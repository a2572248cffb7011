"""Worker for the 2-process CPU distributed test (tests/test_distributed.py).

Run as: python tests/dist_worker.py <process_id> <coordinator> <steps>
Environment must NOT have initialized JAX yet; sets up a 2-process x
2-virtual-CPU-device fleet with gloo collectives, trains a tiny VAE through
the real Trainer for <steps> batches (DP over 4 global devices), and prints
one JSON line with the final loss and a parameter checksum.
"""

import json
import os
import sys

os.environ.pop("XLA_FLAGS", None)
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    pid, coordinator, steps = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])

    import jax

    # The worker runs on the CPU backend only, even where a GPU is present.
    jax.config.update("jax_platforms", "cpu")

    from musicstyletransfer_tpu.parallel import (
        ProcessShardedDataset,
        initialize_distributed,
        make_mesh,
        mesh_process_info,
    )

    initialize_distributed(coordinator, num_processes=2, process_id=pid,
                           num_cpu_devices=2)
    from musicstyletransfer_tpu.parallel.distributed import is_addressable

    cpus = sorted(jax.devices("cpu"), key=lambda d: d.id)
    assert len(cpus) == 4, cpus
    local = [d for d in cpus if is_addressable(d)]

    with jax.default_device(local[0]):
        import jax.numpy as jnp
        import numpy as np

        from musicstyletransfer_tpu.data import MelodyDataset
        from musicstyletransfer_tpu.midi.codec import Melody
        from musicstyletransfer_tpu.models import init_params, make_model
        from musicstyletransfer_tpu.training import TrainConfig, Trainer
        from tests.test_model import tiny_config

        mesh = make_mesh(cpus, tp=1)
        info = mesh_process_info(mesh)
        assert info.count == 2 and info.index == pid, info

        mel = {"a": [Melody(tokens=np.arange(10, 52, dtype=np.int32))],
               "b": [Melody(tokens=np.arange(12, 44, dtype=np.int32))]}
        ds = MelodyDataset(4, 4, mel, seed=11)  # deterministic across procs
        sharded = ProcessShardedDataset(ds, info)

        cfg = tiny_config(vocab=60, classes=2, latent=8, size=16, heads=2,
                          layers=1)
        model = make_model(cfg)
        params = init_params(model, jax.random.key(0), max_seq_len=4)
        tcfg = TrainConfig(batch_size=4, sampling_frequency=0,
                           checkpoint_frequency=10 ** 9,
                           num_checkpoints_not_improved=-1, prefetch=0,
                           logdir=f"/tmp/dist-tb-{pid}", log_every=10 ** 9)
        trainer = Trainer(tcfg, model, params, sampler=None, mesh=mesh,
                          dist=info)
        epochs = -(-steps // ds.num_batches())
        trainer._load_latest_checkpoint = lambda folder: None  # no disk dance
        n = 0
        for _ in range(epochs):
            for batch in sharded:
                trainer._step(batch)
                n += 1
                if n >= steps:
                    break
            if n >= steps:
                break
        vals = trainer._drain_metrics()
        checksum = float(
            sum(float(jnp.sum(jnp.abs(x)))
                for x in jax.tree.leaves(jax.device_get(trainer.state.params)))
        )
        print(json.dumps({
            "pid": pid,
            "mean_total_loss": vals["total_loss"],
            "param_checksum": checksum,
            "steps": n,
        }), flush=True)


if __name__ == "__main__":
    main()
