"""Worker for the 2-process fault-injection test.

Run as: python tests/dist_fault_worker.py <pid> <coordinator> <folder> <mode>

mode=crash: train a tiny DP VAE through the REAL Trainer step/checkpoint
machinery; write two DURABLE checkpoints (sha256 of the full gathered
params recorded in <folder>/checksums.jsonl BEFORE each save — the state
at the tick is exactly what the save serializes), then start checkpoint 3
and — on process 1 — SIGKILL ourselves while that save may still be in
flight (the orchestrating test SIGKILLs process 0 moments later,
simulating whole-job preemption mid-save).

mode=resume: restart the pair on the SAME folder; the Trainer's resume
walks checkpoints newest-first, restores the last COMPLETE one,
assert_in_sync fences the fleet on the resume step, and this worker
verifies the restored params sha256 BITWISE against the recorded sidecar,
trains on, and writes one more durable checkpoint. Prints one JSON line.
"""

import hashlib
import json
import os
import signal
import sys
import time

os.environ.pop("XLA_FLAGS", None)
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS_PER_CKPT = 4


def main() -> None:
    pid, coordinator, folder, mode = (
        int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    )

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
    local = [d for d in cpus if is_addressable(d)]

    with jax.default_device(local[0]):
        import numpy as np

        from musicstyletransfer_tpu.data import MelodyDataset
        from musicstyletransfer_tpu.midi.codec import Melody
        from musicstyletransfer_tpu.models import init_params, make_model
        from musicstyletransfer_tpu.training import TrainConfig, Trainer
        from musicstyletransfer_tpu.training import checkpoint as ckpt_mod
        from tests.test_model import tiny_config

        mesh = make_mesh(cpus, tp=1)
        info = mesh_process_info(mesh)

        mel = {"a": [Melody(tokens=np.arange(10, 52, dtype=np.int32))],
               "b": [Melody(tokens=np.arange(12, 44, dtype=np.int32))]}
        ds = MelodyDataset(4, 4, mel, seed=11)
        sharded = ProcessShardedDataset(ds, info)

        cfg = tiny_config(vocab=60, classes=2, latent=8, size=16, heads=2,
                          layers=1)
        model = make_model(cfg)
        params = init_params(model, jax.random.key(0), max_seq_len=4)
        tcfg = TrainConfig(batch_size=4, sampling_frequency=0,
                           checkpoint_frequency=10 ** 9,
                           num_checkpoints_not_improved=-1, prefetch=0,
                           logdir=f"/tmp/fault-tb-{mode}-{pid}",
                           log_every=10 ** 9)
        trainer = Trainer(tcfg, model, params, sampler=None, mesh=mesh,
                          dist=info)

        def params_sha() -> str:
            """sha256 of the fully gathered params — COLLECTIVE (both
            processes must call in lockstep); bitwise-stable by
            construction."""
            host = ckpt_mod._gather_to_host(trainer.state.params)
            h = hashlib.sha256()
            for leaf in jax.tree.leaves(host):
                h.update(np.ascontiguousarray(leaf).tobytes())
            return h.hexdigest()

        sidecar = os.path.join(folder, "checksums.jsonl")

        def record(index: int, sha: str) -> None:
            if info.is_primary:
                with open(sidecar, "a") as fh:
                    fh.write(json.dumps({"index": index, "sha": sha}) + "\n")

        def train_steps(n: int) -> None:
            done = 0
            while done < n:
                for batch in sharded:
                    trainer._step(batch)
                    trainer.progress.n_batches += 1
                    done += 1
                    if done >= n:
                        break

        os.makedirs(folder, exist_ok=True)
        if mode == "crash":
            for index in (1, 2):
                train_steps(STEPS_PER_CKPT)
                record(index, params_sha())
                trainer._checkpoint(folder, None)
                trainer.checkpointer.wait_until_finished()  # durable
                print(f"DURABLE {index}", flush=True)
            train_steps(STEPS_PER_CKPT)
            record(3, params_sha())
            trainer._checkpoint(folder, None)  # async save 3: in flight
            if pid == 1:
                os.kill(os.getpid(), signal.SIGKILL)  # die mid-save
            print("PRIMARY_WAITING", flush=True)
            time.sleep(120)  # the test SIGKILLs us here (preemption)
            return

        assert mode == "resume", mode
        trainer._load_latest_checkpoint(folder)  # walks newest-first +
        # assert_in_sync on the resume step (multi-process branch)
        resumed_from = trainer.progress.n_checkpoints
        resumed_step = int(jax.device_get(trainer.state.step))
        sha = params_sha()
        expected = {}
        with open(sidecar) as fh:
            for line in fh:
                entry = json.loads(line)
                expected[entry["index"]] = entry["sha"]
        train_steps(STEPS_PER_CKPT)
        trainer._checkpoint(folder, None)
        trainer.checkpointer.wait_until_finished()
        print(json.dumps({
            "pid": pid,
            "resumed_from": resumed_from,
            "resumed_step": resumed_step,
            "sha_match": expected.get(resumed_from) == sha,
            "recorded": sorted(expected),
            "final_ckpt": trainer.progress.n_checkpoints,
        }), flush=True)


if __name__ == "__main__":
    main()
