"""Save/restore cost of the multi-process checkpoint path at the WIDE
config.

Two CPU processes (the children never touch a GPU), 2x2 mesh with the
model axis spanning them, the train-vae-wide.sh model (enc 4x1024 h16 /
dec 2x512, ~60M params, adam: 3x that in state). Each process reports
wall time of save_checkpoint / restore_checkpoint and its peak RSS
(ru_maxrss): the save all-gathers one leaf at a time and only the primary
holds host copies, so a non-primary's peak stays O(largest leaf).

Run: python scripts/ckpt-save-bench.py            (launcher)
     python scripts/ckpt-save-bench.py <pid> <coordinator> <folder>
"""

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def worker(pid: int, coordinator: str, folder: str) -> None:
    os.environ.pop("XLA_FLAGS", None)
    os.environ["JAX_PLATFORMS"] = "cpu"
    import resource

    import jax

    jax.config.update("jax_platforms", "cpu")

    from musicstyletransfer_tpu.parallel import initialize_distributed
    initialize_distributed(coordinator, num_processes=2, process_id=pid,
                           num_cpu_devices=2)
    import numpy as np
    from jax.sharding import Mesh

    from musicstyletransfer_tpu.models import (
        DecoderConfig, EncoderConfig, ModelConfig, TransformerConfig,
        init_params, make_model,
    )
    from musicstyletransfer_tpu.training import (
        OptimizerConfig, build_optimizer, create_train_state,
        restore_checkpoint, save_checkpoint, shard_train_state,
    )

    cpus = sorted(jax.devices("cpu"), key=lambda d: d.id)
    devs = np.array([[cpus[0], cpus[2]], [cpus[1], cpus[3]]])
    mesh = Mesh(devs, ("data", "model"))

    vocab, classes_n, L = 293, 2, 512
    cfg = ModelConfig(
        encoder_config=EncoderConfig(
            transformer_config=TransformerConfig(
                model_size=1024, dropout=0.1, num_layers=4, num_heads=16,
                vocab_size=vocab),
            latent_dim=1024, num_classes=classes_n, input_dim=vocab),
        decoder_config=DecoderConfig(
            transformer_config=TransformerConfig(
                model_size=512, dropout=0.1, num_layers=2, num_heads=16,
                vocab_size=vocab),
            latent_dim=1024, num_classes=classes_n, output_dim=vocab),
    )
    model = make_model(cfg)
    params = init_params(model, jax.random.key(0), max_seq_len=L)
    n_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    tx = build_optimizer(OptimizerConfig("adam", "clip_gradient:1.0", 2e-4))
    state = create_train_state(params, tx, jax.random.key(1))
    state = shard_train_state(state, mesh)
    jax.block_until_ready(state.params)

    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

    t0 = time.perf_counter()
    save_checkpoint(folder, 1, state)
    t_save = time.perf_counter() - t0

    fresh = shard_train_state(
        create_train_state(
            init_params(model, jax.random.key(9), max_seq_len=L),
            tx, jax.random.key(7)),
        mesh)
    t0 = time.perf_counter()
    restored = restore_checkpoint(folder, 1, fresh)
    t_restore = time.perf_counter() - t0
    leaf = jax.tree.leaves(restored.params)[0]
    ok = bool(np.array_equal(
        np.asarray(leaf.addressable_shards[0].data),
        np.asarray(jax.tree.leaves(state.params)[0]
                   .addressable_shards[0].data)))

    rss_after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(json.dumps({
        "pid": pid,
        "n_params_m": round(n_params / 1e6, 1),
        "save_s": round(t_save, 2),
        "restore_s": round(t_restore, 2),
        "peak_rss_mb_before_save": round(rss_before / 1024, 0),
        "peak_rss_mb_end": round(rss_after / 1024, 0),
        "first_leaf_bitwise": ok,
    }), flush=True)


def launcher() -> None:
    import socket

    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    folder = tempfile.mkdtemp(prefix="ckpt-save-bench-")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(pid),
             f"localhost:{port}", folder],
            env=env, cwd=REPO)
        for pid in (0, 1)
    ]
    rc = [p.wait(timeout=3600) for p in procs]
    sys.exit(max(rc))


if __name__ == "__main__":
    if len(sys.argv) == 1:
        launcher()
    else:
        worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
