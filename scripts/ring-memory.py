"""Memory and overhead of ring attention (ops/ring_attention.py).

Modes:

  python scripts/ring-memory.py mem [T ...]
      8-device CPU mesh (1 data x 8 model), B=1 H=4 D=64 f32, causal.
      For each T: XLA's compiled memory analysis (temp allocation bytes)
      of value_and_grad through the ring, beside the same for plain
      attention on one device. The ring's backward is JAX's own
      differentiation through the ppermute scan, which keeps every
      rotated K/V chunk as a residual, so its temp grows with the FULL T
      per device; the forward alone needs O(T/n). Prints one JSON line
      per T. (Memory sizes from the CPU compiler are a count of buffers,
      not a device measurement.)

  python scripts/ring-memory.py time [T]
      GPU only: ring_attention_sharded on a 1-device (data=1, model=1)
      mesh vs plain attention, fwd+bwd at T (default 8192), bf16. n=1 is
      the only ring one card can run; it prices the shard_map wrapper and
      the jnp block attention against the fused attention the model
      uses otherwise.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MODE = sys.argv[1] if len(sys.argv) > 1 else "mem"

if MODE == "mem":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=8 "
        + os.environ.get("XLA_FLAGS", "").replace(
            "--xla_force_host_platform_device_count=8", ""
        )
    )

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def _qkv(B, H, T, D, dtype):
    rng = np.random.default_rng(0)
    return tuple(
        jnp.asarray(rng.normal(size=(B, H, T, D)).astype(np.float32), dtype)
        for _ in range(3)
    )


def _grad_of(fn):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32))

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))


def _plain(lens, causal):
    from musicstyletransfer_tpu.ops.attention import attention

    def fn(q, k, v):
        t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
        return t(attention(t(q), t(k), t(v), lens, causal))

    return fn


def mem_mode(lengths):
    from musicstyletransfer_tpu.ops.ring_attention import (
        ring_attention_sharded,
    )
    from musicstyletransfer_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(jax.devices("cpu")[:8], tp=8)
    B, H, D = 1, 4, 64
    for T in lengths:
        q, k, v = _qkv(B, H, T, D, jnp.float32)
        lens = jnp.full((B,), T, jnp.int32)
        row = {"T": T, "ring": 8}
        for name, fn in (
            ("ring", lambda q, k, v: ring_attention_sharded(
                q, k, v, lens, causal=True, mesh=mesh)),
            ("plain", _plain(lens, True)),
        ):
            try:
                ma = _grad_of(fn).lower(q, k, v).compile().memory_analysis()
                row[f"{name}_temp_mb"] = round(ma.temp_size_in_bytes / 1e6, 1)
            except Exception as e:  # plain attention may not fit at large T
                row[f"{name}_error"] = f"{type(e).__name__}: {str(e)[:120]}"
        print(json.dumps(row), flush=True)


def time_mode(T):
    from musicstyletransfer_tpu.hardware import card_info, require_gpu
    from musicstyletransfer_tpu.ops.ring_attention import (
        ring_attention_sharded,
    )
    from musicstyletransfer_tpu.parallel.mesh import make_mesh
    from musicstyletransfer_tpu.utils import configure_jax_cache

    device = require_gpu()[0]
    configure_jax_cache()
    B, H, D = 1, 4, 64
    mesh = make_mesh([device], tp=1)
    q, k, v = _qkv(B, H, T, D, jnp.bfloat16)
    lens = jnp.full((B,), T, jnp.int32)
    fns = {
        "ring1": _grad_of(lambda q, k, v: ring_attention_sharded(
            q, k, v, lens, causal=True, mesh=mesh)),
        "plain": _grad_of(_plain(lens, True)),
    }

    def timeit(f, reps=8):
        jax.block_until_ready(f(q, k, v))  # compile + warm up
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(q, k, v)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps

    # Interleaved repetitions + medians.
    times = {name: [] for name in fns}
    for _ in range(3):
        for name, f in fns.items():
            times[name].append(timeit(f))
    r, p = (float(np.median(times[n])) for n in ("ring1", "plain"))
    print(json.dumps({
        "T": T,
        "card": card_info(),
        "device_kind": device.device_kind,
        "ring1_fwd_bwd_ms": round(r * 1e3, 3),
        "plain_fwd_bwd_ms": round(p * 1e3, 3),
        "ring1_overhead": round(r / p, 3),
    }), flush=True)


if __name__ == "__main__":
    if MODE == "mem":
        mem_mode([int(t) for t in sys.argv[2:]] or [2048, 4096, 8192])
    elif MODE == "time":
        time_mode(int(sys.argv[2]) if len(sys.argv) > 2 else 8192)
    else:
        raise SystemExit(f"unknown mode {MODE}")
