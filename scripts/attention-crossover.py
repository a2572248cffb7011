"""cuDNN fused attention vs XLA's attention across sequence lengths, on
one GPU: where does cuDNN start to win?

For each head dim of the presets (16, 32, 64) and each length T of their
encoder (L+1, non-causal) and decoder (L+2, causal) shapes, times the
forward and forward+backward of ops.attention.attention with
implementation="cudnn" and "xla" (bf16, 8 heads, batch sized to ~16k
tokens), interleaved, and prints one JSON line per case with the card's
name. Where cuDNN overtakes XLA sets ops/attention.py's choice.

Usage: python scripts/attention-crossover.py [T ...]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from musicstyletransfer_tpu.hardware import card_info, require_gpu  # noqa: E402
from musicstyletransfer_tpu.ops.attention import attention  # noqa: E402
from musicstyletransfer_tpu.utils import configure_jax_cache  # noqa: E402


def time_ms(fn, args, reps=20):
    jax.block_until_ready(fn(*args))  # compile + warm up
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def measure(T, causal, D, H=8, tokens=16384):
    B = max(1, tokens // T)
    rng = np.random.default_rng(T)
    q, k, v = (jnp.asarray(rng.normal(size=(B, T, H, D)), jnp.bfloat16)
               for _ in range(3))
    lens = jnp.asarray(rng.integers(max(1, T // 2), T + 1, B), jnp.int32)
    row = {"T": T, "B": B, "H": H, "D": D, "causal": causal}
    fns = {}
    for impl in ("cudnn", "xla"):
        def fwd(q, k, v, impl=impl):
            return attention(q, k, v, lens, causal, implementation=impl)

        def loss(q, k, v, fwd=fwd):
            return jnp.sum(fwd(q, k, v).astype(jnp.float32))

        fns[f"{impl}_fwd"] = jax.jit(fwd)
        fns[f"{impl}_fwd_bwd"] = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
    samples = {name: [] for name in fns}
    for _ in range(3):  # interleaved rounds, medians
        for name, fn in fns.items():
            samples[name].append(time_ms(fn, (q, k, v)))
    for name, vals in samples.items():
        row[f"{name}_ms"] = round(float(np.median(vals)), 4)
    row["cudnn_speedup_fwd_bwd"] = round(
        row["xla_fwd_bwd_ms"] / row["cudnn_fwd_bwd_ms"], 3)
    row["cudnn_speedup_fwd"] = round(row["xla_fwd_ms"] / row["cudnn_fwd_ms"], 3)
    return row


def main():
    device = require_gpu()[0]
    configure_jax_cache()
    print(f"# {device.device_kind}; {card_info()}", flush=True)
    lengths = [int(t) for t in sys.argv[1:]] or [
        65, 66, 129, 130, 257, 258, 513, 514, 1025, 1026, 2047, 2048]
    for D in (16, 32, 64):
        for T in lengths:
            print(json.dumps(measure(T, causal=T % 2 == 0, D=D)), flush=True)


if __name__ == "__main__":
    main()
