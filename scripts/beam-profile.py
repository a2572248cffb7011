"""Beam-search latency breakdown on one GPU: forward vs top-k vs
cache-reorder cost at the flagship config (B=32, K=4, 130 steps).

The shipped beam loop reorders the KV cache with a row gather
(``jnp.take``); the one-hot permutation matmul is the alternative
formulation, kept here so the two stay measurable side by side.

Variants:
  take      — cache reorder via jnp.take (= shipped behavior)
  noreorder — skip the per-step cache reorder (WRONG results, cost probe)
  noseqs    — skip the seqs take+update too
  matmul    — cache reorder via a one-hot permutation matmul (bf16)
  shipped   — inference.decode.decode_beam as shipped
  sample128 — the plain sampled XLA loop at B=128 (forward-cost floor)

Refuses to run on anything but a GPU; prints the card first.
"""
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from __graft_entry__ import _flagship_config
from musicstyletransfer_tpu.models import init_params, make_model
from musicstyletransfer_tpu.midi.vocab import EOS_ID, PAD_ID, SOS_ID
from musicstyletransfer_tpu.utils import configure_jax_cache

configure_jax_cache()

config = _flagship_config(dtype="bfloat16")
model = make_model(config)
from musicstyletransfer_tpu.hardware import card_info, require_gpu  # noqa: E402

dev = require_gpu()[0]
print(f"# {dev.device_kind}; {card_info()}", flush=True)
B, K, max_len = 32, 4, 130
V = 293

with jax.default_device(dev):
    params = init_params(model, jax.random.key(0), max_seq_len=64)
    rng = np.random.default_rng(5)
    z = jnp.asarray(rng.normal(size=(B, 256)).astype(np.float32))
    classes = jnp.zeros((B,), jnp.int32)

    def beam_variant(reorder: str, take_seqs: bool):
        def run(z, classes):
            z_rep = jnp.repeat(z, K, axis=0)
            classes_rep = jnp.repeat(classes, K, axis=0)
            cache = model.decode_prefill(params, z_rep, classes_rep, max_len + 1)
            seqs = jnp.full((B * K, max_len), PAD_ID,
                            jnp.int32).at[:, 0].set(SOS_ID)
            scores = jnp.where(jnp.arange(K)[None, :] == 0, 0.0,
                               jnp.inf) * jnp.ones((B, 1))
            batch_offset = (jnp.arange(B) * K)[:, None]

            def cond(st):
                return st[3] < max_len

            def body(st):
                seqs, scores, cache, t, done = st
                last = jax.lax.dynamic_slice_in_dim(seqs, t - 1, 1,
                                                    axis=1)[:, 0]
                logits, cache = model.decode_step(params, last, cache, t)
                nll = -jax.nn.log_softmax(logits, axis=-1)
                pad_only = jnp.full((V,), jnp.inf).at[PAD_ID].set(0.0)
                nll = jnp.where(done[:, None], pad_only[None, :], nll)
                expanded = scores.reshape(B * K, 1) + nll
                folded = expanded.reshape(B, K * V)
                top_scores, top_idx = jax.lax.top_k(-folded, K)
                new_scores = -top_scores
                hyp_idx = top_idx // V
                word_idx = (top_idx % V).astype(jnp.int32)
                flat_src = (hyp_idx + batch_offset).reshape(B * K)
                if take_seqs:
                    seqs = jnp.take(seqs, flat_src, axis=0)
                seqs = jax.lax.dynamic_update_slice(
                    seqs, word_idx.reshape(B * K, 1), (0, t))
                if reorder == "take":
                    cache = jax.tree.map(
                        lambda c: jnp.take(c, flat_src, axis=0), cache)
                elif reorder == "matmul":
                    # one-hot [B*K, B*K] selection, block-diagonal by batch
                    sel = jax.nn.one_hot(flat_src, B * K, dtype=jnp.bfloat16)

                    def re(c):
                        flat = c.reshape(B * K, -1)
                        out = jnp.dot(sel, flat.astype(jnp.bfloat16),
                                      preferred_element_type=jnp.float32)
                        return out.astype(c.dtype).reshape(c.shape)

                    cache = jax.tree.map(re, cache)
                done = jnp.take(done, flat_src, axis=0) | (
                    word_idx.reshape(B * K) == EOS_ID)
                return seqs, new_scores, cache, t + 1, done

            st = (seqs, scores, cache, jnp.asarray(1, jnp.int32),
                  jnp.zeros((B * K,), bool))
            st = jax.lax.while_loop(cond, body, st)
            return st[0], st[1]

        return run

    def make_runner(fn):
        @jax.jit
        def run(total):
            s, sc = fn(z, classes)
            return total + jnp.sum(s) + jnp.sum(sc)

        float(run(jnp.zeros(())))  # compile
        return run

    def time_once(run, n=4):
        t0 = time.perf_counter()
        total = jnp.zeros(())
        for _ in range(n):
            total = run(total)
        float(total)
        return (time.perf_counter() - t0) / n * 1e3

    from musicstyletransfer_tpu.inference.decode import decode_beam, decode_sampled

    z128 = jnp.repeat(z, K, axis=0)
    c128 = jnp.repeat(classes, K, axis=0)

    variants = [
        ("take reorder", beam_variant("take", True)),
        ("no cache reorder", beam_variant("none", True)),
        ("no reorder, no seq take", beam_variant("none", False)),
        ("matmul reorder", beam_variant("matmul", True)),
        ("shipped decode_beam", lambda zz, cc: decode_beam(
            model, params, zz, cc, max_len, K)),
        ("sampled XLA loop B=128", lambda zz, cc: decode_sampled(
            model, params, z128, c128, max_len, jax.random.key(0))),
    ]
    runners = [(name, make_runner(fn)) for name, fn in variants]

    # Never judge an A/B ratio from one sequential block per variant —
    # INTERLEAVE rounds across all variants and report the per-variant
    # median, so drift hits every variant alike.
    samples = {name: [] for name, _ in runners}
    for _ in range(5):
        for name, run in runners:
            samples[name].append(time_once(run))
    for name, _ in runners:
        vals = sorted(samples[name])
        med = vals[len(vals) // 2]
        print(f"{name + ':':<26} {med:.2f} ms  "
              f"(spread {vals[0]:.2f}-{vals[-1]:.2f})")
