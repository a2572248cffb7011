"""MFU/roofline sweep for the scaled training config, on one GPU.

Measures the scaled model (L=512, enc 4x512, dec 2x256, bf16 compute)
across batch sizes, remat on/off, and bf16-vs-f32 adam moments, recording
for each config:

- step time (iterations chain into one data-dependent scalar and ONE
  host fetch ends the timed region — see bench.py),
- tokens/s and rough analytic MFU against the card's published bf16 peak
  (musicstyletransfer_tpu.hardware.PEAKS; same FLOP model as bench.py),
- XLA cost-analysis FLOPs + bytes accessed -> achieved TFLOP/s and GB/s
  and the share of the card's published memory bandwidth.

Usage:
    python scripts/mfu-sweep.py | tee mfu-sweep.json
Prints the card, then one JSON line per config plus a final summary line.
Refuses to run on anything but a GPU.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, __import__("os").path.dirname(
    __import__("os").path.dirname(__import__("os").path.abspath(__file__))))


def _pick_device():
    from musicstyletransfer_tpu.hardware import require_gpu

    return require_gpu()[0]


def scaled_config(remat: bool, d_enc: int = 512,
                  d_dec: int = 256, heads: int = 8):
    from musicstyletransfer_tpu.models import (
        DecoderConfig, EncoderConfig, ModelConfig, TransformerConfig,
    )

    vocab, classes_n = 293, 2
    return ModelConfig(
        encoder_config=EncoderConfig(
            transformer_config=TransformerConfig(
                model_size=d_enc, dropout=0.1, num_layers=4, num_heads=heads,
                vocab_size=vocab, remat=remat,
            ),
            latent_dim=d_enc, num_classes=classes_n, input_dim=vocab,
        ),
        decoder_config=DecoderConfig(
            transformer_config=TransformerConfig(
                model_size=d_dec, dropout=0.1, num_layers=2, num_heads=heads,
                vocab_size=vocab, remat=remat,
            ),
            latent_dim=d_enc, num_classes=classes_n, output_dim=vocab,
        ),
        dtype="bfloat16",
    )


def analytic_flops_per_step(B: int, L: int) -> float:
    # Same model as bench.py: fwd+bwd = 3x fwd multiply-adds x2.
    def stack_flops(tokens, T, d, layers):
        per_tok = layers * (24.0 * d * d + 4.0 * T * d)
        return 3.0 * tokens * per_tok

    enc_T, dec_T = L + 1, L + 2
    return (
        stack_flops(B * enc_T, enc_T, _D_ENC, 4)
        + stack_flops(B * dec_T, dec_T, _D_DEC, 2)
        + 3.0 * 2.0 * B * dec_T * _D_DEC * 293
    )


# Stack widths measured by this run (overridden in --big mode: the wide
# preset's widths).
_D_ENC, _D_DEC = 512, 256


def measure(device, B: int, remat: bool, mu_dtype: str, L: int = 512,
            n: int = 30):
    import optax

    from musicstyletransfer_tpu.models import init_params, make_model
    from musicstyletransfer_tpu.training import (
        LossConfig, create_train_state, make_train_step,
    )

    from musicstyletransfer_tpu.hardware import peaks

    peak = peaks(device.device_kind)
    cfg = scaled_config(remat, d_enc=_D_ENC, d_dec=_D_DEC,
                        heads=8 if _D_ENC <= 512 else 16)
    with jax.default_device(device):
        model = make_model(cfg)
        params = init_params(model, jax.random.key(0), max_seq_len=L)
        tx = optax.chain(
            optax.clip(1.0),
            optax.adam(
                2e-4,
                mu_dtype=jnp.bfloat16 if mu_dtype == "bf16" else None,
            ),
        )
        state = create_train_state(params, tx, jax.random.key(1, impl="rbg"))
        step = make_train_step(model, tx, LossConfig(kl_weight=0.5))

        rng = np.random.default_rng(0)
        chunks = jnp.asarray(rng.integers(3, 293, (B, L)).astype(np.int32))
        classes = jnp.asarray(rng.integers(0, 2, (B,)).astype(np.int32))

        # Cost analysis of the exact steady-state program (full-accumulator
        # structure), before the donated buffers are consumed.
        state, acc = step(state, None, chunks, classes)
        lowered = step.jitted_raw.lower(state, acc, chunks, classes)
        try:
            ca = lowered.compile().cost_analysis()
            if isinstance(ca, (list, tuple)):
                ca = ca[0]
            xla_flops = float(ca.get("flops", 0.0))
            xla_bytes = float(ca.get("bytes accessed", 0.0))
        except Exception:
            xla_flops, xla_bytes = 0.0, 0.0

        state, acc = step(state, acc, chunks, classes)
        float(acc["total_loss"][0])  # completion barrier (host fetch)
        t0 = time.perf_counter()
        for _ in range(n):
            state, acc = step(state, acc, chunks, classes)
        float(acc["total_loss"][0])
        dt = time.perf_counter() - t0

    step_s = dt / n
    fl = analytic_flops_per_step(B, L)
    return {
        "batch": B,
        "L": L,
        "remat": remat,
        "mu_dtype": mu_dtype,
        "step_ms": round(step_s * 1e3, 2),
        "tokens_per_sec": round(B * L / step_s, 1),
        "rough_mfu": round(fl / step_s / peak["bf16_flops"], 4),
        "xla_flops_per_step": xla_flops,
        "xla_gb_per_step": round(xla_bytes / 1e9, 3),
        "achieved_tflops": round(xla_flops / step_s / 1e12, 1),
        "achieved_gbps": round(xla_bytes / step_s / 1e9, 1),
        "hbm_frac": round(xla_bytes / step_s / peak["hbm_bytes_per_s"], 3),
    }


def main():
    from musicstyletransfer_tpu.utils import configure_jax_cache

    configure_jax_cache()
    from musicstyletransfer_tpu.hardware import card_info

    device = _pick_device()
    print(f"# device: {device.device_kind}; {card_info()}", flush=True)
    if len(sys.argv) > 1 and sys.argv[1] == "--big":
        # The wide preset's widths: enc 4x1024 h16 / dec 2x512 h16, L=512.
        global _D_ENC, _D_DEC
        _D_ENC, _D_DEC = 1024, 512
        for B in ([int(b) for b in sys.argv[2:]] or [8, 16]):
            print(json.dumps({"model": "enc4x1024/dec2x512",
                              **measure(device, B, False, "f32")}),
                  flush=True)
        return
    if len(sys.argv) > 1:
        # Single-config mode: mfu-sweep.py B remat(0/1) mu L
        B = int(sys.argv[1])
        remat = sys.argv[2] not in ("0", "false", "False")
        mu = sys.argv[3] if len(sys.argv) > 3 else "f32"
        L = int(sys.argv[4]) if len(sys.argv) > 4 else 512
        print(json.dumps(measure(device, B, remat, mu, L=L)), flush=True)
        return
    results = []
    grid = []
    for B in (16, 32, 64, 128):
        for remat in (True, False):
            grid.append((B, remat, "f32"))
    for B, remat, mu in grid:
        try:
            r = measure(device, B, remat, mu)
        except Exception as e:  # OOM at big batches without remat, etc.
            r = {"batch": B, "remat": remat, "mu_dtype": mu,
                 "error": f"{type(e).__name__}: {str(e)[:200]}"}
        results.append(r)
        print(json.dumps(r), flush=True)
    # bf16 adam moments on the best ok config
    ok = [r for r in results if "error" not in r]
    if ok:
        best = max(ok, key=lambda r: r["rough_mfu"])
        r = measure(device, best["batch"], best["remat"], "bf16")
        results.append(r)
        print(json.dumps(r), flush=True)
        best = max((x for x in results if "error" not in x),
                   key=lambda r: r["rough_mfu"])
        print(json.dumps({"best": best}), flush=True)


if __name__ == "__main__":
    main()
