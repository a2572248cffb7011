"""Profile the scaled train step and print a per-op time breakdown.

Runs the best measured config (B=16, remat off — scripts/mfu-sweep.py) for
a few steps under ``jax.profiler.trace`` and aggregates device-side op
durations from the trace protobuf-JSON (no TensorBoard needed: gunzip the
.trace.json.gz and sum ``ph == "X"`` events by name — the technique that
found the r02 top-5-metric sort hotspot).

Usage: python scripts/profile-step.py [B] [remat(0/1)]
       python scripts/profile-step.py --parse <trace_dir> [n_steps]
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--parse":
        n = int(sys.argv[3]) if len(sys.argv) > 3 else 10
        report(sys.argv[2], n)
        return
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    remat = (sys.argv[2] not in ("0", "false")) if len(sys.argv) > 2 else False
    big = "--big" in sys.argv  # wide config: enc 4x1024 h16 / dec 2x512

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from musicstyletransfer_tpu.utils import configure_jax_cache

    configure_jax_cache()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import importlib

    sweep = importlib.import_module("mfu-sweep")
    device = sweep._pick_device()

    from musicstyletransfer_tpu.models import init_params, make_model
    from musicstyletransfer_tpu.training import (
        LossConfig, create_train_state, make_train_step,
    )

    if big:
        sweep._D_ENC, sweep._D_DEC = 1024, 512
    cfg = sweep.scaled_config(
        remat, d_enc=sweep._D_ENC, d_dec=sweep._D_DEC,
        heads=8 if sweep._D_ENC <= 512 else 16,
    )
    L = 512
    with jax.default_device(device):
        model = make_model(cfg)
        params = init_params(model, jax.random.key(0), max_seq_len=L)
        tx = optax.chain(optax.clip(1.0), optax.adam(2e-4))
        state = create_train_state(params, tx, jax.random.key(1, impl="rbg"))
        step = make_train_step(model, tx, LossConfig(kl_weight=0.5))
        rng = np.random.default_rng(0)
        chunks = jnp.asarray(rng.integers(3, 293, (B, L)).astype(np.int32))
        classes = jnp.asarray(rng.integers(0, 2, (B,)).astype(np.int32))
        state, acc = step(state, None, chunks, classes)
        state, acc = step(state, acc, chunks, classes)
        float(acc["total_loss"][0])

        trace_dir = tempfile.mkdtemp(prefix="mst-prof-")
        n = 10
        with jax.profiler.trace(trace_dir):
            for _ in range(n):
                state, acc = step(state, acc, chunks, classes)
            float(acc["total_loss"][0])

    report(trace_dir, n)


def report(trace_dir: str, n: int) -> None:
    traces = glob.glob(
        os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True
    )
    if not traces:
        raise SystemExit(f"no trace written under {trace_dir}")
    with gzip.open(traces[0], "rt") as fh:
        data = json.load(fh)

    # Device lanes: pick pids whose process name mentions the accelerator
    # (falls back to every non-python pid).
    pid_names = {}
    tid_names = {}
    for ev in data.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev["pid"]] = ev["args"].get("name", "")
        elif ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tid_names[(ev["pid"], ev.get("tid"))] = ev["args"].get("name", "")
    device_pids = {
        pid for pid, name in pid_names.items()
        if any(s in name.lower() for s in ("gpu", "device", "xla", "/device"))
    } or set(pid_names)
    # The device pid carries several lanes: "Steps" (iteration markers
    # "0".."9"), "XLA Modules" (the jit_... umbrella spanning each whole
    # step) and "XLA Ops" (the leaf HLOs we want). Summing all three
    # triple-counts and buries the op table under parents — keep only the
    # op lane when it is labelled, else drop umbrella/step-marker names.
    op_tids = {
        key for key, name in tid_names.items()
        if key[0] in device_pids and "op" in name.lower()
    }

    def is_leaf(ev):
        if op_tids:
            return (ev.get("pid"), ev.get("tid")) in op_tids
        name = ev.get("name", "")
        return not (name.isdigit() or name.startswith("jit_"))

    def semantic_bucket(name: str, args: dict) -> str:
        """Coarse workload attribution from the HLO long_name shapes.

        The scaled config's signatures: FFN dots touch the 512x2048 (or
        256x1024 decoder) weight; attention-core ops carry a [B,H,T,T]
        score tensor (T=512 -> "512,512") on XLA's path; q/k/v/o projections are square
        d x d dots. Anything unmatched falls into its hlo_category."""
        import re

        long = args.get("long_name", "")
        cat = args.get("hlo_category", "?")
        if "custom-call" in cat and "cudnn" in long.lower():
            return "cudnn attention"
        # Attention score/softmax ops carry a 4D [B, H, T, T] tensor
        # (T = L+1 or L+2 here, so match "last two dims equal" not a
        # hard-coded size).
        if re.search(r"\[\d+,\d+,(\d+),\1\]", long):
            return "attention core [B,H,T,T]"
        if ("512,2048]" in long or "2048,512]" in long
                or "256,1024]" in long or "1024,256]" in long
                or "1024,4096]" in long or "4096,1024]" in long):
            # Includes the FFN weight-grad matmuls XLA fuses with their
            # adam update (output tuple of param/mu/nu).
            return "FFN matmul (+fused adam)"
        if "convolution" in cat:
            return "qkv/o + other dots"
        if cat == "copy" or cat.startswith("copy"):
            return "layout copy"
        return cat

    by_name = collections.Counter()
    by_cat = collections.Counter()
    total = 0.0
    for ev in data.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("pid") in device_pids and is_leaf(ev):
            dur = float(ev.get("dur", 0.0))
            by_name[ev.get("name", "?")] += dur
            by_cat[semantic_bucket(ev.get("name", ""), ev.get("args", {}))] \
                += dur
            total += dur
    print(f"# pids: { {p: pid_names.get(p, '?') for p in device_pids} }")
    print(f"# total device op time: {total / 1e3:.2f} ms over {n} steps "
          f"({total / 1e3 / n:.2f} ms/step)")
    print("# --- by workload bucket ---")
    for name, dur in by_cat.most_common():
        print(json.dumps({
            "bucket": name,
            "ms_per_step": round(dur / 1e3 / n, 3),
            "pct": round(100 * dur / total, 1),
        }))
    print("# --- top ops ---")
    for name, dur in by_name.most_common(20):
        print(json.dumps({
            "op": name[:100],
            "ms_per_step": round(dur / 1e3 / n, 3),
            "pct": round(100 * dur / total, 1),
        }))


if __name__ == "__main__":
    main()
