"""Streaming engine vs micro-batch service under identical open-loop load.

Thin wrapper over bench.py's shared serving-bench helpers
(_flagship_model_folder, _mixed_requests, _open_loop_load) so the two
benches can never diverge in protocol. Measures, on one GPU (it refuses
any other platform):

- batch-service capacity (closed-loop full batches) as the load anchor;
- for each engine {batch service, streaming engine}: sustained throughput
  and request p50/p99 under open-loop arrivals at ``load_frac`` of that
  capacity, with the same mixed-length request population.

Usage:
    python scripts/streaming-bench.py [load_frac] [slots] [segment_steps] \
        [admit_size] [max_queue]
Defaults: 0.5 128 32 0 0 — the SHIPPED engine configuration (admit 0 =
full-width admission, admit_size=slots). Prints one JSON line per engine
plus a summary. ``slots`` and ``admit_size`` may each be comma lists
(e.g. ``128,256`` / ``16,64``): one streaming engine per (slots, admit)
pair runs interleaved in the same window — the capacity-scaling and
admission-tuning probes (offer load_frac > 1 to push past the batch
service's capacity). ``load_frac`` may ALSO be a comma list (e.g.
``0.3,0.5,0.7,0.9,1.0,1.2,1.5``): the latency-vs-load CURVE mode, past
saturation too — per level, the
batch service and every streaming engine run back-to-back in the same
window, so each row's cross-engine comparison is window-fair and the
curve characterizes the saturation/overload tail. ``max_queue`` > 0
bounds every streaming engine's host queue (overload sheds with
EngineOverloaded; the per-engine ``shed`` count reports it).

The two engines run interleaved per load level within one process;
compare the printed pair, not numbers from different runs.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _pick_device():
    from musicstyletransfer_tpu.hardware import card_info, require_gpu

    device = require_gpu()[0]
    print(f"# {device.device_kind}; {card_info()}", flush=True)
    return device


def run_load(target, requests, rate, n_target, label):
    from bench import _open_loop_load

    s, wall, errors = _open_loop_load(target, requests, rate, n_target,
                                      seed_base=0, timeout=240.0)
    out = {
        "engine": label,
        "offered_req_per_sec": round(rate, 1),
        "sustained_req_per_sec": round(s["requests_served"] / wall, 1),
        "p50_ms": round(s["latency_p50_ms"], 1),
        "p99_ms": round(s["latency_p99_ms"], 1),
        "mean_fill": round(s["mean_batch_fill"], 1),
        "max_queue_depth": s["max_queue_depth"],
        "shed": s.get("requests_shed", 0),
        "errors": errors,
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    import jax

    from musicstyletransfer_tpu.utils import configure_jax_cache

    configure_jax_cache()
    load_fracs = ([float(f) for f in sys.argv[1].split(",")]
                  if len(sys.argv) > 1 else [0.5])
    slots_list = ([int(s) for s in sys.argv[2].split(",")]
                  if len(sys.argv) > 2 else [128])
    segment_steps = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    # 0 = the shipped default (full-width admission, admit_size=slots).
    admit_list = ([int(a) for a in sys.argv[4].split(",")]
                  if len(sys.argv) > 4 else [0])
    max_queue = int(sys.argv[5]) if len(sys.argv) > 5 else 0
    device = _pick_device()
    print(f"# device: {device}, load_fracs={load_fracs}, "
          f"slots={slots_list}, segment_steps={segment_steps}, "
          f"admit={admit_list}, max_queue={max_queue}", flush=True)

    from bench import _flagship_model_folder, _mixed_requests

    with jax.default_device(device):
        folder = _flagship_model_folder(prefix="mst-stream-bench-")
        requests = _mixed_requests()

        from musicstyletransfer_tpu.inference.service import (
            StyleTransferService,
        )
        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )

        svc = StyleTransferService(folder, checkpoint=-1, batch_size=32,
                                   max_seq_len=64, max_wait_ms=5.0,
                                   buckets=[16, 32, 64])
        engine_specs = [(s, a or s) for s in slots_list for a in admit_list]
        engines = [
            (f"streaming[slots={s},admit={a}]",
             StreamingTransferEngine(folder, checkpoint=-1, slots=s,
                                     max_seq_len=64,
                                     segment_steps=segment_steps,
                                     admit_size=a, max_queue=max_queue))
            for s, a in engine_specs
        ]

        # Warm every compiled program outside the timed windows.
        for m in (requests[0], requests[6], requests[9]):
            svc.submit_midi(m)
            for _, eng in engines:
                eng.submit_midi(m)

        # Capacity anchor: median of 3 full max-bucket batches through the
        # service.
        import numpy as np

        toks = [svc._tokens_from_midi(requests[9])] * 32
        svc.transfer_tokens(toks)  # warm the full-batch shape
        caps = []
        for _ in range(3):
            t0 = time.perf_counter()
            svc.transfer_tokens(toks)
            caps.append(32 / (time.perf_counter() - t0))
        cap = float(np.median(caps))
        print(json.dumps({"service_capacity_req_per_sec": round(cap, 1)}),
              flush=True)

        for load_frac in load_fracs:
            rate = load_frac * cap
            n_target = min(600, max(100, int(rate * 10)))
            # Interleave: service then each streaming config per level, in
            # the same window.
            s_batch = run_load(svc, requests, rate, n_target,
                               f"batch@{load_frac}")
            summary = {"load_frac": load_frac}
            for (label, eng), (slots, admit) in zip(engines, engine_specs):
                s = run_load(eng, requests, rate, n_target,
                             f"{label}@{load_frac}")
                # One speedup entry PER engine config (a comma list
                # previously collapsed to the first config's stats,
                # silently excluding the rest from the summary).
                key = f"slots{slots}_admit{admit}"
                summary[f"p50_speedup_{key}"] = round(
                    s_batch["p50_ms"] / max(s["p50_ms"], 1e-9), 2)
                summary[f"p99_speedup_{key}"] = round(
                    s_batch["p99_ms"] / max(s["p99_ms"], 1e-9), 2)
                summary[f"sustained_ratio_{key}"] = round(
                    s["sustained_req_per_sec"]
                    / max(s_batch["sustained_req_per_sec"], 1e-9), 3)
            print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
