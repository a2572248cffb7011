"""Micro-batched style-transfer service CLI.

One-shot mode: transfer every ``.mid`` in ``--in-dir`` into every style
class, writing ``<name>.class-{c}.mid`` files to ``--out-samples``.
Watch mode (``--watch``): keep polling the directory and serve new files
as they appear (micro-batching via StyleTransferService).

    python -m musicstyletransfer_tpu.cli.serve \
        --model-output models/run1 --in-dir midis/ --out-samples out/

HTTP mode (``--http PORT``): a threaded endpoint over the same service —
concurrent clients' requests micro-batch together through the fused
device call:

    POST /transfer            MIDI bytes in -> JSON {class: base64 MIDI}
    POST /transfer?class=N    MIDI bytes in -> raw transferred MIDI bytes
    GET  /stats               ServiceStats snapshot (p50/p99, fill, queue)
    GET  /healthz             liveness probe
"""

from __future__ import annotations

import argparse
import glob
import os
import time

from ..inference.service import StyleTransferService


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-output", "-m", required=True)
    p.add_argument("--checkpoint", "-c", type=int, default=-1)
    p.add_argument("--in-dir", default=None,
                   help="directory of .mid requests (required unless "
                        "--http)")
    p.add_argument("--out-samples", "-o", default=None,
                   help="output directory (required unless --http)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-seq-len", type=int, default=64)
    p.add_argument("--watch", action="store_true")
    p.add_argument("--poll-seconds", type=float, default=1.0)
    p.add_argument("--buckets", default="",
                   help="comma-separated length buckets (e.g. '16,32,64'; "
                        "largest must equal --max-seq-len): each batch is "
                        "served at the smallest bucket covering its "
                        "longest request — one compiled program per "
                        "bucket, shorter generation budget for short "
                        "batches")
    p.add_argument("--stats", action="store_true",
                   help="print serving stats (p50/p99 latency, batch "
                        "fill, queue depth) on exit / every watch poll")
    p.add_argument("--cpu", action="store_true",
                   help="pin compute to a local CPU device (tests/dev)")
    p.add_argument("--http", type=int, default=0, metavar="PORT",
                   help="serve an HTTP endpoint instead of reading "
                        "--in-dir (POST /transfer, GET /stats) — "
                        "concurrent requests micro-batch together")
    p.add_argument("--http-host", default="127.0.0.1",
                   help="bind address for --http (default loopback)")
    p.add_argument("--streaming", action="store_true",
                   help="continuous batching (--http only): slot-based "
                        "engine admits requests between decode segments "
                        "instead of between micro-batches — matches the "
                        "micro-batch loop's throughput at moderate load "
                        "with lower median request latency")
    p.add_argument("--slots", type=int, default=128,
                   help="--streaming: concurrent generation lanes "
                        "(throughput scales with slots while the harvest "
                        "round trip dominates slot residency)")
    p.add_argument("--segment-steps", type=int, default=32,
                   help="--streaming: decode steps per dispatch (the "
                        "admission granularity)")
    p.add_argument("--admit-size", type=int, default=0,
                   help="--streaming: max (request x class) units encoded "
                        "into free slots per cycle; 0 = full width "
                        "(= --slots, the measured overload-safe default)")
    p.add_argument("--max-queue", type=int, default=0,
                   help="--streaming: bound on the host request queue; at "
                        "the bound new requests are SHED with an immediate "
                        "EngineOverloaded error (HTTP 503) instead of "
                        "queueing unboundedly past capacity (0 = "
                        "unbounded)")
    p.add_argument("--harvest-delay-ms", type=float, default=None,
                   help="--streaming: time given to each cycle readout's "
                        "async device->host copy before harvesting it. "
                        "Default auto: calibrated from measured fetch "
                        "round trips at startup, then ADAPTED to window "
                        "drift per harvest (AIMD on the measured fetch "
                        "block); an explicit value pins it")
    return p


def serve_http(svc: StyleTransferService, host: str, port: int):
    """Threaded HTTP front end over the service's micro-batching loop.

    Returns the bound ThreadingHTTPServer (caller runs serve_forever(), or
    drives it from a thread in tests). Every in-flight POST blocks its
    handler thread on the request's callback while the service loop batches
    concurrent requests into fused device calls.
    """
    import base64
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/stats"):
                body = json.dumps(svc.stats.snapshot()).encode()
                self._send(200, "application/json", body)
            elif self.path.startswith("/healthz"):
                # Honest liveness: green only while the serving loop
                # thread is actually alive (a dead loop would otherwise
                # 504 every POST behind a passing probe).
                if svc.is_serving():
                    self._send(200, "text/plain", b"ok")
                else:
                    self._send(503, "text/plain", b"serving loop dead")
            else:
                self._send(404, "text/plain", b"not found")

        # MIDI requests are KB-scale; cap the body so a hostile/buggy
        # Content-Length cannot buffer gigabytes into the process that
        # holds the model (relevant with --http-host 0.0.0.0).
        MAX_BODY = 16 * 1024 * 1024

        def do_POST(self):
            if not self.path.startswith("/transfer"):
                return self._send(404, "text/plain", b"not found")
            from urllib.parse import parse_qs, urlparse

            # Validate ?class BEFORE enqueueing: a bad selector must not
            # pay a full fused device call just to 400 afterwards.
            # keep_blank_values so '?class=' is a 400, not a silent
            # fall-through to the JSON payload.
            query = parse_qs(urlparse(self.path).query,
                             keep_blank_values=True)
            cls = None
            if "class" in query:
                try:
                    cls = int(query["class"][0])
                    if not 0 <= cls < svc.num_classes:
                        raise ValueError(cls)
                except ValueError:
                    return self._send(
                        400, "text/plain",
                        f"unknown class (have 0..{svc.num_classes - 1})"
                        .encode(),
                    )
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > self.MAX_BODY:
                    return self._send(
                        413, "text/plain",
                        f"body too large (max {self.MAX_BODY} bytes)"
                        .encode(),
                    )
                data = self.rfile.read(length)
                done = threading.Event()
                box = {}

                def cb(result):
                    box["result"] = result
                    done.set()

                svc.enqueue(data, cb)
            except Exception as exc:  # malformed MIDI / no note events
                return self._send(
                    400, "text/plain", f"bad request: {exc}".encode()
                )
            if not done.wait(timeout=120.0):
                return self._send(504, "text/plain", b"transfer timed out")
            result = box["result"]
            if isinstance(result, Exception):  # failed batch, fail fast
                from ..inference.streaming import EngineOverloaded

                if isinstance(result, EngineOverloaded):
                    # Bounded-queue shed: the canonical "back off and
                    # retry elsewhere" status, not a server fault.
                    return self._send(
                        503, "text/plain", f"overloaded: {result}".encode()
                    )
                return self._send(
                    500, "text/plain", f"transfer failed: {result}".encode()
                )
            if cls is not None:
                return self._send(200, "audio/midi",
                                  result.midi_by_class[cls])
            payload = {
                str(c): base64.b64encode(m).decode()
                for c, m in result.midi_by_class.items()
            }
            self._send(200, "application/json", json.dumps(payload).encode())

        def log_message(self, *args):  # quiet: stats carry the signal
            pass

    # Bind FIRST: if the port is taken, fail before spawning the serving
    # loop thread (otherwise the OSError would leak a running loop that
    # holds the device context with no handle to stop it).
    server = ThreadingHTTPServer((host, port), Handler)
    svc.start()
    return server


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..utils import (
        configure_jax_cache, pin_local_cpu,
    )

    configure_jax_cache()
    if args.cpu:
        pin_local_cpu()
    if not args.http:
        if not (args.in_dir and args.out_samples):
            build_parser().error(
                "--in-dir and --out-samples are required without --http"
            )
        os.makedirs(args.out_samples, exist_ok=True)
    buckets = (
        [int(b) for b in args.buckets.split(",") if b.strip()]
        if args.buckets else None
    )
    if args.streaming:
        if not args.http:
            build_parser().error(
                "--streaming applies to --http serving (directory modes "
                "are throughput-bound; the micro-batch loop wins there)"
            )
        from ..inference.streaming import StreamingTransferEngine

        svc = StreamingTransferEngine(
            args.model_output,
            checkpoint=args.checkpoint,
            slots=args.slots,
            max_seq_len=args.max_seq_len,
            segment_steps=args.segment_steps,
            admit_size=args.admit_size,
            harvest_delay_s=(None if args.harvest_delay_ms is None
                             else args.harvest_delay_ms / 1e3),
            max_queue=args.max_queue,
        )
    else:
        svc = StyleTransferService(
            args.model_output,
            checkpoint=args.checkpoint,
            batch_size=args.batch_size,
            max_seq_len=args.max_seq_len,
            buckets=buckets,
        )
    if args.http:
        server = serve_http(svc, args.http_host, args.http)
        print(f"serving HTTP on {args.http_host}:{server.server_port} "
              f"(POST /transfer, GET /stats)")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            server.server_close()  # shutdown() leaves the listening fd open
            svc.stop()
        return
    seen = set()

    def process(files):
        batch_tokens, names = [], []
        for f in files:
            with open(f, "rb") as fh:
                data = fh.read()
            try:
                batch_tokens.append(svc._tokens_from_midi(data))
            except ValueError as exc:
                print(f"skipping {f}: {exc}")
                continue
            names.append(os.path.splitext(os.path.basename(f))[0])
            if len(batch_tokens) == svc.batch_size:
                flush(batch_tokens, names)
                batch_tokens, names = [], []
        if batch_tokens:
            flush(batch_tokens, names)

    def flush(batch_tokens, names):
        t0 = time.perf_counter()
        results = svc.transfer_tokens(batch_tokens)
        dt = (time.perf_counter() - t0) * 1e3
        svc.stats.record_batch(
            fill=len(names), queue_depth_after=0,
            latencies_ms=[dt] * len(names),
        )
        for name, result in zip(names, results):
            for c, midi in result.midi_by_class.items():
                out = os.path.join(args.out_samples, f"{name}.class-{c}.mid")
                with open(out, "wb") as fh:
                    fh.write(midi)
        print(f"served {len(names)} files x {svc.num_classes} classes "
              f"in {dt:.1f}ms")

    def print_stats():
        s = svc.stats.snapshot()
        print(
            f"stats: served={s['requests_served']} "
            f"batches={s['batches']} fill={s['mean_batch_fill']:.1f} "
            f"p50={s['latency_p50_ms']:.1f}ms "
            f"p99={s['latency_p99_ms']:.1f}ms "
            f"max_queue={s['max_queue_depth']}"
        )

    while True:
        files = [
            f for f in sorted(glob.glob(os.path.join(args.in_dir, "*.mid")))
            if f not in seen
        ]
        seen.update(files)
        if files:
            process(files)
            if args.stats and args.watch:
                print_stats()
        if not args.watch:
            break
        time.sleep(args.poll_seconds)
    if args.stats and not args.watch:
        print_stats()


if __name__ == "__main__":
    main()
