"""Multi-style micro-batched transfer service: continuous encode/swap/decode.

Continuous encode/swap/decode for many styles at once. Requests (MIDI bytes or
token arrays) are collected into fixed-shape micro-batches — filled up to
``batch_size`` or flushed after ``max_wait_ms`` — and served by ONE jitted
fused call per batch (encode + decode every target class). Fixed shapes
mean exactly one compilation; partial batches are padded with the first
request (static-shape idiom) and the padding rows discarded.

Programmatic use:

    svc = StyleTransferService(model_folder, checkpoint=-1)
    results = svc.submit_midi(midi_bytes)      # blocking convenience call
    # or svc.start(); svc.enqueue(...); svc.stop() for the threaded loop

CLI (one-shot directory mode):
    python -m musicstyletransfer_tpu.cli.serve --model-output m/ \
        --in-dir midis/ --out-samples out/
"""

from __future__ import annotations

import collections
import dataclasses
import math
import queue
import threading
import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..midi import smf
from ..midi.codec import MelodyWriter, melody_from_ids, tokenize_track
from ..midi.vocab import PAD_ID, SOS_ID
from .decode import style_transfer_all_classes
from .sampler import load_inference_model


@dataclasses.dataclass
class TransferResult:
    """Per-request result: one output MIDI per target class."""

    midi_by_class: Dict[int, bytes]
    tokens_by_class: Dict[int, np.ndarray]


def _percentile(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile of an ascending list (p in [0, 100]):
    1-based rank ceil(p*N/100). (int(p*N/100) as a 0-based index is one
    rank high whenever p*N/100 is integral — p99 of 100 samples would
    return the max.)"""
    if not sorted_vals:
        return 0.0
    rank = math.ceil(p / 100.0 * len(sorted_vals))
    return sorted_vals[min(len(sorted_vals) - 1, max(0, rank - 1))]


class ServiceStats:
    """Thread-safe serving counters: request latency (enqueue -> callback),
    batch fill, and queue depth at batch formation.

    Latency samples ride a bounded
    deque so a long-lived service never grows host memory."""

    def __init__(self, max_samples: int = 65536):
        self._lock = threading.Lock()
        self._latencies_ms = collections.deque(maxlen=max_samples)
        self._batch_fills = collections.deque(maxlen=max_samples)
        self._served = 0
        self._batches = 0
        self._max_queue_depth = 0
        self._batch_errors = 0
        self._shed = 0

    def record_error(self) -> None:
        with self._lock:
            self._batch_errors += 1

    def record_shed(self) -> None:
        """A request rejected at admission by a bounded-queue engine
        (streaming.EngineOverloaded) — counted separately from served
        and from batch errors."""
        with self._lock:
            self._shed += 1

    def record_batch(self, fill: int, queue_depth_after: int,
                     latencies_ms: List[float],
                     served: Optional[int] = None) -> None:
        """``served`` defaults to ``fill`` (micro-batch loop: every row in
        the batch completes). The streaming engine passes it explicitly —
        there ``fill`` is slot occupancy and only the requests whose last
        per-class unit finished this segment count as served."""
        with self._lock:
            self._batches += 1
            self._served += fill if served is None else served
            self._batch_fills.append(fill)
            self._latencies_ms.extend(latencies_ms)
            self._max_queue_depth = max(
                self._max_queue_depth, queue_depth_after
            )

    def snapshot(self) -> Dict[str, float]:
        """-> requests served, batches, mean fill, queue-depth high-water,
        p50/p99/max request latency (ms). Safe to call while serving."""
        with self._lock:
            lat = sorted(self._latencies_ms)
            fills = list(self._batch_fills)
            served, batches = self._served, self._batches
            depth = self._max_queue_depth
            errors = self._batch_errors
            shed = self._shed
        return {
            "requests_served": served,
            "batches": batches,
            "batch_errors": errors,
            "requests_shed": shed,
            "mean_batch_fill": (sum(fills) / len(fills)) if fills else 0.0,
            "max_queue_depth": depth,
            "latency_p50_ms": _percentile(lat, 50),
            "latency_p99_ms": _percentile(lat, 99),
            "latency_max_ms": lat[-1] if lat else 0.0,
        }


class StyleTransferService:
    def __init__(
        self,
        model_folder: str,
        checkpoint: Optional[int] = -1,
        batch_size: int = 32,
        max_seq_len: int = 64,
        max_wait_ms: float = 10.0,
        seed: int = 0,
        mesh=None,
        buckets: Optional[List[int]] = None,
    ):
        """``mesh``: optional jax.sharding.Mesh — serve the micro-batch
        sharded over its data axis (params placed per the TP rules once,
        here). None = single-device fused path.

        ``buckets``: optional ascending sequence-length buckets (the
        length-bucketing idiom, SURVEY §5.7): each micro-batch runs at the
        smallest bucket >= its longest request instead of always padding
        to ``max_seq_len``. One compiled program per bucket (compiled on
        first use, cached by XLA thereafter); the generation budget scales
        with the bucket too (2*(bucket+1) decode steps), which is where
        the real win is — decode steps dominate the fused call. None
        disables bucketing (always ``max_seq_len``)."""
        self.model, self.params = load_inference_model(
            model_folder, checkpoint, max_seq_len
        )
        self.num_classes = self.model.config.decoder_config.num_classes
        self.batch_size = batch_size
        self.max_seq_len = max_seq_len
        self.max_wait_ms = max_wait_ms
        if buckets:
            bl = sorted(set(int(b) for b in buckets))
            if bl[-1] != max_seq_len:
                raise ValueError(
                    f"largest bucket ({bl[-1]}) must equal max_seq_len "
                    f"({max_seq_len})"
                )
            self.buckets = bl
        else:
            self.buckets = [max_seq_len]
        self.mesh = mesh
        if mesh is not None:
            from .sharded import prepare_params

            self.params = prepare_params(self.params, mesh)
        self._rng = jax.random.key(seed)
        # The threaded serving loop and direct transfer_tokens/submit_midi
        # callers may run concurrently; key splitting must not race.
        self._rng_lock = threading.Lock()
        self.stats = ServiceStats()
        self._writer = MelodyWriter()
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # jax.default_device contexts are thread-local: capture the caller's
        # device so the serving thread computes on the same one.
        self._device = jax.config.jax_default_device

    # -- request preparation -------------------------------------------

    def _tokens_from_midi(self, midi_bytes: bytes) -> np.ndarray:
        mf = smf.parse_midifile(midi_bytes)
        for track in mf.tracks:
            toks = tokenize_track(track)
            if len(toks):
                return toks[: self.max_seq_len]
        raise ValueError("no note events in MIDI request")

    def _pick_bucket(self, token_lists: List[np.ndarray]) -> int:
        """Smallest bucket covering the longest request in this batch."""
        longest = max(min(len(t), self.max_seq_len) for t in token_lists)
        for b in self.buckets:
            if b >= longest:
                return b
        return self.buckets[-1]

    def _make_batch(self, token_lists: List[np.ndarray], L: int):
        n = len(token_lists)
        tokens = np.full((self.batch_size, L + 1), PAD_ID, np.int32)
        tokens[:, 0] = SOS_ID
        seq_lens = np.ones((self.batch_size,), np.int32)
        for i in range(self.batch_size):
            toks = token_lists[i] if i < n else token_lists[0]  # pad w/ first
            m = min(len(toks), L)
            tokens[i, 1 : m + 1] = toks[:m]
            seq_lens[i] = m + 1
        return tokens, seq_lens

    # -- core fused call ------------------------------------------------

    def transfer_tokens(self, token_lists: List[np.ndarray]) -> List[TransferResult]:
        """Run one fused micro-batch; returns a result per request."""
        if self._device is not None:
            with jax.default_device(self._device):
                return self._transfer_tokens(token_lists)
        return self._transfer_tokens(token_lists)

    def _transfer_tokens(self, token_lists: List[np.ndarray]) -> List[TransferResult]:
        return self._finish(self._dispatch(token_lists), len(token_lists))

    def _dispatch(self, token_lists: List[np.ndarray]):
        """Issue the fused device call WITHOUT fetching the result.

        Returns the on-device sequence array; ``_finish`` fetches and
        detokenizes. The split is what lets the threaded loop overlap
        batch N's device time with batch N-1's host detokenization."""
        assert 0 < len(token_lists) <= self.batch_size
        bucket = self._pick_bucket(token_lists)
        tokens, seq_lens = self._make_batch(token_lists, bucket)
        with self._rng_lock:
            self._rng, key = jax.random.split(self._rng)
        if self.mesh is not None:
            from .sharded import sharded_style_transfer_all_classes

            seqs, _scores = sharded_style_transfer_all_classes(
                self.model,
                self.params,
                jnp.asarray(tokens),
                jnp.asarray(seq_lens),
                2 * (bucket + 1),
                self.num_classes,
                key,
                self.mesh,
                params_on_mesh=True,
            )
        else:
            seqs, _scores = style_transfer_all_classes(
                self.model,
                self.params,
                jnp.asarray(tokens),
                jnp.asarray(seq_lens),
                2 * (bucket + 1),
                self.num_classes,
                key,
            )
        return seqs

    def _finish(self, seqs, n_requests: int) -> List[TransferResult]:
        seqs = np.asarray(seqs)  # [C, B, T] (blocks until device done)
        results = []
        for i in range(n_requests):
            midi_by_class, tokens_by_class = {}, {}
            for c in range(self.num_classes):
                melody = melody_from_ids(seqs[c, i])
                tokens_by_class[c] = melody.tokens
                midi_by_class[c] = smf.dump_midifile(
                    self._writer.to_midifile(melody)
                )
            results.append(TransferResult(midi_by_class, tokens_by_class))
        return results

    def submit_midi(self, midi_bytes: bytes) -> TransferResult:
        """Blocking single-request convenience path."""
        return self.transfer_tokens([self._tokens_from_midi(midi_bytes)])[0]

    # -- continuous threaded loop ---------------------------------------

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def is_serving(self) -> bool:
        """True while the threaded loop is alive (liveness probes)."""
        return self._thread is not None and self._thread.is_alive()

    def enqueue(self, midi_bytes: bytes, callback) -> None:
        """Queue a request; ``callback(TransferResult)`` fires when served.

        If the batch fails, the callback receives the ``Exception``
        instead (fail-fast contract — check ``isinstance(r, Exception)``)."""
        self._queue.put(
            (self._tokens_from_midi(midi_bytes), callback, time.perf_counter())
        )

    def _collect_batch(self) -> Optional[List]:
        """Form one micro-batch: up to batch_size requests, flushed after
        max_wait_ms; None on an idle-poll timeout."""
        batch: List = []
        try:
            batch.append(self._queue.get(timeout=0.05))
        except queue.Empty:
            return None
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while len(batch) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _deliver(self, seqs, batch: List) -> None:
        results = self._finish(seqs, len(batch))
        now = time.perf_counter()
        self.stats.record_batch(
            fill=len(batch),
            queue_depth_after=self._queue.qsize(),
            latencies_ms=[(now - t0) * 1e3 for _, _, t0 in batch],
        )
        for (_, callback, _), result in zip(batch, results):
            # Per-callback isolation: one requester's raising callback must
            # not reach _loop's batch-level handler — that would re-invoke
            # EVERY callback in the batch with the exception, double-firing
            # requesters that already got their result and 500ing ones
            # whose results were computed fine.
            try:
                callback(result)
            except Exception:
                import logging

                self.stats.record_error()
                logging.getLogger(__name__).exception(
                    "result callback raised; other requests unaffected"
                )

    def _loop(self) -> None:
        """Sequential serving loop: collect a micro-batch, dispatch,
        deliver. A request's latency is queue wait + device + detokenize.

        Double-buffering (dispatch batch N+1 before delivering batch N)
        was implemented and measured at 75% of capacity — and rejected:
        host work per batch (fetch + detokenize) was small against the
        batch cycle, so there was nothing worth hiding, and every
        overlapped cycle taxed each request one extra batch turn (p50
        more than doubled). Not re-measured on the GPU. The
        _dispatch/_finish split this
        experiment introduced is kept — it is the right seam if a larger
        model (bigger device share) ever changes the trade."""
        import logging

        while self._running:
            batch = self._collect_batch()
            if not batch:
                continue
            # A failing batch (device error, bad callback) must not kill
            # the serving thread: its requesters' callbacks never fire
            # (they time out client-side), the error is counted, and the
            # loop keeps serving. Liveness stays honest via is_serving().
            try:
                if self._device is not None:
                    with jax.default_device(self._device):
                        self._deliver(
                            self._dispatch([t for t, _, _ in batch]), batch
                        )
                else:
                    self._deliver(
                        self._dispatch([t for t, _, _ in batch]), batch
                    )
            except Exception as exc:
                self.stats.record_error()
                logging.getLogger(__name__).exception(
                    "serving batch of %d failed; loop continues", len(batch)
                )
                # Fail the waiters FAST: each callback receives the
                # exception instead of a TransferResult, so HTTP handlers
                # 500 immediately rather than blocking their full client
                # timeout (which would pile up one stuck thread per
                # request for the duration of a persistent error).
                for _, callback, _ in batch:
                    try:
                        callback(exc)
                    except Exception:
                        pass
