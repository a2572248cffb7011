"""Host->device input prefetching: overlap batch preparation and transfer
with device compute.

The reference's input path is synchronous host work inside the hot loop
(data.py:181-198 per-batch preprocessing). Here a background thread stages
upcoming batches (optionally already placed on the mesh's data axis) in a
small queue, so the accelerator never waits on the host — the usual
double-buffer (SURVEY.md §7 stage 8).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

import jax

from .dataset import Batch, RawBatch

_SENTINEL = object()


def prefetch_batches(
    batches: Iterable[Batch],
    size: int = 2,
    sharding: Optional[jax.sharding.Sharding] = None,
    place: bool = True,
) -> Iterator[Batch]:
    """Iterate ``batches`` with ``size`` batches staged ahead.

    When ``sharding`` is given (e.g. the mesh's data-axis NamedSharding),
    staging includes the host->device transfer, partitioned across the
    mesh; otherwise arrays are device_put to the default device.
    ``place=False`` stages HOST batches (preparation still overlaps
    compute, placement doesn't) — for consumers that re-batch before
    upload, e.g. multi-step dispatch stacking N batches into one
    transfer; placing here would bounce every array device->host->device.
    """
    q: "queue.Queue" = queue.Queue(maxsize=size)
    err: list = []

    # Resolve the placement in the CALLER's thread: jax.default_device
    # contexts are thread-local and would not apply inside the producer.
    target = sharding if sharding is not None else jax.config.jax_default_device

    def stage(batch):
        if not place:
            return batch
        if isinstance(batch, RawBatch):
            arrays = (batch.chunks, batch.classes)
            chunks, classes = (
                jax.device_put(arrays, target) if target is not None
                else jax.device_put(arrays)
            )
            return RawBatch(chunks=chunks, classes=classes,
                            n_valid=batch.n_valid)
        arrays = (batch.tokens, batch.seq_lens, batch.classes, batch.labels)
        if target is not None:
            tokens, seq_lens, classes, labels = jax.device_put(arrays, target)
        else:
            tokens, seq_lens, classes, labels = jax.device_put(arrays)
        return Batch(tokens=tokens, seq_lens=seq_lens, classes=classes,
                     labels=labels, n_valid=batch.n_valid)

    # The consumer can abandon this generator mid-epoch (early stop,
    # SIGINT-triggered return): a plain blocking q.put would then wedge the
    # producer forever, leaking the thread and the staged device buffers.
    # The producer polls a stop event instead, and the generator's finally
    # block sets it and drains the queue on close.
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for batch in batches:
                if stop.is_set() or not _put(stage(batch)):
                    return
        except BaseException as exc:  # propagate into the consumer
            err.append(exc)
        finally:
            # Polling put: a full queue on normal completion must not drop
            # the sentinel (the consumer would block on q.get forever);
            # on abandonment stop is set and the loop exits.
            _put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        if err:
            raise err[0]
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=10)


class PrefetchingDataset:
    """Dataset wrapper that prefetches every epoch's batches.

    Presents the same surface as ``Dataset`` so the Trainer can use it
    transparently.
    """

    def __init__(self, dataset, size: int = 2,
                 sharding: Optional[jax.sharding.Sharding] = None,
                 place: bool = True):
        self._dataset = dataset
        self._size = size
        self._sharding = sharding
        self._place = place

    def num_classes(self) -> int:
        return self._dataset.num_classes()

    def num_tokens(self) -> int:
        return self._dataset.num_tokens()

    def __getattr__(self, name):
        return getattr(self._dataset, name)

    def __iter__(self):
        return prefetch_batches(iter(self._dataset), self._size,
                                self._sharding, self._place)
