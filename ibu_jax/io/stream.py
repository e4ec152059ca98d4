"""Host→device streaming with prefetch.

The device analogue of the reference's buffered refill loop
(``/root/reference/src/io/reader.rs:218-242``): while the device crunches
batch *k*, the host is already mapping/slicing batch *k+1* and its transfer
is in flight. Because jax dispatch is asynchronous, "double buffering" here
means keeping a bounded queue of placed-but-unconsumed device batches;
depth 2 is classic double buffering, and the default is
:data:`ibu_jax.io.mmap.STREAM_PREFETCH` (4).

Batches are shipped in **wire layout** (``(B, 6) uint32``, a zero-copy view
of the mmap) and transposed to columns on device — the host never touches
record bytes (see :func:`ibu_jax.parallel.device.as_raw_u32`).
"""

from __future__ import annotations

from collections import deque
from typing import Iterator

import numpy as np

from ibu_jax.io.mmap import STREAM_BATCH_RECORDS, STREAM_PREFETCH, MmapReader


def prefetched(items, depth: int):
    """Iterate ``items`` with up to ``depth`` values produced ahead of the
    consumer — the bounded-queue prefetch policy shared by every streaming
    engine (single-process :class:`DeviceStream` and the multihost placed
    loop). Production work (mmap fault, host→device placement dispatch)
    for upcoming items overlaps the consumer's asynchronous step
    execution; the queue refills both before AND after each yield so the
    pipeline stays primed while the consumer computes.
    """
    depth = max(1, depth)
    queue: deque = deque()
    it = iter(items)
    exhausted = False

    def fill():
        nonlocal exhausted
        while not exhausted and len(queue) < depth:
            try:
                queue.append(next(it))
            except StopIteration:
                exhausted = True

    while True:
        fill()
        if not queue:
            return
        item = queue.popleft()
        fill()  # keep the pipeline primed while the consumer computes
        yield item


def thread_prefetched(items, depth: int = 2):
    """Produce ``items`` in a BACKGROUND THREAD, up to ``depth`` ahead.

    :func:`prefetched` overlaps production only with the consumer's
    *asynchronous device* work (production still runs on the consumer's
    thread); this variant moves production onto its own thread, so
    CPU-bound producers — gzip/zstd decompression, FASTQ parsing — overlap
    with the consumer's own CPU work too (numpy holds the GIL only inside
    C loops, so parse and encode genuinely interleave). Exceptions raised
    by the producer re-raise at the consumer's next pull; abandoning the
    generator (early ``break``/``close``) stops the producer promptly
    instead of leaving it blocked on a full queue.
    """
    import queue as _queue
    import threading

    q: _queue.Queue = _queue.Queue(maxsize=max(1, depth))
    END = object()
    stop = threading.Event()
    err: list = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                pass
        return False

    def produce():
        try:
            for item in items:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            err.append(e)
        finally:
            _put(END)

    t = threading.Thread(target=produce, daemon=True, name="ibu-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


class DeviceStream:
    """Prefetching iterator of device-placed record batches.

    Yields ``(device_raw, valid_counts)`` pairs as produced by
    :func:`ibu_jax.parallel.device.shard_batch`, keeping up to ``prefetch``
    batches in flight ahead of the consumer (via :func:`prefetched`).
    """

    def __init__(
        self,
        batches: Iterator[np.ndarray],
        mesh=None,
        prefetch: int = STREAM_PREFETCH,
        placer=None,
        with_hint: bool = False,
    ):
        from ibu_jax.parallel.device import default_placer, make_mesh

        self._batches = iter(batches)
        self._mesh = mesh or make_mesh()
        self._placer = placer or default_placer
        self._with_hint = with_hint
        self._iter = prefetched(self._place_all(), prefetch)

    def _place_all(self):
        from ibu_jax.parallel.device import (
            as_raw_u32,
            bc16_hint,
            shard_batch,
        )

        for batch in self._batches:
            item = shard_batch(batch, self._mesh, self._placer)
            if self._with_hint:
                # hint computed before placement (the pages are about to
                # be DMA'd anyway)
                item = item + (bc16_hint(as_raw_u32(batch)),)
            yield item

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._iter)


def stream_file(
    path_or_reader: str | MmapReader,
    mesh=None,
    batch_records: int = STREAM_BATCH_RECORDS,
    prefetch: int = STREAM_PREFETCH,
    with_hint: bool = False,
) -> DeviceStream:
    """Stream an IBU file to the device mesh with prefetch.

    ``batch_records`` is rounded to a mesh-size multiple so every placement
    is host-copy-free (zero-copy mmap view → device DMA).
    """
    from ibu_jax.parallel.device import make_mesh, record_batches_from_mmap

    reader = (
        path_or_reader
        if isinstance(path_or_reader, MmapReader)
        else MmapReader(path_or_reader)
    )
    mesh = mesh or make_mesh()
    s = mesh.devices.size
    batch_records = max(s, (batch_records // s) * s)
    return DeviceStream(
        record_batches_from_mmap(reader, batch_records),
        mesh=mesh,
        prefetch=prefetch,
        with_hint=with_hint,
    )
