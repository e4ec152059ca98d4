"""Host-thread data-parallel engine.

Behavioral parity with the reference's ``ParallelReader`` implementation
(``/root/reference/src/io/mmap.rs:286-332``):

* ``num_threads == 0`` → all cores, otherwise ``min(requested, cores)``
  (``mmap.rs:292-296``);
* static contiguous partition: ``len // num_threads`` records per worker,
  remainder appended to the last worker (``mmap.rs:297-307``);
* each worker walks its shard in ``BATCH_SIZE`` windows, calling the
  processor per batch then ``on_batch_complete`` (``mmap.rs:311-320``);
* the first processor error aborts the run and is re-raised, wrapped per the
  reference's ``IbuError::Process`` semantics (``mmap.rs:326-329``,
  ``parallel.rs:113-116``).

Scaling note: CPython threads only scale when the per-batch work releases the
GIL (vectorized numpy, jax dispatch, native code). Per-record
:class:`ParallelProcessor` work is parity-only; production workloads should
use :class:`~ibu_jax.parallel.processor.BatchProcessor` (numpy/jax inside) or
the device-mesh engine in :mod:`ibu_jax.parallel.device`.
"""

from __future__ import annotations

import os
import threading

from ibu_jax.constructs.record import Record
from ibu_jax.errors import IbuError, into_ibu_error
from ibu_jax.io.mmap import BATCH_SIZE, MmapReader
from ibu_jax.parallel.processor import BatchProcessor, ParallelProcessor


def resolve_num_threads(num_threads: int) -> int:
    """``0`` → all cores; else clamp to core count (ref ``mmap.rs:292-296``).

    Negative counts are rejected (the reference's ``usize`` makes them
    unrepresentable; accepting them here would silently process nothing).
    """
    if num_threads < 0:
        raise ValueError(f"num_threads must be >= 0, got {num_threads}")
    cpus = os.cpu_count() or 1
    if num_threads == 0:
        return cpus
    return min(num_threads, cpus)


def partition(n: int, num_shards: int) -> list[tuple[int, int]]:
    """Static contiguous partition with remainder-to-last
    (ref ``mmap.rs:297-307``). Shard boundaries are identical to the
    reference's so multi-worker statistics match record-for-record."""
    if num_shards <= 0:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    per = n // num_shards
    rem = n % num_shards
    bounds = []
    for i in range(num_shards):
        start = i * per
        end = start + per + (rem if i == num_shards - 1 else 0)
        bounds.append((start, end))
    return bounds


def process_parallel(
    reader: MmapReader,
    processor: ParallelProcessor | BatchProcessor,
    num_threads: int = 0,
    batch_size: int = BATCH_SIZE,
) -> None:
    """Run ``processor`` over all records of ``reader`` with host threads."""
    num_threads = resolve_num_threads(num_threads)
    n = reader.len()
    bounds = partition(n, num_threads)
    batch_mode = isinstance(processor, BatchProcessor) or (
        hasattr(processor, "process_batch")
        and not hasattr(processor, "process_record")
    )

    errors: list[BaseException | None] = [None] * num_threads

    def worker(tid: int, start: int, end: int) -> None:
        thread_reader = reader.clone()
        thread_processor = processor.clone()
        thread_processor.set_tid(tid)
        try:
            batch_start = start
            while batch_start < end:
                batch_end = min(batch_start + batch_size, end)
                chunk = thread_reader.slice(batch_start, batch_end)
                if batch_mode:
                    thread_processor.process_batch(chunk)
                else:
                    for row in chunk:
                        thread_processor.process_record(
                            Record(
                                barcode=int(row["barcode"]),
                                umi=int(row["umi"]),
                                index=int(row["index"]),
                            )
                        )
                thread_processor.on_batch_complete()
                batch_start += batch_size
        except BaseException as e:  # noqa: BLE001 — a BaseException left
            # uncaught in a worker THREAD would be silently swallowed by
            # threading (the run would "succeed" on partial data), so
            # everything is captured; the join loop below re-raises
            # interrupts as themselves and wraps the rest (mmap.rs:326-329)
            errors[tid] = e

    threads = []
    for tid, (start, end) in enumerate(bounds):
        t = threading.Thread(target=worker, args=(tid, start, end), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()

    for e in errors:
        if e is not None:
            if isinstance(e, IbuError):
                raise e
            if not isinstance(e, Exception):
                raise e  # KeyboardInterrupt/SystemExit: as themselves
            raise into_ibu_error(e)
