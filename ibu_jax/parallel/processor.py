"""Processor protocols for the parallel engines.

The reference's extension point is ``ParallelProcessor`` with a per-record
callback (``/root/reference/src/parallel.rs:100-189``). A per-record Python
callback cannot be the hot path on any hardware, so this framework defines a
**batch-first** protocol as the primary interface and keeps the per-record
protocol for parity:

* :class:`ParallelProcessor` — reference-parity: ``process_record`` +
  ``on_batch_complete`` + ``set_tid``/``get_tid`` defaults
  (``parallel.rs:117,162-189``). Used by the host-thread engine.
* :class:`BatchProcessor` — batch-first: ``process_batch(records)`` receives a
  numpy structured-array view of up to ``BATCH_SIZE`` records. The host
  engine hands batches to it directly; the device engine converts batches to
  device columns and runs a jitted update. A ``BatchProcessor`` that defines
  jax-traceable ``init_state`` / ``update_state`` / ``reduce_spec`` can be
  lowered onto a device mesh (see :mod:`ibu_jax.parallel.device`), where
  ``on_batch_complete``'s shared-memory merge becomes a ``psum`` collective.
"""

from __future__ import annotations

from ibu_jax.constructs.record import Record


class ParallelProcessor:
    """Reference-parity per-record processor (ref ``parallel.rs:100-189``).

    Subclasses must be cheaply copyable via :meth:`clone` (default: a shallow
    ``copy``), mirroring the reference's ``Send + Clone`` bound. Thread-local
    accumulation happens in ``process_record``; merging into shared state
    happens in ``on_batch_complete``.

    Example — the reference's doctest pattern (``parallel.rs:47-99``):
    thread-local accumulation with a shared merge target (its
    ``Arc<Mutex<…>>`` becomes a plain shared list here — ``list.append``
    is atomic under the GIL):

    >>> import os, tempfile
    >>> import numpy as np
    >>> from ibu_jax import Header, MmapReader, Writer
    >>> from ibu_jax.constructs.record import RECORD_DTYPE
    >>> from ibu_jax.parallel import ParallelProcessor
    >>> class SumBarcodes(ParallelProcessor):
    ...     def __init__(self, totals):
    ...         self.local = 0       # thread-local accumulator
    ...         self.totals = totals  # shared merge target
    ...     def process_record(self, record):
    ...         self.local += record.barcode
    ...     def on_batch_complete(self):  # the merge point
    ...         self.totals.append(self.local)
    ...         self.local = 0
    ...     def clone(self):  # duplicate local state, share the target
    ...         return SumBarcodes(self.totals)
    >>> path = os.path.join(tempfile.mkdtemp(), "doc.ibu")
    >>> recs = np.zeros(100, dtype=RECORD_DTYPE)
    >>> recs["barcode"] = np.arange(100)
    >>> with Writer.from_path(path, Header.new(16, 12)) as w:
    ...     w.write_batch(recs)
    >>> processor = SumBarcodes([])
    >>> MmapReader(path).process_parallel(processor, num_threads=2)
    >>> sum(processor.totals)  # == 0 + 1 + ... + 99
    4950
    >>> os.remove(path)
    """

    def process_record(self, record: Record) -> None:
        raise NotImplementedError

    def on_batch_complete(self) -> None:
        """Called after each batch; merge thread-local state into shared state
        here (ref ``parallel.rs:162-164``). Default: no-op."""

    def set_tid(self, tid: int) -> None:
        """Default no-op, like the reference (``parallel.rs:179-183``)."""
        self._tid = tid

    def get_tid(self) -> int | None:
        return getattr(self, "_tid", None)

    def clone(self) -> "ParallelProcessor":
        """Deep copy by default — the analogue of Rust's derived ``Clone``,
        where owned fields (thread-local accumulators) are duplicated.

        Override when the processor holds intentionally-shared state (the
        reference's ``Arc<Mutex<…>>`` pattern): copy the thread-local parts
        and carry the shared references over. A shallow copy would silently
        share accumulators between workers and race.
        """
        import copy

        return copy.deepcopy(self)


class BatchProcessor:
    """Batch-first processor: the framework's primary extension point.

    ``process_batch`` receives a numpy structured array (zero-copy view of
    the mmap) of up to ``BATCH_SIZE`` records. Implementations should do
    vectorized numpy / jax work — this releases the GIL and keeps the hot
    loop out of Python. ``on_batch_complete`` retains the reference's merge
    semantics.
    """

    def process_batch(self, records) -> None:
        raise NotImplementedError

    def on_batch_complete(self) -> None:
        """Merge point after each batch. Default: no-op."""

    def set_tid(self, tid: int) -> None:
        self._tid = tid

    def get_tid(self) -> int | None:
        return getattr(self, "_tid", None)

    def clone(self) -> "BatchProcessor":
        """Deep copy by default; override to share global state (see
        :meth:`ParallelProcessor.clone`)."""
        import copy

        return copy.deepcopy(self)
