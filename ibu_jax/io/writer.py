"""Buffered IBU writer.

Behavioral parity with the reference writer
(``/root/reference/src/io/writer.rs:82-523``):

* the header is written immediately at construction (``writer.rs:129-143``)
  and — deliberately matching the reference — is **not** validated on write;
  only readers validate;
* a 48K-record (1,179,648-byte) internal buffer (``writer.rs:10``);
* batches larger than the buffer bypass it and go straight to the sink
  (``writer.rs:321-351``);
* ``new_headless`` omits the header for shard writers (``writer.rs:169-179``);
* ``ingest`` merges another (in-memory) writer's bytes and clears it — the
  shard-merge primitive (``writer.rs:477-482``);
* close/``__exit__``/GC auto-``finish`` (``writer.rs:519-523``).

Batch-first design note: the primary write path is :meth:`write_batch` on a
numpy structured array — one ``memoryview`` straight to the OS, no per-record
Python loop. ``write_record`` exists for parity and small jobs.
"""

from __future__ import annotations

import io
import sys
from typing import BinaryIO, Iterable, Iterator

import numpy as np

from ibu_jax.constructs.header import Header
from ibu_jax.constructs.record import RECORD_DTYPE, RECORD_SIZE, Record
from ibu_jax.errors import IbuIoError

#: 48K records, same as the reference (``writer.rs:10``).
DEFAULT_BUFFER_RECORDS: int = 48 * 1024
DEFAULT_BUFFER_SIZE: int = DEFAULT_BUFFER_RECORDS * RECORD_SIZE


class Writer:
    """Buffered writer of IBU record streams.

    Example — the reference's doctest pattern (``writer.rs:35-81``):

    >>> import numpy as np
    >>> from ibu_jax import Header, Record, Writer
    >>> from ibu_jax.constructs.record import RECORD_DTYPE
    >>> w = Writer.in_memory(Header.new(16, 12))
    >>> w.write_record(Record(barcode=1, umi=2, index=3))
    >>> w.write_batch(np.array([(4, 5, 6)], dtype=RECORD_DTYPE))
    >>> w.records_written
    2
    >>> w.finish()
    >>> len(w.inner.getvalue())  # 32-byte header + 2 * 24-byte records
    80

    Shard-and-merge via headless writers + :meth:`ingest`
    (``writer.rs:169-179,477-482``):

    >>> shard = Writer.in_memory()  # headless: no 32-byte header
    >>> shard.write_record(Record(barcode=7, umi=8, index=9))
    >>> w.ingest(shard)             # splice shard bytes, clear the shard
    >>> (w.records_written, len(shard.inner.getvalue()))
    (3, 0)
    """

    def __init__(
        self,
        inner: BinaryIO,
        header: Header | None,
        buffer_size: int = DEFAULT_BUFFER_SIZE,
    ):
        self._inner = inner
        # set by from_path for plain (uncompressed) disk files only: large
        # batches may then bypass the Python sink via the native threaded
        # pwrite engine (never for compressed/stdout/BytesIO sinks, whose
        # bytes must flow through the Python object)
        self._native_write = False
        # at least one record must fit or write_record cannot make progress
        self._buffer = bytearray(max(buffer_size, RECORD_SIZE))
        self._pos = 0
        self._records_written = 0
        self._finished = False
        self._wrote_header = header is not None
        if header is not None:
            self._write_all(header.as_bytes())

    # -- constructors -----------------------------------------------------

    @classmethod
    def new(cls, inner: BinaryIO, header: Header) -> "Writer":
        """Writer that emits ``header`` immediately (ref ``writer.rs:129-143``)."""
        return cls(inner, header)

    @classmethod
    def new_headless(cls, inner: BinaryIO) -> "Writer":
        """Writer that skips the header — for shard writers that will later be
        merged via :meth:`ingest` (ref ``writer.rs:169-179``)."""
        return cls(inner, None)

    @classmethod
    def from_path(
        cls,
        path: str,
        header: Header,
        compression: str | None = None,
        level: int | None = None,
        threads: int = -1,
    ) -> "Writer":
        """Open ``path`` and write ``header``.

        By default an uncompressed plain file, matching the reference
        (``writer.rs:556-559``). ``compression`` extends that (additively —
        the reference has no write-side compression): ``"gzip"``/``"zstd"``
        compress the output, ``"auto"`` infers from the extension
        (``.gz``/``.zst``/``.zstd``). Readers sniff magic bytes, so
        compressed files roundtrip through ``Reader.from_path`` unchanged.
        ``threads`` sets the zstd worker count (``-1`` = all cores —
        compression dominates a zstd write's CPU; see
        :func:`ibu_jax.io.compression.wrap_compress`).
        """
        if compression is None:
            try:
                f: BinaryIO = open(path, "wb")
            except OSError as e:
                raise IbuIoError(e) from e
            w = cls(f, header)
            w._native_write = True
            return w
        from ibu_jax.io.compression import open_compressed

        f = open_compressed(path, compression, level, threads)
        return cls(f, header)

    @classmethod
    def from_stdout(cls, header: Header) -> "Writer":
        """Write to standard output (ref ``writer.rs:587-589``)."""
        return cls(sys.stdout.buffer, header)

    @classmethod
    def from_optional_path(
        cls,
        path: str | None,
        header: Header,
        compression: str | None = None,
        level: int | None = None,
    ) -> "Writer":
        """``path=None`` → stdout (ref ``writer.rs:618-626``)."""
        if path is None:
            return cls.from_stdout(header)
        return cls.from_path(path, header, compression, level)

    @classmethod
    def in_memory(cls, header: Header | None = None) -> "Writer":
        """Writer over an in-memory buffer (the reference's ``Writer<Vec<u8>>``)."""
        return cls(io.BytesIO(), header)

    # -- accounting -------------------------------------------------------

    @property
    def records_written(self) -> int:
        """Total records accepted so far (ref ``writer.rs:207-209``)."""
        return self._records_written

    @property
    def inner(self) -> BinaryIO:
        return self._inner

    def into_inner(self) -> BinaryIO:
        """Detach and return the sink without flushing — caller should have
        called :meth:`finish` first (ref ``writer.rs:507-511``)."""
        self._finished = True
        return self._inner

    # -- the write paths --------------------------------------------------

    def _write_all(self, data: bytes | memoryview) -> None:
        try:
            mv = memoryview(data)
            while len(mv) > 0:
                n = self._inner.write(mv)
                if n is None:  # non-blocking sink; BinaryIO contract violation
                    raise IbuIoError("sink returned None from write")
                mv = mv[n:]
        except OSError as e:
            raise IbuIoError(e) from e

    def _flush_buffer(self) -> None:
        if self._pos > 0:
            self._write_all(memoryview(self._buffer)[: self._pos])
            self._pos = 0

    def write_record(self, record: Record) -> None:
        """Append one record (ref ``writer.rs:260-273``)."""
        if self._pos + RECORD_SIZE > len(self._buffer):
            self._flush_buffer()
        self._buffer[self._pos : self._pos + RECORD_SIZE] = record.as_bytes()
        self._pos += RECORD_SIZE
        self._records_written += 1

    def write_batch(self, records) -> None:
        """Append a batch — the batch-first hot path.

        Accepts a numpy structured array of ``RECORD_DTYPE`` (preferred,
        zero-copy) or any iterable of :class:`Record`. Batches larger than the
        internal buffer bypass it entirely (ref ``writer.rs:321-351``).
        """
        if isinstance(records, np.ndarray):
            if records.dtype != RECORD_DTYPE:
                raise ValueError(
                    f"write_batch expects dtype {RECORD_DTYPE}, got {records.dtype}"
                )
            arr = np.ascontiguousarray(records)
            self._write_slice(memoryview(arr).cast("B"), len(arr))
        else:
            records = list(records)
            data = b"".join(r.as_bytes() for r in records)
            self._write_slice(memoryview(data), len(records))

    #: threshold below which threaded pwrite is not worth the spawn cost
    _NATIVE_WRITE_MIN_BYTES = 8 << 20

    def _write_direct(self, data: memoryview) -> None:
        """Large-batch sink write: native threaded pwrite for plain disk
        files (page-cache writes are memcpy-bound and scale with cores),
        plain Python write otherwise."""
        if self._native_write and len(data) >= self._NATIVE_WRITE_MIN_BYTES:
            from ibu_jax import native

            if native.available():
                try:
                    self._inner.flush()
                    off = self._inner.tell()
                    fd = self._inner.fileno()
                except OSError:
                    # non-seekable sink behind a plain path (FIFO,
                    # /dev/stdout): positioned I/O is impossible — stream
                    # sequentially instead of failing
                    self._write_all(data)
                    return
                try:
                    # nthreads=1: page-cache writes serialize on the page
                    # allocator (measured 2T slower than 1T on tmpfs), so
                    # unlike reads, fan-out buys nothing here
                    native.pwrite_parallel(fd, data, off, nthreads=1)
                    self._inner.seek(off + len(data))
                except OSError as e:
                    raise IbuIoError(e) from e
                return
        self._write_all(data)

    def _write_slice(self, data: memoryview, num_records: int) -> None:
        if len(data) > len(self._buffer):
            # Direct path: skip the intermediate copy (ref writer.rs:325-331).
            self._flush_buffer()
            self._write_direct(data)
            self._records_written += num_records
            return
        remaining = data
        while len(remaining) > 0:
            available = len(self._buffer) - self._pos
            n = min(len(remaining), available)
            self._buffer[self._pos : self._pos + n] = remaining[:n]
            self._pos += n
            remaining = remaining[n:]
            if self._pos >= len(self._buffer):
                self._flush_buffer()
        self._records_written += num_records

    def write_iter(self, records: Iterable[Record] | Iterator[Record]) -> None:
        """Drain an iterator of records (ref ``writer.rs:388-396``)."""
        for record in records:
            self.write_record(record)

    def ingest(self, other: "Writer") -> None:
        """Merge another in-memory writer's bytes into this one, then clear it
        (ref ``writer.rs:477-482``). ``other`` must wrap a ``BytesIO`` and be
        **headless** — a headered source would splice its 32-byte header
        into this writer's record region, corrupting the file (the
        reference leaves this to convention; here it is enforced)."""
        if not isinstance(other._inner, io.BytesIO):
            raise TypeError("ingest requires the source writer to be in-memory")
        if other._wrote_header:
            raise ValueError(
                "ingest source must be headless (Writer.new_headless / "
                "Writer.in_memory()); its header bytes would corrupt the "
                "record stream"
            )
        other._flush_buffer()
        data = other._inner.getvalue()
        self._write_slice(memoryview(data), len(data) // RECORD_SIZE)
        other._inner.seek(0)
        other._inner.truncate(0)

    # -- teardown ---------------------------------------------------------

    def finish(self) -> None:
        """Flush the internal buffer and the sink (ref ``writer.rs:429-433``)."""
        self._flush_buffer()
        try:
            self._inner.flush()
        except OSError as e:
            raise IbuIoError(e) from e
        self._finished = True

    def close(self) -> None:
        """Finish, then close the sink.

        In-memory (``BytesIO``) and stdout sinks are left open so their
        contents remain accessible — mirroring the reference, where ``Drop``
        only flushes (``writer.rs:519-523``).
        """
        self.finish()
        # getattr: sys.stdout may be swapped for a bufferless wrapper
        # (doctest, pytest capture, notebooks) — close must not crash there
        if self._inner is not getattr(sys.stdout, "buffer", None) and not (
            isinstance(self._inner, io.BytesIO)
        ):
            self._inner.close()

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:  # best-effort, mirror Drop's `finish().ok()` (writer.rs:519-523)
            try:
                self.close()
            except Exception:
                pass

    def __del__(self):  # Drop safety net (ref writer.rs:519-523)
        if not self._finished:
            try:
                self.finish()
            except Exception:
                pass
