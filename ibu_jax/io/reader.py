"""Streaming IBU reader and bulk loader.

Behavioral parity with the reference reader
(``/root/reference/src/io/reader.rs:90-535``):

* the header is read and validated at construction (``reader.rs:152-176``);
* batched refills of a 48K-record buffer, looping the underlying ``read``
  until full or EOF (``reader.rs:218-242``);
* a refill whose byte count is not a multiple of 24 raises
  :class:`TruncatedRecord` with ``pos = bytes_read + complete_bytes``
  (``reader.rs:232-237``);
* ``bytes_read`` starts at 32 (the header) and tracks the stream position
  (``reader.rs:107-108,173``);
* ``from_path`` transparently decompresses gzip/zstd (``reader.rs:345-357``),
  ``from_stdin`` / ``from_optional_path`` mirror ``reader.rs:389-434``;
* :func:`load_to_vec` bulk-loads a plain (uncompressed) file, raising
  :class:`InvalidMapSize` when the record region is ragged
  (``reader.rs:510-535``).

Batch-first design note: the primary read path is :meth:`read_records` /
:meth:`batches`, which yield numpy structured arrays — ready for zero-copy
column extraction and ``jax.device_put``. The per-record iterator exists for
API parity; it is not the hot path.
"""

from __future__ import annotations

import os
import sys
from typing import BinaryIO, Iterator

import numpy as np

from ibu_jax.constructs.header import HEADER_SIZE, Header
from ibu_jax.constructs.record import RECORD_DTYPE, RECORD_SIZE, Record
from ibu_jax.errors import (
    CompressionError,
    IbuIoError,
    InvalidMapSize,
    TruncatedRecord,
)
from ibu_jax.io.compression import (
    DECOMPRESSION_ERRORS,
    open_decompressed,
    wrap_decompress,
)

#: 48K records per refill, same as the reference (``reader.rs:14``).
DEFAULT_BUFFER_RECORDS: int = 48 * 1024
DEFAULT_BUFFER_SIZE: int = DEFAULT_BUFFER_RECORDS * RECORD_SIZE


def _clone_stream(inner: BinaryIO, fallback_pos: int) -> BinaryIO:
    """Duplicate a binary stream with an independent read position.

    Supports :class:`io.BytesIO`, on-disk plain files (reopened by path —
    ``dup``'d fds would share their offset), and PATH-BACKED gzip/zstd
    decompression chains (re-opened and fast-forwarded ``fallback_pos``
    DECOMPRESSED bytes — compressed streams have no byte-position mapping
    to the file, so this costs O(pos) re-decompression).
    ``fallback_pos`` is the logical stream position (the Reader's
    ``bytes_read``), also used when a plain stream cannot ``tell()`` (the
    non-seekable sniffing wrapper). Raises :class:`TypeError` only for
    truly source-less streams (stdin/pipe chains) — the runtime analog of
    the reference's ``R: Clone`` bound (``reader.rs:90``), which is
    universal over any cloneable inner.
    """
    import io

    from ibu_jax.io.compression import _ChainClosing, reopen_decompressed_at

    if isinstance(inner, io.BytesIO):
        dup = io.BytesIO(inner.getvalue())
        dup.seek(inner.tell())
        return dup
    name = getattr(inner, "name", None)
    if isinstance(inner, _ChainClosing):
        # gzip/zstd chain: clone by re-open + skip, when a path backs it
        if isinstance(name, str) and os.path.isfile(name):
            return reopen_decompressed_at(name, fallback_pos)
        raise TypeError(
            "Reader over a source-less compressed stream (stdin/pipe) is "
            "not cloneable; path-backed compressed readers clone by "
            "re-open + skip (reference derive(Clone), reader.rs:90)"
        )
    if isinstance(name, str) and os.path.isfile(name):
        try:
            pos = inner.tell()
        except (OSError, ValueError, AttributeError):
            pos = fallback_pos
        dup = open(name, "rb")
        try:
            dup.seek(pos)
        except OSError:
            dup.close()
            raise
        return dup
    raise TypeError(
        f"Reader over {type(inner).__name__} is not cloneable; only "
        "BytesIO, plain disk files, and path-backed compressed streams "
        "support clone() (the reference requires R: Clone, reader.rs:90)"
    )


class Reader:
    """Buffered streaming reader of IBU record streams.

    Example — in-memory roundtrip, the reference's doctest pattern
    (``reader.rs:38-89``):

    >>> import io
    >>> import numpy as np
    >>> from ibu_jax import Header, Reader, Writer
    >>> from ibu_jax.constructs.record import RECORD_DTYPE
    >>> buf = io.BytesIO()
    >>> w = Writer.new(buf, Header.new(16, 12))
    >>> w.write_batch(np.array([(5, 6, 7), (8, 9, 10)], dtype=RECORD_DTYPE))
    >>> w.finish()
    >>> _ = buf.seek(0)
    >>> r = Reader(buf)
    >>> r.header().bc_len
    16
    >>> [rec.barcode for rec in r]  # per-record iterator (parity path)
    [5, 8]
    >>> r.bytes_read  # 32-byte header + 2 * 24-byte records
    80

    The hot path is batch-first — :meth:`read_records` / :meth:`batches`
    yield structured arrays ready for the device pipeline:

    >>> _ = buf.seek(0)
    >>> batch = next(Reader(buf).batches())
    >>> [int(u) for u in batch["umi"]]
    [6, 9]
    """

    def __init__(self, inner: BinaryIO, buffer_size: int = DEFAULT_BUFFER_SIZE):
        self._inner = inner
        header_bytes = self._read_exact(HEADER_SIZE)
        self._header = Header.from_bytes(header_bytes)
        self._header.validate()
        # round down to whole records (min 1): a ragged buffer that fills
        # completely would otherwise raise a spurious TruncatedRecord
        buffer_size = max(buffer_size - buffer_size % RECORD_SIZE, RECORD_SIZE)
        self._buffer = bytearray(buffer_size)
        self._pos = 0  # record position within the buffer
        self._cap = 0  # valid records in the buffer
        self._bytes_read = HEADER_SIZE
        self._eof = False

    # -- constructors -----------------------------------------------------

    @classmethod
    def from_path(cls, path: str) -> "Reader":
        """Open ``path``, transparently decompressing gzip/zstd
        (ref ``reader.rs:345-357``)."""
        return cls(open_decompressed(path))

    @classmethod
    def from_stdin(cls) -> "Reader":
        """Read from standard input, with decompression sniffing
        (ref ``reader.rs:389-401``)."""
        return cls(wrap_decompress(sys.stdin.buffer))

    @classmethod
    def from_optional_path(cls, path: str | None) -> "Reader":
        """``path=None`` → stdin (ref ``reader.rs:429-434``)."""
        if path is None:
            return cls.from_stdin()
        return cls.from_path(path)

    # -- clone (ref ``reader.rs:90`` derives Clone, tested ``:655-666``) ---

    def clone(self) -> "Reader":
        """Duplicate this reader, including its buffer state and stream
        position, for cloneable inner streams.

        The reference ``Reader<R>`` derives ``Clone`` whenever ``R: Clone``
        (``reader.rs:90``); its clone test duplicates a ``Cursor`` mid-stream
        and reads the remaining records from both (``reader.rs:655-666``).
        Python has no ``Clone`` bound, so cloneability is checked at runtime:

        * :class:`io.BytesIO` — duplicated with an independent position;
        * seekable plain files with a filesystem ``name`` — reopened and
          sought to the current offset (an independent fd, because ``dup``'d
          fds share their offset);
        * path-backed gzip/zstd chains — a fresh decompression chain over
          the same path, fast-forwarded to this reader's decompressed
          position (O(position) re-decompression: compressed streams have
          no byte-position mapping to the file);
        * truly source-less streams (stdin/pipe chains) raise
          :class:`TypeError`, the runtime analog of ``R: !Clone`` failing
          to compile.
        """
        new = object.__new__(Reader)
        new._inner = _clone_stream(self._inner, self._bytes_read)
        new._header = Header.from_bytes(self._header.as_bytes())
        new._buffer = bytearray(self._buffer)
        new._pos = self._pos
        new._cap = self._cap
        new._bytes_read = self._bytes_read
        new._eof = self._eof
        return new

    # -- accessors --------------------------------------------------------

    def header(self) -> Header:
        """A copy of the validated file header (ref ``reader.rs:274-276``)."""
        return Header.from_bytes(self._header.as_bytes())

    @property
    def bytes_read(self) -> int:
        """Total bytes consumed from the stream, including the header."""
        return self._bytes_read

    # -- refill machinery -------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        try:
            while got < n:
                chunk = self._inner.read(n - got)
                if not chunk:
                    raise IbuIoError(
                        f"unexpected end of stream: wanted {n} bytes, got {got}"
                    )
                chunks.append(chunk)
                got += len(chunk)
        # DECOMPRESSION_ERRORS first: gzip.BadGzipFile (bad CRC/member
        # header) subclasses OSError, and must map to the Niffler variant,
        # not to the generic I/O one
        except DECOMPRESSION_ERRORS as e:
            # torn/corrupt gzip or zstd stream → the reference's Niffler
            # error variant, so consumers see an IbuError (error.rs:69-70)
            raise CompressionError(e) from e
        except OSError as e:
            raise IbuIoError(e) from e
        return b"".join(chunks)

    def read_batch(self) -> bool:
        """Refill the internal buffer (ref ``reader.rs:218-242``).

        Returns ``True`` if any data was read, ``False`` at EOF. Raises
        :class:`TruncatedRecord` if the stream ended mid-record.
        """
        read = 0
        view = memoryview(self._buffer)
        try:
            while read < len(self._buffer):
                chunk = self._inner.read(len(self._buffer) - read)
                if not chunk:
                    break
                view[read : read + len(chunk)] = chunk
                read += len(chunk)
        # DECOMPRESSION_ERRORS first: BadGzipFile subclasses OSError
        except DECOMPRESSION_ERRORS as e:
            # gzip raises EOFError/zlib.error/BadGzipFile and zstd
            # ZstdError when the compressed stream itself is torn or
            # corrupt — distinct from a mid-record tear in DECOMPRESSED
            # bytes (TruncatedRecord below). Map to the reference's
            # Niffler variant (error.rs:69-70) so whole-file tools
            # (check_file, concat) can catch IbuError.
            raise CompressionError(e) from e
        except OSError as e:
            raise IbuIoError(e) from e
        if read % RECORD_SIZE != 0:
            non_rem = read - read % RECORD_SIZE
            raise TruncatedRecord(pos=self._bytes_read + non_rem)
        self._pos = 0
        self._cap = read // RECORD_SIZE
        self._bytes_read += read
        return read > 0

    # -- batch-first API (the hot path) -----------------------------------

    def read_records(self) -> np.ndarray | None:
        """Return the next refill as a structured record array, or ``None`` at
        EOF. Consumes any records not yet taken by the iterator."""
        if self._pos >= self._cap:
            if self._eof or not self.read_batch():
                self._eof = True
                return None
        start = self._pos * RECORD_SIZE
        end = self._cap * RECORD_SIZE
        out = np.frombuffer(
            memoryview(self._buffer)[start:end], dtype=RECORD_DTYPE
        ).copy()
        self._pos = self._cap
        return out

    def batches(self) -> Iterator[np.ndarray]:
        """Iterate over the stream as structured record arrays."""
        while True:
            batch = self.read_records()
            if batch is None:
                return
            yield batch

    # -- per-record iterator (parity path, ref reader.rs:279-306) ---------

    def __iter__(self) -> Iterator[Record]:
        return self

    def __next__(self) -> Record:
        if self._eof:
            raise StopIteration
        if self._pos >= self._cap:
            if not self.read_batch():
                self._eof = True
                raise StopIteration
        lpos = self._pos * RECORD_SIZE
        record = Record.from_bytes(bytes(self._buffer[lpos : lpos + RECORD_SIZE]))
        self._pos += 1
        return record

    def close(self) -> None:
        self._inner.close()

    def __enter__(self) -> "Reader":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def load_to_vec(path: str) -> tuple[Header, np.ndarray]:
    """Bulk-load an uncompressed IBU file (ref ``reader.rs:510-535``).

    Validates the header, checks ``(filesize - 32) % 24 == 0`` (raising
    :class:`InvalidMapSize` otherwise, ``reader.rs:520-524``), and reads the
    record region in one shot into a structured array. Like the reference,
    this path does NOT sniff compression — it is the raw-file fast path.

    Large files (≥8 MB) route through the native runtime's threaded
    ``pread`` engine when available: page-cache reads are memcpy-bound, so
    disjoint-range reads scale with cores where ``np.fromfile`` is pinned
    to one.

    >>> import os, tempfile
    >>> import numpy as np
    >>> from ibu_jax import Header, Writer, load_to_vec
    >>> from ibu_jax.constructs.record import RECORD_DTYPE
    >>> path = os.path.join(tempfile.mkdtemp(), "doc.ibu")
    >>> with Writer.from_path(path, Header.new(16, 12)) as w:
    ...     w.write_batch(np.array([(1, 2, 3), (4, 5, 6)], dtype=RECORD_DTYPE))
    >>> header, records = load_to_vec(path)
    >>> (header.umi_len, len(records), int(records["index"][1]))
    (12, 2, 6)
    >>> os.remove(path)
    """
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            header_bytes = f.read(HEADER_SIZE)
            if len(header_bytes) < HEADER_SIZE:
                raise IbuIoError(
                    f"unexpected end of file: wanted {HEADER_SIZE} bytes, "
                    f"got {len(header_bytes)}"
                )
            header = Header.from_bytes(header_bytes)
            header.validate()
            data_size = size - HEADER_SIZE
            if data_size % RECORD_SIZE != 0:
                raise InvalidMapSize()
            n = data_size // RECORD_SIZE
            records = _bulk_read(f, n)
            if len(records) != n:
                raise IbuIoError(
                    f"short read: wanted {n} records, got {len(records)}"
                )
            return header, records
    except OSError as e:
        raise IbuIoError(e) from e


#: threshold below which threaded pread is not worth the spawn cost
_NATIVE_READ_MIN_BYTES = 8 << 20


def _bulk_read(f: BinaryIO, n: int) -> np.ndarray:
    """Read ``n`` records from ``f`` (positioned after the header)."""
    if n * RECORD_SIZE >= _NATIVE_READ_MIN_BYTES:
        from ibu_jax import native

        if native.available():
            out = np.empty(n, dtype=RECORD_DTYPE)
            native.pread_parallel(f.fileno(), out, HEADER_SIZE)
            return out
    return np.fromfile(f, dtype=RECORD_DTYPE, count=n)
