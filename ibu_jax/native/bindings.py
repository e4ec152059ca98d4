"""ctypes bindings for the native host runtime.

Graceful degradation: if the toolchain is unavailable the library reports
``available() == False`` and callers fall back to the numpy paths; nothing
in :mod:`ibu_jax` hard-requires native code.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ibu_jax.constructs.record import RECORD_DTYPE
from ibu_jax.native.build import NativeBuildError, build

_lib: ctypes.CDLL | None = None
_load_error: str | None = None


def _load() -> ctypes.CDLL | None:
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        path = build()
        lib = ctypes.CDLL(path)
    except (NativeBuildError, OSError) as e:
        _load_error = str(e)
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.ibu_write_file.argtypes = [ctypes.c_char_p, u8p, u8p, ctypes.c_uint64]
    lib.ibu_write_file.restype = ctypes.c_int
    lib.ibu_read_file.argtypes = [
        ctypes.c_char_p, u8p, ctypes.c_uint64, ctypes.c_uint64,
    ]
    lib.ibu_read_file.restype = ctypes.c_int
    lib.ibu_file_size.argtypes = [ctypes.c_char_p, u64p]
    lib.ibu_file_size.restype = ctypes.c_int
    lib.ibu_pread_parallel.argtypes = [
        ctypes.c_int, u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.ibu_pread_parallel.restype = ctypes.c_int
    lib.ibu_pwrite_parallel.argtypes = [
        ctypes.c_int, u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.ibu_pwrite_parallel.restype = ctypes.c_int
    lib.ibu_checksum_parallel.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, u64p, ctypes.c_int,
    ]
    lib.ibu_checksum_parallel.restype = ctypes.c_int
    lib.ibu_pack_2bit.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_uint32, u64p, ctypes.c_int,
    ]
    lib.ibu_pack_2bit.restype = ctypes.c_int
    lib.ibu_unpack_2bit.argtypes = [
        u64p, ctypes.c_uint64, ctypes.c_uint32, u8p,
    ]
    lib.ibu_unpack_2bit.restype = ctypes.c_int
    lib.ibu_pack_2bit_mt.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_uint32, u64p, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.ibu_pack_2bit_mt.restype = ctypes.c_int
    lib.ibu_unpack_2bit_mt.argtypes = [
        u64p, ctypes.c_uint64, ctypes.c_uint32, u8p, ctypes.c_int,
    ]
    lib.ibu_unpack_2bit_mt.restype = ctypes.c_int
    lib.ibu_fastq_gather.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_uint64, u8p, ctypes.c_uint64, u64p,
    ]
    lib.ibu_fastq_gather.restype = ctypes.c_int
    lib.ibu_sort_records.argtypes = [u8p, ctypes.c_uint64]
    lib.ibu_sort_records.restype = ctypes.c_int
    lib.ibu_sort_file.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.ibu_sort_file.restype = ctypes.c_int
    lib.ibu_merge_files.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint64, ctypes.c_char_p,
    ]
    lib.ibu_merge_files.restype = ctypes.c_int
    lib.ibu_sort_chunks_range.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_int,
    ]
    lib.ibu_sort_chunks_range.restype = ctypes.c_int
    lib.ibu_run_interval.argtypes = [
        ctypes.c_char_p, u64p, u64p, ctypes.c_int, u64p,
    ]
    lib.ibu_run_interval.restype = ctypes.c_int
    lib.ibu_merge_runs_interval.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint64, u64p, u64p,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64,
    ]
    lib.ibu_merge_runs_interval.restype = ctypes.c_int
    lib.ibu_merge_runs_interval_mt.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint64, u64p, u64p,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_uint64,
    ]
    lib.ibu_merge_runs_interval_mt.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library could be built and loaded."""
    return _load() is not None


def load_error() -> str | None:
    _load()
    return _load_error


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise OSError(-rc, f"native {what} failed: {os.strerror(-rc)}")


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u64ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def write_file(path: str, header_bytes: bytes | None, records: np.ndarray) -> None:
    """Header + record-batch file write in one native call."""
    lib = _load()
    assert lib is not None
    records = np.ascontiguousarray(records)
    hdr = None
    if header_bytes is not None:
        if len(header_bytes) != 32:
            raise ValueError("header must be 32 bytes")
        hdr = (ctypes.c_uint8 * 32).from_buffer_copy(header_bytes)
    _check(
        lib.ibu_write_file(
            path.encode(), hdr, _u8ptr(records.view(np.uint8).reshape(-1)),
            records.nbytes,
        ),
        "write_file",
    )


def read_records(path: str, n_records: int, offset: int = 32) -> np.ndarray:
    """Bulk-read ``n_records`` records starting at byte ``offset``."""
    lib = _load()
    assert lib is not None
    out = np.empty(n_records, dtype=RECORD_DTYPE)
    _check(
        lib.ibu_read_file(
            path.encode(), _u8ptr(out.view(np.uint8).reshape(-1)),
            out.nbytes, offset,
        ),
        "read_records",
    )
    return out


def pread_parallel(
    fd: int, out: np.ndarray, offset: int, nthreads: int = 0
) -> None:
    """Threaded ``pread`` of ``out.nbytes`` bytes at ``offset`` into ``out``.

    Page-cache reads are memcpy-bound; splitting disjoint ranges across
    cores scales them. ``out`` must be contiguous and writeable. The fd's
    file offset is untouched.
    """
    lib = _load()
    assert lib is not None
    assert out.flags.c_contiguous and out.flags.writeable
    _check(
        lib.ibu_pread_parallel(
            fd, _u8ptr(out.view(np.uint8).reshape(-1)), out.nbytes, offset,
            nthreads,
        ),
        "pread_parallel",
    )


def pwrite_parallel(
    fd: int, data, offset: int, nthreads: int = 0
) -> None:
    """Threaded ``pwrite`` of ``data`` (buffer-protocol bytes) at ``offset``.

    Disjoint-range pwrites are safe concurrently and extend the file past
    EOF. The fd's file offset is untouched — the caller repositions its
    own stream if it mixes this with buffered writes.
    """
    lib = _load()
    assert lib is not None
    arr = np.frombuffer(data, dtype=np.uint8)
    _check(
        lib.ibu_pwrite_parallel(fd, _u8ptr(arr), arr.nbytes, offset, nthreads),
        "pwrite_parallel",
    )


def file_size(path: str) -> int:
    lib = _load()
    assert lib is not None
    out = ctypes.c_uint64(0)
    _check(lib.ibu_file_size(path.encode(), ctypes.byref(out)), "file_size")
    return out.value


def checksum_parallel(path: str, n_records: int, nthreads: int = 0) -> tuple[int, int, int]:
    """Native mmap + threads field-sum engine (reference parity path)."""
    lib = _load()
    assert lib is not None
    out = (ctypes.c_uint64 * 3)()
    _check(
        lib.ibu_checksum_parallel(path.encode(), n_records, out, nthreads),
        "checksum_parallel",
    )
    return int(out[0]), int(out[1]), int(out[2])


def pack_2bit(
    ascii_rows: np.ndarray, validate: bool = True, nthreads: int = 0
) -> np.ndarray:
    """``(N, L)`` ASCII → ``(N,)`` u64 (host codec; bitnuc semantics).

    Row-parallel across ``nthreads`` (0 → all cores) above 64K rows —
    the host codec is the transport-starved fallback engine for
    ingest/export and scales with cores like the checksum engine.
    """
    lib = _load()
    assert lib is not None
    ascii_rows = np.ascontiguousarray(ascii_rows, dtype=np.uint8)
    n, L = ascii_rows.shape
    out = np.empty(n, dtype=np.uint64)
    rc = lib.ibu_pack_2bit_mt(
        _u8ptr(ascii_rows.reshape(-1)), n, L, _u64ptr(out),
        1 if validate else 0, nthreads,
    )
    if rc == -22:  # EINVAL: invalid base (validate=True) or bad length
        raise ValueError("invalid nucleotide or length in pack_2bit")
    _check(rc, "pack_2bit")
    return out


def unpack_2bit(
    words: np.ndarray, length: int, nthreads: int = 0
) -> np.ndarray:
    """``(N,)`` u64 → ``(N, L)`` uppercase ASCII (row-parallel)."""
    lib = _load()
    assert lib is not None
    words = np.ascontiguousarray(words, dtype=np.uint64)
    out = np.empty((len(words), length), dtype=np.uint8)
    _check(
        lib.ibu_unpack_2bit_mt(
            _u64ptr(words), len(words), length, _u8ptr(out.reshape(-1)),
            nthreads,
        ),
        "unpack_2bit",
    )
    return out


def sort_file(
    in_path: str,
    out_path: str,
    chunk_records: int = 0,
    nthreads: int = 0,
) -> None:
    """Out-of-core external merge sort of a whole IBU file.

    Sorts ``in_path`` (which may exceed RAM) into ``out_path`` with the
    header's sorted flag set: chunked parallel in-memory sorts spill
    headerless runs, then a k-way merge streams the result.
    ``chunk_records=0`` → ~32 MB chunks; ``nthreads=0`` → all cores.
    """
    lib = _load()
    assert lib is not None
    rc = lib.ibu_sort_file(
        in_path.encode(), out_path.encode(), chunk_records, nthreads
    )
    if rc == -22:
        from ibu_jax.errors import InvalidMapSize

        raise InvalidMapSize()
    _check(rc, "sort_file")


def sort_records(records: np.ndarray) -> np.ndarray:
    """Lexicographic sort of a structured record array; returns the sorted
    array.

    Sorts in place when the input is contiguous and writeable; otherwise
    (read-only memmaps, strided views) a contiguous copy is sorted and
    returned — the caller must use the return value either way.
    """
    lib = _load()
    assert lib is not None
    if records.dtype != RECORD_DTYPE:
        raise ValueError(f"expected dtype {RECORD_DTYPE}")
    if not (records.flags.c_contiguous and records.flags.writeable):
        records = np.array(records)  # writable contiguous copy
    _check(
        lib.ibu_sort_records(
            _u8ptr(records.view(np.uint8).reshape(-1)), len(records)
        ),
        "sort_records",
    )
    return records


def fastq_gather(
    data, first_lineno: int, prefix_len: int, start_cap: int | None = None
) -> tuple[np.ndarray, int, int, bool, int, int]:
    """Prefix rows of the sequence lines among ``data``'s complete lines.

    The native FASTQ chunk parser (memchr scan + per-read prefix memcpy):
    returns ``(rows, consumed, lines, capped, err_line, err_content)``
    where ``rows`` is an ``(N, prefix_len)`` uint8 array, ``consumed`` is
    the byte offset after the last processed line, ``lines`` the number
    of processed lines, and ``capped`` whether a line at/after
    ``start_cap`` stopped processing (the byte-range shard cut). A
    sequence line shorter than ``prefix_len`` returns with
    ``err_line >= 0`` instead of raising — the caller owns the
    user-facing message (and its exact wording).
    """
    lib = _load()
    assert lib is not None
    arr = np.frombuffer(data, dtype=np.uint8)
    # sequence-line bound: a seq line costs prefix_len+1 bytes and its 3
    # sibling lines at least 1 byte each ('\n' — name/plus/qual lines may
    # all be EMPTY; short qual lines are legal input to this parser), so
    # S seq lines need >= S*(prefix_len+4) - 3 bytes. The earlier
    # prefix_len+7 bound assumed non-empty siblings and crashed with
    # ENOMEM on empty-qual FASTQs the numpy path parses fine.
    max_rows = (len(arr) + 3) // (prefix_len + 4) + 2
    rows = np.empty((max_rows, prefix_len), dtype=np.uint8)
    out = np.zeros(6, dtype=np.uint64)
    rc = lib.ibu_fastq_gather(
        _u8ptr(arr), len(arr), first_lineno, prefix_len,
        (1 << 63) if start_cap is None else start_cap,
        _u8ptr(rows.reshape(-1)), max_rows, _u64ptr(out),
    )
    if rc == -22:  # short sequence line: caller formats the error
        return (
            rows[: int(out[0])], int(out[1]), int(out[2]), bool(out[3]),
            int(out[4]), int(out[5]),
        )
    _check(rc, "fastq_gather")
    return rows[: int(out[0])], int(out[1]), int(out[2]), bool(out[3]), -1, 0


def sort_chunks_range(
    in_path: str,
    run_prefix: str,
    start_rec: int,
    n_rec: int,
    chunk_records: int = 0,
    nthreads: int = 0,
) -> list[str]:
    """Sorted HEADERLESS runs of a record range of an IBU file.

    Phase 1 of the external sort generalized to a range — the per-rank
    stage of the pod-wide host sort. Returns the run paths
    (``{run_prefix}.runK``); the caller owns their cleanup.
    """
    lib = _load()
    assert lib is not None
    rc = lib.ibu_sort_chunks_range(
        in_path.encode(), run_prefix.encode(), start_rec, n_rec,
        chunk_records, nthreads,
    )
    if rc == -22:
        from ibu_jax.errors import InvalidMapSize

        raise InvalidMapSize()
    _check(min(rc, 0), "sort_chunks_range")
    return [f"{run_prefix}.run{k}" for k in range(rc)]


def _triple_arg(key) -> np.ndarray:
    arr = np.asarray(list(key), dtype=np.uint64)
    if arr.shape != (3,):
        raise ValueError(f"key must be a (barcode, umi, index) triple: {key}")
    return arr


def run_interval(
    run_path: str, lo, hi=None
) -> tuple[int, int]:
    """``[start, end)`` record indices of keys in ``[lo, hi)`` within a
    sorted headerless run (``hi=None`` → unbounded above). O(log) page
    touches — the counting pass of the pod-wide host sort."""
    lib = _load()
    assert lib is not None
    lo_a = _triple_arg(lo)
    hi_a = _triple_arg(hi) if hi is not None else np.zeros(3, np.uint64)
    out = np.zeros(2, dtype=np.uint64)
    _check(
        lib.ibu_run_interval(
            run_path.encode(), _u64ptr(lo_a), _u64ptr(hi_a),
            1 if hi is None else 0, _u64ptr(out),
        ),
        "run_interval",
    )
    return int(out[0]), int(out[1])


def merge_runs_interval(
    run_paths: list[str], lo, hi, out_path: str, out_byte_offset: int,
    nthreads: int = 0, expect_records: int | None = None,
) -> None:
    """k-way merge of the ``[lo, hi)`` key interval of every sorted
    headerless run, pwritten into the EXISTING ``out_path`` at
    ``out_byte_offset`` (``hi=None`` → unbounded above).

    The per-rank terminal stage of the pod-wide host sort: each rank
    merges its key range directly into its slice of the shared
    pre-truncated output — no post-merge concatenation pass. The merge
    is key-range-parallel across ``nthreads`` (0 → all cores; sampled
    sub-splitters, byte-identical output for any splitter choice). Run
    order is verified while merging (``EILSEQ`` on violation, like
    :func:`merge_files`); ``expect_records`` cross-checks the interval's
    total so a partition bug aborts instead of writing silent zeros.
    """
    lib = _load()
    assert lib is not None
    if not run_paths:
        return
    lo_a = _triple_arg(lo)
    hi_a = _triple_arg(hi) if hi is not None else np.zeros(3, np.uint64)
    arr = (ctypes.c_char_p * len(run_paths))(
        *[p.encode() for p in run_paths]
    )
    _check(
        lib.ibu_merge_runs_interval_mt(
            arr, len(run_paths), _u64ptr(lo_a), _u64ptr(hi_a),
            1 if hi is None else 0, out_path.encode(), out_byte_offset,
            nthreads,
            (1 << 64) - 1 if expect_records is None else expect_records,
        ),
        "merge_runs_interval",
    )


def merge_files(in_paths: list[str], out_path: str) -> None:
    """k-way merge of ALREADY-SORTED IBU files into one sorted file.

    The streaming counterpart of the reference's shard-merge idiom
    (headless ``Writer`` + ``ingest``, ``writer.rs:169-179,477-482``) for
    sorted shards: inputs are merged by a priority queue in one pass with
    bounded memory, never concatenated-then-resorted. Headers must agree
    on (bc_len, umi_len) and carry the sorted flag; an input whose records
    are not actually in order aborts with ``EILSEQ`` ("Invalid or
    incomplete multibyte or wide character" per strerror) rather than
    emitting a mis-sorted file.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_load_error}")
    if not in_paths:
        raise ValueError("merge_files needs at least one input")
    # out_path aliasing an input would O_TRUNC that input mid-merge and
    # then unlink it on the resulting failure — refuse up front
    for p in in_paths:
        if os.path.exists(p) and os.path.exists(out_path):
            same = os.path.samefile(p, out_path)
        else:
            same = os.path.realpath(p) == os.path.realpath(out_path)
        if same:
            raise ValueError(
                f"output {out_path!r} is the same file as input {p!r}; "
                "merge to a different path"
            )
    from ibu_jax.constructs.header import Header

    first = None
    for p in in_paths:
        with open(p, "rb") as f:
            h = Header.from_bytes(f.read(32))
        h.validate()
        if not h.sorted():
            raise ValueError(f"{p}: sorted flag not set; sort it first")
        if first is None:
            first = (h.bc_len, h.umi_len)
        elif (h.bc_len, h.umi_len) != first:
            raise ValueError(
                f"{p}: header (bc_len={h.bc_len}, umi_len={h.umi_len}) "
                f"differs from {in_paths[0]} {first}"
            )
    arr = (ctypes.c_char_p * len(in_paths))(
        *[p.encode() for p in in_paths]
    )
    _check(
        lib.ibu_merge_files(arr, len(in_paths), out_path.encode()),
        "merge_files",
    )
