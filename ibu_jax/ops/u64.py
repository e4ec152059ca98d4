"""u64 ↔ paired-u32 representation helpers.

Design constraint: JAX disables x64 by default (and the switch is
process-global), so packed 2-bit words (wire ``u64``) live on device as **lo/hi
``uint32`` pairs**. The wire stays little-endian ``u64``
(``/root/reference/src/constructs/record.rs:58-66``); these helpers are the
boundary conversions.

Device record layout ("SoA columns"): a ``(6, N) uint32`` matrix with rows

    0: barcode_lo   1: barcode_hi
    2: umi_lo       3: umi_hi
    4: index_lo     5: index_hi

chosen so the record axis ``N`` is the 128-lane axis and every row is a
contiguous vector — the device equivalent of the reference's
``&[Record]`` slice.
"""

from __future__ import annotations

import numpy as np

from ibu_jax.constructs.record import RECORD_DTYPE

#: Row indices of the (6, N) device column matrix.
ROW_BC_LO, ROW_BC_HI = 0, 1
ROW_UMI_LO, ROW_UMI_HI = 2, 3
ROW_IDX_LO, ROW_IDX_HI = 4, 5


def split_u64(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``uint64 (N,)`` → ``(lo, hi)`` uint32 views (zero-copy when contiguous).

    >>> lo, hi = split_u64(np.array([0x1_00000002], dtype=np.uint64))
    >>> int(lo[0]), int(hi[0])
    (2, 1)
    """
    x = np.ascontiguousarray(x, dtype=np.uint64)
    pairs = x.view(np.uint32).reshape(-1, 2)  # little-endian: [lo, hi]
    return pairs[:, 0], pairs[:, 1]


def join_u64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """``(lo, hi)`` uint32 → ``uint64 (N,)``.

    >>> x = np.array([0xFFFFFFFF_00000007], dtype=np.uint64)
    >>> bool(join_u64(*split_u64(x)) == x)
    True
    """
    out = np.empty((len(lo), 2), dtype=np.uint32)
    out[:, 0] = lo
    out[:, 1] = hi
    return out.view(np.uint64).reshape(-1)


def soa_from_records(records: np.ndarray) -> np.ndarray:
    """Structured record array → ``(6, N) uint32`` device column matrix.

    One transpose-copy on the host; the inverse of :func:`records_from_soa`.
    """
    if records.dtype != RECORD_DTYPE:
        raise ValueError(f"expected dtype {RECORD_DTYPE}, got {records.dtype}")
    flat = np.ascontiguousarray(records).view(np.uint32).reshape(-1, 6)
    return np.ascontiguousarray(flat.T)


def records_from_soa(soa: np.ndarray) -> np.ndarray:
    """``(6, N) uint32`` device column matrix → structured record array."""
    if soa.ndim != 2 or soa.shape[0] != 6 or soa.dtype != np.uint32:
        raise ValueError(f"expected (6, N) uint32, got {soa.shape} {soa.dtype}")
    flat = np.ascontiguousarray(np.asarray(soa).T)
    return flat.view(RECORD_DTYPE).reshape(-1)
