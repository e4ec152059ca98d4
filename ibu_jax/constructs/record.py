"""The 24-byte IBU record and batch-first record arrays.

Wire layout is byte-exact with the reference
(``/root/reference/src/constructs/record.rs:58-66``): three little-endian
``u64`` fields ``barcode``, ``umi``, ``index``. The 2-bit nucleotide table
(A=00, C=01, G=10, T=11, base *i* at bits ``2i``) is documented at
``record.rs:19-27``; the codec itself lives in :mod:`ibu_jax.ops.codec`.

Batch-first design note: where the reference is record-at-a-time (a 24-byte POD
struct iterated one by one, ``mmap.rs:315-317``), this framework is
batch-first — the canonical in-memory form is a numpy structured array of
``RECORD_DTYPE`` ("array of records"), and the canonical on-device form is a
``(6, N) uint32`` column matrix (lo/hi pairs; see :mod:`ibu_jax.ops.u64`),
since JAX runs without 64-bit types by default. A scalar :class:`Record` exists for
API parity and tests.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

RECORD_SIZE: int = 24  # bytes on the wire (ref record.rs:3)

#: Canonical host dtype; ``itemsize == 24`` and matches the wire byte-for-byte.
RECORD_DTYPE = np.dtype(
    [("barcode", "<u8"), ("umi", "<u8"), ("index", "<u8")]
)
assert RECORD_DTYPE.itemsize == RECORD_SIZE

_U64_MASK = 0xFFFFFFFFFFFFFFFF


@dataclass(frozen=True)
class Record:
    """One IBU record (ref ``record.rs:58-66``).

    Ordering is lexicographic barcode → umi → index (ref ``record.rs:29-32``),
    provided via the comparison operators below (unsigned semantics — Python
    ints are unbounded so this is automatic).

    >>> r = Record(barcode=0x1234, umi=0x5678, index=42)
    >>> len(r.as_bytes())
    24
    >>> Record.from_bytes(r.as_bytes()) == r
    True
    >>> Record(1, 9, 9) < Record(2, 0, 0)  # barcode dominates
    True
    """

    barcode: int = 0
    umi: int = 0
    index: int = 0

    def as_bytes(self) -> bytes:
        """24-byte little-endian wire form (ref ``record.rs:87-110``)."""
        return (
            (self.barcode & _U64_MASK).to_bytes(8, "little")
            + (self.umi & _U64_MASK).to_bytes(8, "little")
            + (self.index & _U64_MASK).to_bytes(8, "little")
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "Record":
        if len(data) != RECORD_SIZE:
            raise ValueError(
                f"Record.from_bytes requires exactly {RECORD_SIZE} bytes, got {len(data)}"
            )
        return cls(
            barcode=int.from_bytes(data[0:8], "little"),
            umi=int.from_bytes(data[8:16], "little"),
            index=int.from_bytes(data[16:24], "little"),
        )

    # serde parity (reference's optional serde feature, Cargo.toml:22-25)
    def to_dict(self) -> dict:
        return {"barcode": self.barcode, "umi": self.umi, "index": self.index}

    @classmethod
    def from_dict(cls, d: dict) -> "Record":
        return cls(barcode=d["barcode"], umi=d["umi"], index=d["index"])

    def _key(self):
        return (self.barcode, self.umi, self.index)

    def __lt__(self, other: "Record") -> bool:
        return self._key() < other._key()

    def __le__(self, other: "Record") -> bool:
        return self._key() <= other._key()

    def __gt__(self, other: "Record") -> bool:
        return self._key() > other._key()

    def __ge__(self, other: "Record") -> bool:
        return self._key() >= other._key()


# -- batch helpers (the canonical batch form) ------------------------------


def empty_records(n: int) -> np.ndarray:
    """Zeroed structured record array of length ``n``."""
    return np.zeros(n, dtype=RECORD_DTYPE)


def make_records(
    barcode: np.ndarray, umi: np.ndarray, index: np.ndarray
) -> np.ndarray:
    """Assemble a structured record array from three ``uint64`` columns."""
    out = np.empty(len(barcode), dtype=RECORD_DTYPE)
    out["barcode"] = barcode
    out["umi"] = umi
    out["index"] = index
    return out


def records_to_bytes(records: np.ndarray) -> bytes:
    """Zero-copy-view serialization of a record batch to wire bytes."""
    if records.dtype != RECORD_DTYPE:
        raise ValueError(f"expected dtype {RECORD_DTYPE}, got {records.dtype}")
    return np.ascontiguousarray(records).tobytes()


def records_from_bytes(data: bytes | bytearray | memoryview) -> np.ndarray:
    """Parse wire bytes into a structured record array (copies once)."""
    buf = memoryview(data)
    if len(buf) % RECORD_SIZE != 0:
        raise ValueError(
            f"byte length {len(buf)} is not a multiple of RECORD_SIZE={RECORD_SIZE}"
        )
    return np.frombuffer(buf, dtype=RECORD_DTYPE).copy()


def sort_records(records: np.ndarray) -> np.ndarray:
    """Sort lexicographically by (barcode, umi, index) (ref ``record.rs:29-32``).

    ``np.sort`` on a structured dtype compares fields in declaration order,
    which is exactly the reference's derived ``Ord``.
    """
    return np.sort(records, order=("barcode", "umi", "index"))
