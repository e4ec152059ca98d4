"""Record tests — parity with the reference suite (``record.rs:135-322``)."""

import itertools

import numpy as np
import pytest

from ibu_jax import (
    RECORD_DTYPE,
    RECORD_SIZE,
    Record,
    records_from_bytes,
    records_to_bytes,
    sort_records,
)
from ibu_jax.constructs.record import make_records

U64_MAX = 0xFFFFFFFFFFFFFFFF


class TestScalarRecord:
    def test_size_is_24(self):
        assert RECORD_SIZE == 24
        assert RECORD_DTYPE.itemsize == 24
        assert len(Record(1, 2, 3).as_bytes()) == 24

    def test_default(self):
        r = Record()
        assert (r.barcode, r.umi, r.index) == (0, 0, 0)

    def test_byte_roundtrip(self):
        r = Record(0x123456789ABCDEF0, 0xFEDCBA9876543210, 42)
        assert Record.from_bytes(r.as_bytes()) == r

    def test_byte_roundtrip_extremes(self):
        for r in [Record(0, 0, 0), Record(U64_MAX, U64_MAX, U64_MAX)]:
            assert Record.from_bytes(r.as_bytes()) == r

    def test_wire_layout_little_endian(self):
        b = Record(1, 2, 3).as_bytes()
        assert b[0:8] == (1).to_bytes(8, "little")
        assert b[8:16] == (2).to_bytes(8, "little")
        assert b[16:24] == (3).to_bytes(8, "little")

    def test_from_bytes_wrong_size(self):
        with pytest.raises(ValueError):
            Record.from_bytes(b"\x00" * 23)

    def test_lexicographic_ordering(self):
        """barcode → umi → index precedence (record.rs:29-32)."""
        assert Record(1, 9, 9) < Record(2, 0, 0)
        assert Record(1, 1, 9) < Record(1, 2, 0)
        assert Record(1, 1, 1) < Record(1, 1, 2)
        assert Record(1, 1, 1) <= Record(1, 1, 1)
        assert Record(2, 0, 0) > Record(1, 9, 9)

    def test_full_permutation_sort(self):
        """All 8 orderings of a 3-record set sort identically
        (record.rs:163-232)."""
        recs = [Record(2, 1, 1), Record(1, 2, 1), Record(1, 1, 2)]
        want = sorted(recs)
        for perm in itertools.permutations(recs):
            assert sorted(perm) == want


class TestBatchRecords:
    def test_make_and_roundtrip(self):
        bc = np.array([1, 2, 3], dtype=np.uint64)
        umi = np.array([4, 5, 6], dtype=np.uint64)
        idx = np.array([7, 8, 9], dtype=np.uint64)
        arr = make_records(bc, umi, idx)
        data = records_to_bytes(arr)
        assert len(data) == 3 * RECORD_SIZE
        back = records_from_bytes(data)
        assert np.array_equal(back, arr)

    def test_batch_matches_scalar_bytes(self):
        arr = make_records(
            np.array([U64_MAX], dtype=np.uint64),
            np.array([123], dtype=np.uint64),
            np.array([456], dtype=np.uint64),
        )
        assert records_to_bytes(arr) == Record(U64_MAX, 123, 456).as_bytes()

    def test_ragged_bytes_rejected(self):
        with pytest.raises(ValueError):
            records_from_bytes(b"\x00" * 25)

    def test_sort_records_lexicographic(self):
        arr = make_records(
            np.array([2, 1, 1], dtype=np.uint64),
            np.array([1, 2, 1], dtype=np.uint64),
            np.array([1, 1, 2], dtype=np.uint64),
        )
        s = sort_records(arr)
        assert s["barcode"].tolist() == [1, 1, 2]
        assert s["umi"].tolist() == [1, 2, 1]
        assert s["index"].tolist() == [2, 1, 1]

    def test_sort_matches_scalar_sort(self):
        rng = np.random.default_rng(0)
        arr = make_records(
            rng.integers(0, 4, 64).astype(np.uint64),
            rng.integers(0, 4, 64).astype(np.uint64),
            rng.integers(0, 4, 64).astype(np.uint64),
        )
        scalars = sorted(
            Record(int(r["barcode"]), int(r["umi"]), int(r["index"])) for r in arr
        )
        s = sort_records(arr)
        for row, rec in zip(s, scalars):
            assert (int(row["barcode"]), int(row["umi"]), int(row["index"])) == (
                rec.barcode,
                rec.umi,
                rec.index,
            )

    def test_sort_unsigned_semantics(self):
        """u64 ordering: MAX sorts last, not as -1."""
        arr = make_records(
            np.array([U64_MAX, 0, 1], dtype=np.uint64),
            np.zeros(3, dtype=np.uint64),
            np.zeros(3, dtype=np.uint64),
        )
        s = sort_records(arr)
        assert s["barcode"].tolist() == [0, 1, U64_MAX]


class TestSerde:
    """Serde-feature parity (Cargo.toml:22-25; derives at record.rs:58,
    header.rs:48): Record and Header serialize to/from plain dicts and
    therefore to any dict-speaking format (JSON here)."""

    def test_record_json_roundtrip(self):
        import json

        r = Record(barcode=U64_MAX, umi=1, index=2**63)
        back = Record.from_dict(json.loads(json.dumps(r.to_dict())))
        assert back == r
        assert back.as_bytes() == r.as_bytes()

    def test_record_batch_json_roundtrip(self):
        import json

        arr = make_records(
            np.array([1, U64_MAX], dtype=np.uint64),
            np.array([2, 5], dtype=np.uint64),
            np.array([3, 6], dtype=np.uint64),
        )
        dicts = [
            Record(int(r["barcode"]), int(r["umi"]), int(r["index"])).to_dict()
            for r in arr
        ]
        payload = json.loads(json.dumps(dicts))
        back = make_records(
            np.array([d["barcode"] for d in payload], dtype=np.uint64),
            np.array([d["umi"] for d in payload], dtype=np.uint64),
            np.array([d["index"] for d in payload], dtype=np.uint64),
        )
        assert np.array_equal(back, arr)
