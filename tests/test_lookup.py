"""Indexed barcode lookup: binary search on the sorted mmap vs np.isin."""

import numpy as np
import pytest

from ibu_jax import Header, Writer
from ibu_jax.constructs.record import RECORD_DTYPE, make_records
from ibu_jax.pipelines import lookup_barcodes


def _sorted_file(tmp_path, bc, umi=None, idx=None, name="s.ibu"):
    bc = np.asarray(bc, dtype=np.uint64)
    n = len(bc)
    umi = np.arange(n, dtype=np.uint64) if umi is None else np.asarray(umi)
    idx = np.arange(n, dtype=np.uint64) if idx is None else np.asarray(idx)
    recs = np.sort(
        make_records(bc, umi, idx), order=("barcode", "umi", "index")
    )
    h = Header.new(16, 12)
    h.set_sorted()
    path = str(tmp_path / name)
    with Writer.from_path(path, h) as w:
        w.write_batch(recs)
    return path, recs


class TestLookupBarcodes:
    def test_matches_isin_oracle(self, tmp_path):
        rng = np.random.default_rng(3)
        bc = rng.integers(0, 60, 20_000).astype(np.uint64)
        path, recs = _sorted_file(tmp_path, bc)
        queries = [7, 13, 59, 1000]  # 1000 is absent
        got = lookup_barcodes(path, queries)
        want = recs[np.isin(recs["barcode"], queries)]
        np.testing.assert_array_equal(got, want)

    def test_duplicate_queries_dedup(self, tmp_path):
        path, recs = _sorted_file(tmp_path, [5, 5, 5, 9])
        got = lookup_barcodes(path, [5, 5])
        assert len(got) == 3
        assert (got["barcode"] == 5).all()

    def test_boundaries_first_and_last(self, tmp_path):
        # extremes: first record, last record, u64-max barcode
        big = np.uint64(0xFFFFFFFFFFFFFFFF)
        path, recs = _sorted_file(tmp_path, [0, 1, 2, big])
        got = lookup_barcodes(path, [0, int(big)])
        want = recs[np.isin(recs["barcode"], [0, big])]
        np.testing.assert_array_equal(got, want)

    def test_empty_results_and_empty_file(self, tmp_path):
        path, _ = _sorted_file(tmp_path, [1, 2, 3])
        got = lookup_barcodes(path, [42])
        assert got.dtype == RECORD_DTYPE and len(got) == 0
        epath, _ = _sorted_file(tmp_path, [], name="e.ibu")
        assert len(lookup_barcodes(epath, [1])) == 0

    def test_batch_regime_matches_isin_oracle(self, tmp_path):
        # >= LOOKUP_BATCH_MIN distinct queries takes the vectorized
        # searchsorted path; results must match the bisect path's oracle
        from ibu_jax.pipelines import LOOKUP_BATCH_MIN

        rng = np.random.default_rng(11)
        bc = rng.integers(0, 2_000, 50_000).astype(np.uint64)
        path, recs = _sorted_file(tmp_path, bc)
        queries = np.unique(
            rng.integers(0, 3_000, 2 * LOOKUP_BATCH_MIN)
        ).astype(np.uint64)  # ~1/3 absent
        assert len(queries) >= LOOKUP_BATCH_MIN
        got = lookup_barcodes(path, queries)
        want = recs[np.isin(recs["barcode"], queries)]
        np.testing.assert_array_equal(got, want)

    def test_batch_regime_all_absent(self, tmp_path):
        from ibu_jax.pipelines import LOOKUP_BATCH_MIN

        path, _ = _sorted_file(tmp_path, [1, 2, 3])
        queries = np.arange(1000, 1000 + LOOKUP_BATCH_MIN, dtype=np.uint64)
        got = lookup_barcodes(path, queries)
        assert got.dtype == RECORD_DTYPE and len(got) == 0

    def test_unsorted_file_rejected(self, tmp_path):
        recs = make_records(
            np.array([9, 1], np.uint64),
            np.zeros(2, np.uint64),
            np.zeros(2, np.uint64),
        )
        path = str(tmp_path / "u.ibu")
        with Writer.from_path(path, Header.new(16, 12)) as w:
            w.write_batch(recs)
        with pytest.raises(ValueError, match="sorted flag"):
            lookup_barcodes(path, [1])

    def test_cli_sequence_and_integer(self, tmp_path, capsys):
        from ibu_jax.ops.codec import decode_seqs, encode_seqs

        seq = "ACGTACGTACGTACGT"
        packed = int(np.asarray(encode_seqs([seq]))[0])
        path, recs = _sorted_file(tmp_path, [packed, packed, 77])
        from ibu_jax.__main__ import main

        rc = main(["lookup", path, seq, "77"])
        assert rc == 0
        out = capsys.readouterr().out.strip().splitlines()
        assert len(out) == 3
        assert sum(l.startswith(seq + "\t") for l in out) == 2
        seq77 = decode_seqs(np.array([77], dtype=np.uint64), 16)[0]
        assert sum(l.startswith(seq77 + "\t") for l in out) == 1

    def test_cli_wrong_length_rejected(self, tmp_path):
        path, _ = _sorted_file(tmp_path, [1])
        from ibu_jax.__main__ import main

        with pytest.raises(SystemExit, match="length 4"):
            main(["lookup", path, "ACGT"])
