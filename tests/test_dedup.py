"""UMI deduplication: device molecule counts + streaming file dedup.

The capability sits beyond the reference (which stops at raw records);
correctness is anchored the same way as the histogram/stats engines —
numpy set-based oracles over randomized duplicated data, plus boundary
carries forced by tiny batch sizes.
"""

import numpy as np
import pytest

from ibu_jax import Header, Writer
from ibu_jax.constructs.record import make_records
from ibu_jax.io.mmap import MmapReader
from ibu_jax.ops.stats import molecule_counts, molecule_counts_np
from ibu_jax.ops.u64 import soa_from_records
from ibu_jax.pipelines import dedup_file


def _random_dup_records(rng, n, n_barcodes=17, n_umis=11):
    bc = rng.integers(0, n_barcodes, n).astype(np.uint64)
    umi = rng.integers(0, n_umis, n).astype(np.uint64)
    idx = np.arange(n, dtype=np.uint64)
    return make_records(bc, umi, idx)


class TestMoleculeCounts:
    def test_matches_numpy_oracle(self):
        rng = np.random.default_rng(0)
        recs = _random_dup_records(rng, 5000)
        soa = soa_from_records(recs)
        lo, hi, mol, n_unique = map(
            np.asarray, molecule_counts(soa, max_uniques=64)
        )
        want = molecule_counts_np(recs)
        assert int(n_unique) == len(want)
        got = {
            int(lo[i]) | (int(hi[i]) << 32): int(mol[i])
            for i in range(len(lo))
            if mol[i] != 0
        }
        assert got == want

    def test_u64_extremes_and_pad_sentinel(self):
        m = np.uint64(0xFFFFFFFFFFFFFFFF)
        # 5 records (pow2-pad to 8): max-key records must not merge with
        # the pad sentinel, and distinct umis under one barcode must count
        bc = np.array([m, m, m, 1, 1], dtype=np.uint64)
        umi = np.array([m, m, 7, 3, 3], dtype=np.uint64)
        recs = make_records(bc, umi, np.arange(5, dtype=np.uint64))
        lo, hi, mol, n_unique = map(
            np.asarray, molecule_counts(soa_from_records(recs), max_uniques=8)
        )
        want = molecule_counts_np(recs)  # {max: 2, 1: 1}
        got = {
            int(lo[i]) | (int(hi[i]) << 32): int(mol[i])
            for i in range(len(lo))
            if mol[i] != 0
        }
        assert got == want and int(n_unique) == 2

    def test_hinted_matches_unhinted(self):
        # hints drop provably-zero hi words from the device sort; with
        # in-range data (bc/umi < 2^32) results must be identical
        rng = np.random.default_rng(7)
        bc = rng.integers(0, 200, 4000).astype(np.uint64)
        umi = rng.integers(0, 64, 4000).astype(np.uint64)
        recs = make_records(bc, umi, np.arange(4000, dtype=np.uint64))
        soa = soa_from_records(recs)
        base = [np.asarray(x) for x in molecule_counts(soa, max_uniques=256)]
        hinted = [
            np.asarray(x)
            for x in molecule_counts(
                soa, max_uniques=256, bc_len=16, umi_len=12
            )
        ]
        for a, b in zip(base, hinted):
            np.testing.assert_array_equal(a, b)

    def test_overflow_detectable(self):
        rng = np.random.default_rng(1)
        recs = _random_dup_records(rng, 512, n_barcodes=100)
        lo, hi, mol, n_unique = map(
            np.asarray,
            molecule_counts(soa_from_records(recs), max_uniques=16),
        )
        assert int(n_unique) > 16  # caller-visible overflow signal

    def test_empty(self):
        recs = make_records(
            np.array([], np.uint64), np.array([], np.uint64),
            np.array([], np.uint64),
        )
        *_, n_unique = molecule_counts(soa_from_records(recs), max_uniques=4)
        assert int(np.asarray(n_unique)) == 0


class TestDedupFile:
    def _write(self, path, recs, sorted_flag):
        h = Header.new(16, 12)
        if sorted_flag:
            h.set_sorted()
        with Writer.from_path(str(path), h) as w:
            w.write_batch(recs)

    def _sorted_dups(self, rng, n):
        recs = _random_dup_records(rng, n)
        order = np.argsort(recs, order=("barcode", "umi", "index"))
        return recs[order]

    def test_sorted_stream_with_batch_boundaries(self, tmp_path):
        rng = np.random.default_rng(2)
        recs = self._sorted_dups(rng, 10_000)
        src, dst = tmp_path / "in.ibu", tmp_path / "out.ibu"
        self._write(src, recs, sorted_flag=True)
        # batch of 97 forces pair runs to straddle many boundaries
        stats = dedup_file(str(src), str(dst), batch_records=97)
        want = molecule_counts_np(recs)
        assert stats["records"] == len(recs)
        assert stats["molecules"] == sum(want.values())
        assert stats["barcodes"] == len(want)
        out = MmapReader(str(dst))
        assert out.header().sorted()
        got = np.asarray(out.slice(0, out.len()))
        # exactly the first (min-index) record of every distinct pair
        pairs = np.stack([recs["barcode"], recs["umi"]], axis=1)
        first = np.concatenate(
            [[True], np.any(pairs[1:] != pairs[:-1], axis=1)]
        )
        np.testing.assert_array_equal(got, recs[first])

    def _check_unsorted_dedup(self, recs, stats, dst):
        """Shared content oracle for the unsorted-input pre-sort paths."""
        want = molecule_counts_np(recs)
        assert stats["molecules"] == sum(want.values())
        assert stats["barcodes"] == len(want)
        out = MmapReader(str(dst))
        assert out.len() == stats["molecules"] and out.header().sorted()
        # kept record of each pair carries that pair's minimum index
        got = np.asarray(out.slice(0, out.len()))
        by_pair = {}
        for r in recs:
            k = (int(r["barcode"]), int(r["umi"]))
            by_pair[k] = min(by_pair.get(k, 1 << 63), int(r["index"]))
        for r in got:
            assert int(r["index"]) == by_pair[
                (int(r["barcode"]), int(r["umi"]))
            ]

    def test_unsorted_input_sorts_first(self, tmp_path):
        rng = np.random.default_rng(3)
        recs = _random_dup_records(rng, 3000)
        src, dst = tmp_path / "u.ibu", tmp_path / "d.ibu"
        self._write(src, recs, sorted_flag=False)
        stats = dedup_file(str(src), str(dst))
        self._check_unsorted_dedup(recs, stats, dst)

    def test_unsorted_mesh_fallback(self, tmp_path, monkeypatch):
        # with the native runtime unavailable and >1 device, the pre-sort
        # falls back to the distributed mesh sort
        from ibu_jax.native import bindings as native

        monkeypatch.setattr(native, "available", lambda: False)
        rng = np.random.default_rng(4)
        recs = _random_dup_records(rng, 3000)
        src, dst = tmp_path / "u.ibu", tmp_path / "d.ibu"
        self._write(src, recs, sorted_flag=False)
        stats = dedup_file(str(src), str(dst))
        self._check_unsorted_dedup(recs, stats, dst)

    def test_lying_sorted_flag_raises(self, tmp_path):
        bc = np.array([5, 1], dtype=np.uint64)
        recs = make_records(bc, bc, bc)
        src, dst = tmp_path / "lie.ibu", tmp_path / "x.ibu"
        self._write(src, recs, sorted_flag=True)
        with pytest.raises(ValueError, match="not in sorted order"):
            dedup_file(str(src), str(dst))
        # no partial output with a sorted-claiming header left behind
        assert not dst.exists()

    def test_empty_file(self, tmp_path):
        src, dst = tmp_path / "e.ibu", tmp_path / "eo.ibu"
        self._write(
            src,
            make_records(
                np.array([], np.uint64), np.array([], np.uint64),
                np.array([], np.uint64),
            ),
            sorted_flag=True,
        )
        stats = dedup_file(str(src), str(dst))
        assert stats == {"records": 0, "molecules": 0, "barcodes": 0}
        assert MmapReader(str(dst)).len() == 0

    def test_cli(self, tmp_path, capsys):
        rng = np.random.default_rng(4)
        recs = self._sorted_dups(rng, 500)
        src, dst = tmp_path / "c.ibu", tmp_path / "co.ibu"
        self._write(src, recs, sorted_flag=True)
        from ibu_jax.__main__ import main

        assert main(["dedup", str(src), str(dst)]) == 0
        out = capsys.readouterr().out
        want = molecule_counts_np(recs)
        assert f"{sum(want.values())} molecules" in out
        assert f"{len(want)} barcodes" in out
