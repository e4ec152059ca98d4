"""Cell calling: knee/ordmag estimators, call_cells pipeline, CLI.

The estimators are anchored on planted two-population data (a cells
plateau separated from an ambient tail by a clean gap) where the correct
answer is known exactly, plus degenerate-curve contracts and np↔lax
agreement (the framework's oracle-twin convention, SURVEY.md §4).
"""

import numpy as np
import pytest

from ibu_jax import Header, Writer
from ibu_jax.constructs.record import make_records
from ibu_jax.ops.codec import encode_seqs
from ibu_jax.ops.knee import (
    call_from_counts,
    knee_threshold,
    lax_knee_index,
    np_knee_index,
    ordmag_threshold,
)
from ibu_jax.pipelines import barcode_counts, call_cells


def _planted(
    rng, n_cells=40, n_ambient=400, cell_lo=50, cell_hi=101, amb_hi=4
):
    """Barcode/count table with a clean gap between cells and ambient."""
    barcodes = rng.choice(1 << 32, n_cells + n_ambient, replace=False)
    barcodes = barcodes.astype(np.uint64)
    counts = np.concatenate(
        [
            rng.integers(cell_lo, cell_hi, n_cells),
            rng.integers(1, amb_hi, n_ambient),
        ]
    ).astype(np.int64)
    return barcodes[:n_cells], barcodes, counts


def _records_with_counts(barcodes, counts, rng):
    """One record per read, barcodes repeated per count, shuffled."""
    bc = np.repeat(barcodes, counts)
    rng.shuffle(bc)
    n = len(bc)
    return make_records(
        bc,
        rng.integers(0, 1 << 24, n).astype(np.uint64),
        np.arange(n, dtype=np.uint64),
    )


class TestKneeIndex:
    def test_planted_gap_recovered_exactly(self):
        rng = np.random.default_rng(7)
        cells, barcodes, counts = _planted(rng)
        desc = np.sort(counts)[::-1]
        k = np_knee_index(desc)
        # the knee is the first ambient barcode: the 40 cells sit strictly
        # above it, everything from it on is ambient
        assert k == 40
        assert knee_threshold(desc) == desc[40] + 1

    def test_lax_matches_np(self):
        rng = np.random.default_rng(11)
        for _ in range(20):
            n = int(rng.integers(3, 500))
            desc = np.sort(rng.integers(1, 1000, n))[::-1].astype(np.int64)
            got = int(lax_knee_index(desc))
            assert got == np_knee_index(desc), desc[:10]

    def test_degenerate_curves(self):
        # no knee: fewer than 3 points, or flat — "everything is a cell"
        assert np_knee_index(np.array([5])) == 1
        assert np_knee_index(np.array([5, 4])) == 2
        assert np_knee_index(np.array([3, 3, 3, 3])) == 4
        assert int(lax_knee_index(np.array([3, 3, 3, 3]))) == 4
        assert knee_threshold(np.array([3, 3, 3])) == 3  # all kept
        assert knee_threshold(np.array([], dtype=np.int64)) == 1

    def test_ordmag(self):
        desc = np.array([1000] * 100 + [1] * 900, dtype=np.int64)
        # top-3000 clipped to all 1000 entries; 99th pct of the mixed top
        # is still 1000 -> threshold 100
        assert ordmag_threshold(desc, expect=100) == 100
        assert ordmag_threshold(desc, expect=3000) == 100
        assert ordmag_threshold(np.array([], dtype=np.int64)) == 1


class TestCallFromCounts:
    def test_planted_cells_exact(self):
        rng = np.random.default_rng(3)
        cells, barcodes, counts = _planted(rng)
        got, threshold = call_from_counts(barcodes, counts)
        assert set(got.tolist()) == set(cells.tolist())
        assert 4 <= threshold <= 50
        # ordmag on the same table: 99th pct ~100 -> threshold ~10
        got2, t2 = call_from_counts(barcodes, counts, method="ordmag",
                                    expect=40)
        assert set(got2.tolist()) == set(cells.tolist())

    def test_descending_count_tie_broken_by_barcode(self):
        barcodes = np.array([9, 1, 5, 7], dtype=np.uint64)
        counts = np.array([10, 10, 10, 2], dtype=np.int64)
        got, _ = call_from_counts(barcodes, counts, min_count=3)
        np.testing.assert_array_equal(got, [1, 5, 9])

    def test_zero_counts_dropped_negative_raise(self):
        # dense histogram slots with zero counts are not observations
        barcodes = np.array([1, 2, 3, 4], dtype=np.uint64)
        counts = np.array([100, 0, 90, 0], dtype=np.int64)
        got, _ = call_from_counts(barcodes, counts, min_count=1)
        assert set(got.tolist()) == {1, 3}
        with pytest.raises(ValueError, match="nonnegative"):
            call_from_counts(barcodes, np.array([5, -1, 2, 1]))
        with pytest.raises(ValueError, match="positive"):
            np_knee_index(np.array([5, 3, 0]))

    def test_min_count_floor_and_bad_method(self):
        barcodes = np.arange(4, dtype=np.uint64)
        counts = np.array([100, 100, 100, 1], dtype=np.int64)
        got, t = call_from_counts(barcodes, counts, min_count=101)
        assert len(got) == 0 and t == 101
        with pytest.raises(ValueError, match="unknown method"):
            call_from_counts(barcodes, counts, method="spline")
        with pytest.raises(ValueError, match="vs counts"):
            call_from_counts(barcodes, counts[:2])


class TestCallCellsPipeline:
    @pytest.mark.parametrize("engine", ["host", "device"])
    def test_planted_file_roundtrip(self, tmp_path, engine):
        rng = np.random.default_rng(5)
        cells, barcodes, counts = _planted(rng)
        recs = _records_with_counts(barcodes, counts, rng)
        src = tmp_path / "reads.ibu"
        with Writer.from_path(str(src), Header.new(16, 12)) as w:
            w.write_batch(recs)

        out = tmp_path / "allow.txt"
        stats = call_cells(str(src), str(out), engine=engine,
                           batch_records=1024)
        assert stats["cells"] == 40
        assert stats["barcodes"] == 440
        assert stats["records"] == len(recs)
        listed = [l.strip() for l in out.read_text().splitlines() if l]
        assert len(listed) == 40
        packed = encode_seqs(listed)
        assert set(np.asarray(packed).tolist()) == set(cells.tolist())

    def test_barcode_counts_engines_agree(self, tmp_path):
        rng = np.random.default_rng(9)
        _, barcodes, counts = _planted(rng, n_cells=8, n_ambient=50)
        recs = _records_with_counts(barcodes, counts, rng)
        src = tmp_path / "r.ibu"
        with Writer.from_path(str(src), Header.new(16, 12)) as w:
            w.write_batch(recs)
        hb, hc = barcode_counts(str(src), engine="host", batch_records=100)
        db, dc = barcode_counts(str(src), engine="device",
                                batch_records=100)
        np.testing.assert_array_equal(hb, db)
        np.testing.assert_array_equal(hc, dc)
        order = np.argsort(barcodes)
        np.testing.assert_array_equal(hb, barcodes[order])
        np.testing.assert_array_equal(hc, counts[order])

    def test_cli_cells_feeds_correct(self, tmp_path, capsys):
        rng = np.random.default_rng(13)
        cells, barcodes, counts = _planted(rng, n_cells=5, n_ambient=60)
        recs = _records_with_counts(barcodes, counts, rng)
        src = tmp_path / "cli.ibu"
        with Writer.from_path(str(src), Header.new(16, 12)) as w:
            w.write_batch(recs)
        allow = tmp_path / "allow.txt"
        from ibu_jax.__main__ import main

        rc = main(["cells", str(src), "-o", str(allow)])
        assert rc == 0
        assert "5 cells of 65 barcodes" in capsys.readouterr().out
        # the emitted allowlist drives correct end-to-end
        dst = tmp_path / "corrected.ibu"
        rc = main(["correct", str(src), str(dst),
                   "--barcodes", str(allow)])
        assert rc == 0
        assert "allowlist of 5" in capsys.readouterr().out

    def test_compressed_input_rejected(self, tmp_path):
        import gzip

        path = tmp_path / "x.ibu.gz"
        path.write_bytes(gzip.compress(b"\x00" * 64))
        with pytest.raises(Exception, match="compress"):
            call_cells(str(path), str(tmp_path / "o.txt"))
