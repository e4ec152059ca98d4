"""Seeded exact subsampling: hypergeometric streaming vs whole-file oracle.

The per-batch hypergeometric split must be distributionally identical to
a single choice(N, n) over the whole file; the tests anchor exactness
(count is exact, records are a subset, order preserved), determinism, and
a frequency sanity check across seeds.
"""

import subprocess
import sys

import numpy as np
import pytest

from ibu_jax import Header, MmapReader, Writer
from ibu_jax.constructs.record import make_records
from ibu_jax.pipelines import subsample_file


def _file(tmp_path, n, sorted_flag=True, name="in.ibu"):
    p = str(tmp_path / name)
    i = np.arange(n, dtype=np.uint64)
    h = Header.new(8, 6)
    if sorted_flag:
        h.set_sorted()
    with Writer.from_path(p, h) as w:
        if n:
            w.write_batch(make_records(i, i % np.uint64(13), i))
    return p


class TestSubsample:
    def test_exact_count_subset_and_order(self, tmp_path):
        p = _file(tmp_path, 10_000)
        out = str(tmp_path / "o.ibu")
        stats = subsample_file(p, out, n=777, seed=42, batch_records=1024)
        assert stats == {"records": 10_000, "sampled": 777, "seed": 42}
        r = MmapReader(out)
        assert len(r) == 777 and r.header().sorted()
        got = np.asarray(r.slice(0, 777))["index"]
        assert len(np.unique(got)) == 777          # without replacement
        assert np.all(np.diff(got.astype(np.int64)) > 0)  # order preserved
        assert got.max() < 10_000

    def test_gzip_input_streams_two_pass(self, tmp_path):
        # compressed inputs can't mmap: a counting pass then a sampling
        # pass, same exactness guarantees
        n = 10_000
        i = np.arange(n, dtype=np.uint64)
        h = Header.new(8, 6)
        h.set_sorted()
        p = str(tmp_path / "in.ibu.gz")
        with Writer.from_path(p, h, compression="auto") as w:
            w.write_batch(make_records(i, i % np.uint64(13), i))
        out = str(tmp_path / "o.ibu")
        stats = subsample_file(p, out, n=500, seed=7, batch_records=1024)
        assert stats == {"records": n, "sampled": 500, "seed": 7}
        r = MmapReader(out)
        assert len(r) == 500 and r.header().sorted()
        got = np.asarray(r.slice(0, 500))["index"]
        assert len(np.unique(got)) == 500
        assert np.all(np.diff(got.astype(np.int64)) > 0)
        assert got.max() < n

    def test_fraction_rounds_and_seeds_differ(self, tmp_path):
        p = _file(tmp_path, 1000)
        a, b = str(tmp_path / "a.ibu"), str(tmp_path / "b.ibu")
        sa = subsample_file(p, a, fraction=0.25, seed=1)
        assert sa["sampled"] == 250
        subsample_file(p, b, fraction=0.25, seed=2)
        ga = np.asarray(MmapReader(a).slice(0, 250))["index"]
        gb = np.asarray(MmapReader(b).slice(0, 250))["index"]
        assert not np.array_equal(ga, gb)
        # determinism: same seed reproduces byte-exactly
        subsample_file(p, b, fraction=0.25, seed=1)
        assert open(a, "rb").read() == open(b, "rb").read()

    def test_uniformity_across_batches(self, tmp_path):
        # per-batch hypergeometric must not bias early vs late batches
        p = _file(tmp_path, 8000)
        counts = np.zeros(8)
        for seed in range(30):
            out = str(tmp_path / "u.ibu")
            subsample_file(p, out, n=800, seed=seed, batch_records=1000)
            idx = np.asarray(MmapReader(out).slice(0, 800))["index"]
            counts += np.bincount((idx // 1000).astype(int), minlength=8)
        frac = counts / counts.sum()
        assert np.all(np.abs(frac - 1 / 8) < 0.02), frac

    def test_edge_counts(self, tmp_path):
        p = _file(tmp_path, 100)
        out = str(tmp_path / "o.ibu")
        assert subsample_file(p, out, n=0)["sampled"] == 0
        assert len(MmapReader(out)) == 0
        assert subsample_file(p, out, n=100)["sampled"] == 100
        assert open(out, "rb").read() == open(p, "rb").read()
        assert subsample_file(p, out, fraction=1.0)["sampled"] == 100

    def test_bad_args(self, tmp_path):
        p = _file(tmp_path, 10)
        out = str(tmp_path / "o.ibu")
        with pytest.raises(ValueError, match="exactly one"):
            subsample_file(p, out)
        with pytest.raises(ValueError, match="exactly one"):
            subsample_file(p, out, fraction=0.5, n=3)
        with pytest.raises(ValueError, match="fraction"):
            subsample_file(p, out, fraction=1.5)
        with pytest.raises(ValueError, match="out of range"):
            subsample_file(p, out, n=11)

    def test_unsorted_flag_carries(self, tmp_path):
        p = _file(tmp_path, 50, sorted_flag=False)
        out = str(tmp_path / "o.ibu")
        subsample_file(p, out, n=10)
        assert not MmapReader(out).header().sorted()

    def test_cli(self, tmp_path):
        p = _file(tmp_path, 500)
        out = str(tmp_path / "o.ibu")
        r = subprocess.run(
            [sys.executable, "-m", "ibu_jax", "subsample", p, out,
             "--fraction", "0.1", "--seed", "3"],
            capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        assert "50 of 500 records (seed 3)" in r.stdout
        assert len(MmapReader(out)) == 50


class TestInfoCompressed:
    def test_info_streams_gzip_files(self, tmp_path):
        import json

        p = str(tmp_path / "z.ibu.gz")
        i = np.arange(321, dtype=np.uint64)
        h = Header.new(8, 6)
        h.set_sorted()
        with Writer.from_path(p, h, compression="auto") as w:
            w.write_batch(make_records(i, i, i))
        r = subprocess.run(
            [sys.executable, "-m", "ibu_jax", "info", p],
            capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        d = json.loads(r.stdout)
        assert d["records"] == 321 and d["sorted"] is True
        assert d["compression"] == "gzip"
