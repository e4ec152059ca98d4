"""Distributed sample sort over the dp mesh (ibu_jax.parallel.sort).

Oracle: numpy's lexicographic structured sort — the host form of the
reference's derived ``Ord`` (``record.rs:29-32``). Runs on the 8-virtual-
device CPU mesh (conftest), so the all_gather/all_to_all exchange is real.
"""

import numpy as np
import pytest

from ibu_jax.constructs.record import make_records
from ibu_jax.parallel.sort import sharded_sort_records, sort_file_mesh


def _oracle(recs):
    return np.sort(recs, order=("barcode", "umi", "index"))


def _random_records(n, seed, bc_bits=32, umi_bits=24):
    rng = np.random.default_rng(seed)
    return make_records(
        rng.integers(0, 1 << bc_bits, n).astype(np.uint64),
        rng.integers(0, 1 << umi_bits, n).astype(np.uint64),
        np.arange(n, dtype=np.uint64),
    )


class TestShardedSortRecords:
    def test_hinted_matches_oracle(self):
        recs = _random_records(100_000, 1)
        got = sharded_sort_records(
            recs, bc_len=16, umi_len=12, index_bits=32
        )
        np.testing.assert_array_equal(got, _oracle(recs))

    def test_full_width_u64_values(self):
        rng = np.random.default_rng(2)
        recs = make_records(
            rng.integers(0, 1 << 63, 5000).astype(np.uint64) * np.uint64(2),
            rng.integers(0, 1 << 63, 5000).astype(np.uint64),
            rng.integers(0, 1 << 63, 5000).astype(np.uint64),
        )
        recs["barcode"][:5] = 0xFFFFFFFFFFFFFFFF  # sentinel-identical keys
        got = sharded_sort_records(recs)
        np.testing.assert_array_equal(got, _oracle(recs))

    def test_duplicate_heavy_spreads_by_position(self):
        # 60% of the file is ONE (bc, umi, index) triple: value-based
        # routing alone would overflow one shard's exchange capacity;
        # the position tiebreak word must spread it
        rng = np.random.default_rng(3)
        n = 80_000
        bc = np.where(
            rng.random(n) < 0.6,
            np.uint64(42),
            rng.integers(0, 1000, n).astype(np.uint64),
        )
        recs = make_records(
            bc, np.zeros(n, np.uint64), np.zeros(n, np.uint64)
        )
        got = sharded_sort_records(
            recs, bc_len=16, umi_len=12, index_bits=32
        )
        np.testing.assert_array_equal(got, _oracle(recs))

    @pytest.mark.parametrize("n", [0, 1, 7, 63])
    def test_tiny_and_empty(self, n):
        recs = make_records(
            np.arange(n, dtype=np.uint64)[::-1].copy(),
            np.zeros(n, np.uint64),
            np.zeros(n, np.uint64),
        )
        got = sharded_sort_records(
            recs, bc_len=16, umi_len=12, index_bits=32
        )
        np.testing.assert_array_equal(got, _oracle(recs))

    def test_presorted_and_reversed(self):
        recs = _random_records(20_000, 4)
        srt = _oracle(recs)
        np.testing.assert_array_equal(
            sharded_sort_records(srt, bc_len=16, umi_len=12, index_bits=32),
            srt,
        )
        rev = srt[::-1].copy()
        np.testing.assert_array_equal(
            sharded_sort_records(rev, bc_len=16, umi_len=12, index_bits=32),
            srt,
        )

    @pytest.mark.slow
    def test_large_shard_sample_positions(self):
        # regression: sample positions ((2i+1) * n_valid) once wrapped
        # int32 past n_valid > 2^31/(2*samples_per_shard - 1) records per
        # shard, collapsing the high splitters to the smallest keys and
        # raising a spurious exchange overflow once >50% of the sample
        # products wrap (the skew then overloads one destination past
        # c_send). 8192 samples/shard wraps half the products at ~262k
        # records/shard, so 4 devices x 300k reproduces the production
        # default's failure shape at 4.2M+ records/shard without a
        # 17M-record test.
        import jax
        from jax.sharding import Mesh
        from ibu_jax.parallel.device import AXIS

        mesh = Mesh(np.array(jax.devices()[:4]), (AXIS,))
        recs = _random_records(1_200_000, 8)
        got = sharded_sort_records(
            recs,
            mesh=mesh,
            bc_len=16,
            umi_len=12,
            index_bits=32,
            samples_per_shard=8192,
        )
        np.testing.assert_array_equal(got, _oracle(recs))

    def test_shape_bucket_values(self):
        from ibu_jax.parallel.sort import _shape_bucket

        assert _shape_bucket(1) == 64
        assert _shape_bucket(64) == 64
        assert _shape_bucket(65) == 96  # 1.5 * 64
        assert _shape_bucket(96) == 96
        assert _shape_bucket(97) == 128
        assert _shape_bucket(1 << 20) == 1 << 20
        assert _shape_bucket((1 << 20) + 1) == 3 << 19
        for n in (2, 100, 999, 12345, 1 << 21):
            assert _shape_bucket(n) >= n
            assert _shape_bucket(n) < 2 * max(n, 64)

    def test_nearby_sizes_share_one_program(self):
        # the point of bucketing: sorting files of nearby sizes must not
        # recompile (per-shape compiles cost ~minutes on a real chip)
        from ibu_jax.parallel import sort as msort

        msort._SORT_PROGRAM_CACHE.clear()
        # all raw shard widths in (12288, 16384] -> one 16384 bucket
        for n in (99_000, 100_000, 120_000, 131_072):
            recs = _random_records(n, seed=n)
            got = sharded_sort_records(
                recs, bc_len=16, umi_len=12, index_bits=32
            )
            np.testing.assert_array_equal(got, _oracle(recs))
        assert len(msort._SORT_PROGRAM_CACHE) == 1

    def test_violated_hint_raises(self):
        recs = make_records(
            np.array([1 << 40], np.uint64),  # needs the bc hi word
            np.zeros(1, np.uint64),
            np.zeros(1, np.uint64),
        )
        with pytest.raises(ValueError, match="hint violated"):
            sharded_sort_records(recs, bc_len=16, umi_len=12)

    def test_matches_single_device_sort(self):
        # the two device sort paths must agree exactly
        from ibu_jax.ops.u64 import soa_from_records, records_from_soa
        from ibu_jax.ops.stats import sort_records_soa
        import jax.numpy as jnp

        recs = _random_records(30_000, 5)
        mesh_sorted = sharded_sort_records(
            recs, bc_len=16, umi_len=12, index_bits=32
        )
        soa_sorted = records_from_soa(
            np.asarray(
                sort_records_soa(
                    jnp.asarray(soa_from_records(recs)),
                    bc_len=16,
                    umi_len=12,
                    index_bits=32,
                )
            )
        )
        np.testing.assert_array_equal(mesh_sorted, soa_sorted)


def test_multihost_sort_single_process_fallback(tmp_path):
    # multihost_sort_file degrades to sort_file_mesh when there is no
    # process group (the true cluster path is tests/test_multiprocess.py)
    from ibu_jax.io.mmap import MmapReader
    from ibu_jax.io.writer import Writer
    from ibu_jax.constructs.header import Header
    from ibu_jax.parallel.multihost import multihost_sort_file

    recs = _random_records(20_000, 21)
    src = str(tmp_path / "in.ibu")
    dst = str(tmp_path / "out.ibu")
    with Writer.from_path(src, Header.new(16, 12)) as w:
        w.write_batch(recs)
    multihost_sort_file(src, dst, index_bits=32)
    got = MmapReader(dst)
    assert got.header().sorted()
    np.testing.assert_array_equal(np.asarray(got.records), _oracle(recs))


class TestSortFileMesh:
    def test_sorted_rewrite_roundtrip(self, tmp_path, tmp_ibu_file):
        from ibu_jax.io.mmap import MmapReader

        recs = _random_records(50_000, 6)
        in_path = tmp_ibu_file(recs)
        out_path = str(tmp_path / "mesh_sorted.ibu")
        header = sort_file_mesh(in_path, out_path)
        assert header.sorted()
        reader = MmapReader(out_path)
        assert reader.header().sorted()
        np.testing.assert_array_equal(
            np.asarray(reader.records), _oracle(recs)
        )

    def test_matches_native_sort_file(self, tmp_path, tmp_ibu_file):
        # oracle-exact vs the host C++ external merge sort
        from ibu_jax import native
        from ibu_jax.io.mmap import MmapReader

        if not native.available():
            pytest.skip(f"native runtime unavailable: {native.load_error()}")
        recs = _random_records(120_000, 7)
        in_path = tmp_ibu_file(recs)
        mesh_out = str(tmp_path / "mesh.ibu")
        native_out = str(tmp_path / "native.ibu")
        sort_file_mesh(in_path, mesh_out)
        native.sort_file(in_path, native_out)
        a = open(mesh_out, "rb").read()
        b = open(native_out, "rb").read()
        assert a == b  # byte-exact, header flags included
