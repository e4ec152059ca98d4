"""Device-mesh engine tests on the 8-device virtual CPU mesh.

The strategy mirrors the reference's parallel tests (closed-form checksums,
``mmap.rs:454-481``) with ``shard_map`` shards in place of OS threads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ibu_jax.constructs.record import make_records
from ibu_jax.ops.stats import barcode_histogram_np, checksum_records_np
from ibu_jax.ops.u64 import soa_from_records
from ibu_jax.parallel.device import (
    MapReduce,
    make_mesh,
    sharded_barcode_histogram,
    sharded_stats,
    soa_batches_from_mmap,
    stream_file_stats,
)
from ibu_jax.io.mmap import MmapReader
from ibu_jax.parallel.multihost import local_record_range, multihost_file_stats
from tests.conftest import make_records_arange


def random_records(n, seed=0, bc_space=None):
    rng = np.random.default_rng(seed)
    return make_records(
        rng.integers(0, bc_space or (1 << 63), n, dtype=np.uint64),
        rng.integers(0, 1 << 63, n, dtype=np.uint64),
        rng.integers(0, 1 << 63, n, dtype=np.uint64),
    )


def test_virtual_mesh_has_8_devices():
    assert make_mesh().devices.size == 8


class TestShardedStats:
    def test_matches_oracle_even_split(self):
        records = random_records(8 * 1000)
        got = sharded_stats(soa_from_records(records))
        want = checksum_records_np(records)
        assert got["count"] == 8000
        assert (got["barcode_sum"], got["umi_sum"], got["index_sum"]) == want

    def test_uneven_split_pads(self):
        records = random_records(8 * 1000 + 3, seed=1)
        got = sharded_stats(soa_from_records(records))
        assert got["count"] == 8003
        assert got["barcode_sum"] == checksum_records_np(records)[0]

    def test_tiny_batch_smaller_than_mesh(self):
        records = random_records(3, seed=2)
        got = sharded_stats(soa_from_records(records))
        assert got["count"] == 3
        assert got["index_sum"] == checksum_records_np(records)[2]

    def test_empty(self):
        got = sharded_stats(soa_from_records(random_records(0)))
        assert got == {
            "count": 0,
            "barcode_sum": 0,
            "umi_sum": 0,
            "index_sum": 0,
        }


class TestStreamFileStats:
    def test_streamed_matches_oracle(self, tmp_ibu_file):
        records = random_records(50_001, seed=3)
        path = tmp_ibu_file(records)
        got = stream_file_stats(MmapReader(path), batch_records=8192)
        want = checksum_records_np(records)
        assert got["count"] == 50_001
        assert (got["barcode_sum"], got["umi_sum"], got["index_sum"]) == want

    def test_closed_form(self, tmp_ibu_file):
        n = 10_000
        path = tmp_ibu_file(make_records_arange(n))
        got = stream_file_stats(MmapReader(path), batch_records=4096)
        s = n * (n - 1) // 2
        assert (got["barcode_sum"], got["umi_sum"], got["index_sum"]) == (
            s,
            2 * s,
            3 * s,
        )

    def test_soa_batches_cover_file(self, tmp_ibu_file):
        path = tmp_ibu_file(make_records_arange(10_000))
        total = sum(
            b.shape[1] for b in soa_batches_from_mmap(MmapReader(path), 3000)
        )
        assert total == 10_000


class TestCustomMapReduce:
    def test_max_index_with_custom_merge(self):
        """Non-linear statistic: per-shard max merged by host max."""

        engine = MapReduce(
            init=lambda: jnp.zeros((), jnp.uint32),
            update=lambda st, soa, n_valid: jnp.maximum(st, jnp.max(soa[4])),
            merge=lambda states: int(states.max()),
        )
        records = make_records_arange(1000)
        got = engine.run(iter([soa_from_records(records)]))
        assert got == 3 * 999

    def test_multiple_batches_accumulate(self):
        records = random_records(20_000, seed=5)
        soa = soa_from_records(records)
        batches = [soa[:, i : i + 4096] for i in range(0, 20_000, 4096)]
        from ibu_jax.parallel.device import STATS_MAP_REDUCE, finalize_stats

        got = finalize_stats(STATS_MAP_REDUCE.run(iter(batches)))
        assert got["count"] == 20_000
        assert got["umi_sum"] == checksum_records_np(records)[1]


class TestShardedHistogram:
    def test_matches_oracle(self):
        records = random_records(20_000, seed=7, bc_space=500)
        batches = [soa_from_records(records)]
        got = sharded_barcode_histogram(iter(batches), max_uniques_per_shard=1024)
        assert got == barcode_histogram_np(records)

    def test_across_batches(self):
        records = random_records(10_000, seed=8, bc_space=50)
        soa = soa_from_records(records)
        batches = [soa[:, :3000], soa[:, 3000:]]
        got = sharded_barcode_histogram(iter(batches), max_uniques_per_shard=512)
        assert got == barcode_histogram_np(records)

    def test_mixed_hinted_and_full_batches(self):
        """A stream whose first batch fits the lo word (1-key hinted
        sort) and whose second carries u64-range barcodes (full 2-key
        sort) must merge into one exact histogram — both compiled
        variants are exercised and their results combined."""
        rng = np.random.default_rng(13)
        small = make_records(
            rng.integers(0, 40, 5000).astype(np.uint64),
            np.arange(5000, dtype=np.uint64),
            np.arange(5000, dtype=np.uint64),
        )
        big = make_records(
            rng.integers(0, 40, 3000).astype(np.uint64)
            | np.uint64(0xFFFFFFFF00000000),
            np.arange(3000, dtype=np.uint64),
            np.arange(3000, dtype=np.uint64),
        )
        got = sharded_barcode_histogram(
            iter([soa_from_records(small), soa_from_records(big)]),
            max_uniques_per_shard=256,
        )
        assert got == barcode_histogram_np(np.concatenate([small, big]))

    def test_hinted_all_max_lo_barcode_not_pad_merged(self):
        """bc16 path: a genuine all-T 16-base barcode packs to
        0xFFFFFFFF — the mask/pad sentinel value. Stability must keep it
        counted and distinct from padding."""
        records = make_records(
            np.full(9, 0xFFFFFFFF, dtype=np.uint64),  # pads to 16
            np.arange(9, dtype=np.uint64),
            np.arange(9, dtype=np.uint64),
        )
        got = sharded_barcode_histogram(
            iter([soa_from_records(records)]), max_uniques_per_shard=64
        )
        assert got == {0xFFFFFFFF: 9}

    def test_padding_not_counted(self):
        """n not divisible by 8: zero-padding must not inflate barcode 0."""
        records = make_records(
            np.zeros(9, dtype=np.uint64),  # all barcode 0, n=9 → pads to 16
            np.arange(9, dtype=np.uint64),
            np.arange(9, dtype=np.uint64),
        )
        got = sharded_barcode_histogram(
            iter([soa_from_records(records)]), max_uniques_per_shard=64
        )
        assert got == {0: 9}


class TestMultihostSingleProcess:
    def test_local_range_is_whole_file(self):
        assert jax.process_count() == 1
        assert local_record_range(1234) == (0, 1234)

    def test_stats_match_stream(self, tmp_ibu_file):
        records = random_records(30_000, seed=9)
        path = tmp_ibu_file(records)
        got = multihost_file_stats(path, batch_records=8192)
        want = checksum_records_np(records)
        assert got["count"] == 30_000
        assert (got["barcode_sum"], got["umi_sum"], got["index_sum"]) == want


class TestReviewRegressions:
    def test_histogram_capacity_overflow_raises(self):
        records = random_records(4096, seed=11)  # ~4096 unique barcodes
        with pytest.raises(ValueError, match="unique barcodes"):
            sharded_barcode_histogram(
                iter([soa_from_records(records)]), max_uniques_per_shard=64
            )

    def test_as_raw_u32_wire_6x6(self):
        """A 6-record wire batch needs the explicit layout tag."""
        from ibu_jax.parallel.device import as_raw_u32

        records = make_records_arange(6)
        raw = records.view(np.uint32).reshape(6, 6)
        out = as_raw_u32(raw, layout="wire")
        assert out is raw  # untouched, not transposed
        cols = as_raw_u32(np.ascontiguousarray(raw.T), layout="columns")
        assert np.array_equal(cols, raw)

    def test_limb_accumulator_many_small_batches(self):
        """65k+ tiny batches must not wrap the limb accumulator (silent
        checksum corruption regression)."""
        from ibu_jax.parallel.device import STATS_MAP_REDUCE, finalize_stats, make_mesh

        mesh = make_mesh()
        step = STATS_MAP_REDUCE.compile_step(mesh)
        states = STATS_MAP_REDUCE.initial_states(mesh)
        from ibu_jax.parallel.device import shard_batch

        # one batch of 8 records with near-max barcodes, replayed 70k times
        records = make_records(
            np.full(8, 0xFFFF, dtype=np.uint64),
            np.zeros(8, dtype=np.uint64),
            np.zeros(8, dtype=np.uint64),
        )
        dev_raw, dev_valid = shard_batch(records, mesh)
        reps = 70_000
        for _ in range(reps):
            states = step(states, dev_raw, dev_valid)
        got = finalize_stats(STATS_MAP_REDUCE.finalize(states))
        assert got["count"] == 8 * reps
        assert got["barcode_sum"] == (8 * reps * 0xFFFF) & 0xFFFFFFFFFFFFFFFF

    def test_histogram_exact_capacity_no_error(self):
        """A shard at exactly max_uniques_per_shard must NOT raise."""
        # 8 shards x 8 records, barcodes 0..63: each shard sees 8 uniques
        records = make_records(
            np.arange(64, dtype=np.uint64),
            np.zeros(64, dtype=np.uint64),
            np.zeros(64, dtype=np.uint64),
        )
        got = sharded_barcode_histogram(
            iter([soa_from_records(records)]), max_uniques_per_shard=8
        )
        assert got == {i: 1 for i in range(64)}


class TestDeviceHistogram:
    """Device-resident histogram accumulator (cross-shard merge on device)."""

    def test_matches_host_oracle(self):
        from ibu_jax.parallel.device import DeviceHistogram

        records = random_records(10_000, seed=21, bc_space=200)
        soa = soa_from_records(records)
        h = DeviceHistogram(capacity=1024, max_uniques_per_shard=512)
        got = h.run(iter([soa[:, :4000], soa[:, 4000:9001], soa[:, 9001:]]))
        assert got == barcode_histogram_np(records)

    def test_structured_batches_and_uneven_split(self):
        from ibu_jax.parallel.device import DeviceHistogram

        records = random_records(777, seed=22, bc_space=50)
        h = DeviceHistogram(capacity=256, max_uniques_per_shard=128)
        got = h.run(iter([records]))
        assert got == barcode_histogram_np(records)

    def test_zero_barcode_padding_not_counted(self):
        from ibu_jax.parallel.device import DeviceHistogram

        records = make_records(
            np.zeros(9, dtype=np.uint64),
            np.arange(9, dtype=np.uint64),
            np.arange(9, dtype=np.uint64),
        )
        h = DeviceHistogram(capacity=64, max_uniques_per_shard=32)
        assert h.run(iter([records])) == {0: 9}

    def test_u64_max_barcode(self):
        from ibu_jax.parallel.device import DeviceHistogram

        big = np.uint64(0xFFFFFFFFFFFFFFFF)
        records = make_records(
            np.array([big, big, 5], dtype=np.uint64),
            np.arange(3, dtype=np.uint64),
            np.arange(3, dtype=np.uint64),
        )
        h = DeviceHistogram(capacity=64, max_uniques_per_shard=32)
        assert h.run(iter([records])) == {int(big): 2, 5: 1}

    @pytest.mark.parametrize("merge_every", [1, 3, 8])
    def test_staging_fill_levels_exact(self, merge_every):
        # exactness must hold at every stage-fill level: batch counts that
        # end exactly on a merge boundary, one short of it, and one past it
        from ibu_jax.parallel.device import DeviceHistogram

        records = random_records(11_000, seed=31, bc_space=300)
        want = barcode_histogram_np(records)
        for nbatches in (merge_every - 1 or 1, merge_every,
                         merge_every + 1, 2 * merge_every + 1):
            bounds = np.linspace(0, len(records), nbatches + 1).astype(int)
            h = DeviceHistogram(capacity=1024, max_uniques_per_shard=512,
                                merge_every=merge_every)
            got = h.run(
                iter([records[s:e] for s, e in zip(bounds, bounds[1:])])
            )
            assert got == want, (merge_every, nbatches)

    def test_merge_every_validated(self):
        from ibu_jax.parallel.device import DeviceHistogram

        with pytest.raises(ValueError, match="merge_every"):
            DeviceHistogram(capacity=64, merge_every=0)

    def test_capacity_overflow_raises_at_finalize(self):
        # strict mode (spill=False): table overflow is a terminal error
        from ibu_jax.parallel.device import DeviceHistogram

        records = random_records(4096, seed=23)  # ~4096 unique barcodes
        h = DeviceHistogram(
            capacity=128, max_uniques_per_shard=4096, spill=False
        )
        h.update(soa_from_records(records))
        with pytest.raises(ValueError, match="device table"):
            h.finalize()

    def test_spill_exact_on_4x_capacity_space(self):
        # default (spill=True): a barcode space 4x the device table is
        # exact — overflowed groups drain to the host and fold back in
        from ibu_jax.parallel.device import DeviceHistogram

        rng = np.random.default_rng(41)
        capacity = 128
        parts = [
            make_records(
                rng.integers(0, 4 * capacity, 700, dtype=np.uint64),
                rng.integers(0, 1 << 63, 700, dtype=np.uint64),
                np.arange(700, dtype=np.uint64),
            )
            for _ in range(7)
        ]
        h = DeviceHistogram(
            capacity=capacity, max_uniques_per_shard=1024, merge_every=2
        )
        got = h.run(iter(parts))
        assert got == barcode_histogram_np(np.concatenate(parts))
        assert h._spilled  # the spill path actually engaged

    def test_spill_respilled_keys_sum_exactly(self):
        # a key that overflows in one merge cycle and re-enters the table
        # in a later one must end with the SUM of both contributions
        from ibu_jax.parallel.device import DeviceHistogram

        capacity = 4
        # cycle 1: keys 0..15 (12 overflow past capacity 4)
        # cycle 2: keys 8..23 — 8..15 already spilled once, appear again
        a = make_records(
            np.arange(16, dtype=np.uint64),
            np.zeros(16, np.uint64),
            np.zeros(16, np.uint64),
        )
        b = make_records(
            np.arange(8, 24, dtype=np.uint64),
            np.zeros(16, np.uint64),
            np.zeros(16, np.uint64),
        )
        h = DeviceHistogram(
            capacity=capacity, max_uniques_per_shard=64, merge_every=1
        )
        got = h.run(iter([a, b]))
        assert got == barcode_histogram_np(np.concatenate([a, b]))

    def test_spill_stream_file_histogram(self, tmp_ibu_file):
        # ONE streaming call over a barcode
        # space 4x the device capacity, oracle-exact
        from ibu_jax.parallel.device import stream_file_histogram

        rng = np.random.default_rng(42)
        capacity = 256
        records = make_records(
            rng.integers(0, 4 * capacity, 50_000, dtype=np.uint64),
            rng.integers(0, 1 << 63, 50_000, dtype=np.uint64),
            np.arange(50_000, dtype=np.uint64),
        )
        path = tmp_ibu_file(records)
        got = stream_file_histogram(
            MmapReader(path),
            batch_records=4096,
            capacity=capacity,
            max_uniques_per_shard=2048,
        )
        assert got == barcode_histogram_np(records)

    def test_shard_overflow_raises_at_finalize(self):
        from ibu_jax.parallel.device import DeviceHistogram

        records = random_records(4096, seed=24)
        h = DeviceHistogram(capacity=1 << 14, max_uniques_per_shard=64)
        h.update(soa_from_records(records))
        with pytest.raises(ValueError, match="unique barcodes"):
            h.finalize()

    def test_merge_across_many_batches(self):
        from ibu_jax.parallel.device import DeviceHistogram

        rng = np.random.default_rng(25)
        parts = [
            make_records(
                rng.integers(0, 30, 500, dtype=np.uint64),
                rng.integers(0, 1 << 63, 500, dtype=np.uint64),
                rng.integers(0, 1 << 63, 500, dtype=np.uint64),
            )
            for _ in range(6)
        ]
        h = DeviceHistogram(capacity=128, max_uniques_per_shard=64)
        got = h.run(iter(parts))
        assert got == barcode_histogram_np(np.concatenate(parts))


class TestMultihostMapReduce:
    def test_custom_engine_single_process(self, tmp_ibu_file):
        """A user-defined MapReduce through the multihost entry point
        (single-process path) — max/min barcode over the whole file."""
        import jax.numpy as jnp

        from ibu_jax.parallel.multihost import multihost_map_reduce

        rng = np.random.default_rng(31)
        bc = rng.integers(1, 1 << 31, 20_000).astype(np.uint64)
        records = make_records(
            bc, np.zeros(20_000, np.uint64), np.zeros(20_000, np.uint64)
        )
        path = tmp_ibu_file(records)

        engine = MapReduce(
            init=lambda: {
                "mx": jnp.zeros((), jnp.uint32),
                "mn": jnp.full((), 0xFFFFFFFF, jnp.uint32),
            },
            update=lambda st, soa, n: {
                "mx": jnp.maximum(
                    st["mx"],
                    jnp.max(
                        jnp.where(
                            jnp.arange(soa.shape[1]) < n, soa[0], 0
                        ).astype(jnp.uint32)
                    ),
                ),
                "mn": jnp.minimum(
                    st["mn"],
                    jnp.min(
                        jnp.where(
                            jnp.arange(soa.shape[1]) < n,
                            soa[0],
                            jnp.uint32(0xFFFFFFFF),
                        ).astype(jnp.uint32)
                    ),
                ),
            },
            merge=lambda sts: {
                "mx": sts["mx"].max(axis=0),
                "mn": sts["mn"].min(axis=0),
            },
        )
        got = multihost_map_reduce(path, engine, batch_records=4096)
        assert int(got["mx"]) == int(bc.max())
        assert int(got["mn"]) == int(bc.min())

    def test_stream_file_histogram(self, tmp_ibu_file):
        from ibu_jax.parallel.device import stream_file_histogram

        records = random_records(25_000, seed=26, bc_space=400)
        path = tmp_ibu_file(records)
        got = stream_file_histogram(
            MmapReader(path),
            batch_records=4096,
            capacity=2048,
            max_uniques_per_shard=1024,
        )
        assert got == barcode_histogram_np(records)


class TestSortedFastPath:
    """Sorted-input histogram fast path (no per-shard sort; in-kernel
    order verification)."""

    @staticmethod
    def _sorted_records(n, seed, bc_space):
        from ibu_jax.constructs.record import sort_records

        return sort_records(random_records(n, seed=seed, bc_space=bc_space))

    def test_device_histogram_sorted_matches_oracle(self):
        from ibu_jax.parallel.device import DeviceHistogram

        records = self._sorted_records(10_000, 31, 300)
        h = DeviceHistogram(
            capacity=1024, max_uniques_per_shard=512, assume_sorted=True
        )
        got = h.run(iter([records[:4000], records[4000:9001], records[9001:]]))
        assert got == barcode_histogram_np(records)

    def test_sorted_u64_barcodes_cross_word(self):
        """Barcodes spanning the hi word exercise the 2-word adjacency
        and order checks."""
        from ibu_jax.parallel.device import DeviceHistogram

        records = self._sorted_records(5_000, 32, None)  # full u64 space
        h = DeviceHistogram(
            capacity=8192, max_uniques_per_shard=4096, assume_sorted=True
        )
        assert h.run(iter([records])) == barcode_histogram_np(records)

    def test_group_spanning_batch_and_shard_boundaries(self):
        from ibu_jax.parallel.device import DeviceHistogram

        records = make_records(
            np.repeat(np.arange(5, dtype=np.uint64), 700),
            np.zeros(3500, dtype=np.uint64),
            np.arange(3500, dtype=np.uint64),
        )
        h = DeviceHistogram(
            capacity=64, max_uniques_per_shard=32, assume_sorted=True
        )
        got = h.run(iter([records[:1500], records[1500:]]))
        assert got == {i: 700 for i in range(5)}

    def test_lying_sorted_flag_raises(self):
        """Disorder WITHIN a shard's block (the correctness-relevant
        scope — cross-shard merging is by key) must raise at finalize."""
        from ibu_jax.parallel.device import DeviceHistogram

        bc = np.arange(64, dtype=np.uint64)
        bc[10], bc[11] = bc[11], bc[10]  # one within-shard decrease
        records = make_records(
            bc, np.zeros(64, dtype=np.uint64), np.arange(64, dtype=np.uint64)
        )
        h = DeviceHistogram(
            capacity=128, max_uniques_per_shard=64, assume_sorted=True
        )
        h.update(records)
        with pytest.raises(ValueError, match="sorted"):
            h.finalize()

    def test_lying_flag_in_hi_word_only(self):
        """A decrease visible only in the hi word must be caught."""
        from ibu_jax.parallel.device import DeviceHistogram

        bc = (np.arange(64, dtype=np.uint64) << np.uint64(32)) | np.uint64(7)
        bc[20], bc[21] = bc[21], bc[20]  # hi-word-only within-shard swap
        records = make_records(
            bc, np.zeros(64, dtype=np.uint64), np.arange(64, dtype=np.uint64)
        )
        h = DeviceHistogram(
            capacity=128, max_uniques_per_shard=64, assume_sorted=True
        )
        h.update(records)
        with pytest.raises(ValueError, match="sorted"):
            h.finalize()

    def test_shard_boundary_decrease_is_harmless_and_exact(self):
        """A decrease exactly at a shard boundary cannot corrupt counts
        (merge is by key) and must NOT raise."""
        from ibu_jax.parallel.device import DeviceHistogram

        # 8 shards x 2 rows: sorted within every pair, decreasing across
        bc = np.array(
            [100, 100, 90, 90, 80, 80, 70, 70, 60, 60, 50, 50, 40, 40,
             30, 30],
            dtype=np.uint64,
        )
        records = make_records(
            bc, np.zeros(16, dtype=np.uint64), np.arange(16, dtype=np.uint64)
        )
        h = DeviceHistogram(
            capacity=64, max_uniques_per_shard=32, assume_sorted=True
        )
        assert h.run(iter([records])) == barcode_histogram_np(records)

    def test_sharded_histogram_sorted_in(self):
        records = self._sorted_records(8_000, 33, 150)
        got = sharded_barcode_histogram(
            iter([records[:3000], records[3000:]]),
            max_uniques_per_shard=512,
            sorted_in=True,
        )
        assert got == barcode_histogram_np(records)

    def test_stream_file_histogram_auto_fast_path(self, tmp_ibu_file):
        """A header-sorted file takes the fast path automatically and
        stays exact."""
        from ibu_jax.constructs.header import Header
        from ibu_jax.parallel.device import stream_file_histogram

        records = self._sorted_records(20_000, 34, 250)
        hdr = Header.new(16, 12)
        hdr.set_sorted()
        path = tmp_ibu_file(records, header=hdr)
        reader = MmapReader(path)
        assert reader.header().sorted()
        got = stream_file_histogram(
            reader, batch_records=4096, capacity=2048,
            max_uniques_per_shard=1024,
        )
        assert got == barcode_histogram_np(records)

    def test_stream_file_histogram_lying_flag_raises(self, tmp_ibu_file):
        from ibu_jax.constructs.header import Header
        from ibu_jax.parallel.device import stream_file_histogram

        records = random_records(5_000, seed=35, bc_space=100)  # unsorted
        hdr = Header.new(16, 12)
        hdr.set_sorted()  # lie
        path = tmp_ibu_file(records, header=hdr)
        with pytest.raises(ValueError, match="sorted"):
            stream_file_histogram(MmapReader(path), batch_records=1024)

    def test_sorted_with_spill(self):
        """Fast path composes with the exact overflow spill."""
        from ibu_jax.parallel.device import DeviceHistogram

        records = self._sorted_records(6_000, 36, 3_000)
        h = DeviceHistogram(
            capacity=256, max_uniques_per_shard=2048, merge_every=2,
            spill=True, assume_sorted=True,
        )
        got = h.run(iter([records[:2500], records[2500:5000],
                          records[5000:]]))
        assert got == barcode_histogram_np(records)
