"""RecordLoader: epochs, shuffle determinism, sharding, device placement.

Runs on the conftest-forced 8-virtual-device CPU mesh; content equality is
checked against the mmap itself (the loader must be a pure reordering of
the file's records, never a resampling).
"""

import numpy as np
import pytest

from ibu_jax import Header, MmapReader, Writer
from ibu_jax.constructs.record import make_records
from ibu_jax.data import RecordLoader


@pytest.fixture(scope="module")
def ibu_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "train.ibu")
    n = 10_000
    i = np.arange(n, dtype=np.uint64)
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(make_records(i, i * np.uint64(3), i))
    return path, n


def _indices(batches):
    return np.concatenate([np.asarray(b)["index"] for b in batches])


class TestHostPath:
    def test_sequential_batches_cover_file_in_order(self, ibu_file):
        path, n = ibu_file
        ld = RecordLoader(path, 1000, to_device=False)
        assert len(ld) == 10 and ld.records == n
        got = _indices(ld.host_batches())
        np.testing.assert_array_equal(got, np.arange(n, dtype=np.uint64))

    def test_static_shapes_and_drop_remainder(self, ibu_file):
        path, n = ibu_file
        ld = RecordLoader(path, 1024, to_device=False)
        sizes = [len(b) for b in ld.host_batches()]
        assert sizes == [1024] * (n // 1024)  # tail dropped, all static
        ld2 = RecordLoader(path, 1024, drop_remainder=False, to_device=False)
        sizes2 = [len(b) for b in ld2.host_batches()]
        assert sum(sizes2) == n and sizes2[-1] == n % 1024

    def test_global_shuffle_is_permutation_and_seeded(self, ibu_file):
        path, n = ibu_file
        ld = RecordLoader(path, 1000, shuffle=True, seed=7, to_device=False)
        got = _indices(ld.host_batches(epoch=0))
        assert not np.array_equal(got, np.arange(n, dtype=np.uint64))
        np.testing.assert_array_equal(
            np.sort(got), np.arange(n, dtype=np.uint64))
        # deterministic per (seed, epoch); different across epochs/seeds
        again = _indices(RecordLoader(
            path, 1000, shuffle=True, seed=7, to_device=False
        ).host_batches(epoch=0))
        np.testing.assert_array_equal(got, again)
        ep1 = _indices(ld.host_batches(epoch=1))
        assert not np.array_equal(got, ep1)
        other = _indices(RecordLoader(
            path, 1000, shuffle=True, seed=8, to_device=False
        ).host_batches(epoch=0))
        assert not np.array_equal(got, other)

    def test_block_shuffle_is_page_local_permutation(self, ibu_file):
        path, n = ibu_file
        ld = RecordLoader(path, 500, shuffle="blocks", block_records=1000,
                          seed=3, to_device=False)
        got = _indices(ld.host_batches())
        np.testing.assert_array_equal(
            np.sort(got), np.arange(n, dtype=np.uint64))
        # every block-sized window of the order maps to exactly one block
        for w in range(n // 1000):
            window = got[w * 1000:(w + 1) * 1000]
            assert np.ptp(window) < 1000
            assert window[0] // 1000 == window[-1] // 1000

    def test_sharding_is_disjoint_and_exhaustive(self, ibu_file):
        path, n = ibu_file
        parts = []
        for k in range(3):
            ld = RecordLoader(path, 512, shard_index=k, shard_count=3,
                              drop_remainder=False, to_device=False)
            parts.append(_indices(ld.host_batches()))
        allrec = np.concatenate(parts)
        np.testing.assert_array_equal(
            np.sort(allrec), np.arange(n, dtype=np.uint64))
        # contiguous remainder-to-last rule: shard 2 gets the remainder
        assert len(parts[0]) == len(parts[1]) == n // 3
        assert len(parts[2]) == n - 2 * (n // 3)

    def test_shuffle_shards_stay_disjoint(self, ibu_file):
        path, n = ibu_file
        a = _indices(RecordLoader(
            path, 512, shuffle=True, seed=1, shard_index=0, shard_count=2,
            drop_remainder=False, to_device=False).host_batches())
        b = _indices(RecordLoader(
            path, 512, shuffle=True, seed=1, shard_index=1, shard_count=2,
            drop_remainder=False, to_device=False).host_batches())
        assert not np.intersect1d(a, b).size
        assert len(a) + len(b) == n

    def test_epochs_chains_with_reshuffle(self, ibu_file):
        path, n = ibu_file
        ld = RecordLoader(path, 2000, shuffle=True, to_device=False)
        seen = list(ld.epochs(2))
        assert len(seen) == 2 * len(ld)
        assert not np.array_equal(_indices(seen[:5]), _indices(seen[5:]))

    def test_compressed_path_clear_error(self, tmp_path):
        import gzip

        from ibu_jax import Header, Writer
        from ibu_jax.constructs.record import make_records
        from ibu_jax.data import RecordLoader

        i = np.arange(100, dtype=np.uint64)
        p = str(tmp_path / "z.ibu.gz")
        with Writer.from_path(p, Header.new(8, 6), compression="auto") as w:
            w.write_batch(make_records(i, i, i))
        # without the sniff this died with a misleading InvalidMagicNumber
        # (the gzip magic parsed as an IBU header)
        with pytest.raises(ValueError, match="gzip-compressed"):
            RecordLoader(p, batch_records=10)

    def test_bad_args_rejected(self, ibu_file):
        path, _ = ibu_file
        with pytest.raises(ValueError, match="batch_records"):
            RecordLoader(path, 0)
        with pytest.raises(ValueError, match="shuffle"):
            RecordLoader(path, 10, shuffle="banana")
        with pytest.raises(ValueError, match="shard_index"):
            RecordLoader(path, 10, shard_index=2, shard_count=2)

    def test_empty_file(self, tmp_path):
        path = str(tmp_path / "e.ibu")
        with Writer.from_path(path, Header.new(4, 4)):
            pass
        ld = RecordLoader(path, 8, shuffle=True, to_device=False)
        assert len(ld) == 0 and list(ld.host_batches()) == []


class TestDevicePath:
    def test_device_batches_match_host_oracle(self, ibu_file):
        import jax

        from ibu_jax.parallel.device import make_mesh

        path, n = ibu_file
        mesh = make_mesh()
        ld = RecordLoader(path, 1024, shuffle=True, seed=5, mesh=mesh)
        host = list(RecordLoader(
            path, 1024, shuffle=True, seed=5, to_device=False
        ).host_batches())
        dev = list(ld.epoch(0))
        assert len(dev) == len(host) == n // 1024
        for (dev_raw, valid), want in zip(dev, host):
            assert isinstance(dev_raw, jax.Array)
            assert dev_raw.shape == (1024, 6)
            assert int(np.asarray(valid).sum()) == 1024
            got = np.asarray(dev_raw).view(np.uint64).reshape(-1, 3)
            want_raw = np.ascontiguousarray(np.asarray(want)).view(
                np.uint64).reshape(-1, 3)
            np.testing.assert_array_equal(got, want_raw)

    def test_padded_tail_valid_counts(self, ibu_file):
        path, n = ibu_file
        ld = RecordLoader(path, 4096, drop_remainder=False)
        *_, (last_raw, last_valid) = iter(ld)
        tail = n % 4096
        assert int(np.asarray(last_valid).sum()) == tail
        assert last_raw.shape[0] % 8 == 0  # padded to the 8-device mesh
