"""Native (C++) host runtime tests — parity with the numpy oracles.

Skipped wholesale if the toolchain can't build the library (nothing in
ibu_jax hard-requires native code).
"""

import numpy as np
import pytest

from ibu_jax import Header, Writer, native, sort_records
from ibu_jax.constructs.record import RECORD_DTYPE, make_records
from ibu_jax.ops import codec as C
from tests.conftest import make_records_arange

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native build unavailable: {native.load_error()}"
)


class TestNativeCodec:
    @pytest.mark.parametrize("L", [1, 16, 17, 32])
    def test_pack_matches_numpy(self, L):
        rows = np.frombuffer(b"ACGT", dtype=np.uint8)[
            np.random.default_rng(L).integers(0, 4, (500, L))
        ]
        assert np.array_equal(native.pack_2bit(rows), C.np_pack(rows))

    @pytest.mark.parametrize("L", [1, 16, 17, 32])
    def test_unpack_matches_numpy(self, L):
        rows = np.frombuffer(b"ACGT", dtype=np.uint8)[
            np.random.default_rng(100 + L).integers(0, 4, (500, L))
        ]
        words = C.np_pack(rows)
        assert np.array_equal(native.unpack_2bit(words, L), rows)

    def test_lowercase(self):
        rows = np.frombuffer(b"acgt", dtype=np.uint8)[
            np.random.default_rng(0).integers(0, 4, (64, 8))
        ]
        assert np.array_equal(native.pack_2bit(rows), C.np_pack(rows))

    def test_invalid_base_rejected(self):
        with pytest.raises(ValueError):
            native.pack_2bit(np.frombuffer(b"ACGN", dtype=np.uint8).reshape(1, 4))

    def test_invalid_length_rejected(self):
        with pytest.raises(ValueError):
            native.pack_2bit(np.zeros((1, 33), dtype=np.uint8), validate=False)


class TestNativeIO:
    def test_write_read_roundtrip(self, tmp_path):
        recs = make_records_arange(10_000)
        path = str(tmp_path / "n.ibu")
        native.write_file(path, Header.new(16, 12).as_bytes(), recs)
        assert native.file_size(path) == 32 + 10_000 * 24
        back = native.read_records(path, 10_000)
        assert np.array_equal(back, recs)

    def test_file_is_valid_for_python_reader(self, tmp_path):
        """Native-written files read back through the Python stack."""
        from ibu_jax import Reader

        recs = make_records_arange(100)
        path = str(tmp_path / "n.ibu")
        native.write_file(path, Header.new(8, 8).as_bytes(), recs)
        r = Reader.from_path(path)
        assert r.header().bc_len == 8
        assert sum(len(b) for b in r.batches()) == 100

    def test_headless_write(self, tmp_path):
        recs = make_records_arange(5)
        path = str(tmp_path / "h.bin")
        native.write_file(path, None, recs)
        assert native.file_size(path) == 5 * 24

    def test_missing_file_errors(self, tmp_path):
        with pytest.raises(OSError):
            native.read_records(str(tmp_path / "nope.ibu"), 10)


class TestNativeEngine:
    def test_checksum_closed_form(self, tmp_path):
        n = 50_000
        recs = make_records_arange(n)
        path = str(tmp_path / "c.ibu")
        native.write_file(path, Header.new(16, 12).as_bytes(), recs)
        s = n * (n - 1) // 2
        assert native.checksum_parallel(path, n, 2) == (s, 2 * s, 3 * s)
        assert native.checksum_parallel(path, n, 0) == (s, 2 * s, 3 * s)

    def test_checksum_wraps_u64(self, tmp_path):
        recs = make_records(
            np.full(3, 0xFFFFFFFFFFFFFFFF, dtype=np.uint64),
            np.zeros(3, dtype=np.uint64),
            np.zeros(3, dtype=np.uint64),
        )
        path = str(tmp_path / "w.ibu")
        native.write_file(path, Header.new(16, 12).as_bytes(), recs)
        got = native.checksum_parallel(path, 3, 1)
        assert got[0] == (3 * 0xFFFFFFFFFFFFFFFF) & 0xFFFFFFFFFFFFFFFF

    def test_sort_file_external_merge(self, tmp_path):
        """Out-of-core sort: multiple runs, oracle equality, sorted flag."""
        rng = np.random.default_rng(3)
        n = 100_000
        recs = make_records(
            rng.integers(0, 1 << 60, n, dtype=np.uint64),
            rng.integers(0, 1 << 60, n, dtype=np.uint64),
            np.arange(n, dtype=np.uint64),
        )
        src = str(tmp_path / "u.ibu")
        dst = str(tmp_path / "s.ibu")
        native.write_file(src, Header.new(16, 12).as_bytes(), recs)
        native.sort_file(src, dst, chunk_records=10_000, nthreads=2)
        from ibu_jax import MmapReader

        r = MmapReader(dst)
        assert r.len() == n
        assert r.header().sorted()
        assert np.array_equal(np.asarray(r.records), sort_records(recs))
        assert not list(tmp_path.glob("*.run*"))  # temp runs cleaned

    def test_sort_file_empty(self, tmp_path):
        src = str(tmp_path / "e.ibu")
        dst = str(tmp_path / "es.ibu")
        native.write_file(src, Header.new(4, 4).as_bytes(),
                          make_records_arange(0))
        native.sort_file(src, dst)
        from ibu_jax import MmapReader

        r = MmapReader(dst)
        assert r.len() == 0 and r.header().sorted()

    def test_sort_file_invalid_size(self, tmp_path):
        from ibu_jax import InvalidMapSize

        src = tmp_path / "bad.ibu"
        src.write_bytes(b"\x00" * 40)  # 32 header + 8 ragged bytes
        with pytest.raises(InvalidMapSize):
            native.sort_file(str(src), str(tmp_path / "out.ibu"))

    def test_sort_matches_numpy(self):
        rng = np.random.default_rng(2)
        recs = make_records(
            rng.integers(0, 50, 3000, dtype=np.uint64),
            rng.integers(0, 50, 3000, dtype=np.uint64),
            rng.integers(0, 50, 3000, dtype=np.uint64),
        )
        want = sort_records(recs)
        got = native.sort_records(recs.copy())
        assert np.array_equal(got, want)


class TestReviewRegressions:
    def test_sort_records_readonly_memmap(self, tmp_path):
        """Read-only mmap input must not crash; returns a sorted copy."""
        from ibu_jax import MmapReader

        recs = make_records(
            np.array([3, 1, 2], dtype=np.uint64),
            np.zeros(3, dtype=np.uint64),
            np.zeros(3, dtype=np.uint64),
        )
        path = str(tmp_path / "ro.ibu")
        native.write_file(path, Header.new(16, 12).as_bytes(), recs)
        mm = MmapReader(path)
        out = native.sort_records(mm.records)
        assert out["barcode"].tolist() == [1, 2, 3]
        assert mm.records["barcode"].tolist() == [3, 1, 2]  # source untouched

    def test_sort_records_strided_view_returns_sorted_copy(self):
        recs = make_records(
            np.array([5, 9, 3, 9, 1, 9], dtype=np.uint64),
            np.zeros(6, dtype=np.uint64),
            np.zeros(6, dtype=np.uint64),
        )
        out = native.sort_records(recs[::2])
        assert out["barcode"].tolist() == [1, 3, 5]


class TestMergeFiles:
    def _sorted_file(self, tmp_path, name, records):
        from ibu_jax import Header, Writer

        records = np.sort(records, order=("barcode", "umi", "index"))
        h = Header.new(16, 12)
        h.set_sorted()
        path = str(tmp_path / name)
        with Writer.from_path(path, h) as w:
            w.write_batch(records)
        return path, records

    def test_three_way_merge(self, tmp_path):
        native = pytest.importorskip("ibu_jax.native")
        if not native.available():
            pytest.skip(native.load_error())
        rng = np.random.default_rng(70)
        parts, paths = [], []
        for k, n in enumerate((5000, 1, 70_000)):  # force run refills
            recs = make_records(
                rng.integers(0, 1 << 40, n, dtype=np.uint64),
                rng.integers(0, 1 << 40, n, dtype=np.uint64),
                rng.integers(0, 1 << 63, n, dtype=np.uint64),
            )
            p, srt = self._sorted_file(tmp_path, f"m{k}.ibu", recs)
            parts.append(srt)
            paths.append(p)
        out = str(tmp_path / "merged.ibu")
        native.merge_files(paths, out)
        from ibu_jax import MmapReader

        r = MmapReader(out)
        assert r.header().sorted()
        got = np.asarray(r.records)
        want = np.sort(np.concatenate(parts),
                       order=("barcode", "umi", "index"))
        assert np.array_equal(got, want)

    def test_unsorted_input_rejected(self, tmp_path):
        native = pytest.importorskip("ibu_jax.native")
        if not native.available():
            pytest.skip(native.load_error())
        from ibu_jax import Header, Writer

        h = Header.new(16, 12)
        h.set_sorted()  # flag LIES: records are out of order
        path = str(tmp_path / "lying.ibu")
        with Writer.from_path(path, h) as w:
            w.write_batch(make_records(
                np.array([9, 1, 5], dtype=np.uint64),
                np.zeros(3, dtype=np.uint64),
                np.zeros(3, dtype=np.uint64),
            ))
        good, _ = self._sorted_file(
            tmp_path, "good.ibu",
            make_records(np.arange(10, dtype=np.uint64),
                         np.zeros(10, dtype=np.uint64),
                         np.zeros(10, dtype=np.uint64)),
        )
        out = str(tmp_path / "out.ibu")
        with pytest.raises(OSError):
            native.merge_files([good, path], out)
        assert not (tmp_path / "out.ibu").exists()

    def test_flag_and_header_validation(self, tmp_path):
        native = pytest.importorskip("ibu_jax.native")
        if not native.available():
            pytest.skip(native.load_error())
        from ibu_jax import Header, Writer

        unsorted_path = str(tmp_path / "u.ibu")
        with Writer.from_path(unsorted_path, Header.new(16, 12)) as w:
            w.write_batch(make_records(np.arange(3, dtype=np.uint64),
                                       np.zeros(3, dtype=np.uint64),
                                       np.zeros(3, dtype=np.uint64)))
        with pytest.raises(ValueError, match="sorted flag"):
            native.merge_files([unsorted_path], str(tmp_path / "o.ibu"))

        other = Header.new(8, 8)
        other.set_sorted()
        other_path = str(tmp_path / "o8.ibu")
        with Writer.from_path(other_path, other) as w:
            w.write_batch(make_records(np.arange(3, dtype=np.uint64),
                                       np.zeros(3, dtype=np.uint64),
                                       np.zeros(3, dtype=np.uint64)))
        good, _ = self._sorted_file(
            tmp_path, "g.ibu",
            make_records(np.arange(3, dtype=np.uint64),
                         np.zeros(3, dtype=np.uint64),
                         np.zeros(3, dtype=np.uint64)),
        )
        with pytest.raises(ValueError, match="differs"):
            native.merge_files([good, other_path], str(tmp_path / "o.ibu"))

    def test_output_aliasing_input_refused(self, tmp_path):
        """merge out==input would O_TRUNC the input mid-merge (data loss)."""
        native = pytest.importorskip("ibu_jax.native")
        if not native.available():
            pytest.skip(native.load_error())
        path, _ = self._sorted_file(
            tmp_path, "a.ibu",
            make_records(np.arange(5, dtype=np.uint64),
                         np.zeros(5, dtype=np.uint64),
                         np.zeros(5, dtype=np.uint64)),
        )
        with pytest.raises(ValueError, match="same file"):
            native.merge_files([path], path)
        # input untouched
        from ibu_jax import MmapReader

        assert len(MmapReader(path)) == 5


class TestPodSortPrimitives:
    """Direct unit tests of the pod host-sort natives (the cluster tests
    cover composition; these pin each primitive's contract)."""

    @staticmethod
    def _file(tmp_path, recs):
        path = str(tmp_path / "p.ibu")
        with Writer.from_path(path, Header.new(16, 12)) as w:
            w.write_batch(recs)
        return path

    def test_sort_chunks_range_runs_sorted_and_complete(self, tmp_path):
        if not native.available():
            pytest.skip("no native runtime")
        rng = np.random.default_rng(5)
        recs = make_records(
            rng.integers(0, 1 << 40, 10_000).astype(np.uint64),
            rng.integers(0, 1 << 40, 10_000).astype(np.uint64),
            np.arange(10_000, dtype=np.uint64),
        )
        path = self._file(tmp_path, recs)
        runs = native.sort_chunks_range(
            path, str(tmp_path / "r"), 100, 8_000, chunk_records=3_000
        )
        assert len(runs) == 3  # ceil(8000/3000)
        parts = [np.fromfile(r, dtype=recs.dtype) for r in runs]
        for p in parts:
            assert np.array_equal(
                p, np.sort(p, order=("barcode", "umi", "index"))
            )
        got = np.sort(np.concatenate(parts),
                      order=("barcode", "umi", "index"))
        want = np.sort(recs[100:8_100], order=("barcode", "umi", "index"))
        assert np.array_equal(got, want)
        # empty range -> zero runs
        assert native.sort_chunks_range(
            path, str(tmp_path / "e"), 0, 0
        ) == []

    def test_run_interval_bounds(self, tmp_path):
        if not native.available():
            pytest.skip("no native runtime")
        recs = np.sort(
            make_records(
                np.repeat(np.arange(10, dtype=np.uint64), 100),
                np.zeros(1000, dtype=np.uint64),
                np.arange(1000, dtype=np.uint64),
            ),
            order=("barcode", "umi", "index"),
        )
        run = str(tmp_path / "run0")
        recs.tofile(run)  # headerless
        a, b = native.run_interval(run, (3, 0, 0), (7, 0, 0))
        assert (a, b) == (300, 700)
        a, b = native.run_interval(run, (0, 0, 0), None)
        assert (a, b) == (0, 1000)
        a, b = native.run_interval(run, (99, 0, 0), (200, 0, 0))
        assert (a, b) == (1000, 1000)  # empty interval past the end

    def test_merge_runs_interval_order_verified(self, tmp_path):
        if not native.available():
            pytest.skip("no native runtime")
        bad = np.zeros(3, dtype=RECORD_DTYPE)
        bad["barcode"] = [5, 3, 7]  # NOT sorted
        run = str(tmp_path / "bad0")
        bad.tofile(run)
        out = str(tmp_path / "o.ibu")
        with open(out, "wb") as f:
            f.truncate(32 + 24 * 3)
        with pytest.raises(OSError):  # EILSEQ from the in-merge check
            native.merge_runs_interval([run], (0, 0, 0), None, out, 32)


class TestFastqGather:
    def test_basic_and_phase(self):
        if not native.available():
            pytest.skip("no native runtime")
        data = b"@a\nACGTACGT\n+\nIIIIIIII\n@b\nTTTTACGT\n+\nIIIIIIII\n"
        rows, consumed, lines, capped, err, _ = native.fastq_gather(
            data, 0, 8
        )
        assert rows.tolist() == [list(b"ACGTACGT"), list(b"TTTTACGT")]
        assert consumed == len(data) and lines == 8 and not capped
        assert err == -1
        # phase offset: with first_lineno=2 the local lines are global
        # 2,3,4,5,... so (global % 4 == 1) selects local line 3 — the
        # first QUAL line — proving the phase rides the global index
        rows2, *_ = native.fastq_gather(data, 2, 8)
        assert rows2.tolist() == [list(b"IIIIIIII"), list(b"IIIIIIII")]

    def test_crlf_and_short_read(self):
        if not native.available():
            pytest.skip("no native runtime")
        data = b"@a\r\nACGT\r\n+\r\nIIII\r\n"
        rows, consumed, lines, capped, err, content = native.fastq_gather(
            data, 0, 4
        )
        assert err == -1 and rows.tolist() == [list(b"ACGT")]
        # short seq line reports its global line + content length
        rows, consumed, lines, capped, err, content = native.fastq_gather(
            b"@a\nAC\n+\nII\n", 100, 4
        )
        assert err == 101 and content == 2

    def test_start_cap(self):
        if not native.available():
            pytest.skip("no native runtime")
        data = b"@a\nAAAA\n+\nIIII\n@b\nCCCC\n+\nIIII\n"
        cap = data.index(b"@b")
        rows, consumed, lines, capped, err, _ = native.fastq_gather(
            data, 0, 4, start_cap=cap
        )
        assert rows.tolist() == [list(b"AAAA")]
        assert capped and lines == 4 and consumed == cap
