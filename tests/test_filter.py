"""Barcode allowlist filtering (cell filtering) — pipeline + CLI."""

import numpy as np
import pytest

from ibu_jax import Header, Writer
from ibu_jax.constructs.record import make_records
from ibu_jax.io.mmap import MmapReader
from ibu_jax.ops.codec import np_pack
from ibu_jax.pipelines import filter_file


def _write(path, recs, bc_len=16, sorted_flag=False):
    h = Header.new(bc_len, 12)
    if sorted_flag:
        h.set_sorted()
    with Writer.from_path(str(path), h) as w:
        w.write_batch(recs)


def _recs(bc):
    bc = np.asarray(bc, dtype=np.uint64)
    n = len(bc)
    return make_records(
        bc, np.arange(n, dtype=np.uint64), np.arange(n, dtype=np.uint64)
    )


class TestFilterFile:
    def test_keeps_only_allowlisted_in_order(self, tmp_path):
        rng = np.random.default_rng(0)
        bc = rng.integers(0, 50, 10_000).astype(np.uint64)
        src, dst = tmp_path / "a.ibu", tmp_path / "b.ibu"
        _write(src, _recs(bc))
        allow = [3, 17, 42]
        stats = filter_file(str(src), str(dst), allow, batch_records=333)
        mask = np.isin(bc, allow)
        assert stats == {
            "records": 10_000,
            "kept": int(mask.sum()),
            "allowlist": 3,
        }
        got = np.asarray(MmapReader(str(dst)).records)
        np.testing.assert_array_equal(got, _recs(bc)[mask])

    def test_invert(self, tmp_path):
        bc = np.array([1, 2, 3, 2, 1], dtype=np.uint64)
        src, dst = tmp_path / "i.ibu", tmp_path / "o.ibu"
        _write(src, _recs(bc))
        stats = filter_file(str(src), str(dst), [2], invert=True)
        assert stats["kept"] == 3
        got = np.asarray(MmapReader(str(dst)).records)
        np.testing.assert_array_equal(got["barcode"], [1, 3, 1])

    def test_sorted_flag_and_u64_extremes(self, tmp_path):
        m = 0xFFFFFFFFFFFFFFFF
        bc = np.array([0, 5, m], dtype=np.uint64)
        src, dst = tmp_path / "s.ibu", tmp_path / "t.ibu"
        _write(src, _recs(bc), sorted_flag=True)
        stats = filter_file(str(src), str(dst), [0, m])
        assert stats["kept"] == 2
        out = MmapReader(str(dst))
        assert out.header().sorted()
        np.testing.assert_array_equal(
            np.asarray(out.records)["barcode"], [0, m]
        )

    def test_empty_allowlist_keeps_nothing(self, tmp_path):
        src, dst = tmp_path / "e.ibu", tmp_path / "f.ibu"
        _write(src, _recs([1, 2, 3]))
        assert filter_file(str(src), str(dst), [])["kept"] == 0
        assert MmapReader(str(dst)).len() == 0
        # inverted empty list keeps everything
        assert filter_file(str(src), str(dst), [], invert=True)["kept"] == 3


class TestFilterCLI:
    def test_sequence_and_integer_allowlist(self, tmp_path, capsys):
        seqs = ["ACGTACGTACGTACGT", "TTTTACGTACGTACGT", "GGGGACGTACGTACGT"]
        rows = np.frombuffer("".join(seqs).encode(), np.uint8).reshape(3, 16)
        packed = np_pack(rows)
        bc = np.concatenate([packed, [np.uint64(12345)]])
        src, dst = tmp_path / "c.ibu", tmp_path / "d.ibu"
        _write(src, _recs(bc))
        listing = tmp_path / "allow.txt"
        listing.write_text(
            f"# comment\n{seqs[0]}\n{seqs[2].lower()}\n12345\n"
        )
        from ibu_jax.__main__ import main

        rc = main(
            ["filter", str(src), str(dst), "--barcodes", str(listing)]
        )
        assert rc == 0
        assert "kept 3 of 4" in capsys.readouterr().out
        got = np.asarray(MmapReader(str(dst)).records)["barcode"]
        np.testing.assert_array_equal(
            got, [packed[0], packed[2], np.uint64(12345)]
        )

    def test_wrong_length_sequence_rejected(self, tmp_path):
        src, dst = tmp_path / "w.ibu", tmp_path / "x.ibu"
        _write(src, _recs([1]))
        listing = tmp_path / "bad.txt"
        listing.write_text("ACGT\n")  # length 4, file bc_len 16
        from ibu_jax.__main__ import main

        with pytest.raises(SystemExit, match="length 4"):
            main(["filter", str(src), str(dst), "--barcodes", str(listing)])
