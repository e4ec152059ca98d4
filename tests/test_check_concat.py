"""File integrity auditing (check_file) and order-aware concatenation
(concat_files).

Both sit beyond the reference's surface (it validates lazily on read —
``reader.rs:232-237`` — and leaves multi-file assembly to ``Writer::ingest``
convention); correctness here is anchored on constructed corruption and
boundary cases: bit-flipped magic, truncated tails, lying sorted flags,
out-of-range fields, dimension mismatches, compressed inputs, empty files.
"""

import gzip
import subprocess
import sys

import numpy as np
import pytest

from ibu_jax import Header, MmapReader, Writer
from ibu_jax.constructs.record import make_records
from ibu_jax.pipelines import check_file, concat_files


def _write(path, records, bc_len=8, umi_len=6, sorted_flag=False,
           compression=None):
    h = Header.new(bc_len, umi_len)
    if sorted_flag:
        h.set_sorted()
    with Writer.from_path(str(path), h, compression=compression) as w:
        if len(records):
            w.write_batch(records)
    return str(path)


def _sorted_records(lo, hi):
    n = hi - lo
    bc = np.arange(lo, hi, dtype=np.uint64)
    return make_records(bc, bc % np.uint64(7), np.arange(n, dtype=np.uint64))


class TestCheckFile:
    def test_clean_file_ok(self, tmp_path):
        p = _write(tmp_path / "a.ibu", _sorted_records(0, 1000),
                   sorted_flag=True)
        rep = check_file(p)
        assert rep["ok"] and not rep["errors"] and not rep["warnings"]
        assert rep["records"] == 1000
        assert rep["header"]["bc_len"] == 8

    def test_empty_file_ok(self, tmp_path):
        p = _write(tmp_path / "e.ibu", _sorted_records(0, 0))
        rep = check_file(p)
        assert rep["ok"] and rep["records"] == 0

    def test_bad_magic_reported(self, tmp_path):
        p = _write(tmp_path / "m.ibu", _sorted_records(0, 4))
        raw = bytearray(open(p, "rb").read())
        raw[0] ^= 0xFF
        open(p, "wb").write(raw)
        rep = check_file(p)
        assert not rep["ok"]
        assert any("header" in e and "magic" in e.lower()
                   for e in rep["errors"])

    def test_truncated_tail_reported_with_count(self, tmp_path):
        p = _write(tmp_path / "t.ibu", _sorted_records(0, 10))
        raw = open(p, "rb").read()
        open(p, "wb").write(raw[:-5])  # chop mid-record
        rep = check_file(p)
        assert not rep["ok"]
        assert any("stream" in e for e in rep["errors"])
        assert rep["records"] == 9  # whole records before the tear

    def test_lying_sorted_flag_is_error(self, tmp_path):
        recs = _sorted_records(0, 100)[::-1].copy()
        p = _write(tmp_path / "l.ibu", recs, sorted_flag=True)
        rep = check_file(p)
        assert not rep["ok"]
        assert rep["first_order_violation"] == 0
        assert any("order" in e for e in rep["errors"])

    def test_order_violation_across_batches(self, tmp_path):
        # descending pair straddling a buffer refill: carry must catch it
        recs = _sorted_records(0, 64)
        p = _write(tmp_path / "x.ibu", recs, sorted_flag=True)
        rep = check_file(p, buffer_records=32)
        assert rep["ok"]
        recs2 = recs.copy()
        recs2["barcode"][32] = 0  # first record of second batch regresses
        p2 = _write(tmp_path / "x2.ibu", recs2, sorted_flag=True)
        rep2 = check_file(p2, buffer_records=32)
        assert not rep2["ok"] and rep2["first_order_violation"] == 32

    def test_out_of_range_fields_warn_not_fail(self, tmp_path):
        # bc_len=2 → capacity 16; plant barcodes above it
        recs = make_records(
            np.array([3, 200], dtype=np.uint64),
            np.array([1, 2], dtype=np.uint64),
            np.array([0, 1], dtype=np.uint64),
        )
        p = _write(tmp_path / "r.ibu", recs, bc_len=2, umi_len=2)
        rep = check_file(p)
        assert rep["ok"]  # warning only
        assert rep["out_of_range_barcodes"] == 1
        assert rep["warnings"]

    def test_width32_fields_never_flagged(self, tmp_path):
        m = np.uint64(0xFFFFFFFFFFFFFFFF)
        recs = make_records(np.array([m]), np.array([m]),
                            np.array([m]))
        p = _write(tmp_path / "w.ibu", recs, bc_len=32, umi_len=32)
        rep = check_file(p)
        assert rep["ok"] and rep["out_of_range_barcodes"] == 0

    def test_gzip_input_sniffed(self, tmp_path):
        p = _write(tmp_path / "g.ibu.gz", _sorted_records(0, 50),
                   sorted_flag=True, compression="auto")
        assert open(p, "rb").read(2) == b"\x1f\x8b"
        rep = check_file(p)
        assert rep["ok"] and rep["records"] == 50

    def test_torn_gzip_reported_not_raised(self, tmp_path):
        # gzip raises EOFError (not OSError/IbuError) on a truncated
        # member; check_file's contract is collect-every-problem, so the
        # tear must land in the report, never escape as a traceback
        p = _write(tmp_path / "t.ibu.gz", _sorted_records(0, 5000),
                   sorted_flag=True, compression="auto")
        raw = open(p, "rb").read()
        open(p, "wb").write(raw[: len(raw) // 2])
        rep = check_file(p)
        assert not rep["ok"]
        assert any("stream" in e and "Niffler" in e for e in rep["errors"])

    def test_torn_gzip_check_cli_reports_corrupt(self, tmp_path):
        p = _write(tmp_path / "c.ibu.gz", _sorted_records(0, 5000),
                   sorted_flag=True, compression="auto")
        raw = open(p, "rb").read()
        open(p, "wb").write(raw[: len(raw) // 2])
        r = subprocess.run(
            [sys.executable, "-m", "ibu_jax", "check", p],
            capture_output=True, text=True)
        assert r.returncode == 1, r.stderr
        assert "CORRUPT" in r.stdout and "Traceback" not in r.stderr

    def test_torn_zstd_reported_not_raised(self, tmp_path):
        pytest.importorskip("zstandard")
        p = _write(tmp_path / "t.ibu.zst", _sorted_records(0, 5000),
                   sorted_flag=True, compression="auto")
        raw = open(p, "rb").read()
        # mid-frame tear: the frame-tracking decoder must flag it —
        # zstandard's stream_reader would report a clean (silently
        # truncating) EOF here
        open(p, "wb").write(raw[: len(raw) // 2])
        rep = check_file(p)
        assert not rep["ok"]
        assert any("Niffler" in e and "truncated" in e
                   for e in rep["errors"])

    def test_bitflipped_zstd_frame_checksum_caught(self, tmp_path):
        pytest.importorskip("zstandard")
        p = _write(tmp_path / "f.ibu.zst", _sorted_records(0, 5000),
                   sorted_flag=True, compression="auto")
        raw = bytearray(open(p, "rb").read())
        raw[len(raw) // 2] ^= 0x10  # corrupt inside the frame
        open(p, "wb").write(bytes(raw))
        rep = check_file(p)  # content checksum (write_checksum=True)
        assert not rep["ok"] and any("Niffler" in e for e in rep["errors"])

    def test_torn_zstd_repair_salvages_block_prefix(self, tmp_path):
        pytest.importorskip("zstandard")
        from ibu_jax.pipelines import repair_file

        p = _write(tmp_path / "r.ibu.zst", _sorted_records(0, 50_000),
                   sorted_flag=True, compression="auto")
        raw = open(p, "rb").read()
        open(p, "wb").write(raw[: len(raw) // 2])
        out = str(tmp_path / "o.ibu")
        stats = repair_file(p, out)
        # salvage keeps every record up to the last complete zstd block
        assert 0 < stats["records"] < 50_000
        assert any("stream died" in a for a in stats["actions"])
        got = np.asarray(MmapReader(out).slice(0, stats["records"]))
        np.testing.assert_array_equal(
            got["barcode"], np.arange(stats["records"], dtype=np.uint64))

    def test_corrupt_gzip_crc_reported_not_raised(self, tmp_path):
        # bit-flip INSIDE the deflate stream → zlib.error or a CRC
        # EOFError at member end, depending on where the flip lands
        p = _write(tmp_path / "x.ibu.gz", _sorted_records(0, 5000),
                   sorted_flag=True, compression="auto")
        raw = bytearray(open(p, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(p, "wb").write(bytes(raw))
        rep = check_file(p)  # must not raise
        assert not rep["ok"]

    def test_cli_exit_codes(self, tmp_path):
        good = _write(tmp_path / "good.ibu", _sorted_records(0, 5))
        bad = _write(tmp_path / "bad.ibu", _sorted_records(0, 5))
        raw = open(bad, "rb").read()
        open(bad, "wb").write(raw[:-1])
        r = subprocess.run(
            [sys.executable, "-m", "ibu_jax", "check", good, "--json"],
            capture_output=True, text=True)
        assert r.returncode == 0 and '"ok": true' in r.stdout
        r = subprocess.run(
            [sys.executable, "-m", "ibu_jax", "check", bad],
            capture_output=True, text=True)
        assert r.returncode == 1 and "CORRUPT" in r.stdout


class TestConcatFiles:
    def test_sorted_shards_stay_sorted(self, tmp_path):
        a = _write(tmp_path / "a.ibu", _sorted_records(0, 100),
                   sorted_flag=True)
        b = _write(tmp_path / "b.ibu", _sorted_records(100, 250),
                   sorted_flag=True)
        out = str(tmp_path / "out.ibu")
        stats = concat_files([a, b], out)
        assert stats == {"records": 250, "files": 2, "sorted": True}
        r = MmapReader(out)
        assert r.header().sorted() and len(r) == 250
        got = np.asarray(r.slice(0, 250))
        np.testing.assert_array_equal(
            got["barcode"], np.arange(250, dtype=np.uint64))

    def test_split_concat_roundtrip(self, tmp_path):
        from ibu_jax.pipelines import split_file

        src = _write(tmp_path / "src.ibu", _sorted_records(0, 997),
                     sorted_flag=True)
        shards = split_file(src, str(tmp_path / "s{}.ibu"), 4)
        out = str(tmp_path / "rt.ibu")
        concat_files(shards, out)
        assert open(out, "rb").read() == open(src, "rb").read()

    def test_overlapping_sorted_inputs_clear_flag(self, tmp_path):
        a = _write(tmp_path / "a.ibu", _sorted_records(0, 100),
                   sorted_flag=True)
        b = _write(tmp_path / "b.ibu", _sorted_records(50, 150),
                   sorted_flag=True)
        stats = concat_files([a, b], str(tmp_path / "o.ibu"))
        assert stats["sorted"] is False
        assert not MmapReader(str(tmp_path / "o.ibu")).header().sorted()

    def test_unsorted_input_clears_flag(self, tmp_path):
        a = _write(tmp_path / "a.ibu", _sorted_records(0, 10),
                   sorted_flag=True)
        b = _write(tmp_path / "b.ibu", _sorted_records(10, 20))
        stats = concat_files([a, b], str(tmp_path / "o.ibu"))
        assert stats["sorted"] is False

    def test_empty_inputs_skipped_in_boundary_chain(self, tmp_path):
        a = _write(tmp_path / "a.ibu", _sorted_records(0, 10),
                   sorted_flag=True)
        e = _write(tmp_path / "e.ibu", _sorted_records(0, 0),
                   sorted_flag=True)
        b = _write(tmp_path / "b.ibu", _sorted_records(10, 20),
                   sorted_flag=True)
        stats = concat_files([a, e, b], str(tmp_path / "o.ibu"))
        assert stats == {"records": 20, "files": 3, "sorted": True}

    def test_dimension_mismatch_rejected(self, tmp_path):
        a = _write(tmp_path / "a.ibu", _sorted_records(0, 5), bc_len=8)
        b = _write(tmp_path / "b.ibu", _sorted_records(0, 5), bc_len=16)
        with pytest.raises(ValueError, match="dimensions"):
            concat_files([a, b], str(tmp_path / "o.ibu"))

    def test_no_inputs_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="at least one"):
            concat_files([], str(tmp_path / "o.ibu"))

    def test_lying_flag_raises_during_copy(self, tmp_path):
        # boundary records are consistent, but the interior of b regresses
        recs = _sorted_records(100, 200)
        recs["barcode"][50] = 100  # interior dip, first/last unchanged
        a = _write(tmp_path / "a.ibu", _sorted_records(0, 100),
                   sorted_flag=True)
        b = _write(tmp_path / "b.ibu", recs, sorted_flag=True)
        out = tmp_path / "o.ibu"
        with pytest.raises(ValueError, match="sorted order"):
            concat_files([a, b], str(out))
        # the partial output (with a sorted-claiming header downstream
        # tools would trust) must not survive the failed copy
        assert not out.exists()

    def test_gzip_inputs_and_compressed_output(self, tmp_path):
        a = _write(tmp_path / "a.ibu.gz", _sorted_records(0, 40),
                   sorted_flag=True, compression="auto")
        b = _write(tmp_path / "b.ibu", _sorted_records(40, 90),
                   sorted_flag=True)
        out = str(tmp_path / "o.ibu.gz")
        stats = concat_files([a, b], out)
        assert stats["sorted"] is True
        raw = gzip.open(out, "rb").read()
        assert len(raw) == 32 + 24 * 90
        h = Header.from_bytes(raw[:32])
        assert h.sorted()

    def test_cli(self, tmp_path):
        a = _write(tmp_path / "a.ibu", _sorted_records(0, 10),
                   sorted_flag=True)
        b = _write(tmp_path / "b.ibu", _sorted_records(10, 30),
                   sorted_flag=True)
        out = str(tmp_path / "o.ibu")
        r = subprocess.run(
            [sys.executable, "-m", "ibu_jax", "concat", out, a, b],
            capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        assert "30 records (sorted)" in r.stdout
        assert len(MmapReader(out)) == 30


class TestRepairFile:
    def test_truncated_tail_salvaged_including_torn_refill(self, tmp_path):
        from ibu_jax.pipelines import check_file, repair_file

        p = _write(tmp_path / "t.ibu", _sorted_records(0, 10_000),
                   sorted_flag=True)
        raw = open(p, "rb").read()
        open(p, "wb").write(raw[:-13])
        out = str(tmp_path / "fixed.ibu")
        stats = repair_file(p, out)
        # every whole record survives, not just whole refills
        assert stats["records"] == 9999 and stats["dropped_bytes"] == 11
        assert stats["sorted"] is True
        rep = check_file(out)
        assert rep["ok"] and rep["records"] == 9999

    def test_lying_sorted_flag_cleared(self, tmp_path):
        from ibu_jax.pipelines import repair_file

        recs = _sorted_records(0, 100)[::-1].copy()
        p = _write(tmp_path / "l.ibu", recs, sorted_flag=True)
        out = str(tmp_path / "o.ibu")
        stats = repair_file(p, out)
        assert stats["records"] == 100 and stats["sorted"] is False
        assert not MmapReader(out).header().sorted()
        assert any("lying" in a for a in stats["actions"])

    def test_unclaimed_order_flag_set(self, tmp_path):
        from ibu_jax.pipelines import repair_file

        p = _write(tmp_path / "u.ibu", _sorted_records(0, 50))  # no flag
        out = str(tmp_path / "o.ibu")
        stats = repair_file(p, out)
        assert stats["sorted"] is True
        assert MmapReader(out).header().sorted()

    def test_destroyed_header_with_forced_dims(self, tmp_path):
        from ibu_jax.errors import InvalidMagicNumber
        from ibu_jax.pipelines import repair_file

        p = _write(tmp_path / "h.ibu", _sorted_records(0, 20), bc_len=9,
                   umi_len=5, sorted_flag=True)
        raw = bytearray(open(p, "rb").read())
        raw[:32] = b"\xde\xad" * 16  # obliterate the header
        open(p, "wb").write(bytes(raw))
        out = str(tmp_path / "o.ibu")
        with pytest.raises(InvalidMagicNumber):
            repair_file(p, out)
        stats = repair_file(p, out, bc_len=9, umi_len=5)
        assert stats["records"] == 20 and stats["sorted"] is True
        h = MmapReader(out).header()
        assert (h.bc_len, h.umi_len) == (9, 5)
        got = np.asarray(MmapReader(out).slice(0, 20))
        np.testing.assert_array_equal(
            got["barcode"], np.arange(20, dtype=np.uint64))

    def test_forcing_one_dim_rejected(self, tmp_path):
        from ibu_jax.pipelines import repair_file

        p = _write(tmp_path / "x.ibu", _sorted_records(0, 5))
        with pytest.raises(ValueError, match="both"):
            repair_file(p, str(tmp_path / "o.ibu"), bc_len=4)

    def test_tiny_fragment_rejected(self, tmp_path):
        from ibu_jax.errors import IbuError
        from ibu_jax.pipelines import repair_file

        p = tmp_path / "frag.ibu"
        p.write_bytes(b"IBU!\x02\x00")
        with pytest.raises(IbuError, match="nothing to salvage"):
            repair_file(str(p), str(tmp_path / "o.ibu"))

    def test_torn_gzip_stream_salvages_prefix(self, tmp_path):
        from ibu_jax.pipelines import repair_file

        p = _write(tmp_path / "g.ibu.gz", _sorted_records(0, 5000),
                   sorted_flag=True, compression="auto")
        raw = open(p, "rb").read()
        open(p, "wb").write(raw[: len(raw) // 2])  # tear the gzip stream
        out = str(tmp_path / "o.ibu")
        stats = repair_file(p, out, salvage_chunk_bytes=2400)
        assert 0 < stats["records"] < 5000
        assert any("stream died" in a or "partial record" in a
                   for a in stats["actions"])
        got = np.asarray(MmapReader(out).slice(0, stats["records"]))
        np.testing.assert_array_equal(
            got["barcode"],
            np.arange(stats["records"], dtype=np.uint64))

    def test_repair_cli(self, tmp_path):
        p = _write(tmp_path / "t.ibu", _sorted_records(0, 100),
                   sorted_flag=True)
        raw = open(p, "rb").read()
        open(p, "wb").write(raw[:-1])
        out = str(tmp_path / "fixed.ibu")
        r = subprocess.run(
            [sys.executable, "-m", "ibu_jax", "repair", p, out],
            capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        assert "99 records salvaged (sorted, 23 bytes dropped)" in r.stdout
