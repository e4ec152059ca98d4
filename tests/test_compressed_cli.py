"""Every tool either streams compressed inputs or refuses clearly.

The failure mode being locked out: gzip/zstd magic parsed as an IBU
header yields a misleading InvalidMagicNumber (or worse, InvalidMapSize
from a byte-length check). Streaming tools must produce output identical
to the plain-file run; mmap-bound tools must name themselves and point
at decompression.
"""

import numpy as np
import pytest

from ibu_jax import Header, Writer
from ibu_jax.constructs.record import make_records
from ibu_jax.__main__ import main


@pytest.fixture
def gz_pair(tmp_path):
    """(plain_path, gz_path) with the same 5000 records, sorted flag."""
    import gzip

    rng = np.random.default_rng(31)
    recs = np.sort(
        make_records(
            rng.integers(0, 50, 5000).astype(np.uint64),
            rng.integers(0, 9, 5000).astype(np.uint64),
            rng.integers(0, 1 << 20, 5000).astype(np.uint64),
        ),
        order=("barcode", "umi", "index"),
    )
    h = Header.new(16, 12)
    h.set_sorted()
    plain = tmp_path / "a.ibu"
    with Writer.from_path(str(plain), h) as w:
        w.write_batch(recs)
    gzp = tmp_path / "a.ibu.gz"
    gzp.write_bytes(gzip.compress(plain.read_bytes()))
    return str(plain), str(gzp)


class TestStreamsCompressed:
    def test_histogram_matches_plain(self, gz_pair, capsys):
        plain, gzp = gz_pair
        assert main(["histogram", plain, "--top", "5"]) == 0
        want = capsys.readouterr().out
        assert main(["histogram", gzp, "--top", "5"]) == 0
        assert capsys.readouterr().out == want

    def test_stats_matches_plain(self, gz_pair, capsys):
        plain, gzp = gz_pair
        assert main(["stats", plain]) == 0
        want = capsys.readouterr().out
        assert main(["stats", gzp]) == 0
        assert capsys.readouterr().out == want

    def test_export_fastq_byte_identical(self, gz_pair, tmp_path):
        plain, gzp = gz_pair
        a, b = tmp_path / "a.fastq", tmp_path / "b.fastq"
        assert main(["export-fastq", plain, str(a)]) == 0
        assert main(["export-fastq", gzp, str(b)]) == 0
        assert a.read_bytes() == b.read_bytes()


class TestRefusesClearly:
    @pytest.mark.parametrize(
        "argv, tool",
        [
            (["sort", "{gz}", "{out}"], "sort"),
            (["sort", "{gz}", "{out}", "--engine", "device"], "sort"),
            (["split", "{gz}", "{shard}", "2"], "split"),
            (["stats", "{gz}", "--engine", "native"], "native engine"),
            (["lookup", "{gz}", "AAAAAAAAAAAAAAAA"], "lookup"),
            (["cells", "{gz}", "-o", "{out}"], "cells"),
        ],
    )
    def test_clear_error_names_tool(self, gz_pair, tmp_path, capsys,
                                    argv, tool):
        _, gzp = gz_pair
        argv = [
            a.format(gz=gzp, out=str(tmp_path / "o.ibu"),
                     shard=str(tmp_path / "s{}.ibu"))
            for a in argv
        ]
        rc = main(argv)
        assert rc == 1
        err = capsys.readouterr().err
        assert "gzip-compressed" in err and tool in err
        assert "magic" not in err.lower()

    def test_missing_file_is_one_line_error(self, tmp_path, capsys):
        # FileNotFoundError from the sniff open() must not traceback
        for argv in (["stats", str(tmp_path / "nope.ibu")],
                     ["histogram", str(tmp_path / "nope.ibu")],
                     ["sort", str(tmp_path / "nope.ibu"), "x.ibu"]):
            assert main(argv) == 1
            err = capsys.readouterr().err
            assert err.startswith("error:") and "nope.ibu" in err
