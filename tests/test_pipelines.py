"""End-to-end pipeline tests (sequences ↔ sorted IBU files)."""

import numpy as np
import pytest

from ibu_jax import MmapReader, sort_records
from ibu_jax.ops import codec as C
from ibu_jax.pipelines import (
    decode_batch,
    decode_file,
    encode_batch,
    encode_sorted_file,
    sort_batch,
)


def random_seqs(n, L, seed=0):
    rng = np.random.default_rng(seed)
    return np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, (n, L))]


class TestBatchPipelines:
    def test_encode_decode_roundtrip(self):
        bc = random_seqs(1000, 16, 1)
        umi = random_seqs(1000, 12, 2)
        idx = np.arange(1000, dtype=np.uint64) * np.uint64(3)
        records = encode_batch(bc, umi, idx)
        assert np.array_equal(records["barcode"], C.np_pack(bc))
        bc2, umi2, idx2 = decode_batch(records, 16, 12)
        assert np.array_equal(bc2, bc)
        assert np.array_equal(umi2, umi)
        assert np.array_equal(idx2, idx)

    def test_sort_batch_matches_host(self):
        bc = random_seqs(500, 8, 3)
        umi = random_seqs(500, 8, 4)
        records = encode_batch(bc, umi, np.arange(500, dtype=np.uint64))
        assert np.array_equal(sort_batch(records), sort_records(records))

    def test_decode_tsv_block_matches_format_oracle(self):
        # the vectorized TSV assembler vs the per-record f-string it
        # replaced, across variable index widths incl. 0 and u64 max
        from ibu_jax.pipelines import decode_tsv_block

        bc = random_seqs(7, 16, 5)
        umi = random_seqs(7, 12, 6)
        idx = np.array(
            [0, 1, 9, 10, 12345, 10**19, 2**64 - 1], dtype=np.uint64
        )
        got = decode_tsv_block(bc, umi, idx)
        want = "".join(
            f"{b.tobytes().decode()}\t{u.tobytes().decode()}\t{int(i)}\n"
            for b, u, i in zip(bc, umi, idx)
        ).encode()
        assert got == want
        assert decode_tsv_block(bc[:0], umi[:0], idx[:0]) == b""


class TestFilePipelines:
    def test_encode_sorted_file_roundtrip(self, tmp_path):
        path = str(tmp_path / "p.ibu")
        bc_seqs = ["ACGTACGTACGTACGT", "TTTTGGGGCCCCAAAA", "acgtacgtacgtacgt"]
        umi_seqs = ["AACCGGTTAACC", "TTGGCCAATTGG", "ACACACACACAC"]
        header = encode_sorted_file(path, bc_seqs, umi_seqs)
        assert header.sorted()
        reader = MmapReader(path)
        assert reader.len() == 3
        assert bool(np.all(np.diff(reader.barcodes().astype(np.uint64)) >= 0))

        h2, bc2, umi2, idx2 = decode_file(path, as_strings=True)
        assert (h2.bc_len, h2.umi_len) == (16, 12)
        assert set(bc2) == {s.upper() for s in bc_seqs}
        assert sorted(idx2.tolist()) == [0, 1, 2]

    def test_validation(self, tmp_path):
        with pytest.raises(ValueError, match="invalid nucleotide"):
            encode_sorted_file(str(tmp_path / "x.ibu"), ["ACGN"], ["ACGT"])
        with pytest.raises(ValueError, match="barcodes but"):
            encode_sorted_file(str(tmp_path / "x.ibu"), ["ACGT"], ["AC", "GT"])

    def test_array_input(self, tmp_path):
        path = str(tmp_path / "a.ibu")
        bc = random_seqs(200, 10, 5)
        umi = random_seqs(200, 6, 6)
        encode_sorted_file(path, bc, umi)
        header, bc2, umi2, idx = decode_file(path)
        assert (header.bc_len, header.umi_len) == (10, 6)
        # decoded rows are a permutation of the inputs (sorted by barcode)
        assert sorted(map(bytes, bc2)) == sorted(map(bytes, bc))


class TestFastqExport:
    def _make_file(self, tmp_path, n=500, bc_len=16, umi_len=12):
        bc = random_seqs(n, bc_len, 3)
        umi = random_seqs(n, umi_len, 4)
        idx = np.arange(n, dtype=np.uint64) * np.uint64(7)
        path = str(tmp_path / "x.ibu")
        from ibu_jax.constructs.header import Header
        from ibu_jax.io.writer import Writer

        with Writer.from_path(path, Header.new(bc_len, umi_len)) as w:
            w.write_batch(encode_batch(bc, umi, idx))
        return path, bc, umi, idx

    def test_export_matches_decoded_sequences(self, tmp_path):
        from ibu_jax.pipelines import export_fastq

        path, bc, umi, idx = self._make_file(tmp_path)
        out = str(tmp_path / "x.fastq")
        n = export_fastq(path, out)
        assert n == len(bc)
        lines = open(out, "rb").read().splitlines()
        assert len(lines) == 4 * n
        names = lines[0::4]
        seqs = lines[1::4]
        quals = lines[3::4]
        for k in (0, 1, n - 1):
            assert names[k] == b"@r" + str(int(idx[k])).encode().rjust(20, b"0")
            assert seqs[k] == bytes(bc[k]) + bytes(umi[k])
            assert quals[k] == b"I" * (bc.shape[1] + umi.shape[1])
        assert all(lines[2::4][k] == b"+" for k in range(n))

    def test_export_ingest_roundtrip(self, tmp_path):
        """ingest(export(f)) recovers the exact barcode/UMI content."""
        from ibu_jax.pipelines import export_fastq

        path, bc, umi, _ = self._make_file(tmp_path, n=300)
        out = str(tmp_path / "x.fastq")
        export_fastq(path, out, batch_records=128)  # multiple batches
        import importlib.util as iu

        spec = iu.spec_from_file_location(
            "fastq_ingest_mod", "examples/fastq_ingest.py"
        )
        mod = iu.module_from_spec(spec)
        spec.loader.exec_module(mod)
        prefixes = np.concatenate(
            list(mod.fastq_prefixes(out, bc.shape[1] + umi.shape[1]))
        )
        assert np.array_equal(prefixes[:, : bc.shape[1]], bc)
        assert np.array_equal(prefixes[:, bc.shape[1] :], umi)

    def test_export_gzip(self, tmp_path):
        import gzip

        from ibu_jax.pipelines import export_fastq

        path, bc, umi, _ = self._make_file(tmp_path, n=100)
        out = str(tmp_path / "x.fastq.gz")
        export_fastq(path, out)
        lines = gzip.decompress(open(out, "rb").read()).splitlines()
        assert len(lines) == 400
        assert lines[1] == bytes(bc[0]) + bytes(umi[0])

    def test_export_u64_max_index_name(self, tmp_path):
        from ibu_jax.constructs.header import Header
        from ibu_jax.constructs.record import make_records
        from ibu_jax.io.writer import Writer
        from ibu_jax.pipelines import export_fastq

        path = str(tmp_path / "m.ibu")
        big = np.uint64(0xFFFFFFFFFFFFFFFF)
        with Writer.from_path(path, Header.new(4, 4)) as w:
            w.write_batch(
                make_records(
                    np.array([0], np.uint64), np.array([0], np.uint64),
                    np.array([big], np.uint64),
                )
            )
        out = str(tmp_path / "m.fastq")
        export_fastq(path, out)
        name = open(out, "rb").read().splitlines()[0]
        assert name == b"@r18446744073709551615"


class TestSortFileDevice:
    def test_sorted_rewrite(self, tmp_path):
        from ibu_jax.constructs.header import Header
        from ibu_jax.io.mmap import MmapReader
        from ibu_jax.io.writer import Writer
        from ibu_jax.constructs.record import make_records
        from ibu_jax.pipelines import sort_file_device

        rng = np.random.default_rng(60)
        n = 20_000
        records = make_records(
            rng.integers(0, 1 << 32, n, dtype=np.uint64),
            rng.integers(0, 1 << 24, n, dtype=np.uint64),
            rng.permutation(n).astype(np.uint64),
        )
        src_path = str(tmp_path / "u.ibu")
        dst = str(tmp_path / "s.ibu")
        with Writer.from_path(src_path, Header.new(16, 12)) as w:
            w.write_batch(records)
        h = sort_file_device(src_path, dst)
        assert h.sorted()
        r = MmapReader(dst)
        assert r.header().sorted()
        got = np.asarray(r.records)
        want = np.sort(records, order=("barcode", "umi", "index"))
        assert np.array_equal(got, want)

    def test_big_index_falls_back_to_full_sort(self, tmp_path):
        from ibu_jax.constructs.header import Header
        from ibu_jax.io.mmap import MmapReader
        from ibu_jax.io.writer import Writer
        from ibu_jax.constructs.record import make_records
        from ibu_jax.pipelines import sort_file_device

        rng = np.random.default_rng(61)
        n = 5000
        records = make_records(
            rng.integers(0, 1 << 20, n, dtype=np.uint64),
            rng.integers(0, 1 << 20, n, dtype=np.uint64),
            rng.integers(0, 1 << 63, n, dtype=np.uint64),  # idx_hi nonzero
        )
        src_path = str(tmp_path / "u.ibu")
        dst = str(tmp_path / "s.ibu")
        with Writer.from_path(src_path, Header.new(16, 12)) as w:
            w.write_batch(records)
        sort_file_device(src_path, dst)
        got = np.asarray(MmapReader(dst).records)
        want = np.sort(records, order=("barcode", "umi", "index"))
        assert np.array_equal(got, want)

    def test_header_violating_file_raises_not_mangles(self, tmp_path):
        """A file whose records contradict its own header (hi bits set
        past bc_len=16) must raise — not silently zero those bits."""
        from ibu_jax.constructs.header import Header
        from ibu_jax.io.writer import Writer
        from ibu_jax.constructs.record import make_records
        from ibu_jax.pipelines import sort_file_device

        records = make_records(
            np.array([1 << 40, 7], dtype=np.uint64),  # bc needs >16 bases
            np.array([1, 2], dtype=np.uint64),
            np.array([0, 1], dtype=np.uint64),
        )
        src_path = str(tmp_path / "bad.ibu")
        with Writer.from_path(src_path, Header.new(16, 12)) as w:
            w.write_batch(records)  # writers don't validate (parity quirk)
        with pytest.raises(ValueError, match="barcode hi"):
            sort_file_device(src_path, str(tmp_path / "out.ibu"))


class TestExportFastqGuards:
    def test_bad_qual_rejected(self, tmp_path):
        from ibu_jax.pipelines import export_fastq

        # non-printable / framing-corrupting quals must be rejected too:
        # a '\n' qual would emit 5-line records, ' ' and '\x00' are outside
        # the Phred+33 range (ADVICE r1)
        for bad in ("", "II", "你", "\n", " ", "\x00", "\x7f"):
            with pytest.raises(ValueError, match="Phred"):
                export_fastq("x.ibu", str(tmp_path / "x.fastq"), qual=bad)

    def test_qual_range_edges_accepted(self, tmp_path):
        from ibu_jax.constructs.header import Header
        from ibu_jax.io.writer import Writer
        from ibu_jax.pipelines import encode_batch, export_fastq

        bc = random_seqs(4, 16, 70)
        umi = random_seqs(4, 12, 71)
        path = str(tmp_path / "q.ibu")
        with Writer.from_path(path, Header.new(16, 12)) as w:
            w.write_batch(encode_batch(bc, umi, np.arange(4, dtype=np.uint64)))
        for ok in ("!", "~", "@"):  # '@' is fine as a QUAL char (line 4)
            out = str(tmp_path / f"q{ord(ok)}.fastq")
            export_fastq(path, out, qual=ok)
            lines = open(out, "rb").read().splitlines()
            assert len(lines) == 16 and lines[3] == ok.encode() * 28

    def test_zst_output(self, tmp_path):
        pytest.importorskip("zstandard")
        import zstandard

        from ibu_jax.constructs.header import Header
        from ibu_jax.io.writer import Writer
        from ibu_jax.pipelines import encode_batch, export_fastq

        bc = random_seqs(50, 16, 7)
        umi = random_seqs(50, 12, 8)
        path = str(tmp_path / "z.ibu")
        with Writer.from_path(path, Header.new(16, 12)) as w:
            w.write_batch(encode_batch(bc, umi, np.arange(50, dtype=np.uint64)))
        out = str(tmp_path / "z.fastq.zst")
        export_fastq(path, out)
        raw = open(out, "rb").read()
        assert raw[:4] == b"\x28\xb5\x2f\xfd"
        lines = zstandard.ZstdDecompressor().decompress(
            raw, max_output_size=1 << 20
        ).splitlines()
        assert len(lines) == 200 and lines[1] == bytes(bc[0]) + bytes(umi[0])


class TestSplitFile:
    def test_split_matches_partition_rule_and_merge_roundtrips(self, tmp_path):
        from ibu_jax.constructs.header import Header
        from ibu_jax.io.mmap import MmapReader
        from ibu_jax.io.writer import Writer
        from ibu_jax.constructs.record import make_records
        from ibu_jax.parallel.host import partition
        from ibu_jax.pipelines import split_file

        rng = np.random.default_rng(80)
        n = 10_003  # remainder exercises remainder-to-last
        records = np.sort(
            make_records(
                rng.integers(0, 1 << 40, n, dtype=np.uint64),
                rng.integers(0, 1 << 40, n, dtype=np.uint64),
                rng.integers(0, 1 << 40, n, dtype=np.uint64),
            ),
            order=("barcode", "umi", "index"),
        )
        h = Header.new(16, 12)
        h.set_sorted()
        src_path = str(tmp_path / "whole.ibu")
        with Writer.from_path(src_path, h) as w:
            w.write_batch(records)

        paths = split_file(src_path, str(tmp_path / "sh{}.ibu"), 4)
        assert len(paths) == 4
        bounds = partition(n, 4)
        for p, (start, end) in zip(paths, bounds):
            r = MmapReader(p)
            assert r.header().sorted()
            assert len(r) == end - start
            assert np.array_equal(np.asarray(r.records), records[start:end])

        # split -> merge roundtrips byte-exactly
        from ibu_jax import native

        if native.available():
            merged = str(tmp_path / "merged.ibu")
            native.merge_files(paths, merged)
            assert (
                open(merged, "rb").read() == open(src_path, "rb").read()
            )

    def test_bad_template_rejected(self, tmp_path):
        from ibu_jax.pipelines import split_file

        with pytest.raises(ValueError, match="template"):
            split_file("x.ibu", str(tmp_path / "same.ibu"), 2)

    def test_more_shards_than_records(self, tmp_path):
        from ibu_jax.constructs.header import Header
        from ibu_jax.io.mmap import MmapReader
        from ibu_jax.io.writer import Writer
        from ibu_jax.constructs.record import make_records
        from ibu_jax.pipelines import split_file

        src_path = str(tmp_path / "tiny.ibu")
        with Writer.from_path(src_path, Header.new(16, 12)) as w:
            w.write_batch(make_records(
                np.arange(2, dtype=np.uint64),
                np.zeros(2, dtype=np.uint64),
                np.zeros(2, dtype=np.uint64),
            ))
        paths = split_file(src_path, str(tmp_path / "t{}.ibu"), 5)
        sizes = [len(MmapReader(p)) for p in paths]
        assert sum(sizes) == 2 and len(sizes) == 5


class TestIngestFastq:
    def test_export_then_ingest_is_identity(self, tmp_path):
        """ingest(export(sorted_file)) == sorted_file byte-for-byte:
        export names reads by index, ingest re-derives arange indices,
        and the sort restores the exact record set."""
        from ibu_jax.constructs.header import Header
        from ibu_jax.io.writer import Writer
        from ibu_jax.pipelines import (
            encode_batch,
            export_fastq,
            ingest_fastq,
            sort_batch,
        )

        bc = random_seqs(2000, 16, 90)
        umi = random_seqs(2000, 12, 91)
        recs = sort_batch(
            encode_batch(bc, umi, np.arange(2000, dtype=np.uint64)),
            bc_len=16, umi_len=12, index_bits=32,
        )
        h = Header.new(16, 12)
        h.set_sorted()
        src_path = str(tmp_path / "a.ibu")
        with Writer.from_path(src_path, h) as w:
            w.write_batch(recs)

        fq = str(tmp_path / "a.fastq")
        export_fastq(src_path, fq)
        out = str(tmp_path / "b.ibu")
        n = ingest_fastq(fq, out, 16, 12, batch=777)
        assert n == 2000
        # records match except the index column (export's read order IS
        # sorted order, so ingest's arange re-derives the same ranks —
        # but the original indices were a permutation; compare bc/umi)
        from ibu_jax.io.mmap import MmapReader

        got = np.asarray(MmapReader(out).records)
        assert np.array_equal(got["barcode"], recs["barcode"])
        assert np.array_equal(got["umi"], recs["umi"])
        assert np.array_equal(got["index"], np.arange(2000, dtype=np.uint64))

    def test_empty_fastq(self, tmp_path):
        from ibu_jax.io.mmap import MmapReader
        from ibu_jax.pipelines import ingest_fastq

        fq = tmp_path / "e.fastq"
        fq.write_bytes(b"")
        out = str(tmp_path / "e.ibu")
        assert ingest_fastq(str(fq), out, 16, 12) == 0
        r = MmapReader(out)
        assert len(r) == 0 and r.header().sorted()

    def test_short_read_raises(self, tmp_path):
        from ibu_jax.pipelines import ingest_fastq

        fq = tmp_path / "s.fastq"
        fq.write_bytes(b"@r0\nACGT\n+\nIIII\n")
        with pytest.raises(ValueError, match="shorter than"):
            ingest_fastq(str(fq), str(tmp_path / "s.ibu"), 16, 12)

    def test_parser_chunk_boundaries_crlf_and_no_final_newline(self, tmp_path):
        """The vectorized parser must be exact when lines straddle chunk
        boundaries (tiny chunk_bytes forces a carry on nearly every read),
        under CRLF endings, and when the last line has no newline."""
        from ibu_jax.pipelines import fastq_prefix_batches

        rng = np.random.default_rng(5)
        alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
        seqs = [bytes(rng.choice(alphabet, 28)) for _ in range(503)]
        fq = tmp_path / "b.fastq"
        body = b"".join(
            b"@read%d\r\n%s\r\n+\r\n%s\r\n" % (i, s, b"I" * 28)
            for i, s in enumerate(seqs)
        )
        fq.write_bytes(body[:-2])  # drop the final \r\n entirely
        got = np.concatenate(
            list(fastq_prefix_batches(str(fq), 28, batch=100, chunk_bytes=37))
        )
        want = np.frombuffer(b"".join(seqs), dtype=np.uint8).reshape(-1, 28)
        assert np.array_equal(got, want)
        # batch sizes are exact (100) with one remainder
        sizes = [
            len(b)
            for b in fastq_prefix_batches(str(fq), 28, batch=100,
                                          chunk_bytes=37)
        ]
        assert sizes == [100] * 5 + [3]

    def test_short_read_error_reports_physical_line(self, tmp_path):
        """The 1-based line number in the short-read error must survive
        chunked parsing (read #2's sequence is physical line 6)."""
        from ibu_jax.pipelines import fastq_prefix_batches

        fq = tmp_path / "ln.fastq"
        seq = b"ACGTACGTACGTACGTACGTACGTACGT"
        fq.write_bytes(
            b"@r0\n%s\n+\n%s\n@r1\nACG\n+\nIII\n" % (seq, b"I" * 28)
        )
        with pytest.raises(ValueError, match="line 6 is 3 bases"):
            list(fastq_prefix_batches(str(fq), 28, chunk_bytes=11))

    def test_gzip_fastq_without_gz_suffix(self, tmp_path):
        """Compression is sniffed by magic bytes, not extension (ADVICE r1):
        a gzipped FASTQ named '.fastq' must ingest identically."""
        import gzip

        from ibu_jax.io.mmap import MmapReader
        from ibu_jax.pipelines import ingest_fastq

        seq = b"ACGTACGTACGTACGTACGTACGTACGT"  # 16 + 12
        fastq = b"".join(
            b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)) for i in range(64)
        )
        plain = tmp_path / "p.fastq"
        plain.write_bytes(fastq)
        sneaky = tmp_path / "sneaky.fastq"  # gzip bytes, no .gz suffix
        sneaky.write_bytes(gzip.compress(fastq))

        out_a, out_b = str(tmp_path / "a.ibu"), str(tmp_path / "b.ibu")
        assert ingest_fastq(str(plain), out_a, 16, 12) == 64
        assert ingest_fastq(str(sneaky), out_b, 16, 12) == 64
        assert np.array_equal(
            np.asarray(MmapReader(out_a).records),
            np.asarray(MmapReader(out_b).records),
        )

    @pytest.mark.parametrize("force_fallback", [False, True])
    def test_compressed_output_path(self, tmp_path, monkeypatch, force_fallback):
        """A .gz output path yields gzip output on BOTH the out-of-core
        (native sort + recompress) and in-memory fallback paths (ADVICE r1)."""
        from ibu_jax import native
        from ibu_jax.io.reader import Reader
        from ibu_jax.pipelines import ingest_fastq

        if force_fallback:
            monkeypatch.setattr(native, "available", lambda: False)
        elif not native.available():
            pytest.skip("native runtime unavailable")

        seq = b"TTGCACGTAAGTCCGGAAGTCCGGTTGA"
        fastq = b"".join(
            b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)) for i in range(10)
        )
        fq = tmp_path / "c.fastq"
        fq.write_bytes(fastq)
        out = str(tmp_path / "c.ibu.gz")
        assert ingest_fastq(str(fq), out, 16, 12) == 10
        assert open(out, "rb").read(2) == b"\x1f\x8b"  # really gzip
        r = Reader.from_path(out)
        assert r.header().sorted()
        assert sum(len(b) for b in r.batches()) == 10


class TestParserEmptySiblingLines:
    def test_empty_qual_and_name_lines_parse(self, tmp_path):
        """FASTQ records whose name/plus/qual lines are EMPTY are legal
        input to the prefix parser; the native gather's row bound must
        accommodate them (review r5: the prefix_len+7 bound returned
        ENOMEM where the numpy path parsed fine)."""
        from ibu_jax.pipelines import fastq_prefix_batches

        n = 5000
        seq = b"A" * 16
        fq = tmp_path / "empty_qual.fastq"
        fq.write_bytes(b"".join(b"@\n%s\n+\n\n" % seq for _ in range(n)))
        rows = np.concatenate(
            list(fastq_prefix_batches(str(fq), 16, batch=1024))
        )
        assert rows.shape == (n, 16)
        assert (rows == ord("A")).all()
