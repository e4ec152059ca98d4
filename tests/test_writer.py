"""Writer tests — parity with the reference suite (``writer.rs:629-877``)."""

import io

import numpy as np
import pytest

from ibu_jax import HEADER_SIZE, RECORD_SIZE, Header, Reader, Record, Writer
from ibu_jax.constructs.record import make_records
from ibu_jax.io.writer import DEFAULT_BUFFER_SIZE


def recs(n, base=0):
    i = np.arange(base, base + n, dtype=np.uint64)
    return make_records(i, i * np.uint64(2), i * np.uint64(3))


class TestHeaderEmission:
    def test_header_written_immediately(self):
        w = Writer.in_memory(Header.new(16, 12))
        w.finish()
        data = w.inner.getvalue()
        assert len(data) == HEADER_SIZE
        assert data[:4] == b"IBU!"

    def test_headless_writes_no_header(self):
        w = Writer.in_memory()
        w.write_record(Record(1, 2, 3))
        w.finish()
        assert len(w.inner.getvalue()) == RECORD_SIZE

    def test_invalid_header_still_writes(self):
        """Parity quirk: Writer does NOT validate (writer.rs:129-143 never
        calls validate; doc/code discrepancy noted in SURVEY.md §4)."""
        bad = Header(magic=0, version=0, bc_len=0, umi_len=0)
        w = Writer.in_memory(bad)
        w.finish()
        assert len(w.inner.getvalue()) == HEADER_SIZE


class TestWritePaths:
    def test_single_record_bytes(self):
        w = Writer.in_memory(Header.new(16, 12))
        w.write_record(Record(1, 2, 3))
        w.finish()
        data = w.inner.getvalue()
        assert len(data) == HEADER_SIZE + RECORD_SIZE
        assert data[HEADER_SIZE:] == Record(1, 2, 3).as_bytes()

    def test_write_batch_numpy(self):
        w = Writer.in_memory(Header.new(16, 12))
        w.write_batch(recs(100))
        w.finish()
        assert len(w.inner.getvalue()) == HEADER_SIZE + 100 * RECORD_SIZE
        assert w.records_written == 100

    def test_write_batch_record_list(self):
        w = Writer.in_memory(Header.new(16, 12))
        w.write_batch([Record(1, 2, 3), Record(4, 5, 6)])
        w.finish()
        assert w.records_written == 2
        assert len(w.inner.getvalue()) == HEADER_SIZE + 2 * RECORD_SIZE

    def test_write_iter(self):
        w = Writer.in_memory(Header.new(16, 12))
        w.write_iter(Record(i, i * 2, i * 3) for i in range(100))
        w.finish()
        assert w.records_written == 100

    def test_large_batch_direct_path(self):
        """Batches over the internal buffer bypass it (writer.rs:325-331)."""
        n = DEFAULT_BUFFER_SIZE // RECORD_SIZE + 1000
        w = Writer.in_memory(Header.new(16, 12))
        w.write_batch(recs(n))
        # direct path writes through without waiting for finish()
        assert len(w.inner.getvalue()) == HEADER_SIZE + n * RECORD_SIZE
        w.finish()
        assert w.records_written == n

    def test_buffer_flush_threshold(self):
        """Data below the buffer size stays buffered until finish
        (writer.rs:766-787)."""
        w = Writer.in_memory(Header.new(16, 12))
        w.write_batch(recs(10))
        assert len(w.inner.getvalue()) == HEADER_SIZE  # only header so far
        w.finish()
        assert len(w.inner.getvalue()) == HEADER_SIZE + 10 * RECORD_SIZE

    def test_empty_batch(self):
        w = Writer.in_memory(Header.new(16, 12))
        w.write_batch(recs(0))
        w.finish()
        assert w.records_written == 0
        assert len(w.inner.getvalue()) == HEADER_SIZE

    def test_mixed_methods_roundtrip(self):
        w = Writer.in_memory(Header.new(16, 12))
        w.write_record(Record(0, 0, 0))
        w.write_batch(recs(5, base=1))
        w.write_iter(iter([Record(6, 12, 18)]))
        w.finish()
        r = Reader(io.BytesIO(w.inner.getvalue()))
        got = list(r)
        assert len(got) == 7
        assert got[6] == Record(6, 12, 18)

    def test_wrong_dtype_rejected(self):
        w = Writer.in_memory(Header.new(16, 12))
        with pytest.raises(ValueError):
            w.write_batch(np.zeros(4, dtype=np.uint64))


class TestIngest:
    def test_ingest_merges_and_clears(self):
        """Shard-merge primitive (writer.rs:721-741)."""
        main = Writer.in_memory(Header.new(16, 12))
        aux = Writer.in_memory()  # headless
        aux.write_record(Record(1, 2, 3))
        aux.write_record(Record(4, 5, 6))
        main.ingest(aux)
        assert main.records_written == 2
        assert aux.inner.getvalue() == b""  # source cleared
        main.finish()
        assert len(main.inner.getvalue()) == HEADER_SIZE + 2 * RECORD_SIZE

    def test_ingest_shard_and_merge_ordering(self):
        main = Writer.in_memory(Header.new(16, 12))
        shards = []
        for s in range(3):
            aux = Writer.in_memory()
            aux.write_batch(recs(10, base=s * 10))
            shards.append(aux)
        for aux in shards:
            main.ingest(aux)
        main.finish()
        r = Reader(io.BytesIO(main.inner.getvalue()))
        got = [rec.barcode for rec in r]
        assert got == list(range(30))


class TestCounters:
    def test_records_written_accounting(self):
        w = Writer.in_memory(Header.new(16, 12))
        assert w.records_written == 0
        w.write_record(Record(1, 2, 3))
        assert w.records_written == 1
        w.write_batch(recs(2))
        assert w.records_written == 3


class TestTeardown:
    def test_finish_idempotent_through_context(self):
        buf = io.BytesIO()
        with Writer(buf, Header.new(16, 12)) as w:
            w.write_record(Record(1, 2, 3))
        assert len(buf.getvalue()) == HEADER_SIZE + RECORD_SIZE

    def test_del_flushes(self):
        """Drop safety net (writer.rs:519-523)."""
        buf = io.BytesIO()
        w = Writer(buf, Header.new(16, 12))
        w.write_record(Record(1, 2, 3))
        del w
        assert len(buf.getvalue()) == HEADER_SIZE + RECORD_SIZE

    def test_into_inner(self):
        w = Writer.in_memory(Header.new(16, 12))
        w.write_record(Record(1, 2, 3))
        w.finish()
        inner = w.into_inner()
        assert isinstance(inner, io.BytesIO)


class TestGoldenBytes:
    """Byte-exactness anchors: whole-file bytes built by hand."""

    def test_full_file_bytes(self):
        h = Header.new(16, 12)
        h.set_sorted()
        w = Writer.in_memory(h)
        w.write_batch([Record(0x0102, 0x0304, 0x0506)])
        w.finish()
        want = (
            b"IBU!"
            + (2).to_bytes(4, "little")
            + (16).to_bytes(4, "little")
            + (12).to_bytes(4, "little")
            + (1).to_bytes(8, "little")
            + b"\x00" * 8
            + (0x0102).to_bytes(8, "little")
            + (0x0304).to_bytes(8, "little")
            + (0x0506).to_bytes(8, "little")
        )
        assert w.inner.getvalue() == want


class TestIngestGuards:
    def test_ingest_headered_source_rejected(self):
        main = Writer.in_memory(Header.new(16, 12))
        bad_src = Writer.in_memory(Header.new(16, 12))  # headered!
        bad_src.write_record(Record(1, 2, 3))
        with pytest.raises(ValueError, match="headless"):
            main.ingest(bad_src)

    def test_tiny_buffer_still_progresses(self):
        w = Writer(io.BytesIO(), Header.new(16, 12), buffer_size=1)
        for i in range(10):
            w.write_record(Record(i, i, i))
        w.finish()
        assert len(w.inner.getvalue()) == HEADER_SIZE + 10 * RECORD_SIZE


class TestWriteCompression:
    """Write-side gzip/zstd (additive; reference is read-side only)."""

    def _roundtrip(self, tmp_path, name, compression):
        p = tmp_path / name
        records = recs(1000)
        with Writer.from_path(str(p), Header.new(16, 12), compression) as w:
            w.write_batch(records)
        return p, records

    def test_gzip_roundtrip(self, tmp_path):
        import gzip

        p, records = self._roundtrip(tmp_path, "out.ibu.gz", "gzip")
        assert p.read_bytes()[:2] == b"\x1f\x8b"
        # decompressed bytes are the exact plain-format bytes
        raw = gzip.decompress(p.read_bytes())
        assert raw[:4] == b"IBU!"
        assert len(raw) == 32 + 1000 * RECORD_SIZE
        with Reader.from_path(str(p)) as r:  # sniffed transparently
            got = np.concatenate(list(r.batches()))
        np.testing.assert_array_equal(got, records)

    def test_zstd_roundtrip(self, tmp_path):
        pytest.importorskip("zstandard")
        p, records = self._roundtrip(tmp_path, "out.ibu.zst", "zstd")
        assert p.read_bytes()[:4] == b"\x28\xb5\x2f\xfd"
        with Reader.from_path(str(p)) as r:
            got = np.concatenate(list(r.batches()))
        np.testing.assert_array_equal(got, records)

    def test_auto_infers_from_extension(self, tmp_path):
        p, _ = self._roundtrip(tmp_path, "out.ibu.gz", "auto")
        assert p.read_bytes()[:2] == b"\x1f\x8b"
        p2, _ = self._roundtrip(tmp_path, "out.ibu", "auto")
        assert p2.read_bytes()[:4] == b"IBU!"  # plain

    def test_default_stays_plain(self, tmp_path):
        """Parity: default from_path is uncompressed even for .gz names
        (the reference always opens a plain File, writer.rs:556-559)."""
        p = tmp_path / "plain.ibu.gz"
        with Writer.from_path(str(p), Header.new(16, 12)) as w:
            w.write_batch(recs(10))
        assert p.read_bytes()[:4] == b"IBU!"

    def test_unknown_kind_raises_and_leaves_no_fd(self, tmp_path):
        from ibu_jax.errors import CompressionError

        with pytest.raises(CompressionError) as ei:
            Writer.from_path(str(tmp_path / "x.ibu"), Header.new(16, 12), "lz4")
        assert "unknown compression" in str(ei.value.inner)

    def test_large_batch_direct_path_compressed(self, tmp_path):
        """Batches larger than the internal buffer hit the direct-write
        path; that path must also feed the encoder."""
        p = tmp_path / "big.ibu.gz"
        records = recs(DEFAULT_BUFFER_SIZE // RECORD_SIZE + 5000)
        with Writer.from_path(str(p), Header.new(16, 12), "gzip") as w:
            w.write_batch(records)
        with Reader.from_path(str(p)) as r:
            got = np.concatenate(list(r.batches()))
        np.testing.assert_array_equal(got, records)


class TestNonSeekablePlainPath:
    def test_fifo_large_batch_falls_back_to_sequential(self, tmp_path):
        """A plain (uncompressed) path can still be non-seekable — a FIFO
        or /dev/stdout. The ≥8 MB native-pwrite fast path needs tell(),
        which raises ESPIPE there; the writer must fall back to streaming
        the bytes, not abort."""
        import os
        import threading

        fifo = str(tmp_path / "pipe.ibu")
        os.mkfifo(fifo)
        n = (8 << 20) // RECORD_SIZE + 5000  # over the native threshold
        records = recs(n)
        chunks = []

        def drain():
            with open(fifo, "rb") as f:
                while True:
                    b = f.read(1 << 20)
                    if not b:
                        break
                    chunks.append(b)

        t = threading.Thread(target=drain)
        t.start()
        with Writer.from_path(fifo, Header.new(16, 12)) as w:
            w.write_batch(records)
        t.join(timeout=60)
        assert not t.is_alive()
        data = b"".join(chunks)
        assert len(data) == 32 + n * RECORD_SIZE
        got = np.frombuffer(data[32:], dtype=records.dtype)
        np.testing.assert_array_equal(got, records)
