"""Reader + load_to_vec tests — parity with the reference suite
(``reader.rs:537-767``)."""

import gzip
import io

import numpy as np
import pytest

from ibu_jax import (
    HEADER_SIZE,
    RECORD_SIZE,
    Header,
    IbuIoError,
    InvalidMagicNumber,
    InvalidMapSize,
    Reader,
    Record,
    TruncatedRecord,
    Writer,
    load_to_vec,
)
from ibu_jax.constructs.record import make_records


def build_stream(n, header=None):
    """In-memory roundtrip fixture (reader.rs:543-550 pattern)."""
    w = Writer.in_memory(header or Header.new(16, 12))
    i = np.arange(n, dtype=np.uint64)
    w.write_batch(make_records(i, i * np.uint64(2), i * np.uint64(3)))
    w.finish()
    return io.BytesIO(w.inner.getvalue())


class TestConstruction:
    def test_header_parse(self):
        h = Header.new(20, 10)
        h.set_sorted()
        r = Reader(build_stream(0, header=h))
        got = r.header()
        assert got.bc_len == 20
        assert got.umi_len == 10
        assert got.sorted()

    def test_invalid_magic(self):
        with pytest.raises(InvalidMagicNumber):
            Reader(io.BytesIO(b"\x00" * 32))

    def test_short_header_is_io_error(self):
        with pytest.raises(IbuIoError):
            Reader(io.BytesIO(b"IBU!"))

    def test_bytes_read_starts_at_header(self):
        r = Reader(build_stream(0))
        assert r.bytes_read == HEADER_SIZE


class TestIteration:
    def test_roundtrip_small(self):
        r = Reader(build_stream(10))
        got = list(r)
        assert len(got) == 10
        assert got[3] == Record(3, 6, 9)

    def test_empty_file(self):
        assert list(Reader(build_stream(0))) == []

    def test_large_batch_crosses_refills(self):
        """100K records > one 48K-record buffer (reader.rs:606-616)."""
        r = Reader(build_stream(100_000))
        count = 0
        for rec in r:
            assert rec.barcode == count
            count += 1
        assert count == 100_000

    def test_bytes_read_tracking(self):
        r = Reader(build_stream(10))
        list(r)
        assert r.bytes_read == HEADER_SIZE + 10 * RECORD_SIZE


class TestBatchAPI:
    def test_batches_yield_all_records(self):
        r = Reader(build_stream(100_000))
        total = 0
        for batch in r.batches():
            assert batch.dtype.itemsize == RECORD_SIZE
            total += len(batch)
        assert total == 100_000

    def test_batch_contents(self):
        r = Reader(build_stream(1000))
        batch = r.read_records()
        assert batch is not None
        assert batch["barcode"].tolist() == list(range(1000))
        assert r.read_records() is None

    def test_batches_after_partial_iteration(self):
        r = Reader(build_stream(5))
        first = next(iter(r))
        assert first == Record(0, 0, 0)
        rest = r.read_records()
        assert rest["barcode"].tolist() == [1, 2, 3, 4]


class TestTruncation:
    def test_truncated_mid_record(self):
        data = build_stream(2).getvalue()
        cut = data[:-5]  # chop into the last record
        with pytest.raises(TruncatedRecord) as ei:
            list(Reader(io.BytesIO(cut)))
        # pos = header + complete records (reader.rs:232-237)
        assert ei.value.pos == HEADER_SIZE + RECORD_SIZE

    def test_truncated_after_header(self):
        data = build_stream(1).getvalue()[: HEADER_SIZE + 7]
        with pytest.raises(TruncatedRecord) as ei:
            list(Reader(io.BytesIO(data)))
        assert ei.value.pos == HEADER_SIZE

    def test_manual_read_batch_eof(self):
        r = Reader(build_stream(3))
        assert r.read_batch() is True
        assert r.read_batch() is False


class TestCompression:
    def test_gzip_stream(self, tmp_path):
        raw = build_stream(100).getvalue()
        p = tmp_path / "x.ibu.gz"
        p.write_bytes(gzip.compress(raw))
        r = Reader.from_path(str(p))
        assert len(list(r)) == 100

    def test_multi_frame_zstd_reads_across_frames(self, tmp_path):
        # one logical record stream split across TWO zstd frames: the
        # frame-tracking decoder must restart cleanly at the boundary
        zstd = pytest.importorskip("zstandard")
        raw = build_stream(100).getvalue()
        cut = 32 + 24 * 37  # frame boundary mid-stream, record-aligned
        c = zstd.ZstdCompressor(write_checksum=True)
        p = tmp_path / "two.ibu.zst"
        p.write_bytes(c.compress(raw[:cut]) + c.compress(raw[cut:]))
        r = Reader.from_path(str(p))
        assert len(list(r)) == 100

    def test_multi_member_gzip_reads_across_members(self, tmp_path):
        raw = build_stream(50).getvalue()
        cut = 32 + 24 * 13
        p = tmp_path / "two.ibu.gz"
        p.write_bytes(gzip.compress(raw[:cut]) + gzip.compress(raw[cut:]))
        r = Reader.from_path(str(p))
        assert len(list(r)) == 50

    def test_torn_gzip_raises_compression_error(self, tmp_path):
        from ibu_jax.errors import CompressionError

        raw = build_stream(5000).getvalue()
        blob = gzip.compress(raw)
        p = tmp_path / "torn.ibu.gz"
        p.write_bytes(blob[: len(blob) // 2])
        r = Reader.from_path(str(p))
        with pytest.raises(CompressionError):
            for _ in r.batches():
                pass

    def test_corrupt_gzip_crc_is_compression_error(self, tmp_path):
        # a bit flip in the deflate body/CRC raises gzip.BadGzipFile — an
        # OSError subclass that must still map to the Niffler variant,
        # not IbuIoError
        from ibu_jax.errors import CompressionError

        raw = build_stream(5000).getvalue()
        blob = bytearray(gzip.compress(raw))
        blob[-5] ^= 0xFF  # corrupt the CRC/ISIZE trailer
        p = tmp_path / "crc.ibu.gz"
        p.write_bytes(bytes(blob))
        r = Reader.from_path(str(p))
        with pytest.raises(CompressionError):
            for _ in r.batches():
                pass

    def test_zero_bomb_zstd_streams_bounded(self, tmp_path):
        # an all-zero record region compresses ~25000:1; reading it back
        # must stream in bounded chunks (no whole-expansion transient) and
        # still roundtrip exactly
        zstd = pytest.importorskip("zstandard")
        import numpy as np

        from ibu_jax.constructs.record import make_records
        from ibu_jax.io.writer import Writer

        n = 2_000_000  # 48 MB of zero records
        z = np.zeros(n, dtype=np.uint64)
        p = tmp_path / "zero.ibu.zst"
        with Writer.from_path(str(p), Header.new(8, 6),
                              compression="zstd") as w:
            w.write_batch(make_records(z, z, z))
        assert p.stat().st_size < 100_000  # really a zero bomb
        total = 0
        r = Reader.from_path(str(p))
        for batch in r.batches():
            total += len(batch)
            assert not batch["barcode"].any()
        assert total == n

    def test_torn_zstd_raises_compression_error(self, tmp_path):
        zstd = pytest.importorskip("zstandard")
        from ibu_jax.errors import CompressionError

        raw = build_stream(5000).getvalue()
        blob = zstd.ZstdCompressor().compress(raw)
        p = tmp_path / "torn.ibu.zst"
        p.write_bytes(blob[: len(blob) // 2])
        with pytest.raises(CompressionError):
            r = Reader.from_path(str(p))  # may raise at header or stream
            for _ in r.batches():
                pass

    def test_plain_file(self, tmp_path):
        raw = build_stream(100).getvalue()
        p = tmp_path / "x.ibu"
        p.write_bytes(raw)
        assert len(list(Reader.from_path(str(p)))) == 100

    def test_zstd_stream(self, tmp_path):
        zstd = pytest.importorskip("zstandard")
        raw = build_stream(50).getvalue()
        p = tmp_path / "x.ibu.zst"
        p.write_bytes(zstd.ZstdCompressor().compress(raw))
        assert len(list(Reader.from_path(str(p)))) == 50

    def test_zstd_threaded_write_roundtrips(self, tmp_path):
        # threads=-1 (the default: multithreaded zstd frames) and
        # threads=0 (single worker) must both produce standard frames
        # that decode to identical records
        pytest.importorskip("zstandard")
        import numpy as np

        from ibu_jax.constructs.record import make_records
        from ibu_jax.io.writer import Writer

        n = 500_000
        i = np.arange(n, dtype=np.uint64)
        recs = make_records(i, i * np.uint64(2), i * np.uint64(3))
        outs = []
        for threads in (-1, 0):
            p = tmp_path / f"t{threads}.ibu.zst"
            with Writer.from_path(str(p), Header.new(16, 12),
                                  compression="zstd", threads=threads) as w:
                w.write_batch(recs)
            got = np.concatenate(
                [np.asarray(b) for b in Reader.from_path(str(p)).batches()]
            )
            assert np.array_equal(got, recs)
            outs.append(p.stat().st_size)
        # both really compressed (not stored)
        assert all(sz < 24 * n for sz in outs)


class TestLoadToVec:
    def test_basic(self, tmp_path):
        raw = build_stream(1000).getvalue()
        p = tmp_path / "x.ibu"
        p.write_bytes(raw)
        header, records = load_to_vec(str(p))
        assert header.bc_len == 16
        assert len(records) == 1000
        assert records["umi"][500] == 1000

    def test_empty(self, tmp_path):
        p = tmp_path / "x.ibu"
        p.write_bytes(build_stream(0).getvalue())
        _, records = load_to_vec(str(p))
        assert len(records) == 0

    def test_invalid_size(self, tmp_path):
        """Bulk load reports InvalidMapSize, not TruncatedRecord
        (reader.rs:520-524 vs reader.rs:232-237)."""
        p = tmp_path / "x.ibu"
        p.write_bytes(build_stream(2).getvalue()[:-5])
        with pytest.raises(InvalidMapSize):
            load_to_vec(str(p))

    def test_missing_file(self, tmp_path):
        with pytest.raises(IbuIoError):
            load_to_vec(str(tmp_path / "nope.ibu"))


class TestResourceManagement:
    def test_compressed_reader_close_releases_fd(self, tmp_path):
        """Closing a gzip Reader must close the underlying descriptor."""
        import os

        raw = build_stream(10).getvalue()
        p = tmp_path / "fd.ibu.gz"
        p.write_bytes(gzip.compress(raw))
        fd_dir = "/proc/self/fd"
        before = len(os.listdir(fd_dir))
        for _ in range(10):
            r = Reader.from_path(str(p))
            list(r)
            r.close()
        after = len(os.listdir(fd_dir))
        assert after <= before + 1  # no fd accumulation

    def test_ragged_buffer_size_rounds_down(self):
        """A buffer_size not a multiple of 24 must not cause spurious
        truncation errors when the buffer fills completely."""
        r = Reader(build_stream(100), buffer_size=100)  # → 96 bytes, 4 recs
        assert len(list(r)) == 100


class TestClone:
    """Reader.clone() parity with the reference's derived Clone
    (reader.rs:90, test at reader.rs:655-666)."""

    def test_clone_mid_stream_bytesio(self):
        """The reference clone test: read half, clone, both finish
        identically from the clone point."""
        r = Reader(build_stream(10))
        first = [next(r) for _ in range(5)]
        c = r.clone()
        rest_r = list(r)
        rest_c = list(c)
        assert rest_r == rest_c
        assert len(first) + len(rest_r) == 10
        assert c.bytes_read == r.bytes_read

    def test_clone_state_is_independent(self):
        r = Reader(build_stream(100, header=Header.new(8, 8)))
        c = r.clone()
        list(r)  # exhaust the original
        assert len(list(c)) == 100  # clone unaffected
        assert c.header().bc_len == 8

    def test_clone_plain_file(self, tmp_path):
        p = tmp_path / "c.ibu"
        p.write_bytes(build_stream(50).getvalue())
        r = Reader.from_path(str(p))
        next(r)
        c = r.clone()
        assert len(list(c)) == len(list(r))

    def test_clone_gzip_path_mid_stream(self, tmp_path):
        """Path-backed compressed readers clone by re-open + skip —
        closing the reference's universal derive(Clone) surface
        (reader.rs:90): any cloneable inner clones, including
        niffler-wrapped files."""
        p = tmp_path / "c.ibu.gz"
        p.write_bytes(gzip.compress(build_stream(50).getvalue()))
        r = Reader.from_path(str(p))
        first = [next(r) for _ in range(20)]
        c = r.clone()
        rest_r = list(r)
        rest_c = list(c)
        assert rest_r == rest_c
        assert len(first) + len(rest_r) == 50
        assert c.bytes_read == 32 + 50 * 24

    def test_clone_zstd_path_mid_stream(self, tmp_path):
        zstd = pytest.importorskip("zstandard")
        p = tmp_path / "c.ibu.zst"
        p.write_bytes(
            zstd.ZstdCompressor(write_checksum=True).compress(
                build_stream(50).getvalue()
            )
        )
        r = Reader.from_path(str(p))
        next(r)
        c = r.clone()
        assert list(c) == list(r)

    def test_clone_compressed_clone_is_independent(self, tmp_path):
        p = tmp_path / "c.ibu.gz"
        p.write_bytes(gzip.compress(build_stream(30).getvalue()))
        r = Reader.from_path(str(p))
        c = r.clone()
        list(r)  # exhaust the original
        assert len(list(c)) == 30

    def test_clone_stdin_like_chain_raises(self):
        """Truly source-less compressed streams (stdin/pipes) remain
        uncloneable — the runtime analog of R: !Clone failing to
        compile."""
        import io

        from ibu_jax.io.compression import wrap_decompress

        gz = gzip.compress(build_stream(5).getvalue())
        pipe_like = io.BytesIO(gz)  # no filesystem name, like a pipe
        r = Reader(wrap_decompress(pipe_like))
        with pytest.raises(TypeError, match="not cloneable"):
            r.clone()
