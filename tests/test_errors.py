"""Error taxonomy tests — parity with the reference suite (``error.rs:179-370``)."""

import pytest

from ibu_jax import (
    CompressionError,
    IbuError,
    IbuIoError,
    InvalidBarcodeLength,
    InvalidIndex,
    InvalidMagicNumber,
    InvalidMapSize,
    InvalidUmiLength,
    InvalidVersion,
    MAGIC,
    ProcessError,
    TruncatedRecord,
    into_ibu_error,
)


class TestDisplayMessages:
    """Message strings match the reference Display impls (error.rs:56-128)."""

    def test_invalid_magic(self):
        e = InvalidMagicNumber(expected=MAGIC, actual=0xDEADBEEF)
        assert str(e) == (
            "Invalid magic number, expected (0x21554249), found (0xdeadbeef)"
        )

    def test_truncated_record(self):
        assert str(TruncatedRecord(pos=1234)) == "Truncated record at position 1234"

    def test_invalid_version(self):
        assert str(InvalidVersion(expected=2, actual=7)) == (
            "Invalid version found, expected (2), found (7)"
        )

    def test_invalid_barcode_length(self):
        assert str(InvalidBarcodeLength(33)) == (
            "Invalid barcode length: 33 (must be 1-32)"
        )

    def test_invalid_umi_length(self):
        assert str(InvalidUmiLength(0)) == "Invalid UMI length: 0 (must be 1-32)"

    def test_invalid_map_size(self):
        assert str(InvalidMapSize()) == (
            "Invalid map size - not a multiple of record size"
        )

    def test_invalid_index(self):
        assert str(InvalidIndex(idx=10, max=5)) == (
            "Invalid index (10) - Must be less than 5"
        )

    def test_process(self):
        assert str(ProcessError("boom")) == "Processing error: boom"

    def test_io(self):
        assert str(IbuIoError(OSError("x"))) == "I/O error"

    def test_compression(self):
        assert str(CompressionError("x")) == "Niffler error"


class TestHierarchy:
    def test_all_derive_ibu_error(self):
        for e in [
            IbuIoError("x"),
            CompressionError("x"),
            InvalidMagicNumber(1, 2),
            TruncatedRecord(0),
            InvalidVersion(2, 3),
            InvalidBarcodeLength(0),
            InvalidUmiLength(0),
            InvalidMapSize(),
            InvalidIndex(1, 2),
            ProcessError("x"),
        ]:
            assert isinstance(e, IbuError)

    def test_payload_fields(self):
        e = InvalidMagicNumber(expected=1, actual=2)
        assert (e.expected, e.actual) == (1, 2)
        e2 = InvalidIndex(idx=3, max=4)
        assert (e2.idx, e2.max) == (3, 4)
        assert TruncatedRecord(pos=77).pos == 77


class TestIntoIbuError:
    """Blanket conversion parity (error.rs:161-177)."""

    def test_wraps_arbitrary_error(self):
        wrapped = into_ibu_error(ValueError("something went wrong"))
        assert isinstance(wrapped, ProcessError)
        assert "something went wrong" in str(wrapped)

    def test_passes_through_ibu_errors(self):
        e = InvalidMapSize()
        assert into_ibu_error(e) is e

    def test_source_chain(self):
        inner = ValueError("inner")
        wrapped = into_ibu_error(inner)
        assert wrapped.inner is inner

    def test_raising_from_preserves_cause(self):
        with pytest.raises(ProcessError) as ei:
            try:
                raise ValueError("cause")
            except ValueError as v:
                raise into_ibu_error(v) from v
        assert isinstance(ei.value.__cause__, ValueError)
