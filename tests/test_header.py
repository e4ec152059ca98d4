"""Header tests — parity with the reference suite (``header.rs:231-412``)."""

import pytest

from ibu_jax import (
    HEADER_SIZE,
    MAGIC,
    VERSION,
    Header,
    InvalidBarcodeLength,
    InvalidMagicNumber,
    InvalidUmiLength,
    InvalidVersion,
)


class TestCreation:
    def test_new_defaults(self):
        h = Header.new(16, 12)
        assert h.magic == MAGIC
        assert h.version == VERSION
        assert h.bc_len == 16
        assert h.umi_len == 12
        assert h.flags == 0
        assert h.reserved == b"\x00" * 8

    def test_size_is_32(self):
        assert HEADER_SIZE == 32
        assert len(Header.new(16, 12).as_bytes()) == 32

    def test_magic_spells_ibu_bang_le(self):
        assert MAGIC.to_bytes(4, "little") == b"IBU!"


class TestSortedFlag:
    def test_sorted_flag_idempotent(self):
        h = Header.new(16, 12)
        assert not h.sorted()
        h.set_sorted()
        assert h.sorted()
        h.set_sorted()
        assert h.sorted()
        assert h.flags == 1

    def test_clear_sorted(self):
        h = Header.new(16, 12)
        h.set_sorted()
        h.clear_sorted()
        assert not h.sorted()
        assert h.flags == 0

    def test_sorted_flag_preserves_other_bits(self):
        h = Header.new(16, 12)
        h.flags = 0b1010
        h.set_sorted()
        assert h.flags == 0b1011
        h.clear_sorted()
        assert h.flags == 0b1010


class TestValidate:
    def test_valid(self):
        Header.new(16, 12).validate()
        Header.new(1, 1).validate()  # lower boundary
        Header.new(32, 32).validate()  # upper boundary

    def test_invalid_magic(self):
        h = Header.new(16, 12)
        h.magic = 0x12345678
        with pytest.raises(InvalidMagicNumber) as ei:
            h.validate()
        assert ei.value.expected == MAGIC
        assert ei.value.actual == 0x12345678
        assert "Invalid magic number" in str(ei.value)

    def test_invalid_version(self):
        h = Header.new(16, 12)
        h.version = 99
        with pytest.raises(InvalidVersion) as ei:
            h.validate()
        assert ei.value.expected == VERSION
        assert ei.value.actual == 99

    @pytest.mark.parametrize("bad", [0, 33, 100])
    def test_invalid_bc_len(self, bad):
        h = Header.new(bad, 12)
        with pytest.raises(InvalidBarcodeLength) as ei:
            h.validate()
        assert ei.value.length == bad

    @pytest.mark.parametrize("bad", [0, 33, 100])
    def test_invalid_umi_len(self, bad):
        h = Header.new(16, bad)
        with pytest.raises(InvalidUmiLength) as ei:
            h.validate()
        assert ei.value.length == bad

    def test_magic_checked_before_version(self):
        """Error precedence parity with header.rs:167-187."""
        h = Header(magic=0, version=0, bc_len=0, umi_len=0)
        with pytest.raises(InvalidMagicNumber):
            h.validate()
        h.magic = MAGIC
        with pytest.raises(InvalidVersion):
            h.validate()
        h.version = VERSION
        with pytest.raises(InvalidBarcodeLength):
            h.validate()
        h.bc_len = 16
        with pytest.raises(InvalidUmiLength):
            h.validate()


class TestRoundtrip:
    def test_byte_roundtrip(self):
        h = Header.new(20, 10)
        h.set_sorted()
        again = Header.from_bytes(h.as_bytes())
        assert again == h
        assert again.sorted()

    def test_exact_wire_layout(self):
        """Field-by-field byte layout (header.rs:17-24)."""
        h = Header.new(16, 12)
        h.flags = 0x0102030405060708
        b = h.as_bytes()
        assert b[0:4] == b"IBU!"
        assert int.from_bytes(b[4:8], "little") == 2
        assert int.from_bytes(b[8:12], "little") == 16
        assert int.from_bytes(b[12:16], "little") == 12
        assert int.from_bytes(b[16:24], "little") == 0x0102030405060708
        assert b[24:32] == b"\x00" * 8

    def test_from_bytes_wrong_size(self):
        with pytest.raises(ValueError):
            Header.from_bytes(b"\x00" * 31)

    def test_from_bytes_does_not_validate(self):
        h = Header.from_bytes(b"\x00" * 32)
        assert h.magic == 0

    def test_hash_and_eq(self):
        a, b = Header.new(16, 12), Header.new(16, 12)
        assert a == b
        assert hash(a) == hash(b)
        b.set_sorted()
        assert a != b


class TestSerde:
    def test_header_json_roundtrip(self):
        """Serde-feature parity (header.rs:48 derive): byte-identical
        through a JSON round-trip, flags included."""
        import json

        h = Header.new(16, 12)
        h.set_sorted()
        back = Header.from_bytes(
            Header.from_dict(json.loads(json.dumps(h.to_dict()))).as_bytes()
        )
        assert back.as_bytes() == h.as_bytes()
        assert back.sorted()
