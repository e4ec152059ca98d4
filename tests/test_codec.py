"""Codec tests: numpy oracle ↔ lax agreement (per field and fused per
record), 2-bit table parity with the format contract (``record.rs:19-27``)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ibu_jax.ops import codec as C
from ibu_jax.ops.u64 import join_u64, records_from_soa, soa_from_records, split_u64
from tests.conftest import make_records_arange


def random_rows(n, L, seed=0, lowercase=False):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"acgt" if lowercase else b"ACGT", dtype=np.uint8)
    return alphabet[rng.integers(0, 4, size=(n, L))]


class TestTable:
    def test_single_base_codes(self):
        """A=00 C=01 G=10 T=11 (record.rs:19-27)."""
        words = C.encode_seqs(["A", "C", "G", "T"])
        assert words.tolist() == [0, 1, 2, 3]

    def test_acgt_word(self):
        # base i at bits 2i: A|C<<2|G<<4|T<<6 = 0+4+32+192
        assert C.encode_seqs(["ACGT"]).tolist() == [228]

    def test_lowercase_equals_uppercase(self):
        assert C.encode_seqs(["acgt"]).tolist() == C.encode_seqs(["ACGT"]).tolist()

    def test_decode_uppercases(self):
        words = C.encode_seqs(["acgt"])
        assert C.decode_seqs(words, 4) == ["ACGT"]

    def test_validation_rejects_bad_char(self):
        with pytest.raises(ValueError, match="invalid nucleotide 'N'"):
            C.encode_seqs(["ACNT"])

    def test_length_over_32_rejected(self):
        with pytest.raises(ValueError, match="exceeds 32"):
            C.encode_seqs(["A" * 33])

    def test_ragged_rejected(self):
        with pytest.raises(ValueError, match="ragged"):
            C.encode_seqs(["AC", "ACG"])


class TestNumpyOracle:
    @pytest.mark.parametrize("L", [1, 4, 15, 16, 17, 31, 32])
    def test_roundtrip(self, L):
        rows = random_rows(257, L, seed=L)
        words = C.np_pack(rows)
        assert np.array_equal(C.np_unpack(words, L), rows)

    def test_full_t_32_hits_bit63(self):
        """32 T's → all bits set incl. bit 63 (the hi-word edge the SURVEY
        flags as a hard part)."""
        words = C.encode_seqs(["T" * 32])
        assert words[0] == 0xFFFFFFFFFFFFFFFF

    def test_seq_roundtrip_strings(self):
        seqs = ["ACGTACGTACGTACGT", "TTTTGGGGCCCCAAAA"]
        words = C.encode_seqs(seqs)
        assert C.decode_seqs(words, 16) == seqs


class TestLaxAgainstNumpy:
    @pytest.mark.parametrize("L", [1, 8, 16, 17, 32])
    def test_encode_matches(self, L):
        rows = random_rows(500, L, seed=L)
        planes = C.rows_to_planes(rows)
        pair = np.asarray(C.lax_encode_planes(jnp.asarray(planes)))
        words = join_u64(pair[0], pair[1])
        assert np.array_equal(words, C.np_pack(rows))

    @pytest.mark.parametrize("L", [1, 8, 16, 17, 32])
    def test_decode_matches(self, L):
        rows = random_rows(500, L, seed=100 + L)
        words = C.np_pack(rows)
        pair = jnp.asarray(C.words_to_pair(words))
        planes = np.asarray(C.lax_decode_planes(pair, L))
        assert np.array_equal(C.planes_to_rows(planes), rows)

    def test_lowercase(self):
        rows = random_rows(64, 12, lowercase=True)
        planes = C.rows_to_planes(rows)
        pair = np.asarray(C.lax_encode_planes(jnp.asarray(planes)))
        assert np.array_equal(join_u64(pair[0], pair[1]), C.np_pack(rows))


def _planes(rows):
    return jnp.asarray(C.rows_to_planes(rows))


class TestFusedRecordCodec:
    """The jitted record codec the device runs, against the numpy oracle."""

    @pytest.mark.parametrize("field", ["barcode", "umi"])
    @pytest.mark.parametrize("L", [1, 15, 16, 17, 31, 32])
    def test_encode_matches_numpy(self, field, L):
        n = 1001
        bc_rows = random_rows(n, L if field == "barcode" else 16, seed=L)
        umi_rows = random_rows(n, L if field == "umi" else 12, seed=50 + L)
        idx = np.arange(n, dtype=np.uint64) * np.uint64(0x100000007)
        soa = C.lax_encode_records(
            _planes(bc_rows), _planes(umi_rows),
            jnp.asarray(C.words_to_pair(idx)),
        )
        assert soa.shape == (6, n) and soa.dtype == jnp.uint32
        records = records_from_soa(np.asarray(soa))
        assert np.array_equal(records["barcode"], C.np_pack(bc_rows))
        assert np.array_equal(records["umi"], C.np_pack(umi_rows))
        assert np.array_equal(records["index"], idx)

    @pytest.mark.parametrize("field", ["barcode", "umi"])
    @pytest.mark.parametrize("L", [1, 15, 16, 17, 31, 32])
    def test_decode_matches_numpy(self, field, L):
        from ibu_jax.constructs.record import make_records

        n = 999
        bc_len = L if field == "barcode" else 16
        umi_len = L if field == "umi" else 12
        bc_rows = random_rows(n, bc_len, seed=100 + L)
        umi_rows = random_rows(n, umi_len, seed=150 + L)
        idx = np.arange(n, dtype=np.uint64) << np.uint64(31)
        records = make_records(C.np_pack(bc_rows), C.np_pack(umi_rows), idx)
        bc_p, umi_p, idx_pair = C.lax_decode_records(
            jnp.asarray(soa_from_records(records)), bc_len, umi_len
        )
        assert np.array_equal(C.planes_to_rows(np.asarray(bc_p)), bc_rows)
        assert np.array_equal(C.planes_to_rows(np.asarray(umi_p)), umi_rows)
        assert np.array_equal(C.pair_to_words(np.asarray(idx_pair)), idx)

    @pytest.mark.parametrize("n", [1, 2, 127, 4097])
    def test_odd_record_counts_roundtrip(self, n):
        """No tile padding: any record count, lowercase in, uppercase out."""
        bc_rows = random_rows(n, 16, seed=n, lowercase=True)
        umi_rows = random_rows(n, 12, seed=n + 1)
        idx = np.arange(n, dtype=np.uint64)
        soa = C.lax_encode_records(
            _planes(bc_rows), _planes(umi_rows),
            jnp.asarray(C.words_to_pair(idx)),
        )
        bc_p, umi_p, idx_pair = C.lax_decode_records(soa, 16, 12)
        assert np.array_equal(
            C.planes_to_rows(np.asarray(bc_p)), bc_rows - 32  # upper-cased
        )
        assert np.array_equal(C.planes_to_rows(np.asarray(umi_p)), umi_rows)
        assert np.array_equal(C.pair_to_words(np.asarray(idx_pair)), idx)


class TestU64Pairs:
    def test_split_join_roundtrip(self):
        rng = np.random.default_rng(0)
        x = rng.integers(0, 1 << 63, 1000, dtype=np.uint64) * np.uint64(2) + rng.integers(0, 2, 1000, dtype=np.uint64)
        lo, hi = split_u64(x)
        assert np.array_equal(join_u64(lo, hi), x)

    def test_split_known_value(self):
        lo, hi = split_u64(np.array([0x1122334455667788], dtype=np.uint64))
        assert lo[0] == 0x55667788
        assert hi[0] == 0x11223344

    def test_soa_roundtrip_byte_exact(self):
        records = make_records_arange(1000)
        records["barcode"][0] = 0xFFFFFFFFFFFFFFFF
        soa = soa_from_records(records)
        assert soa.shape == (6, 1000)
        back = records_from_soa(soa)
        assert back.tobytes() == records.tobytes()

    def test_soa_row_order(self):
        from ibu_jax.constructs.record import make_records

        r = make_records(
            np.array([0x0000000200000001], dtype=np.uint64),
            np.array([0x0000000400000003], dtype=np.uint64),
            np.array([0x0000000600000005], dtype=np.uint64),
        )
        soa = soa_from_records(r)
        assert soa[:, 0].tolist() == [1, 2, 3, 4, 5, 6]
