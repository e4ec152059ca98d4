"""Barcode Hamming-1 correction: XOR-variant probe vs brute-force oracle.

The policy (exact keep / unique distance-1 neighbor rewrite / else drop)
is anchored three ways: a brute-force Hamming-distance oracle over decoded
sequences, np↔lax path agreement on random data (incl. power-of-two
padding edges), and end-to-end file/CLI drives.
"""

import subprocess
import sys

import numpy as np
import pytest

from ibu_jax import Header, MmapReader, Writer
from ibu_jax.constructs.record import make_records
from ibu_jax.ops import codec as C
from ibu_jax.ops.correct import (
    CORRECTED,
    DROP,
    EXACT,
    correct_batch,
    lax_correct_unique,
    np_correct_unique,
    variant_deltas,
)


def _pack(seqs):
    return C.np_pack(C.seqs_to_rows(list(seqs)))


def _hamming(a: str, b: str) -> int:
    return sum(x != y for x, y in zip(a, b))


def brute_force(seq: str, allow_seqs: list[str]):
    """The policy, written directly against decoded sequences."""
    if seq in allow_seqs:
        return seq, EXACT
    near = [a for a in allow_seqs if _hamming(seq, a) == 1]
    if len(near) == 1:
        return near[0], CORRECTED
    return seq, DROP


class TestVariantDeltas:
    def test_distinct_and_in_range(self):
        for L in (1, 2, 15, 16, 17, 32):
            d = variant_deltas(L)
            assert len(d) == 3 * L == len(set(d.tolist()))
            assert int(d.max()) < (1 << (2 * L)) if L < 32 else True
            assert 0 not in d

    def test_bad_length(self):
        with pytest.raises(ValueError):
            variant_deltas(0)
        with pytest.raises(ValueError):
            variant_deltas(33)


class TestAgainstBruteForce:
    @pytest.mark.parametrize("L", [4, 16])
    def test_policy_matches_exhaustive_oracle(self, L):
        rng = np.random.default_rng(7)
        bases = "ACGT"

        def rand_seq():
            return "".join(bases[i] for i in rng.integers(0, 4, L))

        allow_seqs = sorted({rand_seq() for _ in range(40)})
        # queries: exact members, 1-error mutants, 2-error mutants, random
        queries = list(allow_seqs[:5])
        for s in allow_seqs[:10]:
            p = int(rng.integers(0, L))
            queries.append(
                s[:p] + bases[(bases.index(s[p]) + 1) % 4] + s[p + 1:]
            )
        for s in allow_seqs[:5]:
            p, q = sorted(rng.choice(L, 2, replace=False).tolist())
            if p == q:
                continue
            m = list(s)
            m[p] = bases[(bases.index(m[p]) + 1) % 4]
            m[q] = bases[(bases.index(m[q]) + 2) % 4]
            queries.append("".join(m))
        queries += [rand_seq() for _ in range(30)]

        allow = np.sort(_pack(allow_seqs))
        uniq = np.unique(_pack(queries))
        got_val, got_st = np_correct_unique(uniq, allow, L)
        uniq_seqs = C.decode_seqs(uniq, L)
        for i, s in enumerate(uniq_seqs):
            want_seq, want_st = brute_force(s, allow_seqs)
            assert got_st[i] == want_st, (s, allow_seqs)
            if want_st != DROP:
                assert C.decode_seqs(got_val[i : i + 1], L)[0] == want_seq

    def test_ambiguous_two_neighbors_dropped(self):
        allow = np.sort(_pack(["AAAA", "CAAA"]))
        # "GAAA" is distance 1 from both -> ambiguous
        uniq = _pack(["GAAA"])
        val, st = np_correct_unique(uniq, allow, 4)
        assert st[0] == DROP and val[0] == uniq[0]

    def test_exact_beats_neighbors(self):
        # a barcode IN the list that also has distance-1 neighbors stays
        allow = np.sort(_pack(["AAAA", "CAAA", "GAAA"]))
        uniq = _pack(["CAAA"])
        val, st = np_correct_unique(uniq, allow, 4)
        assert st[0] == EXACT and val[0] == uniq[0]

    def test_empty_allowlist_drops_everything(self):
        uniq = _pack(["ACGT"])
        val, st = np_correct_unique(uniq, np.array([], np.uint64), 4)
        assert st[0] == DROP


class TestLaxAgreement:
    @pytest.mark.parametrize("L", [1, 8, 12, 16])
    def test_np_lax_identical_random(self, L):
        rng = np.random.default_rng(L)
        space = 1 << (2 * L)
        allow = np.sort(
            np.unique(rng.integers(0, min(space, 1 << 62), 200).astype(np.uint64))
        )
        uniq = np.unique(
            rng.integers(0, min(space, 1 << 62), 500).astype(np.uint64)
        )
        nv, ns = np_correct_unique(uniq, allow, L)
        lv, ls = lax_correct_unique(uniq, allow, L)
        np.testing.assert_array_equal(nv, lv)
        np.testing.assert_array_equal(ns, ls)

    def test_pow2_padding_edges(self):
        # unique counts straddling powers of two (padding correctness)
        L = 8
        rng = np.random.default_rng(3)
        allow = np.sort(
            np.unique(rng.integers(0, 1 << 16, 100).astype(np.uint64))
        )
        for u in (1, 2, 3, 4, 127, 128, 129):
            uniq = np.unique(
                rng.integers(0, 1 << 16, u * 2).astype(np.uint64)
            )[:u]
            nv, ns = np_correct_unique(uniq, allow, L)
            lv, ls = lax_correct_unique(uniq, allow, L)
            np.testing.assert_array_equal(nv, lv)
            np.testing.assert_array_equal(ns, ls)

    def test_length_over_16_rejected_on_device_path(self):
        with pytest.raises(ValueError, match="<= 16"):
            lax_correct_unique(
                np.array([1], np.uint64), np.array([1], np.uint64), 17
            )

    def test_wide_values_fall_back_to_numpy(self):
        # malformed: a value with hi bits set despite length<=16 must not
        # be silently truncated by the u32 device path
        wide = np.uint64(1) << np.uint64(40)
        allow = np.sort(np.array([5, int(wide)], np.uint64))
        fixed, st = correct_batch(
            np.array([int(wide), 5], np.uint64), allow, 16
        )
        assert st.tolist() == [EXACT, EXACT]
        assert fixed.tolist() == [int(wide), 5]


class TestCorrectFile:
    def _write(self, path, bc_seqs, L):
        n = len(bc_seqs)
        recs = make_records(
            _pack(bc_seqs),
            np.arange(n, dtype=np.uint64),
            np.arange(n, dtype=np.uint64),
        )
        h = Header.new(L, 6)
        with Writer.from_path(str(path), h) as w:
            w.write_batch(recs)
        return str(path)

    def test_end_to_end_counts_and_values(self, tmp_path):
        from ibu_jax.pipelines import correct_file

        allow_seqs = ["AAAA", "CCCC", "GGGG"]
        reads = [
            "AAAA",  # exact
            "AAAT",  # -> AAAA
            "CCCC",  # exact
            "GCCC",  # -> CCCC
            "TTTT",  # no neighbor -> drop
            "ACCC",  # -> CCCC (distance 1 of CCCC only; AAAA is 3 away)
        ]
        p = self._write(tmp_path / "in.ibu", reads, 4)
        out = str(tmp_path / "out.ibu")
        stats = correct_file(p, out, _pack(allow_seqs))
        assert stats == {
            "records": 6, "exact": 2, "corrected": 3, "dropped": 1,
            "allowlist": 3,
        }
        r = MmapReader(out)
        got = C.decode_seqs(np.asarray(r.records)["barcode"], 4)
        assert got == ["AAAA", "AAAA", "CCCC", "CCCC", "CCCC"]
        # indices of kept records preserved
        np.testing.assert_array_equal(
            np.asarray(r.records)["index"], [0, 1, 2, 3, 5]
        )

    def test_keep_unmatched_passthrough(self, tmp_path):
        from ibu_jax.pipelines import correct_file

        p = self._write(tmp_path / "in.ibu", ["TTTT", "AAAT"], 4)
        out = str(tmp_path / "o.ibu")
        stats = correct_file(p, out, _pack(["AAAA"]), keep_unmatched=True)
        assert stats["dropped"] == 1 and len(MmapReader(out)) == 2
        got = C.decode_seqs(np.asarray(MmapReader(out).records)["barcode"], 4)
        assert got == ["TTTT", "AAAA"]

    def test_sorted_flag_reflects_observed_order(self, tmp_path):
        from ibu_jax.pipelines import correct_file

        # output comes out sorted here (all map to AAAA, indices ascend)
        p = self._write(tmp_path / "s.ibu", ["AAAT", "AAAA", "AATA"], 4)
        out = str(tmp_path / "so.ibu")
        correct_file(p, out, _pack(["AAAA"]))
        assert MmapReader(out).header().sorted()
        # and unsorted when correction breaks barcode order
        p2 = self._write(tmp_path / "u.ibu", ["CCCC", "AAAA"], 4)
        out2 = str(tmp_path / "uo.ibu")
        correct_file(p2, out2, _pack(["AAAA", "CCCC"]))
        assert not MmapReader(out2).header().sorted()

    def test_cli(self, tmp_path):
        p = self._write(tmp_path / "in.ibu", ["AAAA", "AAAT", "TTTT"], 4)
        allow = tmp_path / "allow.txt"
        allow.write_text("AAAA\n")
        out = str(tmp_path / "out.ibu")
        r = subprocess.run(
            [sys.executable, "-m", "ibu_jax", "correct", p, out,
             "--barcodes", str(allow)],
            capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        assert "1 exact, 1 corrected, 1 dropped of 3 records" in r.stdout
        assert len(MmapReader(out)) == 2
