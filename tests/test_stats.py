"""Stats kernel tests: exact u64 checksums, device sort, barcode histogram."""

import jax.numpy as jnp
import numpy as np
import pytest

from ibu_jax import sort_records
from ibu_jax.constructs.record import make_records
from ibu_jax.ops.stats import (
    barcode_histogram,
    barcode_histogram_np,
    checksum_records_np,
    checksum_soa,
    field_sums_soa,
    fold_limbs,
    limb_sums,
    sort_records_soa,
)
from ibu_jax.ops.u64 import records_from_soa, soa_from_records, split_u64
from tests.conftest import make_records_arange


def random_records(n, seed=0, bc_space=None):
    rng = np.random.default_rng(seed)
    bc = rng.integers(0, bc_space or (1 << 63), n, dtype=np.uint64)
    umi = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    idx = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    return make_records(bc, umi, idx)


class TestChecksum:
    def test_limb_sums_small(self):
        x = np.array([1, 2, 3], dtype=np.uint64)
        lo, hi = split_u64(x)
        assert fold_limbs(np.asarray(limb_sums(jnp.asarray(lo), jnp.asarray(hi)))) == 6

    def test_carry_propagation_max_values(self):
        """Sums crossing every 16-bit limb boundary stay exact."""
        x = np.full(100_000, 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)
        lo, hi = split_u64(x)
        got = fold_limbs(np.asarray(limb_sums(jnp.asarray(lo), jnp.asarray(hi))))
        want = (100_000 * 0xFFFFFFFFFFFFFFFF) & 0xFFFFFFFFFFFFFFFF
        assert got == want

    def test_checksum_vs_oracle_random(self):
        records = random_records(200_001, seed=3)
        got = checksum_soa(soa_from_records(records))
        assert got == checksum_records_np(records)

    def test_checksum_closed_form(self):
        """The reference benchmark's methodology (mmap.rs:454-481)."""
        n = 10_000
        records = make_records_arange(n)
        s = n * (n - 1) // 2
        assert checksum_soa(soa_from_records(records)) == (s, 2 * s, 3 * s)

    def test_empty(self):
        records = make_records_arange(0)
        assert checksum_soa(soa_from_records(records)) == (0, 0, 0)

    def test_field_sums_linear_mergeable(self):
        """Shard partials add elementwise — the psum merge contract."""
        a, b = random_records(5000, 1), random_records(5000, 2)
        pa = np.asarray(field_sums_soa(jnp.asarray(soa_from_records(a))))
        pb = np.asarray(field_sums_soa(jnp.asarray(soa_from_records(b))))
        merged = pa + pb
        both = np.concatenate([a, b])
        want = checksum_records_np(both)
        got = tuple(fold_limbs(merged[i]) for i in range(3))
        assert got == want


class TestDeviceSort:
    def test_matches_host_sort(self):
        records = random_records(4096, seed=5, bc_space=16)  # force ties
        got = records_from_soa(
            np.asarray(sort_records_soa(jnp.asarray(soa_from_records(records))))
        )
        want = sort_records(records)
        assert np.array_equal(got, want)

    def test_unsigned_order_u64_max(self):
        records = make_records(
            np.array([0xFFFFFFFFFFFFFFFF, 0, 0x8000000000000000], dtype=np.uint64),
            np.zeros(3, dtype=np.uint64),
            np.zeros(3, dtype=np.uint64),
        )
        got = records_from_soa(
            np.asarray(sort_records_soa(jnp.asarray(soa_from_records(records))))
        )
        assert got["barcode"].tolist() == [0, 0x8000000000000000, 0xFFFFFFFFFFFFFFFF]


class TestHistogram:
    def test_matches_oracle(self):
        records = random_records(10_000, seed=7, bc_space=100)
        soa = jnp.asarray(soa_from_records(records))
        u_lo, u_hi, counts, n_uniq = barcode_histogram(soa, max_uniques=256)
        want = barcode_histogram_np(records)
        assert int(n_uniq) == len(want)
        got = {}
        for i in range(int(n_uniq)):
            key = int(u_lo[i]) | (int(u_hi[i]) << 32)
            got[key] = int(counts[i])
        assert got == want

    def test_counts_sum_to_n(self):
        records = random_records(5_000, seed=8, bc_space=50)
        soa = jnp.asarray(soa_from_records(records))
        _, _, counts, _ = barcode_histogram(soa, max_uniques=128)
        assert int(np.asarray(counts).sum()) == 5_000

    def test_bc_len_hint_matches_unhinted(self):
        records = random_records(4_097, seed=9, bc_space=64)
        soa = jnp.asarray(soa_from_records(records))
        base = [
            np.asarray(x) for x in barcode_histogram(soa, max_uniques=128)
        ]
        hinted = [
            np.asarray(x)
            for x in barcode_histogram(soa, max_uniques=128, bc_len=16)
        ]
        for a, b in zip(base, hinted):
            np.testing.assert_array_equal(a, b)


class TestHintedSort:
    """sort_records_soa hints: drop provably-zero hi words from the sort."""

    def _random_soa(self, n, bc_bits, umi_bits, idx_bits, seed=0):
        import jax.numpy as jnp

        rng = np.random.default_rng(seed)
        from ibu_jax.constructs.record import make_records
        from ibu_jax.ops.u64 import soa_from_records

        records = make_records(
            rng.integers(0, 1 << bc_bits, n, dtype=np.uint64),
            rng.integers(0, 1 << umi_bits, n, dtype=np.uint64),
            rng.integers(0, 1 << idx_bits, n, dtype=np.uint64),
        )
        return jnp.asarray(soa_from_records(records)), records

    def test_hinted_matches_full_sort(self):
        import numpy.lib.recfunctions  # noqa: F401

        soa, records = self._random_soa(5000, 31, 23, 32, seed=40)
        full = np.asarray(sort_records_soa(soa))
        hinted = np.asarray(
            sort_records_soa(soa, bc_len=16, umi_len=12, index_bits=32)
        )
        assert np.array_equal(full, hinted)
        want = np.sort(records, order=("barcode", "umi", "index"))
        from ibu_jax.ops.u64 import records_from_soa

        assert np.array_equal(records_from_soa(hinted), want)

    def test_partial_hints(self):
        soa, records = self._random_soa(3000, 60, 20, 40, seed=41)
        got = np.asarray(sort_records_soa(soa, bc_len=32, umi_len=10))
        from ibu_jax.ops.u64 import records_from_soa

        want = np.sort(records, order=("barcode", "umi", "index"))
        assert np.array_equal(records_from_soa(got), want)

    def test_violated_hint_raises(self):
        soa, _ = self._random_soa(1000, 60, 20, 20, seed=42)  # bc > 32 bits
        with pytest.raises(ValueError, match="barcode hi"):
            sort_records_soa(soa, bc_len=16)

    def test_violated_index_hint_raises(self):
        soa, _ = self._random_soa(1000, 20, 20, 50, seed=43)
        with pytest.raises(ValueError, match="index hi"):
            sort_records_soa(soa, index_bits=32)

    def test_check_false_skips_validation(self):
        soa, _ = self._random_soa(100, 60, 20, 20, seed=44)
        # no raise (and garbage order is accepted) when check is disabled
        sort_records_soa(soa, bc_len=16, check=False)

    def test_all_max_lo_tie_with_sentinel(self):
        """Records whose kept key words are all-max tie with the pow2 pad
        sentinel; reconstruction must still produce the exact multiset."""
        import jax.numpy as jnp

        from ibu_jax.constructs.record import make_records
        from ibu_jax.ops.u64 import records_from_soa, soa_from_records

        m = np.uint64(0xFFFFFFFF)  # lo word all-ones, hi zero
        records = make_records(
            np.array([m, 1, m], dtype=np.uint64),
            np.array([m, 2, m], dtype=np.uint64),
            np.array([m, 3, 7], dtype=np.uint64),
        )  # n=3 pads to 4 with an all-max sentinel
        got = records_from_soa(
            np.asarray(
                sort_records_soa(
                    jnp.asarray(soa_from_records(records)),
                    bc_len=16, umi_len=16, index_bits=32,
                )
            )
        )
        want = np.sort(records, order=("barcode", "umi", "index"))
        assert np.array_equal(got, want)


class TestSortJitRestriction:
    def test_checked_hints_under_jit_raise_clearly(self):
        """check=True with hints needs a host sync; under an outer jit it
        must raise a clear ValueError, not TracerArrayConversionError
        (ADVICE r1). check=False stays fully traceable."""
        import jax
        import jax.numpy as jnp

        from ibu_jax.ops.stats import sort_records_soa

        soa = jnp.zeros((6, 8), jnp.uint32)

        @jax.jit
        def bad(x):
            return sort_records_soa(x, bc_len=8, check=True)

        with pytest.raises(ValueError, match="cannot be traced"):
            bad(soa)

        @jax.jit
        def good(x):
            return sort_records_soa(x, bc_len=8, check=False)

        assert good(soa).shape == (6, 8)
