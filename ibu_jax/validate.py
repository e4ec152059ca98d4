"""On-device validation matrix: oracle checks against the compiled program.

The CPU test suite checks the same device code compiled for the CPU; this
module re-runs the oracle comparisons against what XLA compiled for
whatever accelerator jax selected — catching compiled-code drift between
backends (integer wraparound, sort stability, masked tails). Nothing runs
in interpret mode.

``python chip_smoke.py`` runs it on the card, and ``python bench.py`` ships
its pass count with every benchmark record. Mirrors the reference's
tests-encode-the-truth stance (SURVEY §4;
``/root/reference/src/io/mmap.rs:454-481``).
"""

from __future__ import annotations

import numpy as np


def _random_rows(n, L, seed=0, lowercase=False):
    rng = np.random.default_rng(seed)
    al = np.frombuffer(b"acgt" if lowercase else b"ACGT", dtype=np.uint8)
    return al[rng.integers(0, 4, size=(n, L))]


def run_matrix(progress=None) -> list[tuple[str, bool]]:
    """Run every oracle check on the current default backend.

    Returns ``[(check_name, passed), ...]``. ``progress`` is an optional
    callable invoked with each result line as it lands (for streaming CLI
    output). Device code compiles through the persistent cache, so warm
    runs take seconds.
    """
    import jax
    import jax.numpy as jnp

    from ibu_jax.constructs.record import make_records
    from ibu_jax.ops import codec as C
    from ibu_jax.ops.stats import (
        barcode_histogram,
        barcode_histogram_np,
        checksum_records_np,
        checksum_soa,
        molecule_counts,
        molecule_counts_np,
        pair_molecule_counts,
        pair_molecule_counts_np,
        sort_records_soa,
    )
    from ibu_jax.ops.u64 import records_from_soa, soa_from_records

    encode_planes = jax.jit(C.lax_encode_planes)
    decode_planes = jax.jit(C.lax_decode_planes, static_argnums=1)

    results: list[tuple[str, bool]] = []

    def check(name: str, ok: bool) -> None:
        results.append((name, bool(ok)))
        if progress is not None:
            progress(f"{'PASS' if ok else 'FAIL'} {name}")

    # codec matrix: boundary lengths incl. the hi-word and bit-63 paths
    for L in (1, 15, 16, 17, 31, 32):
        rows = _random_rows(3000, L, seed=L)  # odd N: no power-of-two tail
        planes = jnp.asarray(C.rows_to_planes(rows))
        pair = encode_planes(planes)
        check(
            f"encode_planes L={L}",
            np.array_equal(C.pair_to_words(np.asarray(pair)), C.np_pack(rows)),
        )
        back = decode_planes(pair, L)
        check(
            f"decode_planes L={L}",
            np.array_equal(np.asarray(back), np.asarray(planes)),
        )

    # all-T 32-base: bit 63 set
    words = C.pair_to_words(
        np.asarray(
            encode_planes(jnp.asarray(np.full((32, 256), ord("T"), np.uint8)))
        )
    )
    check("bit63 all-T32", bool((words == 0xFFFFFFFFFFFFFFFF).all()))

    # lowercase
    rows = _random_rows(1000, 12, seed=9, lowercase=True)
    pair = encode_planes(jnp.asarray(C.rows_to_planes(rows)))
    check(
        "lowercase encode",
        np.array_equal(C.pair_to_words(np.asarray(pair)), C.np_pack(rows)),
    )

    # fused record codec
    n = 5000
    bc_rows = _random_rows(n, 16, seed=1)
    umi_rows = _random_rows(n, 12, seed=2)
    idx = np.arange(n, dtype=np.uint64) * np.uint64(11) + (
        np.uint64(1) << np.uint64(40)
    )  # hi index word in use
    soa = C.lax_encode_records(
        jnp.asarray(C.rows_to_planes(bc_rows)),
        jnp.asarray(C.rows_to_planes(umi_rows)),
        jnp.asarray(C.words_to_pair(idx)),
    )
    recs = records_from_soa(np.asarray(soa))
    check(
        "fused encode barcode",
        np.array_equal(recs["barcode"], C.np_pack(bc_rows)),
    )
    check("fused encode umi", np.array_equal(recs["umi"], C.np_pack(umi_rows)))
    check("fused encode index", np.array_equal(recs["index"], idx))

    bc_p, umi_p, idx_p = C.lax_decode_records(soa, 16, 12)
    check(
        "fused decode roundtrip",
        np.array_equal(C.planes_to_rows(np.asarray(bc_p)), bc_rows)
        and np.array_equal(C.planes_to_rows(np.asarray(umi_p)), umi_rows)
        and np.array_equal(C.pair_to_words(np.asarray(idx_p)), idx),
    )

    # device sort vs host sort (with ties)
    rng = np.random.default_rng(4)
    records = make_records(
        rng.integers(0, 32, 10_001, dtype=np.uint64),
        rng.integers(0, 32, 10_001, dtype=np.uint64),
        rng.integers(0, 1 << 63, 10_001, dtype=np.uint64),
    )
    got = records_from_soa(
        np.asarray(sort_records_soa(jnp.asarray(soa_from_records(records))))
    )
    check(
        "device sort",
        np.array_equal(got, np.sort(records, order=("barcode", "umi", "index"))),
    )

    # hinted sort (dropped hi words) — the common bc16/umi12/idx<2^32 case
    hinted_rec = make_records(
        rng.integers(0, 1 << 32, 10_001, dtype=np.uint64),
        rng.integers(0, 1 << 24, 10_001, dtype=np.uint64),
        rng.permutation(10_001).astype(np.uint64),
    )
    got_h = records_from_soa(
        np.asarray(
            sort_records_soa(
                jnp.asarray(soa_from_records(hinted_rec)),
                bc_len=16,
                umi_len=12,
                index_bits=32,
            )
        )
    )
    check(
        "device sort (hinted 3-op)",
        np.array_equal(
            got_h, np.sort(hinted_rec, order=("barcode", "umi", "index"))
        ),
    )

    # checksums (limb pyramid) at u64 extremes
    ext = make_records(
        np.full(70_000, 0xFFFFFFFFFFFFFFFF, dtype=np.uint64),
        rng.integers(0, 1 << 63, 70_000, dtype=np.uint64),
        np.arange(70_000, dtype=np.uint64),
    )
    check(
        "checksum extremes",
        checksum_soa(soa_from_records(ext)) == checksum_records_np(ext),
    )

    # histogram
    hrec = make_records(
        rng.integers(0, 300, 20_000, dtype=np.uint64),
        rng.integers(0, 1 << 40, 20_000, dtype=np.uint64),
        np.arange(20_000, dtype=np.uint64),
    )
    u_lo, u_hi, counts, n_uniq = barcode_histogram(
        jnp.asarray(soa_from_records(hrec)), max_uniques=1024
    )
    want = barcode_histogram_np(hrec)
    got_hist = {}
    counts_np = np.asarray(counts)
    for i in np.nonzero(counts_np)[0]:
        got_hist[int(u_lo[i]) | (int(u_hi[i]) << 32)] = int(counts_np[i])
    check("device histogram", got_hist == want and int(n_uniq) == len(want))

    # sorted-input histogram fast path (round 5): no per-shard sort;
    # in-kernel order verification must also fire on compiled kernels
    from ibu_jax.parallel.device import DeviceHistogram

    srec = np.sort(hrec, order=("barcode", "umi", "index"))
    hfast = DeviceHistogram(
        capacity=1024, max_uniques_per_shard=1024, assume_sorted=True
    )
    check("sorted histogram fast path", hfast.run(iter([srec])) == want)
    hlie = DeviceHistogram(
        capacity=1024, max_uniques_per_shard=1024, assume_sorted=True
    )
    hlie.update(hrec)  # unsorted data under the sorted claim
    try:
        hlie.finalize()
        check("sorted-path order detection", False)
    except ValueError:
        check("sorted-path order detection", True)

    # UMI dedup kernel: distinct (bc, umi) pairs per barcode
    mrec = make_records(
        rng.integers(0, 200, 30_000, dtype=np.uint64),
        rng.integers(0, 64, 30_000, dtype=np.uint64),
        rng.integers(0, 1 << 50, 30_000, dtype=np.uint64),
    )
    m_lo, m_hi, mol, m_uniq = molecule_counts(
        jnp.asarray(soa_from_records(mrec)), max_uniques=1024
    )
    m_want = molecule_counts_np(mrec)
    mol_np = np.asarray(mol)
    got_mol = {
        int(m_lo[i]) | (int(m_hi[i]) << 32): int(mol_np[i])
        for i in np.nonzero(mol_np)[0]
    }
    check(
        "device molecule counts",
        got_mol == m_want and int(m_uniq) == len(m_want),
    )

    # count-matrix kernel: distinct triples per (bc, idx) pair, with
    # full-u64-range barcodes/indices so the hi-word sort keys matter
    bpool = rng.integers(0, 1 << 64, 150, dtype=np.uint64)
    ipool = rng.integers(0, 1 << 64, 40, dtype=np.uint64)
    prec = make_records(
        bpool[rng.integers(0, 150, 20_000)],
        rng.integers(0, 16, 20_000, dtype=np.uint64),
        ipool[rng.integers(0, 40, 20_000)],
    )
    pair_rows, pcounts, num_pairs = pair_molecule_counts(
        jnp.asarray(soa_from_records(prec)), max_pairs=8192
    )
    p_want = pair_molecule_counts_np(prec)
    pc = np.asarray(pcounts)
    pr = np.asarray(pair_rows)
    got_pairs = {
        (
            int(pr[0, i]) | (int(pr[1, i]) << 32),
            int(pr[2, i]) | (int(pr[3, i]) << 32),
        ): int(pc[i])
        for i in np.nonzero(pc)[0]
    }
    check(
        "device pair molecule counts",
        got_pairs == p_want and int(num_pairs) == len(p_want),
    )

    return results
