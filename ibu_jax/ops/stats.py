"""Device-side statistics kernels: checksums, sorting, histograms.

These replace the reference's per-record accumulation processors (the
``ParallelProcessor`` examples that sum fields or count barcodes —
``/root/reference/examples/parallel.rs:22-35``,
``/root/reference/src/io/mmap.rs:350-372``) with batch kernels over the
``(6, N) uint32`` column layout (:mod:`ibu_jax.ops.u64`).

Exact u64 arithmetic in 32-bit JAX
----------------------------------
JAX runs without 64-bit types by default, so exact mod-2^64 field sums use
a two-level u16-limb pyramid in pure uint32:

* level 1: each u64 value is 4 u16 limbs; the record axis is chunked into
  65,536-record blocks, so per-chunk limb sums stay < 2^32 — exact;
* level 2: chunk sums are split into u16 halves and summed again, exact
  while the **global** record count is < 2^32 (~4.3 G records, ~103 GB).

The resulting ``(4, 2) uint32`` partials are linear, so they can be merged
with ``jax.lax.psum`` across a device mesh (the collective replacement for
the reference's ``Arc<Mutex>`` merge) and folded to a Python int on the
host. Beyond 2^32 records, merge per-shard totals hierarchically host-side.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_CHUNK = 65536  # level-1 chunk: max records per exact u32 limb sum


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def limb_sums(lo: jax.Array, hi: jax.Array) -> jax.Array:
    """Exact sum of ``(lo, hi)`` u32-pair values as ``(4, 2) uint32`` limbs.

    Output ``[k, 0]``/``[k, 1]`` are the low/high u16 halves of the total of
    u16-limb ``k`` (limb 0 = bits 0-15 ... limb 3 = bits 48-63). Jittable,
    total, and ``psum``-mergeable (see module docstring for the capacity
    bound). Fold with :func:`fold_limbs`.
    """
    n = lo.shape[0]
    limbs = jnp.stack(
        [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16]
    ).astype(jnp.uint32)  # (4, N)
    m = _cdiv(max(n, 1), _CHUNK)
    padded = m * _CHUNK
    if padded != n:
        limbs = jnp.pad(limbs, ((0, 0), (0, padded - n)))
    chunked = limbs.reshape(4, m, _CHUNK)
    level1 = jnp.sum(chunked, axis=2, dtype=jnp.uint32)  # (4, M) exact
    level2 = jnp.stack(
        [
            jnp.sum(level1 & 0xFFFF, axis=1, dtype=jnp.uint32),
            jnp.sum(level1 >> 16, axis=1, dtype=jnp.uint32),
        ],
        axis=1,
    )  # (4, 2) exact while global N < 2^32
    return level2


def fold_limbs(level2) -> int:
    """Fold a ``(4, 2)`` limb-sum array to the exact mod-2^64 total."""
    level2 = np.asarray(level2, dtype=np.uint64)
    total = 0
    for k in range(4):
        limb_total = int(level2[k, 1]) * 65536 + int(level2[k, 0])
        total += limb_total << (16 * k)
    return total & 0xFFFFFFFFFFFFFFFF


@jax.jit
def field_sums_soa(soa: jax.Array) -> jax.Array:
    """Per-field limb sums of a ``(6, N)`` column matrix → ``(3, 4, 2)``
    uint32 (barcode, umi, index). The device equivalent of the reference
    benchmark's three-field checksum (``examples/parallel.rs:22-35``)."""
    return jnp.stack(
        [
            limb_sums(soa[0], soa[1]),
            limb_sums(soa[2], soa[3]),
            limb_sums(soa[4], soa[5]),
        ]
    )


def checksum_soa(soa) -> tuple[int, int, int]:
    """Exact (barcode_sum, umi_sum, index_sum) mod 2^64 of a column matrix."""
    sums = np.asarray(field_sums_soa(jnp.asarray(soa)))
    return tuple(fold_limbs(sums[i]) for i in range(3))


def checksum_records_np(records: np.ndarray) -> tuple[int, int, int]:
    """Host oracle for :func:`checksum_soa` over a structured record array."""
    return tuple(
        int(records[f].sum(dtype=object)) & 0xFFFFFFFFFFFFFFFF
        for f in ("barcode", "umi", "index")
    )


# ---------------------------------------------------------------------------
# device-side record sort
# ---------------------------------------------------------------------------


def _pad_pow2_max(soa: jax.Array) -> tuple[jax.Array, int]:
    """Pad the record axis to the next power of two with all-max sentinel
    records (which sort last in unsigned order, so slicing the head back
    off is exact). Power-of-two sort shapes avoid a severe XLA sort
    compile/runtime pathology observed at odd sizes (100k-record sorts
    taking minutes vs ~1 s)."""
    n = soa.shape[1]
    npad = 1 << max(0, (n - 1).bit_length())
    if npad != n:
        pad = jnp.full((soa.shape[0], npad - n), 0xFFFFFFFF, dtype=soa.dtype)
        soa = jnp.concatenate([soa, pad], axis=1)
    return soa, n


@functools.partial(jax.jit, static_argnames=("hi_used",))
def _sort_soa_impl(soa: jax.Array, hi_used: tuple[bool, bool, bool]) -> jax.Array:
    """Variadic record sort with statically-dropped known-zero hi words.

    ``hi_used[k]`` says whether field ``k``'s (barcode, umi, index) hi word
    participates; dropped words are reconstructed as zeros in the output.
    Every dropped operand removes a comparator word AND a full column of
    sort traffic (tools/sort_lab.py times the operand counts).
    """
    soa, n = _pad_pow2_max(soa)
    ops: list[jax.Array] = []
    slots: list[int | None] = []  # operand index for soa rows [lo,hi]*3
    for field in range(3):
        lo, hi = soa[2 * field], soa[2 * field + 1]
        if hi_used[field]:
            hi_slot = len(ops)
            ops.append(hi)  # hi sorts before lo (unsigned u64 order)
        lo_slot = len(ops)
        ops.append(lo)
        slots.extend([lo_slot, hi_slot if hi_used[field] else None])
    srt = jax.lax.sort(tuple(ops), num_keys=len(ops))
    zeros = jnp.zeros_like(srt[0])
    out = jnp.stack([zeros if s is None else srt[s] for s in slots])
    return out[:, :n]


def sort_records_soa(
    soa: jax.Array,
    bc_len: int | None = None,
    umi_len: int | None = None,
    index_bits: int | None = None,
    check: bool = True,
) -> jax.Array:
    """Lexicographic (barcode, umi, index) sort of a ``(6, N)`` column matrix
    — the device equivalent of ``Record``'s derived ``Ord``
    (``record.rs:29-32``). Unsigned u64 order falls out of sorting the hi
    word before the lo word of each field.

    Optional hints shrink the sort: ``bc_len``/``umi_len`` (the header's
    base counts — ≤16 bases means the field's hi word is zero by
    construction) and ``index_bits`` (a caller bound on index magnitude,
    e.g. 32 when indices are record numbers of a <4.3G-record batch) drop
    provably-zero words from the comparator, each saving a full column of
    sort traffic. With
    no hints this is the exact full-width sort. ``check=True`` verifies
    dropped words really are all-zero on device (one tiny sync; raises
    ``ValueError`` on a violated hint instead of silently mis-sorting).

    Jit note: the hint verification is a host-side sync, so ``check=True``
    with hints cannot run under an outer ``jax.jit`` (a clear ``ValueError``
    is raised rather than jax's opaque ``TracerArrayConversionError``).
    Inside jit, pass ``check=False`` (caller-verified hints) or no hints.
    """
    hi_used = (
        bc_len is None or bc_len > 16,
        umi_len is None or umi_len > 16,
        index_bits is None or index_bits > 32,
    )
    if check and not all(hi_used) and isinstance(soa, jax.core.Tracer):
        raise ValueError(
            "sort_records_soa(check=True) with hints verifies the hints on "
            "the host and cannot be traced under jit; pass check=False "
            "(with caller-verified hints) or drop the hints"
        )
    if check and not all(hi_used):
        import numpy as np  # local: host sync point

        dropped = [2 * f + 1 for f in range(3) if not hi_used[f]]
        nz = np.asarray(_any_nonzero_rows(soa, tuple(dropped)))
        if nz.any():
            names = ["barcode", "umi", "index"]
            bad = [names[dropped[i] // 2] for i in np.nonzero(nz)[0]]
            raise ValueError(
                f"sort hint violated: {', '.join(bad)} hi word(s) contain "
                "nonzero bits; fix the bc_len/umi_len/index_bits hints"
            )
    return _sort_soa_impl(soa, hi_used)


@functools.partial(jax.jit, static_argnames=("rows",))
def _any_nonzero_rows(soa: jax.Array, rows: tuple[int, ...]) -> jax.Array:
    return jnp.stack([jnp.any(soa[r] != 0) for r in rows])


# ---------------------------------------------------------------------------
# per-barcode histogram
# ---------------------------------------------------------------------------


def _changed_flags(rows: list) -> jax.Array:
    """Position-i "any of these rows differs from position i-1" flags,
    with position 0 always flagged (segment-boundary construction)."""
    npad = rows[0].shape[0]
    first = jnp.ones((npad,), dtype=jnp.bool_)
    if npad > 1:
        f = None
        for r in rows:
            g = r[1:] != r[:-1]
            f = g if f is None else f | g
        first = first.at[1:].set(f)
    return first


def _sorted_barcode_groups(
    key_rows: list, n_group_rows: int, n: int, max_uniques: int
):
    """Shared scaffolding for barcode-grouped device aggregations —
    scatter-free (the formulation that took the shard histogram 47 → 140+
    Mrec/s; see :func:`ibu_jax.parallel.device._masked_histogram`).

    ``key_rows`` are sort-key columns most-significant first; the first
    ``n_group_rows`` (1 = lo word only under a ≤16-base hint, 2 = hi+lo)
    form the group key. Pow2-pads every key with the all-max sentinel and
    sorts STABLY, so real records occupy exactly positions ``[0, n)`` of
    the sorted order (pads are appended after the reals, and stability
    keeps genuine all-max records ahead of them). Group segments come
    from monotonic segment ids; per-slot segment bounds from two
    ``searchsorted`` binary searches, clipped to the valid region —
    table-sized gathers, no record-sized scatters, no weights payload in
    the sort.

    Returns ``(sorted_rows, bc_first, s, e, unique_lo, unique_hi,
    num_unique)``: ``s``/``e`` are each slot's valid-record bounds
    (``e - s`` = records in that group segment), and ``num_unique`` is
    the TRUE distinct-group count of the real records; callers MUST
    treat ``num_unique > max_uniques`` as overflow (slots past capacity
    were dropped).
    """
    npad = 1 << max(0, (n - 1).bit_length())  # pow2 sort shapes (see above)
    if npad != n:
        padk = jnp.full((npad - n,), 0xFFFFFFFF, jnp.uint32)
        key_rows = [jnp.concatenate([k, padk]) for k in key_rows]
    sorted_rows = list(
        jax.lax.sort(tuple(key_rows), num_keys=len(key_rows), is_stable=True)
    )
    bc_first = _changed_flags(sorted_rows[:n_group_rows])
    seg_ids = jnp.cumsum(bc_first.astype(jnp.int32)) - 1  # monotonic (Npad,)
    slots = jnp.arange(max_uniques, dtype=jnp.int32)
    starts = jnp.searchsorted(seg_ids, slots, side="left")
    ends = jnp.searchsorted(seg_ids, slots, side="right")
    s = jnp.minimum(starts.astype(jnp.int32), n)
    e = jnp.minimum(ends.astype(jnp.int32), n)
    at = jnp.minimum(starts, npad - 1)
    valid = e > s
    unique_lo = jnp.where(valid, sorted_rows[n_group_rows - 1][at], 0)
    unique_hi = (
        jnp.where(valid, sorted_rows[0][at], 0)
        if n_group_rows == 2
        else jnp.zeros((max_uniques,), jnp.uint32)
    )
    # distinct groups among the real records: they occupy [0, n) of the
    # stable sort, so the last real record's segment id caps the count
    num_unique = (
        seg_ids[n - 1] + 1 if n > 0 else jnp.int32(0)
    )
    return sorted_rows, bc_first, s, e, unique_lo, unique_hi, num_unique


def _prefix_count_at(flags: jax.Array):
    """Inclusive-cumsum reader for segment-bound difference counting:
    returns ``f(pos) = sum(flags[:pos])`` built on one cumsum + gathers."""
    cum = jnp.cumsum(flags.astype(jnp.int32))
    return lambda pos: jnp.where(pos > 0, cum[jnp.maximum(pos - 1, 0)], 0)


@functools.partial(jax.jit, static_argnames=("max_uniques", "bc_len"))
def barcode_histogram(
    soa: jax.Array, max_uniques: int, bc_len: int | None = None
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Count records per unique barcode.

    Static-shape (jit-friendly) contract: returns
    ``(unique_lo, unique_hi, counts, num_unique)`` where the first three are
    padded to ``max_uniques`` entries (tail zeroed) and ``num_unique`` is the
    scalar number of valid entries. Sorts on device, then segments runs —
    replacing the reference pattern of a host hash map per thread.
    Per-barcode counts are segment-bound differences (scatter-free).

    ``bc_len ≤ 16`` (CALLER-VERIFIED, e.g. from the file header) drops the
    provably-zero barcode hi word from the sort — the hinted-sort trick
    (``sort_records_soa``); a violated hint silently mis-groups.
    """
    n = soa.shape[1]
    rows = ([soa[1]] if bc_len is None or bc_len > 16 else []) + [soa[0]]
    _, _, s, e, unique_lo, unique_hi, num_unique = _sorted_barcode_groups(
        rows, len(rows), n, max_uniques
    )
    counts = (e - s).astype(jnp.uint32)
    return unique_lo, unique_hi, counts, num_unique


def barcode_histogram_np(records: np.ndarray) -> dict[int, int]:
    """Host oracle: barcode → count."""
    vals, counts = np.unique(records["barcode"], return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


# ---------------------------------------------------------------------------
# UMI deduplication (molecule counting)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("max_uniques", "bc_len", "umi_len")
)
def molecule_counts(
    soa: jax.Array,
    max_uniques: int,
    bc_len: int | None = None,
    umi_len: int | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Distinct ``(barcode, umi)`` pairs per barcode — UMI deduplication.

    Reads sharing a (barcode, UMI) pair are PCR duplicates of one
    molecule; the per-barcode count of DISTINCT pairs is the standard
    single-cell molecule count. Beyond the reference's capability set
    (it stops at raw records), built from the same device primitives as
    :func:`barcode_histogram`: one sort over (bc, umi) words,
    pair-boundary flags, and a pair-first cumsum difference at each
    barcode segment's bounds (scatter-free).

    ``bc_len``/``umi_len`` ≤ 16 (CALLER-VERIFIED, e.g. from the file
    header) drop the provably-zero hi words from the sort — the
    hinted-sort trick; a violated hint silently mis-groups.

    Static-shape contract mirrors :func:`barcode_histogram`: returns
    ``(unique_lo, unique_hi, mol_counts, num_unique)`` padded to
    ``max_uniques`` barcodes; ``num_unique > max_uniques`` means overflow
    (entries were dropped) and callers MUST check.
    """
    n = soa.shape[1]
    bc_rows = ([soa[1]] if bc_len is None or bc_len > 16 else []) + [soa[0]]
    umi_rows = ([soa[3]] if umi_len is None or umi_len > 16 else []) + [soa[2]]
    sorted_rows, bc_first, s, e, unique_lo, unique_hi, num_unique = (
        _sorted_barcode_groups(
            bc_rows + umi_rows, len(bc_rows), n, max_uniques
        )
    )
    pair_first = bc_first | _changed_flags(sorted_rows[len(bc_rows):])
    pf_at = _prefix_count_at(pair_first)
    mol = jnp.where(e > s, pf_at(e) - pf_at(s), 0).astype(jnp.uint32)
    return unique_lo, unique_hi, mol, num_unique


def molecule_counts_np(records: np.ndarray) -> dict[int, int]:
    """Host oracle: barcode → number of distinct (barcode, umi) pairs."""
    pairs = np.unique(
        np.stack([records["barcode"], records["umi"]], axis=1), axis=0
    )
    vals, counts = np.unique(pairs[:, 0], return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


# ---------------------------------------------------------------------------
# count matrix: distinct-triple counts per (barcode, index) pair
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("max_pairs", "bc_len", "umi_len", "index_bits"),
)
def pair_molecule_counts(
    soa: jax.Array,
    max_pairs: int,
    bc_len: int | None = None,
    umi_len: int | None = None,
    index_bits: int | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Distinct ``(barcode, umi, index)`` triples per ``(barcode, index)``
    pair — the device kernel under :func:`ibu_jax.pipelines.count_matrix`.

    One 6-key sort orders records by (barcode, index, umi); pair segments
    come from the first four sorted keys, triple-first flags from all six,
    and each pair's molecule count is a cumulative-triple-count difference
    at the pair's segment bounds (scatter-free — binary-searched bounds +
    gathers instead of segment_sum/.at[].set; see
    :func:`ibu_jax.parallel.device._masked_histogram` for the measured
    3-6x). Static-shape contract like :func:`barcode_histogram`: returns
    ``(bc_lo, bc_hi, idx_lo, idx_hi, counts)`` stacked as
    ``(pair_keys (4, max_pairs), counts (max_pairs,), num_pairs scalar)``
    — concretely ``(pair_rows, counts, num_pairs)`` where ``pair_rows`` is
    ``(4, max_pairs) uint32`` ordered [bc_lo, bc_hi, idx_lo, idx_hi];
    ``num_pairs > max_pairs`` means overflow (entries dropped) and callers
    MUST check.
    """
    n = soa.shape[1]
    # sort keys most-significant first: bc (hi, lo), idx (hi, lo), umi
    # (hi, lo) — this orders by the (barcode, index, umi) triple, with
    # CALLER-VERIFIED hints (≤16-base fields / index_bits ≤ 32) dropping
    # provably-zero hi words from the comparator. Pow2 padding uses
    # all-max sentinel keys; stability keeps real all-max records (input
    # prefix) before the sentinels, so valid records occupy exactly
    # positions [0, n) of the sorted order.
    bc_hi = bc_len is None or bc_len > 16
    umi_hi = umi_len is None or umi_len > 16
    idx_hi = index_bits is None or index_bits > 32
    key_rows = (
        ([soa[1]] if bc_hi else [])
        + [soa[0]]
        + ([soa[5]] if idx_hi else [])
        + [soa[4]]
    )
    n_pair_rows = len(key_rows)
    key_rows += ([soa[3]] if umi_hi else []) + [soa[2]]
    npad = 1 << max(0, (n - 1).bit_length())
    if npad != n:
        padk = jnp.full((npad - n,), 0xFFFFFFFF, jnp.uint32)
        key_rows = [jnp.concatenate([k, padk]) for k in key_rows]
    srt = jax.lax.sort(
        tuple(key_rows), num_keys=len(key_rows), is_stable=True
    )

    pair_first = _changed_flags(srt[:n_pair_rows])
    triple_first = _changed_flags(srt)  # pair change implies triple change
    seg_ids = jnp.cumsum(pair_first.astype(jnp.int32)) - 1  # monotonic
    # scatter-free compaction (see parallel/device._masked_histogram): per
    # capacity slot, segment bounds via binary search, clipped to the
    # valid region
    slots = jnp.arange(max_pairs, dtype=jnp.int32)
    starts = jnp.searchsorted(seg_ids, slots, side="left")
    ends = jnp.searchsorted(seg_ids, slots, side="right")
    s = jnp.minimum(starts.astype(jnp.int32), n)
    e = jnp.minimum(ends.astype(jnp.int32), n)
    # distinct triples in [s, e): inclusive-cumsum difference; s is always
    # a triple_first position (a pair change implies a triple change)
    tf_at = _prefix_count_at(triple_first)
    counts = jnp.where(e > s, tf_at(e) - tf_at(s), 0).astype(jnp.uint32)
    at = jnp.minimum(starts, npad - 1)
    zeros = jnp.zeros((max_pairs,), jnp.uint32)
    bc_lo_i = 1 if bc_hi else 0
    idx_lo_i = n_pair_rows - 1
    pair_rows = jnp.stack(
        [
            jnp.where(counts > 0, srt[bc_lo_i][at], 0),  # bc_lo
            jnp.where(counts > 0, srt[0][at], 0) if bc_hi else zeros,
            jnp.where(counts > 0, srt[idx_lo_i][at], 0),  # idx_lo
            (
                jnp.where(counts > 0, srt[idx_lo_i - 1][at], 0)
                if idx_hi
                else zeros
            ),
        ]
    )
    num_pairs = jnp.where(
        n > 0, seg_ids[jnp.maximum(n - 1, 0)] + 1, jnp.int32(0)
    )
    return pair_rows, counts, num_pairs


def pair_molecule_counts_np(records: np.ndarray) -> dict:
    """Host oracle: (barcode, index) → distinct (barcode, umi, index)
    triples."""
    triples = np.unique(
        np.stack(
            [records["barcode"], records["umi"], records["index"]], axis=1
        ),
        axis=0,
    )
    pairs, counts = np.unique(triples[:, [0, 2]], axis=0, return_counts=True)
    return {
        (int(b), int(i)): int(c) for (b, i), c in zip(pairs.tolist(), counts)
    }
