"""Barcode error correction against an allowlist (Hamming distance ≤ 1).

The standard step between cell filtering and UMI deduplication in the
BUS-style pipelines the IBU format feeds (the reference stops at raw
records; ``/root/reference/README.md:12`` positions the format in exactly
this workflow). Policy is the common one (CellRanger-style, simplified):

* a barcode already in the allowlist is kept (**exact**);
* otherwise, if exactly ONE allowlist entry lies at Hamming distance 1
  (one substituted base), the barcode is rewritten to it (**corrected**);
* otherwise (no neighbor, or several — ambiguous) the record is dropped.

Design: sequencing batches repeat barcodes heavily, so the
expensive search runs over the batch's UNIQUE barcodes only (host
``np.unique``), and each unique probes the sorted allowlist with a
vectorized binary search — one ``searchsorted`` for exact hits plus one
over the ``3L`` single-substitution variants (``bc XOR (d << 2i)`` in the
packed 2-bit domain, ``d ∈ {1,2,3}``). No per-record Python anywhere;
records map through the corrected unique table by one more
``searchsorted``. The device path (:func:`lax_correct_unique`) runs the
probe matrix under ``jit`` in the u32 domain (barcodes of ≤ 16 bases — the
common 10x case — pack into the lo word); longer barcodes take the numpy
u64 path, which is also the test oracle.

Status codes: 0 = drop (unmatched or ambiguous), 1 = exact, 2 = corrected.
"""

from __future__ import annotations

import functools

import numpy as np

#: status codes shared by every implementation
DROP, EXACT, CORRECTED = 0, 1, 2


def variant_deltas(length: int, dtype=np.uint64) -> np.ndarray:
    """XOR deltas of all ``3 * length`` single-base substitutions.

    In the 2-bit packing (base ``i`` at bits ``2i``,
    ``/root/reference/src/constructs/record.rs:19-27``) substituting base
    ``i`` XORs a nonzero 2-bit value ``d`` into that field; distinct
    ``(i, d)`` yield distinct deltas, so variants of one barcode never
    collide with each other.
    """
    if not 1 <= length <= 32:
        raise ValueError(f"barcode length {length} outside 1..=32")
    i = np.arange(length, dtype=dtype)
    d = np.arange(1, 4, dtype=dtype)
    return (d[:, None] << (2 * i)[None, :]).reshape(-1)


def np_correct_unique(
    uniq: np.ndarray, allow_sorted: np.ndarray, length: int
) -> tuple[np.ndarray, np.ndarray]:
    """Correct UNIQUE packed barcodes against a sorted allowlist (numpy).

    Returns ``(corrected_values, status)`` aligned with ``uniq``; dropped
    entries keep their original value with status ``DROP``.
    """
    uniq = np.asarray(uniq, dtype=np.uint64)
    allow_sorted = np.asarray(allow_sorted, dtype=np.uint64)
    k = len(allow_sorted)
    out = uniq.copy()
    status = np.zeros(len(uniq), dtype=np.uint8)
    if k == 0 or len(uniq) == 0:
        return out, status
    pos = np.searchsorted(allow_sorted, uniq)
    exact = (pos < k) & (allow_sorted[np.minimum(pos, k - 1)] == uniq)
    status[exact] = EXACT

    miss = ~exact
    if miss.any():
        var = uniq[miss, None] ^ variant_deltas(length)[None, :]  # (M, 3L)
        vpos = np.searchsorted(allow_sorted, var.reshape(-1))
        hit = (vpos < k) & (
            allow_sorted[np.minimum(vpos, k - 1)] == var.reshape(-1)
        )
        hit = hit.reshape(var.shape)
        nhits = hit.sum(axis=1)
        one = nhits == 1
        # the unique hit's column; rows with one==False are ignored
        col = hit.argmax(axis=1)
        fixed = var[np.arange(len(var)), col]
        midx = np.flatnonzero(miss)
        out[midx[one]] = fixed[one]
        status[midx[one]] = CORRECTED
    return out, status


@functools.lru_cache(maxsize=1)
def _lax_correct_jit():
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("length",))
    def impl(uniq, allow_sorted, length):
        k = allow_sorted.shape[0]
        deltas = jnp.asarray(
            variant_deltas(length, dtype=np.uint32), jnp.uint32
        )
        pos = jnp.clip(jnp.searchsorted(allow_sorted, uniq), 0, k - 1)
        exact = allow_sorted[pos] == uniq
        var = uniq[:, None] ^ deltas[None, :]  # (U, 3L)
        vpos = jnp.clip(
            jnp.searchsorted(allow_sorted, var.reshape(-1)), 0, k - 1
        )
        hit = (allow_sorted[vpos] == var.reshape(-1)).reshape(var.shape)
        nhits = jnp.sum(hit, axis=1)
        col = jnp.argmax(hit, axis=1)
        fixed = jnp.take_along_axis(var, col[:, None], axis=1)[:, 0]
        one = (~exact) & (nhits == 1)
        out = jnp.where(exact, uniq, jnp.where(one, fixed, uniq))
        status = (
            exact.astype(jnp.uint8) * EXACT + one.astype(jnp.uint8) * CORRECTED
        )
        return out, status

    return impl


def lax_correct_unique(
    uniq: np.ndarray, allow_sorted: np.ndarray, length: int
) -> tuple[np.ndarray, np.ndarray]:
    """Device path of :func:`np_correct_unique` for barcodes of ≤ 16 bases
    (values fit the u32 lo word; the hi word is provably zero).

    Pads the unique set to a power of two (recompile-free across batch
    diversity) and runs the whole probe matrix in one jitted dispatch.
    """
    import jax.numpy as jnp

    if length > 16:
        raise ValueError(
            "lax_correct_unique handles lengths <= 16 (u32 domain); "
            "use np_correct_unique"
        )
    uniq = np.asarray(uniq, dtype=np.uint64)
    allow_sorted = np.asarray(allow_sorted, dtype=np.uint64)
    if len(allow_sorted) == 0 or len(uniq) == 0:
        return uniq.copy(), np.zeros(len(uniq), dtype=np.uint8)
    u = len(uniq)
    upad = 1 << max(0, (u - 1).bit_length())
    uniq32 = uniq.astype(np.uint32)
    if upad != u:
        # pad with the last value: harmless duplicates, sliced off below
        uniq32 = np.concatenate(
            [uniq32, np.full(upad - u, uniq32[-1], np.uint32)]
        )
    kpad = 1 << max(0, (len(allow_sorted) - 1).bit_length())
    allow32 = allow_sorted.astype(np.uint32)
    if kpad != len(allow32):
        # pad with the max value: keeps the array sorted; a real barcode
        # equal to the pad value still matches correctly (equality decides)
        allow32 = np.concatenate(
            [allow32, np.full(kpad - len(allow32), allow32[-1], np.uint32)]
        )
    out32, status = _lax_correct_jit()(
        jnp.asarray(uniq32), jnp.asarray(allow32), length
    )
    return (
        np.asarray(out32)[:u].astype(np.uint64),
        np.asarray(status)[:u],
    )


def correct_batch(
    barcodes: np.ndarray,
    allow_sorted: np.ndarray,
    length: int,
    use_device: bool | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Correct a full barcode column: unique → probe → map back.

    Returns ``(corrected_barcodes, status)`` aligned with ``barcodes``
    (dropped entries keep their value, status ``DROP``). ``use_device``
    ``None`` picks the jitted path when the barcode fits 16 bases.
    """
    barcodes = np.asarray(barcodes, dtype=np.uint64)
    allow_sorted = np.asarray(allow_sorted, dtype=np.uint64)
    uniq, inverse = np.unique(barcodes, return_inverse=True)
    if use_device is None:
        use_device = length <= 16
    # the u32 device path needs every value to actually fit 32 bits; a
    # malformed file (or an allowlist wider than the header claims) falls
    # back to the u64 numpy path instead of silently truncating
    fits32 = (len(uniq) == 0 or not uniq[-1] >> np.uint64(32)) and (
        len(allow_sorted) == 0 or not allow_sorted[-1] >> np.uint64(32)
    )
    fn = (
        lax_correct_unique
        if (use_device and length <= 16 and fits32)
        else np_correct_unique
    )
    fixed, status = fn(uniq, allow_sorted, length)
    return fixed[inverse], status[inverse]
