"""2-bit nucleotide codec — numpy reference and jax.lax implementations.

The reference delegates this codec to the external ``bitnuc`` crate; the
format contract is documented at
``/root/reference/src/constructs/record.rs:19-27``: A=00, C=01, G=10, T=11,
base *i* stored at bits ``2i`` of the packed word, ≤32 bases per ``u64``.

Encoding trick (branch-free, one VPU pass): for ASCII ``c`` in
``ACGTacgt``, ``t = (c >> 1) & 3`` yields A→0, C→1, G→3, T→2 (case
insensitive), and the 2-bit Gray code ``t ^ (t >> 1)`` permutes that to the
table order A→0, C→1, G→2, T→3. The Gray map is an involution, which also
powers the decoder.

Decoding: ``code → ASCII`` via the arithmetic select
``65 + 2*code + 2*(code>>1) + 11*(code & (code>>1))`` (offsets 0/2/6/19 →
'A','C','G','T'), avoiding gathers entirely.

Two layouts are supported:

* **base-planes** ``(L, N)``: the device layout, with the record axis
  contiguous so that every base row is one coalesced stream;
* row-major ``(N, L)`` helpers for host interop.

The ``lax_*`` functions are jittable and total (no data-dependent control
flow). They are the device codec on every backend; XLA fuses each into
loops of a shift and a mask per byte. PERF.md records how they compare with
a copy of the same bytes on the GPU, and why no hand-written kernel is kept.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ibu_jax.ops.u64 import join_u64, split_u64

_VALID_BASES = np.frombuffer(b"ACGTacgt", dtype=np.uint8)


# ---------------------------------------------------------------------------
# numpy reference (host oracle)
# ---------------------------------------------------------------------------


def np_encode_codes(ascii_arr: np.ndarray) -> np.ndarray:
    """ASCII uint8 → 2-bit codes (same shape)."""
    t = (ascii_arr >> 1) & 3
    return t ^ (t >> 1)


def np_decode_ascii(codes: np.ndarray) -> np.ndarray:
    """2-bit codes → uppercase ASCII uint8 (same shape)."""
    codes = codes.astype(np.uint8)
    return (
        65 + 2 * codes + 2 * (codes >> 1) + 11 * (codes & (codes >> 1))
    ).astype(np.uint8)


#: 256-entry validity LUT: one gather + all() instead of np.isin's
#: sort/search machinery (np.isin measured as the top ingest cost once
#: parsing went native — ~10x slower than the table gather)
_VALID_LUT = np.zeros(256, dtype=bool)
_VALID_LUT[[ord(c) for c in "ACGTacgt"]] = True


def np_validate_ascii(ascii_arr: np.ndarray) -> None:
    """Raise ``ValueError`` naming the first invalid character."""
    ok = _VALID_LUT[ascii_arr]
    if not ok.all():
        bad = np.argwhere(~ok)
        pos = tuple(int(v) for v in bad[0])
        ch = int(ascii_arr[pos])
        raise ValueError(
            f"invalid nucleotide {chr(ch)!r} (0x{ch:02x}) at position {pos}; "
            "expected one of ACGTacgt"
        )


def np_pack(ascii_rows: np.ndarray, validate: bool = False) -> np.ndarray:
    """``(N, L)`` ASCII → ``(N,)`` uint64 packed words (host reference)."""
    if validate:
        np_validate_ascii(ascii_rows)
    codes = np_encode_codes(ascii_rows).astype(np.uint64)
    L = ascii_rows.shape[1]
    shifts = (2 * np.arange(L, dtype=np.uint64))[None, :]
    return np.bitwise_or.reduce(codes << shifts, axis=1)


def np_unpack(words: np.ndarray, length: int) -> np.ndarray:
    """``(N,)`` uint64 → ``(N, L)`` uppercase ASCII (host reference)."""
    shifts = (2 * np.arange(length, dtype=np.uint64))[None, :]
    codes = (words[:, None] >> shifts) & np.uint64(3)
    return np_decode_ascii(codes)


# -- string conveniences (bitnuc-style API parity) -------------------------


def seqs_to_rows(seqs: list[str]) -> np.ndarray:
    """List of equal-length sequences → ``(N, L)`` ASCII uint8."""
    if not seqs:
        return np.zeros((0, 0), dtype=np.uint8)
    L = len(seqs[0])
    for s in seqs:
        if len(s) != L:
            raise ValueError(f"ragged sequence lengths: {len(s)} != {L}")
    return np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8).reshape(
        len(seqs), L
    )


def rows_to_seqs(rows: np.ndarray) -> list[str]:
    """``(N, L)`` ASCII uint8 → list of strings."""
    return [bytes(r).decode("ascii") for r in rows]


def encode_seqs(seqs: list[str], validate: bool = True) -> np.ndarray:
    """Sequences → packed uint64 words (host API, ≤32 bases each).

    >>> encode_seqs(["A", "C", "G", "T"]).tolist()
    [0, 1, 2, 3]
    >>> encode_seqs(["ACGT"]).tolist()  # base i at bits 2i: 0+4+32+192
    [228]
    >>> encode_seqs(["acgt"]).tolist() == encode_seqs(["ACGT"]).tolist()
    True
    """
    rows = seqs_to_rows(seqs)
    if rows.shape[1] > 32:
        raise ValueError(f"sequence length {rows.shape[1]} exceeds 32 bases")
    return np_pack(rows, validate=validate)


def decode_seqs(words: np.ndarray, length: int) -> list[str]:
    """Packed uint64 words → uppercase sequences of ``length`` bases.

    >>> import numpy as np
    >>> decode_seqs(np.array([228], dtype=np.uint64), 4)
    ['ACGT']
    """
    return rows_to_seqs(np_unpack(np.asarray(words, dtype=np.uint64), length))


# -- layout conversion ------------------------------------------------------


def rows_to_planes(rows: np.ndarray) -> np.ndarray:
    """``(N, L)`` row-major → ``(L, N)`` base-planes (device layout)."""
    return np.ascontiguousarray(rows.T)


def planes_to_rows(planes: np.ndarray) -> np.ndarray:
    """``(L, N)`` base-planes → ``(N, L)`` row-major."""
    return np.ascontiguousarray(np.asarray(planes).T)


def words_to_pair(words: np.ndarray) -> np.ndarray:
    """``(N,)`` uint64 → ``(2, N)`` uint32 [lo, hi] (device layout)."""
    lo, hi = split_u64(words)
    return np.stack([lo, hi])


def pair_to_words(pair: np.ndarray) -> np.ndarray:
    """``(2, N)`` uint32 [lo, hi] → ``(N,)`` uint64."""
    pair = np.asarray(pair)
    return join_u64(pair[0], pair[1])


# ---------------------------------------------------------------------------
# jax.lax implementation (the device codec)
# ---------------------------------------------------------------------------


def lax_encode_planes(planes: jax.Array) -> jax.Array:
    """``(L, N)`` ASCII uint8 → ``(2, N)`` uint32 packed [lo, hi].

    Total function: invalid characters produce garbage codes rather than
    errors (validation is host-side, pre-kernel — SURVEY.md §7 "hard parts":
    in-kernel code stays total).
    """
    L = planes.shape[0]
    if not 1 <= L <= 32:
        raise ValueError(f"base count {L} outside 1..=32")
    c = planes.astype(jnp.uint32)
    t = (c >> 1) & 3
    code = t ^ (t >> 1)  # (L, N)
    lo_rows = min(L, 16)
    sh_lo = 2 * jax.lax.broadcasted_iota(jnp.uint32, (lo_rows, 1), 0)
    lo = jnp.sum(code[:lo_rows] << sh_lo, axis=0, dtype=jnp.uint32)
    if L > 16:
        sh_hi = 2 * jax.lax.broadcasted_iota(jnp.uint32, (L - 16, 1), 0)
        hi = jnp.sum(code[16:] << sh_hi, axis=0, dtype=jnp.uint32)
    else:
        hi = jnp.zeros_like(lo)
    return jnp.stack([lo, hi])


def lax_decode_planes(pair: jax.Array, length: int) -> jax.Array:
    """``(2, N)`` uint32 [lo, hi] → ``(L, N)`` uppercase ASCII uint8."""
    if not 1 <= length <= 32:
        raise ValueError(f"base count {length} outside 1..=32")
    lo = pair[0:1]  # (1, N)
    hi = pair[1:2]
    lo_rows = min(length, 16)
    sh_lo = 2 * jax.lax.broadcasted_iota(jnp.uint32, (lo_rows, 1), 0)
    codes = (lo >> sh_lo) & 3
    if length > 16:
        sh_hi = 2 * jax.lax.broadcasted_iota(jnp.uint32, (length - 16, 1), 0)
        codes = jnp.concatenate([codes, (hi >> sh_hi) & 3], axis=0)
    return _codes_to_ascii(codes)


def _codes_to_ascii(codes: jax.Array) -> jax.Array:
    """Arithmetic 4-way select: 0/1/2/3 → 'A'/'C'/'G'/'T'."""
    return (
        65 + 2 * codes + 2 * (codes >> 1) + 11 * (codes & (codes >> 1))
    ).astype(jnp.uint8)


@jax.jit
def lax_encode_records(
    bc_planes: jax.Array, umi_planes: jax.Array, idx_pair: jax.Array
) -> jax.Array:
    """Fused record assembly: barcode and UMI planes ``(L, N)`` plus the
    index pair ``(2, N)`` → the ``(6, N) uint32`` device column matrix (rows
    per :mod:`ibu_jax.ops.u64`). The device form of the reference's write
    path ``Record::new`` + ``write_batch`` (``writer.rs:315-351``) with the
    codec fused in."""
    return jnp.concatenate(
        [lax_encode_planes(bc_planes), lax_encode_planes(umi_planes), idx_pair]
    )


@functools.partial(jax.jit, static_argnames=("bc_len", "umi_len"))
def lax_decode_records(
    soa: jax.Array, bc_len: int, umi_len: int
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """``(6, N) uint32`` columns → barcode planes, UMI planes and the index
    ``[lo, hi]`` pair: the inverse of :func:`lax_encode_records`."""
    return (
        lax_decode_planes(soa[0:2], bc_len),
        lax_decode_planes(soa[2:4], umi_len),
        soa[4:6],
    )
