"""Deterministic patterned-file generation shared by benchmarks/examples.

Every harness needs "write an n-record file whose field sums have closed
forms" (the reference's checksum-test methodology, ``mmap.rs:454-481``);
this is the single implementation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from ibu_jax.constructs.header import Header
from ibu_jax.constructs.record import make_records
from ibu_jax.io.writer import Writer

CHUNK = 4 * 1024 * 1024


def parallel_fields(i: np.ndarray):
    """barcode = i mod 1M, umi = 2i, index = i (the parallel-harness pattern:
    index sums to n(n-1)/2)."""
    return i % np.uint64(1_000_000), i * np.uint64(2), i


def roundtrip_fields(i: np.ndarray):
    """barcode = i mod 1M, umi = 31i mod 1M, index = i (the reference
    roundtrip pattern, ``examples/roundtrip.rs:33-39``)."""
    return (
        i % np.uint64(1_000_000),
        (i * np.uint64(31)) % np.uint64(1_000_000),
        i,
    )


def write_patterned_file(
    path: str,
    n: int,
    fields: Callable[[np.ndarray], tuple] = parallel_fields,
    header: Header | None = None,
    sorted_flag: bool = False,
    chunk: int = CHUNK,
) -> None:
    """Write ``n`` records whose fields are ``fields(arange-chunk)``."""
    if header is None:
        header = Header.new(16, 12)
    if sorted_flag:
        header.set_sorted()
    with Writer.from_path(path, header) as w:
        for s in range(0, n, chunk):
            m = min(chunk, n - s)
            i = np.arange(s, s + m, dtype=np.uint64)
            bc, umi, idx = fields(i)
            w.write_batch(make_records(bc, umi, idx))


class PlantedLibrary(NamedTuple):
    """A synthetic single-cell library whose answer is known.

    ``allowlist`` holds the planted cell barcodes (sorted, every pair at
    Hamming distance ≥ 3, so each one-base error corrects to exactly one
    cell). Per read: ``bc_rows``/``umi_rows`` are ASCII ``(N, L)`` rows
    (barcodes after error injection) and ``gene`` is the read's gene. The
    truth is the molecule count of every (cell barcode, gene) pair:
    ``truth_pairs`` ``(P, 2)`` uint64 rows sorted by (barcode, gene), and
    ``truth_counts``.
    """

    allowlist: np.ndarray
    bc_rows: np.ndarray
    umi_rows: np.ndarray
    gene: np.ndarray
    truth_pairs: np.ndarray
    truth_counts: np.ndarray


def _bases_differing(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Number of differing 2-bit bases between packed words (broadcasts)."""
    x = a ^ b
    x = (x | (x >> np.uint64(1))) & np.uint64(0x5555555555555555)
    x = (x & np.uint64(0x3333333333333333)) + (
        (x >> np.uint64(2)) & np.uint64(0x3333333333333333)
    )
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return (x * np.uint64(0x0101010101010101)) >> np.uint64(56)


def _spread_allowlist(rng, cells: int, bc_len: int) -> np.ndarray:
    """``cells`` distinct random barcodes, pairwise ≥ 3 bases apart."""
    space = 1 << (2 * bc_len)
    allow = rng.integers(0, space, cells, dtype=np.uint64)
    while True:
        bad = np.zeros(cells, dtype=bool)
        for i in range(0, cells, 1024):
            d = _bases_differing(allow[i:i + 1024, None], allow[None, :])
            d[np.arange(len(d)), i + np.arange(len(d))] = 3  # self
            bad[i:i + 1024] = (d < 3).any(axis=1)
        if not bad.any():
            return np.sort(allow)
        allow[bad] = rng.integers(0, space, int(bad.sum()), dtype=np.uint64)


def _unpack_rows(words: np.ndarray, length: int) -> np.ndarray:
    """Packed words → ``(N, length)`` ASCII rows, chunked to bound memory."""
    from ibu_jax.ops.codec import np_unpack

    out = np.empty((len(words), length), dtype=np.uint8)
    for s in range(0, len(words), CHUNK):
        out[s:s + CHUNK] = np_unpack(words[s:s + CHUNK], length)
    return out


def planted_library(
    rng: np.random.Generator,
    cells: int,
    genes: int,
    reads: int,
    error_rate: float,
    bc_len: int = 16,
    umi_len: int = 12,
) -> PlantedLibrary:
    """Draw reads from planted molecules, with single-base barcode errors.

    Each cell holds ``0.8 × reads / cells`` molecules, each a distinct UMI
    with a fixed gene; reads pick molecules uniformly, so molecules repeat
    (PCR duplicates) and some are never read. A ``error_rate`` share of the
    reads has exactly one barcode base changed. Every read of a molecule
    carries the same (cell, UMI, gene), so correction + dedup + count must
    reproduce the truth exactly.
    """
    per_cell = max(1, round(0.8 * reads / cells))
    if per_cell > 1 << (2 * umi_len):
        raise ValueError(f"{per_cell} molecules per cell exceed the "
                         f"{umi_len}-base UMI space")
    allow = _spread_allowlist(rng, cells, bc_len)
    mol = rng.integers(0, cells * per_cell, reads, dtype=np.uint64)
    cell = mol // np.uint64(per_cell)
    # odd multiplier: a bijection mod 4^umi_len, so a cell's UMIs differ
    umi = ((mol % np.uint64(per_cell)) * np.uint64(0x9E3779B1)) & np.uint64(
        (1 << (2 * umi_len)) - 1
    )

    def gene_of(m):  # a fixed gene per molecule
        return ((m * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33)) % (
            np.uint64(genes)
        )

    gene = gene_of(mol)
    seen = np.unique(mol)
    key = (seen // np.uint64(per_cell)) * np.uint64(genes) + gene_of(seen)
    uniq, truth_counts = np.unique(key, return_counts=True)
    truth_pairs = np.stack(
        [allow[uniq // np.uint64(genes)], uniq % np.uint64(genes)], axis=1
    )

    bc = allow[cell]
    del mol, cell
    nerr = int(error_rate * reads)
    pick = rng.choice(reads, size=nerr, replace=False)
    bc[pick] ^= rng.integers(1, 4, nerr, dtype=np.uint64) << (
        np.uint64(2) * rng.integers(0, bc_len, nerr, dtype=np.uint64)
    )
    return PlantedLibrary(
        allow, _unpack_rows(bc, bc_len), _unpack_rows(umi, umi_len), gene,
        truth_pairs, truth_counts.astype(np.int64),
    )


def pair_counts(
    a: np.ndarray, b: np.ndarray, weights: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Distinct ``(a, b)`` uint64 pairs, sorted, with their multiplicities
    (or summed ``weights``) — the form of :attr:`PlantedLibrary.truth_pairs`
    and ``truth_counts``."""
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    first = np.ones(len(a), dtype=bool)
    first[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    starts = np.flatnonzero(first)
    if weights is None:
        counts = np.diff(np.append(starts, len(a)))
    else:
        counts = np.add.reduceat(np.asarray(weights)[order], starts)
    return np.stack([a[starts], b[starts]], axis=1), counts.astype(np.int64)
