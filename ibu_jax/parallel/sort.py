"""Distributed record sort over the device mesh (sample sort).

The reference sorts with ``Record``'s derived ``Ord`` on one host
(``/root/reference/src/constructs/record.rs:29-32``); the single-device
port (:func:`ibu_jax.ops.stats.sort_records_soa`) keeps that shape. This
module is the device scale-out: a **sample sort** over the 1-D
``"dp"`` mesh, so ``sort``/``dedup``/``count`` use every chip and a file
larger than one device's memory sorts without falling back to the host C++
external merge (``native/ibu_native.cpp``).

One jitted ``shard_map`` program per (mesh, shape, hints):

1. **local sort** — each shard sorts its block with the hinted variadic
   comparator (provably-zero hi words dropped, same rules as
   ``sort_records_soa``); invalid rows masked to the all-max sentinel;
2. **splitters** — each shard contributes ``Q`` regularly-spaced sample
   keys, ``all_gather`` + sort, take ``S-1`` equally-spaced splitters.
   Samples carry a per-shard POSITION word as the last comparator word:
   duplicate-heavy keys (the dedup workload) are split by position, so a
   hot barcode spreads over shards instead of flooding one;
3. **partition** — the local block is already sorted, so each
   destination's records are ONE contiguous range (two ``searchsorted``
   calls on the monotone destination vector — no scatter); ranges are
   ``dynamic_slice``d into a fixed ``(S, C_send)`` send buffer;
4. **exchange** — ``lax.all_to_all`` of the send buffer and counts;
   the collective rides the device interconnect on a real mesh;
5. **merge** — received blocks, masked by their counts, sort locally;
   every shard ends with a globally-ordered contiguous run (shard ``d``
   holds keys ``(splitter_{d-1}, splitter_d]``).

Static shapes throughout: the per-(src,dst) capacity is
``C_send = local_n / S * slack`` (default slack 2.0 — sampled splitters
keep the imbalance far below that). A range exceeding ``C_send`` is
detected ON DEVICE and raised host-side with the remedy (raise ``slack``).

Input records are DEALT to shards by stride (shard ``i`` holds positions
``i, i+S, i+2S, …`` — one vectorized host transpose) rather than split
contiguously: a contiguous split of an already-sorted file would route
every shard's whole block to a single destination (each shard's keys span
exactly one splitter interval), overflowing any sub-``local_n`` exchange
capacity. The stride deal makes every shard a uniform positional sample
of the key range, so per-destination sends stay near ``local_n / S`` for
ANY input order.

Sentinel note: invalid rows are masked to all-max in every retained key
word. A GENUINE all-max record is bit-identical to the sentinel in those
words (and its dropped hi words are zero by the verified hints, exactly
what reconstruction emits), so sentinel/record mixing inside the final
tie group is value-exact — the same argument as the pow2 sentinel padding
in :func:`ibu_jax.ops.stats._pad_pow2_max`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ibu_jax.constructs.record import RECORD_DTYPE
from ibu_jax.parallel.device import AXIS, make_mesh

shard_map = jax.shard_map

_MAX = jnp.uint32(0xFFFFFFFF)

#: bounded program cache, keyed by (mesh, local_n, c_send, samples, hints)
_SORT_PROGRAM_CACHE: dict = {}
_SORT_PROGRAM_CACHE_MAX = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _lex_gt(words_a: list, words_b: list) -> jax.Array:
    """Vectorized lexicographic ``a > b``; word lists most-significant
    first (broadcastable shapes)."""
    gt = None
    eq = None
    for wa, wb in zip(words_a, words_b):
        g = wa > wb
        e = wa == wb
        if gt is None:
            gt, eq = g, e
        else:
            gt = gt | (eq & g)
            eq = eq & e
    return gt


def _key_slots(hi_used: tuple[bool, bool, bool]):
    """Retained soa-row indices, most-significant first, per field:
    [bc_hi?, bc_lo, umi_hi?, umi_lo, idx_hi?, idx_lo]."""
    slots = []
    for field in range(3):
        if hi_used[field]:
            slots.append(2 * field + 1)  # hi word sorts first
        slots.append(2 * field)
    return slots


def _pad_pow2(rows: list, fill) -> tuple[list, int]:
    n = rows[0].shape[0]
    npad = 1 << max(0, (n - 1).bit_length())
    if npad != n:
        pad = jnp.full((npad - n,), fill, rows[0].dtype)
        rows = [jnp.concatenate([r, pad]) for r in rows]
    return rows, npad


def _build_sort_program(
    mesh: Mesh,
    mesh_key,
    local_n: int,
    c_send: int,
    n_samples: int,
    hi_used: tuple[bool, bool, bool],
):
    key = (mesh_key, local_n, c_send, n_samples, hi_used)
    if key in _SORT_PROGRAM_CACHE:
        return _SORT_PROGRAM_CACHE[key]

    s = mesh.devices.size
    slots = _key_slots(hi_used)
    k = len(slots)

    def local_fn(raw_local, valid_local):
        soa = raw_local.T  # (6, local_n) device-side transpose
        n_valid = valid_local[0].astype(jnp.int32)

        # 1. local hinted sort, invalid rows masked to the sentinel
        valid = jnp.arange(local_n, dtype=jnp.int32) < n_valid
        rows = [jnp.where(valid, soa[r], _MAX) for r in slots]
        rows, npad = _pad_pow2(rows, _MAX)
        srt = list(jax.lax.sort(tuple(rows), num_keys=k))
        pos = jnp.arange(npad, dtype=jnp.uint32)  # duplicate tiebreak

        # 2. splitters from regularly-spaced samples (+ position word).
        # Position math: (k * n_valid) // m computed as
        # k*(n_valid//m) + k*(n_valid%m)//m — algebraically identical but
        # every intermediate stays < n_valid, where the naive product
        # k*n_valid wraps int32 once local_n exceeds ~2^31/(2q) ≈ 4.2M
        # records/shard (inside the advertised file-size range; jax
        # int64 is disabled by default so casting up is not an option)
        q = n_samples
        m = 2 * q
        k_odd = 2 * jnp.arange(q, dtype=jnp.int32) + 1  # k < m
        samp_at = jnp.clip(
            k_odd * (n_valid // m) + (k_odd * (n_valid % m)) // m,
            0,
            npad - 1,
        )
        samples = jnp.stack(
            [r[samp_at] for r in srt] + [samp_at.astype(jnp.uint32)]
        )  # (k+1, q); empty shards sample the sentinel (sorts last)
        gathered = jax.lax.all_gather(samples, AXIS, axis=1, tiled=True)
        g_sorted = jax.lax.sort(
            tuple(gathered[i] for i in range(k + 1)), num_keys=k + 1
        )
        sp_at = (jnp.arange(s - 1, dtype=jnp.int32) + 1) * q
        splitters = [row[sp_at] for row in g_sorted]  # (k+1) rows, (s-1,)

        # 3. destination of every record; monotone because the block is
        # sorted, so each destination's records are one contiguous range
        key_words = srt + [pos]
        dest = jnp.zeros((npad,), jnp.int32)
        for d in range(s - 1):
            dest = dest + _lex_gt(
                key_words, [sp[d] for sp in splitters]
            ).astype(jnp.int32)
        targets = jnp.arange(s, dtype=jnp.int32)
        starts = jnp.minimum(
            jnp.searchsorted(dest, targets, side="left").astype(jnp.int32),
            n_valid,
        )
        ends = jnp.minimum(
            jnp.searchsorted(dest, targets, side="right").astype(jnp.int32),
            n_valid,
        )
        counts = ends - starts  # (s,)
        overflow = jnp.any(counts > c_send)

        # 4. fixed-capacity send buffer: one dynamic_slice per dest; the
        # extra c_send sentinel columns make every slice in-bounds
        padded = [
            jnp.concatenate([r, jnp.full((c_send,), _MAX, jnp.uint32)])
            for r in srt
        ]
        send = jnp.stack(
            [
                jnp.stack(
                    [
                        jax.lax.dynamic_slice_in_dim(
                            padded[w], starts[d], c_send
                        )
                        for w in range(k)
                    ]
                )
                for d in range(s)
            ]
        )  # (s, k, c_send)
        recv = jax.lax.all_to_all(
            send, AXIS, split_axis=0, concat_axis=0, tiled=True
        )  # (s, k, c_send): row j = block sent by shard j
        rcnt = jax.lax.all_to_all(
            counts, AXIS, split_axis=0, concat_axis=0, tiled=True
        )  # (s,): rcnt[j] = valid rows in block j

        # 5. mask rows beyond each block's count, then the merge sort
        within = jnp.arange(c_send, dtype=jnp.int32)[None, :]  # (1, c_send)
        inval = within >= rcnt[:, None]  # (s, c_send)
        rows2 = [
            jnp.where(inval, _MAX, recv[:, w, :]).reshape(s * c_send)
            for w in range(k)
        ]
        rows2, npad2 = _pad_pow2(rows2, _MAX)
        srt2 = jax.lax.sort(tuple(rows2), num_keys=k)
        out_valid = jnp.sum(rcnt, dtype=jnp.int32)

        # reconstruct the 6 wire words (dropped hi words are zero beyond
        # out_valid too — the host slices the valid prefix anyway)
        zeros = jnp.zeros((s * c_send,), jnp.uint32)
        out_rows = []
        for r in range(6):
            if r in slots:
                w = srt2[slots.index(r)][: s * c_send]
                out_rows.append(
                    jnp.where(
                        jnp.arange(s * c_send) < out_valid, w, 0
                    ).astype(jnp.uint32)
                )
            else:
                out_rows.append(zeros)
        out_raw = jnp.stack(out_rows).T  # (s*c_send, 6) wire layout
        return out_raw, out_valid[None], overflow[None]

    program = jax.jit(
        shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS)),
            out_specs=(P(AXIS, None), P(AXIS), P(AXIS)),
            check_vma=False,
        )
    )
    if len(_SORT_PROGRAM_CACHE) >= _SORT_PROGRAM_CACHE_MAX:
        _SORT_PROGRAM_CACHE.pop(next(iter(_SORT_PROGRAM_CACHE)))
    _SORT_PROGRAM_CACHE[key] = program
    return program


def _shape_bucket(n: int) -> int:
    """Round a shard width up to the next ``{2^k, 1.5*2^k}`` bucket.

    The compiled sort program is keyed by ``local_n`` (and the derived
    ``c_send``); without bucketing every distinct file size compiles a
    fresh program, which takes tens of seconds or more.
    Bucketed widths make the in-process program cache AND the persistent
    XLA compile cache hit across nearby sizes, at <=33% padding — and the
    in-program sorts pad to the next pow2 anyway, so the dominant stage
    costs exactly the same.
    """
    if n <= 64:
        return 64
    k = (n - 1).bit_length()  # 2^(k-1) < n <= 2^k
    mid = (1 << (k - 1)) + (1 << (k - 2))
    return mid if n <= mid else 1 << k


def _deal_to_shards(records: np.ndarray, mesh: Mesh):
    """Place records stride-dealt over the mesh (module docstring):
    shard ``i`` gets positions ``i, i+S, …`` so every shard uniformly
    samples the key range regardless of input order. Returns
    ``(dev_raw, dev_valid, local_n)``; each shard's valid rows are a
    prefix (padding positions ``>= n`` land at the tail of every shard).
    ``local_n`` is bucketed (:func:`_shape_bucket`) so recompiles are
    per-bucket, not per-file-size; the kernel masks the extra padding by
    the per-shard valid counts exactly like any short shard.
    """
    from ibu_jax.parallel.device import as_raw_u32, default_placer

    s = mesh.devices.size
    raw = as_raw_u32(np.asarray(records))
    b = raw.shape[0]
    local_n = _shape_bucket(_cdiv(max(b, 1), s))
    padded = local_n * s
    if padded != b:
        raw = np.concatenate(
            [raw, np.zeros((padded - b, 6), dtype=np.uint32)]
        )
    dealt = np.ascontiguousarray(
        raw.reshape(local_n, s, 6).transpose(1, 0, 2)
    ).reshape(padded, 6)
    base, rem = b // s, b % s
    valid = (base + (np.arange(s) < rem)).astype(np.int32)
    dev_raw = default_placer(dealt, mesh, P(AXIS, None))
    dev_valid = default_placer(valid, mesh, P(AXIS))
    return dev_raw, dev_valid, local_n


def _verify_hints_host(records: np.ndarray, hi_used) -> None:
    names = ["barcode", "umi", "index"]
    bad = []
    for f in range(3):
        if not hi_used[f]:
            col = records[names[f]]
            if len(col) and int(col.max()) > 0xFFFFFFFF:
                bad.append(names[f])
    if bad:
        raise ValueError(
            f"sort hint violated: {', '.join(bad)} hi word(s) contain "
            "nonzero bits; fix the bc_len/umi_len/index_bits hints"
        )


def sharded_sort_records(
    records: np.ndarray,
    mesh: Mesh | None = None,
    bc_len: int | None = None,
    umi_len: int | None = None,
    index_bits: int | None = None,
    check: bool = True,
    slack: float = 2.0,
    samples_per_shard: int = 256,
) -> np.ndarray:
    """Lexicographic (barcode, umi, index) sort of a structured record
    array, distributed over the mesh (sample sort — module docstring).

    Hints follow :func:`ibu_jax.ops.stats.sort_records_soa`: header base
    counts ≤16 / ``index_bits`` ≤32 drop provably-zero hi words from every
    comparator; ``check=True`` verifies them host-side (one pass over the
    hinted columns) and raises on violation instead of mis-sorting.

    Raises ``ValueError`` if a shard's send range overflows the
    ``slack``-sized exchange capacity (extremely skewed splitters —
    retry with a larger ``slack``).
    """
    mesh = mesh or make_mesh()
    hi_used = (
        bc_len is None or bc_len > 16,
        umi_len is None or umi_len > 16,
        index_bits is None or index_bits > 32,
    )
    if check and not all(hi_used):
        _verify_hints_host(records, hi_used)

    s = mesh.devices.size
    dev_raw, dev_valid, local_n = _deal_to_shards(records, mesh)
    c_send = min(max(64, int(_cdiv(local_n, s) * slack)), local_n)
    mesh_key = (mesh.axis_names, tuple(d.id for d in mesh.devices.flat))
    program = _build_sort_program(
        mesh, mesh_key, local_n, c_send, samples_per_shard, hi_used
    )
    out_raw, out_valid, overflow = program(dev_raw, dev_valid)
    if bool(np.any(np.asarray(overflow))):
        raise ValueError(
            "sharded sort exchange overflow: a shard's range exceeded "
            f"c_send={c_send} (slack={slack}); retry with a larger slack"
        )
    counts = np.asarray(out_valid)
    raw_host = np.asarray(out_raw)  # (s * s*c_send, 6)
    per = raw_host.shape[0] // s
    parts = [
        raw_host[d * per : d * per + int(counts[d])] for d in range(s)
    ]
    wire = np.ascontiguousarray(np.concatenate(parts))
    return wire.view(RECORD_DTYPE).reshape(-1)


def sort_file_mesh(
    in_path: str,
    out_path: str,
    mesh: Mesh | None = None,
    index_bits: int | None = None,
    slack: float = 2.0,
) -> "Header":
    """Sorted rewrite of an IBU file using the mesh sample sort.

    The multi-chip sibling of :func:`ibu_jax.pipelines.sort_file_device`:
    the file is placed sharded over the mesh (each device holds 1/S), so
    files up to the MESH's total device memory sort on device. Header hints are
    host-verified exactly like the single-device path.
    """
    from ibu_jax.constructs.header import Header
    from ibu_jax.io.mmap import MmapReader
    from ibu_jax.io.writer import Writer
    from ibu_jax.pipelines import _require_plain

    _require_plain(in_path, "sort")
    reader = MmapReader(in_path)
    header = reader.header()
    records = np.asarray(reader.records)
    if index_bits is None:
        idx_hi = records["index"] >> np.uint64(32)
        index_bits = 32 if not idx_hi.any() else None
    sorted_records = sharded_sort_records(
        records,
        mesh=mesh,
        bc_len=header.bc_len,
        umi_len=header.umi_len,
        index_bits=index_bits,
        slack=slack,
    )
    out_header = Header.new(header.bc_len, header.umi_len)
    out_header.flags = header.flags
    out_header.set_sorted()
    with Writer.from_path(out_path, out_header) as w:
        w.write_batch(sorted_records)
    return out_header
