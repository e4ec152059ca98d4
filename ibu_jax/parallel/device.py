"""Device-mesh data-parallel engine.

The device re-design of the reference's parallel path
(``/root/reference/src/io/mmap.rs:286-332``): the two boundaries of the Rust
engine map onto device concepts —

* ``thread::spawn`` over mmap shards (``mmap.rs:310``) → a 1-D
  ``jax.sharding.Mesh`` with record batches sharded over the ``"dp"`` axis
  via ``shard_map``;
* the ``Arc<Mutex>`` / atomic merge in ``on_batch_complete``
  (``parallel.rs:162-164``) → ``jax.lax.psum`` over the device interconnect.

Shard partitioning mirrors the reference rule (contiguous, remainder to
last; see :func:`ibu_jax.parallel.host.partition`) at the host feeding
level, while on device every batch is split evenly (padding with records
that are no-ops for the running statistics, or masked via per-shard valid
counts).

The generic engine is :class:`MapReduce`; the flagship built-ins
(:func:`sharded_stats`, :func:`stream_file_stats`) compute record counts,
exact u64 field checksums, and per-barcode histograms over files of any
size with double-buffered host→device streaming.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

from ibu_jax.io.mmap import STREAM_BATCH_RECORDS, MmapReader
from ibu_jax.ops.stats import field_sums_soa, fold_limbs
from ibu_jax.ops.u64 import soa_from_records

AXIS = "dp"

#: compiled step cache per engine (weak: engines die, steps follow). Keyed
#: by the engine instance (frozen dataclass → value hash, so structurally
#: identical engines share compilations) then by mesh identity.
import weakref

_STEP_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def make_mesh(devices: list | None = None) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (AXIS,))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def default_placer(arr: np.ndarray, mesh: Mesh, spec: P) -> jax.Array:
    """Place a host array onto the mesh (single-process path).

    Multi-host engines substitute a placer built on
    ``jax.make_array_from_process_local_data`` (see
    :mod:`ibu_jax.parallel.multihost`).
    """
    return jax.device_put(arr, NamedSharding(mesh, spec))


def as_raw_u32(batch: np.ndarray, layout: str = "auto") -> np.ndarray:
    """Normalize a host batch to the raw ``(B, 6) uint32`` wire view.

    Accepts a structured record array (**zero-copy** — this is the exact
    byte layout of the file/mmap, so streaming does no host transform at
    all; the device transposes to columns inside the jitted step) or a
    ``(6, B) uint32`` column matrix (transposed on host; test convenience).

    ``layout``: ``"auto"`` (structured → wire; else a leading dim of 6 is
    read as columns — ambiguous only for a plain 6-record ``(6, 6)`` wire
    batch, where callers must pass ``layout="wire"`` or, preferably, a
    structured array), ``"wire"`` (``(B, 6)``), ``"columns"`` (``(6, B)``).
    """
    if batch.dtype.names is not None:  # structured records
        return np.ascontiguousarray(batch).view(np.uint32).reshape(-1, 6)
    if batch.ndim != 2:
        raise ValueError(f"unrecognized batch layout {batch.shape} {batch.dtype}")
    if layout == "wire" or (layout == "auto" and batch.shape[0] != 6):
        if batch.shape[1] != 6:
            raise ValueError(f"wire batch must be (B, 6), got {batch.shape}")
        return batch
    if layout in ("auto", "columns"):
        if batch.shape[0] != 6:
            raise ValueError(f"column batch must be (6, B), got {batch.shape}")
        return np.ascontiguousarray(batch.T)
    raise ValueError(f"unknown layout {layout!r}")


def bc16_hint(raw: np.ndarray) -> bool:
    """Data-verified "every barcode fits the lo u32 word" hint: one
    strided max over the wire view's bc_hi column. Padding rows are
    all-zero, so they never veto. Selects the 1-key shard-sort program
    in the histogram engines (collective-free, so per-process hint
    divergence on a multi-host mesh is safe)."""
    hi_col = raw[:, 1]
    return len(hi_col) == 0 or int(hi_col.max()) == 0


def shard_batch(
    batch: np.ndarray, mesh: Mesh, placer=default_placer
) -> tuple[jax.Array, jax.Array]:
    """Pad a host batch to an even device split and place it sharded over
    the mesh record-major. Returns ``(device_raw, valid_counts)`` where
    ``device_raw`` is ``(B_padded, 6) uint32`` sharded on its record axis
    and ``valid_counts[s]`` is the number of real (non-padding) records on
    shard ``s``. Padding records are all-zero. When ``B`` is already a
    multiple of the mesh size (every streamer batch except a file's last),
    placement is copy-free on the host.
    """
    raw = as_raw_u32(batch)
    s = mesh.devices.size
    b = raw.shape[0]
    per = _cdiv(max(b, 1), s)
    padded = per * s
    if padded != b:
        raw = np.concatenate(
            [raw, np.zeros((padded - b, 6), dtype=np.uint32)]
        )
    valid = np.minimum(
        np.maximum(b - per * np.arange(s), 0), per
    ).astype(np.int32)
    dev_raw = placer(raw, mesh, P(AXIS, None))
    dev_valid = placer(valid, mesh, P(AXIS))
    return dev_raw, dev_valid


@dataclass(frozen=True)
class MapReduce:
    """Generic sharded map-reduce over record batches.

    The batch-combinator distillation of the reference's
    ``ParallelProcessor`` contract (``parallel.rs:100-189``):

    * ``init()`` → per-shard state pytree (the thread-local accumulator);
    * ``update(state, soa_local, n_valid)`` → new state — jax-traceable and
      **total**; ``soa_local`` is the shard's ``(6, per)`` block, rows
      beyond ``n_valid`` are zero padding (mask if zeros aren't neutral
      for your statistic);
    * ``merge(states)`` → host-side merge of the ``(S, ...)`` stacked
      per-shard states (the ``on_batch_complete`` analogue; default:
      elementwise sum, the common linear-statistic case).
    """

    init: Callable[[], Any]
    update: Callable[[Any, jax.Array, jax.Array], Any]
    merge: Callable[[Any], Any] | None = None

    def compile_step(self, mesh: Mesh):
        """Jitted per-batch step: ``(states, raw, valid) -> states`` where
        ``states`` leaves are ``(S, ...)`` sharded over ``AXIS``, ``raw`` is
        ``(B, 6) uint32`` wire-layout records sharded on the record axis
        (the raw→column transpose happens on device, fused into the step),
        and ``valid`` is ``(S,)``.

        The jit object is cached per (engine, mesh): a fresh one per call
        would retrace AND recompile on every ``run`` — measured as the
        dominant cost of repeated ``stream_file_stats`` calls (jax caches
        compiled executables on function identity, which a fresh closure
        defeats)."""
        key = (mesh.axis_names, tuple(d.id for d in mesh.devices.flat))
        cache = _STEP_CACHE.setdefault(self, {})
        if key in cache:
            return cache[key]

        def local_step(state, raw_local, valid_local):
            soa_local = raw_local.T  # (6, per) columns, device-side
            unsq = jax.tree.map(lambda x: x[0], state)
            new = self.update(unsq, soa_local, valid_local[0])
            return jax.tree.map(lambda x: x[None], new)

        step = jax.jit(
            shard_map(
                local_step,
                mesh=mesh,
                in_specs=(P(AXIS), P(AXIS, None), P(AXIS)),
                out_specs=P(AXIS),
                check_vma=False,
            )
        )
        cache[key] = step
        return step

    def initial_states(self, mesh: Mesh, placer=default_placer) -> Any:
        """Per-shard initial states, broadcast and placed over the mesh."""
        s = mesh.devices.size
        return jax.tree.map(
            lambda x: placer(
                np.broadcast_to(np.asarray(x), (s,) + np.asarray(x).shape).copy(),
                mesh,
                P(AXIS),
            ),
            self.init(),
        )

    def finalize(self, states) -> Any:
        """Gather per-shard states to host and merge."""
        if jax.process_count() > 1:
            host_states = _gather_state_tree(states)
        else:
            host_states = jax.tree.map(np.asarray, states)
        if self.merge is None:
            return jax.tree.map(lambda x: x.sum(axis=0), host_states)
        return self.merge(host_states)

    def run(
        self,
        batches: Iterator[np.ndarray],
        mesh: Mesh | None = None,
        placer=default_placer,
    ) -> Any:
        """Fold ``update`` over host batches (structured records or ``(6,B)``
        columns), sharded on ``mesh`` (single-process path; multi-host
        drives :meth:`compile_step` directly — see
        :mod:`ibu_jax.parallel.multihost`)."""
        mesh = mesh or make_mesh()
        step = self.compile_step(mesh)
        states = self.initial_states(mesh, placer)
        for batch in batches:
            dev_raw, dev_valid = shard_batch(batch, mesh, placer)
            states = step(states, dev_raw, dev_valid)
        return self.finalize(states)

    def run_placed(self, placed: Iterator, mesh: Mesh | None = None) -> Any:
        """Fold ``update`` over already-placed ``(device_raw, valid)`` pairs
        (e.g. a prefetching :class:`ibu_jax.io.stream.DeviceStream`)."""
        mesh = mesh or make_mesh()
        step = self.compile_step(mesh)
        states = self.initial_states(mesh)
        for dev_raw, dev_valid in placed:
            states = step(states, dev_raw, dev_valid)
        return self.finalize(states)


# ---------------------------------------------------------------------------
# flagship statistics: count + exact u64 checksums (+ histogram)
# ---------------------------------------------------------------------------


def _stats_init():
    return {
        "count": jnp.zeros((), jnp.uint32),
        "count_hi": jnp.zeros((), jnp.uint32),
        "sums": jnp.zeros((3, 4, 2), jnp.uint32),
    }


def _stats_update(state, soa_local, n_valid):
    # zero padding is neutral for limb sums; count uses n_valid directly.
    acc = state["sums"] + field_sums_soa(soa_local)
    # Normalize the (lo16, hi16) accumulator pair each batch: without this,
    # every batch can add up to 65535 to the lo half regardless of record
    # count, wrapping uint32 after ~65k small batches (silent checksum
    # corruption). After normalization lo < 2^17 always, and hi tracks the
    # true magnitude (≤ record count), restoring the 2^32-record capacity.
    lo_half = acc[..., 0]
    hi_half = acc[..., 1] + (lo_half >> 16)
    new_sums = jnp.stack([lo_half & 0xFFFF, hi_half], axis=-1)
    lo = state["count"] + n_valid.astype(jnp.uint32)
    carry = (lo < state["count"]).astype(jnp.uint32)
    return {
        "count": lo,
        "count_hi": state["count_hi"] + carry,
        "sums": new_sums,
    }


STATS_MAP_REDUCE = MapReduce(init=_stats_init, update=_stats_update)


def finalize_stats(merged) -> dict:
    """Host fold of the summed per-shard stats state."""
    count = int(merged["count"]) + (int(merged["count_hi"]) << 32)
    sums = merged["sums"]
    return {
        "count": count,
        "barcode_sum": fold_limbs(sums[0]),
        "umi_sum": fold_limbs(sums[1]),
        "index_sum": fold_limbs(sums[2]),
    }


def record_batches_from_mmap(
    reader: MmapReader, batch_records: int = STREAM_BATCH_RECORDS
) -> Iterator[np.ndarray]:
    """Stream a mapped file as structured record batches — **zero-copy**
    views straight off the mapping (the engine ships them to the device in
    wire layout and transposes there)."""
    n = reader.len()
    start = 0
    while start < n:
        end = min(start + batch_records, n)
        yield reader.slice(start, end)
        start = end


def soa_batches_from_mmap(
    reader: MmapReader, batch_records: int = STREAM_BATCH_RECORDS
) -> Iterator[np.ndarray]:
    """Stream a mapped file as ``(6, B)`` column batches (host transpose).

    Prefer :func:`record_batches_from_mmap` — this variant pays a host
    transpose per batch and exists for callers that want host-side columns.
    """
    for batch in record_batches_from_mmap(reader, batch_records):
        yield soa_from_records(np.asarray(batch))


def stream_file_stats(
    reader: MmapReader,
    mesh: Mesh | None = None,
    batch_records: int = STREAM_BATCH_RECORDS,
) -> dict:
    """Count + exact field checksums of a whole file, streamed over the mesh.

    The device equivalent of the reference's flagship benchmark
    (``examples/parallel.rs:38-105``): shards process record batches in
    parallel and partial statistics merge at the end. Batches are sized to
    a mesh-size multiple so every placement is host-copy-free.
    """
    from ibu_jax.io.stream import stream_file

    mesh = mesh or make_mesh()
    merged = STATS_MAP_REDUCE.run_placed(
        stream_file(reader, mesh=mesh, batch_records=batch_records), mesh=mesh
    )
    return finalize_stats(merged)


def sharded_stats(soa: np.ndarray, mesh: Mesh | None = None) -> dict:
    """One-shot count + checksums of an in-memory ``(6, N)`` column matrix."""
    merged = STATS_MAP_REDUCE.run(iter([soa]), mesh=mesh)
    return finalize_stats(merged)


# ---------------------------------------------------------------------------
# sharded per-barcode histogram
# ---------------------------------------------------------------------------


def _sparse_group_sum(
    key_lo: jax.Array,
    key_hi: jax.Array,
    weights: jax.Array,
    capacity: int,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Group-by-key weight sums of sparse ``(u64 key, u32 weight)`` entries.

    The shared primitive under both histogram stages. Entries with weight 0
    are INVALID (empty slots / padding): a validity flag leads the sort key,
    so every valid entry sorts before every invalid one — valid groups
    occupy the first segments regardless of key value (no u64-max/zero
    phantom-key corner cases). Returns ``(lo, hi, counts, n_distinct)``
    where the first ``n_distinct`` slots hold the distinct valid keys with
    their summed weights; slots past ``capacity`` are silently dropped,
    which callers must guard via ``n_distinct``.
    """
    invalid = (weights == 0).astype(jnp.uint32)
    s_inv, s_hi, s_lo, s_w = jax.lax.sort(
        (invalid, key_hi, key_lo, weights), num_keys=3
    )
    first = jnp.concatenate(
        [
            jnp.ones((1,), dtype=jnp.bool_),
            (s_inv[1:] != s_inv[:-1])
            | (s_hi[1:] != s_hi[:-1])
            | (s_lo[1:] != s_lo[:-1]),
        ]
    )
    seg_ids = jnp.cumsum(first.astype(jnp.int32)) - 1
    counts = jax.ops.segment_sum(s_w, seg_ids, num_segments=capacity)
    zeros = jnp.zeros((capacity,), jnp.uint32)
    unique_lo = zeros.at[seg_ids].set(s_lo, mode="drop")
    unique_hi = zeros.at[seg_ids].set(s_hi, mode="drop")
    n_distinct = jnp.sum(first & (s_inv == 0), dtype=jnp.int32)
    return unique_lo, unique_hi, counts, n_distinct


def _gather_state_tree(states):
    """Host-gather a per-shard state pytree across processes in ONE
    collective.

    The per-leaf ``process_allgather`` costs one cross-process round trip per
    leaf; the 3-leaf stats state measured 3 × ~7 ms of pure collective
    latency per streaming call on a 2-process CPU cohort. Instead: each
    process
    packs its leaves' LOCAL row blocks into one byte buffer, one
    allgather moves it, and the global ``(S, ...)`` leaves reassemble by
    rank order.

    Valid when every process owns one CONTIGUOUS, rank-ordered,
    equal-sized row block of each leaf — true for ``make_mesh()``
    (jax.devices() is process-ordered) with ``P(AXIS)`` states on
    homogeneous cohorts. The verdict is computed from the GLOBAL mesh
    device order, which every rank sees identically — a per-rank verdict
    (e.g. from local shard indices) could route different ranks onto
    DIFFERENT collective sequences (one packed allgather vs one per
    leaf) and hang the cohort until the heartbeat timeout. Anything
    irregular falls back to the per-leaf gather on EVERY rank.
    """
    from jax.experimental import multihost_utils

    leaves, treedef = jax.tree.flatten(states)
    pid = jax.process_index()
    nprocs = jax.process_count()

    def _fallback():
        return jax.tree.map(
            lambda x: np.asarray(
                multihost_utils.process_allgather(x, tiled=True)
            ),
            states,
        )

    # -- global layout verdict (identical on every rank) --
    def _mesh_pids(x):
        sh = getattr(x, "sharding", None)
        mesh = getattr(sh, "mesh", None)
        if mesh is None:
            return None
        try:
            return [d.process_index for d in mesh.devices.flat]
        except AttributeError:
            return None

    ok = bool(leaves)
    pids0 = _mesh_pids(leaves[0]) if leaves else None
    if pids0 is None or pids0 != sorted(pids0):
        ok = False  # devices not grouped in ascending rank order
    else:
        counts = np.bincount(pids0, minlength=nprocs)
        if len(set(pids0)) != nprocs or not (counts == counts[0]).all():
            ok = False  # missing ranks or heterogeneous device counts
    if ok:
        n_dev = len(pids0)
        for x in leaves:
            if _mesh_pids(x) != pids0 or x.shape[0] % n_dev:
                ok = False
                break
            # dim 0 must be FULLY partitioned across all devices — a
            # replicated (or partially sharded) leaf would concatenate
            # whole copies locally; shard_shape is global info, so the
            # verdict stays identical on every rank
            try:
                if x.sharding.shard_shape(x.shape)[0] * n_dev != x.shape[0]:
                    ok = False
                    break
            except Exception:  # noqa: BLE001 — unknown sharding type
                ok = False
                break
    if not ok:
        return _fallback()

    locals_, metas = [], []
    for x in leaves:
        rows_local = x.shape[0] // nprocs
        shards = sorted(x.addressable_shards, key=lambda h: h.index[0].start)
        block = np.ascontiguousarray(
            np.concatenate([np.asarray(h.data) for h in shards])
        )
        if block.shape[0] != rows_local:
            # the global verdict said this cannot happen; a mismatch is a
            # sharding-model bug, not a layout variant — fail loudly and
            # identically everywhere rather than silently mis-merging
            raise RuntimeError(
                f"_gather_state_tree: local rows {block.shape[0]} != "
                f"expected {rows_local} despite a regular global layout"
            )
        locals_.append(block.view(np.uint8).reshape(-1))
        metas.append((block.dtype, (rows_local,) + x.shape[1:]))
    flat = (
        np.concatenate(locals_)
        if locals_
        else np.zeros(0, dtype=np.uint8)
    )
    gathered = np.asarray(
        multihost_utils.process_allgather(flat[None, :])
    ).reshape(nprocs, -1)
    out = []
    off = 0
    for (dtype, lshape), loc in zip(metas, locals_):
        nb = loc.nbytes
        per_rank = [
            gathered[r, off:off + nb].view(dtype).reshape(lshape)
            for r in range(nprocs)
        ]
        out.append(np.concatenate(per_rank, axis=0))
        off += nb
    return jax.tree.unflatten(treedef, out)


def _to_host(x) -> np.ndarray:
    """Replicated/addressable device array → host numpy (multi-process
    safe: a non-fully-addressable replicated array reads its local shard)."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    return np.asarray(x.addressable_data(0))  # replicated


def _sparse_group_sum_spill(
    key_lo: jax.Array,
    key_hi: jax.Array,
    weights: jax.Array,
    capacity: int,
    ovf_cap: int,
):
    """:func:`_sparse_group_sum` with an overflow lane instead of drops.

    Groups the sparse entries exactly like ``_sparse_group_sum`` but
    segments into ``capacity + ovf_cap`` slots: the first ``capacity``
    distinct keys (the smallest, by the sort order) form the table; the
    next ``ovf_cap`` land in the overflow arrays for the host to absorb.
    Exact whenever ``ovf_cap >= len(entries) - capacity`` (distinct groups
    can never exceed entry count), which every caller guarantees
    statically. Returns ``(lo, hi, cnt, n_distinct, ovf_lo, ovf_hi,
    ovf_cnt, ovf_n)`` where ``ovf_n = max(n_distinct - capacity, 0)`` is
    the number of live overflow slots.
    """
    invalid = (weights == 0).astype(jnp.uint32)
    s_inv, s_hi, s_lo, s_w = jax.lax.sort(
        (invalid, key_hi, key_lo, weights), num_keys=3
    )
    first = jnp.concatenate(
        [
            jnp.ones((1,), dtype=jnp.bool_),
            (s_inv[1:] != s_inv[:-1])
            | (s_hi[1:] != s_hi[:-1])
            | (s_lo[1:] != s_lo[:-1]),
        ]
    )
    seg_ids = jnp.cumsum(first.astype(jnp.int32)) - 1
    nseg = capacity + ovf_cap
    counts = jax.ops.segment_sum(s_w, seg_ids, num_segments=nseg)
    zeros = jnp.zeros((nseg,), jnp.uint32)
    unique_lo = zeros.at[seg_ids].set(s_lo, mode="drop")
    unique_hi = zeros.at[seg_ids].set(s_hi, mode="drop")
    n_distinct = jnp.sum(first & (s_inv == 0), dtype=jnp.int32)
    ovf_n = jnp.maximum(n_distinct - capacity, 0)
    return (
        unique_lo[:capacity],
        unique_hi[:capacity],
        counts[:capacity],
        n_distinct,
        unique_lo[capacity:],
        unique_hi[capacity:],
        counts[capacity:],
        ovf_n,
    )


def _masked_histogram_scatter(raw, n_valid, max_uniques: int,
                              bc16: bool = False):
    """Scatter-based per-shard histogram (the r1/r2 production form; kept
    for lab comparisons — see :func:`_masked_histogram` for why it lost).
    ``bc16`` is accepted for signature parity and ignored (always the
    full 2-key sort)."""
    soa = raw.T
    bc_lo, bc_hi = soa[0], soa[1]
    n = bc_lo.shape[0]
    w = (jnp.arange(n, dtype=jnp.int32) < n_valid).astype(jnp.uint32)
    npad = 1 << max(0, (n - 1).bit_length())  # pow2 sort shapes (see stats)
    if npad != n:
        padk = jnp.full((npad - n,), 0xFFFFFFFF, jnp.uint32)
        bc_lo = jnp.concatenate([bc_lo, padk])
        bc_hi = jnp.concatenate([bc_hi, padk])
        w = jnp.concatenate([w, jnp.zeros((npad - n,), jnp.uint32)])
    unique_lo, unique_hi, counts, n_distinct = _sparse_group_sum(
        bc_lo, bc_hi, w, max_uniques
    )
    return unique_lo, unique_hi, counts, n_distinct[None]


def _masked_histogram(raw, n_valid, max_uniques: int, bc16: bool = False):
    """Per-shard histogram, scatter-free.

    The classic sort→segment-ids→``segment_sum``+``.at[].set`` formulation
    runs THREE record-sized scatters per batch. This formulation replaces
    every scatter with table-sized work (whether that pays on a GPU, where
    scatter-add is native, is not measured yet):

    * masked entries get the all-max key BEFORE the stable sort, so valid
      records occupy exactly positions ``[0, n_valid)`` of the sorted
      order (equal-key stability keeps valid — input-prefix — entries
      first);
    * per capacity slot ``j``, the segment's bounds come from two
      ``searchsorted`` binary searches over the monotonic segment ids
      (``max_uniques × log n`` gathers instead of ``n`` scatters), clipped
      to ``n_valid`` so invalid tails never count;
    * unique keys are two ``max_uniques``-sized gathers at the segment
      starts.

    Contract is identical to the scatter form: ``(unique_lo, unique_hi,
    counts, n_distinct[1])`` with empty slots zeroed; ``n_distinct``
    counting true distinct valid barcodes (callers must treat
    ``n_distinct > max_uniques`` as overflow).

    ``bc16=True`` (CALLER-VERIFIED: every valid barcode < 2^32, e.g. one
    host ``max()`` per batch) drops the provably-zero hi word from the
    sort — a 1-key comparator.
    """
    soa = raw.T
    bc_lo, bc_hi = soa[0], soa[1]
    n = bc_lo.shape[0]
    maxk = jnp.uint32(0xFFFFFFFF)
    valid = jnp.arange(n, dtype=jnp.int32) < n_valid
    key_lo = jnp.where(valid, bc_lo, maxk)
    npad = 1 << max(0, (n - 1).bit_length())  # pow2 sort shapes (see stats)
    padk = jnp.full((npad - n,), maxk, jnp.uint32)
    if npad != n:
        key_lo = jnp.concatenate([key_lo, padk])
    if bc16:
        (s_lo,) = jax.lax.sort((key_lo,), num_keys=1, is_stable=True)
        s_hi = jnp.zeros_like(s_lo)
        first_tail = s_lo[1:] != s_lo[:-1]
    else:
        key_hi = jnp.where(valid, bc_hi, maxk)
        if npad != n:
            key_hi = jnp.concatenate([key_hi, padk])
        s_hi, s_lo = jax.lax.sort(
            (key_hi, key_lo), num_keys=2, is_stable=True
        )
        first_tail = (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])
    first = jnp.concatenate(
        [jnp.ones((1,), dtype=jnp.bool_), first_tail]
    )
    seg_ids = jnp.cumsum(first.astype(jnp.int32)) - 1  # monotonic
    total_valid = n_valid.astype(jnp.int32)
    slots = jnp.arange(max_uniques, dtype=jnp.int32)
    starts = jnp.searchsorted(seg_ids, slots, side="left")
    ends = jnp.searchsorted(seg_ids, slots, side="right")
    s = jnp.minimum(starts.astype(jnp.int32), total_valid)
    e = jnp.minimum(ends.astype(jnp.int32), total_valid)
    counts = (e - s).astype(jnp.uint32)
    at = jnp.minimum(starts, npad - 1)
    unique_lo = jnp.where(counts > 0, s_lo[at], 0)
    unique_hi = jnp.where(counts > 0, s_hi[at], 0)
    n_distinct = jnp.where(
        total_valid > 0,
        seg_ids[jnp.maximum(total_valid - 1, 0)] + 1,
        jnp.int32(0),
    )
    return unique_lo, unique_hi, counts, n_distinct[None]


#: bit 30 of the per-shard ``n_seen`` lane carries the sorted-fast-path
#: order-violation verdict (int32 stays positive, so the max-combining
#: ``shard_seen`` state propagates it; decoded in
#: :meth:`DeviceHistogram.finalize` / :func:`sharded_barcode_histogram`)
_ORDER_BAD_BIT = 1 << 30


def _masked_histogram_sorted(raw, n_valid, max_uniques: int,
                             bc16: bool = False):
    """Per-shard histogram for SORTED batches — no sort at all.

    On a sorted file (the common case after ``sort``/``dedup``/ingest),
    equal barcodes are adjacent within every shard's block, so the
    record-sized ``lax.sort`` — the dominant cost of
    :func:`_masked_histogram`, ~6 ms/1M records of the measured
    23 ms/batch (tools/histogram_capacity_lab.py) — is unnecessary:
    segment ids come from ONE adjacent-diff and the per-slot bounds from
    the same ``searchsorted`` binary searches.

    Trust is verified, not assumed: the kernel also computes whether the
    valid prefix really is nondecreasing by barcode and returns the
    verdict in bit 30 of the ``n_seen`` lane (:data:`_ORDER_BAD_BIT`) —
    a lying sorted flag raises at finalize instead of producing silently
    split groups. The check is per-shard, which is exactly the
    correctness-relevant scope: cross-shard (and cross-batch) merging is
    BY KEY, so a decrease at a shard/batch boundary cannot corrupt
    counts — only within-shard disorder can, and that is what the kernel
    flags. Padding rows beyond ``n_valid`` never count: bounds clip to
    the valid prefix exactly as in :func:`_masked_histogram`.

    ``bc16=True`` (caller-verified: all barcodes < 2^32) drops the hi
    word from both the adjacency and the order check.
    """
    soa = raw.T
    bc_lo, bc_hi = soa[0], soa[1]
    n = bc_lo.shape[0]
    total_valid = n_valid.astype(jnp.int32)
    valid_tail = jnp.arange(1, n, dtype=jnp.int32) < total_valid
    if bc16:
        neq = bc_lo[1:] != bc_lo[:-1]
        dec = bc_lo[1:] < bc_lo[:-1]
    else:
        hi_neq = bc_hi[1:] != bc_hi[:-1]
        neq = hi_neq | (bc_lo[1:] != bc_lo[:-1])
        dec = (bc_hi[1:] < bc_hi[:-1]) | (
            ~hi_neq & (bc_lo[1:] < bc_lo[:-1])
        )
    bad = jnp.any(dec & valid_tail)
    first = jnp.concatenate([jnp.ones((1,), dtype=jnp.bool_), neq])
    seg_ids = jnp.cumsum(first.astype(jnp.int32)) - 1  # monotonic
    slots = jnp.arange(max_uniques, dtype=jnp.int32)
    starts = jnp.searchsorted(seg_ids, slots, side="left")
    ends = jnp.searchsorted(seg_ids, slots, side="right")
    s = jnp.minimum(starts.astype(jnp.int32), total_valid)
    e = jnp.minimum(ends.astype(jnp.int32), total_valid)
    counts = (e - s).astype(jnp.uint32)
    at = jnp.minimum(starts, n - 1)
    unique_lo = jnp.where(counts > 0, bc_lo[at], 0)
    unique_hi = jnp.where(counts > 0, bc_hi[at], 0)
    n_distinct = jnp.where(
        total_valid > 0,
        seg_ids[jnp.maximum(total_valid - 1, 0)] + 1,
        jnp.int32(0),
    )
    n_out = n_distinct + jnp.where(bad, jnp.int32(_ORDER_BAD_BIT),
                                   jnp.int32(0))
    return unique_lo, unique_hi, counts, n_out[None]


def _decode_seen(seen: int, context: str) -> int:
    """Split the max-combined ``n_seen`` lane into (order verdict raised,
    true per-shard unique count)."""
    if seen & _ORDER_BAD_BIT:
        raise ValueError(
            f"{context}: the sorted-input fast path saw barcodes out of "
            "nondecreasing order — the file's sorted flag is wrong; "
            "re-sort the file or rerun without assuming sorted input"
        )
    return seen


def sharded_barcode_histogram(
    batches: Iterator[np.ndarray],
    mesh: Mesh | None = None,
    max_uniques_per_shard: int | None = None,
    sorted_in: bool = False,
) -> dict[int, int]:
    """Barcode → count over sharded batches; host dict merge across shards.

    Each shard histograms its local block on device; the sparse per-shard
    results merge in a host dict (barcode spaces are data-dependent, so the
    cross-shard union stays host-side by design).

    ``sorted_in=True`` (input known sorted, e.g. a verified header flag)
    skips the per-batch device sort entirely — groups are adjacent
    (:func:`_masked_histogram_sorted`); order is still verified in-kernel
    and a lying flag raises instead of producing wrong counts.

    The per-shard table holds a whole shard by default, so no barcode
    space overflows it. With an explicit ``max_uniques_per_shard``, raises
    ``ValueError`` if any shard sees more distinct barcodes than that in
    one batch (counts would otherwise be silently dropped) — raise the cap
    or shrink batches.
    """
    mesh = mesh or make_mesh()

    mesh_key = (
        mesh.axis_names,
        tuple(d.id for d in mesh.devices.flat),
    )
    totals: dict[int, int] = {}
    for batch in batches:
        # hinted 1-key sort when this batch's barcodes provably fit the
        # lo word (data-verified, not header-trusted)
        bc16 = bc16_hint(as_raw_u32(batch))
        dev_soa, dev_valid = shard_batch(batch, mesh)
        cap = max_uniques_per_shard or dev_soa.shape[0] // mesh.devices.size
        hist_fn = _shard_hist_fn(mesh, mesh_key, cap, bc16, sorted_in)
        u_lo, u_hi, counts, n_seen = jax.tree.map(
            np.asarray, hist_fn(dev_soa, dev_valid)
        )
        if _decode_seen(int(n_seen.max()),
                        "sharded_barcode_histogram") > cap:
            raise ValueError(
                f"a shard saw {int(n_seen.max())} unique barcodes, over the "
                f"max_uniques_per_shard={max_uniques_per_shard} capacity; "
                "raise the cap or use smaller batches"
            )
        # vectorized cross-shard merge: one u64 key build + np.unique over
        # all shards' nonzero entries (no per-entry Python)
        nz = counts != 0
        keys = u_lo[nz].astype(np.uint64) | (u_hi[nz].astype(np.uint64) << 32)
        uk, inv = np.unique(keys, return_inverse=True)
        summed = np.zeros(len(uk), dtype=np.int64)
        np.add.at(summed, inv, counts[nz].astype(np.int64))
        for k, c in zip(uk.tolist(), summed.tolist()):
            totals[k] = totals.get(k, 0) + c
    return totals


#: Bounded FIFO cache: keys are (mesh_key, capacity, per-shard cap) value
#: tuples, so unlike _STEP_CACHE there is no engine object to key weakly;
#: the bound stops a capacity/mesh parameter sweep from retaining every
#: compiled executable forever.
_HIST_FN_CACHE: dict = {}
_HIST_FN_CACHE_MAX = 16


def _histogram_fns(mesh, mesh_key, capacity, max_uniques_per_shard,
                   merge_every, spill: bool = False):
    """Build (or fetch cached) the per-shard histogram, stage-write, and
    global-merge jits.

    A fresh jit object per DeviceHistogram would recompile on every
    construction (same failure mode as MapReduce.compile_step); caching on
    (mesh identity, capacity, per-shard cap, stage depth, spill) makes
    repeated histogram runs pay compilation once per process.

    ``spill=True`` builds the overflow-lane merge: instead of silently
    dropping distinct keys beyond ``capacity``, the merge group-sums them
    into a fixed ``stage_total``-sized overflow buffer
    (:func:`_sparse_group_sum_spill`) that the host absorbs — the same
    collective sequence on every process either way.
    """
    key = (mesh_key, capacity, max_uniques_per_shard, merge_every, spill)
    if key in _HIST_FN_CACHE:
        return _HIST_FN_CACHE[key]

    replicated = NamedSharding(mesh, P())
    staged = NamedSharding(mesh, P(None, AXIS))
    state_shardings = {
        "lo": replicated, "hi": replicated, "cnt": replicated,
        "n": replicated, "shard_seen": replicated,
        "st_lo": staged, "st_hi": staged, "st_cnt": staged,
    }

    @functools.partial(
        jax.jit, out_shardings=state_shardings, donate_argnums=(0,)
    )
    def stage_write(state, b_lo, b_hi, b_cnt, b_seen, slot):
        # O(entries) sharded row write — no sort, no collective. The
        # expensive group-sum happens only in ``merge`` below, every
        # ``merge_every`` batches.
        def put(buf, row):
            return jax.lax.dynamic_update_slice(buf, row[None, :], (slot, 0))

        return {
            **state,
            "st_lo": put(state["st_lo"], b_lo),
            "st_hi": put(state["st_hi"], b_hi),
            "st_cnt": put(state["st_cnt"], b_cnt),
            "shard_seen": jnp.maximum(state["shard_seen"], jnp.max(b_seen)),
        }

    def _merge_inputs(state):
        # zero-count staged entries (unused slots / empty segments) are
        # invalid by _sparse_group_sum's weight convention, so merging the
        # full stage regardless of fill level is exact.
        lo = jnp.concatenate([state["lo"], state["st_lo"].reshape(-1)])
        hi = jnp.concatenate([state["hi"], state["st_hi"].reshape(-1)])
        cnt = jnp.concatenate([state["cnt"], state["st_cnt"].reshape(-1)])
        return lo, hi, cnt

    def _new_state(state, new_lo, new_hi, new_cnt, n_distinct):
        return {
            "lo": new_lo,
            "hi": new_hi,
            "cnt": new_cnt,
            "n": jnp.maximum(state["n"], n_distinct),
            "shard_seen": state["shard_seen"],
            "st_lo": jnp.zeros_like(state["st_lo"]),
            "st_hi": jnp.zeros_like(state["st_hi"]),
            "st_cnt": jnp.zeros_like(state["st_cnt"]),
        }

    if spill:
        # overflow lane sized to the staged entry count: distinct groups
        # beyond the kept `capacity` can never exceed the number of
        # non-table input entries, so this is exact — never drops
        stage_total = merge_every * mesh.devices.size * max_uniques_per_shard

        @functools.partial(
            jax.jit,
            out_shardings=(
                state_shardings,
                replicated, replicated, replicated, replicated,
            ),
            donate_argnums=(0,),
        )
        def merge(state):
            lo, hi, cnt = _merge_inputs(state)
            (new_lo, new_hi, new_cnt, n_distinct,
             ovf_lo, ovf_hi, ovf_cnt, ovf_n) = _sparse_group_sum_spill(
                lo, hi, cnt, capacity, stage_total
            )
            return (
                _new_state(state, new_lo, new_hi, new_cnt, n_distinct),
                ovf_n, ovf_lo, ovf_hi, ovf_cnt,
            )
    else:

        @functools.partial(
            jax.jit, out_shardings=state_shardings, donate_argnums=(0,)
        )
        def merge(state):
            lo, hi, cnt = _merge_inputs(state)
            new_lo, new_hi, new_cnt, n_distinct = _sparse_group_sum(
                lo, hi, cnt, capacity
            )
            return _new_state(state, new_lo, new_hi, new_cnt, n_distinct)

    if len(_HIST_FN_CACHE) >= _HIST_FN_CACHE_MAX:
        _HIST_FN_CACHE.pop(next(iter(_HIST_FN_CACHE)))
    _HIST_FN_CACHE[key] = (stage_write, merge)
    return stage_write, merge


def _shard_hist_fn(mesh, mesh_key, max_uniques_per_shard, bc16: bool,
                   sorted_in: bool = False):
    """Build (or fetch cached) the per-shard histogram jit — keyed
    separately from the stage/merge pair so the hinted (``bc16``) /
    sorted-fast-path variants don't duplicate those compiles."""
    key = ("shard", mesh_key, max_uniques_per_shard, bc16, sorted_in)
    if key in _HIST_FN_CACHE:
        return _HIST_FN_CACHE[key]
    fn = jax.jit(
        shard_map(
            functools.partial(
                _masked_histogram_sorted if sorted_in else _masked_histogram,
                max_uniques=max_uniques_per_shard,
                bc16=bc16,
            ),
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS)),
            out_specs=P(AXIS),
            check_vma=False,
        )
    )
    if len(_HIST_FN_CACHE) >= _HIST_FN_CACHE_MAX:
        _HIST_FN_CACHE.pop(next(iter(_HIST_FN_CACHE)))
    _HIST_FN_CACHE[key] = fn
    return fn


class DeviceHistogram:
    """Device-resident barcode histogram accumulator (bounded key spaces).

    Where :func:`sharded_barcode_histogram` merges per-shard sparse results
    in a host dict every batch (unbounded key spaces, host round-trip per
    batch), this keeps the running ``barcode → count`` table ON DEVICE:

    1. per batch, each shard histograms its local block under ``shard_map``
       (sort + segment-sum — exactly the per-shard stage above) and writes
       the sparse result into a sharded STAGING buffer (one row write — no
       sort, no collective in the per-batch path);
    2. every ``merge_every`` batches, a jitted global merge concatenates
       the staged entries with the running table and group-sums by key —
       XLA inserts the all-gather, so the cross-shard traffic rides the
       device interconnect (and the network on a multi-host mesh), not the
       host. Staging
       amortizes this table-sized sort over ``merge_every`` batches: it
       dominated the per-batch cost (23.3 ms/batch measured r2 vs ~6.5 ms
       for the shard stage — tools/histogram_capacity_lab.py);
    3. :meth:`finalize` flushes the stage and makes ONE device→host
       transfer, building the dict vectorized.

    No host sync happens inside the batch loop, so update dispatch
    pipelines with the device work. Capacity overflow (more than
    ``capacity`` distinct barcodes in the table): with ``spill=True``
    (default) the merge routes the overflowed groups — the LARGEST keys,
    exactly group-summed into a fixed overflow lane — to a host spill
    dict, drained one merge-cycle later (by which time that merge has
    long completed, so the scalar read stalls nothing); :meth:`finalize`
    folds the spill back in, making the result exact on barcode spaces of
    ANY size. ``spill=False`` restores the strict behavior: overflow is
    tracked on device and raised at :meth:`finalize`. A shard-batch with
    more than ``max_uniques_per_shard`` distinct barcodes remains a hard
    error either way (staging capacity — shrink batches or raise the
    cap). Counts are uint32 per barcode (≥4.2e9 records of ONE barcode
    would wrap; total record count is unbounded).
    """

    def __init__(
        self,
        mesh: Mesh | None = None,
        capacity: int = 1 << 20,
        max_uniques_per_shard: int = 1 << 16,
        placer=default_placer,
        merge_every: int = 16,  # on-chip sweep r5: 8 -> 16 is +16% (the
        # capacity-sized merge dominates; staging is ~12 MB/shard here)
        spill: bool = True,
        assume_sorted: bool = False,
    ):
        if merge_every < 1:
            raise ValueError(f"merge_every must be >= 1, got {merge_every}")
        self.mesh = mesh or make_mesh()
        self.capacity = capacity
        self.max_uniques_per_shard = max_uniques_per_shard
        self.merge_every = merge_every
        self.spill = spill
        #: input claimed sorted (e.g. a verified header flag): the per-
        #: shard stage skips its record sort — groups are adjacent — and
        #: instead VERIFIES order in-kernel; a lie raises at finalize
        self.assume_sorted = assume_sorted
        self._placer = placer
        self._filled = 0  # staged batches since the last merge
        self._spilled: dict[int, int] = {}  # host-absorbed overflow
        self._pending = None  # previous merge's (ovf_n, lo, hi, cnt)
        mesh_key = (
            self.mesh.axis_names,
            tuple(d.id for d in self.mesh.devices.flat),
        )
        self._mesh_key = mesh_key
        self._stage_write, self._merge = _histogram_fns(
            self.mesh, mesh_key, capacity, max_uniques_per_shard,
            merge_every, spill=spill,
        )
        replicated = NamedSharding(self.mesh, P())
        staged = NamedSharding(self.mesh, P(None, AXIS))
        zeros = np.zeros(capacity, np.uint32)
        s = self.mesh.devices.size
        st_zeros = np.zeros((merge_every, s * max_uniques_per_shard),
                            np.uint32)
        self._state = {
            "lo": jax.device_put(zeros, replicated),
            "hi": jax.device_put(zeros, replicated),
            "cnt": jax.device_put(zeros, replicated),
            "n": jax.device_put(np.int32(0), replicated),
            "shard_seen": jax.device_put(np.int32(0), replicated),
            "st_lo": jax.device_put(st_zeros, staged),
            "st_hi": jax.device_put(st_zeros, staged),
            "st_cnt": jax.device_put(st_zeros, staged),
        }

    def update(self, batch: np.ndarray) -> None:
        """Fold one host batch (structured records or ``(6,B)`` columns).

        Batches whose barcodes provably fit the lo word (one host
        ``max()`` over the wire view's bc_hi column — data-verified) take
        the hinted 1-key shard sort.
        """
        bc16 = bc16_hint(as_raw_u32(batch))
        dev_raw, dev_valid = shard_batch(batch, self.mesh, self._placer)
        self.update_placed(dev_raw, dev_valid, bc16=bc16)

    def update_placed(self, dev_raw, dev_valid, bc16: bool = False) -> None:
        """Fold one already-placed ``(device_raw, valid)`` pair.
        ``bc16=True`` is CALLER-VERIFIED (all barcodes < 2^32).

        Multi-process safety: the hint may differ across processes of one
        mesh for the same batch. It selects only the per-shard histogram
        program, which contains NO collectives (pure ``shard_map`` with
        local outputs); the collective-bearing ``stage_write``/``merge``
        programs are hint-independent, so every process launches the same
        collective sequence regardless of its local hints (exercised by
        ``tests/test_multiprocess.py``'s divergent-hint cluster leg).
        ``assume_sorted`` is likewise safe: it is a constructor property
        (cohort-uniform — every process reads the same header flag) and
        selects only the collective-free per-shard program.
        """
        u_lo, u_hi, counts, n_seen = _shard_hist_fn(
            self.mesh, self._mesh_key, self.max_uniques_per_shard, bc16,
            self.assume_sorted,
        )(dev_raw, dev_valid)
        self._state = self._stage_write(
            self._state, u_lo, u_hi, counts, n_seen,
            jnp.int32(self._filled),
        )
        self._filled += 1
        if self._filled >= self.merge_every:
            self._run_merge()

    def _run_merge(self) -> None:
        if self.spill:
            # drain the PREVIOUS cycle's overflow first: its merge has had
            # merge_every batches of device work to complete, so reading
            # its scalar now costs no pipeline stall
            self._drain_pending()
            self._state, ovf_n, o_lo, o_hi, o_cnt = self._merge(self._state)
            self._pending = (ovf_n, o_lo, o_hi, o_cnt)
        else:
            self._state = self._merge(self._state)
        self._filled = 0

    def _drain_pending(self) -> None:
        if self._pending is None:
            return
        ovf_n, o_lo, o_hi, o_cnt = self._pending
        self._pending = None
        n = int(_to_host(ovf_n))
        if n == 0:
            return
        # live overflow groups are a contiguous prefix (valid segments
        # sort before invalid ones in the merge); transfer only that,
        # pow2-bucketed so device slicing compiles O(log) variants, not
        # one per distinct n — the full lane is merge_every * S *
        # max_uniques entries (~50 MB at defaults), the live prefix is
        # typically a few thousand
        m = min(1 << max(0, (n - 1).bit_length()), o_lo.shape[0])
        lo, hi, cnt = (
            _to_host(o_lo[:m]),
            _to_host(o_hi[:m]),
            _to_host(o_cnt[:m]),
        )
        nz = cnt != 0
        keys = lo[nz].astype(np.uint64) | (hi[nz].astype(np.uint64) << 32)
        for k, c in zip(keys.tolist(), cnt[nz].astype(np.int64).tolist()):
            self._spilled[k] = self._spilled.get(k, 0) + c

    def finalize(self) -> dict[int, int]:
        """Flush the stage, then one device→host transfer; returns
        ``{barcode: count}`` (device table + any host-spilled overflow)."""
        if self._filled:
            self._run_merge()
        self._drain_pending()

        # transfer only the table keys — the (just-zeroed) staging buffers
        # are merge_every × S·max_uniques u32 each and are never read here
        st = {
            k: _to_host(self._state[k])
            for k in ("lo", "hi", "cnt", "n", "shard_seen")
        }
        if _decode_seen(int(st["shard_seen"]),
                        "DeviceHistogram") > self.max_uniques_per_shard:
            raise ValueError(
                f"a shard saw {int(st['shard_seen'])} unique barcodes, over "
                f"the max_uniques_per_shard={self.max_uniques_per_shard} "
                "capacity; raise the cap or use smaller batches"
            )
        if not self.spill and int(st["n"]) > self.capacity:
            raise ValueError(
                f"{int(st['n'])} distinct barcodes exceed the device table "
                f"capacity={self.capacity}; raise capacity, enable "
                "spill=True, or use sharded_barcode_histogram (host merge)"
            )
        nz = st["cnt"] != 0
        keys = st["lo"][nz].astype(np.uint64) | (
            st["hi"][nz].astype(np.uint64) << 32
        )
        out = dict(
            zip(keys.tolist(), st["cnt"][nz].astype(np.int64).tolist())
        )
        # fold the host-spilled overflow back in; a spilled key can have
        # re-entered the table later, so counts ADD
        for k, c in self._spilled.items():
            out[k] = out.get(k, 0) + c
        return out

    def run(self, batches: Iterator[np.ndarray]) -> dict[int, int]:
        """Fold all ``batches`` and finalize."""
        for batch in batches:
            self.update(batch)
        return self.finalize()


def stream_file_histogram(
    reader: MmapReader,
    mesh: Mesh | None = None,
    batch_records: int = STREAM_BATCH_RECORDS,
    capacity: int = 1 << 20,
    max_uniques_per_shard: int = 1 << 16,
    spill: bool = True,
    assume_sorted: bool | None = None,
) -> dict[int, int]:
    """Per-barcode counts of a whole file, streamed over the mesh with
    prefetch — the histogram sibling of :func:`stream_file_stats`. The
    running table stays on device (:class:`DeviceHistogram`), so the only
    host work in the loop is feeding zero-copy mmap views. Barcode spaces
    larger than ``capacity`` spill exactly to the host (``spill``).

    ``assume_sorted=None`` (default) trusts the header's sorted flag —
    sorted files (the common case after ``sort``/``dedup``/ingest) skip
    the per-batch device sort entirely; order is verified in-kernel and a
    lying flag raises rather than mis-counting.
    """
    from ibu_jax.io.stream import stream_file

    if assume_sorted is None:
        assume_sorted = reader.header().sorted()
    mesh = mesh or make_mesh()
    hist = DeviceHistogram(
        mesh=mesh,
        capacity=capacity,
        max_uniques_per_shard=max_uniques_per_shard,
        spill=spill,
        assume_sorted=assume_sorted,
    )
    for dev_raw, dev_valid, bc16 in stream_file(
        reader, mesh=mesh, batch_records=batch_records, with_hint=True
    ):
        hist.update_placed(dev_raw, dev_valid, bc16=bc16)
    return hist.finalize()
