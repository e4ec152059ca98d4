"""Multi-host (pod-slice) data-parallel processing.

The reference shares one ``Arc<Mmap>`` between OS threads
(``/root/reference/src/io/mmap.rs:102,308``); across hosts that becomes:

* each process opens the file itself and reads **only its own record
  range** — the same contiguous remainder-to-last partition rule as the
  reference (``mmap.rs:297-307``), applied at process granularity;
* per-process batches become global arrays via
  ``jax.make_array_from_process_local_data`` over a global mesh, so the
  engine's collectives span every process's devices;
* every process runs the same number of global steps (short shards pad
  with empty batches), because collectives are cohort-wide.

Single-process environments degrade gracefully: the global mesh is the
local one and the byte range is the whole file, so these entry points are
exercised by the single-host test suite too.
"""

from __future__ import annotations

import os
import sys
from typing import Iterator

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ibu_jax.io.mmap import STREAM_BATCH_RECORDS, MmapReader
from ibu_jax.ops.u64 import soa_from_records
from ibu_jax.parallel.device import (
    AXIS,
    STATS_MAP_REDUCE,
    bc16_hint,
    finalize_stats,
    make_mesh,
)
from ibu_jax.parallel.host import partition


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _cohort_checkpoint(
    failed: BaseException | None, stage: str, extra=()
) -> np.ndarray:
    """Collective failure gate (the cohort rule: any local failure must
    reach the next collective AS DATA, not as control flow — a lone rank
    raising before an allgather/barrier deadlocks the rest until the
    runtime heartbeat timeout).

    Allgathers a failure flag plus optional int lanes; if ANY rank
    failed, every rank raises together (its own exception, or a pointer
    to the failing rank). On success returns the gathered extra lanes as
    an ``(nprocs, len(extra))`` array. The allgather doubles as a
    barrier, so callers sequencing filesystem work can drop their
    explicit ``sync_global_devices``.
    """
    from jax.experimental import multihost_utils

    lane = [int(failed is not None)] + [int(v) for v in extra]
    gathered = multihost_utils.process_allgather(
        np.asarray([lane], dtype=np.int64)
    ).reshape(jax.process_count(), len(lane))
    if gathered[:, 0].any():
        if failed is not None:
            raise failed
        raise ValueError(
            f"multihost operation failed on another process during "
            f"{stage} (see that rank's error)"
        )
    return gathered[:, 1:]


def _even_sample_positions(n: int, s: int) -> np.ndarray:
    """``s`` evenly-spaced positions in ``[0, n)`` (``(2k+1)·n/2s``) —
    the sampling rule shared by every splitter election here (count
    matrix, host sort) and echoed by the C merge's sub-splitters."""
    pos = ((np.arange(s) + 0.5) * n / s).astype(np.int64)
    return np.minimum(pos, max(n - 1, 0))


def _splitter_cut_indices(total: int, nprocs: int) -> np.ndarray:
    """Quantile cut positions into a sorted sample array: splitter
    ``d`` sits at ``d·total/nprocs`` for ``d = 1..nprocs-1``."""
    return (np.arange(1, nprocs) * total) // nprocs


def _pwrite_all(fd: int, data, offset: int) -> None:
    """``os.pwrite`` until every byte lands: pwrite may return short
    (ENOSPC after partial progress, signal interruption, NFS/Lustre
    quirks on exactly the shared filesystems the multihost writers
    target); advancing by the intended length would leave the tail as the
    pre-truncated zeros while the run reports success."""
    view = memoryview(data)
    while len(view):
        written = os.pwrite(fd, view, offset)
        view = view[written:]
        offset += written


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize the JAX process group (no-op when single-process).

    The device-mesh replacement for spinning up the reference's thread pool:
    on a pod slice each host calls this once before any collective work.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def local_record_range(total_records: int) -> tuple[int, int]:
    """This process's contiguous record range (reference partition rule)."""
    bounds = partition(total_records, jax.process_count())
    return bounds[jax.process_index()]


def local_record_batches(
    reader: MmapReader, batch_records: int = STREAM_BATCH_RECORDS
) -> Iterator[np.ndarray]:
    """Stream only this process's shard of the file as structured record
    batches (zero-copy mmap views)."""
    start, end = local_record_range(reader.len())
    pos = start
    while pos < end:
        stop = min(pos + batch_records, end)
        yield reader.slice(pos, stop)
        pos = stop


def local_soa_batches(
    reader: MmapReader, batch_records: int = STREAM_BATCH_RECORDS
) -> Iterator[np.ndarray]:
    """Column-matrix variant of :func:`local_record_batches` (host transpose)."""
    for batch in local_record_batches(reader, batch_records):
        yield soa_from_records(np.asarray(batch))


def process_local_placer(local: np.ndarray, mesh: Mesh, spec: P) -> jax.Array:
    """Assemble identical-shaped per-process blocks into one global array."""
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), local
    )


def multihost_rounds(total_records: int, local_cols: int) -> int:
    """Cohort-wide round count, computed LOCALLY on every process.

    The record partition is deterministic (contiguous, remainder-to-last —
    the reference rule, ``mmap.rs:297-307``), so every process can compute
    every other process's range from the file size alone. Replacing the
    former ``process_allgather`` of per-process round counts with this
    local max removes one cross-process sync from every streaming call.

    Local reasoning is only valid when every process has the same device
    count (``local_cols`` is derived from it); the lone caller falls back
    to the allgather on heterogeneous cohorts — a locally-computed round
    count there would desynchronize the cohort-wide collective schedule
    and hang the job at the first mismatched round.
    """
    return max(
        _cdiv(max(e - s, 0), local_cols)
        for s, e in partition(total_records, jax.process_count())
    )


def multihost_placed_batches(
    reader: MmapReader,
    mesh: Mesh,
    batch_records: int = STREAM_BATCH_RECORDS,
    prefetch: int | None = None,
    with_hint: bool = False,
) -> Iterator[tuple]:
    """Yield globally-placed ``(raw, valid)`` pairs of this process's range.

    Every process yields the SAME number of pairs (short shards pad with
    empty batches) because downstream collectives are cohort-wide; the
    per-device valid counts mask the padding.

    ``prefetch`` pairs (default :data:`ibu_jax.io.mmap.STREAM_PREFETCH`)
    are kept placed-but-unconsumed ahead of the consumer — the multihost
    analogue of :class:`ibu_jax.io.stream.DeviceStream`: placement dispatch
    (mmap fault + host→device copy) for round *k+1…k+prefetch* overlaps the
    consumer's asynchronous step execution of round *k* instead of
    serializing after it.

    ``with_hint=True`` yields ``(raw, valid, bc16)`` triples where ``bc16``
    is this process's data-verified "every barcode of this block fits the
    lo u32 word" hint (padding rows are zero, so they never veto). The
    hint may legitimately differ across processes: it only selects the
    collective-free per-shard histogram program, never a collective one
    (see :meth:`ibu_jax.parallel.device.DeviceHistogram.update_placed`).
    """
    from ibu_jax.io.mmap import STREAM_PREFETCH

    if prefetch is None:
        prefetch = STREAM_PREFETCH
    prefetch = max(1, prefetch)

    s_local = jax.local_device_count()
    per_dev = _cdiv(batch_records, s_local)
    local_cols = per_dev * s_local  # fixed local block width every round

    start, end = local_record_range(reader.len())
    if jax.device_count() == s_local * jax.process_count():
        # homogeneous cohort (the multi-host norm): every process derives the
        # same round count locally — no sync
        rounds = multihost_rounds(reader.len(), local_cols)
    else:
        # heterogeneous device counts: local_cols differs per process, so
        # agree on the max local round count the robust way
        from jax.experimental import multihost_utils

        my_rounds = _cdiv(max(end - start, 0), local_cols)
        rounds = int(
            np.max(
                multihost_utils.process_allgather(
                    np.asarray([my_rounds], dtype=np.int64)
                )
            )
        )

    def produce():
        pos = start
        for _ in range(rounds):
            stop = min(pos + local_cols, end)
            if stop > pos:
                blk = (
                    np.ascontiguousarray(reader.slice(pos, stop))
                    .view(np.uint32)
                    .reshape(-1, 6)
                )
            else:
                blk = np.zeros((0, 6), dtype=np.uint32)
            b_local = blk.shape[0]
            pos = stop
            bc16 = bc16_hint(blk)
            if b_local < local_cols:
                blk = np.concatenate(
                    [blk, np.zeros((local_cols - b_local, 6), dtype=np.uint32)]
                )
            valid_local = np.minimum(
                np.maximum(b_local - per_dev * np.arange(s_local), 0), per_dev
            ).astype(np.int32)
            placed = (
                process_local_placer(blk, mesh, P(AXIS, None)),
                process_local_placer(valid_local, mesh, P(AXIS)),
            )
            yield placed + (bc16,) if with_hint else placed

    from ibu_jax.io.stream import prefetched

    yield from prefetched(produce(), prefetch)


def multihost_file_stats(
    path: str,
    mesh: Mesh | None = None,
    batch_records: int = STREAM_BATCH_RECORDS,
) -> dict:
    """Count + exact u64 field checksums across all hosts of a pod slice.

    Parity target: BASELINE.json config 5 ("multi-host parallel: records
    sharded across pod slice, parallel count + allreduce merge"). Every
    process streams its own byte range; partial limb-sum states merge at
    the end (``psum``-equivalent host fold of the gathered per-shard
    states).
    """
    return finalize_stats(
        multihost_map_reduce(path, STATS_MAP_REDUCE, mesh, batch_records)
    )


def multihost_barcode_histogram(
    path: str,
    mesh: Mesh | None = None,
    batch_records: int = STREAM_BATCH_RECORDS,
    capacity: int = 1 << 20,
    max_uniques_per_shard: int = 1 << 16,
    spill: bool = True,
) -> dict[int, int]:
    """Per-barcode counts across all hosts of a pod slice.

    Every process streams its own record range; per-shard sparse
    histograms merge on device each batch (``DeviceHistogram``), so the
    cross-shard union rides device collectives, and the single final
    table transfers once per host. Barcode spaces larger than
    ``capacity`` spill exactly to the host (``spill``; the spill drain is
    replicated, so every process converges on the same dict).

    Sorted files take the no-sort per-shard fast path: every device's
    block is a contiguous slice of the file, so groups are adjacent
    within it. The flag is read from the same header bytes on every
    process (cohort-uniform program selection) and verified in-kernel.
    """
    from ibu_jax.parallel.device import DeviceHistogram

    reader = MmapReader(path)
    assume_sorted = reader.header().sorted()

    if jax.process_count() == 1:
        hist = DeviceHistogram(
            mesh=mesh,
            capacity=capacity,
            max_uniques_per_shard=max_uniques_per_shard,
            spill=spill,
            assume_sorted=assume_sorted,
        )
        return hist.run(local_record_batches(reader, batch_records))

    mesh = mesh or make_mesh()
    hist = DeviceHistogram(
        mesh=mesh,
        capacity=capacity,
        max_uniques_per_shard=max_uniques_per_shard,
        placer=process_local_placer,
        spill=spill,
        assume_sorted=assume_sorted,
    )
    for g_raw, g_valid, bc16 in multihost_placed_batches(
        reader, mesh, batch_records, with_hint=True
    ):
        hist.update_placed(g_raw, g_valid, bc16=bc16)
    return hist.finalize()


def multihost_sort_file(
    in_path: str,
    out_path: str,
    mesh: Mesh | None = None,
    index_bits: int | None = None,
    slack: float = 2.0,
    samples_per_shard: int = 256,
    engine: str = "auto",
    chunk_records: int = 0,
    nthreads: int = 0,
) -> None:
    """Pod-scale sorted rewrite, engine-dispatched.

    Two engines, identical byte output:

    * ``"mesh"`` — the device sample sort over the global mesh
      (:func:`_multihost_sort_mesh`): the ``all_to_all`` exchange rides
      the device interconnect, files up to the whole mesh's device memory
      sort on device.
    * ``"host"`` — the shared-FS external sample sort
      (:func:`_multihost_sort_host`): per-rank native chunk sorts spill
      sorted runs, sampled splitters assign each rank a key range, and
      each rank k-way-merges its range from EVERY rank's runs straight
      into its slice of the pre-truncated output. Per-rank I/O equals
      the single-host external sort over ``n/P`` records — the fast path
      when no accelerator backs the mesh (CPU stand-ins) or the file
      exceeds the mesh's device memory.

    ``engine="auto"`` picks mesh on an accelerator backend when the file
    fits the mesh budget, host otherwise (when the native runtime is available),
    announcing on stderr; ``IBU_POD_SORT_ENGINE`` overrides globally.
    """
    if engine == "auto":
        env = os.environ.get("IBU_POD_SORT_ENGINE") or ""
        if env:
            engine, why = env, "operator override"
        else:
            engine, why = _choose_pod_sort_engine(in_path)
        if jax.process_count() > 1:
            # the choice must be COHORT-UNIFORM (the two engines run
            # different collective programs; divergent ranks would hang
            # until the heartbeat timeout): gather rank 0's preference,
            # every rank's native availability, and any invalid operator
            # override, resolve identically everywhere — host only if
            # rank 0 chose it AND every rank can run it; a bad
            # IBU_POD_SORT_ENGINE raises on EVERY rank (single-process
            # raises too, below) instead of silently running mesh
            from jax.experimental import multihost_utils

            from ibu_jax import native

            lane = np.asarray(
                [[1 if engine == "host" else 0,
                  1 if native.available() else 0,
                  1 if engine not in ("mesh", "host") else 0]],
                dtype=np.int64,
            )
            g = multihost_utils.process_allgather(lane).reshape(-1, 3)
            if g[:, 2].any():
                raise ValueError(
                    f"IBU_POD_SORT_ENGINE must be mesh or host, got "
                    f"{engine!r} (on this or another rank)"
                )
            uniform = "host" if (g[0, 0] and g[:, 1].all()) else "mesh"
            if uniform != engine:
                why += (
                    f"; cohort agreement overrode local choice "
                    f"{engine!r} (rank-0 preference + every-rank native "
                    "availability)"
                )
            engine = uniform
        print(f"pod sort engine auto: {why} -> {engine}",
              file=sys.stderr)
    if engine == "host":
        return _multihost_sort_host(
            in_path, out_path, chunk_records=chunk_records,
            nthreads=nthreads,
        )
    if engine != "mesh":
        raise ValueError(
            f"engine must be auto/mesh/host, got {engine!r}"
        )
    return _multihost_sort_mesh(
        in_path, out_path, mesh=mesh, index_bits=index_bits, slack=slack,
        samples_per_shard=samples_per_shard,
    )


def _choose_pod_sort_engine(in_path: str) -> tuple[str, str]:
    """mesh on an accelerator when the file fits the mesh's device memory,
    else host (when the native runtime built), else mesh."""
    from ibu_jax import native

    backend = jax.default_backend()
    if backend != "cpu":
        nbytes = os.path.getsize(in_path)
        stats = jax.local_devices()[0].memory_stats() or {}
        if "bytes_limit" not in stats:
            raise RuntimeError(
                f"the {backend} device reports no memory limit, so the mesh "
                "sort cannot be sized; choose --engine mesh or set "
                "IBU_POD_SORT_ENGINE"
            )
        budget = jax.device_count() * int(stats["bytes_limit"])
        # working set ≈ dealt input + exchange buffers + merged output
        if nbytes * 6 <= budget:
            return "mesh", (
                f"{backend} backend, {nbytes/1e9:.1f} GB fits the mesh "
                f"({budget/1e9:.0f} GB/6)"
            )
        if native.available():
            return "host", (
                f"{nbytes/1e9:.1f} GB exceeds the mesh device-memory budget "
                f"({budget/1e9:.0f} GB/6)"
            )
        return "mesh", "file exceeds the mesh budget but no native runtime"
    if native.available():
        return "host", "cpu backend: native external sort"
    return "mesh", "cpu backend but no native runtime"


def _multihost_sort_host(
    in_path: str,
    out_path: str,
    chunk_records: int = 0,
    nthreads: int = 0,
    samples_per_rank: int = 256,
) -> None:
    """Pod-scale shared-FS external sample sort (host path).

    Per rank: (1) native chunk sorts spill sorted headerless runs of MY
    record range next to ``out_path`` (shared FS); (2) every rank samples
    its runs evenly and one allgather elects ``P-1`` full-triple
    splitters; (3) each rank binary-searches its key interval in EVERY
    rank's runs (an interval of a sorted run is one contiguous slice) and
    one allgather of interval counts yields exact output offsets; (4)
    rank 0 pre-creates the output (input header + sorted flag +
    full-size truncate); (5) each rank k-way-merges its interval from all
    runs DIRECTLY into its byte slice (``native.merge_runs_interval`` —
    no concat pass). Total per-rank I/O = the single-host external sort
    of ``n/P`` records, so records/s scales ~linearly with hosts.

    Every stage failure rides a cohort checkpoint; a failed cooperative
    write unlinks the output (guarded). Equal triples are byte-identical,
    so the output is byte-identical to the single-host ``native.sort_file``
    for any splitter choice.
    """
    from jax.experimental import multihost_utils

    from ibu_jax import native
    from ibu_jax.constructs.header import HEADER_SIZE, Header
    from ibu_jax.constructs.record import RECORD_DTYPE, RECORD_SIZE
    from ibu_jax.pipelines import _require_plain

    if not native.available():
        raise RuntimeError(
            f"pod host sort needs the native runtime: {native.load_error()}"
        )
    if jax.process_count() == 1:
        native.sort_file(in_path, out_path, chunk_records=chunk_records,
                         nthreads=nthreads)
        return

    _require_plain(in_path, "sort")
    reader = MmapReader(in_path)
    header = reader.header()
    n = reader.len()
    start, end = local_record_range(n)
    pid = jax.process_index()
    nprocs = jax.process_count()
    u64max = np.uint64(0xFFFFFFFFFFFFFFFF)

    failed: BaseException | None = None
    run_prefix = f"{out_path}.mhsort{pid}"
    runs: list[str] = []
    try:
        # -- stage 1: sorted runs of my range --
        try:
            runs = native.sort_chunks_range(
                in_path, run_prefix, start, end - start,
                chunk_records=chunk_records, nthreads=nthreads,
            )
        except BaseException as e:
            failed = e
        gathered = _cohort_checkpoint(
            failed, "the run sort", (len(runs),)
        )
        runs_per_rank = [int(v) for v in gathered[:, 0]]
        all_runs = [
            f"{out_path}.mhsort{r}.run{k}"
            for r in range(nprocs)
            for k in range(runs_per_rank[r])
        ]

        # -- stage 2: splitter election (evenly-spaced triples over my
        # sorted runs' concatenation; padding sorts last) --
        samples = np.full((samples_per_rank, 3), u64max, dtype=np.uint64)
        sizes = [os.path.getsize(r) // RECORD_SIZE for r in runs]
        tot = sum(sizes)
        if tot:
            bounds = np.concatenate([[0], np.cumsum(sizes)])
            pos = _even_sample_positions(tot, samples_per_rank)
            which = np.searchsorted(bounds, pos, side="right") - 1
            for i, (w, p) in enumerate(zip(which, pos)):
                rec = np.memmap(
                    runs[int(w)], dtype=RECORD_DTYPE, mode="r"
                )[int(p - bounds[w])]
                samples[i] = (rec["barcode"], rec["umi"], rec["index"])
        g_samp = np.asarray(
            multihost_utils.process_allgather(samples[None, :, :])
        ).reshape(nprocs * samples_per_rank, 3)
        key_view = np.zeros(len(g_samp), dtype=RECORD_DTYPE)
        key_view["barcode"], key_view["umi"], key_view["index"] = (
            g_samp[:, 0], g_samp[:, 1], g_samp[:, 2]
        )
        key_sorted = np.sort(
            key_view, order=("barcode", "umi", "index")
        )
        sp_at = _splitter_cut_indices(len(key_sorted), nprocs)
        splitters = [
            (int(r["barcode"]), int(r["umi"]), int(r["index"]))
            for r in key_sorted[sp_at]
        ]
        lo = (0, 0, 0) if pid == 0 else splitters[pid - 1]
        hi = None if pid == nprocs - 1 else splitters[pid]

        # -- stage 3: my interval counts over ALL runs → exact offsets --
        my_count = 0
        try:
            for r in all_runs:
                a, b_ = native.run_interval(r, lo, hi)
                my_count += b_ - a
        except BaseException as e:
            failed = e
        gathered = _cohort_checkpoint(
            failed, "the interval count", (my_count,)
        )
        counts = [int(v) for v in gathered[:, 0]]
        assert sum(counts) == n, (counts, n)
        my_offset = HEADER_SIZE + RECORD_SIZE * sum(counts[:pid])

        # -- stage 4: rank 0 creates the full-size output --
        out_header = Header.new(header.bc_len, header.umi_len)
        out_header.flags = header.flags
        out_header.set_sorted()
        try:
            if pid == 0:
                with open(out_path, "wb") as f:
                    f.write(out_header.as_bytes())
                    f.truncate(HEADER_SIZE + RECORD_SIZE * n)
        except BaseException as e:
            failed = e
        _cohort_checkpoint(failed, "output creation")

        # -- stage 5: merge my interval straight into my byte slice --
        try:
            if my_count:
                native.merge_runs_interval(
                    all_runs, lo, hi, out_path, my_offset,
                    nthreads=nthreads, expect_records=my_count,
                )
        except BaseException as e:
            failed = e
        try:
            _cohort_checkpoint(failed, "the merge write")
        except BaseException:
            try:
                os.unlink(out_path)
            except OSError:
                pass
            raise
    finally:
        for r in runs:
            try:
                os.unlink(r)
            except OSError:
                pass


def _multihost_sort_mesh(
    in_path: str,
    out_path: str,
    mesh: Mesh | None = None,
    index_bits: int | None = None,
    slack: float = 2.0,
    samples_per_shard: int = 256,
) -> None:
    """Pod-scale sorted rewrite: the mesh sample sort over ALL hosts.

    The multi-process generalization of
    :func:`ibu_jax.parallel.sort.sort_file_mesh`: the same jitted
    shard_map sample-sort program runs over the GLOBAL mesh, so the
    ``all_to_all`` exchange rides the device interconnect, and files up to
    the whole mesh's device memory sort on device.

    Host plumbing per process (``out_path`` must be on a filesystem all
    hosts share — the same assumption every multi-writer tool makes):

    * stride-deal READS: global shard ``g`` owns record positions
      ``g, g+S, …`` (the exact placement rule of the single-process
      engine — ``parallel/sort.py`` module docstring), so each process
      reads only its own devices' strided subsets of the input mmap;
    * each process ``pwrite``s its own shards' sorted runs at exact byte
      offsets derived from the allgathered per-shard counts; process 0
      pre-creates the file (header + full-size truncate) behind a
      cohort barrier, so every byte is written exactly once.
    """
    from jax.experimental import multihost_utils

    from ibu_jax.constructs.header import HEADER_SIZE, Header
    from ibu_jax.constructs.record import RECORD_SIZE
    from ibu_jax.parallel.sort import (
        _build_sort_program,
        _cdiv as _sort_cdiv,
        _shape_bucket,
        _verify_hints_host,
    )
    from ibu_jax.pipelines import _require_plain

    if jax.process_count() == 1:
        from ibu_jax.parallel.sort import sort_file_mesh

        sort_file_mesh(
            in_path, out_path, mesh=mesh, index_bits=index_bits,
            slack=slack,
        )
        return

    _require_plain(in_path, "sort")
    mesh = mesh or make_mesh()
    s = mesh.devices.size
    reader = MmapReader(in_path)
    header = reader.header()
    records = reader.records  # mmap view — no bulk copy
    b = reader.len()

    # hints: identical on every process (hi_used shapes the compiled
    # program, so per-process divergence would desynchronize the cohort);
    # the index probe scans the shared mmap, same bytes everywhere
    if index_bits is None:
        idx_hi = np.asarray(records["index"]) >> np.uint64(32)
        index_bits = 32 if not idx_hi.any() else None
    hi_used = (
        header.bc_len > 16,
        header.umi_len > 16,
        index_bits is None or index_bits > 32,
    )
    if not all(hi_used):
        _verify_hints_host(records, hi_used)

    local_n = _shape_bucket(_sort_cdiv(max(b, 1), s))
    c_send = min(max(64, int(_sort_cdiv(local_n, s) * slack)), local_n)

    # stride-dealt blocks for THIS process's devices only
    devs = list(mesh.devices.flat)
    pid = jax.process_index()
    local_gids = [g for g, d in enumerate(devs) if d.process_index == pid]
    blocks, valid_local = [], []
    for g in local_gids:
        sub = np.ascontiguousarray(records[g::s]).view(np.uint32)
        sub = sub.reshape(-1, 6)
        valid_local.append(sub.shape[0])
        if sub.shape[0] < local_n:
            sub = np.concatenate(
                [sub, np.zeros((local_n - sub.shape[0], 6), np.uint32)]
            )
        blocks.append(sub)
    g_raw = process_local_placer(
        np.concatenate(blocks), mesh, P(AXIS, None)
    )
    g_valid = process_local_placer(
        np.asarray(valid_local, dtype=np.int32), mesh, P(AXIS)
    )

    mesh_key = (mesh.axis_names, tuple(d.id for d in devs))
    program = _build_sort_program(
        mesh, mesh_key, local_n, c_send, samples_per_shard, hi_used
    )
    out_raw, out_valid, overflow = program(g_raw, g_valid)

    # cohort-wide counts/overflow: each process contributes its shards'
    # slots of a dense (S,) vector; the allgather+sum is ordering-proof
    cnt_local = np.zeros(s, dtype=np.int64)
    ovf_local = False
    for sh in out_valid.addressable_shards:
        cnt_local[sh.index[0].start] = int(np.asarray(sh.data)[0])
    for sh in overflow.addressable_shards:
        ovf_local |= bool(np.asarray(sh.data)[0])
    gathered = multihost_utils.process_allgather(
        np.concatenate([cnt_local, [np.int64(ovf_local)]])[None, :]
    ).reshape(jax.process_count(), s + 1)
    if gathered[:, s].any():
        raise ValueError(
            "sharded sort exchange overflow: a shard's range exceeded "
            f"c_send={c_send} (slack={slack}); retry with a larger slack"
        )
    counts = gathered[:, :s].sum(axis=0)
    assert int(counts.sum()) == b, (counts, b)
    offsets = HEADER_SIZE + RECORD_SIZE * (
        np.concatenate([[0], np.cumsum(counts)[:-1]])
    )

    # process 0 creates header + full-size file; barrier; everyone
    # pwrites its own shards; barrier again so the file is complete for
    # every returning process
    out_header = Header.new(header.bc_len, header.umi_len)
    out_header.flags = header.flags
    out_header.set_sorted()
    # rank 0's create rides the checkpoint (cohort rule): a quota/
    # permission error must fail every rank together, not strand the
    # others at a bare barrier until the heartbeat timeout
    failed: BaseException | None = None
    try:
        if pid == 0:
            with open(out_path, "wb") as f:
                f.write(out_header.as_bytes())
                f.truncate(HEADER_SIZE + RECORD_SIZE * b)
    except BaseException as e:
        failed = e
    _cohort_checkpoint(failed, "output creation")
    rows_per = out_raw.shape[0] // s
    try:
        fd = os.open(out_path, os.O_WRONLY)
        try:
            for sh in out_raw.addressable_shards:
                g = sh.index[0].start // rows_per
                part = np.asarray(sh.data)[: counts[g]]
                _pwrite_all(fd, np.ascontiguousarray(part).tobytes(),
                            int(offsets[g]))
        finally:
            os.close(fd)
    except BaseException as e:
        failed = e
    try:
        _cohort_checkpoint(failed, "the write pass")
    except BaseException:
        # a partial cooperative write must not survive as a full-size
        # sorted-flagged file whose dead ranges are zero records (the
        # checkpoint raises on every rank together; unlink is guarded)
        try:
            os.unlink(out_path)
        except OSError:
            pass
        raise


def multihost_dedup_file(
    in_path: str,
    out_path: str,
    mesh: Mesh | None = None,
    assume_sorted: bool | None = None,
    batch_records: int = 4 * 1024 * 1024,
) -> dict:
    """Pod-scale UMI dedup: one record per distinct (barcode, umi) pair,
    across all hosts of a slice.

    The multi-process generalization of
    :func:`ibu_jax.pipelines.dedup_file`. Unsorted inputs first run the
    pod-wide mesh sample sort (:func:`multihost_sort_file` — the
    device-heavy stage); the dedup itself partitions the sorted file by
    the reference rule (``mmap.rs:297-307``) and each process streams ONLY
    its record range:

    * the one-record carry at a range boundary is read directly from the
      shared mmap (``records[start-1]``) — no communication;
    * pass 1 counts each range's kept records (vectorized keep-mask,
      verifying sort order like the single-host pass), one allgather
      turns the counts into exact output byte offsets;
    * process 0 pre-creates the output (header + truncate) behind a
      barrier, then every process pwrites its kept records at its offset.

    ``in_path``/``out_path`` must be on a filesystem all hosts share (the
    same contract as :func:`multihost_sort_file`). Returns
    ``{"records", "molecules", "barcodes"}`` on every process.
    """
    from jax.experimental import multihost_utils

    from ibu_jax.constructs.header import HEADER_SIZE, Header
    from ibu_jax.constructs.record import RECORD_SIZE
    from ibu_jax.pipelines import (
        _dedup_batch_masks,
        _lex_nondecreasing,
        _require_plain,
        dedup_file,
    )

    if jax.process_count() == 1:
        return dedup_file(
            in_path, out_path, batch_records=batch_records,
            assume_sorted=assume_sorted,
        )

    _require_plain(in_path, "dedup")
    reader = MmapReader(in_path)
    header = reader.header()
    # every process reads the same header bytes and was launched with the
    # same flags, so this branch is cohort-uniform
    sorted_in = header.sorted() if assume_sorted is None else assume_sorted

    tmp = None
    if not sorted_in:
        tmp = out_path + ".mhsort.tmp"  # deterministic: shared by all hosts
        multihost_sort_file(in_path, tmp, mesh=mesh)
        reader = MmapReader(tmp)

    try:
        n = reader.len()
        records = reader.records
        start, end = local_record_range(n)

        def batches_with_prev():
            prev = None
            if start > 0 and end > start:
                r = records[start - 1]
                prev = (int(r["barcode"]), int(r["umi"]), int(r["index"]))
            pos = start
            while pos < end:
                stop = min(pos + batch_records, end)
                batch = np.asarray(records[pos:stop])
                bc, umi, idx = (
                    batch["barcode"], batch["umi"], batch["index"],
                )
                if not _lex_nondecreasing(bc, umi, idx, prev):
                    if tmp is not None:
                        raise ValueError(
                            "internal error: the pod mesh sort produced "
                            f"out-of-order output near record {pos} of "
                            f"{tmp}; please report this"
                        )
                    raise ValueError(
                        f"{in_path}: records are not in sorted order near "
                        f"record {pos} despite the sorted flag; re-sort, "
                        "or pass assume_sorted=False (CLI: "
                        "--assume-sorted no)"
                    )
                keep, bc_first = _dedup_batch_masks(bc, umi, prev)
                prev = (int(bc[-1]), int(umi[-1]), int(idx[-1]))
                yield batch, keep, bc_first
                pos = stop

        # the order verification must fail COHORT-UNIFORMLY: a lone rank
        # raising here while the others proceed to the allgather would
        # deadlock the cohort until the runtime heartbeat timeout, so the
        # verdict travels inside the count allgather and every rank raises
        kept = bc_firsts = 0
        order_error: str | None = None
        try:
            for _, keep, bc_first in batches_with_prev():
                kept += int(keep.sum())
                bc_firsts += int(bc_first.sum())
        except ValueError as e:
            order_error = str(e)

        gathered = multihost_utils.process_allgather(
            np.asarray(
                [[kept, bc_firsts, int(order_error is not None)]],
                dtype=np.int64,
            )
        ).reshape(jax.process_count(), 3)
        if gathered[:, 2].any():
            raise ValueError(
                order_error
                or "records are not in sorted order in another process's "
                "record range (see that rank's error for the position)"
            )
        total_kept = int(gathered[:, 0].sum())
        my_offset = int(gathered[: jax.process_index(), 0].sum())

        out_header = Header.new(header.bc_len, header.umi_len)
        out_header.flags = header.flags
        out_header.set_sorted()
        # rank 0's create follows the cohort rule (failure travels as
        # data): a quota/permission error must fail every rank, not leave
        # the others blocked at a bare barrier
        failed: BaseException | None = None
        try:
            if jax.process_index() == 0:
                with open(out_path, "wb") as f:
                    f.write(out_header.as_bytes())
                    f.truncate(HEADER_SIZE + RECORD_SIZE * total_kept)
        except BaseException as e:
            failed = e
        _cohort_checkpoint(failed, "output creation")

        pos_out = HEADER_SIZE + RECORD_SIZE * my_offset
        try:
            fd = os.open(out_path, os.O_WRONLY)
            try:
                for batch, keep, _ in batches_with_prev():
                    data = np.ascontiguousarray(batch[keep]).tobytes()
                    _pwrite_all(fd, data, pos_out)
                    pos_out += len(data)
            finally:
                os.close(fd)
        except BaseException as e:
            failed = e
        try:
            _cohort_checkpoint(failed, "the write pass")
        except BaseException:
            # a partial cooperative write would otherwise survive as a
            # full-size, valid-looking file whose dead ranges are zero
            # records (_removed_on_error parity; the checkpoint raises on
            # every rank together, so each unlinks, guarded)
            try:
                os.unlink(out_path)
            except OSError:
                pass
            raise
    finally:
        if tmp is not None and jax.process_index() == 0:
            # shared-FS unlink can fail (ESTALE/EACCES, already gone); an
            # OSError raised from finally would replace the in-flight
            # exception — match the guarded cleanup of multihost_ingest_fastq
            try:
                os.unlink(tmp)
            except OSError:
                pass

    return {
        "records": n,
        "molecules": total_kept,
        "barcodes": int(gathered[:, 1].sum()),
    }


def _multihost_rewrite(
    reader: MmapReader,
    out_path: str,
    out_header,
    transform,
    batch_records: int,
    stat_keys: tuple = (),
    track_order: bool = False,
    spool: bool = False,
):
    """Range-partitioned streaming record rewrite across the cohort.

    The shared engine under :func:`multihost_filter_file` and
    :func:`multihost_correct_file`: the input partitions by the reference
    rule, each process streams only its range through ``transform(batch)
    -> (out_records, {stat: int})``, one allgather of kept counts (+ stat
    sums) becomes exact output byte offsets, and every process pwrites its
    output behind a create barrier.

    ``spool=False``: ``transform`` must be deterministic — it runs twice
    (count pass, then write pass) so memory stays bounded at one batch;
    right when the transform is cheap vectorized numpy (filter).
    ``spool=True``: the count pass writes transformed records to a
    rank-LOCAL temp file (host scratch, not the shared FS) and the write
    pass byte-copies it to the final offset — right when the transform
    dominates (correct's device Hamming probe would otherwise run twice
    per record).

    With ``track_order=True`` the return includes whether the GLOBAL
    written stream is lexicographically nondecreasing (each rank verifies
    its own stream; rank-boundary pairs check after the allgather) — the
    caller can then patch the sorted flag, replacing the single-host
    pass's running verification.

    Returns ``(total_kept, {stat: total}, globally_sorted | None)``.
    """
    from jax.experimental import multihost_utils

    from ibu_jax.constructs.header import HEADER_SIZE
    from ibu_jax.constructs.record import RECORD_SIZE
    from ibu_jax.pipelines import _lex_nondecreasing

    n = reader.len()
    records = reader.records
    start, end = local_record_range(n)

    def out_batches():
        for pos in range(start, end, batch_records):
            batch = np.asarray(records[pos:min(pos + batch_records, end)])
            yield transform(batch)

    spool_file = None
    if spool:
        import tempfile

        spool_file = tempfile.TemporaryFile(
            prefix="ibu_mh_rewrite_", suffix=".spool"
        )
    kept = 0
    stats = dict.fromkeys(stat_keys, 0)
    local_sorted = True
    first = last = None
    for out, inc in out_batches():
        kept += len(out)
        for k in stat_keys:
            stats[k] += int(inc.get(k, 0))
        if spool_file is not None and len(out):
            spool_file.write(np.ascontiguousarray(out).tobytes())
        if track_order and len(out):
            if local_sorted and not _lex_nondecreasing(
                out["barcode"], out["umi"], out["index"], last
            ):
                local_sorted = False
            tail = out[-1]
            last = (int(tail["barcode"]), int(tail["umi"]),
                    int(tail["index"]))
            if first is None:
                head = out[0]
                first = (int(head["barcode"]), int(head["umi"]),
                         int(head["index"]))

    # one allgather: kept, stat sums, and (when order-tracked) the local
    # sorted verdict + boundary triples, all as uint64 lanes
    lane = [kept] + [stats[k] for k in stat_keys]
    if track_order:
        lane += [int(local_sorted), int(first is not None)]
        lane += list(first or (0, 0, 0)) + list(last or (0, 0, 0))
    gathered = multihost_utils.process_allgather(
        np.asarray([lane], dtype=np.uint64)
    ).reshape(jax.process_count(), len(lane))
    total_kept = int(gathered[:, 0].sum())
    totals = {
        k: int(gathered[:, 1 + i].sum()) for i, k in enumerate(stat_keys)
    }
    globally_sorted = None
    if track_order:
        base = 1 + len(stat_keys)
        globally_sorted = bool(gathered[:, base].all())
        if globally_sorted:
            prev_last = None
            for row in gathered:
                if not row[base + 1]:
                    continue  # rank wrote nothing
                r_first = tuple(int(v) for v in row[base + 2:base + 5])
                if prev_last is not None and r_first < prev_last:
                    globally_sorted = False
                    break
                prev_last = tuple(int(v) for v in row[base + 5:base + 8])

    my_offset = int(gathered[: jax.process_index(), 0].sum())
    # the cohort rule applies to rank 0's create too: a quota/permission/
    # ENOSPC failure here must reach every rank as data, not strand them
    # at a bare barrier until the heartbeat timeout
    failed: BaseException | None = None
    try:
        if jax.process_index() == 0:
            with open(out_path, "wb") as f:
                f.write(out_header.as_bytes())
                f.truncate(HEADER_SIZE + RECORD_SIZE * total_kept)
    except BaseException as e:
        failed = e
    _cohort_checkpoint(failed, "output creation")

    pos_out = HEADER_SIZE + RECORD_SIZE * my_offset
    try:
        fd = os.open(out_path, os.O_WRONLY)
        try:
            if spool_file is not None:
                spool_file.seek(0)
                while chunk := spool_file.read(1 << 23):
                    _pwrite_all(fd, chunk, pos_out)
                    pos_out += len(chunk)
            else:
                for out, _ in out_batches():
                    data = np.ascontiguousarray(out).tobytes()
                    _pwrite_all(fd, data, pos_out)
                    pos_out += len(data)
        finally:
            os.close(fd)
            if spool_file is not None:
                spool_file.close()
    except BaseException as e:
        failed = e
    try:
        _cohort_checkpoint(failed, "the write pass")
    except BaseException:
        # _removed_on_error parity: a partial cooperative write must not
        # survive as a full-size file whose dead ranges are zero records.
        # The checkpoint raises on EVERY rank together, so each unlinks
        # (guarded — another rank may already have removed it).
        try:
            os.unlink(out_path)
        except OSError:
            pass
        raise
    return total_kept, totals, globally_sorted


def multihost_filter_file(
    in_path: str,
    out_path: str,
    barcodes,
    invert: bool = False,
    batch_records: int = 4 * 1024 * 1024,
) -> dict:
    """Pod-scale allowlist filtering: :func:`ibu_jax.pipelines.filter_file`
    with every host streaming only its record range (shared-filesystem
    contract of :func:`multihost_sort_file`). Record order — and therefore
    the input's sorted flag — survives because the ranges are contiguous
    and in rank order. Output is byte-identical to the single-host tool.
    """
    from ibu_jax.constructs.header import Header
    from ibu_jax.pipelines import _require_plain, allowlist_mask, filter_file

    if jax.process_count() == 1:
        return filter_file(
            in_path, out_path, barcodes, invert=invert,
            batch_records=batch_records,
        )

    _require_plain(in_path, "filter_file")
    allow = np.unique(np.asarray(list(barcodes), dtype=np.uint64))
    reader = MmapReader(in_path)
    header = reader.header()
    out_header = Header.new(header.bc_len, header.umi_len)
    out_header.flags = header.flags  # sorted flag survives

    def transform(batch):
        return batch[allowlist_mask(batch["barcode"], allow, invert)], {}

    kept, _, _ = _multihost_rewrite(
        reader, out_path, out_header, transform, batch_records
    )
    return {
        "records": reader.len(),
        "kept": kept,
        "allowlist": int(len(allow)),
    }


def multihost_correct_file(
    in_path: str,
    out_path: str,
    barcodes,
    batch_records: int = 4 * 1024 * 1024,
    keep_unmatched: bool = False,
) -> dict:
    """Pod-scale Hamming-1 barcode correction:
    :func:`ibu_jax.pipelines.correct_file` with every host streaming only
    its record range. The output sorted flag follows the single-host
    observed-order convention, verified ACROSS ranks (local verification +
    boundary-pair checks through the count allgather); process 0 patches
    the flag after the write barrier, so every returning process sees the
    final header. Output bytes match the single-host tool exactly.
    """
    import struct

    from jax.experimental import multihost_utils

    from ibu_jax.constructs.header import Header
    from ibu_jax.ops.correct import CORRECTED, DROP, EXACT, correct_batch
    from ibu_jax.pipelines import _require_plain, correct_file

    if jax.process_count() == 1:
        return correct_file(
            in_path, out_path, barcodes, batch_records=batch_records,
            keep_unmatched=keep_unmatched,
        )

    _require_plain(in_path, "correct_file")
    allow = np.unique(np.asarray(list(barcodes), dtype=np.uint64))
    reader = MmapReader(in_path)
    header = reader.header()
    out_header = Header.new(header.bc_len, header.umi_len)

    def transform(batch):
        batch = batch.copy()
        fixed, status = correct_batch(batch["barcode"], allow, header.bc_len)
        batch["barcode"] = fixed
        keep = (
            np.ones(len(batch), dtype=bool)
            if keep_unmatched
            else status != DROP
        )
        return batch[keep], {
            "exact": int(np.count_nonzero(status == EXACT)),
            "corrected": int(np.count_nonzero(status == CORRECTED)),
            "dropped": int(np.count_nonzero(status == DROP)),
        }

    kept, totals, globally_sorted = _multihost_rewrite(
        reader, out_path, out_header, transform, batch_records,
        stat_keys=("exact", "corrected", "dropped"), track_order=True,
        spool=True,  # the Hamming probe dominates; don't run it twice
    )
    if globally_sorted and kept > 0 and jax.process_index() == 0:
        out_header.set_sorted()
        with open(out_path, "r+b") as f:
            f.seek(16)
            f.write(struct.pack("<Q", out_header.flags))
    multihost_utils.sync_global_devices("ibu_multihost_correct_flag")
    return {
        "records": reader.len(),
        "exact": totals["exact"],
        "corrected": totals["corrected"],
        "dropped": totals["dropped"],
        "allowlist": int(len(allow)),
    }


#: barcode samples contributed per rank to the splitter election
_COUNT_SPLIT_SAMPLES = 512


def multihost_count_matrix(
    in_path: str,
    out_prefix: str,
    batch_records: int = 4 * 1024 * 1024,
    dedup: bool = True,
) -> dict:
    """Pod-scale barcode × index count matrix:
    :func:`ibu_jax.pipelines.count_matrix` (host engine) with BOTH heavy
    stages — the per-batch uniquing AND the global merge/format/write —
    sharded across hosts. No stage is O(answer) on a single rank.

    1. **range partial**: every process streams only its record range
       (:func:`ibu_jax.pipelines._count_range_partial`; sorted inputs
       keep the O(n) adjacent-diff with a boundary carry).
    2. **splitters**: each rank allgathers evenly-spaced samples of its
       partial's (nondecreasing) barcode column; rank *d* owns barcode
       range ``[sp[d-1], sp[d])`` — a barcode belongs wholly to one rank.
    3. **exchange** via ``{out_prefix}.mh_count.partN.npz`` on the shared
       filesystem: the partial is nondecreasing in barcode, so each
       destination's rows are ONE contiguous slice (``searchsorted``);
       the file also carries the rank's sorted unique-index array.
    4. **range merge**: rank *d* merges only its barcode range
       (:func:`_count_pairs_from_partials` on its slices — cross-range
       duplicates of a triple land at the same destination, so the
       semantics match the old rank-0 merge exactly); the GLOBAL unique
       index array is the union of every rank's index member, computed
       identically on all ranks.
    5. **cooperative output**: entries are globally row-major by
       construction (disjoint barcode ranges in rank order; each block
       internally (row, col)-sorted), so each rank formats its own
       ``.mtx`` entry block, ``barcodes.txt`` block (fixed ``bc_len+1``
       bytes/line), and ``indices.txt`` slice, and pwrites them at exact
       byte offsets from one allgather of block sizes. The trio is
       byte-identical to the single-host tool (cluster-tested).

    EVERY local failure travels through a checkpoint allgather (cohort
    rule) so all ranks fail together; a failed cooperative write unlinks
    all three outputs on every rank (guarded).
    """
    from ibu_jax.ops import codec as C
    from ibu_jax.pipelines import (
        _count_pairs_from_partials,
        _count_range_partial,
        _format_mtx_entries,
        _require_plain,
        count_matrix,
    )

    if jax.process_count() == 1:
        return count_matrix(
            in_path, out_prefix, batch_records=batch_records, dedup=dedup,
            engine="host",
        )

    from jax.experimental import multihost_utils

    _require_plain(in_path, "count_matrix")
    reader = MmapReader(in_path)
    header = reader.header()
    n = reader.len()
    start, end = local_record_range(n)
    pid = jax.process_index()
    nprocs = jax.process_count()
    u64max = np.uint64(0xFFFFFFFFFFFFFFFF)

    failed: BaseException | None = None
    part_path = f"{out_prefix}.mh_count.part{pid}.npz"
    out_paths = (f"{out_prefix}.mtx", f"{out_prefix}.barcodes.txt",
                 f"{out_prefix}.indices.txt")
    try:
        # -- stage 1: range partial (kept in memory for the later slice) --
        keys = weights = None
        try:
            keys, weights = _count_range_partial(
                reader, start, end, dedup, batch_records, in_path,
                boundary_carry=True,
            )
        except BaseException as e:
            failed = e
        _cohort_checkpoint(failed, "the range-partial pass")

        # -- stage 2: splitter election (pure collectives; cannot fail
        # locally) -- every rank samples its nondecreasing barcode column
        s_n = _COUNT_SPLIT_SAMPLES
        bc_col = keys["barcode"]
        if len(bc_col):
            samples = bc_col[_even_sample_positions(len(bc_col), s_n)]
        else:
            samples = np.full(s_n, u64max, dtype=np.uint64)
        gathered = np.sort(  # allgather output is a read-only view
            multihost_utils.process_allgather(
                samples[None, :].astype(np.uint64)
            ).reshape(nprocs * s_n)
        )
        sp_at = _splitter_cut_indices(len(gathered), nprocs)
        splitters = gathered[sp_at]  # (nprocs-1,) — rank d owns
        # barcodes b with (# splitters <= b) == d

        # -- stage 3: exchange write (per-destination contiguous slices) --
        try:
            cuts = np.concatenate(
                [[0], np.searchsorted(bc_col, splitters, side="right"),
                 [len(keys)]]
            )
            payload = {"idx": np.unique(keys["index"])}
            for d in range(nprocs):
                payload[f"k{d}"] = keys[cuts[d]:cuts[d + 1]]
                if weights is not None:
                    payload[f"w{d}"] = weights[cuts[d]:cuts[d + 1]]
            np.savez(part_path, **payload)
        except BaseException as e:
            failed = e
        _cohort_checkpoint(failed, "the exchange write")

        # -- stage 4: merge MY barcode range + the (identical) index union --
        pairs = counts = indices = bc_u = None
        try:
            key_parts, weight_parts, idx_parts = [], [], []
            for r in range(nprocs):
                with np.load(f"{out_prefix}.mh_count.part{r}.npz") as z:
                    key_parts.append(z[f"k{pid}"])
                    if f"w{pid}" in z:
                        weight_parts.append(z[f"w{pid}"])
                    idx_parts.append(z["idx"])
            indices = np.unique(np.concatenate(idx_parts))
            pairs, counts = _count_pairs_from_partials(
                key_parts, weight_parts, dedup=dedup,
                presorted=dedup and header.sorted(),  # carried ranges
            )
            bc_u = np.unique(pairs["barcode"])
        except BaseException as e:
            failed = e
        gathered = _cohort_checkpoint(
            failed, "the range merge",
            (0, 0, 0) if failed is not None else
            (len(bc_u), len(pairs), int(counts.sum())),
        )
        r_total = int(gathered[:, 0].sum())
        nnz = int(gathered[:, 1].sum())
        molecules = int(gathered[:, 2].sum())
        prefix_bc = int(gathered[:pid, 0].sum())

        # -- stage 5: format my blocks; offsets from one size allgather --
        mtx_block = bc_block = idx_block = b""
        try:
            if len(pairs):
                row = prefix_bc + np.searchsorted(bc_u, pairs["barcode"])
                col = np.searchsorted(indices, pairs["index"])
                mtx_block = _format_mtx_entries(
                    row + 1, col + 1, np.asarray(counts)
                ).encode()
            bc_block = "".join(
                s + "\n" for s in C.decode_seqs(bc_u, header.bc_len)
            ).encode()
            i_lo, i_hi = partition(len(indices), nprocs)[pid]
            idx_block = "".join(
                f"{int(i)}\n" for i in indices[i_lo:i_hi]
            ).encode()
        except BaseException as e:
            failed = e
        gathered = _cohort_checkpoint(
            failed, "the block formatting",
            (len(mtx_block), len(idx_block)),
        )
        mtx_head = (
            "%%MatrixMarket matrix coordinate integer general\n"
            "%rows=barcodes cols=record-indices "
            f"source={in_path} dedup={dedup}\n"
            f"{r_total} {len(indices)} {nnz}\n"
        ).encode()
        mtx_off = len(mtx_head) + int(gathered[:pid, 0].sum())
        mtx_size = len(mtx_head) + int(gathered[:, 0].sum())
        bc_off = prefix_bc * (header.bc_len + 1)
        bc_size = r_total * (header.bc_len + 1)
        idx_off = int(gathered[:pid, 1].sum())
        idx_size = int(gathered[:, 1].sum())

        try:
            if pid == 0:
                with open(out_paths[0], "wb") as f:
                    f.write(mtx_head)
                    f.truncate(mtx_size)
                with open(out_paths[1], "wb") as f:
                    f.truncate(bc_size)
                with open(out_paths[2], "wb") as f:
                    f.truncate(idx_size)
        except BaseException as e:
            failed = e
        _cohort_checkpoint(failed, "output creation")

        try:
            for path, block, off in (
                (out_paths[0], mtx_block, mtx_off),
                (out_paths[1], bc_block, bc_off),
                (out_paths[2], idx_block, idx_off),
            ):
                if not block:
                    continue
                fd = os.open(path, os.O_WRONLY)
                try:
                    _pwrite_all(fd, block, off)
                finally:
                    os.close(fd)
        except BaseException as e:
            failed = e
        try:
            _cohort_checkpoint(failed, "the write pass")
        except BaseException:
            # a partial cooperative write must not survive as a valid-
            # looking trio (every rank raises together; unlinks guarded)
            for path in out_paths:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            raise

        return {
            "barcodes": r_total,
            "indices": int(len(indices)),
            "entries": nnz,
            "molecules": molecules,
            "records": n,
        }
    finally:
        try:
            os.unlink(part_path)
        except OSError:
            pass


def multihost_ingest_fastq(
    fastq_path: str,
    ibu_path: str,
    bc_len: int,
    umi_len: int,
    batch: int = 200_000,
    validate: bool = True,
) -> int:
    """Pod-scale FASTQ → sorted IBU: the whole ingest pipeline sharded.

    A plain (uncompressed) FASTQ splits EXACTLY across hosts without
    parsing it twice:

    * raw byte ranges partition by the reference rule; each host counts
      the newlines in its range (one vectorized memmap scan) and one
      allgather gives every host the global line index at its range
      start — so the every-4th-line phase, the 1-based line numbers in
      errors, and each host's global READ index base all follow by
      arithmetic, no communication in the parse itself;
    * range starts align forward to the next line start (a line whose
      first byte is in a range belongs to that host and is consumed to
      its real end, even past the cut — the byte-range contract of
      :func:`ibu_jax.pipelines.fastq_prefix_batches`);
    * each host parses + device-encodes only its reads and pwrites them
      at its exact offset of a shared unsorted temp, then the pod-wide
      mesh sample sort (:func:`multihost_sort_file`) produces the final
      sorted file.

    Parse/validate/IO failures are cohort-uniform (checkpoint allgather,
    like :func:`multihost_count_matrix`). Gzip/zstd FASTQs have no
    random access — ingest those single-host. Returns the pod-wide read
    count on every process.
    """
    from jax.experimental import multihost_utils

    from ibu_jax.constructs.header import HEADER_SIZE, Header
    from ibu_jax.constructs.record import RECORD_SIZE
    from ibu_jax.io.compression import infer_compression, sniff_compression
    from ibu_jax.ops import codec as C
    from ibu_jax.pipelines import (
        encode_batch,
        fastq_prefix_batches,
        ingest_fastq,
    )

    if jax.process_count() == 1:
        return ingest_fastq(
            fastq_path, ibu_path, bc_len, umi_len, batch=batch,
            validate=validate,
        )

    with open(fastq_path, "rb") as f:
        kind = sniff_compression(f.read(4))
    if kind is not None:
        raise ValueError(
            f"{fastq_path} is {kind}-compressed: no random access to "
            "shard it across hosts — decompress first, or ingest "
            "single-host (compressed ingest streams fine there)"
        )
    if infer_compression(ibu_path):
        raise ValueError(
            "compressed output cannot be pwritten cooperatively; use a "
            "plain .ibu output (compress it afterwards if needed)"
        )

    nprocs = jax.process_count()
    pid = jax.process_index()
    prefix_len = bc_len + umi_len
    size = os.path.getsize(fastq_path)
    lo, hi = partition(size, nprocs)[pid]
    # mode="r": pod-shared inputs are routinely on read-only mounts (the
    # memmap default "r+" would fail there while single-host ingest works)
    mm = np.memmap(fastq_path, np.uint8, mode="r") if size else None

    # newlines in my raw range + my aligned start (first line start >= lo)
    nl_mine = 0
    for p in range(lo, hi, 1 << 26):
        nl_mine += int(
            np.count_nonzero(mm[p:min(p + (1 << 26), hi)] == 10)
        )
    aligned = lo
    if lo > 0 and mm[lo - 1] != 10:
        nxt = lo
        aligned = size  # no line starts at/after lo unless a \n is found
        while nxt < size:
            stop = min(nxt + (1 << 26), size)
            hits = np.flatnonzero(mm[nxt:stop] == 10)
            if len(hits):
                aligned = nxt + int(hits[0]) + 1
                break
            nxt = stop

    gathered = multihost_utils.process_allgather(
        np.asarray([[nl_mine, aligned]], dtype=np.int64)
    ).reshape(nprocs, 2)
    nl_before = int(gathered[:pid, 0].sum())
    line_base = nl_before + (1 if aligned > lo else 0)
    total_nl = int(gathered[:, 0].sum())
    total_lines = total_nl + (1 if size and mm[size - 1] != 10 else 0)

    # global line index at every rank's aligned start, by the same rule
    # (deterministic: derived from the allgathered counts + aligned flags)
    line_starts = [
        int(gathered[:r, 0].sum())
        + (1 if gathered[r, 1] > partition(size, nprocs)[r][0] else 0)
        for r in range(nprocs)
    ] + [total_lines]

    def seq_lines_below(x: int) -> int:  # lines with index % 4 == 1
        return (x + 2) // 4

    reads = [
        seq_lines_below(line_starts[r + 1]) - seq_lines_below(line_starts[r])
        for r in range(nprocs)
    ]
    total = int(sum(reads))
    base = int(sum(reads[:pid]))

    failed: BaseException | None = None
    tmp = ibu_path + ".mhingest.tmp"
    header = Header.new(bc_len, umi_len)
    try:
        # output creation rides the checkpoint too (the cohort rule): a
        # rank-0 quota/permission error must fail every rank, not leave
        # the others blocked at a bare barrier
        try:
            if pid == 0:
                with open(tmp, "wb") as f:
                    f.write(header.as_bytes())
                    f.truncate(HEADER_SIZE + RECORD_SIZE * total)
        except BaseException as e:
            failed = e
        _cohort_checkpoint(failed, "output creation")

        written = 0
        try:
            fd = os.open(tmp, os.O_WRONLY)
            try:
                pos_out = HEADER_SIZE + RECORD_SIZE * base
                # parse ahead on a background thread, exactly like the
                # single-host ingest: inflation/parsing overlaps encode
                from ibu_jax.io.stream import thread_prefetched

                for prefixes in thread_prefetched(
                    fastq_prefix_batches(
                        fastq_path, prefix_len, batch,
                        byte_range=(aligned, hi), line_base=line_base,
                    ),
                    depth=2,
                ):
                    if validate:
                        C.np_validate_ascii(prefixes)
                    idx = np.arange(
                        base + written, base + written + len(prefixes),
                        dtype=np.uint64,
                    )
                    records = encode_batch(
                        prefixes[:, :bc_len], prefixes[:, bc_len:], idx
                    )
                    data = np.ascontiguousarray(records).tobytes()
                    _pwrite_all(fd, data, pos_out)
                    pos_out += len(data)
                    written += len(prefixes)
            finally:
                os.close(fd)
            if written != reads[pid]:  # arithmetic vs parse cross-check
                raise AssertionError(
                    f"rank {pid} parsed {written} reads, expected "
                    f"{reads[pid]} from the line arithmetic"
                )
        except BaseException as e:
            failed = e
        _cohort_checkpoint(failed, "the parse/encode pass")

        # a pre-existing ibu_path is only replaced by the sort stage,
        # which cleans up its own partial writes on failure — no outer
        # unlink of the output (it would destroy an older good file on a
        # parse error that never touched it)
        multihost_sort_file(tmp, ibu_path)
        return total
    finally:
        if pid == 0:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def multihost_export_fastq(
    ibu_path: str,
    fastq_path: str,
    batch_records: int = 1 << 20,
    qual: str = "I",
) -> tuple[int, int, str]:
    """Pod-scale FASTQ export: every host decodes only its record range
    into its own shard file (``reads.fastq.gz`` → ``reads.part3.fastq.gz``
    on process 3 — per-host shards are the operational FASTQ convention,
    and compressed streams cannot be pwritten cooperatively anyway).

    Read names carry the record index, so concatenating the shards in
    rank order reproduces the single-host export exactly. Returns
    ``(total_reads, local_reads, this_process_shard_path)``; the total is
    allgathered so every process knows the pod-wide count alongside what
    its own shard holds.
    """
    from jax.experimental import multihost_utils

    from ibu_jax.pipelines import _require_plain, export_fastq

    if jax.process_count() == 1:
        mine = export_fastq(
            ibu_path, fastq_path, batch_records=batch_records, qual=qual
        )
        return mine, mine, fastq_path

    _require_plain(ibu_path, "export-fastq --distributed")
    reader = MmapReader(ibu_path)
    start, end = local_record_range(reader.len())

    d, base = os.path.split(fastq_path)
    dot = base.find(".")
    pid = jax.process_index()
    shard = (
        f"{base}.part{pid}" if dot < 0
        else f"{base[:dot]}.part{pid}{base[dot:]}"
    )
    shard_path = os.path.join(d, shard)

    mine = export_fastq(
        ibu_path, shard_path, batch_records=batch_records, qual=qual,
        record_range=(start, end),
    )
    total = int(
        multihost_utils.process_allgather(
            np.asarray([mine], dtype=np.int64)
        ).sum()
    )
    return total, mine, shard_path


def multihost_map_reduce(
    path: str,
    engine,
    mesh: Mesh | None = None,
    batch_records: int = STREAM_BATCH_RECORDS,
):
    """Run any :class:`ibu_jax.parallel.device.MapReduce` over a pod slice.

    The multi-host generalization of ``MapReduce.run``: every process
    streams its own record range of ``path`` and the engine's per-shard
    states merge exactly as on a single host (``finalize`` gathers across
    processes). This is the device-mesh form of the reference's "implement
    ``ParallelProcessor`` and hand it to ``process_parallel``" extension
    point (``/root/reference/src/parallel.rs:100-189``) at pod-slice scale.
    """
    reader = MmapReader(path)
    mesh = mesh or make_mesh()

    if jax.process_count() == 1:
        return engine.run(local_record_batches(reader, batch_records), mesh=mesh)

    step = engine.compile_step(mesh)
    states = engine.initial_states(mesh, process_local_placer)
    for g_raw, g_valid in multihost_placed_batches(reader, mesh, batch_records):
        states = step(states, g_raw, g_valid)
    return engine.finalize(states)
