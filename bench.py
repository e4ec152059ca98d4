#!/usr/bin/env python
"""Device benchmark: the record codec against a copy, then the engine legs.

The codec leg times the fused lax record codec that XLA compiles from
:mod:`ibu_jax.ops.codec` (encode, decode, and the encode+decode roundtrip in
one jit) beside a plain device copy that moves the same number of bytes, so
each op is reported as a share of what a copy reaches on the same device.
The stream, histogram, mesh-sort and molecule-count legs follow; every leg
checks its result against a host oracle, and any failure fails the run.

Prints exactly ONE JSON line to stdout, tagged with the device it ran on
(platform, device kind and count); diagnostics go to stderr. Bytes
accounted per record (bc16/umi12): encode reads 16+12+8=36 B and writes
24 B; decode reads 24 B and writes 36 B; the roundtrip reads 36 B and
writes 36 B.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from ibu_jax.utils import apply_platform_env

apply_platform_env()

import jax
import jax.numpy as jnp

from ibu_jax.ops import codec as C
from ibu_jax.ops.u64 import records_from_soa


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_tag() -> dict:
    """The device a result was measured on, as jax reports it."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _hash_codes(shape, salt, stride):
    """Pseudo-random 2-bit codes from an iota hash (generated on device)."""
    row = jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
    col = jax.lax.broadcasted_iota(jnp.uint32, shape, 1)
    h = (col * jnp.uint32(2654435761) + row * jnp.uint32(stride) + salt)
    return (h >> 13) & 3


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def codec_inputs(n: int, bc_len: int, umi_len: int, salt):
    """One fresh input set for the codec: barcode and UMI planes (upper-
    case ASCII) and the index pair, distinct for every ``salt``."""

    def planes(length, stride):
        return C._codes_to_ascii(_hash_codes((length, n), salt, stride))

    lo = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0) + salt
    idx = jnp.stack([lo, jnp.full((n,), salt, jnp.uint32)])
    return planes(bc_len, 40503), planes(umi_len, 69069), idx


@functools.partial(jax.jit, static_argnums=0)
def _copy_input(words: int, salt):
    return jax.lax.broadcasted_iota(jnp.uint32, (words,), 0) ^ salt


@jax.jit
def _copy(x):
    return x ^ jnp.uint32(1)


def _seconds_per_call(fn, arg_sets, iters: int) -> float:
    """Wall time per call over ``iters`` passes through distinct input
    sets, ending in ``block_until_ready``; calls on one device execute in
    order, so waiting on the last output waits for all of them."""
    out = None
    t0 = time.perf_counter()
    for _ in range(iters):
        for args in arg_sets:
            out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / (iters * len(arg_sets))


def bench_codec(n: int, bc_len: int, umi_len: int, iters: int = 10,
                sets: int = 3, reps: int = 3) -> dict:
    """Time encode, decode and the fused roundtrip beside a copy of the
    same bytes.

    Every call gets a different input buffer, so no call can reuse the
    work of another and no encode can be hoisted out of a loop. The copy
    reads half and writes half of the op's byte count. ``copy_share`` is
    copy time over op time: 1.0 means the op runs at the speed of a copy.
    Op and copy alternate, and each keeps its best of ``reps``.
    """
    encode = C.lax_encode_records
    decode = functools.partial(C.lax_decode_records, bc_len=bc_len,
                               umi_len=umi_len)
    roundtrip = jax.jit(lambda bc, umi, idx: decode(encode(bc, umi, idx)))
    ins = [codec_inputs(n, bc_len, umi_len, jnp.uint32(s))
           for s in range(sets)]
    soas = [encode(*x) for x in ins]

    # oracle spot check on a prefix of the first set
    m = min(n, 4096)
    bc, umi, idx = (np.asarray(a[:, :m]) for a in ins[0])
    recs = records_from_soa(np.asarray(soas[0][:, :m]))
    want = C.np_pack(C.planes_to_rows(bc)), C.np_pack(C.planes_to_rows(umi))
    if not (np.array_equal(recs["barcode"], want[0])
            and np.array_equal(recs["umi"], want[1])
            and np.array_equal(recs["index"], C.pair_to_words(idx))):
        raise AssertionError("device codec diverged from the numpy oracle")
    back = roundtrip(*ins[0])
    if not all(np.array_equal(np.asarray(b), np.asarray(a))
               for a, b in zip(ins[0], back)):
        raise AssertionError("codec roundtrip is not the identity")

    io_bytes = n * (bc_len + umi_len + 8)  # ASCII planes + index pair
    cases = {
        "encode": (encode, ins, io_bytes + 24 * n),
        "decode": (decode, [(s,) for s in soas], 24 * n + io_bytes),
        "roundtrip": (roundtrip, ins, 2 * io_bytes),
    }
    out = {"records": n, "bc_len": bc_len, "umi_len": umi_len}
    for name, (fn, arg_sets, nbytes) in cases.items():
        copy_sets = [(_copy_input(nbytes // 8, jnp.uint32(s)),)
                     for s in range(sets)]
        for f, a in ((fn, arg_sets), (_copy, copy_sets)):
            jax.block_until_ready(f(*a[0]))  # compile + warm
        t_op = t_copy = float("inf")
        for _ in range(reps):
            t_op = min(t_op, _seconds_per_call(fn, arg_sets, iters))
            t_copy = min(t_copy, _seconds_per_call(_copy, copy_sets, iters))
        del copy_sets
        out[name] = {
            "bytes": nbytes,
            "seconds": t_op,
            "gbps": nbytes / t_op / 1e9,
            "copy_seconds": t_copy,
            "copy_gbps": nbytes / t_copy / 1e9,
            "copy_share": t_copy / t_op,
        }
        log(f"codec {name}: {t_op * 1e3:.3f} ms ({nbytes / t_op / 1e9:.1f} "
            f"GB/s), same-bytes copy {t_copy * 1e3:.3f} ms "
            f"({nbytes / t_copy / 1e9:.1f} GB/s), share {t_copy / t_op:.3f}")
    return out


def _stream_bench_file(n: int) -> str:
    from ibu_jax.constructs.record import make_records
    from ibu_jax.io.writer import Writer
    from ibu_jax.constructs.header import Header

    path = os.path.join(tempfile.gettempdir(), f"ibu_bench_stream_{n}.ibu")
    if not os.path.exists(path) or os.path.getsize(path) != 32 + 24 * n:
        rng = np.random.default_rng(7)
        recs = make_records(
            rng.integers(0, 1 << 32, n).astype(np.uint64),
            rng.integers(0, 1 << 24, n).astype(np.uint64),
            np.arange(n, dtype=np.uint64),
        )
        with Writer.from_path(path, Header.new(16, 12)) as w:
            w.write_batch(recs)
        log(f"stream bench file created: {path} ({24 * n / 1e6:.0f} MB)")
    return path


def bench_stream_file_stats(n: int) -> dict:
    """End-to-end streamed file→device stats throughput.

    Measures the flagship streaming engine — mmap → prefetched placement →
    sharded per-batch stats → merged result — over a REAL on-disk file, so
    transport and dispatch are in the loop (the codec bench above is
    device-resident only; an engine regression would be invisible to it).
    The result is verified against a host checksum oracle every run.
    """
    from ibu_jax.io.mmap import MmapReader
    from ibu_jax.ops.stats import checksum_records_np
    from ibu_jax.parallel.device import make_mesh, stream_file_stats

    path = _stream_bench_file(n)
    reader = MmapReader(path)
    mesh = make_mesh()
    got = stream_file_stats(reader, mesh=mesh)  # warm-up: compile + run
    want = checksum_records_np(np.asarray(reader.records))
    assert got["count"] == n, (got["count"], n)
    assert (got["barcode_sum"], got["umi_sum"], got["index_sum"]) == want, (
        "stream_file_stats diverged from the host oracle"
    )
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        stream_file_stats(reader, mesh=mesh)
        best = min(best, time.perf_counter() - t0)
    return {
        "records": n,
        "seconds": round(best, 4),
        "mrec_s": round(n / best / 1e6, 1),
        "gbps": round(n * 24 / best / 1e9, 3),
    }


def bench_stream_auto(n: int) -> dict:
    """End-to-end whole-file stats through the PRODUCT path
    (``pipelines.file_stats(engine="auto")``): probes the
    transport and the native host engine, routes to the fastest engine on
    this box, and reports what users actually get. Oracle-verified every run.
    """
    from ibu_jax.io.mmap import MmapReader
    from ibu_jax.ops.stats import checksum_records_np
    from ibu_jax.pipelines import file_stats

    path = _stream_bench_file(n)
    got = file_stats(path, engine="auto")  # warm: probes + compile + run
    engine = got.pop("engine")
    want = checksum_records_np(np.asarray(MmapReader(path).records))
    assert got["count"] == n, (got["count"], n)
    assert (got["barcode_sum"], got["umi_sum"], got["index_sum"]) == want, (
        f"file_stats(engine={engine}) diverged from the host oracle"
    )
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        file_stats(path, engine=engine)  # engine pinned: time the run, not the probe
        best = min(best, time.perf_counter() - t0)
    return {
        "records": n,
        "engine": engine,
        "seconds": round(best, 4),
        "mrec_s": round(n / best / 1e6, 1),
        "gbps": round(n * 24 / best / 1e9, 3),
    }


def bench_histogram_device(batch_records: int = 1 << 20,
                           buffers: int = 4) -> dict:
    """Device-resident DeviceHistogram throughput, unsorted vs the
    sorted-input fast path — transport excluded, slope
    methodology of tools/histogram_capacity_lab.py, so a histogram-engine
    regression is visible in the benchmark record.
    """
    from ibu_jax.parallel.device import DeviceHistogram, make_mesh, shard_batch

    mesh = make_mesh()
    rng = np.random.default_rng(17)
    out = {"batch_records": batch_records}
    for is_sorted in (False, True):
        hosts = []
        for _ in range(buffers):
            raw = np.zeros((batch_records, 6), dtype=np.uint32)
            raw[:, 0] = rng.integers(0, 4096, batch_records)
            raw[:, 4] = rng.integers(0, 1 << 16, batch_records)
            if is_sorted:
                raw = raw[np.argsort(raw[:, 0], kind="stable")]
            hosts.append(raw)
        placed = [shard_batch(h, mesh) for h in hosts]
        jax.block_until_ready([p[0] for p in placed])

        def fresh():
            return DeviceHistogram(
                mesh=mesh, capacity=1 << 16,
                max_uniques_per_shard=1 << 14,
                merge_every=4, assume_sorted=is_sorted,
            )

        h = fresh()  # compile + warm both stages
        h.update_placed(*placed[0], bc16=True)
        h.finalize()

        def run(k):
            hist = fresh()
            t0 = time.perf_counter()
            for i in range(k):
                hist.update_placed(*placed[i % buffers], bc16=True)
            jax.block_until_ready(hist._state["cnt"])
            return time.perf_counter() - t0

        # k multiples of merge_every so both points amortize the same
        # merges per batch and the slope isolates the per-batch cost
        k_lo, k_hi = 4, 12
        t_lo = min(run(k_lo) for _ in range(3))
        t_hi = min(run(k_hi) for _ in range(3))
        per = max((t_hi - t_lo) / (k_hi - k_lo), 1e-9)
        key = "sorted" if is_sorted else "unsorted"
        out[key + "_mrec_s"] = round(batch_records / per / 1e6, 1)
        log(f"histogram[{key}]: {per*1e3:.2f} ms/batch = "
            f"{out[key + '_mrec_s']} Mrec/s device-side")
    return out


def bench_mesh_sort(total_records: int = 1 << 20) -> dict:
    """Steady-state mesh sample-sort throughput over all local devices:
    the jitted shard_map program timed on resident data — local sorts + splitter all_gather + all_to_all exchange + merge,
    no file I/O or host transfer in the loop. S=1 on a single chip
    (degenerates to the device sort); S=8 on the CPU test mesh exercises
    the exchange.
    """
    from jax.sharding import PartitionSpec as P

    from ibu_jax.constructs.record import make_records
    from ibu_jax.parallel.device import AXIS, make_mesh
    from ibu_jax.parallel.sort import (
        _build_sort_program,
        _cdiv,
        _deal_to_shards,
    )

    mesh = make_mesh()
    s = mesh.devices.size
    rng = np.random.default_rng(29)
    records = make_records(
        rng.integers(0, 1 << 32, total_records).astype(np.uint64),
        rng.integers(0, 1 << 24, total_records).astype(np.uint64),
        np.arange(total_records, dtype=np.uint64),
    )
    dev_raw, dev_valid, local_n = _deal_to_shards(records, mesh)
    c_send = min(max(64, int(_cdiv(local_n, s) * 2.0)), local_n)
    mesh_key = (mesh.axis_names, tuple(d.id for d in mesh.devices.flat))
    program = _build_sort_program(
        mesh, mesh_key, local_n, c_send, 256, (False, False, False)
    )

    @jax.jit
    def perturb(raw, salt):
        # distinct input per call: touching one idx-lo word changes nothing
        # structural, and no call can reuse another's result
        return raw.at[0, 4].set(raw[0, 4] + salt)

    t0 = time.perf_counter()
    jax.block_until_ready(program(dev_raw, dev_valid))
    compile_s = time.perf_counter() - t0
    log(f"mesh sort first call (compile+run): {compile_s:.1f}s")

    def run(k, base):
        raw = dev_raw
        t0 = time.perf_counter()
        for i in range(k):
            raw = perturb(raw, jnp.uint32(base + i))
            out_raw, out_valid, ovf = program(raw, dev_valid)
        jax.block_until_ready(out_raw)
        return time.perf_counter() - t0

    run(2, 1000)  # warm the perturb jit
    k_lo, k_hi = 2, 6
    t_lo = min(run(k_lo, 100 * r) for r in range(3))
    t_hi = min(run(k_hi, 7000 + 100 * r) for r in range(3))
    per = max((t_hi - t_lo) / (k_hi - k_lo), 1e-9)
    return {
        "records": total_records,
        "shards": s,
        "per_sort_ms": round(per * 1e3, 2),
        "mrec_s": round(total_records / per / 1e6, 1),
    }


def bench_molecule_counts(batch_records: int = 1 << 20) -> dict:
    """Device-resident molecule_counts (UMI dedup kernel) slope
    (methodology of tools/molcount_capacity_lab.py) — the dedup/count
    engines' hot kernel, tracked per round.
    """
    from ibu_jax.constructs.record import make_records
    from ibu_jax.ops.stats import molecule_counts
    from ibu_jax.ops.u64 import soa_from_records

    rng = np.random.default_rng(23)
    recs = make_records(
        rng.integers(0, 2048, batch_records).astype(np.uint64),
        rng.integers(0, 1 << 16, batch_records).astype(np.uint64),
        rng.integers(0, 64, batch_records).astype(np.uint64),
    )
    soa = jax.device_put(jnp.asarray(soa_from_records(recs)))
    jax.block_until_ready(soa)

    def looped(k):
        @jax.jit
        def run(s):
            def body(_, carry):
                s, acc = carry
                u_bc, u_umi, counts, n = molecule_counts(
                    s, max_uniques=1 << 13, bc_len=16, umi_len=16
                )
                tag = jnp.ravel(n)[0].astype(jnp.uint32)
                s = s.at[2, :1].add(tag & 1)
                return s, acc + tag

            s2, acc = jax.lax.fori_loop(0, k, body, (s, jnp.uint32(0)))
            return acc, s2[0, 0]

        return run

    k_lo, k_hi = 2, 6
    fns = {k: looped(k) for k in (k_lo, k_hi)}
    for fn in fns.values():
        jax.block_until_ready(fn(soa))
    best = {}
    for k, fn in fns.items():
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(soa))
            ts.append(time.perf_counter() - t0)
        best[k] = min(ts)
    per = max((best[k_hi] - best[k_lo]) / (k_hi - k_lo), 1e-9)
    return {
        "batch_records": batch_records,
        "per_batch_ms": round(per * 1e3, 2),
        "mrec_s": round(batch_records / per / 1e6, 1),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--records", type=int, default=1 << 25)
    ap.add_argument("--bc-len", type=int, default=16)
    ap.add_argument("--umi-len", type=int, default=12)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--stream-records", type=int, default=None,
                    help="records for the end-to-end stream_file_stats leg "
                         "(default: --records; 0 disables)")
    ap.add_argument("--engine-legs", type=int, default=1 << 20,
                    help="batch records for the per-engine device legs "
                         "(histogram / mesh-sort / molecule-count; "
                         "0 disables)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a jax.profiler trace of the codec leg "
                         "into DIR")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip the on-device oracle validation matrix")
    args = ap.parse_args()

    device = device_tag()
    log(f"device: {device}")

    # every benchmark record carries the on-device validation result, so a
    # regression in compiled code can't hide behind a healthy number
    validate_summary = "skipped"
    if not args.no_validate:
        from ibu_jax.validate import run_matrix

        results = run_matrix()
        failed = [name for name, ok in results if not ok]
        validate_summary = f"{len(results) - len(failed)}/{len(results)}"
        log(f"on-device validation: {validate_summary} pass")
        if failed:
            raise SystemExit(f"validation failed: {', '.join(failed)}")

    codec_args = (args.records, args.bc_len, args.umi_len, args.iters)
    if args.profile:
        with jax.profiler.trace(args.profile):
            codec = bench_codec(*codec_args)
        log(f"profiler trace written to {args.profile}")
    else:
        codec = bench_codec(*codec_args)

    payload = {
        "metric": "fused codec roundtrip throughput (device-resident, "
                  f"bc{args.bc_len}/umi{args.umi_len})",
        "value": round(codec["roundtrip"]["gbps"], 2),
        "unit": "GB/s",
        "device": device,
        "validate": validate_summary,
        "codec": codec,
    }

    # end-to-end streaming legs (file → mesh → merged stats): engine and
    # transport regressions show here, not in the device-resident codec
    stream_n = (
        args.records if args.stream_records is None else args.stream_records
    )
    if stream_n:
        payload["stream"] = stream = bench_stream_auto(stream_n)
        log(
            f"file_stats auto end-to-end: {stream['records']} records via "
            f"the {stream['engine']} engine in {stream['seconds']} s = "
            f"{stream['mrec_s']} Mrec/s, oracle-verified"
        )
        payload["stream_device"] = sd = bench_stream_file_stats(stream_n)
        log(
            f"stream_file_stats (device path): {sd['records']} records in "
            f"{sd['seconds']} s = {sd['mrec_s']} Mrec/s, oracle-verified"
        )

    # per-engine device legs: a failure in any of them fails the run
    if args.engine_legs:
        for name, fn in (
            ("histogram", bench_histogram_device),
            ("mesh_sort", bench_mesh_sort),
            ("molecule_counts", bench_molecule_counts),
        ):
            payload[name] = fn(args.engine_legs)
            log(f"{name} leg: {json.dumps(payload[name])}")
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
