#!/usr/bin/env python
"""Device-side engine capacity: the streaming stats loop minus transport.

Pre-places D distinct wire batches on device, then folds the production
MapReduce step over them k times (cycling buffers, states chained — every
dispatch is distinct work), blocking only at the end. The slope between
two chain lengths cancels fixed costs. This is the number the end-to-end
engine would run at if the host→device link were not the bottleneck.

Prints one JSON dict.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from ibu_jax.utils import apply_platform_env

apply_platform_env()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch-records", type=int, default=1 << 20)
    ap.add_argument("--buffers", type=int, default=8)
    ap.add_argument("--k", nargs=2, type=int, default=(16, 64))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax

    from ibu_jax.parallel.device import (
        STATS_MAP_REDUCE,
        finalize_stats,
        make_mesh,
        shard_batch,
    )

    b = args.batch_records
    nbytes = b * 24
    mesh = make_mesh()
    log(f"platform: {jax.devices()[0].platform}, {args.buffers} resident "
        f"buffers x {nbytes/1e6:.0f} MB")

    rng = np.random.default_rng(13)
    hosts = [
        rng.integers(0, 2**32, (b, 6), dtype=np.uint64).astype(np.uint32)
        for _ in range(args.buffers)
    ]
    placed = [shard_batch(h, mesh) for h in hosts]
    jax.block_until_ready([p[0] for p in placed])

    step = STATS_MAP_REDUCE.compile_step(mesh)
    # compile + warm
    st = STATS_MAP_REDUCE.initial_states(mesh)
    st = step(st, *placed[0])
    jax.block_until_ready(st)

    def run(k):
        states = STATS_MAP_REDUCE.initial_states(mesh)
        t0 = time.perf_counter()
        for i in range(k):
            dev_raw, dev_valid = placed[i % args.buffers]
            states = step(states, dev_raw, dev_valid)
        jax.block_until_ready(states)
        return time.perf_counter() - t0, states

    k_lo, k_hi = args.k
    if k_hi <= k_lo:
        ap.error(f"--k must be increasing, got {args.k}")
    best = {}
    for k in (k_lo, k_hi):
        times = []
        for _ in range(args.reps):
            dt, states = run(k)
            times.append(dt)
        best[k] = min(times)
        log(f"  k={k}: best {best[k]:.3f}s "
            f"({k*nbytes/best[k]/1e9:.1f} GB/s incl. fixed)")
    # correctness: one fold over every buffer equals the host oracle
    stats = finalize_stats(STATS_MAP_REDUCE.finalize(run(args.buffers)[1]))
    m64 = (1 << 64) - 1
    want_idx = sum(
        int(h[:, 4].astype(np.uint64).sum())
        + (int(h[:, 5].astype(np.uint64).sum()) << 32)
        for h in hosts
    ) & m64
    assert stats["count"] == args.buffers * b, stats
    assert stats["index_sum"] == want_idx, (stats["index_sum"], want_idx)
    log("  oracle ok")

    per_iter = (best[k_hi] - best[k_lo]) / (k_hi - k_lo)
    gbps = nbytes / per_iter / 1e9
    log(f"  slope: {per_iter*1e3:.2f} ms/batch = {gbps:.1f} GB/s device-side")
    print(json.dumps({
        "batch_records": b,
        "MB": round(nbytes / 1e6, 1),
        "best_s": best,
        "per_batch_ms": round(per_iter * 1e3, 3),
        "GB_s": round(gbps, 2),
        "Mrec_s": round(b / per_iter / 1e6, 1),
    }))


if __name__ == "__main__":
    main()
