#!/usr/bin/env python
"""Device-side DeviceHistogram capacity (transport excluded).

The histogram sibling of tools/engine_capacity_lab.py: folds the
device-resident histogram update (per-shard sort + segment-sum, jitted
global sparse merge) over D pre-placed distinct wire batches, k times,
blocking only at the end; the k-slope cancels fixed costs. Correctness is
anchored by one exact fold over every buffer vs the numpy oracle.

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
    ap.add_argument("--barcodes", type=int, default=4096)
    ap.add_argument("--k", nargs=2, type=int, default=(8, 32))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--capacity", type=int, default=1 << 16)
    ap.add_argument("--max-uniques", type=int, default=1 << 14)
    ap.add_argument("--merge-every", type=int, default=8)
    ap.add_argument("--shard-impl", choices=("searchsorted", "scatter"),
                    default="searchsorted",
                    help="A/B the per-shard histogram formulation")
    ap.add_argument("--bc16", action="store_true",
                    help="hinted 1-key shard sort (true for this lab's "
                         "data: barcodes < 2^32)")
    ap.add_argument("--spill", choices=("on", "off"), default="on",
                    help="A/B the overflow-lane merge (round 4) vs the "
                         "strict merge")
    ap.add_argument("--sorted", action="store_true",
                    help="A/B the sorted-input fast path (round 5): "
                         "buffers sorted by barcode, assume_sorted=True "
                         "(per-shard adjacent-diff instead of the sort)")
    args = ap.parse_args()

    import jax

    from ibu_jax.parallel import device as _dev
    from ibu_jax.parallel.device import DeviceHistogram, make_mesh, shard_batch

    if args.shard_impl == "scatter":
        # monkeypatch before the first _histogram_fns build (process-local)
        _dev._masked_histogram = _dev._masked_histogram_scatter

    b = args.batch_records
    nbytes = b * 24
    mesh = make_mesh()
    log(f"platform: {jax.devices()[0].platform}, {args.buffers} resident "
        f"buffers x {nbytes/1e6:.0f} MB, {args.barcodes} barcodes")

    rng = np.random.default_rng(17)
    hosts = []
    for _ in range(args.buffers):
        raw = np.zeros((b, 6), dtype=np.uint32)
        raw[:, 0] = rng.integers(0, args.barcodes, b)  # bc_lo
        raw[:, 2] = rng.integers(0, 1 << 16, b)  # umi_lo
        raw[:, 4] = rng.integers(0, 1 << 16, b)  # idx_lo
        if args.sorted:
            raw = raw[np.argsort(raw[:, 0], kind="stable")]
        hosts.append(raw)
    placed = [shard_batch(h, mesh) for h in hosts]
    jax.block_until_ready([p[0] for p in placed])

    def fresh():
        return DeviceHistogram(
            mesh=mesh, capacity=args.capacity,
            max_uniques_per_shard=args.max_uniques,
            merge_every=args.merge_every,
            spill=args.spill == "on",
            assume_sorted=args.sorted,
        )

    # compile + warm both stages
    h = fresh()
    h.update_placed(*placed[0], bc16=args.bc16)
    h.finalize()

    def run(k):
        hist = fresh()
        t0 = time.perf_counter()
        for i in range(k):
            hist.update_placed(*placed[i % args.buffers],
                               bc16=args.bc16)
        jax.block_until_ready(hist._state["cnt"])
        return time.perf_counter() - t0, hist

    k_lo, k_hi = args.k
    if k_hi <= k_lo:
        ap.error(f"--k must be increasing, got {args.k}")
    best = {}
    for k in (k_lo, k_hi):
        best[k] = min(run(k)[0] for _ in range(args.reps))
        log(f"  k={k}: best {best[k]:.3f}s "
            f"({k*nbytes/best[k]/1e9:.1f} GB/s incl. fixed)")

    # correctness: one fold over every buffer == numpy oracle
    dt, hist = run(args.buffers)
    got = hist.finalize()
    all_bc = np.concatenate([h[:, 0] for h in hosts]).astype(np.uint64)
    vals, counts = np.unique(all_bc, return_counts=True)
    want = dict(zip(vals.tolist(), counts.tolist()))
    assert got == want, (len(got), len(want))
    log("  oracle ok")

    per_iter = (best[k_hi] - best[k_lo]) / (k_hi - k_lo)
    gbps = nbytes / per_iter / 1e9
    log(f"  slope: {per_iter*1e3:.2f} ms/batch = {gbps:.2f} GB/s device-side")
    print(json.dumps({
        "bc16": bool(args.bc16),
        "sorted": bool(args.sorted),
        "batch_records": b,
        "MB": round(nbytes / 1e6, 1),
        "barcodes": args.barcodes,
        "capacity": args.capacity,
        "max_uniques": args.max_uniques,
        "merge_every": args.merge_every,
        "best_s": best,
        "per_batch_ms": round(per_iter * 1e3, 3),
        "GB_s": round(gbps, 2),
        "Mrec_s": round(b / per_iter / 1e6, 1),
    }))


if __name__ == "__main__":
    main()
