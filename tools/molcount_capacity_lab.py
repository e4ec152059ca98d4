#!/usr/bin/env python
"""Device-side capacity of the dedup/count kernels (transport excluded).

Measures ``molecule_counts`` (UMI dedup: 4-key sort + pair-first segment
sum) and ``pair_molecule_counts`` (count matrix: 6-key sort +
scatter-free triple counting) as resident-batch kernels. Unlike the
engine labs these are pure functions, so the k-slope runs INSIDE one
dispatch: a ``lax.fori_loop`` threads the output back into the input, so
no iteration can reuse another's work, and the slope between k_lo and k_hi
iterations cancels fixed dispatch/transfer costs.

Correctness is anchored by one plain run vs the numpy oracle.
Prints one JSON dict per kernel.
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
    ap.add_argument("--batch-records", type=int, default=1 << 22)
    ap.add_argument("--barcodes", type=int, default=2048)
    ap.add_argument("--indices", type=int, default=64)
    ap.add_argument("--k", nargs=2, type=int, default=(4, 16))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-uniques", type=int, default=1 << 13)
    ap.add_argument("--max-pairs", type=int, default=1 << 17)
    ap.add_argument("--hints", action="store_true",
                    help="pass bc_len=16/umi_len=16/index_bits=32 (true "
                         "for this lab's data), dropping zero hi words "
                         "from the device sorts")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ibu_jax.constructs.record import make_records
    from ibu_jax.ops.stats import (
        molecule_counts,
        molecule_counts_np,
        pair_molecule_counts,
        pair_molecule_counts_np,
    )
    from ibu_jax.ops.u64 import soa_from_records

    b = args.batch_records
    nbytes = b * 24
    log(f"platform: {jax.devices()[0].platform}, batch {b} records "
        f"({nbytes/1e6:.0f} MB), {args.barcodes} barcodes x "
        f"{args.indices} indices")

    rng = np.random.default_rng(23)
    recs = make_records(
        rng.integers(0, args.barcodes, b).astype(np.uint64),
        rng.integers(0, 1 << 16, b).astype(np.uint64),
        rng.integers(0, args.indices, b).astype(np.uint64),
    )
    soa_host = soa_from_records(recs)
    soa = jax.device_put(jnp.asarray(soa_host))
    jax.block_until_ready(soa)

    def slope(name, step, oracle_check):
        # correctness first: one plain application vs the numpy oracle
        oracle_check(soa)
        log(f"  {name}: oracle ok")

        def looped(k):
            @jax.jit
            def run(s):
                def body(_, carry):
                    s, acc = carry
                    out, tag = step(s)
                    # thread a data-dependent perturbation so iterations
                    # can't be elided or memoized; umi_lo of record 0
                    # doesn't change pair/triple structure materially
                    s = s.at[2, :1].add((tag & 1).astype(jnp.uint32))
                    return s, acc + tag
                s2, acc = jax.lax.fori_loop(0, k, body, (s, jnp.uint32(0)))
                return acc, s2[0, 0]
            return run

        k_lo, k_hi = args.k
        fns = {k: looped(k) for k in (k_lo, k_hi)}
        for k, fn in fns.items():
            jax.block_until_ready(fn(soa))  # compile + warm
        best = {}
        for k, fn in fns.items():
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(soa))
                ts.append(time.perf_counter() - t0)
            best[k] = min(ts)
            log(f"  {name}: k={k} best {best[k]*1e3:.1f} ms")
        per_iter = (best[k_hi] - best[k_lo]) / (k_hi - k_lo)
        out = {
            "kernel": name,
            "hints": bool(args.hints),
            "batch_records": b,
            "MB": round(nbytes / 1e6, 1),
            "per_batch_ms": round(per_iter * 1e3, 3),
            "GB_s": round(nbytes / per_iter / 1e9, 2),
            "Mrec_s": round(b / per_iter / 1e6, 1),
        }
        print(json.dumps(out), flush=True)

    hint_kw = (
        {"bc_len": 16, "umi_len": 16} if args.hints else {}
    )
    pair_hint_kw = dict(hint_kw, index_bits=32) if args.hints else {}

    # --- molecule_counts (dedup kernel) ---
    def mol_step(s):
        lo, hi, mol, nuniq = molecule_counts(s, args.max_uniques, **hint_kw)
        # the carry tag must consume EVERY output, or XLA dead-code
        # eliminates the counting stages and the slope times the sort
        # alone (verified: 1 vs 41 scatter ops in the optimized HLO)
        tag = (
            nuniq.astype(jnp.uint32)
            + jnp.sum(mol)
            + jnp.sum(lo)
            + jnp.sum(hi)
        )
        return (lo, hi, mol, nuniq), tag

    def mol_oracle(s):
        lo, hi, mol, nuniq = jax.block_until_ready(
            molecule_counts(s, args.max_uniques, **hint_kw)
        )
        want = molecule_counts_np(recs)
        mol_np = np.asarray(mol)
        got = {
            int(lo[i]) | (int(hi[i]) << 32): int(mol_np[i])
            for i in np.nonzero(mol_np)[0]
        }
        assert got == want and int(nuniq) == len(want), (
            len(got), len(want), int(nuniq),
        )

    slope("molecule_counts", mol_step, mol_oracle)

    # --- pair_molecule_counts (count-matrix kernel) ---
    def pair_step(s):
        rows, counts, npairs = pair_molecule_counts(
            s, max_pairs=args.max_pairs, **pair_hint_kw
        )
        tag = (
            npairs.astype(jnp.uint32)
            + jnp.sum(counts)
            + jnp.sum(rows)
        )
        return (rows, counts, npairs), tag

    def pair_oracle(s):
        rows, counts, npairs = jax.block_until_ready(
            pair_molecule_counts(s, max_pairs=args.max_pairs, **pair_hint_kw)
        )
        want = pair_molecule_counts_np(recs)
        pc = np.asarray(counts)
        pr = np.asarray(rows)
        got = {
            (
                int(pr[0, i]) | (int(pr[1, i]) << 32),
                int(pr[2, i]) | (int(pr[3, i]) << 32),
            ): int(pc[i])
            for i in np.nonzero(pc)[0]
        }
        assert got == want and int(npairs) == len(want), (
            len(got), len(want), int(npairs),
        )

    slope("pair_molecule_counts", pair_step, pair_oracle)


if __name__ == "__main__":
    main()
