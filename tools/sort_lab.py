#!/usr/bin/env python
"""Device sort experiments: lax.sort operand counts for the record sort.

Times lax.sort operand-count configurations (6, 4, 3 and 1 u32 keys) for
the record-sort workload on the device. Production drops provably-zero hi
words via header hints (ibu_jax/ops/stats.py::sort_records_soa), which is
what the fewer-operand configurations stand for. Every call gets distinct
device-generated inputs, and completion is forced by fetching a slice of
the output.

Usage: python tools/sort_lab.py [--records N]
"""

from __future__ import annotations

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from ibu_jax.utils import apply_platform_env

apply_platform_env()

import numpy as np

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", type=int, default=1 << 24)
    args = ap.parse_args()
    n = args.records
    print(f"backend={jax.default_backend()} n={n}", file=sys.stderr)

    @jax.jit
    def gen(seed):
        i = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0)
        return (i * jnp.uint32(2654435761)) ^ (i >> 3) ^ seed

    def make_sort(n_ops):
        @jax.jit
        def f(x):
            iota = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0)
            umi = (x * jnp.uint32(40503)) & jnp.uint32(0xFFFFFF)
            zeros = jnp.zeros_like(x)
            if n_ops == 6:
                return jax.lax.sort(
                    (zeros, x, zeros, umi, zeros, iota), num_keys=6
                )[1]
            if n_ops == 4:
                return jax.lax.sort((x, umi, zeros, iota), num_keys=4)[0]
            if n_ops == 3:
                return jax.lax.sort((x, umi, iota), num_keys=3)[0]
            return jax.lax.sort((x,), num_keys=1)[0]

        return f

    print(f"{'operands':<10} {'median ms':>10} {'Mrec/s':>8}")
    for n_ops in (6, 4, 3, 1):
        f = make_sort(n_ops)
        _ = np.asarray(f(gen(jnp.uint32(0)))[:8])  # compile
        ts = []
        for k in range(4):
            x = gen(jnp.uint32(1000 + k))
            jax.block_until_ready(x)
            t0 = time.perf_counter()
            head = np.asarray(f(x)[:8])  # value fetch forces completion
            ts.append(time.perf_counter() - t0)
            assert np.all(np.diff(head.astype(np.int64)) >= 0)
        med = sorted(ts)[len(ts) // 2]
        print(f"{n_ops:<10} {med*1e3:>10.0f} {n/med/1e6:>8.1f}", flush=True)


if __name__ == "__main__":
    main()
