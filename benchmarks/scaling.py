#!/usr/bin/env python
"""CPU correctness tool: the streaming stats engine across mesh sizes.

Runs the streaming stats engine (count + exact field checksums) over the
same file at mesh sizes 1, 2, 4, ..., all available devices, checks every
count, and reports records/s and the ratio to the single-device run. The
``--pinned-processes`` mode runs a jax.distributed cohort of CPU processes
(one pinned core each) through the multi-process engine.

Its workers are pinned to the CPU, and virtual CPU devices share physical
cores, so its rates say nothing about accelerator scaling; measured
one-to-four-card scaling belongs to a run on the cards themselves.

Prints one JSON line:
    {"devices": [...], "records_per_s": [...], "efficiency": [...]}
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from ibu_jax.utils import apply_platform_env

apply_platform_env()


PINNED_WORKER = '''
import os, sys, time
rank, nprocs, port, path, n, batch, reps = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]),
)
os.sched_setaffinity(0, {rank % os.cpu_count()})
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
sys.path.insert(0, sys.argv[8])
from ibu_jax.utils import apply_platform_env
apply_platform_env()
import jax
if nprocs > 1:
    jax.distributed.initialize(
        f"127.0.0.1:{port}", num_processes=nprocs, process_id=rank
    )
from ibu_jax.parallel.multihost import multihost_file_stats
best = float("inf")
for rep in range(reps + 1):  # rep 0 pays compilation
    t0 = time.perf_counter()
    stats = multihost_file_stats(path, batch_records=batch)
    best = min(best, time.perf_counter() - t0)
assert stats["count"] == n, stats
print(f"TIME {best:.4f}", flush=True)
'''


def run_pinned(nprocs: int, path: str, n: int, batch: int, reps: int) -> float:
    """Wall time of an nprocs-pinned-core cluster over ``path`` (max of
    per-rank bests; collectives sync the ranks)."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    repo = __file__.rsplit("/", 2)[0]
    workdir = tempfile.mkdtemp(prefix="ibu_pin_")
    worker = os.path.join(workdir, "worker.py")
    with open(worker, "w") as f:
        f.write(PINNED_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(r), str(nprocs), port, path,
             str(n), str(batch), str(reps), repo],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(nprocs)
    ]
    times = []
    for r, p in enumerate(procs):
        out, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} failed:\n{err[-2000:]}")
        times.append(float(
            [l for l in out.splitlines() if l.startswith("TIME ")][0].split()[1]
        ))
    return max(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--records", type=float, default=8.0,
                    help="records in millions")
    ap.add_argument("--batch-records", type=int, default=1 << 21)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument(
        "--kernel", choices=("stats", "sort"), default="stats",
        help="stats: streaming count+checksum engine; sort: the "
             "distributed mesh sample sort (ibu_jax.parallel.sort)",
    )
    ap.add_argument(
        "--pinned-processes", type=int, default=None, metavar="N",
        help="instead of the in-process mesh sweep, measure a pinned "
             "N-process jax.distributed cluster (one physical core + one "
             "virtual device per process) against a pinned 1-process "
             "baseline — the honest CPU-box efficiency methodology "
             "(XLA's thread pool makes unpinned 1-device baselines use "
             "every core)",
    )
    args = ap.parse_args()

    if args.pinned_processes:
        n = int(args.records * 1_000_000)
        workdir = tempfile.mkdtemp(prefix="ibu_scaling_")
        path = os.path.join(workdir, "scale.ibu")
        from ibu_jax.utils.datagen import parallel_fields, write_patterned_file

        print(f"writing {n} records...", file=sys.stderr, flush=True)
        write_patterned_file(path, n, parallel_fields)
        batch = min(args.batch_records, 1 << 20)
        t1 = run_pinned(1, path, n, batch, args.reps)
        tn = run_pinned(args.pinned_processes, path, n, batch, args.reps)
        os.remove(path)
        eff = t1 / (args.pinned_processes * tn)
        print(
            f"  1 proc {t1:.3f}s ({n/t1/1e6:.1f} M rec/s) | "
            f"{args.pinned_processes} procs {tn:.3f}s "
            f"({n/tn/1e6:.1f} M rec/s)",
            file=sys.stderr, flush=True,
        )
        print(json.dumps({
            "pinned_processes": [1, args.pinned_processes],
            "records_per_s": [round(n / t1), round(n / tn)],
            "efficiency": [1.0, round(eff, 3)],
        }))
        return

    import jax

    from ibu_jax.io.mmap import MmapReader
    from ibu_jax.parallel.device import AXIS, stream_file_stats
    from ibu_jax.utils.datagen import parallel_fields, write_patterned_file
    from jax.sharding import Mesh

    n = int(args.records * 1_000_000)
    workdir = tempfile.mkdtemp(prefix="ibu_scaling_")
    path = os.path.join(workdir, "scale.ibu")
    print(f"writing {n} records...", file=sys.stderr, flush=True)
    write_patterned_file(path, n, parallel_fields)

    devices = jax.devices()
    sizes = []
    d = 1
    while d <= len(devices):
        sizes.append(d)
        d *= 2
    if sizes[-1] != len(devices):
        sizes.append(len(devices))

    want_idx = (n * (n - 1) // 2) & 0xFFFFFFFFFFFFFFFF
    if args.kernel == "sort":
        from ibu_jax.parallel.sort import sharded_sort_records

        recs = np.asarray(MmapReader(path).records)
        oracle = np.sort(recs, order=("barcode", "umi", "index"))
    rates = []
    for size in sizes:
        mesh = Mesh(np.array(devices[:size]), (AXIS,))
        reader = MmapReader(path)
        best = float("inf")
        if args.kernel == "sort":
            got = sharded_sort_records(  # also pays compilation
                recs, mesh=mesh, bc_len=16, umi_len=12, index_bits=32
            )
            np.testing.assert_array_equal(got, oracle)
            for _ in range(args.reps):
                t0 = time.perf_counter()
                sharded_sort_records(
                    recs, mesh=mesh, bc_len=16, umi_len=12, index_bits=32
                )
                best = min(best, time.perf_counter() - t0)
        else:
            for _ in range(args.reps):
                t0 = time.perf_counter()
                stats = stream_file_stats(
                    reader, mesh=mesh, batch_records=args.batch_records
                )
                best = min(best, time.perf_counter() - t0)
            assert stats["count"] == n and stats["index_sum"] == want_idx
        rate = n / best
        rates.append(rate)
        print(f"  {size} device(s): {best:.2f}s = {rate/1e6:.1f} M rec/s",
              file=sys.stderr, flush=True)

    eff = [r / (rates[0] * s) for r, s in zip(rates, sizes)]
    os.remove(path)
    print(json.dumps({
        "devices": sizes,
        "records_per_s": [round(r) for r in rates],
        "efficiency": [round(e, 3) for e in eff],
    }))


if __name__ == "__main__":
    main()
