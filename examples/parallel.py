#!/usr/bin/env python
"""Parallel processing benchmark — parity with
``/root/reference/examples/parallel.rs:38-105``: write a large patterned
file, then mmap it and compute the three field sums in parallel, reporting
processing time.

Two engines run the same workload:

* ``--engine host``: host threads with the reference's shard partitioning
  (the direct analogue of the Rust thread engine);
* ``--engine device`` (default): record batches sharded over the jax device
  mesh, per-shard exact u64 limb-sum states, host-merged (the mesh is the
  accelerator's devices, or CPU devices where there is none).

Default 10M records; the reference's headline run is ``--records 1000``
(1B records, 24 GB).
"""

import os as _os
import sys

# the examples dir must NOT stay on sys.path: random.py (named for parity
# with the reference's random.rs) would shadow the stdlib random module
_HERE = _os.path.dirname(_os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if _os.path.abspath(p or ".") != _HERE]
sys.path.insert(0, _os.path.dirname(_HERE))

import argparse
import os
import sys
import threading
import time

from ibu_jax import BatchProcessor, MmapReader, process_parallel
from ibu_jax.utils import apply_platform_env

apply_platform_env()

CHUNK = 4 * 1024 * 1024


def write_file(filename: str, num_records: int) -> None:
    from ibu_jax.utils.datagen import parallel_fields, write_patterned_file

    start = time.perf_counter()
    write_patterned_file(filename, num_records, parallel_fields,
                         sorted_flag=True)
    dur = time.perf_counter() - start
    print(f"  Wrote {num_records} records in {dur:.2f}s "
          f"({num_records * 24 / dur / 1e9:.2f} GB/s)")


def run_host_engine(reader: MmapReader, threads: int) -> tuple[int, int, int]:
    totals = [0, 0, 0]
    lock = threading.Lock()

    class Sums(BatchProcessor):
        def __init__(self):
            self.local = [0, 0, 0]

        def process_batch(self, records):
            self.local[0] += int(records["barcode"].sum(dtype=object))
            self.local[1] += int(records["umi"].sum(dtype=object))
            self.local[2] += int(records["index"].sum(dtype=object))

        def on_batch_complete(self):
            with lock:
                for k in range(3):
                    totals[k] += self.local[k]
            self.local = [0, 0, 0]

    process_parallel(reader, Sums(), threads)
    return tuple(t & 0xFFFFFFFFFFFFFFFF for t in totals)


def run_device_engine(reader: MmapReader) -> tuple[int, int, int]:
    from ibu_jax.parallel.device import stream_file_stats

    stats = stream_file_stats(reader)
    return (stats["barcode_sum"], stats["umi_sum"], stats["index_sum"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--records", type=float, default=10.0,
                    help="records in millions (reference uses 1000)")
    ap.add_argument("--engine", choices=["host", "device", "both"],
                    default="device")
    ap.add_argument("--threads", type=int, default=0,
                    help="host engine thread count (0 = all cores)")
    ap.add_argument("--file", default="test_parallel.ibu")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()
    num_records = int(args.records * 1_000_000)

    print("IBU Parallel Processing Test")
    print("============================")
    write_file(args.file, num_records)
    reader = MmapReader(args.file)

    # expected sums for the patterned records
    i = num_records
    want_idx = i * (i - 1) // 2

    engines = ["host", "device"] if args.engine == "both" else [args.engine]
    for engine in engines:
        start = time.perf_counter()
        if engine == "host":
            sums = run_host_engine(reader, args.threads)
        else:
            sums = run_device_engine(reader)
        dur = time.perf_counter() - start
        ok = sums[2] == (want_idx & 0xFFFFFFFFFFFFFFFF)
        print(f"  [{engine}] processed {num_records} records in {dur:.2f}s "
              f"({num_records / dur / 1e6:.1f} M rec/s, "
              f"{num_records * 24 / dur / 1e9:.2f} GB/s) "
              f"checksum {'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"checksum mismatch: {sums}")

    if not args.keep:
        os.remove(args.file)
        print("✓ complete - file cleaned up")


if __name__ == "__main__":
    main()
