#!/usr/bin/env python
"""Generate a random IBU file — parity with the reference CLI
(``/root/reference/examples/random.rs:8-63``): same flags, same record
distribution (barcode < --barcodes, index < --max-index, umi uniform u64),
same bandwidth report. Batch-first: records are generated and written in
vectorized chunks rather than one at a time.
"""

import os as _os
import sys

# the examples dir must NOT stay on sys.path: random.py (named for parity
# with the reference's random.rs) would shadow the stdlib random module
_HERE = _os.path.dirname(_os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if _os.path.abspath(p or ".") != _HERE]
sys.path.insert(0, _os.path.dirname(_HERE))

import argparse
import sys
import time

import numpy as np

from ibu_jax import HEADER_SIZE, RECORD_SIZE, Header, Writer
from ibu_jax.constructs.record import make_records

CHUNK = 4 * 1024 * 1024  # records per generated batch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="Output file path")
    ap.add_argument("--records", type=float, default=1.0,
                    help="Number of records to generate (in millions)")
    ap.add_argument("--barcodes", type=int, default=1_000)
    ap.add_argument("--max-index", type=int, default=10_000)
    ap.add_argument("--bc-len", type=int, default=16)
    ap.add_argument("--umi-len", type=int, default=12)
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args()

    header = Header.new(args.bc_len, args.umi_len)
    header.validate()

    rng = np.random.default_rng(args.seed)
    num_records = int(args.records * 1_000_000)

    start = time.perf_counter()
    with Writer.from_path(args.path, header) as writer:
        remaining = num_records
        while remaining > 0:
            n = min(remaining, CHUNK)
            batch = make_records(
                rng.integers(0, args.barcodes, n, dtype=np.uint64),
                rng.integers(0, 1 << 64, n, dtype=np.uint64),
                rng.integers(0, args.max_index, n, dtype=np.uint64),
            )
            writer.write_batch(batch)
            remaining -= n
    elapsed = time.perf_counter() - start

    total_bytes = HEADER_SIZE + num_records * RECORD_SIZE
    print(f"Finished generating {num_records} records", file=sys.stderr)
    print(f"Elapsed time: {elapsed:.3f}s", file=sys.stderr)
    print(f"Bandwidth: {total_bytes / elapsed / 1e9:.2f} Gb/s", file=sys.stderr)


if __name__ == "__main__":
    main()
