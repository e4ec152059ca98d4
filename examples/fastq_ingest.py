#!/usr/bin/env python
"""FASTQ → sorted IBU ingestion demo.

The end-to-end workflow the IBU format exists for: reads come in as FASTQ
(barcode+UMI in the sequence prefix, as in 10x-style libraries), get
batch-encoded to 2-bit words on the device, sorted, and written as a
sorted IBU file — then read back and summarized with the parallel engine.

    python examples/fastq_ingest.py [--reads N] [--bc-len 16] [--umi-len 12]

Generates a synthetic FASTQ if none is given (``--fastq PATH`` accepts a
real one; gzip is sniffed). Batch-first throughout: no per-read Python in
the hot path.
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
import time

import numpy as np

from ibu_jax import MmapReader
from ibu_jax.utils import apply_platform_env

apply_platform_env()


def synth_fastq(path: str, reads: int, prefix_len: int, seed: int = 0) -> None:
    """Write a synthetic FASTQ whose sequence prefix carries barcode+UMI."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    chunk = 100_000
    with open(path, "wb") as f:
        written = 0
        while written < reads:
            n = min(chunk, reads - written)
            seqs = alphabet[rng.integers(0, 4, (n, prefix_len + 20))]
            lines = []
            for i in range(n):
                lines.append(b"@read" + str(written + i).encode())
                lines.append(bytes(seqs[i]))
                lines.append(b"+")
                lines.append(b"I" * (prefix_len + 20))
            f.write(b"\n".join(lines) + b"\n")
            written += n


def fastq_prefixes(path: str, prefix_len: int, batch: int = 200_000):
    """Yield ``(N, prefix_len)`` ASCII read-prefix arrays (see
    :func:`ibu_jax.pipelines.fastq_prefix_batches`, which this wraps)."""
    from ibu_jax.pipelines import fastq_prefix_batches

    yield from fastq_prefix_batches(path, prefix_len, batch)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fastq", default=None, help="input FASTQ (.gz ok)")
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--bc-len", type=int, default=16)
    ap.add_argument("--umi-len", type=int, default=12)
    ap.add_argument("--out", default="ingested.ibu")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()
    prefix_len = args.bc_len + args.umi_len

    fastq = args.fastq
    synthetic = fastq is None
    if synthetic:
        fastq = "synth.fastq"
        print(f"Generating {args.reads} synthetic reads...")
        synth_fastq(fastq, args.reads, prefix_len)

    from ibu_jax.pipelines import ingest_fastq

    print("Ingesting...")
    t0 = time.perf_counter()
    total = ingest_fastq(fastq, args.out, args.bc_len, args.umi_len)
    dt = time.perf_counter() - t0
    print(f"  ingested {total} reads -> "
          f"{os.path.getsize(args.out)/1e6:.1f} MB sorted IBU in {dt:.2f}s "
          f"({total/max(dt,1e-9)/1e6:.2f} M reads/s)")

    # read back and summarize with the parallel engine
    from ibu_jax.parallel.device import stream_file_stats

    reader = MmapReader(args.out)
    assert reader.header().sorted()
    stats = stream_file_stats(reader)
    assert stats["count"] == total, (stats["count"], total)
    # index field is a permutation of 0..total-1 under the sort
    want_idx_sum = total * (total - 1) // 2
    assert stats["index_sum"] == want_idx_sum
    print(f"  verified: {stats['count']} records, index-sum OK, "
          f"barcodes sorted: {bool(np.all(np.diff(reader.barcodes()) >= 0))}")

    if not args.keep:
        if synthetic:
            os.remove(fastq)
        os.remove(args.out)
        print("✓ complete - files cleaned up")


if __name__ == "__main__":
    main()
