#!/usr/bin/env python
"""The five driver workloads from BASELINE.json, runnable end to end.

    python benchmarks/run_config.py 1        # scaled-down (CI-sized)
    python benchmarks/run_config.py 2 --full # full driver size

1. roundtrip: Header(16,12), write_batch 2 records, read back, assert equal
2. batch encode: random 16bp barcodes + 12bp UMIs → 2-bit u64, write sorted
   IBU file (1M records full-size)
3. batch decode: read a 10M-record IBU file, unpack to ASCII, validate
   header/magic/truncation error paths
4. compressed I/O: gzip (and zstd when available) streams → per-barcode
   histogram
5. multi-host parallel: records sharded across the device mesh/pod slice,
   parallel count + allreduce-style merge (parallel.rs parity)

Each config asserts correctness against a host oracle and prints timings.
"""

from __future__ import annotations

import argparse
import gzip
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from ibu_jax.utils import apply_platform_env

apply_platform_env()


def log(*a):
    print(*a, flush=True)


def _alphabet():
    return np.frombuffer(b"ACGT", dtype=np.uint8)


def config1_roundtrip() -> None:
    """Header(16,12) → 2 records → read back → assert equality
    (BASELINE config 1; mirrors the reference README usage demo)."""
    import io

    from ibu_jax import Header, Reader, Writer
    from ibu_jax.constructs.record import make_records
    from ibu_jax.ops import codec as C

    header = Header.new(16, 12)
    barcodes = C.encode_seqs(["ACGTACGTACGTACGT", "TTTTGGGGCCCCAAAA"])
    umis = C.encode_seqs(["AACCGGTTAACC", "TTGGCCAATTGG"])
    records = make_records(barcodes, umis, np.array([0, 1], dtype=np.uint64))

    w = Writer.in_memory(header)
    w.write_batch(records)
    w.finish()

    r = Reader(io.BytesIO(w.inner.getvalue()))
    assert r.header().bc_len == 16 and r.header().umi_len == 12
    back = r.read_records()
    assert np.array_equal(back, records)
    assert C.decode_seqs(back["barcode"], 16) == [
        "ACGTACGTACGTACGT",
        "TTTTGGGGCCCCAAAA",
    ]
    log("config1: roundtrip OK (2 records byte-exact, sequences recovered)")


def config2_batch_encode(n: int, workdir: str) -> None:
    """Random barcodes/UMIs → device 2-bit encode → device sort → sorted
    IBU file (BASELINE config 2)."""
    import jax.numpy as jnp

    from ibu_jax import Header, Writer
    from ibu_jax.ops import codec as C
    from ibu_jax.ops.stats import sort_records_soa
    from ibu_jax.ops.u64 import records_from_soa

    rng = np.random.default_rng(0)
    al = _alphabet()
    bc_planes = al[rng.integers(0, 4, (16, n))]
    umi_planes = al[rng.integers(0, 4, (12, n))]
    idx = np.stack(
        [np.arange(n, dtype=np.uint32), np.zeros(n, dtype=np.uint32)]
    )

    t0 = time.perf_counter()
    soa = C.lax_encode_records(
        jnp.asarray(bc_planes), jnp.asarray(umi_planes), jnp.asarray(idx)
    )
    # hinted comparator: bc16/umi12 + arange indices < 2^32 (2.2x sort)
    soa_sorted = sort_records_soa(soa, bc_len=16, umi_len=12, index_bits=32)
    records = records_from_soa(np.asarray(soa_sorted))
    encode_s = time.perf_counter() - t0

    path = os.path.join(workdir, "encoded_sorted.ibu")
    header = Header.new(16, 12)
    header.set_sorted()
    t0 = time.perf_counter()
    with Writer.from_path(path, header) as w:
        w.write_batch(records)
    write_s = time.perf_counter() - t0

    # oracle check: the sorted barcode column is exactly the sorted multiset
    # of host-packed inputs (barcode is the primary sort key)
    want_sorted = np.sort(C.np_pack(C.planes_to_rows(bc_planes)))
    assert np.array_equal(records["barcode"], want_sorted)
    assert header.sorted()
    log(
        f"config2: encoded+sorted {n} records in {encode_s:.2f}s, "
        f"wrote {os.path.getsize(path)/1e6:.1f} MB in {write_s:.2f}s, "
        "sort-order oracle OK"
    )


def config3_batch_decode(n: int, workdir: str) -> None:
    """Write an n-record file, read+unpack to ASCII, and exercise the
    header/magic/truncation validation paths (BASELINE config 3)."""
    import jax
    import jax.numpy as jnp

    from ibu_jax import (
        Header,
        InvalidMagicNumber,
        Reader,
        TruncatedRecord,
        Writer,
        load_to_vec,
    )
    from ibu_jax.constructs.record import make_records
    from ibu_jax.ops import codec as C
    from ibu_jax.ops.u64 import soa_from_records

    rng = np.random.default_rng(1)
    al = _alphabet()
    bc_rows = al[rng.integers(0, 4, (n, 16))]
    umi_rows = al[rng.integers(0, 4, (n, 12))]
    records = make_records(
        C.np_pack(bc_rows), C.np_pack(umi_rows), np.arange(n, dtype=np.uint64)
    )
    path = os.path.join(workdir, "decode_me.ibu")
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(records)

    t0 = time.perf_counter()
    header, loaded = load_to_vec(path)
    soa = jnp.asarray(soa_from_records(loaded))
    bc_p, umi_p, idx_p = C.lax_decode_records(soa, 16, 12)
    jax.block_until_ready((bc_p, umi_p, idx_p))
    decode_s = time.perf_counter() - t0

    assert np.array_equal(C.planes_to_rows(np.asarray(bc_p)), bc_rows)
    assert np.array_equal(C.planes_to_rows(np.asarray(umi_p)), umi_rows)

    # validation paths
    data = open(path, "rb").read()
    bad_magic = b"XXXX" + data[4:]
    import io

    try:
        Reader(io.BytesIO(bad_magic))
        raise AssertionError("magic validation missed")
    except InvalidMagicNumber:
        pass
    try:
        for _ in Reader(io.BytesIO(data[:-7])).batches():
            pass  # batch-drain; error fires on the final ragged refill
        raise AssertionError("truncation validation missed")
    except TruncatedRecord:
        pass
    log(
        f"config3: decoded {n} records to ASCII in {decode_s:.2f}s "
        f"({n*24/decode_s/1e9:.2f} GB/s incl. host IO); error paths OK"
    )


def config4_compressed_histogram(n: int, workdir: str) -> None:
    """gzip/zstd IBU streams → per-barcode histogram (BASELINE config 4)."""
    from ibu_jax import Header, Reader, Writer
    from ibu_jax.constructs.record import make_records
    from ibu_jax.ops.stats import barcode_histogram_np
    from ibu_jax.parallel.device import sharded_barcode_histogram

    rng = np.random.default_rng(2)
    records = make_records(
        rng.integers(0, 256, n, dtype=np.uint64),
        rng.integers(0, 1 << 48, n, dtype=np.uint64),
        np.arange(n, dtype=np.uint64),
    )
    w = Writer.in_memory(Header.new(16, 12))
    w.write_batch(records)
    w.finish()
    raw = w.inner.getvalue()

    streams = {"gzip": os.path.join(workdir, "h.ibu.gz")}
    open(streams["gzip"], "wb").write(gzip.compress(raw))
    try:
        import zstandard as zstd

        streams["zstd"] = os.path.join(workdir, "h.ibu.zst")
        open(streams["zstd"], "wb").write(zstd.ZstdCompressor().compress(raw))
    except ImportError:
        log("config4: zstandard module unavailable; gzip only")

    want = barcode_histogram_np(records)
    for kind, path in streams.items():
        t0 = time.perf_counter()
        reader = Reader.from_path(path)
        got = sharded_barcode_histogram(
            reader.batches(), max_uniques_per_shard=4096
        )
        dt = time.perf_counter() - t0
        assert got == want, f"{kind} histogram mismatch"
        log(
            f"config4: {kind} decode + histogram of {n} records in {dt:.2f}s "
            f"({len(got)} unique barcodes) OK"
        )


def config5_multihost_parallel(n: int, workdir: str) -> None:
    """Sharded parallel count + merge over the mesh/pod slice
    (BASELINE config 5; parallel.rs parity)."""
    from ibu_jax.parallel.multihost import multihost_file_stats
    from ibu_jax.utils.datagen import parallel_fields, write_patterned_file

    path = os.path.join(workdir, "mh.ibu")
    write_patterned_file(path, n, parallel_fields)

    t0 = time.perf_counter()
    stats = multihost_file_stats(path)
    dt = time.perf_counter() - t0
    assert stats["count"] == n
    want_idx = (n * (n - 1) // 2) & 0xFFFFFFFFFFFFFFFF
    assert stats["index_sum"] == want_idx
    log(
        f"config5: parallel stats of {n} records in {dt:.2f}s "
        f"({n/dt/1e6:.1f} M rec/s) count+checksum OK"
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", type=int, choices=[1, 2, 3, 4, 5])
    ap.add_argument("--full", action="store_true",
                    help="full driver sizes (1M/10M/100M)")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args()

    workdir = args.workdir or tempfile.mkdtemp(prefix="ibu_bench_")
    sizes = {
        2: 1_000_000 if args.full else 100_000,
        3: 10_000_000 if args.full else 200_000,
        4: 1_000_000 if args.full else 100_000,
        5: 100_000_000 if args.full else 1_000_000,
    }
    if args.config == 1:
        config1_roundtrip()
    elif args.config == 2:
        config2_batch_encode(sizes[2], workdir)
    elif args.config == 3:
        config3_batch_decode(sizes[3], workdir)
    elif args.config == 4:
        config4_compressed_histogram(sizes[4], workdir)
    elif args.config == 5:
        config5_multihost_parallel(sizes[5], workdir)


if __name__ == "__main__":
    main()
