#!/usr/bin/env python
"""IBU write → stream-read → bulk-load roundtrip benchmark — parity with
``/root/reference/examples/roundtrip.rs``: same patterned records
(barcode = i % 1M, umi = 31·i % 1M, index = i), same XOR checksum, same
per-phase M records/s + GB/s report. Batch-first throughout.

Default 5M records; pass ``--records 500`` (millions) for the reference's
full 12 GB workload.
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

from ibu_jax import Header, Reader, Writer, load_to_vec
from ibu_jax.constructs.record import make_records
from ibu_jax.utils.datagen import roundtrip_fields

CHUNK = 4 * 1024 * 1024


def patterned_batch(start: int, n: int) -> np.ndarray:
    i = np.arange(start, start + n, dtype=np.uint64)
    return make_records(*roundtrip_fields(i))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--records", type=float, default=5.0,
                    help="records in millions (reference uses 500)")
    ap.add_argument("--file", default="test_roundtrip.ibu")
    ap.add_argument("--keep", action="store_true", help="don't delete the file")
    args = ap.parse_args()
    num_records = int(args.records * 1_000_000)
    filename = args.file

    print("IBU Roundtrip Test")
    print("==================")
    print(f"Records: {num_records}")
    print(f"File size: ~{num_records * 24 / 1e9:.2f} GB\n")

    header = Header.new(16, 12)
    header.set_sorted()

    # ========== WRITE ==========
    print("Writing...")
    write_start = time.perf_counter()
    with Writer.from_path(filename, header) as writer:
        for start in range(0, num_records, CHUNK):
            writer.write_batch(patterned_batch(start, min(CHUNK, num_records - start)))
    write_dur = time.perf_counter() - write_start
    print("  ✓ Write complete")
    print(f"  Duration: {write_dur:.2f}s")
    print(f"  Rate: {num_records / write_dur / 1e6:.2f} M records/s")
    print(f"  Bandwidth: {num_records * 24 / write_dur / 1e9:.2f} GB/s\n")

    # ========== STREAMING READ ==========
    print("Reading...")
    read_start = time.perf_counter()
    reader = Reader.from_path(filename)
    read_header = reader.header()
    assert read_header.bc_len == header.bc_len
    assert read_header.umi_len == header.umi_len
    assert read_header.sorted() == header.sorted()

    records_read = 0
    checksum = np.uint64(0)
    for batch in reader.batches():
        records_read += len(batch)
        checksum ^= (
            np.bitwise_xor.reduce(batch["barcode"])
            ^ np.bitwise_xor.reduce(batch["umi"])
            ^ np.bitwise_xor.reduce(batch["index"])
        )
    read_dur = time.perf_counter() - read_start
    print("  ✓ Read complete")
    print(f"  Duration: {read_dur:.2f}s")
    print(f"  Rate: {records_read / read_dur / 1e6:.2f} M records/s")
    print(f"  Bandwidth: {records_read * 24 / read_dur / 1e9:.2f} GB/s\n")

    # ========== VERIFICATION ==========
    print("Verification:")
    print(f"  Records written: {num_records}")
    print(f"  Records read: {records_read}")
    print(f"  Checksum: 0x{int(checksum):016X}")
    assert records_read == num_records, "Record count mismatch!"
    print("  ✓ Record count matches\n")

    # ========== DIRECT LOAD ==========
    load_start = time.perf_counter()
    _header, records = load_to_vec(filename)
    load_dur = time.perf_counter() - load_start
    print("Direct Load:")
    print(f"  Duration: {load_dur:.2f}s")
    print(f"  Rate: {len(records) / load_dur / 1e6:.2f} M records/s")
    print(f"  Bandwidth: {len(records) * 24 / load_dur / 1e9:.2f} GB/s\n")

    if not args.keep:
        os.remove(filename)
        print("✓ Test complete - file cleaned up")


if __name__ == "__main__":
    main()
