"""Generate the golden IBU fixture corpus under tests/fixtures/.

These bytes are hand-encoded from the documented wire layout — straight
``struct.pack`` per the reference's spec, deliberately NOT via ibu_jax's
Writer — so the fixture tests cross-check the library against an
independent encoding of the format rather than against itself:

* header: ``magic:u32 version:u32 bc_len:u32 umi_len:u32 flags:u64
  reserved:[u8;8]`` little-endian, 32 bytes
  (``/root/reference/src/constructs/header.rs:17-24,48-61``;
  ``MAGIC = 0x21554249`` "IBU!" LE, ``VERSION = 2``, sorted = flag bit 0);
* record: ``barcode:u64 umi:u64 index:u64`` little-endian, 24 bytes
  (``/root/reference/src/constructs/record.rs:58-66``);
* 2-bit sequence packing: A=00 C=01 G=10 T=11, base ``i`` at bits ``2i``
  (``record.rs:19-27``, the bitnuc convention).

The corpus covers the format's corners: empty file, one
record, sorted/unsorted flags, bc/umi lengths {1, 16, 17, 32}, u64-max
fields, gzip- and zstd-compressed copies, and corruption variants
(bit-flipped magic, truncated tail). Deterministic output: fixed values,
gzip mtime pinned to 0.

Run from the repo root: ``python tools/make_fixtures.py`` — writes the
files and prints a manifest with sha256 sums.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import struct
import sys

FIXDIR = os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures")

MAGIC = 0x21554249  # "IBU!" little-endian
VERSION = 2
TABLE = {"A": 0, "C": 1, "G": 2, "T": 3}


def header(bc_len: int, umi_len: int, flags: int = 0) -> bytes:
    return struct.pack("<IIIIQ8s", MAGIC, VERSION, bc_len, umi_len, flags, b"")


def record(barcode: int, umi: int, index: int) -> bytes:
    return struct.pack("<QQQ", barcode, umi, index)


def pack2bit(seq: str) -> int:
    """Independent 2-bit encoder: base i at bits 2i (record.rs:19-27)."""
    word = 0
    for i, base in enumerate(seq):
        word |= TABLE[base.upper()] << (2 * i)
    return word


def seq_of(length: int, phase: int) -> str:
    """Deterministic sequence of the given length (cycled alphabet)."""
    return "".join("ACGT"[(i + phase) % 4] for i in range(length))


def build() -> dict[str, bytes]:
    files: dict[str, bytes] = {}

    # -- empty file: header only, zero records ------------------------------
    files["empty_bc16_umi12.ibu"] = header(16, 12)

    # -- one record, hand-picked values (ASCII-checkable hex) ---------------
    one = header(16, 12) + record(
        0x0123456789ABCDEF, 0x0000FEDCBA987654, 0x0000000000000007
    )
    files["one_record.ibu"] = one

    # -- sorted vs unsorted: same record set, flag bit 0 differs ------------
    recs = [
        (pack2bit(seq_of(4, 0)), pack2bit(seq_of(8, 1)), 2),
        (pack2bit(seq_of(4, 1)), pack2bit(seq_of(8, 2)), 1),
        (pack2bit(seq_of(4, 2)), pack2bit(seq_of(8, 3)), 0),
    ]
    srt = sorted(recs)  # lexicographic (barcode, umi, index), record.rs:29-32
    files["sorted_bc4_umi8.ibu"] = header(4, 8, flags=1) + b"".join(
        record(*r) for r in srt
    )
    files["unsorted_bc4_umi8.ibu"] = header(4, 8, flags=0) + b"".join(
        record(*r) for r in recs
    )

    # -- boundary lengths {1, 16, 17, 32} with known sequences --------------
    # lengths 17/32 exercise the hi u32 word; 32 exercises bit 63 (T last)
    for L in (1, 16, 17, 32):
        bc_seq = seq_of(L, 0)
        umi_seq = seq_of(L, 3)  # starts with T: bit coverage in low limb
        files[f"len{L}.ibu"] = header(L, L) + record(
            pack2bit(bc_seq), pack2bit(umi_seq), L
        )
    # all-T 32-mer: every 2-bit slot = 11, word == u64 max → bit-63 path
    files["allT32.ibu"] = header(32, 32) + record(
        pack2bit("T" * 32), pack2bit("T" * 32), 0xFFFFFFFFFFFFFFFF
    )

    # -- u64-max in every field (not a valid 2-bit seq constraint — the
    #    format carries arbitrary u64s; readers must not mangle them) ------
    files["umax.ibu"] = header(16, 12) + record(
        0xFFFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFF
    ) + record(0, 0, 0)

    # -- compressed copies (read-side niffler parity, reader.rs:345-357) ----
    files["one_record.ibu.gz"] = gzip.compress(one, mtime=0)
    try:
        import zstandard

        files["one_record.ibu.zst"] = zstandard.ZstdCompressor(
            level=3
        ).compress(one)
    except ImportError:
        print("zstandard unavailable; skipping .zst fixture", file=sys.stderr)

    # -- corruption variants -------------------------------------------------
    bad_magic = bytearray(one)
    bad_magic[0] ^= 0x01  # "IBU!" -> "HBU!" (0x49 -> 0x48)
    files["corrupt_magic.ibu"] = bytes(bad_magic)
    files["corrupt_version.ibu"] = header(16, 12)[:4] + struct.pack(
        "<I", 99
    ) + header(16, 12)[8:]
    files["bad_bc_len.ibu"] = header(33, 12)
    files["bad_umi_len.ibu"] = header(16, 0)
    # truncated mid-record: 2 complete records + 5 stray bytes
    files["truncated_tail.ibu"] = (
        header(16, 12)
        + record(1, 2, 3)
        + record(4, 5, 6)
        + record(7, 8, 9)[:5]
    )
    return files


def main() -> None:
    os.makedirs(FIXDIR, exist_ok=True)
    files = build()
    for name, data in sorted(files.items()):
        path = os.path.join(FIXDIR, name)
        with open(path, "wb") as f:
            f.write(data)
        print(f"{hashlib.sha256(data).hexdigest()[:16]}  {len(data):5d}  {name}")


if __name__ == "__main__":
    main()
