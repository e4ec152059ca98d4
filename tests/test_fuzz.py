"""Randomized end-to-end roundtrips across the configuration space.

One seeded fuzzer covering combinations the unit tests sample only at
boundaries: random (bc_len, umi_len, n, compression, batch sizes), the
full pipeline chain sequences → encode → sort → file → stream/mmap →
stats/decode, each leg checked against host oracles.
"""

import gzip
import os

import numpy as np
import pytest

from ibu_jax import Header, MmapReader, Reader, Writer, sort_records
from ibu_jax.ops import codec as C
from ibu_jax.ops.stats import checksum_records_np
from ibu_jax.parallel.device import stream_file_stats
from ibu_jax.pipelines import decode_batch, encode_batch, sort_batch


#: CI runs 8 seeds; set FUZZ_SEEDS=N for an extended sweep.
@pytest.mark.parametrize("seed", range(int(os.environ.get("FUZZ_SEEDS", 8))))
def test_random_roundtrip_config(seed, tmp_path):
    rng = np.random.default_rng(1000 + seed)
    bc_len = int(rng.integers(1, 33))
    umi_len = int(rng.integers(1, 33))
    n = int(rng.integers(1, 5000))
    compress = bool(rng.integers(0, 2))
    al = np.frombuffer(b"ACGTacgt", dtype=np.uint8)

    bc_rows = al[rng.integers(0, 8, (n, bc_len))]
    umi_rows = al[rng.integers(0, 8, (n, umi_len))]
    index = rng.integers(0, 1 << 63, n, dtype=np.uint64)

    # encode (device) vs host oracle
    records = encode_batch(bc_rows, umi_rows, index)
    assert np.array_equal(records["barcode"], C.np_pack(bc_rows))
    assert np.array_equal(records["umi"], C.np_pack(umi_rows))
    assert np.array_equal(records["index"], index)

    # device sort vs host sort — randomly exercise the hinted (dropped
    # hi-word) comparator path; hints here are always truthful by
    # construction (bc_len/umi_len bound the packed widths, index < 2^63)
    if rng.integers(0, 2):
        records = sort_batch(
            records, bc_len=bc_len, umi_len=umi_len, index_bits=63
        )
    else:
        records = sort_batch(records)
    assert np.array_equal(records, sort_records(records.copy()))

    # write → (maybe compressed) stream read → byte equality
    header = Header.new(bc_len, umi_len)
    header.set_sorted()
    w = Writer.in_memory(header)
    w.write_batch(records)
    w.finish()
    raw = w.inner.getvalue()
    assert len(raw) == 32 + 24 * n

    path = tmp_path / f"f{seed}.ibu"
    if compress:
        # exercise the WRITE-side codecs: our own gzip/zstd writers must
        # produce streams our reader sniffs back to the same bytes
        kind = "gzip" if rng.integers(0, 2) else "zstd"
        try:
            import zstandard  # noqa: F401
        except ImportError:
            kind = "gzip"
        path = tmp_path / f"f{seed}.ibu.{'gz' if kind == 'gzip' else 'zst'}"
        with Writer.from_path(str(path), header, compression=kind) as cw:
            cw.write_batch(records)
    else:
        path.write_bytes(raw)
    r = Reader.from_path(str(path))
    got_header = r.header()
    assert (got_header.bc_len, got_header.umi_len) == (bc_len, umi_len)
    assert got_header.sorted()
    back = np.concatenate(list(r.batches())) if n else np.empty(0, records.dtype)
    assert np.array_equal(back, records)

    # decode (device) back to uppercase sequences
    bc2, umi2, idx2 = decode_batch(records, bc_len, umi_len)
    # sort permuted rows; compare as multisets of (bc, umi, idx) triples
    want = sorted(
        (bytes(b).upper(), bytes(u).upper(), int(i))
        for b, u, i in zip(bc_rows, umi_rows, index)
    )
    got = sorted(
        (bytes(b), bytes(u), int(i)) for b, u, i in zip(bc2, umi2, idx2)
    )
    assert got == want

    # uncompressed path also gets mmap + streamed device stats + a FASTQ
    # export + re-parse roundtrip
    if not compress:
        mm = MmapReader(str(path))
        batch_records = int(rng.integers(1, n + 1))
        stats = stream_file_stats(mm, batch_records=batch_records)
        want_sums = checksum_records_np(records)
        assert stats["count"] == n
        assert (
            stats["barcode_sum"],
            stats["umi_sum"],
            stats["index_sum"],
        ) == want_sums

        from ibu_jax.pipelines import export_fastq

        fq = tmp_path / f"f{seed}.fastq"
        assert export_fastq(str(path), str(fq),
                            batch_records=batch_records) == n
        lines = fq.read_bytes().splitlines()
        assert len(lines) == 4 * n
        if n:
            k = int(rng.integers(0, n))
            srt = np.sort(records, order=("barcode", "umi", "index"))
            want_seq = (
                C.decode_seqs(srt["barcode"][k : k + 1], bc_len)[0]
                + C.decode_seqs(srt["umi"][k : k + 1], umi_len)[0]
            ).encode()
            assert lines[4 * k + 1] == want_seq
            assert int(lines[4 * k][2:]) == int(srt["index"][k])

        # dedup + filter legs vs set-based host oracles
        from ibu_jax.ops.stats import molecule_counts_np
        from ibu_jax.pipelines import dedup_file, filter_file

        dd = tmp_path / f"f{seed}.dedup.ibu"
        dstats = dedup_file(str(path), str(dd))
        want_mol = molecule_counts_np(records)
        assert dstats["records"] == n
        assert dstats["molecules"] == sum(want_mol.values())
        assert dstats["barcodes"] == len(want_mol)
        if n:
            allow = rng.choice(
                records["barcode"], size=int(rng.integers(1, 4)),
                replace=True,
            )
            ff = tmp_path / f"f{seed}.filt.ibu"
            fstats = filter_file(str(path), str(ff), allow)
            assert fstats["kept"] == int(
                np.isin(records["barcode"], allow).sum()
            )
            kept = np.asarray(MmapReader(str(ff)).records)
            assert np.array_equal(
                kept, records[np.isin(records["barcode"], allow)]
            )

        # barcode-correction leg vs an independent brute-force oracle:
        # Hamming distances computed on DECODED base rows, not the XOR
        # trick the production kernel uses
        if n:
            from ibu_jax.pipelines import correct_file

            base = rng.choice(records["barcode"],
                              size=int(rng.integers(1, 5)), replace=True)
            mut = base ^ (
                rng.integers(1, 4, len(base)).astype(np.uint64)
                << (2 * rng.integers(0, bc_len, len(base)).astype(np.uint64))
            )
            allow = np.unique(np.concatenate([base, mut]))
            rows = C.np_unpack(records["barcode"], bc_len)  # (n, L) ASCII
            arows = C.np_unpack(allow, bc_len)  # (K, L)
            dist = (rows[:, None, :] != arows[None, :, :]).sum(axis=2)
            is_exact = (dist == 0).any(axis=1)
            n1 = (dist == 1).sum(axis=1)
            keep = is_exact | (n1 == 1)
            fixed_bc = records["barcode"].copy()
            fix_rows = ~is_exact & (n1 == 1)
            fixed_bc[fix_rows] = allow[(dist == 1).argmax(axis=1)[fix_rows]]
            want_kept = records[keep].copy()
            want_kept["barcode"] = fixed_bc[keep]
            co = tmp_path / f"f{seed}.corr.ibu"
            cstats2 = correct_file(str(path), str(co), allow)
            assert cstats2["exact"] == int(is_exact.sum())
            assert cstats2["corrected"] == int(fix_rows.sum())
            assert cstats2["dropped"] == n - int(keep.sum())
            got_kept = np.asarray(MmapReader(str(co)).records)
            assert np.array_equal(got_kept, want_kept)

        # audit + subsample + split→concat + repair legs
        from ibu_jax.pipelines import (
            check_file,
            concat_files,
            repair_file,
            split_file,
            subsample_file,
        )

        rep = check_file(str(path))
        assert rep["ok"] and rep["records"] == n

        if n:
            k = int(rng.integers(0, n + 1))
            ss = tmp_path / f"f{seed}.sub.ibu"
            sstats = subsample_file(
                str(path), str(ss), n=k, seed=seed,
                batch_records=batch_records,
            )
            assert sstats["sampled"] == k
            sub = np.asarray(MmapReader(str(ss)).records)
            assert len(sub) == k
            v_all = np.ascontiguousarray(records).view("V24").ravel()
            v_sub = np.ascontiguousarray(sub).view("V24").ravel()
            assert np.isin(v_sub, v_all).all()  # strict subset of the file

        shards = split_file(
            str(path), str(tmp_path / f"f{seed}.s{{}}.ibu"),
            int(rng.integers(1, 5)),
        )
        cc = tmp_path / f"f{seed}.cat.ibu"
        cstats = concat_files(shards, str(cc))
        assert cstats["records"] == n and cstats["sorted"]
        assert cc.read_bytes() == path.read_bytes()  # byte-exact inverse

        # indexed lookup vs isin oracle (file is sorted with the flag set)
        if n:
            from ibu_jax.pipelines import lookup_barcodes

            qs = np.concatenate(
                [
                    rng.choice(records["barcode"],
                               size=int(rng.integers(1, 4))),
                    np.array([0xDEAD_BEEF_DEAD_BEEF], dtype=np.uint64),
                ]
            )
            hits = lookup_barcodes(str(path), qs)
            want_hits = records[np.isin(records["barcode"], qs)]
            assert np.array_equal(hits, want_hits)

        # count matrix (sorted fast path) vs the pair-triple oracle
        from ibu_jax.ops.stats import pair_molecule_counts_np
        from ibu_jax.pipelines import count_matrix

        want_pairs = pair_molecule_counts_np(records)
        mstats = count_matrix(str(path), str(tmp_path / f"f{seed}.cm"),
                              batch_records=batch_records)
        assert mstats["entries"] == len(want_pairs)
        assert mstats["molecules"] == sum(want_pairs.values())

        # cell calling self-consistency: the emitted allowlist is exactly
        # the barcodes at/above the reported threshold (no planted gap
        # here, so assert the contract, not a particular cut)
        if n:
            from ibu_jax.pipelines import call_cells

            allowf = tmp_path / f"f{seed}.cells.txt"
            method = "knee" if rng.integers(0, 2) else "ordmag"
            kst = call_cells(str(path), str(allowf), method=method,
                             batch_records=batch_records)
            u, c = np.unique(records["barcode"], return_counts=True)
            assert kst["barcodes"] == len(u) and kst["records"] == n
            want_cells = set(u[c >= kst["threshold"]].tolist())
            listed = [l.strip() for l in allowf.read_text().splitlines()
                      if l.strip()]
            got_cells = set(
                int(v) for v in np.asarray(C.encode_seqs(listed))
            ) if listed else set()
            assert got_cells == want_cells
            assert kst["cells"] == len(want_cells)

        if n:
            cut = int(rng.integers(1, 24))  # always tears the last record
            bad = tmp_path / f"f{seed}.bad.ibu"
            bad.write_bytes(path.read_bytes()[:-cut])
            assert not check_file(str(bad))["ok"]
            rr = tmp_path / f"f{seed}.rep.ibu"
            rstats = repair_file(str(bad), str(rr))
            assert rstats["records"] == n - 1
            assert rstats["dropped_bytes"] == 24 - cut
            back_r = np.asarray(MmapReader(str(rr)).records)
            assert np.array_equal(back_r, records[: n - 1])
            assert check_file(str(rr))["ok"]
