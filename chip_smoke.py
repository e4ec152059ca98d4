#!/usr/bin/env python
"""Start the system on one NVIDIA GPU and check everything it computes.

    python chip_smoke.py                 # one card: all phases below
    python chip_smoke.py --four-cards    # four cards: the multi-device path

One process does all device work (a JAX process reserves most of a card's
memory, so a second one would fail), and every tool runs through the CLI's
own ``main`` with ``--engine device`` wherever the tool has that option.
Phases, in order; any failure exits nonzero before the result line:

1. **device** — refuse anything but a GPU; print the card's name and power
   limit, the device kind and count, and the JAX version.
2. **validation** — the oracle matrix of :mod:`ibu_jax.validate`, compiled
   for the card; then the fused codec timed beside a copy of the same bytes.
3. **chain** — a planted 10x-v3-shaped library (16-base barcodes, 12-base
   UMIs) through ``ingest-fastq → cells → correct → sort → dedup → count``;
   the count matrix must equal the planted molecule counts exactly.
4. **streaming** — ``stats``, ``histogram`` and ``sort`` over a patterned
   file, against the closed-form checksum, ``barcode_histogram_np`` and
   ``native.sort_file``; plus the ``--engine auto`` decisions and probes.

``--four-cards`` replaces phases 2-4 with the paths that span devices:
``sort --engine mesh``, ``stats`` and ``histogram --engine device`` over the
local mesh, and the pod-sort engine choice, on a 500M-record file.

The last line of standard output is the JSON result, and nothing follows it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
U64 = (1 << 64) - 1


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(platform: str, kind: str, count: int) -> str:
    """The run's last line: the device as JAX reports it."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind,
                                "count": count}}
    )


def cli(*argv: str) -> str:
    """Run one ``python -m ibu_jax`` command in this process; return its
    standard output, raising on a nonzero exit code."""
    from ibu_jax.__main__ import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"`{' '.join(map(str, argv))}` exited {rc}")
    return out.getvalue()


class Stages:
    """Wall time of each named stage, printed as it ends."""

    def __init__(self, phase: str):
        self.phase = phase
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        self.seconds[name] = dt = time.perf_counter() - t0
        log(f"[{self.phase}] {name}: {dt:.2f} s")


def patterned_checksum(n: int) -> dict:
    """Closed-form stats of ``datagen.write_patterned_file`` with
    ``parallel_fields``: barcode = i mod 1M, umi = 2i, index = i."""
    m = 1_000_000
    q, r = divmod(n, m)
    return {
        "count": n,
        "barcode_sum": (q * (m * (m - 1) // 2) + r * (r - 1) // 2) & U64,
        "umi_sum": (n * (n - 1)) & U64,
        "index_sum": (n * (n - 1) // 2) & U64,
    }


def files_equal(a: str, b: str, chunk: int = 1 << 26) -> bool:
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(chunk), fb.read(chunk)
            if x != y:
                return False
            if not x:
                return True


def read_histogram(text: str) -> dict[int, int]:
    """Parse the ``histogram`` tool's ``<barcode>\\t<count>`` lines."""
    import numpy as np

    from ibu_jax.ops import codec as C

    lines = text.splitlines()
    if not lines:
        return {}
    seqs, counts = zip(*(line.split("\t") for line in lines))
    words = C.np_pack(C.seqs_to_rows(list(seqs)))
    return dict(zip(words.tolist(), np.asarray(counts, np.int64).tolist()))


def read_count_matrix(prefix: str):
    """The ``count`` tool's MatrixMarket trio → barcode, index and value
    per entry (uint64, uint64, int64)."""
    import numpy as np

    from ibu_jax.ops import codec as C

    with open(f"{prefix}.mtx") as f:
        while f.readline().startswith("%"):
            pass  # comment lines, then the dimension line
        body = np.fromfile(f, dtype=np.int64, sep=" ").reshape(-1, 3)
    with open(f"{prefix}.barcodes.txt") as f:
        barcodes = C.np_pack(C.seqs_to_rows([s.strip() for s in f]))
    indices = np.fromfile(f"{prefix}.indices.txt", dtype=np.int64, sep=" ")
    return (barcodes[body[:, 0] - 1], indices[body[:, 1] - 1].astype(np.uint64),
            body[:, 2])


def run_chain(work: str, cells: int, reads: int, genes: int,
              error_rate: float, seed: int) -> dict[str, float]:
    """The single-cell chain through the CLI on a planted library; raises
    unless the count matrix equals the planted truth exactly."""
    import numpy as np

    from ibu_jax.ops import codec as C
    from ibu_jax.pipelines import _fastq_block
    from ibu_jax.utils.datagen import CHUNK, pair_counts, planted_library

    st = Stages("chain")
    with st("generate"):
        lib = planted_library(np.random.default_rng(seed), cells, genes,
                              reads, error_rate)
    fastq = os.path.join(work, "reads.fastq")
    with st("write FASTQ"), open(fastq, "wb") as f:
        for s in range(0, reads, CHUNK):
            e = min(s + CHUNK, reads)
            f.write(_fastq_block(lib.bc_rows[s:e], lib.umi_rows[s:e],
                                 np.arange(s, e, dtype=np.uint64), ord("I")))
    allowlist, gene_of_read = lib.allowlist, lib.gene
    truth_pairs, truth_counts = lib.truth_pairs, lib.truth_counts
    del lib  # the FASTQ holds the reads now

    p = {k: os.path.join(work, k) for k in
         ("raw.ibu", "cells.txt", "corrected.ibu", "sorted.ibu",
          "molecules.ibu", "counts")}
    # the ingest codec has no --engine option: pin the router to the device
    saved = os.environ.get("IBU_AUTO_ENGINE")
    os.environ["IBU_AUTO_ENGINE"] = "device"
    try:
        with st("ingest-fastq"):
            cli("ingest-fastq", fastq, p["raw.ibu"])
    finally:
        if saved is None:
            os.environ.pop("IBU_AUTO_ENGINE")
        else:
            os.environ["IBU_AUTO_ENGINE"] = saved
    os.unlink(fastq)
    with st("cells"):
        cli("cells", p["raw.ibu"], "-o", p["cells.txt"], "--method",
            "ordmag", "--expect", cells, "--engine", "device")
    with open(p["cells.txt"]) as f:
        called = np.sort(C.encode_seqs([s.strip() for s in f if s.strip()]))
    if not np.array_equal(called, allowlist):
        raise AssertionError(f"cells called {len(called)} barcodes, "
                             f"planted {len(allowlist)}")
    with st("correct"):
        cli("correct", p["raw.ibu"], p["corrected.ibu"], "--barcodes",
            p["cells.txt"])
    with st("sort"):
        cli("sort", p["corrected.ibu"], p["sorted.ibu"], "--engine",
            "device")
    with st("dedup"):
        cli("dedup", p["sorted.ibu"], p["molecules.ibu"])
    with st("count"):
        cli("count", p["molecules.ibu"], p["counts"], "--engine", "device")
    with st("verify"):
        # ingest numbers reads in FASTQ order; map each matrix column (a
        # surviving read) back to the gene of its planted molecule
        bc, index, value = read_count_matrix(p["counts"])
        pairs, counts = pair_counts(bc, gene_of_read[index], value)
        if not (np.array_equal(pairs, truth_pairs)
                and np.array_equal(counts, truth_counts)):
            raise AssertionError(
                f"count matrix: {len(pairs)} (cell, gene) entries with "
                f"{int(counts.sum())} molecules; planted "
                f"{len(truth_pairs)} with {int(truth_counts.sum())}"
            )
    log(f"[chain] count matrix equals the planted truth: {cells} cells, "
        f"{len(pairs)} (cell, gene) entries, {int(counts.sum())} molecules "
        f"from {reads} reads")
    return st.seconds


def check_stats(st: Stages, path: str, records: int) -> None:
    """``stats --engine device`` against the closed form."""
    with st("stats"):
        got = json.loads(cli("stats", path, "--engine", "device")
                         .splitlines()[-1])
    if got != patterned_checksum(records):
        raise AssertionError(f"stats {got} != closed form "
                             f"{patterned_checksum(records)}")


def check_sort(st: Stages, path: str, engine: str) -> None:
    """``sort --engine <engine>`` byte-equal to ``native.sort_file``."""
    from ibu_jax import native

    out, ref = f"{path}.{engine}-sorted", f"{path}.native-sorted"
    with st(f"sort --engine {engine}"):
        cli("sort", path, out, "--engine", engine)
    if not native.available():
        raise RuntimeError(f"native runtime unavailable: "
                           f"{native.load_error()}")
    with st("sort reference"):
        native.sort_file(path, ref)
    if not files_equal(out, ref):
        raise AssertionError(f"sort --engine {engine} differs from "
                             "native.sort_file")
    os.unlink(out)
    os.unlink(ref)


def run_streaming(work: str, records: int) -> dict[str, float]:
    """``stats``, ``histogram`` and ``sort`` on a patterned file, each
    against its plain reference, and the ``--engine auto`` decisions."""
    import numpy as np

    from ibu_jax.io.mmap import MmapReader
    from ibu_jax.ops.stats import barcode_histogram_np
    from ibu_jax.parallel import select
    from ibu_jax.parallel.multihost import _choose_pod_sort_engine
    from ibu_jax.utils.datagen import write_patterned_file

    st = Stages("streaming")
    path = os.path.join(work, "stream.ibu")
    with st("generate"):
        write_patterned_file(path, records)
    check_stats(st, path, records)
    with st("histogram"):
        hist = read_histogram(cli("histogram", path, "--engine", "device",
                                  "--top", records))
    with st("histogram reference"):
        want = barcode_histogram_np(np.asarray(MmapReader(path).records))
    if hist != want:
        raise AssertionError(f"histogram: {len(hist)} barcodes, reference "
                             f"{len(want)}")
    check_sort(st, path, "device")
    log(f"[streaming] stats, histogram and sort of {records} records "
        "match their references")

    select.reset_probe_memo()
    rates = select.probe_rates(path, records)
    engine, why = select.choose_stats_engine(rates["device_gbps"],
                                             rates["native_recs"])
    log(f"[streaming] stats --engine auto: device feed probe "
        f"{rates['device_gbps']:.2f} GB/s, native probe "
        f"{rates['native_recs'] / 1e6:.0f} Mrec/s -> {engine} ({why})")
    hist_engine = select.auto_device_or_host(announce=False)
    codec_engine = select.auto_codec_engine(announce=False)
    for what, engine, probe in (
        ("histogram", hist_engine, "host_hist_recs"),
        ("codec", codec_engine, "native_codec_recs"),
    ):
        rate = select._MEMO.get(probe)
        rate = "not probed" if rate is None else f"{rate / 1e6:.0f} Mrec/s"
        log(f"[streaming] {what} auto -> {engine} (host probe {rate})")
    log("[streaming] pod sort engine for this file: "
        "%s (%s)" % _choose_pod_sort_engine(path))
    os.unlink(path)
    return st.seconds


def run_four_cards(work: str, records: int) -> dict[str, float]:
    """The paths that span the local devices, on one file: mesh sort (vs
    ``native.sort_file``), stats (vs the closed form), the device-table
    histogram (vs the closed form), and the pod-sort engine choice."""
    import jax
    import numpy as np

    from ibu_jax.io.mmap import STREAM_BATCH_RECORDS
    from ibu_jax.parallel.multihost import _choose_pod_sort_engine
    from ibu_jax.utils.datagen import write_patterned_file

    st = Stages("four-cards")
    path = os.path.join(work, "mesh.ibu")
    with st("generate"):
        write_patterned_file(path, records)
    log("[four-cards] pod sort engine: %s (%s)"
        % _choose_pod_sort_engine(path))
    check_sort(st, path, "mesh")
    check_stats(st, path, records)
    # the file holds min(records, 1M) distinct barcodes, all of which the
    # device table keeps; a stream batch's barcodes are all distinct, so
    # each card's share of a batch is its per-shard unique count
    m = min(records, 1_000_000)
    per_card = -(-min(records, STREAM_BATCH_RECORDS) // len(jax.devices()))
    with st("histogram"):
        hist = read_histogram(cli(
            "histogram", path, "--engine", "device", "--device-table", m,
            "--max-uniques", per_card, "--top", records))
    q, r = divmod(records, 1_000_000)
    want = np.full(m, q, np.int64)
    want[:r] += 1
    if hist != dict(zip(range(m), want.tolist())):
        raise AssertionError(f"histogram: {len(hist)} barcodes, closed "
                             f"form {m}")
    log(f"[four-cards] mesh sort, stats and histogram of {records} records "
        "match their references")
    os.unlink(path)
    return st.seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cells", type=int, default=5_000)
    ap.add_argument("--reads", type=int, default=50_000_000)
    ap.add_argument("--genes", type=int, default=30_000)
    ap.add_argument("--error-rate", type=float, default=0.2)
    ap.add_argument("--records", type=int, default=None,
                    help="streaming file size (default 100M; 500M with "
                         "--four-cards)")
    ap.add_argument("--codec-records", type=int, default=1 << 25)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the paths that span four cards")
    ap.add_argument("--workdir", default=os.path.join(REPO, ".smoke_work"))
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from ibu_jax.utils import apply_platform_env

    apply_platform_env()
    import jax

    devices = jax.devices()
    d = devices[0]
    if d.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {d.platform!r})",
              file=sys.stderr)
        return 1
    if args.four_cards and len(devices) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found "
              f"{len(devices)}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[device] {card}")
    log(f"[device] kind {d.device_kind!r}, {len(devices)} device(s), "
        f"jax {jax.__version__}")
    from ibu_jax import native

    log("[device] native host runtime: " + (
        "built" if native.available() else f"unavailable: {native.load_error()}"
    ))

    os.makedirs(args.workdir, exist_ok=True)
    work = tempfile.mkdtemp(dir=args.workdir)
    t0 = time.perf_counter()
    try:
        if args.four_cards:
            run_four_cards(work, args.records or 500_000_000)
        else:
            from ibu_jax.validate import run_matrix

            with Stages("validation")("matrix"):
                results = run_matrix(progress=lambda s: log(f"  {s}"))
            failed = [name for name, ok in results if not ok]
            if failed:
                raise AssertionError(f"validation failed: {failed}")
            log(f"[validation] {len(results)}/{len(results)} checks pass, "
                f"compiled for {d.device_kind}")

            import bench

            codec = bench.bench_codec(args.codec_records, 16, 12)
            for op in ("encode", "decode", "roundtrip"):
                c = codec[op]
                log(f"[validation] codec {op} on {card}: XLA "
                    f"{c['seconds'] * 1e3:.3f} ms, same-bytes copy "
                    f"{c['copy_seconds'] * 1e3:.3f} ms "
                    f"({args.codec_records} records, {c['bytes']} bytes), "
                    f"copy share {c['copy_share']:.3f}")

            log(f"[chain] {args.cells} cells x ~{args.reads // args.cells} "
                "reads; a user library has 10k cells at 20k-50k reads, cut "
                "here for run time (--cells/--reads raise it)")
            run_chain(work, args.cells, args.reads, args.genes,
                      args.error_rate, args.seed)
            run_streaming(work, args.records or 100_000_000)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[done] {time.perf_counter() - t0:.1f} s after device start-up")
    print(result_line(d.platform, d.device_kind, len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
