"""CLI-level pod-cohort tests: ``python -m ibu_jax <cmd> --distributed``
run as a real 2-process jax.distributed CPU cluster (the same launch shape
a pod operator uses — one identical command per host), verifying rank-0-only
output and cross-rank correctness."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from ibu_jax import Header, MmapReader, Writer
from ibu_jax.constructs.record import make_records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cohort_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    return env


def _run_cohort(cli_args: list, nprocs: int = 2, timeout: int = 150):
    """Launch the SAME CLI command on every 'host', pinned into one cohort."""
    port = _free_port()
    env = _cohort_env()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ibu_jax", *cli_args,
             "--distributed", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(nprocs), "--process-id", str(r)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        for r in range(nprocs)
    ]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for r, (out, err) in enumerate(outs):
        assert procs[r].returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    # The CPU stand-in's Gloo backend prints connection banners to stdout
    # from C++, and its unbuffered
    # writes can TEAR mid-line against Python's, so tests must select the
    # recognizable CLI lines rather than assert raw stdout emptiness.
    return outs


@pytest.fixture(scope="module")
def data_file(tmp_path_factory):
    n = 60_003  # odd: exercises the remainder partition across ranks
    i = np.arange(n, dtype=np.uint64)
    path = str(tmp_path_factory.mktemp("clid") / "in.ibu")
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(
            make_records(i % np.uint64(64), i * np.uint64(2), i)
        )
    return path, n


@pytest.mark.slow
def test_cli_distributed_stats(data_file):
    path, n = data_file
    s = n * (n - 1) // 2
    want = {
        "count": n,
        "barcode_sum": sum(k % 64 for k in range(n)),
        "umi_sum": 2 * s,
        "index_sum": s,
    }
    # Gloo's C++ banners write to stdout UNBUFFERED and can tear a line
    # mid-character against Python's writes (module docstring): select
    # the stats JSON by shape — a {...} line that PARSES with the right
    # keys — instead of assuming '{' prefix lines arrived untorn
    def stats_lines(out):
        found = []
        for l in out.splitlines():
            brace = l.find("{")
            if brace < 0:
                continue
            try:
                d = json.loads(l[brace:])
            except json.JSONDecodeError:
                continue
            if isinstance(d, dict) and "barcode_sum" in d:
                found.append(d)
        return found

    # a banner injected INSIDE the JSON line corrupts it unrecoverably
    # (stand-in-only artifact; real pods don't run Gloo): retry the
    # cohort once before failing
    for attempt in range(2):
        outs = _run_cohort(["stats", path])
        got = stats_lines(outs[0][0])
        if got:
            break
    assert got == [want], outs[0][0]
    assert not stats_lines(outs[1][0]), "rank 1 must print no result"


@pytest.mark.slow
def test_cli_distributed_histogram(data_file):
    path, n = data_file
    import re

    # 300 s: the distributed DeviceHistogram compiles its (mesh, stage)
    # shapes fresh in each cohort subprocess on a cold cache — generous
    # headroom so shared-CI contention can't turn a compile into a "hang"
    outs = _run_cohort(["histogram", path, "--top", "64"], timeout=300)
    row = re.compile(r"^[ACGT]{16}\t\d+$")
    lines = [l for l in outs[0][0].splitlines() if row.match(l)]
    assert len(lines) == 64, outs[0][0]
    counts = {}
    for line in lines:
        seq, cnt = line.split("\t")
        counts[seq] = int(cnt)
    # barcodes cycle 0..63 over 60_003 records: 0,1,2 appear 938 times
    assert sum(counts.values()) == n
    assert counts["AAAAAAAAAAAAAAAA"] == -(-n // 64)
    assert not any(row.match(l) for l in outs[1][0].splitlines()), (
        "rank 1 must print no rows"
    )


@pytest.mark.slow
def test_cli_distributed_sort(tmp_path):
    n = 49_999
    rng = np.random.default_rng(7)
    path = str(tmp_path / "in.ibu")
    out = str(tmp_path / "out.ibu")
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(
            make_records(
                rng.integers(0, 1 << 32, n).astype(np.uint64),
                rng.integers(0, 1 << 24, n).astype(np.uint64),
                rng.integers(0, 1 << 32, n).astype(np.uint64),
            )
        )
    outs = _run_cohort(["sort", path, out, "--engine", "mesh"])
    assert "sorted" in outs[0][0]
    assert "sorted" not in outs[1][0], "rank 1 must print no result"
    got = MmapReader(out)
    src = MmapReader(path)
    want = np.sort(np.asarray(src.records), order=("barcode", "umi", "index"))
    assert got.header().sorted()
    assert got.len() == n
    assert np.array_equal(np.asarray(got.records), want)


@pytest.mark.slow
def test_cli_distributed_dedup(tmp_path):
    """Pod-wide dedup of an UNSORTED duplicate-heavy file: runs the
    multihost mesh sort first, then the range-partitioned dedup pass with
    cross-rank boundary carries; verified against a numpy oracle."""
    n = 40_000
    rng = np.random.default_rng(3)
    path = str(tmp_path / "in.ibu")
    out = str(tmp_path / "out.ibu")
    # ~6 reads per (bc, umi) pair on average → heavy duplication, and
    # hot pairs straddle the rank boundary after sorting
    bc = rng.integers(0, 64, n).astype(np.uint64)
    umi = rng.integers(0, 100, n).astype(np.uint64)
    idx = rng.integers(0, 1 << 20, n).astype(np.uint64)
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(make_records(bc, umi, idx))
    outs = _run_cohort(["dedup", path, out])
    pairs = {}
    for b, u, x in zip(bc, umi, idx):
        key = (int(b), int(u))
        pairs[key] = min(pairs.get(key, 1 << 62), int(x))
    want = np.array(
        sorted((b, u, x) for (b, u), x in pairs.items()),
        dtype=np.uint64,
    )
    got = MmapReader(out)
    assert got.header().sorted()
    assert got.len() == len(pairs)
    arr = np.asarray(got.records)
    assert np.array_equal(arr["barcode"], want[:, 0])
    assert np.array_equal(arr["umi"], want[:, 1])
    assert np.array_equal(arr["index"], want[:, 2])
    line = [l for l in outs[0][0].splitlines() if l.startswith("dedup ")]
    assert line and f"{n} reads -> {len(pairs)} molecules" in line[0]
    assert f"across {len(set(int(b) for b in bc))} barcodes" in line[0]
    assert not any(l.startswith("dedup ") for l in outs[1][0].splitlines())
    assert not os.path.exists(out + ".mhsort.tmp"), "sort temp not cleaned"


@pytest.mark.slow
def test_cli_distributed_filter_and_correct(tmp_path):
    """Pod-wide filter and correct must write BYTE-IDENTICAL outputs to
    the single-host tools (contiguous rank ranges in rank order), with
    matching stats lines and a correctly-verified cross-rank sorted flag."""
    import filecmp

    from ibu_jax.ops.codec import decode_seqs
    from ibu_jax.pipelines import correct_file, filter_file

    n = 50_021
    rng = np.random.default_rng(9)
    allow_vals = np.unique(rng.integers(0, 1 << 30, 40).astype(np.uint64))
    # mix: exact allowlist hits, 1-bases-off neighbors, random junk
    pick = rng.integers(0, 3, n)
    bc = rng.integers(0, 1 << 32, n).astype(np.uint64)
    bc[pick == 0] = rng.choice(allow_vals, int((pick == 0).sum()))
    flip = rng.choice(allow_vals, int((pick == 1).sum()))
    pos = rng.integers(0, 16, len(flip)).astype(np.uint64)  # one base off
    bc[pick == 1] = flip ^ (np.uint64(1) << (2 * pos))
    path = str(tmp_path / "in.ibu")
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(make_records(
            bc,
            rng.integers(0, 1 << 24, n).astype(np.uint64),
            np.arange(n, dtype=np.uint64),
        ))
    allow_file = tmp_path / "allow.txt"
    allow_file.write_text(
        "".join(s + "\n" for s in decode_seqs(allow_vals, 16))
    )

    f_dist, f_solo = str(tmp_path / "f_d.ibu"), str(tmp_path / "f_s.ibu")
    outs = _run_cohort(
        ["filter", path, f_dist, "--barcodes", str(allow_file)]
    )
    stats = filter_file(path, f_solo, allow_vals)
    assert filecmp.cmp(f_dist, f_solo, shallow=False)
    line = [l for l in outs[0][0].splitlines() if l.startswith("filter ")]
    assert line and f"kept {stats['kept']} of {n} records" in line[0]

    c_dist, c_solo = str(tmp_path / "c_d.ibu"), str(tmp_path / "c_s.ibu")
    outs = _run_cohort(
        ["correct", path, c_dist, "--barcodes", str(allow_file)]
    )
    stats = correct_file(path, c_solo, allow_vals)
    assert stats["corrected"] > 0 and stats["dropped"] > 0  # real mix
    assert filecmp.cmp(c_dist, c_solo, shallow=False)
    line = [l for l in outs[0][0].splitlines() if l.startswith("correct ")]
    assert line and (
        f"{stats['exact']} exact, {stats['corrected']} corrected" in line[0]
    )

    # sorted all-exact input: correction preserves order, so the output
    # sorted flag must be SET — exercising the CROSS-RANK observed-order
    # verification (local verdicts + boundary-pair checks) and process
    # 0's post-barrier flag patch; byte-identity covers the flag byte too
    srt_in = str(tmp_path / "sorted_in.ibu")
    m = 30_011
    recs = np.sort(
        make_records(
            rng.choice(allow_vals, m),
            rng.integers(0, 1 << 24, m).astype(np.uint64),
            np.arange(m, dtype=np.uint64),
        ),
        order=("barcode", "umi", "index"),
    )
    h = Header.new(16, 12)
    h.set_sorted()
    with Writer.from_path(srt_in, h) as w:
        w.write_batch(recs)
    s_dist, s_solo = str(tmp_path / "s_d.ibu"), str(tmp_path / "s_s.ibu")
    _run_cohort(["correct", srt_in, s_dist, "--barcodes", str(allow_file)])
    correct_file(srt_in, s_solo, allow_vals)
    assert MmapReader(s_solo).header().sorted(), "oracle must set the flag"
    assert filecmp.cmp(s_dist, s_solo, shallow=False)


@pytest.mark.slow
def test_cli_distributed_dedup_lying_flag_fails_cohort_uniformly(tmp_path):
    """A lying sorted flag must fail EVERY rank with the clear one-line
    error (the order verdict travels in the count allgather) — not
    deadlock the ranks whose ranges happen to be locally sorted."""
    n = 20_000
    rng = np.random.default_rng(13)
    path = str(tmp_path / "lying.ibu")
    # rank 0's range (first half) is sorted; the out-of-order pair lives
    # in rank 1's range, so without the cohort-uniform verdict rank 0
    # would hang at the allgather
    bc = np.sort(rng.integers(0, 1 << 32, n).astype(np.uint64))
    bc[-2], bc[-1] = bc[-1], bc[-2]
    h = Header.new(16, 12)
    h.set_sorted()  # lie
    with Writer.from_path(path, h) as w:
        w.write_batch(make_records(bc, bc, bc))
    port = _free_port()
    env = _cohort_env()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ibu_jax", "dedup", path,
             str(tmp_path / "out.ibu"),
             "--distributed", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(r)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        for r in range(2)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    for r, (out, err) in enumerate(outs):
        assert procs[r].returncode == 1, (
            f"rank {r} rc={procs[r].returncode}:\n{err[-2000:]}"
        )
        assert "not in sorted order" in err, f"rank {r}:\n{err[-2000:]}"
    assert not os.path.exists(tmp_path / "out.ibu"), (
        "failed dedup must not leave an output file"
    )


@pytest.mark.slow
def test_cli_distributed_export_fastq(tmp_path):
    """Each host exports its record range into its own FASTQ shard;
    shards concatenated in rank order must equal the single-host export
    byte-for-byte (plain output, so the bytes compare directly)."""
    from ibu_jax.pipelines import export_fastq

    n = 30_007
    rng = np.random.default_rng(21)
    path = str(tmp_path / "in.ibu")
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(make_records(
            rng.integers(0, 1 << 32, n).astype(np.uint64),
            rng.integers(0, 1 << 24, n).astype(np.uint64),
            np.arange(n, dtype=np.uint64),
        ))
    out = str(tmp_path / "reads.fastq")
    outs = _run_cohort(["export-fastq", path, out])
    import re

    per_rank = []
    for r in range(2):
        m = re.search(r"exported (\d+) reads -> \S*part%d" % r, outs[r][1])
        assert m, outs[r][1][-500:]
        per_rank.append(int(m.group(1)))
    assert sum(per_rank) == n  # shard counts are LOCAL, not the total
    assert f"pod total: {n} reads" in outs[0][1]
    assert "pod total" not in outs[1][1]
    part0 = (tmp_path / "reads.part0.fastq").read_bytes()
    part1 = (tmp_path / "reads.part1.fastq").read_bytes()
    solo = str(tmp_path / "solo.fastq")
    export_fastq(path, solo)
    assert part0 + part1 == open(solo, "rb").read()


@pytest.mark.slow
def test_cli_distributed_count(tmp_path):
    """Pod-wide count matrix: the heavy uniquing shards per host and the
    MatrixMarket trio written by process 0 must be byte-identical to the
    single-host tool — on an UNSORTED input (cross-rank triple dedup via
    the global unique) and on a SORTED one (O(n) adjacent-diff with the
    mmap boundary carry), with duplicates planted astride the rank cut."""
    import filecmp

    from ibu_jax.pipelines import count_matrix

    n = 36_011
    rng = np.random.default_rng(17)
    bc = rng.integers(0, 50, n).astype(np.uint64)
    umi = rng.integers(0, 40, n).astype(np.uint64)
    idx = rng.integers(0, 30, n).astype(np.uint64)  # heavy duplication
    for name, recs in [
        ("unsorted", make_records(bc, umi, idx)),
        ("sorted", np.sort(make_records(bc, umi, idx),
                           order=("barcode", "umi", "index"))),
    ]:
        path = str(tmp_path / f"{name}.ibu")
        h = Header.new(16, 12)
        if name == "sorted":
            h.set_sorted()
        with Writer.from_path(path, h) as w:
            w.write_batch(recs)
        d_pref = str(tmp_path / f"{name}_d")
        s_pref = str(tmp_path / f"{name}_s")
        outs = _run_cohort(["count", path, d_pref])
        stats = count_matrix(path, s_pref)
        for suffix in (".mtx", ".barcodes.txt", ".indices.txt"):
            assert filecmp.cmp(d_pref + suffix, s_pref + suffix,
                               shallow=False), (name, suffix)
        line = [l for l in outs[0][0].splitlines() if l.startswith("count ")]
        assert line and f"{stats['molecules']} molecules" in line[0], (
            name, outs[0][0]
        )
        assert not any(
            l.startswith("count ") for l in outs[1][0].splitlines()
        )
        assert not list(tmp_path.glob("*.mh_count.part*")), (
            "partial exchange files not cleaned"
        )


@pytest.mark.slow
def test_cli_distributed_ingest_fastq(tmp_path):
    """Pod-wide FASTQ ingest: raw byte ranges align to line starts, the
    newline-count allgather fixes the 4-line phase and global read
    indices, each host encodes+pwrites its shard, and the pod mesh sort
    finishes — output must be byte-identical to the single-host ingest
    (the byte cut lands mid-read by construction: variable-length names
    make the read size non-constant)."""
    import filecmp

    from ibu_jax.pipelines import ingest_fastq

    n = 25_013
    rng = np.random.default_rng(33)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    fq = tmp_path / "reads.fastq"
    with open(fq, "wb") as f:
        for i in range(n):
            seq = bytes(rng.choice(alphabet, 28))
            f.write(b"@read_%d\n%s\n+\n%s\n" % (i, seq, b"F" * 28))
    d_out, s_out = str(tmp_path / "d.ibu"), str(tmp_path / "s.ibu")
    outs = _run_cohort(["ingest-fastq", str(fq), d_out])
    line = [l for l in outs[0][1].splitlines() if "ingested" in l]
    assert line and f"ingested {n} reads" in line[0]
    assert not any("ingested" in l for l in outs[1][1].splitlines())
    ingest_fastq(str(fq), s_out, 16, 12)
    assert filecmp.cmp(d_out, s_out, shallow=False)
    assert not os.path.exists(d_out + ".mhingest.tmp")

    # a parse failure (short read in rank 1's range) must fail BOTH ranks
    # cohort-uniformly and leave the pre-existing output untouched (only
    # the sort stage writes it, and that never ran)
    bad = tmp_path / "bad.fastq"
    with open(bad, "wb") as f:
        for i in range(2000):
            seq = b"ACG" if i == 1999 else bytes(rng.choice(alphabet, 28))
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"F" * len(seq)))
    before = open(d_out, "rb").read()
    port = _free_port()
    env = _cohort_env()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ibu_jax", "ingest-fastq", str(bad),
             d_out, "--distributed", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(r)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        for r in range(2)
    ]
    for r, p in enumerate(procs):
        _, err = p.communicate(timeout=120)
        assert p.returncode == 1, f"rank {r}: rc={p.returncode}\n{err[-1500:]}"
        assert "shorter than" in err or "another process" in err, err[-1000:]
    assert open(d_out, "rb").read() == before, (
        "failed ingest must not touch a pre-existing output"
    )
    assert not os.path.exists(d_out + ".mhingest.tmp")

    # compressed FASTQ: clear refusal on EVERY rank (both sniff the same
    # bytes and raise before any collective — no deadlock)
    import gzip

    gz = tmp_path / "reads.fastq.gz"
    gz.write_bytes(gzip.compress(fq.read_bytes()[:400]))
    port = _free_port()
    env = _cohort_env()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ibu_jax", "ingest-fastq", str(gz),
             str(tmp_path / "x.ibu"), "--distributed",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(r)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        for r in range(2)
    ]
    for r, p in enumerate(procs):
        _, err = p.communicate(timeout=120)
        assert p.returncode == 1 and "no random access" in err, (
            f"rank {r}: rc={p.returncode}\n{err[-1500:]}"
        )


def test_cli_distributed_flag_validation(tmp_path):
    """--distributed refuses engines/inputs it cannot shard (fast, no cohort)."""
    path = str(tmp_path / "t.ibu")
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(make_records(
            np.arange(4, dtype=np.uint64),
            np.arange(4, dtype=np.uint64),
            np.arange(4, dtype=np.uint64),
        ))
    env = _cohort_env()
    r = subprocess.run(
        [sys.executable, "-m", "ibu_jax", "stats", path,
         "--engine", "native", "--distributed"],
        capture_output=True, text=True, env=env,
    )
    assert r.returncode == 2 and "drop --engine native" in r.stderr
    r = subprocess.run(
        [sys.executable, "-m", "ibu_jax", "sort", path,
         str(tmp_path / "o.ibu"), "--distributed"],
        capture_output=True, text=True, env=env,
    )
    assert r.returncode == 2 and "--engine mesh" in r.stderr
    r = subprocess.run(
        [sys.executable, "-m", "ibu_jax", "count", path,
         str(tmp_path / "cnt"), "--engine", "device", "--distributed"],
        capture_output=True, text=True, env=env,
    )
    assert r.returncode == 2 and "drop --engine device" in r.stderr


@pytest.mark.slow
def test_cli_distributed_sort_pod_host_engine(tmp_path):
    """`sort --engine pod --distributed` on the CPU stand-in auto-routes
    to the shared-FS native external sample sort: per-rank
    chunk sorts -> sampled triple splitters -> per-rank interval merges
    pwritten straight into the shared output. Byte-identical to the
    single-host native sort, duplicate triples astride splitters included."""
    from ibu_jax import native

    if not native.available():
        pytest.skip("no native runtime on this box")
    n = 50_001
    rng = np.random.default_rng(13)
    # heavy duplication: hot triples MUST straddle splitter boundaries
    recs = make_records(
        rng.integers(0, 97, n).astype(np.uint64),
        rng.integers(0, 11, n).astype(np.uint64),
        rng.integers(0, 7, n).astype(np.uint64),
    )
    path = str(tmp_path / "in.ibu")
    out = str(tmp_path / "out.ibu")
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(recs)
    outs = _run_cohort(["sort", path, out, "--engine", "pod"])
    assert "sorted" in outs[0][0]
    assert any("pod sort engine auto" in e for _, e in outs), (
        "auto announcement missing"
    )
    single = str(tmp_path / "single.ibu")
    native.sort_file(path, single)
    with open(out, "rb") as a, open(single, "rb") as b:
        assert a.read() == b.read(), "pod host sort not byte-identical"
    assert MmapReader(out).header().sorted()
    assert not list(tmp_path.glob("*.mhsort*")), "run files not cleaned"


@pytest.mark.slow
def test_cli_distributed_sort_pod_three_ranks(tmp_path):
    """3-rank pod host sort with an adversarial skew: most records share
    one barcode, so the sampled splitters collapse onto the hot key and
    interval assignment must stay exact (a key belongs wholly to one
    rank)."""
    from ibu_jax import native

    if not native.available():
        pytest.skip("no native runtime on this box")
    n = 30_000
    rng = np.random.default_rng(41)
    bc = np.where(
        rng.random(n) < 0.7, np.uint64(5), rng.integers(0, 1000, n)
    ).astype(np.uint64)
    recs = make_records(
        bc, rng.integers(0, 1 << 30, n).astype(np.uint64),
        np.arange(n, dtype=np.uint64),
    )
    path = str(tmp_path / "in.ibu")
    out = str(tmp_path / "out.ibu")
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(recs)
    _run_cohort(["sort", path, out, "--engine", "pod"], nprocs=3)
    got = np.asarray(MmapReader(out).records)
    want = np.sort(recs, order=("barcode", "umi", "index"))
    assert np.array_equal(got, want)
