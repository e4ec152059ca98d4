"""Cohort failure-injection fuzz.

The round-4/5 cohort semantics (failures travel as data through
checkpoint allgathers; cooperative writes unlink their outputs; every
rank raises together) are the most deadlock-prone code in the repo and
were covered only by directed tests. This leg drives a REAL 2-process
jax.distributed cohort through a random tool × random file × an injected
mid-write failure on a random rank, asserting:

* no hang — every rank exits within the watchdog (a bare-barrier bug
  would park the healthy rank until the distributed heartbeat timeout,
  minutes past the watchdog);
* cohort-uniform failure — EVERY rank exits nonzero;
* no partial outputs — the tool's outputs and its exchange/run temp
  files are gone.

With no injection (a third of the seeds) the same run must succeed and
match the single-host tool byte-for-byte.

CI runs 4 seeds; set FUZZ_COHORT_SEEDS=N for an extended sweep.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ibu_jax import Header, Writer
from ibu_jax.constructs.record import make_records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import os, sys
    (rank, nprocs, port, tool, in_path, out, fail_rank, fail_after) = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6], int(sys.argv[7]), int(sys.argv[8]),
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, {repo!r})
    from ibu_jax.utils import apply_platform_env
    apply_platform_env()
    import jax
    jax.distributed.initialize(
        f"127.0.0.1:{{port}}", num_processes=nprocs, process_id=rank
    )
    from ibu_jax.parallel import multihost as mh

    if rank == fail_rank:
        if tool == "sort-host":
            # the host sort writes through the native merge, not
            # _pwrite_all — inject there
            from ibu_jax import native as _nat
            real_merge = _nat.merge_runs_interval
            def boom_merge(*a, **k):
                raise OSError(28, "injected ENOSPC (fuzz)")
            _nat.merge_runs_interval = boom_merge
            mh_native = sys.modules.get("ibu_jax.native")
            mh_native.merge_runs_interval = boom_merge
        else:
            # inject at the FIRST write: ranges this small make exactly
            # one _pwrite_all call per pass, so a later index may never
            # be reached and the run would (correctly) succeed
            def boom(fd, data, offset):
                raise OSError(28, "injected ENOSPC (fuzz)")
            mh._pwrite_all = boom

    allow_path = in_path + ".allow"
    try:
        if tool == "dedup":
            r = mh.multihost_dedup_file(in_path, out)
        elif tool == "filter":
            import numpy as np
            allow = np.loadtxt(allow_path, dtype=np.uint64, ndmin=1)
            r = mh.multihost_filter_file(in_path, out, allow)
        elif tool == "correct":
            import numpy as np
            allow = np.loadtxt(allow_path, dtype=np.uint64, ndmin=1)
            r = mh.multihost_correct_file(in_path, out, allow)
        elif tool == "count":
            r = mh.multihost_count_matrix(in_path, out)
        elif tool == "sort-host":
            r = mh.multihost_sort_file(in_path, out, engine="host")
        elif tool == "sort-mesh":
            r = mh.multihost_sort_file(in_path, out, engine="mesh")
        else:
            raise SystemExit(f"unknown tool {{tool}}")
        print("DONE", r, flush=True)
    except BaseException as e:  # noqa: BLE001 — report + nonzero exit
        print(f"FAILED {{type(e).__name__}}: {{e}}", flush=True)
        raise SystemExit(3)
    """
).format(repo=REPO)

TOOLS = ("dedup", "filter", "correct", "count", "sort-host", "sort-mesh")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
@pytest.mark.parametrize(
    "seed", range(int(os.environ.get("FUZZ_COHORT_SEEDS", 4)))
)
def test_cohort_failure_injection(seed, tmp_path):
    from ibu_jax import native

    rng = np.random.default_rng(7000 + seed)
    tool = TOOLS[int(rng.integers(0, len(TOOLS)))]
    if tool == "sort-host" and not native.available():
        tool = "sort-mesh"
    n = int(rng.integers(8_000, 40_000))
    presorted = bool(rng.integers(0, 2))
    bc = rng.integers(0, 300, n).astype(np.uint64)
    recs = make_records(
        bc,
        rng.integers(0, 50, n).astype(np.uint64),
        rng.integers(0, 1 << 20, n).astype(np.uint64),
    )
    h = Header.new(16, 12)
    if presorted:
        recs = np.sort(recs, order=("barcode", "umi", "index"))
        h.set_sorted()
    in_path = str(tmp_path / "in.ibu")
    with Writer.from_path(in_path, h) as w:
        w.write_batch(recs)
    allow = np.unique(rng.choice(bc, size=40))
    np.savetxt(in_path + ".allow", allow, fmt="%d")
    out = str(tmp_path / ("cnt" if tool == "count" else "out.ibu"))

    # a third of the seeds run clean (success + byte-identity); the rest
    # inject a failure at a random write on a random rank
    inject = int(rng.integers(0, 3)) != 0
    fail_rank = int(rng.integers(0, 2)) if inject else -1
    fail_after = int(rng.integers(0, 2))

    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), str(r), "2", str(port), tool,
             in_path, out, str(fail_rank), str(fail_after)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        for r in range(2)
    ]
    try:
        # WATCHDOG: a cohort bug that parks a rank at a bare barrier
        # blocks until the distributed heartbeat timeout (minutes) — the
        # 120 s communicate() timeout catches it as a hang, not a pass
        outs = [p.communicate(timeout=120) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(
            f"seed {seed} tool {tool} inject={inject}: cohort HUNG "
            "(a rank blocked past the watchdog)"
        )
    rcs = [p.returncode for p in procs]

    if not inject:
        assert rcs == [0, 0], (
            f"clean run failed: {tool}\n" +
            "\n".join(e[-1500:] for _, e in outs)
        )
        # byte-identity vs the single-host tool
        from ibu_jax.pipelines import (
            correct_file,
            count_matrix,
            dedup_file,
            filter_file,
        )

        single = str(tmp_path / ("s_cnt" if tool == "count" else "s.ibu"))
        if tool == "dedup":
            dedup_file(in_path, single)
        elif tool == "filter":
            filter_file(in_path, single, allow)
        elif tool == "correct":
            correct_file(in_path, single, allow)
        elif tool == "count":
            count_matrix(in_path, single)
        elif tool == "sort-host":
            native.sort_file(in_path, single)
        else:
            from ibu_jax.pipelines import sort_file_device

            sort_file_device(in_path, single)
        if tool == "count":
            for sfx in (".mtx", ".barcodes.txt", ".indices.txt"):
                a = open(out + sfx, "rb").read()
                b = open(single + sfx, "rb").read()
                assert a == b, (tool, sfx)
        else:
            assert open(out, "rb").read() == open(single, "rb").read(), tool
    else:
        # cohort-uniform failure: EVERY rank exits nonzero, promptly
        assert all(rc != 0 for rc in rcs), (
            f"seed {seed} tool {tool} fail_rank {fail_rank}: a rank "
            f"succeeded despite the injected failure: rcs={rcs}\n" +
            "\n".join(o[-800:] for o, _ in outs)
        )
        # no partial outputs survive
        if tool == "count":
            for sfx in (".mtx", ".barcodes.txt", ".indices.txt"):
                assert not os.path.exists(out + sfx), (tool, sfx)
        else:
            assert not os.path.exists(out), tool

    # exchange/run/spool temp files never survive either way
    leftovers = [
        p.name for p in tmp_path.iterdir()
        if ".mh_count.part" in p.name or ".mhsort" in p.name
        or ".mhingest" in p.name
    ]
    assert not leftovers, (tool, inject, leftovers)
