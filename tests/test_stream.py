"""DeviceStream prefetch tests."""

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from ibu_jax.io.stream import DeviceStream, stream_file
from ibu_jax.ops.stats import checksum_records_np
from ibu_jax.parallel.device import STATS_MAP_REDUCE, finalize_stats, make_mesh
from tests.conftest import make_records_arange


class TestDeviceStream:
    def test_yields_all_batches(self, tmp_ibu_file):
        path = tmp_ibu_file(make_records_arange(10_000))
        stream = stream_file(path, batch_records=2048)
        total = 0
        for dev_raw, valid in stream:
            total += int(np.asarray(valid).sum())
        assert total == 10_000

    def test_prefetch_depth_respected(self):
        produced = []

        def batches():
            for k in range(5):
                produced.append(k)
                yield make_records_arange(16)

        s = DeviceStream(batches(), prefetch=2)
        first = next(s)
        # after one consumption, at most 3 batches produced (1 consumed + 2 queued)
        assert len(produced) <= 3
        rest = list(s)
        assert len(rest) == 4

    def test_run_placed_matches_run(self, tmp_ibu_file):
        records = make_records_arange(25_000)
        path = tmp_ibu_file(records)
        mesh = make_mesh()
        got = finalize_stats(
            STATS_MAP_REDUCE.run_placed(
                stream_file(path, mesh=mesh, batch_records=4096), mesh=mesh
            )
        )
        want = checksum_records_np(records)
        assert got["count"] == 25_000
        assert (got["barcode_sum"], got["umi_sum"], got["index_sum"]) == want

    def test_empty_file(self, tmp_ibu_file):
        path = tmp_ibu_file(make_records_arange(0))
        assert list(stream_file(path)) == []


class TestStreamDefaults:
    def test_env_overrides(self):
        """IBU_STREAM_BATCH_RECORDS / IBU_STREAM_PREFETCH bind the module
        constants at import (fresh process — the knobs for
        directly-attached hosts where bigger feeds win)."""
        import subprocess
        import sys

        out = subprocess.run(
            [sys.executable, "-c",
             "from ibu_jax.io.mmap import STREAM_BATCH_RECORDS, "
             "STREAM_PREFETCH; print(STREAM_BATCH_RECORDS, STREAM_PREFETCH)"],
            capture_output=True, text=True,
            env={"PATH": "/usr/bin:/bin", "PYTHONPATH": REPO,
                 "IBU_STREAM_BATCH_RECORDS": "123456",
                 "IBU_STREAM_PREFETCH": "7"},
        )
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["123456", "7"]

    def test_defaults_match_reference_batch(self):
        """Subprocess with a clean env: the module constants bind
        os.environ at import, so in-process reads would see whatever the
        invoking shell exported."""
        import subprocess
        import sys

        out = subprocess.run(
            [sys.executable, "-c",
             "from ibu_jax.io.mmap import BATCH_SIZE, "
             "STREAM_BATCH_RECORDS, STREAM_PREFETCH; "
             "assert STREAM_BATCH_RECORDS == BATCH_SIZE; "  # ref mmap.rs:284
             "assert STREAM_PREFETCH >= 1; print('ok')"],
            capture_output=True, text=True,
            env={"PATH": "/usr/bin:/bin", "PYTHONPATH": REPO},
        )
        assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


class TestThreadPrefetched:
    """Background-thread producer used by ingest_fastq (CPU-bound parse
    overlapping the consumer's encode)."""

    def test_order_and_completeness(self):
        from ibu_jax.io.stream import thread_prefetched

        assert list(thread_prefetched(iter(range(1000)), depth=3)) == list(
            range(1000)
        )

    def test_producer_exception_reraises_in_consumer(self):
        import pytest

        from ibu_jax.io.stream import thread_prefetched

        def gen():
            yield 1
            yield 2
            raise RuntimeError("parse failed at line 9")

        it = thread_prefetched(gen(), depth=2)
        assert next(it) == 1 and next(it) == 2
        with pytest.raises(RuntimeError, match="line 9"):
            next(it)

    def test_early_abandon_stops_producer(self):
        import threading
        import time

        from ibu_jax.io.stream import thread_prefetched

        produced = []

        def gen():
            for i in range(10_000):
                produced.append(i)
                yield i

        it = thread_prefetched(gen(), depth=2)
        for _, _ in zip(range(3), it):
            pass
        it.close()  # GeneratorExit -> stop event -> producer drains out
        deadline = time.time() + 5
        while time.time() < deadline:
            alive = [
                t for t in threading.enumerate() if t.name == "ibu-prefetch"
            ]
            if not alive:
                break
            time.sleep(0.05)
        assert not alive, "producer thread still running after close()"
        assert len(produced) < 10_000, "producer ran to completion anyway"
