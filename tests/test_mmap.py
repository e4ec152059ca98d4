"""MmapReader + host parallel engine tests — parity with the reference suite
(``mmap.rs:334-574``, ``parallel.rs:298-484``)."""

import threading

import numpy as np
import pytest

from ibu_jax import (
    BATCH_SIZE,
    BatchProcessor,
    Header,
    InvalidIndex,
    InvalidMapSize,
    MmapReader,
    ParallelProcessor,
    ProcessError,
    Record,
)
from ibu_jax.parallel.host import partition, process_parallel
from tests.conftest import make_records_arange


class TestConstruction:
    def test_len_and_header(self, tmp_ibu_file):
        path = tmp_ibu_file(make_records_arange(10_000))
        r = MmapReader(path)
        assert r.len() == 10_000
        assert len(r) == 10_000
        assert r.header().bc_len == 16

    def test_invalid_map_size(self, tmp_path, tmp_ibu_file):
        path = tmp_ibu_file(make_records_arange(10))
        with open(path, "ab") as f:
            f.write(b"\x00" * 5)
        with pytest.raises(InvalidMapSize):
            MmapReader(path)

    def test_empty_file(self, tmp_ibu_file):
        path = tmp_ibu_file(make_records_arange(0))
        assert MmapReader(path).len() == 0


class TestSlice:
    def test_zero_copy_contents(self, tmp_ibu_file):
        path = tmp_ibu_file(make_records_arange(1000))
        r = MmapReader(path)
        s = r.slice(100, 200)
        assert len(s) == 100
        assert s["barcode"][0] == 100
        assert s["umi"][99] == 398

    def test_slice_error_cases(self, tmp_ibu_file):
        """Exact InvalidIndex payloads (mmap.rs:425-452)."""
        path = tmp_ibu_file(make_records_arange(100))
        r = MmapReader(path)
        with pytest.raises(InvalidIndex) as ei:
            r.slice(100, 101)  # start >= len
        assert (ei.value.idx, ei.value.max) == (101, 100)
        with pytest.raises(InvalidIndex) as ei:
            r.slice(0, 101)  # end > len
        assert (ei.value.idx, ei.value.max) == (101, 100)
        with pytest.raises(InvalidIndex) as ei:
            r.slice(50, 50)  # end <= start
        assert (ei.value.idx, ei.value.max) == (50, 100)
        with pytest.raises(InvalidIndex):
            r.slice(60, 50)

    def test_random_access_large(self, tmp_ibu_file):
        path = tmp_ibu_file(make_records_arange(100_000))
        r = MmapReader(path)
        rng = np.random.default_rng(7)
        for _ in range(50):
            i = int(rng.integers(0, 100_000 - 1))
            s = r.slice(i, i + 1)
            assert s["barcode"][0] == i
            assert s["index"][0] == 3 * i

    def test_clone_shares_map(self, tmp_ibu_file):
        path = tmp_ibu_file(make_records_arange(100))
        r = MmapReader(path)
        c = r.clone()
        assert c.records is r.records  # same backing view object
        assert c.len() == 100

    def test_batch_size_sanity(self):
        assert BATCH_SIZE == 1024 * 1024


class TestPartition:
    def test_remainder_to_last(self):
        """Shard boundary parity (mmap.rs:297-307)."""
        assert partition(10, 3) == [(0, 3), (3, 6), (6, 10)]
        assert partition(9, 3) == [(0, 3), (3, 6), (6, 9)]
        assert partition(2, 4) == [(0, 0), (0, 0), (0, 0), (0, 2)]


class SumProcessor(ParallelProcessor):
    """Checksum processor with thread-local accumulation + locked merge —
    the reference's canonical aggregation pattern (parallel.rs:47-99)."""

    def __init__(self, totals, lock):
        self.totals = totals  # shared list [bc, umi, idx]
        self.lock = lock
        self.local = [0, 0, 0]

    def process_record(self, record: Record) -> None:
        self.local[0] += record.barcode
        self.local[1] += record.umi
        self.local[2] += record.index

    def on_batch_complete(self) -> None:
        with self.lock:
            for k in range(3):
                self.totals[k] += self.local[k]
        self.local = [0, 0, 0]

    def clone(self):
        c = SumProcessor(self.totals, self.lock)
        return c


class BatchSumProcessor(BatchProcessor):
    """Vectorized equivalent — the batch-first hot path."""

    def __init__(self, totals, lock):
        self.totals = totals
        self.lock = lock
        self.local = np.zeros(3, dtype=object)

    def process_batch(self, records) -> None:
        self.local[0] += int(records["barcode"].sum(dtype=object))
        self.local[1] += int(records["umi"].sum(dtype=object))
        self.local[2] += int(records["index"].sum(dtype=object))

    def on_batch_complete(self) -> None:
        with self.lock:
            for k in range(3):
                self.totals[k] += self.local[k]
        self.local = np.zeros(3, dtype=object)

    def clone(self):
        return BatchSumProcessor(self.totals, self.lock)


def closed_form(n):
    s = n * (n - 1) // 2
    return [s, 2 * s, 3 * s]


class TestParallelExecution:
    def test_checksum_4_threads(self, tmp_ibu_file):
        """10K records, 4 threads, closed-form sum (mmap.rs:454-481)."""
        path = tmp_ibu_file(make_records_arange(10_000))
        totals = [0, 0, 0]
        process_parallel(
            MmapReader(path), SumProcessor(totals, threading.Lock()), 4,
            batch_size=1024,
        )
        assert totals == closed_form(10_000)

    def test_checksum_batch_processor(self, tmp_ibu_file):
        path = tmp_ibu_file(make_records_arange(50_000))
        totals = [0, 0, 0]
        process_parallel(
            MmapReader(path), BatchSumProcessor(totals, threading.Lock()), 4,
            batch_size=4096,
        )
        assert totals == closed_form(50_000)

    def test_auto_thread_count(self, tmp_ibu_file):
        path = tmp_ibu_file(make_records_arange(5_000))
        totals = [0, 0, 0]
        process_parallel(
            MmapReader(path), BatchSumProcessor(totals, threading.Lock()), 0
        )
        assert totals == closed_form(5_000)

    def test_empty_file_two_threads(self, tmp_ibu_file):
        path = tmp_ibu_file(make_records_arange(0))
        totals = [0, 0, 0]
        process_parallel(
            MmapReader(path), SumProcessor(totals, threading.Lock()), 2
        )
        assert totals == [0, 0, 0]

    def test_error_propagation(self, tmp_ibu_file):
        """First processor error aborts the run as ProcessError
        (mmap.rs:326-329, parallel.rs:413-436)."""

        class Exploder(ParallelProcessor):
            def process_record(self, record):
                if record.barcode == 500:
                    raise ValueError("boom at 500")

        path = tmp_ibu_file(make_records_arange(1_000))
        with pytest.raises(ProcessError) as ei:
            process_parallel(MmapReader(path), Exploder(), 2)
        assert "boom at 500" in str(ei.value)

    def test_base_exception_reraised_not_swallowed(self, tmp_ibu_file):
        """A BaseException in a worker (SystemExit here) must re-raise in
        the caller AS ITSELF — not wrapped in ProcessError, and above all
        not silently swallowed by the thread (which would return success
        on partially-processed data)."""

        class Quitter(ParallelProcessor):
            def process_record(self, record):
                if record.barcode == 500:
                    raise SystemExit(3)

        path = tmp_ibu_file(make_records_arange(1_000))
        with pytest.raises(SystemExit) as ei:
            process_parallel(MmapReader(path), Quitter(), 2)
        assert ei.value.code == 3

    def test_set_tid_called(self, tmp_ibu_file):
        """Unlike the reference (which never calls set_tid — SURVEY §4
        discrepancy list), this engine does assign tids."""
        seen = []
        lock = threading.Lock()

        class TidRecorder(BatchProcessor):
            def process_batch(self, records):
                with lock:
                    seen.append(self.get_tid())

        path = tmp_ibu_file(make_records_arange(8))
        process_parallel(MmapReader(path), TidRecorder(), 2)
        assert set(seen) <= {0, 1}
        assert len(seen) >= 1

    def test_clone_independent_state(self):
        """Clones don't share thread-local state (parallel.rs:383-411)."""
        totals = [0, 0, 0]
        p = SumProcessor(totals, threading.Lock())
        p.process_record(Record(1, 1, 1))
        c = p.clone()
        assert c.local == [0, 0, 0]
        assert p.local == [1, 1, 1]

    def test_negative_threads_rejected(self, tmp_ibu_file):
        path = tmp_ibu_file(make_records_arange(10))
        with pytest.raises(ValueError, match="num_threads"):
            process_parallel(MmapReader(path), SumProcessor([0, 0, 0],
                             threading.Lock()), -1)
