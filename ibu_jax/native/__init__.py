"""Native (C++) host runtime: bulk file I/O, threaded engine, host codec.

Built lazily with g++ on first use; see :mod:`ibu_jax.native.bindings`.
"""

from ibu_jax.native.bindings import (
    available,
    checksum_parallel,
    fastq_gather,
    file_size,
    load_error,
    merge_files,
    merge_runs_interval,
    pack_2bit,
    pread_parallel,
    pwrite_parallel,
    read_records,
    run_interval,
    sort_chunks_range,
    sort_file,
    sort_records,
    unpack_2bit,
    write_file,
)

__all__ = [
    "available",
    "checksum_parallel",
    "fastq_gather",
    "file_size",
    "load_error",
    "merge_files",
    "merge_runs_interval",
    "pack_2bit",
    "pread_parallel",
    "pwrite_parallel",
    "read_records",
    "run_interval",
    "sort_chunks_range",
    "sort_file",
    "sort_records",
    "unpack_2bit",
    "write_file",
]
