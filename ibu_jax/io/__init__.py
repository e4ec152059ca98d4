"""Host I/O layer: streaming reader/writer, bulk loader, mmap reader.

Equivalent of the reference's ``src/io/`` module
(``/root/reference/src/io/mod.rs:5-7``).
"""

from ibu_jax.io.compression import open_compressed, wrap_compress
from ibu_jax.io.mmap import BATCH_SIZE, MmapReader
from ibu_jax.io.reader import (
    DEFAULT_BUFFER_RECORDS,
    DEFAULT_BUFFER_SIZE,
    Reader,
    load_to_vec,
)
from ibu_jax.io.writer import Writer
from ibu_jax.io import stream

__all__ = [
    "BATCH_SIZE",
    "DEFAULT_BUFFER_RECORDS",
    "DEFAULT_BUFFER_SIZE",
    "MmapReader",
    "Reader",
    "Writer",
    "load_to_vec",
    "open_compressed",
    "wrap_compress",
]
