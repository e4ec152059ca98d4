"""ibu_jax — a JAX framework for the IBU binary barcode/UMI format.

A ground-up JAX/XLA re-design of the capabilities of the reference
Rust crate ``noamteyssier/ibu`` (see ``SURVEY.md``): the IBU! v2 wire format
(32-byte header + 24-byte barcode/umi/index records), streaming and bulk I/O,
memory-mapped random access, transparent gzip/zstd compression on both read and write sides, a
data-parallel processing engine, and — new here — a first-class 2-bit
nucleotide codec compiled for the device.

The public API is flat, like the reference's ``src/lib.rs:173-181``::

    from ibu_jax import Header, Record, Reader, Writer, MmapReader, load_to_vec

Device-side entry points live in :mod:`ibu_jax.ops` (codec + stats kernels)
and :mod:`ibu_jax.parallel` (mesh engine). Importing :mod:`ibu_jax` itself
does not import jax, so pure host I/O stays light.
"""

from ibu_jax.constructs import (
    HEADER_SIZE,
    MAGIC,
    RECORD_DTYPE,
    RECORD_SIZE,
    VERSION,
    Header,
    Record,
    empty_records,
    records_from_bytes,
    records_to_bytes,
    sort_records,
)
from ibu_jax.errors import (
    CompressionError,
    IbuError,
    IbuIoError,
    InvalidBarcodeLength,
    InvalidIndex,
    InvalidMagicNumber,
    InvalidMapSize,
    InvalidUmiLength,
    InvalidVersion,
    ProcessError,
    TruncatedRecord,
    into_ibu_error,
)
from ibu_jax.io import (
    BATCH_SIZE,
    DEFAULT_BUFFER_RECORDS,
    DEFAULT_BUFFER_SIZE,
    MmapReader,
    Reader,
    Writer,
    load_to_vec,
)
from ibu_jax.parallel import (
    BatchProcessor,
    ParallelProcessor,
    process_parallel,
)

__version__ = "0.1.0"

__all__ = [
    "BATCH_SIZE",
    "BatchProcessor",
    "CompressionError",
    "DEFAULT_BUFFER_RECORDS",
    "DEFAULT_BUFFER_SIZE",
    "HEADER_SIZE",
    "Header",
    "IbuError",
    "IbuIoError",
    "InvalidBarcodeLength",
    "InvalidIndex",
    "InvalidMagicNumber",
    "InvalidMapSize",
    "InvalidUmiLength",
    "InvalidVersion",
    "MAGIC",
    "MmapReader",
    "ParallelProcessor",
    "ProcessError",
    "RECORD_DTYPE",
    "RECORD_SIZE",
    "Reader",
    "Record",
    "TruncatedRecord",
    "VERSION",
    "Writer",
    "empty_records",
    "into_ibu_error",
    "load_to_vec",
    "process_parallel",
    "records_from_bytes",
    "records_to_bytes",
    "sort_records",
]
