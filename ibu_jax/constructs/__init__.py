"""Wire-format core: the 32-byte header and 24-byte record types.

Equivalent of the reference's ``src/constructs/`` module
(``/root/reference/src/constructs/mod.rs:1-5``).
"""

from ibu_jax.constructs.header import HEADER_SIZE, MAGIC, VERSION, Header
from ibu_jax.constructs.record import (
    RECORD_DTYPE,
    RECORD_SIZE,
    Record,
    empty_records,
    make_records,
    records_from_bytes,
    records_to_bytes,
    sort_records,
)

__all__ = [
    "HEADER_SIZE",
    "MAGIC",
    "VERSION",
    "Header",
    "RECORD_DTYPE",
    "RECORD_SIZE",
    "Record",
    "empty_records",
    "make_records",
    "records_from_bytes",
    "records_to_bytes",
    "sort_records",
]
