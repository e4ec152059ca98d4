"""Device-side ops: the 2-bit codec, u64 pairing, and stats.

This is the subsystem that replaces the reference's external ``bitnuc``
codec dependency and its per-record processing loops with jitted device
passes (see BASELINE.md north star).
"""

from ibu_jax.ops import codec, stats, u64
from ibu_jax.ops.codec import (
    decode_seqs,
    encode_seqs,
    lax_decode_planes,
    lax_decode_records,
    lax_encode_planes,
    lax_encode_records,
    np_pack,
    np_unpack,
    pair_to_words,
    planes_to_rows,
    rows_to_planes,
    rows_to_seqs,
    seqs_to_rows,
    words_to_pair,
)
from ibu_jax.ops.u64 import (
    join_u64,
    records_from_soa,
    soa_from_records,
    split_u64,
)

__all__ = [
    "codec",
    "decode_seqs",
    "encode_seqs",
    "join_u64",
    "lax_decode_planes",
    "lax_decode_records",
    "lax_encode_planes",
    "lax_encode_records",
    "np_pack",
    "np_unpack",
    "pair_to_words",
    "planes_to_rows",
    "records_from_soa",
    "rows_to_planes",
    "rows_to_seqs",
    "seqs_to_rows",
    "soa_from_records",
    "split_u64",
    "stats",
    "u64",
    "words_to_pair",
]
