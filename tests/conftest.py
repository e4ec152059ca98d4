"""Test configuration.

Tests run on CPU with 8 virtual XLA devices so the multi-device sharding
path (`shard_map` over a Mesh) is exercised without accelerator hardware —
the strategy described in SURVEY.md §4 ("How parallelism is tested without
a cluster"). Must run before any jax import, hence the env mutation at
module top. Tests that need the GPU carry the ``gpu`` marker and skip here;
``python chip_smoke.py`` runs their checks on the card.
"""

import os

# Force CPU: tests always run on the virtual CPU mesh; chip_smoke.py and
# bench.py are the accelerator paths.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

from ibu_jax.utils.platform import enable_compile_cache

# pin the config too: jax may already have read the environment
jax.config.update("jax_platforms", "cpu")

# Persistent compile cache: most test wall-time is XLA compilation; cache
# every entry across runs, in the same directory the program uses.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np
import pytest

from ibu_jax import Header, Writer


@pytest.fixture
def tmp_ibu_file(tmp_path):
    """Factory fixture: write a records array to a temp IBU file, return path."""

    def _make(records: np.ndarray, header: Header | None = None, name="test.ibu"):
        if header is None:
            header = Header.new(16, 12)
        path = str(tmp_path / name)
        with Writer.from_path(path, header) as w:
            w.write_batch(records)
        return path

    return _make


def make_records_arange(n: int) -> np.ndarray:
    """Deterministic records with closed-form field sums (the reference's
    checksum-test methodology, ``mmap.rs:454-481``)."""
    from ibu_jax import RECORD_DTYPE

    out = np.empty(n, dtype=RECORD_DTYPE)
    idx = np.arange(n, dtype=np.uint64)
    out["barcode"] = idx
    out["umi"] = idx * np.uint64(2)
    out["index"] = idx * np.uint64(3)
    return out
