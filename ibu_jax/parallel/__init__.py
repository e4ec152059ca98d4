"""Parallel engines: host threads (parity) and the device mesh (flagship).

The reference's single parallelism strategy is data parallelism over a
memory-mapped record array with shared-memory merges
(``/root/reference/src/io/mmap.rs:286-332``). Here that splits into:

* :mod:`ibu_jax.parallel.host` — host-thread engine, shard-boundary-identical
  to the reference;
* :mod:`ibu_jax.parallel.device` — ``shard_map`` over a ``jax.sharding.Mesh``
  with ``psum``/``all_gather`` merges (imported lazily; requires jax);
* :mod:`ibu_jax.parallel.multihost` — per-process byte-range reads +
  ``jax.distributed`` for pod slices.
"""

from ibu_jax.parallel.host import partition, process_parallel, resolve_num_threads
from ibu_jax.parallel.processor import BatchProcessor, ParallelProcessor

__all__ = [
    "BatchProcessor",
    "ParallelProcessor",
    "partition",
    "process_parallel",
    "resolve_num_threads",
]
