"""Transport-aware engine auto-selection.

The reference's flagship path is fast "for free" because it is
host-native: the mmap'd records never cross a link
(the reference's ``src/io/mmap.rs:286-332``). The device streaming engine
is bounded END-TO-END by the host→device transport, so on a slow link the
device path can run far below the native host engine on the same box.
Auto mode probes both sides once and routes each streaming call to the
fastest engine actually available, saying so on stderr.

Probes:

* :func:`measure_device_feed_gbps` — sustained ``device_put`` bandwidth
  of the streaming wire layout onto the mesh (taken as the end-to-end
  device rate: the engine's own per-batch cost is assumed small beside
  the transfer);
* :func:`measure_native_recs_per_s` — the native threaded checksum
  engine timed on a PREFIX of the actual input file (real data, real
  page cache, no synthetic temp file).

Both are memoized per process and the decision is pure
(:func:`choose_stats_engine` takes injected probe values), so the logic
unit-tests with fake clocks and no hardware.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

#: per-process probe memo: {"device_gbps": float, "native_recs": float|None}
_MEMO: dict = {}

#: feed probe block: big enough to amortize dispatch, small enough that a
#: slow link still answers in a fraction of a second
PROBE_BYTES = 8 << 20

#: native probe prefix: 4M records ≈ 8 ms at the engine's ~500 Mrec/s,
#: still only ~80 ms on a 10× slower box — cheap next to any full pass
PROBE_RECORDS = 4 << 20


def measure_device_feed_gbps(
    mesh=None,
    probe_bytes: int = PROBE_BYTES,
    timer=time.perf_counter,
    min_seconds: float = 0.05,
    max_puts: int = 8,
) -> float:
    """Sustained host→device placement bandwidth (GB/s) of the streaming
    wire layout: timed ``device_put`` of ``(B, 6) uint32`` blocks sharded
    over the mesh, after one small warm-up put (allocator/layout setup).

    Each put gets a distinct leading word, so no put can reuse another's
    transfer. Puts repeat until ``min_seconds`` of measured time or
    ``max_puts``, whichever first (a slow link answers in one put; a fast
    link loops a few times for noise robustness).

    The default mesh is LOCAL devices only: a ``device_put`` onto a
    multi-process mesh is a collective, and a probe fired from one rank
    while its peers sit at an unrelated collective deadlocks the cohort
    until the heartbeat timeout (observed in the distributed ingest
    error-path test). A local probe measures the same link, and engine
    divergence across ranks is safe for every auto consumer (the
    host/device codec forks contain no collectives).
    """
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ibu_jax.parallel.device import AXIS

    if mesh is None:
        mesh = Mesh(np.array(jax.local_devices()), (AXIS,))
    sharding = NamedSharding(mesh, P(AXIS, None))
    s = int(mesh.devices.size)
    rows = max(s, (probe_bytes // 24) // s * s)
    blk = np.zeros((rows, 6), dtype=np.uint32)
    blk[:, 5] = np.arange(rows, dtype=np.uint32)  # non-trivial payload

    warm = np.zeros((s, 6), dtype=np.uint32)
    jax.block_until_ready(jax.device_put(warm, sharding))

    elapsed = 0.0
    done = 0
    for i in range(max_puts):
        blk[0, 0] = i + 1  # distinct per put
        t0 = timer()
        jax.block_until_ready(jax.device_put(blk, sharding))
        elapsed += timer() - t0
        done += 1
        if elapsed >= min_seconds:
            break
    return done * blk.nbytes / max(elapsed, 1e-9) / 1e9


def measure_native_recs_per_s(
    path: str,
    n_records: int,
    probe_records: int = PROBE_RECORDS,
    timer=time.perf_counter,
) -> float | None:
    """Native threaded host engine rate (records/s), timed on a prefix of
    the actual file. ``None`` when the native runtime is unavailable or
    the file is empty (nothing to probe — and nothing to route)."""
    from ibu_jax import native

    if n_records <= 0 or not native.available():
        return None
    k = min(n_records, probe_records)
    native.checksum_parallel(path, min(k, 1024))  # warm: mmap + thread pool
    t0 = timer()
    native.checksum_parallel(path, k)
    dt = timer() - t0
    return k / max(dt, 1e-9)


def host_numpy_recs_per_s() -> float:
    """Conservative a-priori estimate of the single-threaded numpy host
    engine (memory-bound column sums ≈ 1 GB/s ⇒ ~40 Mrec/s). Used only
    when the native runtime is unavailable, as the bar the device feed
    must beat; deliberately pessimistic so a healthy device link always
    wins against it."""
    return 40e6


def probe_rates(path: str, n_records: int, mesh=None) -> dict:
    """Measure (once per process) and memoize the two probe rates."""
    if "device_gbps" not in _MEMO:
        _MEMO["device_gbps"] = measure_device_feed_gbps(mesh=mesh)
    # the native probe is per-file in principle but rate is dominated by
    # the engine, not the file; memoize on first use like the feed probe
    if "native_recs" not in _MEMO:
        rate = measure_native_recs_per_s(path, n_records)
        if rate is not None:
            _MEMO["native_recs"] = rate
        else:
            from ibu_jax import native

            if not native.available():
                # permanently unavailable — cache the verdict
                _MEMO["native_recs"] = None
            # else: this FILE was empty (nothing to probe); don't poison
            # the memo — the next call on a real file probes again
            return {**_MEMO, "native_recs": None}
    return dict(_MEMO)


def reset_probe_memo() -> None:
    """Forget memoized probes (tests; or after the transport changed)."""
    _MEMO.clear()


def choose_stats_engine(
    device_gbps: float,
    native_recs: float | None,
    margin: float = 1.0,
) -> tuple[str, str]:
    """Pure decision: fastest engine for a streaming whole-file pass.

    ``device_gbps`` is the measured feed bandwidth; the device end-to-end
    record rate is ``feed / 24 B`` (engine overhead taken as ≈ 0).
    ``native_recs`` is the measured native engine rate or
    ``None`` when unavailable (the numpy host estimate stands in).
    ``margin`` > 1 biases toward the host side (hysteresis). Returns
    ``(engine, reason)`` with ``engine`` ∈ {"device", "native", "host"}.
    """
    device_recs = device_gbps * 1e9 / 24.0
    host_engine = "native" if native_recs is not None else "host"
    host_recs = native_recs if native_recs is not None else host_numpy_recs_per_s()
    if device_recs >= host_recs * margin:
        return "device", (
            f"device feed {device_gbps:.2f} GB/s "
            f"(~{device_recs / 1e6:.0f} Mrec/s) >= {host_engine} "
            f"~{host_recs / 1e6:.0f} Mrec/s"
        )
    return host_engine, (
        f"device feed {device_gbps:.2f} GB/s "
        f"(~{device_recs / 1e6:.0f} Mrec/s) is below the {host_engine} "
        f"host engine (~{host_recs / 1e6:.0f} Mrec/s) — staying on host"
    )


def auto_stats_engine(
    path: str, n_records: int, mesh=None, announce: bool = True
) -> str:
    """Probe (memoized) + decide + optionally announce on stderr."""
    env = os.environ.get("IBU_AUTO_ENGINE")
    if env:  # operator override: skip probing entirely
        return env
    rates = probe_rates(path, n_records, mesh=mesh)
    engine, reason = choose_stats_engine(
        rates["device_gbps"], rates["native_recs"]
    )
    if announce:
        print(f"engine auto: {reason} -> {engine} "
              "(--engine forces a specific one)", file=sys.stderr)
    return engine


def measure_native_codec_recs(
    length: int = 28, probe_rows: int = 1 << 18, timer=time.perf_counter
) -> float | None:
    """Threaded native host codec rate (records/s): time ``pack_2bit``
    on a synthetic ``(N, L)`` block. ``None`` when native is unavailable
    (the numpy codec stands in at a measured ~6 Mrec/s)."""
    from ibu_jax import native

    if not native.available():
        return None
    rows = np.frombuffer(b"ACGT", dtype=np.uint8)[
        (np.arange(probe_rows)[:, None] + np.arange(length)[None, :]) % 4
    ]
    native.pack_2bit(rows[:1024], validate=False)  # warm threads/pages
    t0 = timer()
    native.pack_2bit(rows, validate=False)
    return probe_rows / max(timer() - t0, 1e-9)


def numpy_codec_recs_per_s() -> float:
    """Pessimistic numpy codec bar (measured ~5-8 Mrec/s at L=16)."""
    return 5e6


#: encode moves ~(L + 8) ASCII/index bytes up and 24 record bytes down
#: per record; decode the reverse. 64 B/record is the round conservative
#: figure for the feed-rate → codec-records conversion.
CODEC_BYTES_PER_RECORD = 64.0


def auto_codec_engine(mesh=None, announce: bool = True) -> str:
    """Device-vs-host decision for the record codec paths (encode/decode
    batches: FASTQ ingest/export, TSV decode).

    Same transport question as stats ("is the link worth crossing?"), but
    the host bar is the THREADED native host codec
    (:func:`measure_native_codec_recs`) and the device side pays
    ~:data:`CODEC_BYTES_PER_RECORD` of link traffic per record. Memoized;
    announced once; ``IBU_AUTO_ENGINE`` overrides (``device`` → device,
    anything else → host).
    """
    env = os.environ.get("IBU_AUTO_ENGINE")
    if env:
        return "device" if env == "device" else "host"
    if "codec_engine" in _MEMO:
        return _MEMO["codec_engine"]
    import jax

    if jax.default_backend() == "cpu":
        # no accelerator: the "device" path is jax-on-host, and the feed
        # probe would measure memcpy-to-self (~GB/s) — a meaningless
        # codec-rate proxy. The native codec beats CPU-lax encode when
        # built; keep the lax path only as the no-native fallback.
        from ibu_jax import native

        engine = "host" if native.available() else "device"
        _MEMO["codec_engine"] = engine
        if announce:
            print(
                f"codec engine auto: cpu backend -> {engine} "
                "(IBU_AUTO_ENGINE overrides)",
                file=sys.stderr,
            )
        return engine
    if "device_gbps" not in _MEMO:
        _MEMO["device_gbps"] = measure_device_feed_gbps(mesh=mesh)
    if "native_codec_recs" not in _MEMO:
        _MEMO["native_codec_recs"] = measure_native_codec_recs()
    device_recs = _MEMO["device_gbps"] * 1e9 / CODEC_BYTES_PER_RECORD
    host_recs = _MEMO["native_codec_recs"]
    host_name = "native codec"
    if host_recs is None:
        host_recs = numpy_codec_recs_per_s()
        host_name = "numpy codec"
    engine = "device" if device_recs >= host_recs else "host"
    _MEMO["codec_engine"] = engine
    if announce:
        print(
            f"codec engine auto: device link ~{device_recs/1e6:.0f} Mrec/s "
            f"vs {host_name} ~{host_recs/1e6:.0f} Mrec/s -> {engine} "
            "(IBU_AUTO_ENGINE overrides)",
            file=sys.stderr,
        )
    return engine


def measure_host_histogram_recs(
    probe_records: int = 1 << 20, timer=time.perf_counter
) -> float:
    """The host histogram engine's actual rate: ``np.unique`` group-sum
    over synthetic u64 barcodes (the engine ``host_stream_histogram``
    really runs — NOT the native checksum, which a histogram cannot
    use; routing the histogram by the checksum's ~900 Mrec/s bar made
    auto pick the ~90 Mrec/s numpy path on healthy links)."""
    vals = (
        np.arange(probe_records, dtype=np.uint64) * np.uint64(2654435761)
    ) % np.uint64(4096)
    np.unique(vals[:4096], return_counts=True)  # warm
    t0 = timer()
    np.unique(vals, return_counts=True)
    return probe_records / max(timer() - t0, 1e-9)


def auto_device_or_host(
    mesh=None, what: str = "histogram", announce: bool = True
) -> str:
    """Binary device-vs-host decision for streaming tools whose host
    side is the numpy pass (histogram): the device feed probe against
    the MEASURED host-histogram rate — the engine that would actually
    run on "host" — collapsed to ``{"device", "host"}``. On a CPU
    backend the "device" is the same host and the feed probe measures
    memcpy-to-self, so the decision is backend-based there (host — the
    numpy merge measured ~100× the virtual-mesh histogram on CPU),
    matching :func:`auto_codec_engine`'s rule."""
    env = os.environ.get("IBU_AUTO_ENGINE")
    if env:
        return "device" if env == "device" else "host"
    import jax

    if jax.default_backend() == "cpu":
        if announce:
            print(f"engine auto ({what}): cpu backend -> host "
                  "(--engine forces a specific one)", file=sys.stderr)
        return "host"
    if "device_gbps" not in _MEMO:
        _MEMO["device_gbps"] = measure_device_feed_gbps(mesh=mesh)
    if "host_hist_recs" not in _MEMO:
        _MEMO["host_hist_recs"] = measure_host_histogram_recs()
    device_recs = _MEMO["device_gbps"] * 1e9 / 24.0
    host_recs = _MEMO["host_hist_recs"]
    engine = "device" if device_recs >= host_recs else "host"
    if announce:
        print(
            f"engine auto ({what}): device feed "
            f"~{device_recs / 1e6:.0f} Mrec/s vs host numpy "
            f"~{host_recs / 1e6:.0f} Mrec/s -> {engine} "
            "(--engine forces a specific one)",
            file=sys.stderr,
        )
    return engine
