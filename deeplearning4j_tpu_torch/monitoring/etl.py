"""ETL-service metric families (copy of ``deeplearning4j_tpu/monitoring/etl.py``).

One declaration site, so the multi-process ETL service,
``DevicePrefetchIterator.stats()`` and the tests agree on names and labels.
The families live in the port's process-wide registry by default, so they
reach its ``/metrics`` exposition with no extra wiring.

Families::

    tdl_etl_workers                 ETL worker processes currently attached
    tdl_etl_ring_occupancy          decoded batches sitting ready in the
                                    shared-memory ring (gauge)
    tdl_etl_worker_busy_frac        fraction of worker wall time spent
                                    decoding/augmenting (gauge, 0..1)
    tdl_etl_batches_total           batches published through the ring
    tdl_etl_cache_hits_total        batches served from the persistent
                                    decoded-batch cache (no JPEG decode)
    tdl_etl_cache_misses_total      batches that had to decode from source
    tdl_etl_worker_respawns_total   crashed workers transparently respawned
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

from .registry import MetricsRegistry, get_registry


def etl_metrics(registry: Optional[MetricsRegistry] = None) -> SimpleNamespace:
    """Get-or-create the ETL-service metric families on ``registry``."""
    r = registry if registry is not None else get_registry()
    return SimpleNamespace(
        workers=r.gauge(
            "tdl_etl_workers", "ETL worker processes currently attached"),
        ring_occupancy=r.gauge(
            "tdl_etl_ring_occupancy",
            "decoded batches ready in the shared-memory ring"),
        busy_frac=r.gauge(
            "tdl_etl_worker_busy_frac",
            "fraction of ETL worker wall time spent decoding/augmenting"),
        batches=r.counter(
            "tdl_etl_batches_total", "batches published through the ring"),
        cache_hits=r.counter(
            "tdl_etl_cache_hits_total",
            "batches served from the persistent decoded-batch cache"),
        cache_misses=r.counter(
            "tdl_etl_cache_misses_total",
            "batches that had to decode from source files"),
        respawns=r.counter(
            "tdl_etl_worker_respawns_total",
            "crashed ETL workers transparently respawned"),
    )
