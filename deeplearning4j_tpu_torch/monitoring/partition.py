"""Sharded-parameter training metric families.

Copy of ``deeplearning4j_tpu/monitoring/partition.py`` (without its
pipeline families, which wait for ROADMAP.md item 6c): one declaration site
so ``parallel.partition.Partitioner``, ``serde.checkpoint`` and the tests
agree on names and labels. Families live in the process-wide registry, so
every gang rank's values ride the metrics spool.

Families::

    tdl_param_bytes_per_rank{kind}      bytes this rank holds for
                                        kind="params" / kind="opt_state"
                                        (its blocks: shrinks ~linearly with
                                        the fsdp axis)
    tdl_mesh_layout_info{data,fsdp,tp}  one series describing the active mesh
                                        layout; value = ranks in the mesh
    tdl_reshard_bytes_total             bytes copied into this rank's blocks
                                        by reshard=True restores
    tdl_reshard_seconds                 wall time of one reshard=True restore
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

from .registry import MetricsRegistry, get_registry


def partition_metrics(registry: Optional[MetricsRegistry] = None) -> SimpleNamespace:
    """Get-or-create the partition metric families on ``registry``."""
    r = registry if registry is not None else get_registry()
    return SimpleNamespace(
        param_bytes=r.gauge(
            "tdl_param_bytes_per_rank",
            "bytes of model state this rank holds (addressable shards)",
            labels=("kind",)),
        layout_info=r.gauge(
            "tdl_mesh_layout_info",
            "active data/fsdp/tp mesh layout; value = mesh device count",
            labels=("data", "fsdp", "tp")),
    )


def elastic_metrics(registry: Optional[MetricsRegistry] = None) -> SimpleNamespace:
    """Get-or-create the cross-layout restore families: what a
    ``reshard=True`` restore costs."""
    r = registry if registry is not None else get_registry()
    return SimpleNamespace(
        reshard_bytes=r.counter(
            "tdl_reshard_bytes_total",
            "bytes copied into this process's addressable shards by "
            "cross-topology (reshard=True) checkpoint restores"),
        reshard_seconds=r.histogram(
            "tdl_reshard_seconds",
            "wall seconds of one cross-topology checkpoint restore"),
    )
