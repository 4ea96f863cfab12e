"""Sharded-parameter and pipeline training metric families.

Copy of ``deeplearning4j_tpu/monitoring/partition.py`` (its gang-resize
counter waits for the gang supervisor, ROADMAP.md item 6c.2): one
declaration site so ``parallel.partition.Partitioner``,
``parallel.pipeline``, ``serde.checkpoint`` and the tests agree on names
and labels. Families live in the process-wide registry, so
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

Pipeline-parallel families (the ``pipe`` axis)::

    tdl_pipe_stages                     stages in the active pipeline layout
    tdl_pipe_bubble_fraction{schedule}  measured idle fraction of the
                                        microbatch schedule (analytic bound
                                        is (S-1)/(M+S-1)); declared, not set,
                                        as in the JAX package
    tdl_pipe_stage_seconds{stage}       measured per-stage forward seconds —
                                        compare against the cost-model
                                        prediction to see stage skew
    tdl_pipe_rebalances_total           measured-skew stage re-partitions
                                        (each also records a
                                        ``pipe_rebalance`` flight event)
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


def pipe_metrics(registry: Optional[MetricsRegistry] = None) -> SimpleNamespace:
    """Get-or-create the pipeline-parallel families: stage count, measured
    schedule bubble, per-stage seconds, and the rebalance counter the
    measured-skew loop increments."""
    r = registry if registry is not None else get_registry()
    return SimpleNamespace(
        stages=r.gauge(
            "tdl_pipe_stages",
            "pipeline stages in the active pipe layout"),
        bubble=r.gauge(
            "tdl_pipe_bubble_fraction",
            "measured pipeline bubble (idle) fraction of one step, by "
            "microbatch schedule; the fill-drain analytic bound is "
            "(S-1)/(M+S-1)", labels=("schedule",)),
        stage_seconds=r.gauge(
            "tdl_pipe_stage_seconds",
            "measured per-stage forward wall seconds (stage skew vs the "
            "tdl_layer_cost_info prediction drives rebalancing)",
            labels=("stage",)),
        rebalances=r.counter(
            "tdl_pipe_rebalances_total",
            "cost-model stage re-partitions triggered by measured stage "
            "skew exceeding the rebalance threshold"),
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
