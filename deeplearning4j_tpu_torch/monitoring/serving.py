"""Serving metric families (copy of the JAX package's ``monitoring.serving``:
the same names, labels and buckets, so dashboards and the fleet tools read
either package's servers alike).

One declaration site so the executor, the HTTP server, the pool and the
tests agree on names, labels, and buckets. All families live in the
process-wide registry by default.

Families::

    tdl_inference_requests_total{code}      HTTP responses by status code
    tdl_inference_shed_total{reason}        requests refused/abandoned before
                                            the model ran (queue_full,
                                            queue_expired, deadline, shutdown)
    tdl_inference_queue_depth               admission queue depth (gauge)
    tdl_inference_queue_wait_seconds        time from admission to batching
    tdl_inference_latency_seconds           end-to-end request latency
    tdl_inference_batch_size                coalesced rows per executor cycle

Client-side families (SLO math grounded where users live, not only at the
server)::

    tdl_client_request_seconds{outcome}     client-observed request wall time
                                            (retries included), by outcome
    tdl_client_retries_total{reason}        retry attempts by trigger

Continuous-batching decode families (the generative executor's per-step
truth)::

    tdl_decode_slot_occupancy               live sequences in the slot pool
                                            at the last decode step (gauge)
    tdl_decode_steps_total                  decode steps executed
    tdl_decode_tokens_total                 tokens emitted across sequences
    tdl_decode_admitted_total               sequences admitted into a slot
    tdl_decode_evicted_total{reason}        sequences evicted mid-decode
                                            (deadline, shutdown)

Paged-decode families (block-paged KV arena, CoW prefix sharing and
speculative decoding; all zero/absent when a dense slot pool serves)::

    tdl_decode_blocks_total                 usable KV arena blocks (gauge;
                                            trash block excluded)
    tdl_decode_blocks_free                  blocks free for admission (gauge;
                                            CoW reserves held back)
    tdl_decode_cow_shared_blocks            blocks referenced by >1 sequence
                                            via prefix sharing (gauge)
    tdl_decode_spec_proposed_total          draft-model tokens proposed
    tdl_decode_spec_accepted_total          proposed tokens accepted by the
                                            target verify forward (the ratio
                                            is the acceptance rate)

Replica-pool families (the ServingPool supervisor's view; the per-replica
serving families above arrive with ``proc=replica{N}`` labels through the
spool merge)::

    tdl_pool_size                           live replica processes (gauge)
    tdl_pool_replica_state{replica,state}   1 for the replica's current
                                            state (starting/ready/unready/
                                            draining/dead), 0 otherwise
    tdl_pool_scale_events_total{direction}  autoscaler/manual resizes (up,
                                            down)
    tdl_pool_swap_events_total              completed zero-downtime model
                                            swaps
    tdl_pool_swap_rollbacks_total           swaps aborted because the new
                                            model failed validation (the old
                                            version kept serving)
    tdl_pool_swap_rejected_total            swaps refused at PRE-FLIGHT
                                            : the checkpoint failed
                                            lineage verification before any
                                            surge replica was spawned
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

from .registry import MetricsRegistry, get_registry

#: row-count buckets for the micro-batch size histogram — powers of two to
#: mirror ParallelInference's bucketed padding
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def serving_metrics(registry: Optional[MetricsRegistry] = None) -> SimpleNamespace:
    """Get-or-create the serving metric families on ``registry``."""
    r = registry if registry is not None else get_registry()
    return SimpleNamespace(
        requests=r.counter(
            "tdl_inference_requests_total",
            "inference HTTP responses by status code", labels=("code",)),
        shed=r.counter(
            "tdl_inference_shed_total",
            "requests shed before the model ran", labels=("reason",)),
        queue_depth=r.gauge(
            "tdl_inference_queue_depth", "inference admission queue depth"),
        queue_wait=r.histogram(
            "tdl_inference_queue_wait_seconds",
            "seconds a request waited in the admission queue"),
        latency=r.histogram(
            "tdl_inference_latency_seconds",
            "end-to-end request latency, admission to response"),
        batch_size=r.histogram(
            "tdl_inference_batch_size",
            "rows coalesced into one inference cycle",
            buckets=BATCH_SIZE_BUCKETS),
    )


def decode_metrics(registry: Optional[MetricsRegistry] = None) -> SimpleNamespace:
    """Get-or-create the continuous-batching decode families.

    Slot occupancy is the batching-efficiency headline: mean occupancy near
    the pool size means the decode executable runs full; near 1 means the
    pool is serving sequentially and static batching would do as well."""
    r = registry if registry is not None else get_registry()
    return SimpleNamespace(
        slot_occupancy=r.gauge(
            "tdl_decode_slot_occupancy",
            "live sequences in the decode slot pool at the last step"),
        steps=r.counter(
            "tdl_decode_steps_total", "autoregressive decode steps executed"),
        tokens=r.counter(
            "tdl_decode_tokens_total",
            "tokens emitted across all generated sequences"),
        admitted=r.counter(
            "tdl_decode_admitted_total",
            "sequences admitted into a decode slot (prefilled)"),
        evicted=r.counter(
            "tdl_decode_evicted_total",
            "sequences evicted mid-decode before finishing",
            labels=("reason",)),
        blocks_total=r.gauge(
            "tdl_decode_blocks_total",
            "usable KV blocks in the paged decode arena (trash excluded)"),
        blocks_free=r.gauge(
            "tdl_decode_blocks_free",
            "paged KV blocks free for new admissions (CoW reserves held "
            "back)"),
        cow_shared=r.gauge(
            "tdl_decode_cow_shared_blocks",
            "paged KV blocks shared by more than one sequence via "
            "copy-on-write prefix sharing"),
        spec_proposed=r.counter(
            "tdl_decode_spec_proposed_total",
            "draft-model tokens proposed for speculative verification"),
        spec_accepted=r.counter(
            "tdl_decode_spec_accepted_total",
            "speculatively proposed tokens accepted by the target model"),
    )


def pool_metrics(registry: Optional[MetricsRegistry] = None) -> SimpleNamespace:
    """Get-or-create the replica-pool families. The pool
    supervisor owns these; per-replica serving metrics ride the spool merge
    with ``proc=replica{N}`` labels instead."""
    r = registry if registry is not None else get_registry()
    return SimpleNamespace(
        size=r.gauge("tdl_pool_size", "live serving replica processes"),
        replica_state=r.gauge(
            "tdl_pool_replica_state",
            "1 for the replica's current state, 0 for its other states "
            "(starting/ready/unready/draining/dead)",
            labels=("replica", "state")),
        scale_events=r.counter(
            "tdl_pool_scale_events_total",
            "replica-pool resizes by direction (autoscaler or manual)",
            labels=("direction",)),
        swap_events=r.counter(
            "tdl_pool_swap_events_total",
            "zero-downtime model swaps completed (every replica rolled to "
            "the new checkpoint)"),
        swap_rollbacks=r.counter(
            "tdl_pool_swap_rollbacks_total",
            "model swaps rolled back because the new model failed to become "
            "ready (the old version kept serving)"),
        swap_rejected=r.counter(
            "tdl_pool_swap_rejected_total",
            "model swaps refused at pre-flight checkpoint verification — "
            "no surge replica was spawned, the old fleet never noticed"),
    )


def client_metrics(registry: Optional[MetricsRegistry] = None) -> SimpleNamespace:
    """Get-or-create the CLIENT-side metric families on ``registry``.

    Outcomes: ``ok``, ``bad_request`` (4xx, never retried), ``shed``
    (429/503 after retries), ``deadline`` (504), ``server_error`` (other
    5xx), ``connection``, ``breaker_open``. The latency histogram measures
    what the caller experienced — the whole ``predict()`` including
    backoff — which is the number client-grounded SLOs must judge."""
    r = registry if registry is not None else get_registry()
    return SimpleNamespace(
        request_seconds=r.histogram(
            "tdl_client_request_seconds",
            "client-observed request wall seconds (retries and backoff "
            "included), by outcome", labels=("outcome",)),
        retries=r.counter(
            "tdl_client_retries_total",
            "client retry attempts by trigger", labels=("reason",)),
    )
