"""Telemetry of the port (copies of the JAX package's host-side monitoring).

- :mod:`.registry` — labeled counters / gauges / fixed-bucket histograms with
  Prometheus text exposition; the port's process-wide registry is its own;
- :mod:`.aggregate` — per-process metrics spools merged into ONE
  proc/rank-labeled ``/metrics`` with derived straggler gauges;
- :mod:`.flight` — the flight recorder: a bounded ring of structured events
  every process appends to;
- :mod:`.history` — a bounded ring of timestamped registry snapshots and the
  window math (rates, deltas, bucket-interpolated quantiles);
- :mod:`.timeline` — one chrome-trace across every process's spools;
- :mod:`.alerts` — declarative rules evaluated at scrape time, the engine
  under ``serving.PoolAutoscaler``;
- :mod:`.heartbeat` — per-rank/replica heartbeat files and the memory gauges;
- :mod:`.serving` — the serving, decode, client and pool metric families;
- :mod:`.partition` — the sharding, pipeline and elasticity families;
- :mod:`.deploy` — the deploy controller's families and the paired canary
  judgement (``paired_canary_windows``, ``judge_canary_windows``);
- :mod:`.trial` — the trial fleet's families (``tdl_trial_*``,
  ``tdl_fleet_disk_bytes``) and the exclusive trial-state gauge;
- :mod:`.etl` — the multi-process ETL service's families (``tdl_etl_*``);
- :mod:`.trace` — nestable host spans that enter ``torch.profiler``
  ranges of their own names and feed ``OpProfiler`` chrome-trace files;
  the step-phase recorder;
- :mod:`.watchdogs` — the device-memory watermark sampler (the CUDA caching
  allocator; host RSS without CUDA) and the recompile / shape-churn
  detector;
- :mod:`.listener` — ``MetricsListener``, the TrainingListener bridge that
  wires a network's fit loop into the registry;
- :mod:`.costmodel` — per-layer flops attribution joined against the step's
  flops counted under fake tensors, the live device-memory breakdown, the
  pipeline stage partitioner;
- :mod:`.slo` — declarative SLO objectives compiled against the history
  ring: attainment, error-budget remaining and burn rate as ``tdl_slo_*``
  gauges;
- :mod:`.compilecache` — compile-cache hit/miss counters of the kernel
  build, attributed per fn through the watchdogs' thread announcements.

The spools, flight logs and heartbeats read the same to both packages' fleet
tools. Nothing here imports torch at import time (the ETL service's
spawned workers import this package).
"""

from .aggregate import (MetricsSpooler, maybe_spool, merged_prometheus,
                        merged_snapshot)
from .alerts import AlertEngine, AlertRule, default_rules
from .costmodel import (cost_table, layer_costs, live_hbm_breakdown,
                        net_hbm_breakdown, xla_step_cost)
from .deploy import canary_rules, deploy_metrics
from .etl import etl_metrics
from .flight import FlightRecorder, get_flight_recorder, set_flight_recorder
from .heartbeat import HeartbeatWriter, maybe_beat, read_heartbeat
from .history import HistoryRing, HistoryView
from .listener import MetricsListener
from .partition import partition_metrics
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       get_registry)
from .serving import serving_metrics
from .slo import SloObjective, SloTracker, default_objectives
from .trace import (Span, StepPhaseRecorder, current_span_path,
                    set_trace_profiler, span, step_phase_histogram, step_span)
from .trial import TRIAL_STATES, set_trial_state, trial_metrics
from .watchdogs import (DeviceMemoryWatchdog, RecompileWatchdog, active,
                        host_rss_bytes, note_signature, note_step,
                        signature_of)

__all__ = [
    "SloObjective",
    "SloTracker",
    "default_objectives",
    "cost_table",
    "layer_costs",
    "live_hbm_breakdown",
    "net_hbm_breakdown",
    "xla_step_cost",
    "partition_metrics",
    "MetricsListener",
    "merged_snapshot",
    "maybe_beat",
    "Span",
    "StepPhaseRecorder",
    "step_phase_histogram",
    "span",
    "step_span",
    "current_span_path",
    "set_trace_profiler",
    "DeviceMemoryWatchdog",
    "RecompileWatchdog",
    "active",
    "note_signature",
    "note_step",
    "signature_of",
    "etl_metrics",
    "AlertEngine",
    "AlertRule",
    "default_rules",
    "canary_rules",
    "deploy_metrics",
    "HistoryRing",
    "HistoryView",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "serving_metrics",
    "TRIAL_STATES",
    "set_trial_state",
    "trial_metrics",
    "MetricsSpooler",
    "maybe_spool",
    "merged_prometheus",
    "FlightRecorder",
    "get_flight_recorder",
    "set_flight_recorder",
    "HeartbeatWriter",
    "host_rss_bytes",
    "read_heartbeat",
]
