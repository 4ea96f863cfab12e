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
- :mod:`.etl` — the multi-process ETL service's families (``tdl_etl_*``).

The spools, flight logs and heartbeats read the same to both packages' fleet
tools. The JAX package's ``costmodel``, ``trace``, ``watchdogs``, ``slo``
and the rest are not ported yet (ROADMAP item 8).
"""

from .aggregate import MetricsSpooler, maybe_spool, merged_prometheus
from .alerts import AlertEngine, AlertRule, default_rules
from .deploy import canary_rules, deploy_metrics
from .etl import etl_metrics
from .flight import FlightRecorder, get_flight_recorder, set_flight_recorder
from .heartbeat import HeartbeatWriter, host_rss_bytes, read_heartbeat
from .history import HistoryRing, HistoryView
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       get_registry)
from .serving import serving_metrics
from .trial import TRIAL_STATES, set_trial_state, trial_metrics

__all__ = [
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
