"""Op profiler + Chrome-trace emission (copy of the JAX package's
``ops.profiler``; a spool written by either package reads the same to both
packages' ``monitoring.timeline``).

Reference: nd4j ``org.nd4j.linalg.profiler.OpProfiler`` (+``ProfilerConfig``)
and SameDiff's ``ProfilingListener``, which emits chrome://tracing JSON.
The device-side complement on the card is ``torch.profiler``: a
``monitoring.trace`` span enters a ``record_function`` range of its own
name, so host spans recorded here and a profiler capture line up by name.
This module covers the host-side per-op stats, the trace-event file and
its spool for the fleet timeline, and ``ProfileAnalyzer``'s A/B diff.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")

#: op-trace spool filename prefix — ``monitoring.timeline.build_timeline``
#: scans for it next to the flight spools
SPOOL_PREFIX = "tdl_optrace_"


@dataclass
class ProfilerConfig:
    check_for_nan: bool = False
    check_for_inf: bool = False
    native_statistics: bool = False
    trace_events: bool = False  # collect chrome trace events


@dataclass
class _OpStat:
    count: int = 0
    total_ns: int = 0


class OpProfiler:
    """Per-op-class counters/timings with reset/print, chrome-trace export.

    Event ``ts`` values are microseconds relative to the profiler's own
    ``perf_counter_ns`` origin — a private clock no other process shares.
    ``anchors`` pairs that clock with the wall clock (one pair at open /
    reset and one per spool flush), which is what lets
    ``monitoring.timeline.build_timeline`` place this profiler's ops on the
    fleet-wide wall-aligned axis next to every other process's lane.
    """

    def __init__(self, config: Optional[ProfilerConfig] = None,
                 proc: Optional[str] = None,
                 directory: Optional[str] = None):
        self.config = config or ProfilerConfig()
        self.proc = proc
        self.directory = directory
        self._stats: Dict[str, _OpStat] = defaultdict(_OpStat)
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter_ns()
        self._anchors: List[dict] = [self._anchor()]
        if directory:
            os.makedirs(directory, exist_ok=True)

    def _anchor(self) -> dict:
        """monotonic↔wall pair in the events' own clock (seconds since the
        profiler origin) — call sites hold no lock; appending is done by the
        caller under ``self._lock``."""
        return {"mono": (time.perf_counter_ns() - self._t0) / 1e9,
                "wall": time.time()}  # wallclock-ok: clock-skew anchor for the timeline merge, never a duration

    def record(self, op_name: str, duration_ns: int = 0) -> None:
        with self._lock:
            st = self._stats[op_name]
            st.count += 1
            st.total_ns += duration_ns
            if self.config.trace_events:
                now = time.perf_counter_ns()
                self._events.append(
                    {
                        "name": op_name,
                        "ph": "X",
                        "ts": (now - self._t0 - duration_ns) / 1e3,
                        "dur": max(duration_ns, 1) / 1e3,
                        "pid": 0,
                        "tid": threading.get_ident() % 100000,
                    }
                )

    def timed(self, op_name: str):
        """Context manager recording wall duration of a block."""
        profiler = self

        class _Timer:
            def __enter__(self):
                self.start = time.perf_counter_ns()
                return self

            def __exit__(self, *exc):
                profiler.record(op_name, time.perf_counter_ns() - self.start)

        return _Timer()

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            return {k: {"count": v.count, "total_ns": v.total_ns} for k, v in self._stats.items()}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._events.clear()
            self._t0 = time.perf_counter_ns()
            self._anchors = [self._anchor()]

    def print_stats(self) -> str:
        lines = ["Op profile:"]
        for name, st in sorted(self.stats().items(), key=lambda kv: -kv[1]["total_ns"]):
            lines.append(f"  {name:<30} count={st['count']:<8} total={st['total_ns'] / 1e6:.3f}ms")
        out = "\n".join(lines)
        logger.info("%s", out)
        return out

    def to_chrome_trace(self, path: str) -> None:
        """Write chrome://tracing-compatible JSON (ProfilingListener parity)."""
        with self._lock:
            events = list(self._events)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)

    @property
    def spool_path(self) -> Optional[str]:
        if self.directory is None:
            return None
        from ..monitoring.flight import proc_name
        proc = self.proc or proc_name()
        return os.path.join(self.directory, f"{SPOOL_PREFIX}{proc}.json")

    def flush(self) -> Optional[str]:
        """Spool events + anchors for the fleet-timeline merge (atomic
        tmp+rename, same contract as the flight recorder). No-op without a
        directory; failures are swallowed — profiling must never take the
        workload down."""
        path = self.spool_path
        if path is None:
            return None
        from ..monitoring.flight import atomic_json_write, proc_name, run_id
        with self._lock:
            self._anchors.append(self._anchor())
            payload = {"proc": self.proc or proc_name(), "pid": os.getpid(),
                       "anchors": list(self._anchors),
                       "events": list(self._events)}
        rid = run_id()
        if rid is not None:
            payload["run_id"] = rid
        try:
            atomic_json_write(path, payload)
        except Exception:
            logger.exception("op-trace spool to %s failed (workload continues)",
                             path)
            return None
        return path


class ProfileAnalyzer:
    """Diff two chrome traces (org.nd4j...comparison.ProfileAnalyzer parity)."""

    @staticmethod
    def load(path: str) -> Dict[str, _OpStat]:
        with open(path) as f:
            trace = json.load(f)
        stats: Dict[str, _OpStat] = defaultdict(_OpStat)
        for ev in trace.get("traceEvents", []):
            if ev.get("ph") == "X":
                st = stats[ev["name"]]
                st.count += 1
                st.total_ns += int(ev.get("dur", 0) * 1e3)
        return stats

    @staticmethod
    def compare(path_a: str, path_b: str) -> List[dict]:
        a, b = ProfileAnalyzer.load(path_a), ProfileAnalyzer.load(path_b)
        rows = []
        for name in sorted(set(a) | set(b)):
            rows.append(
                {
                    "op": name,
                    "a_count": a[name].count,
                    "b_count": b[name].count,
                    "a_total_ns": a[name].total_ns,
                    "b_total_ns": b[name].total_ns,
                    "delta_ns": b[name].total_ns - a[name].total_ns,
                }
            )
        return rows
