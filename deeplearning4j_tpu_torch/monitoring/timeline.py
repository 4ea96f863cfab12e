"""Fleet timeline — ONE wall-clock-aligned chrome-trace across every process
(copy of the JAX package's ``monitoring.timeline``: spools of both packages
merge into one trace).

A request crosses router → replica → executor → decode slot; a training step
crosses supervisor → N ranks. Each of those processes keeps its own
flight-event spool on its own clock basis: events carry ``t =
time.monotonic()`` (system-wide per host boot, but NOT comparable across
hosts or reboots); ``OpProfiler`` op traces (``ops.profiler``, the
``monitoring.trace`` spans) carry microseconds since a private
``perf_counter_ns`` origin. :func:`build_timeline` merges them all into a
single Perfetto-loadable chrome-trace JSON:

- **one pid lane per process identity** (``supervisor``, ``rank0``,
  ``replica1``, …) — restart-stable, so a respawned rank lands back on the
  lane where it crashed;
- **clock-skew correction** — every spool carries monotonic↔wall ``anchors``
  (one pair recorded at open and one per flush). The median of
  ``wall − mono`` over a spool's anchors maps that process's private clock
  onto the shared wall axis; the export's ``ts`` values are microseconds
  from the earliest event (``otherData.origin_wall`` holds the epoch base).
  Medianing the pairs makes one NTP step during the run a non-event;
- **request spans joined by trace id** — every span/route slice carrying a
  ``trace_id`` becomes part of a chrome flow (``ph: s/t/f``), so Perfetto
  draws the arrows router-lane → replica-lane for one request;
- **crashes / respawns / gang resizes as instant events** — supervisor
  decisions are mirrored onto the implicated rank/replica lanes, so the
  lane that died shows WHERE in its own event stream it died.

Open the artifact at https://ui.perfetto.dev (or chrome://tracing): drop the
JSON file in. ``ServingPool.write_timeline()`` exports one for a serving
fleet.
"""

from __future__ import annotations

import zlib
from typing import Dict, Iterable, List, Optional, Sequence

from . import flight
from .aggregate import spool_error_counter
from .registry import MetricsRegistry

#: kept in sync with ops/profiler.py (imported lazily there to keep this
#: module free of the ops package) — a test pins equality
OPTRACE_PREFIX = "tdl_optrace_"

#: flight-event kinds that become duration slices by ending at the event's
#: timestamp with ``dur`` = their ``seconds`` field
_DURATION_KINDS = ("ckpt_save", "ckpt_commit", "ckpt_reshard", "compile",
                   "route")

#: supervisor/router verdicts mirrored onto the implicated worker lanes
_MIRROR_KINDS = ("gang_failure", "restart_decision", "gang_resize",
                 "replica_spawn", "replica_death", "replica_retire")


def _median_offset(anchors: Sequence[dict],
                   events: Sequence[dict] = ()) -> Optional[float]:
    """wall − mono, medianed over the spool's anchor pairs (falling back to
    the events' own (t, wall) pairs for pre-anchor spools). None when the
    spool carries no usable pair at all."""
    diffs = []
    for a in anchors or ():
        if isinstance(a, dict) \
                and isinstance(a.get("mono"), (int, float)) \
                and isinstance(a.get("wall"), (int, float)):
            diffs.append(a["wall"] - a["mono"])
    if not diffs:
        for ev in list(events)[:64]:
            if isinstance(ev.get("t"), (int, float)) \
                    and isinstance(ev.get("wall"), (int, float)):
                diffs.append(ev["wall"] - ev["t"])
    if not diffs:
        return None
    diffs.sort()
    n = len(diffs)
    if n % 2:
        return diffs[n // 2]
    return (diffs[n // 2 - 1] + diffs[n // 2]) / 2.0


def _span_duration(ev: dict) -> float:
    phases = ev.get("phases")
    total = 0.0
    if isinstance(phases, dict):
        total = sum(v for v in phases.values() if isinstance(v, (int, float)))
    return max(total, 1e-6)


def _request_tid(ev: dict) -> int:
    """Concurrent request slices on one lane must not pretend to be one
    nested call stack — spread them across a small stable tid range keyed
    by request id (collisions merely share a row)."""
    rid = str(ev.get("request_id") or ev.get("trace_id") or "")
    return 1 + (zlib.crc32(rid.encode()) % 61)


class _Lanes:
    """Stable proc-name → synthetic chrome pid assignment."""

    def __init__(self):
        self.pids: Dict[str, int] = {}

    def pid(self, proc: str) -> int:
        proc = proc or "unknown"
        if proc not in self.pids:
            self.pids[proc] = len(self.pids) + 1
        return self.pids[proc]


def _flight_trace_events(proc: str, events: Sequence[dict],
                         offset: float, lanes: _Lanes,
                         flows: Dict[str, list]) -> List[dict]:
    """Convert one process's flight events to chrome events on the WALL
    axis (epoch seconds; the caller rebases to the global origin)."""
    out: List[dict] = []
    pid = lanes.pid(proc)
    open_steps: Dict[object, float] = {}
    for ev in events:
        t = ev.get("t")
        if not isinstance(t, (int, float)):
            continue
        wall_t = t + offset
        kind = str(ev.get("kind", "event"))
        args = {k: v for k, v in ev.items()
                if k not in ("t", "wall", "proc", "pid", "seq", "kind")}
        if kind == "request_span":
            dur = _span_duration(ev)
            tid = _request_tid(ev)
            slice_start = wall_t - dur
            out.append({"name": f"request:{ev.get('outcome', '?')}",
                        "cat": "request", "ph": "X", "pid": pid, "tid": tid,
                        "ts": slice_start, "dur": dur, "args": args})
            tr = ev.get("trace_id")
            if tr:
                flows.setdefault(str(tr), []).append(
                    {"pid": pid, "tid": tid, "ts": slice_start})
        elif kind == "route":
            dur = max(float(ev.get("seconds") or 0.0), 1e-6)
            tid = _request_tid(ev)
            slice_start = wall_t - dur
            out.append({"name": "route", "cat": "request", "ph": "X",
                        "pid": pid, "tid": tid, "ts": slice_start,
                        "dur": dur, "args": args})
            tr = ev.get("trace_id")
            if tr:
                flows.setdefault(str(tr), []).append(
                    {"pid": pid, "tid": tid, "ts": slice_start})
        elif kind == "step_begin":
            open_steps[ev.get("iteration")] = wall_t
        elif kind == "step_end":
            begin = open_steps.pop(ev.get("iteration"), None)
            if begin is not None and wall_t >= begin:
                out.append({"name": f"step {ev.get('iteration')}",
                            "cat": "step", "ph": "X", "pid": pid, "tid": 0,
                            "ts": begin, "dur": max(wall_t - begin, 1e-6),
                            "args": args})
            else:  # end without a begin in the ring window
                out.append({"name": kind, "cat": "step", "ph": "i", "s": "t",
                            "pid": pid, "tid": 0, "ts": wall_t, "args": args})
        elif kind in _DURATION_KINDS \
                and isinstance(ev.get("seconds"), (int, float)):
            dur = max(float(ev["seconds"]), 1e-6)
            out.append({"name": kind, "cat": "flight", "ph": "X", "pid": pid,
                        "tid": 0, "ts": wall_t - dur, "dur": dur,
                        "args": args})
        else:
            scope = "p" if kind in _MIRROR_KINDS \
                or kind == "fault_injected" else "t"
            out.append({"name": kind, "cat": "flight", "ph": "i", "s": scope,
                        "pid": pid, "tid": 0, "ts": wall_t, "args": args})
            if kind in _MIRROR_KINDS:
                ranks = ev.get("ranks")
                if not isinstance(ranks, (list, tuple)):
                    ranks = [ev.get("rank")] if ev.get("rank") is not None \
                        else []
                targets = [f"rank{r}" for r in ranks]
                if ev.get("replica") is not None:
                    targets.append(f"replica{ev.get('replica')}")
                for target in targets:
                    if target == proc:
                        continue
                    out.append({"name": kind, "cat": "flight", "ph": "i",
                                "s": "p", "pid": lanes.pid(target), "tid": 0,
                                "ts": wall_t, "args": args})
    # a step_begin whose step_end never came IS the crash signature — keep it
    for iteration, begin in open_steps.items():
        out.append({"name": f"step_begin {iteration} (no end)", "cat": "step",
                    "ph": "i", "s": "t", "pid": pid, "tid": 0, "ts": begin,
                    "args": {"iteration": iteration}})
    return out


def _flow_events(flows: Dict[str, list]) -> List[dict]:
    """Chrome flow s/t/f triples joining every slice that carried one trace
    id — the arrows Perfetto draws router-lane → replica-lane."""
    out: List[dict] = []
    for trace_id, sites in flows.items():
        if len(sites) < 2:
            continue  # a flow with one endpoint renders as a dangling arrow
        sites.sort(key=lambda s: s["ts"])
        for i, site in enumerate(sites):
            ph = "s" if i == 0 else ("f" if i == len(sites) - 1 else "t")
            ev = {"name": "request", "cat": "trace", "ph": ph,
                  "id": trace_id, "pid": site["pid"], "tid": site["tid"],
                  "ts": site["ts"], "args": {"trace_id": trace_id}}
            if ph == "f":
                ev["bp"] = "e"  # bind to the enclosing slice, not the next
            out.append(ev)
    return out


def build_timeline(flight_dirs: Iterable[str] = (),
                   optrace_dirs: Iterable[str] = (),
                   extra_events: Sequence[dict] = (),
                   registry: Optional[MetricsRegistry] = None) -> dict:
    """Merge every per-process spool under ``flight_dirs`` /
    ``optrace_dirs`` (plus ``extra_events`` — e.g. a router's in-memory
    ring) into one chrome-trace dict: ``{"traceEvents": [...],
    "displayTimeUnit": "ms", "otherData": {...}}``.

    Torn/unreadable spools are skipped and counted in
    ``tdl_spool_read_errors_total{reader="timeline"}``. A spool with no
    usable clock anchor falls back to its events' own (t, wall) pairs; one
    with neither is dropped (an unplaceable lane is worse than a missing
    one — it would shear every flow crossing it)."""
    lanes = _Lanes()
    flows: Dict[str, list] = {}
    wall_events: List[dict] = []
    run_ids = set()
    dropped = 0

    groups: Dict[str, List[dict]] = {}
    for ev in extra_events:
        groups.setdefault(str(ev.get("proc", "unknown")), []).append(ev)
    spools: List[dict] = [
        {"proc": proc, "anchors": [], "events": evs}
        for proc, evs in groups.items()]
    for d in flight_dirs:
        spools.extend(flight.read_spools(
            d, on_error=spool_error_counter(
                "timeline", registry, prefix=flight.SPOOL_PREFIX)))

    for spool in spools:
        if not isinstance(spool, dict):
            dropped += 1
            continue
        events = spool.get("events") or []
        offset = _median_offset(spool.get("anchors") or (), events)
        if offset is None:
            dropped += 1
            continue
        if spool.get("run_id"):
            run_ids.add(str(spool["run_id"]))
        proc = str(spool.get("proc", "unknown"))
        wall_events.extend(
            _flight_trace_events(proc, events, offset, lanes, flows))

    for d in optrace_dirs:
        for spool in scan_optrace_dir(d, registry):
            offset = _median_offset(spool.get("anchors") or ())
            if offset is None:
                dropped += 1
                continue
            if spool.get("run_id"):
                run_ids.add(str(spool["run_id"]))
            pid = lanes.pid(str(spool.get("proc", "unknown")))
            for ev in spool.get("events") or []:
                ts = ev.get("ts")
                if not isinstance(ts, (int, float)):
                    continue
                out = dict(ev)
                out["pid"] = pid
                out["ts"] = ts / 1e6 + offset  # µs-since-origin → wall s
                wall_events.append(out)

    wall_events.extend(_flow_events(flows))

    origin = min((ev["ts"] for ev in wall_events), default=0.0)
    trace_events: List[dict] = []
    for proc, pid in sorted(lanes.pids.items(), key=lambda kv: kv[1]):
        trace_events.append({"name": "process_name", "ph": "M", "pid": pid,
                             "tid": 0, "ts": 0, "args": {"name": proc}})
        trace_events.append({"name": "thread_name", "ph": "M", "pid": pid,
                             "tid": 0, "ts": 0, "args": {"name": "events"}})
    for ev in sorted(wall_events, key=lambda e: e["ts"]):
        ev["ts"] = round((ev["ts"] - origin) * 1e6, 3)  # wall s → trace µs
        if "dur" in ev:
            ev["dur"] = round(ev["dur"] * 1e6, 3)
        trace_events.append(ev)

    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": {"origin_wall": origin,
                          "procs": dict(lanes.pids),
                          "run_ids": sorted(run_ids),
                          "spools_dropped": dropped,
                          "flows": len([f for f in flows.values()
                                        if len(f) >= 2])}}


def scan_optrace_dir(directory: str,
                     registry: Optional[MetricsRegistry] = None) -> List[dict]:
    """Every ``OpProfiler`` spool in ``directory`` (torn files skipped and
    counted, reader="timeline")."""
    return flight.scan_spool_json(
        directory, OPTRACE_PREFIX,
        on_error=spool_error_counter("timeline", registry,
                                     prefix=OPTRACE_PREFIX))


def write_timeline(path: str, flight_dirs: Iterable[str] = (),
                   optrace_dirs: Iterable[str] = (),
                   extra_events: Sequence[dict] = (),
                   registry: Optional[MetricsRegistry] = None) -> str:
    """Build and atomically write the merged timeline JSON; returns
    ``path``. The artifact is what Perfetto opens directly."""
    doc = build_timeline(flight_dirs=flight_dirs, optrace_dirs=optrace_dirs,
                         extra_events=extra_events, registry=registry)
    flight.atomic_json_write(path, doc)
    return path
