"""Cluster-wide metrics aggregation — one ``/metrics`` for many processes
(copy of the JAX package's ``monitoring.aggregate``; spools written by either
package merge through either one's readers).

Gang ranks, worker pools and serving replicas each hold their own
per-process registry, so a scrape of any one process shows one process's
view. This module closes the gap without adding a network dependency, using
a shared-filesystem contract:

- every participating process periodically snapshots its registry to a
  **spool file** in ``TDL_METRICS_SPOOL_DIR`` (atomic tmp+rename, one file
  per (proc, pid) so a respawned incarnation can never collide with — or
  tear — its predecessor's spool);
- the scrape side (a pool's router, a UI server, a gang supervisor)
  merges every spool **at scrape time** and serves one Prometheus text
  exposition with ``proc`` (and, for gang members, ``rank``) labels stamped
  on every series;
- derived cross-rank gauges ride the merge: ``tdl_step_time_skew_ratio``
  (slowest rank's mean step wall over fastest — the straggler signal),
  ``tdl_step_time_slowest_rank`` and
  per-rank ``tdl_step_time_mean_seconds{rank=...}``, computed from the
  per-rank step-time histograms in the spools.

The spool hook (:func:`maybe_spool`) follows ``heartbeat.maybe_beat``'s
shape exactly: a no-op costing one env lookup unless the env contract is
active, throttled by ``TDL_METRICS_SPOOL_INTERVAL`` seconds, cached writer
rebuilt whenever the contract changes.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import history
from .flight import atomic_json_write, proc_name, proc_rank, scan_spool_json
from .registry import (MetricsRegistry, _escape_help, _escape_label_value,
                       _fmt_value, get_registry)

log = logging.getLogger(__name__)

ENV_DIR = "TDL_METRICS_SPOOL_DIR"
ENV_INTERVAL = "TDL_METRICS_SPOOL_INTERVAL"

#: spool filename prefix (leak-audit fixture + merge both key on it)
SPOOL_PREFIX = "tdl_metrics_"

#: families that exist only at merge time (computed by derive_straggler, no
#: registry declares them). Alert rules may reference these; the alert-rule
#: lint unions them with the registry-declared set.
DERIVED_FAMILIES = ("tdl_step_time_skew_ratio", "tdl_step_time_slowest_rank",
                    "tdl_step_time_mean_seconds")

#: per-rank step-time families the straggler derivation reads, in preference
#: order. ``tdl_step_wall_seconds`` is iteration-to-iteration wall (includes
#: checkpoint IO, input stalls — everything a straggler actually loses time
#: to); the others are narrower fallbacks for processes that predate it.
STEP_TIME_FAMILIES = ("tdl_step_wall_seconds", "tdl_parallel_step_seconds",
                      "tdl_step_duration_seconds")

class MetricsSpooler:
    """Periodically snapshot one registry to a per-process spool file."""

    def __init__(self, directory: str, proc: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 interval: float = 1.0, rank: Optional[int] = None):
        self.directory = directory
        self.proc = proc or proc_name()
        self.rank = rank if rank is not None else proc_rank()
        self.registry = registry if registry is not None else get_registry()
        self.interval = max(0.0, float(interval))
        # pid in the filename: a child process (multiprocessing spawn, a
        # respawned gang incarnation) structurally cannot collide with its
        # parent's spool even when both share proc identity and directory
        self.path = os.path.join(
            directory, f"{SPOOL_PREFIX}{self.proc}.{os.getpid()}.json")
        self._last_spool: Optional[float] = None
        self._write_failed = False
        os.makedirs(directory, exist_ok=True)

    def spool(self, force: bool = False) -> Optional[str]:
        """Write a snapshot unless throttled; returns the path on a write.
        A failing write (disk full, dir removed) is logged and swallowed —
        this runs on train-step / inference-thread hot paths, and losing a
        metrics snapshot must never take the workload down with it."""
        now = time.perf_counter()
        if (not force and self._last_spool is not None
                and now - self._last_spool < self.interval):
            return None
        payload = {
            "proc": self.proc, "rank": self.rank, "pid": os.getpid(),
            "wall": time.time(),  # wallclock-ok: newest-spool tiebreak across processes, not a duration
            "snapshot": self.registry.snapshot(),
        }
        try:
            atomic_json_write(self.path, payload)
        except Exception:
            if not self._write_failed:  # once, not per step
                log.exception("metrics spool write to %s failed; metrics "
                              "aggregation degraded (workload continues)",
                              self.path)
                self._write_failed = True
            return None
        self._write_failed = False
        self._last_spool = time.perf_counter()
        return self.path


_spooler: Optional[object] = None
_spooler_key: Optional[tuple] = None
_SPOOLER_DISABLED = object()  # creation failed for this key: stop retrying


def maybe_spool(force: bool = False) -> None:
    """Library hook: spool the process registry iff ``TDL_METRICS_SPOOL_DIR``
    is set (one env dict lookup when inactive). Wired into the serving
    executors' batch cycle, the process kind of the port that the
    aggregated ``/metrics`` covers."""
    global _spooler, _spooler_key
    # the history ring rides the same hook sites on its OWN env contract: one env lookup when
    # TDL_HISTORY_DIR is unset, independent of the metrics-spool contract
    history.maybe_sample(force=force)
    directory = os.environ.get(ENV_DIR)
    if not directory:
        return
    key = (directory, os.environ.get("TDL_PROCESS_ID"),
           float(os.environ.get(ENV_INTERVAL, "1.0")))
    if _spooler is None or key != _spooler_key:
        try:
            _spooler = MetricsSpooler(directory, interval=key[2])
        except OSError:  # unwritable spool dir: degrade, don't kill the step
            log.exception("cannot create metrics spooler in %s", directory)
            _spooler = _SPOOLER_DISABLED
        _spooler_key = key
    if _spooler is not _SPOOLER_DISABLED:
        _spooler.spool(force=force)


# -- merge -------------------------------------------------------------------


def spool_read_errors(registry: Optional[MetricsRegistry] = None):
    """Get-or-create the spool-degradation counter (one declaration site):
    spool files a reader had to skip, labeled by which reader
    (``metrics``/``history``/``flight``/``timeline``) and the proc identity
    in the filename (``unknown`` when the name itself is mangled)."""
    r = registry if registry is not None else get_registry()
    return r.counter(
        "tdl_spool_read_errors_total",
        "spool files skipped by a reader "
        "(unreadable, torn, or not a JSON object)",
        labels=("reader", "proc"))


def _spool_proc_from_filename(name: str, prefix: str = None) -> str:
    # tdl_metrics_<proc>.<pid>.json — proc may itself contain dots, so strip
    # the two KNOWN trailing components, not the first dot. Flight/op-trace
    # spools have no pid component: tdl_flight_<proc>.json.
    stem = name[len(prefix if prefix is not None else SPOOL_PREFIX):]
    parts = stem.rsplit(".", 2)
    if len(parts) == 3 and parts[0]:
        return parts[0]
    if len(parts) == 2 and parts[1] == "json" and parts[0]:
        return parts[0]
    return "unknown"


def spool_error_counter(reader: str,
                        registry: Optional[MetricsRegistry] = None,
                        prefix: str = None):
    """An ``on_error`` callback for :func:`flight.scan_spool_json` call
    sites: bumps ``tdl_spool_read_errors_total{reader, proc}`` per skipped
    file. Every reader of a spool directory passes one of these instead of
    silently dropping torn spools."""
    errors = spool_read_errors(registry)

    def note_error(name: str) -> None:
        errors.labels(reader, _spool_proc_from_filename(name, prefix)).inc()

    return note_error


def read_spools(directory: str,
                registry: Optional[MetricsRegistry] = None) -> List[dict]:
    """Parse every spool in ``directory``, keeping only the NEWEST file per
    proc identity (a restarted incarnation leaves its predecessor's spool
    behind; double-counting both would inflate every counter). The dedup
    needs a restart-stable proc identity — ``rank{N}`` or an explicit
    ``TDL_PROC_NAME``; fallback ``pid{N}`` identities change on restart, so
    such spools accumulate until the directory is rotated.

    Unreadable / torn / non-object spool files are SKIPPED and counted in
    ``tdl_spool_read_errors_total{reader="metrics", proc}`` on ``registry``
    (default: the process registry) — one corrupt file degrades one proc's
    view, never the whole merged scrape, and the degradation counter lands
    on the SAME registry the caller's scrape serves."""
    errors = spool_read_errors(registry)
    note_error = spool_error_counter("metrics", registry)

    newest: Dict[str, dict] = {}
    for payload in scan_spool_json(directory, SPOOL_PREFIX,
                                   on_error=note_error):
        if not isinstance(payload, dict) \
                or not isinstance(payload.get("snapshot", {}), dict):
            # parsed but wrong shape: same degradation bucket
            proc = (str(payload.get("proc") or "unknown")
                    if isinstance(payload, dict) else "unknown")
            errors.labels("metrics", proc).inc()
            continue
        proc = str(payload.get("proc", ""))
        if (proc not in newest
                or payload.get("wall", 0) >= newest[proc].get("wall", 0)):
            newest[proc] = payload
    return [newest[p] for p in sorted(newest)]


def _fmt_label_str(pairs: Sequence[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(str(v))}"' for k, v in pairs)
    return "{" + body + "}"


def _series_lines(name: str, fam: dict, series: dict,
                  extra: Sequence[Tuple[str, str]]) -> List[str]:
    """Prometheus lines for ONE series of a snapshotted family, with the
    merge's proc/rank labels appended."""
    base = list(series.get("labels", {}).items()) + list(extra)
    kind = fam.get("type")
    if kind in ("counter", "gauge"):
        return [f"{name}{_fmt_label_str(base)} {_fmt_value(series['value'])}"]
    if kind == "histogram":
        lines = []
        buckets = sorted(((float(ub), c) for ub, c in
                          (series.get("buckets") or {}).items()),
                         key=lambda t: t[0])
        cumulative = 0
        for ub, c in buckets:
            cumulative += int(c)
            lines.append(f"{name}_bucket"
                         f"{_fmt_label_str(base + [('le', _fmt_value(ub))])}"
                         f" {cumulative}")
        cumulative += int(series.get("inf", 0))
        lines.append(f"{name}_bucket{_fmt_label_str(base + [('le', '+Inf')])}"
                     f" {cumulative}")
        lines.append(f"{name}_sum{_fmt_label_str(base)} "
                     f"{_fmt_value(series.get('sum', 0.0))}")
        lines.append(f"{name}_count{_fmt_label_str(base)} {cumulative}")
        return lines
    return []


def merged_prometheus(directory: str,
                      local_registry: Optional[MetricsRegistry] = None,
                      local_proc: str = "local", derive: bool = True) -> str:
    """ONE text exposition over every process's spool (plus, optionally, the
    scraping process's own live registry), ``proc``/``rank`` labels on every
    series, derived straggler gauges appended."""
    spools = read_spools(directory, registry=local_registry)
    entries: List[Tuple[str, Optional[int], dict]] = [
        (str(s.get("proc")), s.get("rank"), s.get("snapshot") or {})
        for s in spools]
    if local_registry is not None:
        entries.append((local_proc, None, local_registry.snapshot()))
    names = sorted({n for _, _, snap in entries for n in snap})
    lines: List[str] = []
    for name in names:
        fam = next(snap[name] for _, _, snap in entries if name in snap)
        if fam.get("help"):
            lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {name} {fam.get('type', 'untyped')}")
        for proc, rank, snap in entries:
            if name not in snap:
                continue
            extra = [("proc", proc)]
            if rank is not None:
                extra.append(("rank", str(rank)))
            for series in snap[name].get("series", []):
                lines.extend(_series_lines(name, snap[name], series, extra))
    if derive:
        lines.extend(_derived_lines(derive_straggler(spools)))
    return "\n".join(lines) + ("\n" if lines else "")


# -- derived straggler gauges -------------------------------------------------


def _mean_step_seconds(snapshot: dict) -> Optional[float]:
    """Mean seconds/step from the first step-time histogram family present
    with observations, summed across its label children."""
    for fam_name in STEP_TIME_FAMILIES:
        fam = snapshot.get(fam_name)
        if not fam or fam.get("type") != "histogram":
            continue
        count = sum(s.get("count", 0) for s in fam.get("series", []))
        total = sum(s.get("sum", 0.0) for s in fam.get("series", []))
        if count > 0:
            return total / count
    return None


def derive_straggler(spools: List[dict]) -> Optional[dict]:
    """Cross-rank step-time skew from per-rank spools: ``skew_ratio`` =
    slowest mean step wall / fastest, ``slowest_rank`` its rank id, plus the
    per-rank means. None with fewer than two ranks reporting step times."""
    per_rank: Dict[int, float] = {}
    for spool in spools:
        rank = spool.get("rank")
        if rank is None:
            continue
        mean = _mean_step_seconds(spool.get("snapshot") or {})
        if mean is not None:
            per_rank[int(rank)] = mean
    if len(per_rank) < 2:
        return None
    fastest = min(per_rank.values())
    slowest_rank = max(per_rank, key=lambda r: per_rank[r])
    return {
        "skew_ratio": (per_rank[slowest_rank] / fastest if fastest > 0
                       else float("inf")),
        "slowest_rank": slowest_rank,
        "mean_step_seconds": per_rank,
    }


def _derived_lines(derived: Optional[dict]) -> List[str]:
    if not derived:
        return []
    lines = [
        "# HELP tdl_step_time_skew_ratio Slowest rank's mean step wall over "
        "the fastest rank's (1.0 = perfectly balanced gang)",
        "# TYPE tdl_step_time_skew_ratio gauge",
        f"tdl_step_time_skew_ratio {_fmt_value(derived['skew_ratio'])}",
        "# HELP tdl_step_time_slowest_rank Rank id with the largest mean "
        "step wall (the straggler)",
        "# TYPE tdl_step_time_slowest_rank gauge",
        f"tdl_step_time_slowest_rank {derived['slowest_rank']}",
        "# HELP tdl_step_time_mean_seconds Per-rank mean seconds per step "
        "(derived from per-rank step-time histograms at merge time)",
        "# TYPE tdl_step_time_mean_seconds gauge",
    ]
    for rank in sorted(derived["mean_step_seconds"]):
        lines.append(f'tdl_step_time_mean_seconds{{rank="{rank}"}} '
                     f"{_fmt_value(derived['mean_step_seconds'][rank])}")
    return lines


def merged_snapshot(directory: str,
                    local_registry: Optional[MetricsRegistry] = None) -> dict:
    """JSON twin of :func:`merged_prometheus` (``/metrics.json`` with a spool
    dir attached): per-proc snapshots keyed by proc, plus the derived
    straggler block."""
    spools = read_spools(directory, registry=local_registry)
    out = {
        "procs": {str(s.get("proc")): {"rank": s.get("rank"),
                                       "pid": s.get("pid"),
                                       "wall": s.get("wall"),
                                       "snapshot": s.get("snapshot") or {}}
                  for s in spools},
        "derived": derive_straggler(spools),
    }
    if local_registry is not None:
        out["local"] = local_registry.snapshot()
    return out
