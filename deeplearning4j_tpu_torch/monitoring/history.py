"""Metrics history ring — the time dimension of the observability plane
(copy of the JAX package's ``monitoring.history``).

The registry is a point-in-time snapshot, so a rule that judges one
snapshot cannot express "p99 over the last 60 seconds" or "error-budget burn
rate", the only forms an autoscaler can act on without flapping.

This module is the shared windowed view every time-aware consumer reads:

- a :class:`HistoryRing` keeps a bounded in-memory ring of timestamped
  registry snapshots (``t`` = ``time.monotonic()`` — system-wide per host,
  the same ordering contract as the flight recorder), optionally spooled to
  ``TDL_HISTORY_DIR/tdl_history_<proc>.<pid>.json`` with the atomic
  tmp+rename convention every other spool uses;
- the read side merges per-proc ring spools at read time (newest file per
  proc, exactly like ``aggregate.read_spools``) plus the local ring into
  one time-ordered sample list;
- window math lives here once: per-series point extraction
  (:func:`window_points`), counter increase/rate (:func:`counter_increase`),
  histogram window deltas (:func:`histogram_delta`) and bucket-interpolated
  quantiles (:func:`quantile_from_buckets`) — the windowed alert rules,
  ``serving.loadgen`` and the pool's autoscaler all consume these helpers,
  so "p99 over the window" means the same thing everywhere.

The sampling hook (:func:`maybe_sample`) follows ``aggregate.maybe_spool``'s
shape and is driven from the same call sites (it is invoked BY
``maybe_spool``): one env lookup when inactive, throttled by
``TDL_HISTORY_INTERVAL`` seconds.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from .flight import atomic_json_write, proc_name, proc_rank, scan_spool_json
from .registry import MetricsRegistry, get_registry

log = logging.getLogger(__name__)

ENV_DIR = "TDL_HISTORY_DIR"
ENV_INTERVAL = "TDL_HISTORY_INTERVAL"
ENV_CAPACITY = "TDL_HISTORY_CAPACITY"

#: spool filename prefix (leak-audit fixture + read-side merge key on it)
SPOOL_PREFIX = "tdl_history_"

#: ring capacity: at the default 2s interval this holds ~12 minutes of
#: history — enough for every stock window (60s p99, fast/slow burn pairs)
#: with room for dashboards to look back past an incident's onset
DEFAULT_CAPACITY = 360
DEFAULT_INTERVAL = 2.0
#: disk-spool throttle (seconds): each flush rewrites the whole ring, so it
#: runs an order of magnitude less often than in-memory sampling
DEFAULT_SPOOL_INTERVAL = 15.0


class HistoryRing:
    """Bounded ring of timestamped snapshots of ONE registry.

    ``sample()`` is throttled by ``interval`` (0 = every call) and appends
    ``{"t", "wall", "snapshot"}``; with a ``directory`` the whole ring is
    spooled (bounded by ``capacity``, so the file size is too). Thread-safe:
    scrape handlers and the owning process's hot-path hook may race.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 capacity: int = DEFAULT_CAPACITY,
                 interval: float = DEFAULT_INTERVAL,
                 proc: Optional[str] = None, rank: Optional[int] = None,
                 directory: Optional[str] = None,
                 spool_interval: float = DEFAULT_SPOOL_INTERVAL):
        self.registry = registry if registry is not None else get_registry()
        self.capacity = max(2, int(capacity))
        self.interval = max(0.0, float(interval))
        self.proc = proc or proc_name()
        self.rank = rank if rank is not None else proc_rank()
        self.directory = directory
        #: disk writes rewrite the WHOLE ring (up to capacity snapshots), so
        #: they are throttled separately from in-memory sampling — a full
        #: 360-snapshot ring serialized every 2s on the step path would cost
        #: real step time; cross-proc readers tolerate a few seconds of lag
        self.spool_interval = max(0.0, float(spool_interval))
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._last_sample: Optional[float] = None
        self._last_flush: Optional[float] = None
        self._write_failed = False
        if directory:
            os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> Optional[str]:
        if self.directory is None:
            return None
        return os.path.join(
            self.directory,
            f"{SPOOL_PREFIX}{self.proc}.{os.getpid()}.json")

    def sample(self, force: bool = False) -> Optional[dict]:
        """Append one timestamped snapshot unless throttled; returns the
        sample on an append. Spools the ring when a directory is set, on
        the separate ``spool_interval`` throttle (``force=True`` bypasses
        both throttles); same swallow-and-log durability contract as the
        metrics spooler — history must never take the workload down."""
        now = time.monotonic()
        with self._lock:
            if (not force and self._last_sample is not None
                    and now - self._last_sample < self.interval):
                return None
            self._last_sample = now
        entry = {"t": now,
                 "wall": time.time(),  # wallclock-ok: human display timestamp on history samples, never compared as a duration
                 "snapshot": self.registry.snapshot()}
        with self._lock:
            self._ring.append(entry)
        if self.directory is not None and (
                force or self._last_flush is None
                or now - self._last_flush >= self.spool_interval):
            self.flush()
        return entry

    def samples(self, window: Optional[float] = None,
                now: Optional[float] = None) -> List[dict]:
        """This ring's samples (oldest first), proc/rank-stamped, optionally
        restricted to the trailing ``window`` seconds."""
        with self._lock:
            entries = list(self._ring)
        if window is not None:
            cutoff = (now if now is not None else time.monotonic()) - window
            entries = [e for e in entries if e["t"] >= cutoff]
        return [{"t": e["t"], "wall": e["wall"], "proc": self.proc,
                 "rank": self.rank, "snapshot": e["snapshot"]}
                for e in entries]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def flush(self) -> Optional[str]:
        path = self.path
        if path is None:
            return None
        with self._lock:
            payload = {"proc": self.proc, "rank": self.rank,
                       "pid": os.getpid(), "capacity": self.capacity,
                       "wall": time.time(),  # wallclock-ok: newest-ring tiebreak across processes, not a duration
                       "samples": list(self._ring)}
        try:
            atomic_json_write(path, payload)
        except Exception:
            if not self._write_failed:  # once, not per sample
                log.exception("history spool to %s failed; windowed views "
                              "degraded (workload continues)", path)
                self._write_failed = True
            # stamp anyway: a broken disk must not defeat the throttle
            self._last_flush = time.monotonic()
            return None
        self._write_failed = False
        self._last_flush = time.monotonic()
        return path


# -- process-wide ring (env contract, mirrors aggregate.maybe_spool) ---------

_ring: Optional[object] = None
_ring_key: Optional[tuple] = None
_RING_DISABLED = object()


def maybe_sample(force: bool = False) -> None:
    """Library hook: sample the process registry into a spooled history ring
    iff ``TDL_HISTORY_DIR`` is set. Called by ``aggregate.maybe_spool`` so
    every process kind that spools metrics also accrues history with zero
    extra wiring."""
    global _ring, _ring_key
    directory = os.environ.get(ENV_DIR)
    if not directory:
        return
    key = (directory, os.environ.get("TDL_PROCESS_ID"),
           float(os.environ.get(ENV_INTERVAL, str(DEFAULT_INTERVAL))),
           int(os.environ.get(ENV_CAPACITY, str(DEFAULT_CAPACITY))))
    if _ring is None or key != _ring_key:
        try:
            _ring = HistoryRing(directory=directory, interval=key[2],
                                capacity=key[3])
        except OSError:  # unwritable history dir: degrade, don't kill the step
            log.exception("cannot create history ring in %s", directory)
            _ring = _RING_DISABLED
        _ring_key = key
    if _ring is not _RING_DISABLED:
        _ring.sample(force=force)


# -- read side ----------------------------------------------------------------


def read_rings(directory: str) -> List[dict]:
    """Every history-ring spool in ``directory``, newest file per proc
    identity (a respawned incarnation's predecessor must not double-count —
    same dedup rule as ``aggregate.read_spools``). Unreadable / torn /
    non-dict payloads are skipped and counted in
    ``tdl_spool_read_errors_total{reader="history"}``."""
    from .aggregate import spool_error_counter
    note_error = spool_error_counter("history", prefix=SPOOL_PREFIX)
    newest: Dict[str, dict] = {}
    for payload in scan_spool_json(directory, SPOOL_PREFIX,
                                   on_error=note_error):
        if not isinstance(payload, dict):
            continue
        proc = str(payload.get("proc", ""))
        if (proc not in newest
                or payload.get("wall", 0) >= newest[proc].get("wall", 0)):
            newest[proc] = payload
    return [newest[p] for p in sorted(newest)]


def merged_samples(directory: Optional[str] = None,
                   ring: Optional[HistoryRing] = None,
                   window: Optional[float] = None,
                   now: Optional[float] = None) -> List[dict]:
    """ONE time-ordered sample list across every proc's spooled ring plus
    the local ring. The local ring wins over its own spool (same proc name
    would double-count). Monotonic ``t`` is system-wide per host, so the
    merge needs no clock agreement."""
    out: List[dict] = []
    local_proc = ring.proc if ring is not None else None
    if directory:
        for payload in read_rings(directory):
            proc = str(payload.get("proc", ""))
            if proc == local_proc:
                continue
            rank = payload.get("rank")
            for s in payload.get("samples") or []:
                if isinstance(s, dict) and "t" in s:
                    out.append({"t": s["t"], "wall": s.get("wall"),
                                "proc": proc, "rank": rank,
                                "snapshot": s.get("snapshot") or {}})
    if ring is not None:
        out.extend(ring.samples())
    if window is not None:
        cutoff = (now if now is not None else time.monotonic()) - window
        out = [s for s in out if s["t"] >= cutoff]
    return sorted(out, key=lambda s: (s["t"], str(s.get("proc", ""))))


class HistoryView:
    """Read-side handle bundling a local ring and/or a spool directory —
    what ``AlertEngine(history_view=...)`` / ``SloTracker(history_view=...)``
    consume, so every windowed reader sees the same sample stream."""

    def __init__(self, ring: Optional[HistoryRing] = None,
                 directory: Optional[str] = None):
        self.ring = ring
        self.directory = directory

    def samples(self, window: Optional[float] = None,
                now: Optional[float] = None) -> List[dict]:
        return merged_samples(self.directory, self.ring, window=window,
                              now=now)


# -- window math --------------------------------------------------------------


def labels_match(series_labels: dict, want: Optional[dict]) -> bool:
    """Subset match: every wanted (name, value) pair present and equal."""
    if not want:
        return True
    return all(series_labels.get(k) == v for k, v in want.items())


def window_points(samples: Sequence[dict], family: str,
                  labels: Optional[dict] = None,
                  window: Optional[float] = None,
                  now: Optional[float] = None,
                  baseline: bool = False) -> Dict[tuple, List[Tuple[float, dict]]]:
    """Per-(proc, labelset) time-ordered points of one family.

    Returns ``{(proc, labels_key): [(t, series_dict), ...]}`` with points
    inside the trailing ``window``. With ``baseline=True`` every series
    gets a delta baseline as its first point: the nearest sample BEFORE
    the window when one exists (a counter increase over "the last 60s"
    needs the value at the window's left edge), else a synthetic ZERO at
    the earliest in-window sample time — a series born mid-window counts
    from zero instead of being dropped (its events DID happen inside the
    window; without this, the first minute of traffic after a family's
    first observation would be invisible to every windowed rule).
    """
    cutoff = None
    if window is not None:
        cutoff = (now if now is not None else time.monotonic()) - window
    in_window: Dict[tuple, List[Tuple[float, dict]]] = {}
    before: Dict[tuple, Tuple[float, dict]] = {}
    earliest_t: Optional[float] = None
    for sample in sorted(samples, key=lambda s: s.get("t", 0.0)):
        t = float(sample.get("t", 0.0))
        if cutoff is None or t >= cutoff:
            if earliest_t is None:
                earliest_t = t
        fam = (sample.get("snapshot") or {}).get(family)
        if not fam:
            continue
        for series in fam.get("series", []):
            slabels = series.get("labels") or {}
            if not labels_match(slabels, labels):
                continue
            key = (str(sample.get("proc", "")),
                   tuple(sorted(slabels.items())))
            if cutoff is not None and t < cutoff:
                before[key] = (t, series)
            else:
                in_window.setdefault(key, []).append((t, series))
    if baseline:
        zero = {"value": 0.0, "count": 0, "sum": 0.0, "buckets": {}, "inf": 0}
        for key, pts in in_window.items():
            if key in before:
                pts.insert(0, before[key])
            elif earliest_t is not None and earliest_t < pts[0][0]:
                # the series appeared AFTER the window's earliest sample:
                # it was genuinely born mid-window, so it counts from zero
                pts.insert(0, (earliest_t, zero))
            # else: the series' first point IS the earliest sample — a
            # single-point series has no delta yet (no_data), never a
            # fabricated since-birth total
    return in_window


def counter_increase(first: float, last: float) -> float:
    """Increase of a counter between two observations, reset-aware: a value
    that went DOWN means the process restarted and the counter restarted
    from zero — the post-reset value is the whole increase (Prometheus
    ``increase`` semantics, good enough without per-sample scan)."""
    return last if last < first else last - first


def histogram_delta(first: dict, last: dict) -> dict:
    """Windowed delta of one histogram series between two snapshots:
    per-bucket count deltas (reset-aware like :func:`counter_increase`),
    ``inf``, ``sum`` and ``count`` deltas."""
    fb = first.get("buckets") or {}
    lb = last.get("buckets") or {}
    reset = last.get("count", 0) < first.get("count", 0)
    if reset:
        first = {}
        fb = {}
    return {
        "buckets": {ub: lb[ub] - fb.get(ub, 0) for ub in lb},
        "inf": last.get("inf", 0) - first.get("inf", 0),
        "sum": last.get("sum", 0.0) - first.get("sum", 0.0),
        "count": last.get("count", 0) - first.get("count", 0),
    }


def merge_histograms(deltas: Sequence[dict]) -> dict:
    """Sum histogram deltas across series/procs (same declared buckets by
    construction — one declaration site per family)."""
    out = {"buckets": {}, "inf": 0, "sum": 0.0, "count": 0}
    for d in deltas:
        for ub, c in (d.get("buckets") or {}).items():
            out["buckets"][ub] = out["buckets"].get(ub, 0) + c
        out["inf"] += d.get("inf", 0)
        out["sum"] += d.get("sum", 0.0)
        out["count"] += d.get("count", 0)
    return out


def quantile_from_buckets(buckets: dict, inf: float, q: float) -> Optional[float]:
    """Quantile from per-bucket (non-cumulative) counts with linear
    interpolation inside the bucket — Prometheus ``histogram_quantile``
    semantics, including "observations in the +Inf bucket report the
    highest finite upper bound" (there is nothing sane to interpolate
    toward past the last edge)."""
    edges = sorted(((float(ub), c) for ub, c in (buckets or {}).items()),
                   key=lambda t: t[0])
    total = sum(c for _, c in edges) + inf
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    lo = 0.0
    for ub, c in edges:
        if cum + c >= rank and c > 0:
            frac = (rank - cum) / c
            return lo + (ub - lo) * frac
        cum += c
        lo = ub
    return edges[-1][0] if edges else None


def count_at_or_below(buckets: dict, threshold: float) -> float:
    """Observations ≤ ``threshold`` from per-bucket counts, interpolating
    linearly inside the bucket containing the threshold (the dual of
    :func:`quantile_from_buckets` — SLO "good event" counting)."""
    edges = sorted(((float(ub), c) for ub, c in (buckets or {}).items()),
                   key=lambda t: t[0])
    cum = 0.0
    lo = 0.0
    for ub, c in edges:
        if threshold >= ub:
            cum += c
            lo = ub
            continue
        if threshold > lo and ub > lo:
            cum += c * (threshold - lo) / (ub - lo)
        return cum
    return cum
