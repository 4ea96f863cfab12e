"""SLO alert engine — declarative rules over the metrics plane (copy of the
JAX package's ``monitoring.alerts``; the stock rules are the same, so one
rule set judges a fleet of either package's processes).

A straggling rank, a recompile storm or a server about to shed load all look
like "numbers on /metrics" until something judges them. This module does:

- an :class:`AlertRule` names ONE metric family, an aggregation over its
  series (across every proc in an aggregated scrape), a comparison and a
  threshold — plus modifiers: ``ratio_of`` (divide by another family's
  aggregate, e.g. HBM in-use over HBM limit), ``after_warmup`` (compare
  the INCREASE since :meth:`AlertEngine.mark_warmup_done`), and — the v2
  time dimension an autoscaler needs — ``window`` (evaluate over the
  trailing N seconds of the history ring), ``rate`` (counter → per-second
  increase over the window), percentile aggregations (``agg="p99"``),
  ``for_duration`` (must hold for N consecutive evaluations before firing —
  kills flapping) and ``clear_hysteresis`` (a firing rule clears only once
  the value retreats past the threshold by the band — no re-fire churn at
  the boundary);
- an :class:`AlertEngine` evaluates its rules **at scrape time** over the
  local registry plus (when attached) the metrics-spool dir — the same
  merge ``/metrics`` serves, including the derived straggler gauges.
  Windowed rules read the
  history plane (``monitoring.history``): an explicit
  ``history_view=HistoryRing/HistoryView`` when given, else an internal
  buffer the engine feeds one sample per evaluation (so any
  regularly-scraped engine gets windowed semantics with zero wiring);
- a rule's rising edge records an ``alert`` event in the flight recorder
  and increments ``tdl_alerts_fired_total{rule}``; the falling edge records
  an ``alert_clear`` event (with the firing duration) and increments
  ``tdl_alerts_cleared_total{rule}`` — postmortems therefore show alert
  *intervals*, not just onsets; the level is continuously exported as
  ``tdl_alert_firing{rule}`` 0/1 gauges.

Rules reference metric families by name; the JAX package's lint
(tests/test_alerts.py) fails any stock rule naming a family no registry
declares — renaming a metric cannot silently rot the alert that watches it.
``ServingPool``'s ``PoolAutoscaler`` acts on an engine's firing rules.
"""

from __future__ import annotations

import logging
import math
import re
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from . import flight, history
from .aggregate import derive_straggler, read_spools
from .registry import MetricsRegistry, get_registry

log = logging.getLogger(__name__)

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

_BASE_AGGS = ("max", "min", "sum", "mean")
_QUANTILE_RE = re.compile(r"p(\d{1,2}(?:\.\d+)?)$")


def _quantile_of(agg: str) -> Optional[float]:
    """``"p99"`` → 0.99, ``"p99.9"`` → 0.999; None for non-percentile aggs."""
    m = _QUANTILE_RE.fullmatch(agg)
    if not m:
        return None
    q = float(m.group(1))
    return q / 100.0 if 0 < q < 100 else None


@dataclass(frozen=True)
class AlertRule:
    """One declarative SLO rule over a metric family.

    ``agg`` folds the family's series (across labelsets AND procs) into one
    number: ``max``/``min``/``sum``, ``mean`` (histograms: sum/count — e.g.
    mean queue wait), or a percentile ``pNN``/``pNN.N`` (histograms only:
    bucket-interpolated quantile, merged across series). Histogram families
    under ``max``/``min``/``sum`` read the observation COUNT. ``ratio_of``
    divides PER SERIES — each numerator series over the same-labels series
    of the denominator family in the same snapshot — and the agg then folds
    the ratios. ``after_warmup`` compares the increase since the engine's
    warmup mark (the rule stays ``pending_warmup`` until
    :meth:`AlertEngine.mark_warmup_done`).

    Time-dimension modifiers (v2 — all read the history plane):

    - ``window``: evaluate over the trailing N seconds of history instead
      of the instantaneous snapshot. Counters become increases, histograms
      become window deltas (so ``agg="p99"`` is "p99 of the last N
      seconds", not since process start), gauges fold every in-window
      point;
    - ``rate``: with a window, counters (and histogram counts) divide the
      increase by the elapsed window time → per-second rate;
    - ``for_duration``: the condition must hold for this many CONSECUTIVE
      evaluations before the rule fires (state ``pending`` while holding);
    - ``clear_hysteresis``: once firing, the rule clears only when the
      value retreats past the threshold by this margin (in the clearing
      direction) — values oscillating inside the band keep one continuous
      firing interval instead of an edge per scrape;
    - ``label_filter``: only series whose labels superset-match (e.g.
      ``{"window": "fast"}`` to watch one burn-rate window).
    """

    name: str
    family: str
    op: str = ">"
    threshold: float = 0.0
    agg: str = "max"
    ratio_of: Optional[str] = None
    after_warmup: bool = False
    severity: str = "warning"
    description: str = ""
    window: Optional[float] = None
    rate: bool = False
    for_duration: int = 0
    clear_hysteresis: float = 0.0
    label_filter: Optional[Any] = None

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r} (use {sorted(_OPS)})")
        if self.agg not in _BASE_AGGS and _quantile_of(self.agg) is None:
            raise ValueError(
                f"unknown agg {self.agg!r} (use {_BASE_AGGS} or pNN)")
        if self.window is not None and self.window <= 0:
            raise ValueError(f"window must be > 0 seconds, got {self.window}")
        if self.rate and self.window is None:
            raise ValueError("rate=True needs window= (a rate is an "
                             "increase over a time window)")
        if self.window is not None and self.after_warmup:
            raise ValueError("window= and after_warmup are mutually "
                             "exclusive (a windowed value already measures "
                             "recent change)")
        if self.window is not None and self.ratio_of is not None:
            raise ValueError("window= and ratio_of are mutually exclusive")
        if self.for_duration < 0:
            raise ValueError("for_duration must be >= 0 evaluations")
        if self.clear_hysteresis < 0:
            raise ValueError("clear_hysteresis must be >= 0")
        if self.label_filter is not None:
            # normalize to a hashable tuple so the frozen dataclass stays
            # usable as a value object whatever mapping the caller passed
            if isinstance(self.label_filter, Mapping):
                object.__setattr__(
                    self, "label_filter",
                    tuple(sorted((str(k), str(v))
                                 for k, v in self.label_filter.items())))
            else:
                object.__setattr__(
                    self, "label_filter",
                    tuple(sorted((str(k), str(v))
                                 for k, v in self.label_filter)))

    @property
    def label_filter_dict(self) -> Optional[dict]:
        return dict(self.label_filter) if self.label_filter else None


def default_rules(queue_depth_hwm: float = 48, skew_ratio: float = 1.5,
                  hbm_headroom_frac: float = 0.9,
                  p99_latency_s: float = 0.5,
                  latency_window_s: float = 60.0,
                  burn_fast: float = 14.4, burn_slow: float = 6.0,
                  shed_per_s: float = 1.0,
                  shed_window_s: float = 30.0) -> Tuple[AlertRule, ...]:
    """The stock SLO rules: straggler skew, input-starved steps, serving
    queue-depth high watermark, recompile-after-warmup, HBM headroom,
    plus the windowed serving rules an autoscaler can act on:
    p99-latency-over-window, multi-window error-budget burn
    pair, and shed rate. Compose with your own:
    ``AlertEngine(default_rules() + (...,))``."""
    return (
        AlertRule(
            "straggler_skew", "tdl_step_time_skew_ratio", ">", skew_ratio,
            description="slowest rank's mean step wall exceeds the fastest "
                        "rank's by the threshold ratio — one rank is "
                        "dragging the gang"),
        AlertRule(
            "input_starved_steps", "tdl_input_starved_steps_total", ">", 0,
            agg="sum", after_warmup=True,
            description="train steps blocked on the input pipeline after "
                        "warmup — ETL or h2d staging is the wall"),
        AlertRule(
            "inference_queue_depth_hwm", "tdl_inference_queue_depth", ">=",
            queue_depth_hwm,
            description="serving admission queue at its high watermark — "
                        "backpressure (429s) is imminent"),
        AlertRule(
            "recompiles_after_warmup", "tdl_xla_compiles_total", ">", 0,
            agg="sum", after_warmup=True, severity="critical",
            description="XLA compiled after warmup — shape churn is "
                        "recompiling the step executable (pad or bucket "
                        "minibatch shapes)"),
        AlertRule(
            "hbm_headroom", "tdl_device_memory_bytes_in_use", ">",
            hbm_headroom_frac, ratio_of="tdl_device_memory_limit_bytes",
            severity="critical",
            description="device memory in use is above the headroom "
                        "fraction of the reported HBM limit — the next "
                        "allocation spike OOMs"),
        # -- windowed serving rules: what a scaler can act on --
        AlertRule(
            "p99_latency_rising", "tdl_inference_latency_seconds", ">",
            p99_latency_s, agg="p99", window=latency_window_s,
            for_duration=2, clear_hysteresis=0.2 * p99_latency_s,
            description="serving p99 latency over the trailing window is "
                        "above target for consecutive evaluations — "
                        "sustained, not a single slow scrape; scale out or "
                        "tighten admission"),
        AlertRule(
            "error_budget_burn_fast", "tdl_slo_burn_rate", ">", burn_fast,
            agg="max", label_filter={"window": "fast"}, for_duration=2,
            severity="critical",
            description="error budget burning at page-worthy speed over "
                        "the fast window (an SLO tracker must be "
                        "exporting tdl_slo_burn_rate)"),
        AlertRule(
            "error_budget_burn_slow", "tdl_slo_burn_rate", ">", burn_slow,
            agg="max", label_filter={"window": "slow"}, for_duration=3,
            description="error budget burning persistently over the slow "
                        "window — at this pace the budget is gone before "
                        "the period ends"),
        AlertRule(
            "shed_rate", "tdl_inference_shed_total", ">", shed_per_s,
            agg="sum", window=shed_window_s, rate=True, for_duration=2,
            description="requests shed (queue-full / expired) per second "
                        "over the window — sustained overload, not one "
                        "burst scrape"),
    )


def alert_metrics(registry: Optional[MetricsRegistry] = None):
    """Get-or-create the alert families (one declaration site)."""
    r = registry or get_registry()
    return (
        r.gauge("tdl_alert_firing",
                "1 while the named alert rule's condition holds, else 0",
                labels=("rule",)),
        r.counter("tdl_alerts_fired_total",
                  "Rising edges of the named alert rule (ok → firing)",
                  labels=("rule",)),
        r.counter("tdl_alerts_cleared_total",
                  "Falling edges of the named alert rule (firing → ok)",
                  labels=("rule",)),
    )


# ------------------------------------------------------------------- engine


def _series_values(fam: dict, agg: str,
                   label_filter: Optional[dict] = None) -> List[float]:
    vals = []
    for s in fam.get("series", []):
        if not history.labels_match(s.get("labels") or {}, label_filter):
            continue
        if fam.get("type") == "histogram":
            if agg == "mean":
                if s.get("count", 0) > 0:
                    vals.append(float(s.get("sum", 0.0)) / s["count"])
            else:
                vals.append(float(s.get("count", 0)))
        elif "value" in s:
            vals.append(float(s["value"]))
    return vals


def _fold(vals: List[float], agg: str) -> Optional[float]:
    if not vals:
        return None
    if agg == "max":
        return max(vals)
    if agg == "min":
        return min(vals)
    if agg == "sum":
        return sum(vals)
    return sum(vals) / len(vals)  # mean


#: capacity of the engine's internal history buffer (used only when no
#: explicit history is attached): per-proc samples per evaluation, so this
#: bounds both memory and how far back windowed rules can see
_INTERNAL_HISTORY_CAP = 4096


class AlertEngine:
    """Evaluates rules over the local registry + (optionally) a metrics
    spool dir, at scrape time. Stateless between evaluations except for the
    warmup baselines, the firing/hold state machine (edge detection,
    ``for_duration`` counting, hysteresis) and — for windowed rules without
    an explicit ``history`` — an internal sample buffer fed one sample per
    evaluation."""

    def __init__(self, rules: Optional[Sequence[AlertRule]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 spool_dir: Optional[str] = None,
                 history_view=None):
        self.rules: Tuple[AlertRule, ...] = tuple(
            default_rules() if rules is None else rules)
        names = [r.name for r in self.rules]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate alert rule names: {sorted(dupes)}")
        self.registry = registry if registry is not None else get_registry()
        self.spool_dir = spool_dir
        #: history source for windowed rules: a HistoryRing / HistoryView
        #: (anything with .samples(window=, now=)); None → the engine feeds
        #: its own buffer from the snapshots it already takes per evaluation
        self.history_view = history_view
        self._warmup_base: Dict[str, float] = {}
        self._warmup_marked = False
        self._was_firing: Dict[str, bool] = {}
        self._hold_counts: Dict[str, int] = {}
        self._fired_at: Dict[str, float] = {}
        self._internal_hist: deque = deque(maxlen=_INTERNAL_HISTORY_CAP)
        #: longest rule window + margin: internal-buffer entries older than
        #: this are useless to every rule and are dropped on append, so a
        #: long-lived frequently-scraped engine holds minutes of snapshots,
        #: not the full 4096-entry backstop
        windows = [r.window for r in self.rules if r.window is not None]
        self._hist_horizon = (max(windows) + 60.0) if windows else None
        # /alerts is served by a ThreadingHTTPServer: concurrent scrapes
        # must not both take the same rising edge (double-counted fires,
        # duplicate flight events) or race the warmup baselines
        self._eval_lock = threading.Lock()
        (self._firing_gauge, self._fired_counter,
         self._cleared_counter) = alert_metrics(self.registry)

    # -- snapshots ---------------------------------------------------------

    def _proc_snapshots(self) -> List[Tuple[str, dict]]:
        """Every (proc, snapshot) in scope: the local registry, every spool,
        and the derived straggler gauges presented as a pseudo-snapshot (so
        rules can reference the same derived families /metrics exposes)."""
        pairs: List[Tuple[str, dict]] = [("local", self.registry.snapshot())]
        if self.spool_dir:
            spools = read_spools(self.spool_dir, registry=self.registry)
            pairs.extend((str(s.get("proc", "")), s.get("snapshot") or {})
                         for s in spools)
            derived = derive_straggler(spools)
            if derived:
                pairs.append(("_derived", {
                    "tdl_step_time_skew_ratio": {"type": "gauge", "series": [
                        {"labels": {}, "value": derived["skew_ratio"]}]},
                    "tdl_step_time_slowest_rank": {"type": "gauge", "series": [
                        {"labels": {}, "value": derived["slowest_rank"]}]},
                    "tdl_step_time_mean_seconds": {"type": "gauge", "series": [
                        {"labels": {"rank": str(r)}, "value": v}
                        for r, v in derived["mean_step_seconds"].items()]},
                }))
        return pairs

    def _snapshots(self) -> List[dict]:
        return [snap for _, snap in self._proc_snapshots()]

    def _aggregate(self, snaps: List[dict], family: str, agg: str,
                   label_filter: Optional[dict] = None) -> Optional[float]:
        q = _quantile_of(agg)
        if q is not None:
            # quantile over CUMULATIVE buckets merged across series/procs
            deltas = []
            for snap in snaps:
                fam = snap.get(family)
                if not fam or fam.get("type") != "histogram":
                    continue
                for s in fam.get("series", []):
                    if history.labels_match(s.get("labels") or {},
                                            label_filter):
                        deltas.append({"buckets": s.get("buckets") or {},
                                       "inf": s.get("inf", 0),
                                       "sum": s.get("sum", 0.0),
                                       "count": s.get("count", 0)})
            if not deltas:
                return None
            merged = history.merge_histograms(deltas)
            return history.quantile_from_buckets(merged["buckets"],
                                                 merged["inf"], q)
        vals: List[float] = []
        for snap in snaps:
            fam = snap.get(family)
            if fam:
                vals.extend(_series_values(fam, agg, label_filter))
        return _fold(vals, agg)

    def _ratio_values(self, snaps: List[dict],
                      rule: AlertRule) -> List[float]:
        """Per-SERIES ratios: numerator and denominator are paired within
        the same snapshot by identical labels (each device's in-use over
        THAT device's limit), then the agg folds the ratios. Folding the
        two families independently would let one proc's huge denominator
        (a 64GB CPU host limit) hide another proc's 97%-full device."""
        ratios: List[float] = []
        filt = rule.label_filter_dict
        for snap in snaps:
            num_fam, den_fam = snap.get(rule.family), snap.get(rule.ratio_of)
            if not num_fam or not den_fam:
                continue
            denoms = {}
            for s in den_fam.get("series", []):
                vals = _series_values({**den_fam, "series": [s]}, rule.agg)
                if vals:
                    denoms[tuple(sorted((s.get("labels") or {}).items()))] = vals[0]
            for s in num_fam.get("series", []):
                if not history.labels_match(s.get("labels") or {}, filt):
                    continue
                den = denoms.get(
                    tuple(sorted((s.get("labels") or {}).items())))
                if not den:
                    continue
                vals = _series_values({**num_fam, "series": [s]}, rule.agg)
                if vals:
                    ratios.append(vals[0] / den)
        return ratios

    # -- windowed evaluation ------------------------------------------------

    def _history_samples(self, now: Optional[float]) -> List[dict]:
        if self.history_view is not None:
            # fetch UNWINDOWED: window_points applies each rule's cutoff
            # itself and needs the nearest PRE-window sample as the delta
            # baseline — pre-trimming to the rule window here would measure
            # increases from the first in-window sample and undercount by
            # up to one sampling/spool interval
            return self.history_view.samples(now=now)
        return list(self._internal_hist)

    def _windowed_value(self, rule: AlertRule, now: Optional[float],
                        samples: Optional[List[dict]] = None) -> Optional[float]:
        """The rule's value over its trailing window: counters → increase
        (or per-second rate), histograms → window-delta count / mean /
        bucket-interpolated quantile, gauges → agg-fold of every in-window
        point. Per-series deltas are taken per (proc, labelset), then the
        agg folds across series — same shape as the snapshot path.
        ``samples`` lets one evaluation share a single history fetch across
        all its windowed rules (a directory-backed view re-reads every ring
        file per fetch)."""
        if samples is None:
            samples = self._history_samples(now)
        ftype = None
        for s in samples:
            fam = (s.get("snapshot") or {}).get(rule.family)
            if fam:
                ftype = fam.get("type")
                break
        if ftype is None:
            return None
        # gauges carry no delta semantics: fold the in-window point values
        # (no pre-window baseline). Everything else deltas first-vs-last per
        # series, with the nearest pre-window sample as the left edge.
        pts = history.window_points(
            samples, rule.family, labels=rule.label_filter_dict,
            window=rule.window, now=now, baseline=(ftype != "gauge"))
        q = _quantile_of(rule.agg)
        if ftype == "gauge":
            if q is not None:
                # no bucket data to interpolate a percentile from — and a
                # percentile over scrape-cadence point samples would be a
                # different (cadence-dependent) statistic. no_data, same as
                # the snapshot path, never a silent mean
                return None
            vals = [float(s["value"]) for series_pts in pts.values()
                    for _, s in series_pts if "value" in s]
            return _fold(vals, rule.agg)
        vals: List[float] = []
        deltas: List[dict] = []
        mean_sum = mean_count = 0.0
        for series_pts in pts.values():
            if len(series_pts) < 2:
                continue  # no delta to take yet
            (t0, first), (t1, last) = series_pts[0], series_pts[-1]
            dt = t1 - t0
            if ftype == "histogram":
                d = history.histogram_delta(first, last)
                if q is not None:
                    deltas.append(d)
                elif rule.agg == "mean":
                    mean_sum += d["sum"]
                    mean_count += d["count"]
                elif rule.rate:
                    if dt > 0:
                        vals.append(d["count"] / dt)
                else:
                    vals.append(float(d["count"]))
            elif "value" in last:  # counter series
                inc = history.counter_increase(
                    float(first["value"]), float(last["value"]))
                if rule.rate:
                    if dt > 0:
                        vals.append(inc / dt)
                else:
                    vals.append(inc)
        if q is not None:
            if not deltas:
                return None
            merged = history.merge_histograms(deltas)
            return history.quantile_from_buckets(merged["buckets"],
                                                 merged["inf"], q)
        if rule.agg == "mean" and ftype == "histogram":
            return mean_sum / mean_count if mean_count > 0 else None
        return _fold(vals, rule.agg)

    def _folded_value(self, snaps: List[dict],
                      rule: AlertRule) -> Optional[float]:
        """The rule's aggregate (ratio applied) BEFORE any warmup-baseline
        subtraction — the one folding path both live evaluation and the
        warmup snapshot use, so the two can never drift apart."""
        if rule.ratio_of is not None:
            return _fold(self._ratio_values(snaps, rule), rule.agg)
        return self._aggregate(snaps, rule.family, rule.agg,
                               rule.label_filter_dict)

    def _rule_value(self, snaps: List[dict], rule: AlertRule,
                    now: Optional[float] = None,
                    hist_samples: Optional[List[dict]] = None):
        """(value, state) — value is what the threshold compares against."""
        if rule.window is not None:
            v = self._windowed_value(rule, now, samples=hist_samples)
            return (v, "ok") if v is not None else (None, "no_data")
        v = self._folded_value(snaps, rule)
        if v is None:
            return None, "no_data"
        if rule.after_warmup:
            if not self._warmup_marked:
                return None, "pending_warmup"
            v = v - self._warmup_base.get(rule.name, 0.0)
        return v, "ok"

    # -- lifecycle ---------------------------------------------------------

    def mark_warmup_done(self) -> None:
        """Snapshot the current value of every ``after_warmup`` rule as its
        baseline: compiles/starvation during warmup are expected, growth
        afterwards is the anomaly. Call once the steady state is reached
        (e.g. after the first epoch / serving warmup)."""
        snaps = self._snapshots()
        with self._eval_lock:
            for rule in self.rules:
                if not rule.after_warmup:
                    continue
                v = self._folded_value(snaps, rule)
                self._warmup_base[rule.name] = v if v is not None else 0.0
            self._warmup_marked = True

    def evaluate(self) -> List[dict]:
        """One scrape-time pass: every rule's current value, threshold and
        firing state. Rising edges land in the flight recorder (and the
        fired counter), falling edges as ``alert_clear`` events (and the
        cleared counter); the 0/1 level lands in ``tdl_alert_firing``.
        Serialized: concurrent scrapes of ``/alerts`` must not both take
        the same rising edge."""
        now = time.monotonic()
        pairs = self._proc_snapshots()
        with self._eval_lock:
            if self.history_view is None and self._hist_horizon is not None:
                # feed the internal buffer so windowed rules see this scrape
                for proc, snap in pairs:
                    if proc != "_derived":
                        self._internal_hist.append(
                            {"t": now, "proc": proc, "snapshot": snap})
                # time-trim: nothing older than the longest window (+margin
                # for the pre-window baseline) helps any rule
                cutoff = now - self._hist_horizon
                while (self._internal_hist
                       and self._internal_hist[0]["t"] < cutoff):
                    self._internal_hist.popleft()
            return self._evaluate_locked([s for _, s in pairs], now)

    def _holds(self, rule: AlertRule, value: float, was_firing: bool) -> bool:
        """The comparison, hysteresis-shifted while firing: a firing rule
        keeps firing inside the band and clears only past it."""
        thr = rule.threshold
        if was_firing and rule.clear_hysteresis:
            if rule.op in (">", ">="):
                thr -= rule.clear_hysteresis
            else:
                thr += rule.clear_hysteresis
        return _OPS[rule.op](value, thr)

    def _evaluate_locked(self, snaps: List[dict],
                         now: Optional[float] = None) -> List[dict]:
        if now is None:
            now = time.monotonic()
        out = []
        hist_samples: Optional[List[dict]] = None
        for rule in self.rules:
            if rule.window is not None and hist_samples is None:
                # ONE history fetch per evaluation, shared by every
                # windowed rule — a spool-dir view re-parses ring files
                hist_samples = self._history_samples(now)
            value, state = self._rule_value(snaps, rule, now, hist_samples)
            was = self._was_firing.get(rule.name, False)
            holds = bool(value is not None
                         and self._holds(rule, value, was))
            if holds:
                self._hold_counts[rule.name] = \
                    self._hold_counts.get(rule.name, 0) + 1
            else:
                self._hold_counts[rule.name] = 0
            consecutive = self._hold_counts[rule.name]
            # for_duration: a NEW fire needs the condition to have held for
            # that many consecutive evaluations; an already-firing rule
            # stays firing while the (hysteresis-shifted) condition holds
            firing = (holds if was
                      else holds and consecutive >= max(1, rule.for_duration))
            if holds and not firing:
                state = "pending"
            elif firing:
                state = "firing"
            if firing and not was:
                self._fired_counter.labels(rule.name).inc()
                self._fired_at[rule.name] = now
                # black-box breadcrumb: the postmortem shows the alert ON the
                # timeline, between the events that caused it
                flight.record("alert", rule=rule.name, value=value,
                              threshold=rule.threshold,
                              severity=rule.severity, family=rule.family)
                log.warning("alert %s firing: %s %s %s (%s=%.6g)",
                            rule.name, rule.family, rule.op, rule.threshold,
                            rule.agg, value)
            elif was and not firing:
                self._cleared_counter.labels(rule.name).inc()
                fired_at = self._fired_at.pop(rule.name, None)
                duration = now - fired_at if fired_at is not None else None
                # the falling edge completes the interval: postmortems show
                # how LONG the alert held, not just that it rose
                flight.record("alert_clear", rule=rule.name, value=value,
                              threshold=rule.threshold,
                              severity=rule.severity, family=rule.family,
                              duration=duration)
                log.warning("alert %s cleared after %.3gs", rule.name,
                            duration if duration is not None else float("nan"))
            self._was_firing[rule.name] = firing
            self._firing_gauge.labels(rule.name).set(1.0 if firing else 0.0)
            out.append({
                "rule": rule.name,
                "family": rule.family,
                "op": rule.op,
                "threshold": rule.threshold,
                "agg": rule.agg,
                "ratio_of": rule.ratio_of,
                "after_warmup": rule.after_warmup,
                "window": rule.window,
                "rate": rule.rate,
                "for_duration": rule.for_duration,
                "clear_hysteresis": rule.clear_hysteresis,
                "label_filter": rule.label_filter_dict,
                "severity": rule.severity,
                "description": rule.description,
                # an infinite skew (a rank reporting 0s steps) still fires,
                # but the Infinity token is not strict JSON — report null
                "value": value if (value is None or math.isfinite(value))
                else None,
                "consecutive": consecutive,
                "state": state,
                "firing": firing,
            })
        return out

    def firing(self) -> List[str]:
        """Names of currently-firing rules (evaluates)."""
        return [a["rule"] for a in self.evaluate() if a["firing"]]
