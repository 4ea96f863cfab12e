"""SLO objectives and attainment — declarative service-level math (copy of
the JAX package's ``monitoring.slo``: the same registry history gives the
same attainment, budget and burn rows in both packages).

An alert rule says "this number crossed that line"; an SLO says "over this
window, at least ``target`` of events must be good" — the form an
autoscaler (and any honest bench report) actually needs, because it carries
its own error budget: how much badness is still affordable, and how fast it
is being spent.

- :class:`SloObjective` declares ONE objective against the metrics plane:
  either a **latency** objective over a histogram family (good = the
  observations at or below ``threshold_seconds``, bucket-interpolated the
  same way ``agg="p99"`` alert rules read quantiles) or a **success-ratio**
  objective over a labeled counter family (good = the series whose labels
  prefix-match ``good_labels``, e.g. ``{"code": "2"}`` for HTTP 2xx over
  ``tdl_inference_requests_total``);
- :class:`SloTracker` compiles objectives against the history ring
  (``monitoring.history``) and computes, per objective: **attainment** over
  the objective's window, **error budget remaining** (1 − consumed/allowed)
  and **burn rate** over each configured burn window (1.0 = spending budget
  exactly as fast as the target affords; 14.4 = the classic page-worthy
  fast burn). Results are exported as ``tdl_slo_attainment{slo}``,
  ``tdl_slo_error_budget_remaining{slo}`` and
  ``tdl_slo_burn_rate{slo,window}`` — which is what the stock
  ``error_budget_burn_fast``/``_slow`` alert rules watch.

Objectives reference metric families by name; every family the stock
objectives read is declared by a module of the port (``monitoring.serving``).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from . import history
from .registry import MetricsRegistry, get_registry

log = logging.getLogger(__name__)

#: burn-rate windows exported by default: a fast window that catches a
#: spike while it still matters and a slow one that catches a grind. The
#: NAMES are the ``window`` label values (stable alert targets); the
#: seconds are tuned for this repo's compressed bench/replay timescales.
DEFAULT_BURN_WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("fast", 60.0), ("slow", 300.0))


@dataclass(frozen=True)
class SloObjective:
    """One service-level objective over the metrics plane.

    Exactly one mode must be set:

    - latency: ``histogram_family`` + ``threshold_seconds`` — good events
      are observations ≤ the threshold (interpolated inside the bucket
      containing it);
    - success ratio: ``success_ratio_of`` (a labeled counter family) —
      good events are increases of the series whose labels PREFIX-match
      every ``good_labels`` entry (default ``{"code": "2"}``: HTTP 2xx).

    ``labels`` narrows both modes to series superset-matching it exactly
    (e.g. ``{"outcome": "ok"}`` on the client latency histogram).
    ``target`` is the good fraction promised over ``window`` seconds.
    """

    name: str
    histogram_family: Optional[str] = None
    threshold_seconds: Optional[float] = None
    success_ratio_of: Optional[str] = None
    good_labels: Optional[Any] = None
    labels: Optional[Any] = None
    target: float = 0.999
    window: float = 60.0
    description: str = ""

    def __post_init__(self):
        latency = self.histogram_family is not None
        ratio = self.success_ratio_of is not None
        if latency == ratio:
            raise ValueError(
                f"SloObjective {self.name!r}: set exactly one of "
                "histogram_family (latency SLO) or success_ratio_of "
                "(success-ratio SLO)")
        if latency and self.threshold_seconds is None:
            raise ValueError(f"SloObjective {self.name!r}: a latency SLO "
                             "needs threshold_seconds")
        if latency and self.threshold_seconds <= 0:
            raise ValueError(f"SloObjective {self.name!r}: threshold_seconds "
                             "must be > 0")
        if not (0.0 < self.target < 1.0):
            raise ValueError(f"SloObjective {self.name!r}: target must be in "
                             f"(0, 1), got {self.target} — a target of "
                             "exactly 1.0 has no error budget to track")
        if self.window <= 0:
            raise ValueError(f"SloObjective {self.name!r}: window must be "
                             "> 0 seconds")
        for attr, default in (("good_labels",
                               {"code": "2"} if ratio else None),
                              ("labels", None)):
            val = getattr(self, attr)
            if val is None:
                val = default
            if val is not None and isinstance(val, Mapping):
                val = tuple(sorted((str(k), str(v)) for k, v in val.items()))
            elif val is not None:
                val = tuple(sorted((str(k), str(v)) for k, v in val))
            object.__setattr__(self, attr, val)

    @property
    def family(self) -> str:
        return self.histogram_family or self.success_ratio_of

    @property
    def labels_dict(self) -> Optional[dict]:
        return dict(self.labels) if self.labels else None

    @property
    def good_labels_dict(self) -> Optional[dict]:
        return dict(self.good_labels) if self.good_labels else None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "histogram_family": self.histogram_family,
            "threshold_seconds": self.threshold_seconds,
            "success_ratio_of": self.success_ratio_of,
            "good_labels": self.good_labels_dict,
            "labels": self.labels_dict,
            "target": self.target,
            "window": self.window,
            "description": self.description,
        }


def default_objectives(latency_threshold_s: float = 0.25,
                       target: float = 0.99,
                       window_s: float = 60.0) -> Tuple[SloObjective, ...]:
    """The stock serving objectives: server-side latency, server-side
    availability (2xx ratio), and client-observed latency (where users
    live — the satellite client metrics ground it)."""
    return (
        SloObjective(
            "serving_latency",
            histogram_family="tdl_inference_latency_seconds",
            threshold_seconds=latency_threshold_s, target=target,
            window=window_s,
            description="fraction of server-side requests answered within "
                        "the latency threshold"),
        SloObjective(
            "serving_availability",
            success_ratio_of="tdl_inference_requests_total",
            good_labels={"code": "2"}, target=target, window=window_s,
            description="fraction of HTTP responses that were 2xx (429/504 "
                        "shed traffic burns budget)"),
        SloObjective(
            "client_latency",
            histogram_family="tdl_client_request_seconds",
            labels={"outcome": "ok"},
            threshold_seconds=latency_threshold_s, target=target,
            window=window_s,
            description="fraction of successful client-observed requests "
                        "(retries included) within the latency threshold"),
    )


def slo_metrics(registry: Optional[MetricsRegistry] = None):
    """Get-or-create the SLO export families (one declaration site)."""
    r = registry if registry is not None else get_registry()
    return (
        r.gauge("tdl_slo_attainment",
                "good-event fraction over the objective's window "
                "(1.0 = perfect; -1 = no traffic in window)",
                labels=("slo",)),
        r.gauge("tdl_slo_error_budget_remaining",
                "fraction of the objective's error budget left over its "
                "window (1.0 = untouched, 0 = spent, negative = overdrawn)",
                labels=("slo",)),
        r.gauge("tdl_slo_burn_rate",
                "error-budget burn speed over the named window (1.0 = "
                "spending exactly the budgeted rate)",
                labels=("slo", "window")),
    )


# ------------------------------------------------------------------ tracker


class SloTracker:
    """Computes attainment / budget / burn for a set of objectives from the
    history ring, exporting the ``tdl_slo_*`` gauges on every evaluation.

    ``history_view``: a ``HistoryRing``/``HistoryView`` (anything with
    ``.samples(window=, now=)``). None → the tracker self-feeds an internal
    ring from ``registry`` on each :meth:`evaluate` call, so a tracker
    polled on a scrape/evaluation cadence works with zero wiring (same
    pattern as ``AlertEngine``'s internal buffer).
    """

    def __init__(self, objectives: Optional[Sequence[SloObjective]] = None,
                 history_view=None,
                 registry: Optional[MetricsRegistry] = None,
                 burn_windows: Sequence[Tuple[str, float]] = DEFAULT_BURN_WINDOWS):
        self.objectives: Tuple[SloObjective, ...] = tuple(
            default_objectives() if objectives is None else objectives)
        names = [o.name for o in self.objectives]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate SLO names: {sorted(dupes)}")
        self.registry = registry if registry is not None else get_registry()
        self.burn_windows = tuple((str(n), float(w)) for n, w in burn_windows)
        self._own_ring: Optional[history.HistoryRing] = None
        if history_view is None:
            # self-feeding adds one sample per evaluate(): size the ring so
            # the longest window in play survives even a tight evaluation
            # loop (~5 Hz) — a fixed default capacity would silently shrink
            # a 300s burn window to however far the ring happened to reach
            longest = max([w for _, w in self.burn_windows]
                          + [o.window for o in self.objectives])
            self._own_ring = history.HistoryRing(
                registry=self.registry, interval=0.0,
                capacity=max(history.DEFAULT_CAPACITY, int(longest * 5) + 8))
            history_view = self._own_ring
        self.history_view = history_view
        (self._attain_gauge, self._budget_gauge,
         self._burn_gauge) = slo_metrics(self.registry)

    # -- math --------------------------------------------------------------

    def _good_total(self, samples: List[dict], obj: SloObjective,
                    window: float, now: Optional[float]) -> Tuple[float, float]:
        """(good, total) event increases over the trailing ``window``."""
        pts = history.window_points(
            samples, obj.family, labels=obj.labels_dict,
            window=window, now=now, baseline=True)
        good = total = 0.0
        if obj.histogram_family is not None:
            deltas = []
            for series_pts in pts.values():
                if len(series_pts) < 2:
                    continue
                deltas.append(history.histogram_delta(series_pts[0][1],
                                                      series_pts[-1][1]))
            merged = history.merge_histograms(deltas)
            total = float(merged["count"])
            good = min(total, history.count_at_or_below(
                merged["buckets"], obj.threshold_seconds))
            return good, total
        want = obj.good_labels_dict or {}
        for (proc, labels_key), series_pts in pts.items():
            if len(series_pts) < 2:
                continue
            inc = history.counter_increase(
                float(series_pts[0][1].get("value", 0.0)),
                float(series_pts[-1][1].get("value", 0.0)))
            total += inc
            slabels = dict(labels_key)
            if all(str(slabels.get(k, "")).startswith(v)
                   for k, v in want.items()):
                good += inc
        return good, total

    def _attainment(self, samples: List[dict], obj: SloObjective,
                    window: float,
                    now: Optional[float]) -> Optional[float]:
        good, total = self._good_total(samples, obj, window, now)
        if total <= 0:
            return None
        return good / total

    # -- evaluation --------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One pass: attainment / budget / burn per objective, gauges set.
        No traffic in an objective's window reports ``state="no_traffic"``
        with a full budget (you cannot burn budget on requests that never
        arrived) and attainment gauge −1 (a 0.0 would read as a total
        outage on dashboards)."""
        if now is None:
            now = time.monotonic()
        if self._own_ring is not None:
            self._own_ring.sample(force=True)
        longest = max([w for _, w in self.burn_windows]
                      + [o.window for o in self.objectives])
        samples = self.history_view.samples(window=longest, now=now)
        # honesty marker: how far back the retained history actually
        # reaches — a span shorter than an objective's window means that
        # window is effectively truncated (ring capacity / young process)
        span = round(now - min(s["t"] for s in samples), 1) if samples else 0.0
        out = []
        for obj in self.objectives:
            allowed = 1.0 - obj.target
            att = self._attainment(samples, obj, obj.window, now)
            if att is None:
                budget_remaining: Optional[float] = 1.0
                state = "no_traffic"
            else:
                budget_remaining = 1.0 - (1.0 - att) / allowed
                state = "ok" if att >= obj.target else "violating"
            burns: Dict[str, Optional[float]] = {}
            for wname, wsec in self.burn_windows:
                w_att = self._attainment(samples, obj, wsec, now)
                burn = (0.0 if w_att is None
                        else (1.0 - w_att) / allowed)
                burns[wname] = burn
                self._burn_gauge.labels(obj.name, wname).set(burn)
            self._attain_gauge.labels(obj.name).set(
                att if att is not None else -1.0)
            self._budget_gauge.labels(obj.name).set(budget_remaining)
            out.append({
                "slo": obj.name,
                "family": obj.family,
                "threshold_seconds": obj.threshold_seconds,
                "target": obj.target,
                "window": obj.window,
                "attainment": att,
                "error_budget_remaining": budget_remaining,
                "burn_rate": burns,
                "history_span_s": span,
                "state": state,
                "description": obj.description,
            })
        return out
