"""Deployment-controller metric families and canary judgement.

Copy of ``deeplearning4j_tpu/monitoring/deploy.py``: one declaration site so
``deploy.controller.FleetController``, its tests and ``chip_smoke.py`` agree
on names and labels (the same names as the JAX package's).

Controller families::

    tdl_deploy_candidates_total             committed generations picked up
                                            as promotion candidates
    tdl_deploy_gate_verdicts_total{gate,verdict}
                                            per-gate pass/fail verdicts
                                            (gate: integrity|eval|canary|
                                            promote; verdict: pass|fail)
    tdl_deploy_gate_seconds{gate}           wall seconds one gate evaluation
                                            took (retries included)
    tdl_deploy_promotions_total             candidates promoted to the fleet
    tdl_deploy_rollbacks_total{gate}        candidates rejected, by the gate
                                            that caught them
    tdl_deploy_promoted_generation          the currently-promoted lineage
                                            generation number (-1 = none)

Canary families — the PAIRED old-vs-candidate judgement, one sample per
replay sub-window (the ``arm`` label separates the two sides of the pair)::

    tdl_deploy_canary_availability{arm}     fraction of the window's requests
                                            answered 200, per arm
                                            (baseline | candidate)
    tdl_deploy_canary_burn_rate{arm}        client-side SLO error-budget burn
                                            over the window, per arm — the
                                            same (1-attainment)/(1-target)
                                            math the JAX package's monitoring/slo.py exports
    tdl_deploy_canary_latency_ratio         candidate p99 / baseline p99 over
                                            the window (1.0 = parity)
    tdl_deploy_canary_burn_excess           candidate burn minus baseline
                                            burn over the window — a paired
                                            measure that a fleet-wide
                                            overload cannot trip

:func:`canary_rules` declares the stock :class:`AlertRule` set over those
families — ``for_duration``/``clear_hysteresis`` semantics come from
``monitoring/alerts.py`` unchanged, so "sustained over the replay window"
means exactly what it means for every other alert in the repo: the
controller feeds one evaluation per sub-window and a rule must hold for
``for_duration`` CONSECUTIVE windows to fire.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

from .alerts import AlertRule
from .registry import MetricsRegistry, get_registry


def deploy_metrics(registry: Optional[MetricsRegistry] = None
                   ) -> SimpleNamespace:
    """Get-or-create the deployment-controller families on ``registry``."""
    r = registry if registry is not None else get_registry()
    return SimpleNamespace(
        candidates=r.counter(
            "tdl_deploy_candidates_total",
            "committed lineage generations picked up as promotion "
            "candidates"),
        gate_verdicts=r.counter(
            "tdl_deploy_gate_verdicts_total",
            "deployment gate verdicts by gate and outcome",
            labels=("gate", "verdict")),
        gate_seconds=r.histogram(
            "tdl_deploy_gate_seconds",
            "wall seconds one deployment gate evaluation took (retries "
            "included)", labels=("gate",)),
        promotions=r.counter(
            "tdl_deploy_promotions_total",
            "candidates promoted to the serving fleet (rolling swap "
            "completed)"),
        rollbacks=r.counter(
            "tdl_deploy_rollbacks_total",
            "candidates rejected, by the gate that caught them",
            labels=("gate",)),
        promoted_generation=r.gauge(
            "tdl_deploy_promoted_generation",
            "the currently-promoted lineage generation number (-1 = no "
            "promotion yet)"),
        canary_availability=r.gauge(
            "tdl_deploy_canary_availability",
            "fraction of the canary sub-window's requests answered 200, "
            "per arm (baseline|candidate)", labels=("arm",)),
        canary_burn=r.gauge(
            "tdl_deploy_canary_burn_rate",
            "client-side error-budget burn over the canary sub-window, "
            "per arm (1.0 = spending exactly the budgeted rate)",
            labels=("arm",)),
        canary_latency_ratio=r.gauge(
            "tdl_deploy_canary_latency_ratio",
            "candidate p99 latency over baseline p99 in the canary "
            "sub-window (1.0 = parity)"),
        canary_burn_excess=r.gauge(
            "tdl_deploy_canary_burn_excess",
            "candidate burn minus baseline burn over the canary sub-window "
            "— paired, so fleet-wide overload cannot trip it"),
    )


def canary_rules(latency_ratio: float = 2.0,
                 min_availability: float = 0.95,
                 burn_excess: float = 2.0,
                 for_duration: int = 2) -> Tuple[AlertRule, ...]:
    """The stock canary SLO rules the controller's gate judges with.

    Each is evaluated once per replay sub-window; ``for_duration``
    consecutive bad windows fire (one noisy window never kills a healthy
    candidate), and hysteresis keeps a firing rule from flapping across the
    threshold — the exact ``monitoring/alerts.py`` machinery production
    alerting uses, pointed at the paired canary gauges."""
    return (
        AlertRule(
            "canary_latency_regression", "tdl_deploy_canary_latency_ratio",
            ">", latency_ratio, agg="max", for_duration=for_duration,
            clear_hysteresis=0.1 * latency_ratio, severity="critical",
            description="candidate p99 latency exceeds baseline p99 by the "
                        "threshold ratio for consecutive canary sub-windows "
                        "— a latency regression shipped with the candidate"),
        AlertRule(
            "canary_availability_low", "tdl_deploy_canary_availability",
            "<", min_availability, agg="min",
            label_filter={"arm": "candidate"}, for_duration=for_duration,
            clear_hysteresis=0.01, severity="critical",
            description="the candidate arm's per-window availability is "
                        "below target for consecutive canary sub-windows "
                        "(baseline arm untouched — the candidate is the "
                        "problem)"),
        AlertRule(
            "canary_burn_excess", "tdl_deploy_canary_burn_excess", ">",
            burn_excess, agg="max", for_duration=for_duration,
            severity="critical",
            description="the candidate is burning error budget faster than "
                        "the baseline by the threshold margin for "
                        "consecutive sub-windows — a paired burn edge a "
                        "fleet-wide overload cannot fake"),
    )


# -------------------------------------------------- paired window judgement


def _p99(vals: List[float]) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


def _arm_window(rows: Sequence[dict], lo: float, hi: float,
                threshold_ms: float, target: float) -> Optional[dict]:
    """One arm's stats over one ``[lo, hi)`` sub-window of its replay rows
    (the ``record_requests=True`` rows a LoadGenerator returns). None when
    the arm offered no traffic in the window."""
    in_w = [r for r in rows if lo <= r["t"] < hi]
    if not in_w:
        return None
    ok = [r for r in in_w if r["outcome"] == "200"]
    good = sum(1 for r in ok if r["latency_ms"] <= threshold_ms)
    att = good / len(in_w)
    burn = (1.0 - att) / max(1e-9, 1.0 - target)
    return {
        "offered": len(in_w),
        "availability": len(ok) / len(in_w),
        "p99_ms": _p99([r["latency_ms"] for r in ok]),
        "attainment": round(att, 6),
        "burn": round(burn, 3),
    }


def paired_canary_windows(baseline_rows: Sequence[dict],
                          candidate_rows: Sequence[dict],
                          duration_s: float, window_s: float,
                          threshold_ms: float, target: float) -> List[dict]:
    """Chop the two arms' replay rows into aligned sub-windows and compute
    the PAIRED stats the canary gate judges: per-arm availability and burn,
    candidate/baseline p99 ratio, and burn excess. Windows where either arm
    offered no traffic carry ``None`` for the paired numbers (the gate skips
    them — absence of evidence is not an SLO edge)."""
    out: List[dict] = []
    n = max(1, int(math.ceil(duration_s / max(1e-9, window_s))))
    for k in range(n):
        lo, hi = k * window_s, (k + 1) * window_s
        base = _arm_window(baseline_rows, lo, hi, threshold_ms, target)
        cand = _arm_window(candidate_rows, lo, hi, threshold_ms, target)
        ratio = excess = None
        if base is not None and cand is not None:
            if base.get("p99_ms") and cand.get("p99_ms") is not None:
                ratio = round(cand["p99_ms"] / base["p99_ms"], 3)
            excess = round(cand["burn"] - base["burn"], 3)
        out.append({"window": k, "start_s": lo,
                    "baseline": base, "candidate": cand,
                    "latency_ratio": ratio, "burn_excess": excess})
    return out


def judge_canary_windows(windows: Sequence[dict],
                         rules: Sequence[AlertRule],
                         registry: Optional[MetricsRegistry] = None
                         ) -> Dict[str, object]:
    """Feed the paired windows through a fresh AlertEngine, one evaluation
    per sub-window (``for_duration`` therefore means consecutive WINDOWS),
    and return the verdict: ``{"ok": bool, "fired": [...], "windows": N,
    "judged": M}``. ``fired`` rows carry the rule, the window index and the
    offending value — the audit evidence a rollback points at."""
    from .alerts import AlertEngine

    r = registry if registry is not None else MetricsRegistry()
    m = deploy_metrics(r)
    engine = AlertEngine(rules=tuple(rules), registry=r)
    fired: List[dict] = []
    judged = 0
    for w in windows:
        base, cand = w.get("baseline"), w.get("candidate")
        if base is None or cand is None:
            continue  # no paired evidence in this window
        judged += 1
        m.canary_availability.labels("baseline").set(base["availability"])
        m.canary_availability.labels("candidate").set(cand["availability"])
        m.canary_burn.labels("baseline").set(base["burn"])
        m.canary_burn.labels("candidate").set(cand["burn"])
        if w.get("latency_ratio") is not None:
            m.canary_latency_ratio.set(w["latency_ratio"])
        if w.get("burn_excess") is not None:
            m.canary_burn_excess.set(w["burn_excess"])
        for a in engine.evaluate():
            if a["firing"]:
                fired.append({"rule": a["rule"], "window": w["window"],
                              "value": a["value"],
                              "threshold": a["threshold"],
                              "severity": a["severity"]})
    return {"ok": not fired, "fired": fired,
            "windows": len(windows), "judged": judged}
