"""Trial-fleet metric families (copy of the JAX package's
``monitoring.trial``, under the same names and labels).

One declaration site so :class:`~..arbiter.fleet.TrialFleet`, the trial
worker target and the OBSERVABILITY.md catalog agree on names and labels.

Fleet-side families (set by the meta-supervisor process)::

    tdl_trial_state{trial,state}        1 for the trial's CURRENT lifecycle
                                        state, 0 for every other state it has
                                        ever been in (same exclusive-gauge
                                        idiom as tdl_pool_replica_state);
                                        states: pending | running | waiting |
                                        demoted | quarantined | winner | done
    tdl_trial_rung_promotions_total     trials promoted past a rung barrier
    tdl_trial_quarantined_total{reason} trials removed from the sweep, by
                                        reason (crash_budget | clone_source |
                                        wedged)
    tdl_trial_clones_total{outcome}     PBT exploit clone attempts by outcome
                                        (ok | fallback | failed)
    tdl_fleet_disk_bytes                bytes currently on disk under the
                                        fleet's trial lineages + journal —
                                        the number lineage GC keeps bounded

Worker-side families (set inside each trial gang; they ride the shared
metrics spool into the fleet's merged scrape, where the ``trial`` label and
the trial-prefixed ``proc`` identity keep N gangs distinguishable)::

    tdl_trial_score{trial}              the trial's latest reported score
                                        (higher is better by fleet
                                        convention; the fleet negates when
                                        minimizing)
    tdl_trial_iteration{trial}          the iteration the score was measured
                                        at — the rung barrier refuses a
                                        stale score from an earlier rung
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

from .registry import MetricsRegistry, get_registry

#: every lifecycle state the exclusive state gauge emits — the fleet writes
#: 0s for all non-current states so one scrape shows exactly one 1 per trial
TRIAL_STATES = ("pending", "running", "waiting", "demoted", "quarantined",
                "winner", "done")


def trial_metrics(registry: Optional[MetricsRegistry] = None
                  ) -> SimpleNamespace:
    """Get-or-create the trial-fleet families on ``registry``."""
    r = registry if registry is not None else get_registry()
    return SimpleNamespace(
        state=r.gauge(
            "tdl_trial_state",
            "1 for the trial's current lifecycle state, 0 otherwise "
            "(pending|running|waiting|demoted|quarantined|winner|done)",
            labels=("trial", "state")),
        rung_promotions=r.counter(
            "tdl_trial_rung_promotions_total",
            "trials promoted past an ASHA rung barrier"),
        quarantined=r.counter(
            "tdl_trial_quarantined_total",
            "trials quarantined out of the sweep, by reason",
            labels=("reason",)),
        clones=r.counter(
            "tdl_trial_clones_total",
            "PBT exploit clone attempts by outcome (ok|fallback|failed)",
            labels=("outcome",)),
        disk_bytes=r.gauge(
            "tdl_fleet_disk_bytes",
            "bytes on disk under the fleet's trial lineages and journal "
            "(bounded by per-trial lineage GC)"),
        score=r.gauge(
            "tdl_trial_score",
            "latest reported trial score (higher is better; the fleet "
            "negates when minimizing)", labels=("trial",)),
        iteration=r.gauge(
            "tdl_trial_iteration",
            "iteration the trial's latest score was measured at",
            labels=("trial",)),
    )


def set_trial_state(m: SimpleNamespace, trial: str, state: str) -> None:
    """Exclusive state transition: 1 for ``state``, 0 for every other known
    state — a merged scrape then shows exactly one live state per trial."""
    if state not in TRIAL_STATES:
        raise ValueError(f"unknown trial state {state!r}")
    for s in TRIAL_STATES:
        m.state.labels(trial, s).set(1.0 if s == state else 0.0)
