"""Fault-isolated trial fleets: a PBT/ASHA meta-supervisor.

Counterpart of the JAX package's ``arbiter/fleet.py``, with its API, journal
format, flight events and metric families. ``TrialFleet`` runs N trial
gangs — each one candidate from the ``arbiter.optimize`` generators,
trained rung-by-rung by a per-trial ``GangSupervisor`` — with:

- **ASHA-style rung barriers**: every surviving trial trains to the rung's
  iteration budget, scores land in the SHARED metrics spool
  (``tdl_trial_score{trial}``), and the barrier keeps the top
  ``1/reduction`` of the cohort; the rest are demoted. The barrier is
  BOUNDED: a straggler or wedged trial past the rung deadline is demoted,
  never waited for.
- **PBT exploit/explore**: at each barrier the bottom quantile of the
  survivors clones a top-quantile winner's newest VERIFIED committed
  checkpoint generation into its own lineage
  (:func:`serde.checkpoint.clone_generation` — a suffixed-sibling
  re-save, so the clone lands as ``gen-<iter>a`` and the loser's plain
  restore walk picks it up), with hyperparameters perturbed under a seed
  derived from ``(fleet seed, rung, loser)`` — deterministic across
  resumes. A clone source failing deep verify is quarantined
  (``*.corrupt``) and the clone falls back to the winner's previous
  committed generation; when nothing verifies the loser keeps its own
  weights (``outcome="failed"``) — the sweep NEVER aborts on a corrupt
  winner.
- **Fault isolation**: per-trial restart budgets with exponential backoff
  on top of the gang supervisor's own; a trial exhausting its budget is
  quarantined (reason ``crash_budget``, or ``wedged`` when the gang died
  hanging) and the sweep continues without it.
- **Durable journal**: every terminal decision and score is journaled to
  ``fleet_state.json`` via fsync-then-rename (``common/durability``)
  BEFORE the sweep moves on, so a SIGKILLed meta-supervisor re-entering
  ``run()`` resumes mid-rung: journaled scores are not re-run, journaled
  rung verdicts are not recomputed, and the deterministic verdict/PBT
  seeds make the resumed sweep reach the same decisions the unkilled one
  would have.
- **Bounded disk**: each trial worker's checkpointer GCs its own lineage
  (keep-last-K); the fleet additionally collapses demoted/quarantined
  trials' lineages to one generation at every barrier and publishes the
  total under ``tdl_fleet_disk_bytes``.

Execution is pluggable: the ``runner`` callable
``(slot, target_iter, timeout_s) -> score`` defaults to
:class:`GangTrialRunner` (real subprocess gangs through
``parallel.supervisor``); tests drive the fleet logic with in-process
runners. The scheduler never cares which.

Two deliberate differences from the JAX package: the default gang target
(:data:`WORKER_TARGET`) is the port's ``trial_train``, and
:class:`GangTrialRunner` runs its gangs on the card (``platform="cuda"``,
one NCCL rank per trial process, up to ``max_concurrent`` of them sharing
one card) unless asked for the CPU; ``from_config`` passes the config's
``platform`` through unchanged. The verdicts are the JAX package's: the
same seed draws the same candidates, and the derived PBT streams
(:meth:`TrialFleet._rs`), the tie-break on trial id and the perturbation
factors are copies, so the same scores give the same journal.
"""

from __future__ import annotations

import json
import logging
import math
import os
import shutil
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..common import faults
from ..common.durability import durable_write_json
from ..monitoring import aggregate, flight
from ..monitoring.registry import MetricsRegistry, get_registry
from ..monitoring.trial import set_trial_state, trial_metrics
from ..serde.checkpoint import (CheckpointVerifyError, clone_generation,
                                lineage_state, quarantine_generation)

log = logging.getLogger(__name__)

STATE_FILE = "fleet_state.json"

#: worker target every default trial gang runs
WORKER_TARGET = "deeplearning4j_tpu_torch.arbiter.trial_worker:trial_train"


class TrialStraggler(RuntimeError):
    """A trial run exceeded the rung deadline — demotion, not a retry."""


class TrialRunFailed(RuntimeError):
    """A trial run finished without producing a fresh spooled score."""


@dataclass
class TrialSlot:
    """One trial's slot in the fleet — id, hyperparameters, lineage."""

    trial_id: str
    hparams: Dict
    workdir: str
    ckpt_dir: str
    status: str = "pending"   # monitoring.trial.TRIAL_STATES
    rung: int = 0
    scores: Dict[str, float] = field(default_factory=dict)
    restarts: int = 0
    quarantine_reason: Optional[str] = None
    cloned_from: Optional[str] = None

    def to_json(self) -> Dict:
        return {"trial_id": self.trial_id, "hparams": self.hparams,
                "status": self.status, "rung": self.rung,
                "scores": self.scores, "restarts": self.restarts,
                "quarantine_reason": self.quarantine_reason,
                "cloned_from": self.cloned_from}


def _slot_from_json(d: Dict, workdir: str) -> TrialSlot:
    tid = d["trial_id"]
    tdir = os.path.join(workdir, "trials", tid)
    return TrialSlot(
        trial_id=tid, hparams=dict(d["hparams"]), workdir=tdir,
        ckpt_dir=os.path.join(tdir, "ckpt"), status=d.get("status", "pending"),
        rung=int(d.get("rung", 0)), scores=dict(d.get("scores", {})),
        restarts=int(d.get("restarts", 0)),
        quarantine_reason=d.get("quarantine_reason"),
        cloned_from=d.get("cloned_from"))


def spooled_scores(spool_dir: str, registry=None) -> Dict[str, Tuple[int, float]]:
    """``{trial: (iteration, score)}`` from the shared metrics spool — the
    rung barrier's ONLY score source for gang-run trials. The iteration
    gauge rides along so a stale spool from an earlier rung is
    distinguishable from this rung's verdict."""
    out: Dict[str, Tuple[int, float]] = {}
    for payload in aggregate.read_spools(spool_dir, registry=registry):
        snap = payload.get("snapshot") or {}

        def series(family: str) -> Dict[str, float]:
            fam = snap.get(family) or {}
            return {s.get("labels", {}).get("trial"): float(s.get("value", 0))
                    for s in fam.get("series", [])}

        iters = series("tdl_trial_iteration")
        for trial, score in series("tdl_trial_score").items():
            if trial is None:
                continue
            it = int(iters.get(trial, -1))
            cur = out.get(trial)
            if cur is None or it >= cur[0]:
                out[trial] = (it, score)
    return out


class GangTrialRunner:
    """The default trial execution engine: one rung of one trial = one
    single-process ``GangSupervisor`` gang over the trial-worker target,
    with trial-scoped env (hparams, lineage, rung budget), the fleet's
    SHARED spool/flight/compile-cache dirs, and a per-trial proc prefix so
    N gangs stay distinguishable in one merged scrape. The score comes
    back from the spool — if the gang exits without a fresh
    ``tdl_trial_score`` at the rung's iteration, the run FAILED regardless
    of its exit status. ``platform`` is the card (``cuda``) unless the
    caller asks for the CPU: on a host with no card the gang raises before
    any process starts."""

    def __init__(self, fleet_workdir: str, task_spec: Optional[Dict] = None,
                 *, n_local_devices: int = 1, platform: str = "cuda",
                 gang_max_restarts: int = 2, hang_timeout: float = 30.0,
                 startup_grace: float = 240.0, keep_last: int = 2,
                 target: str = WORKER_TARGET,
                 fault_spec_for: Optional[Callable[[TrialSlot], str]] = None):
        self.fleet_workdir = fleet_workdir
        self.task_spec = dict(task_spec or {"kind": "synth_classify"})
        self.n_local_devices = n_local_devices
        self.platform = platform
        self.gang_max_restarts = gang_max_restarts
        self.hang_timeout = hang_timeout
        self.startup_grace = startup_grace
        self.keep_last = keep_last
        self.target = target
        #: per-trial chaos hook: return a TDL_FAULT_SPEC for this slot
        self.fault_spec_for = fault_spec_for
        self.spool_dir = os.path.join(fleet_workdir, "spool")
        self.flight_dir = os.path.join(fleet_workdir, "flight")
        self.compile_cache_dir = os.path.join(fleet_workdir, "compile_cache")

    def __call__(self, slot: TrialSlot, target_iter: int,
                 timeout_s: float) -> float:
        from ..common import compile_cache
        from ..parallel.supervisor import GangSupervisor

        extra = {
            "TDL_TRIAL_ID": slot.trial_id,
            "TDL_TRIAL_HPARAMS": json.dumps(slot.hparams),
            "TDL_TRIAL_CKPT": slot.ckpt_dir,
            "TDL_TRIAL_TARGET_ITER": str(int(target_iter)),
            "TDL_TRIAL_KEEP_LAST": str(self.keep_last),
            "TDL_TRIAL_TASK": json.dumps(self.task_spec),
            # ONE spool/flight plane for the whole fleet: per-trial proc
            # prefixes keep identities apart, the merged scrape shows all
            aggregate.ENV_DIR: self.spool_dir,
            flight.ENV_DIR: self.flight_dir,
            # one kernel-build cache for the sweep: later trials load what
            # the first one built
            compile_cache.ENV_DIR: self.compile_cache_dir,
        }
        if self.fault_spec_for is not None:
            spec = self.fault_spec_for(slot)
            if spec:
                extra[faults.ENV_SPEC] = spec
        sup = GangSupervisor(
            self.target, n_processes=1,
            n_local_devices=self.n_local_devices, platform=self.platform,
            workdir=os.path.join(slot.workdir, f"r{int(target_iter)}"),
            extra_env=extra, max_restarts=self.gang_max_restarts,
            hang_timeout=self.hang_timeout,
            startup_grace=self.startup_grace,
            backoff_base=0.2, backoff_max=2.0,
            ckpt_dir=slot.ckpt_dir, proc_prefix=f"{slot.trial_id}-")
        sup.run(timeout=max(1.0, timeout_s))
        got = spooled_scores(self.spool_dir).get(slot.trial_id)
        if got is None or got[0] < int(target_iter):
            raise TrialRunFailed(
                f"{slot.trial_id}: gang exited without a fresh spooled "
                f"score at iteration {target_iter} (got {got})")
        return got[1]


class TrialFleet:
    """The meta-supervisor (module docstring). ``run()`` drives every rung
    to a verdict and returns the promoted winner."""

    def __init__(self, generator, runner: Optional[Callable] = None, *,
                 workdir: str, n_trials: int = 8,
                 rungs: Tuple[int, ...] = (4, 8, 16), reduction: int = 2,
                 pbt: bool = True, pbt_quantile: float = 0.25,
                 minimize: bool = False, rung_timeout_s: float = 600.0,
                 trial_max_restarts: int = 2, backoff_base_s: float = 0.5,
                 backoff_max_s: float = 10.0, max_concurrent: int = 4,
                 seed: int = 0, spaces: Optional[Dict] = None,
                 pbt_mutable: Optional[Tuple[str, ...]] = None,
                 registry: Optional[MetricsRegistry] = None):
        if not rungs or list(rungs) != sorted(set(int(r) for r in rungs)):
            raise ValueError(f"rungs must be strictly increasing, got {rungs}")
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.generator = generator
        self.runner = runner if runner is not None \
            else GangTrialRunner(workdir)
        self.n_trials = int(n_trials)
        self.rungs = tuple(int(r) for r in rungs)
        self.reduction = max(2, int(reduction))
        self.pbt = bool(pbt)
        self.pbt_quantile = float(pbt_quantile)
        self.minimize = bool(minimize)
        self.rung_timeout_s = float(rung_timeout_s)
        self.trial_max_restarts = int(trial_max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.max_concurrent = max(1, int(max_concurrent))
        self.seed = int(seed)
        #: the generator's spaces (perturbation clamps into their bounds);
        #: defaults to the generator's own dict when it has one
        self.spaces = spaces if spaces is not None \
            else getattr(generator, "spaces", None)
        #: hyperparameter keys PBT explore may perturb. ``None`` (default)
        #: means "every float" — integer and categorical hyperparameters
        #: usually change weight SHAPES (layer widths, kernel counts), and
        #: a cloned checkpoint only loads into the winner's architecture,
        #: so they are inherited verbatim unless explicitly whitelisted
        self.pbt_mutable = tuple(pbt_mutable) if pbt_mutable is not None \
            else None
        self.registry = registry if registry is not None else get_registry()
        self._m = trial_metrics(self.registry)
        self.state_path = os.path.join(workdir, STATE_FILE)
        self.spool_dir = os.path.join(workdir, "spool")
        self.flight_dir = os.path.join(workdir, "flight")
        self._own_recorder: Optional[flight.FlightRecorder] = None
        if not flight.active():
            # unattended means self-recording, exactly like the deploy
            # controller: without a supervising TDL_FLIGHT_DIR the fleet
            # installs its own spool so every decision reaches the audit
            self._own_recorder = flight.FlightRecorder(
                proc="fleet", directory=self.flight_dir, interval=0.0)
            flight.set_flight_recorder(self._own_recorder)
        # one lock over journal + flight spooling: trials finish on worker
        # threads, and both durable_write_json and the recorder's flush
        # rename a pid-derived tmp name — concurrent writers would race
        # each other's os.replace
        self._lock = threading.RLock()
        self.trials: Dict[str, TrialSlot] = {}
        self.state = self._load_state()
        self._adopt_or_draw_trials()

    # -- durable journal ----------------------------------------------------

    def _load_state(self) -> Dict:
        try:
            with open(self.state_path) as f:
                st = json.load(f)
            log.info("fleet resumed from %s (%d trials journaled)",
                     self.state_path, len(st.get("trials", {})))
            st["resumed"] = True
            return st
        except (OSError, ValueError):
            return {"version": 1, "seed": self.seed, "rungs": list(self.rungs),
                    "minimize": self.minimize, "trials": {}, "verdicts": {},
                    "winner": None, "journal": [], "resumed": False}

    def _save_state(self) -> None:
        with self._lock:
            self.state["trials"] = {tid: t.to_json()
                                    for tid, t in self.trials.items()}
            durable_write_json(self.state_path, self.state)

    def _journal(self, kind: str, **fields) -> None:
        """One audit row, durably on disk BEFORE the sweep acts on it."""
        with self._lock:
            row = {"kind": kind,
                   "wall": time.time(),  # wallclock-ok: audit timestamp
                   **fields}
            self.state.setdefault("journal", []).append(row)
            self._save_state()

    def _record(self, kind: str, **fields) -> None:
        """flight.record, serialized: with ``interval=0.0`` every record
        flushes the spool, and concurrent flushes from trial worker threads
        would race on the recorder's tmp-file rename."""
        with self._lock:
            flight.record(kind, **fields)

    # -- trial population ---------------------------------------------------

    def _adopt_or_draw_trials(self) -> None:
        journaled = self.state.get("trials") or {}
        if journaled:
            # resume: the journal owns the population — candidates are NOT
            # re-drawn (the generator's stream has moved on; re-drawing
            # would silently run a different sweep than the one that died)
            for tid, d in sorted(journaled.items()):
                self.trials[tid] = _slot_from_json(d, self.workdir)
            return
        from .optimize import GeneratorExhausted

        width = max(2, len(str(max(0, self.n_trials - 1))))
        for i in range(self.n_trials):
            if not self.generator.has_more():
                log.warning("candidate generator exhausted at %d of %d "
                            "requested trials; running the smaller sweep",
                            i, self.n_trials)
                break
            try:
                cand = self.generator.next_candidate()
            except GeneratorExhausted:
                break
            tid = f"t{i:0{width}d}"
            tdir = os.path.join(self.workdir, "trials", tid)
            os.makedirs(tdir, exist_ok=True)
            slot = TrialSlot(trial_id=tid, hparams=dict(cand), workdir=tdir,
                             ckpt_dir=os.path.join(tdir, "ckpt"))
            self.trials[tid] = slot
            self._set_state(slot, "pending")
        self._save_state()

    def _set_state(self, slot: TrialSlot, status: str) -> None:
        slot.status = status
        set_trial_state(self._m, slot.trial_id, status)

    # -- deterministic derived RNG ------------------------------------------

    def _rs(self, *key) -> np.random.RandomState:
        """A RandomState derived from (fleet seed, key...) — NOT a shared
        mutable stream: a resumed fleet replaying only the tail of a rung
        must draw the same perturbations/pairings the unkilled one did."""
        h = 0x811C9DC5
        for part in (self.seed,) + key:
            for b in str(part).encode():
                h = ((h ^ b) * 0x01000193) & 0x7FFFFFFF
        return np.random.RandomState(h)

    # -- scoring helpers ----------------------------------------------------

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.minimize else a > b

    def _sort_key(self, rung: int):
        sign = 1.0 if self.minimize else -1.0

        def key(t: TrialSlot):
            # total order: score then trial id — two trials tying on score
            # must rank identically no matter which finished first
            return (sign * t.scores[str(rung)], t.trial_id)
        return key

    def _report_to_generator(self, slot: TrialSlot) -> None:
        if not slot.scores:
            return
        last = slot.scores[str(max(int(k) for k in slot.scores))]
        score = last if self.minimize else -last
        try:
            self.generator.report_score(slot.hparams, score)
        except Exception:
            log.exception("generator.report_score failed for %s",
                          slot.trial_id)

    # -- trial-terminal decisions (AST-linted: each records its flight
    # -- event before any return — tests/test_torch_fleet.py) ---------------

    def _quarantine_trial(self, slot: TrialSlot, rung: int, reason: str,
                          detail: str = "") -> None:
        """Remove a repeatedly-failing trial from the sweep — the sweep
        itself continues. Reasons: ``crash_budget`` (restart budget
        exhausted), ``wedged`` (its gang kept hanging), ``clone_source``
        (every generation of this winner failed clone verification)."""
        self._set_state(slot, "quarantined")
        slot.quarantine_reason = reason
        self._m.quarantined.labels(reason).inc()
        self._record("trial_quarantine", trial=slot.trial_id, rung=rung,
                      reason=reason, detail=detail[:200],
                      restarts=slot.restarts)
        self._journal("quarantine", trial=slot.trial_id, rung=rung,
                      reason=reason, detail=detail[:200])
        self._report_to_generator(slot)
        log.warning("trial %s quarantined at rung %d (%s) %s",
                    slot.trial_id, rung, reason, detail[:200])

    def _demote_trial(self, slot: TrialSlot, rung: int, reason: str) -> None:
        """ASHA early stop: the trial leaves the cohort (``asha_cut``), blew
        the rung deadline (``straggler``), or lost the final ranking
        (``final_cut``). Its lineage collapses to one generation at the
        next GC pass."""
        self._set_state(slot, "demoted")
        self._record("trial_demote", trial=slot.trial_id, rung=rung,
                      reason=reason, score=slot.scores.get(str(rung)))
        self._journal("demote", trial=slot.trial_id, rung=rung, reason=reason)
        self._report_to_generator(slot)

    def _clone_into_slot(self, loser: TrialSlot, winner: TrialSlot,
                         rung: int) -> str:
        """PBT exploit/explore: commit the winner's newest VERIFIED
        generation into the loser's lineage and perturb the loser's
        hyperparameters. Walks the winner's committed generations newest-
        first; a source failing deep verify is quarantined and the walk
        falls back (``outcome="fallback"``). Nothing verifying →
        ``outcome="failed"`` and the loser keeps its own weights. Returns
        the outcome string."""
        inv = lineage_state(winner.ckpt_dir)
        gens = [g["generation"] for g in reversed(inv["committed"])]
        outcome, generation, quarantined = "failed", None, []
        for idx, gen in enumerate(gens):
            src = os.path.join(winner.ckpt_dir, "latest", gen)
            # chaos hook: corrupt_clone bit-flips THIS source pre-verify
            faults.fault_point("trial_clone", iteration=rung, path=src)
            try:
                got = clone_generation(src, loser.ckpt_dir,
                                       registry=self.registry)
            except CheckpointVerifyError as e:
                reason = getattr(e, "reason", "unknown")
                quarantine_generation(src, reason, registry=self.registry)
                quarantined.append({"generation": gen, "reason": reason})
                continue
            except OSError as e:
                # clone write failed (ENOSPC and kin): the loser keeps its
                # own weights; never abort the sweep over one clone
                quarantined.append({"generation": gen, "error": str(e)})
                break
            outcome = "ok" if idx == 0 else "fallback"
            generation = got["generation"]
            break
        old_hp = dict(loser.hparams)
        if outcome != "failed":
            loser.hparams = self._perturb(winner.hparams,
                                          self._rs("pbt", rung,
                                                   loser.trial_id))
            loser.cloned_from = f"{winner.trial_id}/{generation}"
            # exploit means ABANDONING the loser's own weights: its own
            # generations are stale (and, with perturbed hyperparameters,
            # possibly shape-incompatible) — a fallback clone can even be
            # OLDER than the loser's own newest, which would outrank the
            # clone on restore. Keep only the clone.
            self._retire_all_but(loser, generation)
        self._m.clones.labels(outcome).inc()
        self._record("trial_clone", trial=loser.trial_id,
                      source=winner.trial_id, rung=rung, outcome=outcome,
                      generation=generation, quarantined=quarantined)
        self._journal("clone", trial=loser.trial_id, source=winner.trial_id,
                      rung=rung, outcome=outcome, generation=generation,
                      quarantined=quarantined, old_hparams=old_hp,
                      new_hparams=dict(loser.hparams))
        if quarantined and outcome == "failed" \
                and len(quarantined) == len(gens) and gens:
            # every generation of this winner is corrupt: the winner itself
            # can no longer be trusted as a clone source or a finalist
            self._quarantine_trial(winner, rung, "clone_source",
                                   detail=json.dumps(quarantined)[:200])
        return outcome

    def _promote_winner(self, slot: TrialSlot, score: float) -> Dict:
        """The sweep's terminal decision: the final ranking's best trial
        becomes THE winner (state ``winner``, ``trial_promote`` event,
        journaled with its lineage pointer for the operator)."""
        self._set_state(slot, "winner")
        inv = lineage_state(slot.ckpt_dir)
        winner = {"trial": slot.trial_id, "score": score,
                  "hparams": {k: v for k, v in slot.hparams.items()
                              if k != "__id__"},
                  "ckpt_dir": slot.ckpt_dir,
                  "generation": inv.get("newest_committed")}
        self._record("trial_promote", trial=slot.trial_id,
                      score=round(float(score), 6),
                      generation=winner["generation"])
        self.state["winner"] = winner
        self._journal("promote", **winner)
        return winner

    # -- PBT explore --------------------------------------------------------

    def _perturb(self, hparams: Dict, rs: np.random.RandomState) -> Dict:
        """Explore step over the WINNER's hyperparameters: mutable numeric
        values x0.8 / x1.25 (clamped into the generator's space bounds when
        known), mutable categoricals resampled with p=0.25; everything
        outside ``pbt_mutable`` (default: non-floats — see __init__) is
        inherited verbatim so the cloned weights still fit the net. ``rs``
        is derived per (seed, rung, loser) so a resumed fleet perturbs
        identically."""
        out = {}
        for k, v in hparams.items():
            if k == "__id__":
                continue
            mutable = (k in self.pbt_mutable
                       if self.pbt_mutable is not None
                       else isinstance(v, float) and not isinstance(v, bool))
            if not mutable:
                out[k] = v
                continue
            space = (self.spaces or {}).get(k)
            if isinstance(v, bool) or isinstance(v, str):
                if space is not None and rs.rand() < 0.25:
                    out[k] = space.value(float(rs.rand()))
                else:
                    out[k] = v
            elif isinstance(v, (int, float)):
                nv = float(v) * float(rs.choice((0.8, 1.25)))
                if space is not None:
                    lo, hi = space.value(0.0), space.value(1.0 - 1e-9)
                    if isinstance(lo, (int, float)):
                        nv = min(max(nv, float(lo)), float(hi))
                out[k] = int(round(nv)) if isinstance(v, int) else float(nv)
            else:
                out[k] = v
        return out

    # -- rung execution -----------------------------------------------------

    def _run_trial(self, slot: TrialSlot, rung: int,
                   deadline: float) -> None:
        """One trial's attempt(s) at one rung, inside the rung deadline:
        retries with exponential backoff up to the fleet-level budget, then
        quarantines; a deadline overrun demotes (straggler) instead of
        stalling the barrier."""
        target = self.rungs[rung]
        self._set_state(slot, "running")
        self._record("trial_spawn", trial=slot.trial_id, rung=rung,
                      target_iter=target, restarts=slot.restarts)
        attempt = 0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._demote_trial(slot, rung, "straggler")
                return
            try:
                score = float(self.runner(slot, target, remaining))
            except Exception as e:  # noqa: BLE001 — every failure mode of a
                # trial lands here; classification decides its fate
                classification = getattr(e, "classification", None)
                if isinstance(e, TrialStraggler) \
                        or classification == "timeout":
                    self._demote_trial(slot, rung, "straggler")
                    return
                attempt += 1
                slot.restarts += 1
                if attempt > self.trial_max_restarts:
                    reason = "wedged" if classification == "hang" \
                        else "crash_budget"
                    self._quarantine_trial(slot, rung, reason, detail=str(e))
                    return
                backoff = min(self.backoff_max_s,
                              self.backoff_base_s * (2 ** (attempt - 1)))
                log.warning("trial %s rung %d attempt %d failed (%s); "
                            "backing off %.2fs", slot.trial_id, rung,
                            attempt, e, backoff)
                time.sleep(min(backoff,
                               max(0.0, deadline - time.monotonic())))
                continue
            slot.scores[str(rung)] = score
            self._set_state(slot, "waiting")
            sc = self._m.score.labels(slot.trial_id)
            sc.set(score if not self.minimize else -score)
            # fleet-side mirror of the worker's iteration gauge: a runner
            # that returned is AT the rung target by contract, so the
            # meta-supervisor's own scrape carries (score, iteration) pairs
            # even when the runner is in-process (no spool to merge)
            self._m.iteration.labels(slot.trial_id).set(float(target))
            self._journal("score", trial=slot.trial_id, rung=rung,
                          score=score, restarts=slot.restarts)
            return

    def _rung_cohort(self, rung: int) -> List[TrialSlot]:
        return [t for t in sorted(self.trials.values(),
                                  key=lambda s: s.trial_id)
                if t.status not in ("demoted", "quarantined")
                and t.rung == rung]

    def _run_rung(self, rung: int) -> None:
        cohort = self._rung_cohort(rung)
        todo = [t for t in cohort if str(rung) not in t.scores]
        deadline = time.monotonic() + self.rung_timeout_s
        if todo:
            with ThreadPoolExecutor(
                    max_workers=min(self.max_concurrent, len(todo)),
                    thread_name_prefix="trial") as ex:
                futs = [ex.submit(self._run_trial, t, rung, deadline)
                        for t in todo]
                for f in futs:
                    f.result()  # _run_trial never raises; surface bugs loudly
        self._apply_verdict(rung)

    def _apply_verdict(self, rung: int) -> None:
        """The rung barrier: rank the scored survivors, demote the ASHA
        cut, PBT-clone winners into surviving losers, promote the rest.
        Deterministic from the journaled scores — a resumed fleet reaches
        the identical verdict."""
        scored = [t for t in self._rung_cohort(rung)
                  if str(rung) in t.scores]
        scored.sort(key=self._sort_key(rung))
        final = rung == len(self.rungs) - 1
        if not final and len(scored) > 1:
            keep = max(1, int(math.ceil(len(scored) / self.reduction)))
        else:
            keep = len(scored)
        survivors, cut = scored[:keep], scored[keep:]
        clones = []
        for t in cut:
            self._demote_trial(t, rung, "asha_cut")
        if self.pbt and not final and len(survivors) >= 3:
            q = max(1, int(len(survivors) * self.pbt_quantile))
            winners, losers = survivors[:q], survivors[-q:]
            rs = self._rs("pbt-pairing", rung)
            for loser in losers:
                winner = winners[int(rs.randint(len(winners)))]
                if winner.trial_id == loser.trial_id:
                    continue
                outcome = self._clone_into_slot(loser, winner, rung)
                clones.append({"loser": loser.trial_id,
                               "winner": winner.trial_id,
                               "outcome": outcome})
        promoted = []
        for t in survivors:
            if t.status == "quarantined":
                continue  # a clone-source quarantine can hit a survivor
            if not final:
                t.rung = rung + 1
                self._m.rung_promotions.inc()
                self._record("trial_rung_promote", trial=t.trial_id,
                              from_rung=rung, to_rung=rung + 1,
                              score=t.scores.get(str(rung)))
            promoted.append(t.trial_id)
        self.state.setdefault("verdicts", {})[str(rung)] = {
            "promoted": promoted,
            "demoted": [t.trial_id for t in cut],
            "clones": clones,
        }
        self._journal("rung_verdict", rung=rung, promoted=promoted,
                      demoted=[t.trial_id for t in cut], clones=clones)
        self._gc_and_measure()

    # -- disk ---------------------------------------------------------------

    def _retire_all_but(self, slot: TrialSlot, keep: str) -> None:
        """Remove every generation of ``slot``'s lineage except ``keep``
        (the just-landed PBT clone): the slot's next restore must see the
        clone and nothing that could outrank or shadow it."""
        lineage = os.path.join(slot.ckpt_dir, "latest")
        inv = lineage_state(slot.ckpt_dir)
        doomed = [g["generation"]
                  for g in inv["committed"] + inv["uncommitted"]
                  if g["generation"] != keep]
        for name in doomed:
            try:
                shutil.rmtree(os.path.join(lineage, name))
            except OSError as e:
                log.warning("could not retire %s/%s after clone: %s",
                            lineage, name, e)

    def _gc_lineage(self, slot: TrialSlot) -> None:
        """Collapse a finished trial's lineage to its newest committed
        generation (evidence dirs — ``*.corrupt`` — are kept: bounded, one
        per quarantine event, and the audit trail points at them)."""
        lineage = os.path.join(slot.ckpt_dir, "latest")
        inv = lineage_state(slot.ckpt_dir)
        keep = inv.get("newest_committed")
        doomed = [g["generation"] for g in inv["committed"]
                  if g["generation"] != keep]
        doomed += [g["generation"] for g in inv["uncommitted"]]
        for name in doomed:
            try:
                shutil.rmtree(os.path.join(lineage, name))
            except OSError as e:
                log.warning("fleet GC could not retire %s/%s: %s",
                            lineage, name, e)

    def _gc_and_measure(self) -> None:
        for t in self.trials.values():
            if t.status in ("demoted", "quarantined", "done"):
                self._gc_lineage(t)
        total = 0
        for root, _, files in os.walk(self.workdir):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(root, f))
                except OSError:
                    pass
        self._m.disk_bytes.set(float(total))
        self.state["disk_bytes"] = total

    # -- the sweep ----------------------------------------------------------

    def run(self) -> Dict:
        """Drive every rung to a verdict; returns the winner dict
        ``{trial, score, hparams, ckpt_dir, generation}``. Re-entrant: a
        resumed fleet skips journaled scores and verdicts and finishes the
        sweep the dead incarnation started."""
        if self.state.get("winner"):
            return self.state["winner"]
        verdicts = self.state.get("verdicts") or {}
        for rung in range(len(self.rungs)):
            if str(rung) in verdicts:
                continue  # journaled barrier: decided, never recomputed
            self._run_rung(rung)
        last = len(self.rungs) - 1
        finalists = [t for t in self._rung_cohort(last)
                     if str(last) in t.scores]
        if not finalists:
            # every trial crashed/straggled out — surface the empty sweep
            # rather than inventing a winner
            self._journal("exhausted", rung=last)
            raise RuntimeError(
                "trial fleet finished with no surviving scored trial — "
                f"see {self.state_path} and the flight spool in "
                f"{self.flight_dir}")
        finalists.sort(key=self._sort_key(last))
        best = finalists[0]
        for t in finalists[1:]:
            self._set_state(t, "done")
            self._report_to_generator(t)
        winner = self._promote_winner(best, best.scores[str(last)])
        self._report_to_generator(best)
        self._gc_and_measure()
        return winner

    def close(self) -> None:
        if self._own_recorder is not None:
            self._own_recorder.flush()
            flight.set_flight_recorder(None)
            self._own_recorder = None


# -- unattended CLI ----------------------------------------------------------


def from_config(path: str) -> TrialFleet:
    """Build a gang-runner fleet from a JSON config — the unattended /
    SIGKILL-resume entry point (``python -m
    deeplearning4j_tpu_torch.arbiter.fleet config.json``). Config keys:
    ``workdir``, ``task`` (trial_worker task spec), ``spaces`` ({name:
    {kind: continuous|integer|discrete, ...}}), ``generator``
    (random|grid|genetic), the gang runner's ``platform`` (default
    ``cuda``), ``gang_max_restarts``, ``hang_timeout``, ``keep_last`` and
    ``n_local_devices``, plus any TrialFleet kwarg."""
    from .optimize import (ContinuousParameterSpace, DiscreteParameterSpace,
                           GeneticSearchCandidateGenerator,
                           GridSearchCandidateGenerator,
                           IntegerParameterSpace, RandomSearchGenerator)

    with open(path) as f:
        cfg = json.load(f)
    spaces = {}
    for name, sd in (cfg.get("spaces") or {}).items():
        kind = sd.get("kind", "continuous")
        if kind == "continuous":
            spaces[name] = ContinuousParameterSpace(
                sd["lo"], sd["hi"], log_scale=bool(sd.get("log_scale")))
        elif kind == "integer":
            spaces[name] = IntegerParameterSpace(sd["lo"], sd["hi"])
        elif kind == "discrete":
            spaces[name] = DiscreteParameterSpace(sd["values"])
        else:
            raise ValueError(f"unknown space kind {kind!r} for {name!r}")
    gen_kind = cfg.get("generator", "random")
    seed = int(cfg.get("seed", 0))
    if gen_kind == "random":
        generator = RandomSearchGenerator(spaces, seed=seed)
    elif gen_kind == "grid":
        generator = GridSearchCandidateGenerator(
            spaces, discretization_count=int(cfg.get("discretization", 3)),
            seed=seed)
    elif gen_kind == "genetic":
        generator = GeneticSearchCandidateGenerator(spaces, seed=seed)
    else:
        raise ValueError(f"unknown generator {gen_kind!r}")
    workdir = cfg["workdir"]
    runner = GangTrialRunner(
        workdir, cfg.get("task"),
        **{k: cfg[k] for k in ("gang_max_restarts", "hang_timeout",
                               "keep_last", "platform", "n_local_devices")
           if k in cfg})
    fleet_kwargs = {k: cfg[k] for k in (
        "n_trials", "rungs", "reduction", "pbt", "pbt_quantile", "minimize",
        "rung_timeout_s", "trial_max_restarts", "backoff_base_s",
        "backoff_max_s", "max_concurrent", "pbt_mutable") if k in cfg}
    if "rungs" in fleet_kwargs:
        fleet_kwargs["rungs"] = tuple(fleet_kwargs["rungs"])
    return TrialFleet(generator, runner, workdir=workdir, seed=seed,
                      spaces=spaces, **fleet_kwargs)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="run an unattended PBT/ASHA trial fleet from a JSON "
                    "config (re-entrant: rerun after a kill to resume)")
    ap.add_argument("config", help="fleet config JSON")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    fleet = from_config(args.config)
    try:
        winner = fleet.run()
    finally:
        fleet.close()
    sys.stdout.write(json.dumps(winner) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
