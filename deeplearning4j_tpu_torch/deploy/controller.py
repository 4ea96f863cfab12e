"""Self-driving model lifecycle: watch a checkpoint lineage, drive every
newly COMMITTED generation through an ordered gate chain, and promote or
roll back — unattended.

Counterpart of ``deeplearning4j_tpu/deploy/controller.py``, with its API,
gates, durable state, flight events, ``tdl_deploy_*`` families and
``audit.json``. Gangs survive chaos and commit verified generations
(``parallel.supervisor``, ``serde.checkpoint``), ``swap_model`` rolls a pool
with zero downtime, the AlertEngine judges replayed traffic; the
:class:`FleetController` is their composition — one gate contract, many gate
implementations:

1. **integrity** — ``verify_checkpoint`` deep verify of the candidate
   generation; quarantine evidence (``*.corrupt`` renames) honored. Catches
   torn/bit-flipped artifacts for the price of a read, never a replica.
2. **eval** — offline metrics on a held-out iterator (any callable
   ``gen_dir -> metrics`` — return an :class:`eval.Evaluation` and its
   ``to_metrics`` hook puts the judged numbers on ``/metrics``), checked
   against absolute thresholds AND a regression band vs the
   currently-promoted generation. Catches valid-but-ruined weights (the
   ``loss_spike`` poison) no structural check can see.
3. **canary** — surge ONE replica on the candidate
   (``ServingPool.start_canary``: router-invisible, old fleet untouched)
   and replay the same seeded :class:`TraceSpec` against the canary and a
   baseline replica CONCURRENTLY; judge the paired per-window SLO stats
   (availability, burn, p99 ratio — ``monitoring/deploy.py``) with real
   :class:`AlertRule` ``for_duration``/hysteresis semantics. Catches what
   only live traffic can: latency/availability regressions that ship WITH
   the candidate.
4. **promote** — complete the rolling swap (``swap_model``: updates the
   pool's default overrides so scale-ups spawn the new version) on
   sustained-clear; ANY gate failure rolls back by killing only the surge.

Robustness is the headline:

- **durable resume** — controller state (per-candidate gate progress,
  verdicts, the promoted baseline) is written with
  ``common.durability.durable_write_json`` BEFORE and AFTER every gate; a
  SIGKILLed controller restarted on the same workdir re-enters the exact
  gate it died in and reaches the same terminal verdict.
- **bounded gates** — every gate runs under ``gate_timeout_s`` in its own
  thread; a wedged canary additionally hits ``start_canary``'s ready
  timeout. Timeout = rollback, never a hang.
- **retry before verdict** — exceptions escaping a gate (transient FS/eval
  errors) retry with exponential backoff; only after ``retries`` attempts
  do they count as a failing verdict.

Every decision is a flight event (``deploy_candidate`` / ``deploy_gate`` /
``deploy_promote`` / ``deploy_rollback`` — the AST lint in
tests/test_torch_controller.py proves no decision path forgets its
breadcrumb) and a ``tdl_deploy_*`` metric; every run rewrites a
postmortem-style ``audit.json`` (gate verdicts, evidence pointers, the
timeline artifact via ``monitoring/timeline.write_timeline``).

The controller holds no tensor and imports no torch: the eval callable and
the pool's replica targets decide the device (the card, unless they ask for
the CPU).

Subprocess mode (the unattended story end-to-end)::

    python -m deeplearning4j_tpu_torch.deploy.controller config.json --once

with a JSON config naming the lineage, the pool target, the trace and the
gate thresholds — see :func:`from_config`.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..common.durability import durable_write_json
from ..monitoring import flight
from ..monitoring.deploy import (canary_rules as default_canary_rules,
                                 deploy_metrics, judge_canary_windows,
                                 paired_canary_windows)
from ..monitoring.registry import MetricsRegistry, get_registry
from ..serde.checkpoint import lineage_state, verify_checkpoint

log = logging.getLogger(__name__)

#: the full gate chain, in order; configurable subsets keep the one-gate
#: contract (e.g. ``("integrity", "eval")`` for a controller without a pool)
GATE_CHAIN = ("integrity", "eval", "canary")

STATE_FILE = "controller_state.json"
AUDIT_FILE = "audit.json"


def _load_callable(spec: str) -> Callable:
    """``module:function`` or ``/path/to/file.py:function`` — the same two
    target forms pool replicas and launcher workers accept."""
    mod_name, _, fn_name = spec.rpartition(":")
    if mod_name.endswith(".py"):
        import importlib.util

        loader_spec = importlib.util.spec_from_file_location(
            "_tdl_eval_target", mod_name)
        mod = importlib.util.module_from_spec(loader_spec)
        loader_spec.loader.exec_module(mod)
    else:
        import importlib

        mod = importlib.import_module(mod_name)
    return getattr(mod, fn_name)


class FleetController:
    """Unattended lineage-to-fleet promotion with staged fault gates.

    ``ckpt_dir``/``tag`` name the ``TrainingCheckpointer`` lineage to watch;
    ``pool`` is the :class:`serving.ServingPool` to canary against and
    promote into (None = gate chain without canary/swap — promotion then
    just moves the durable baseline). ``eval_fn(gen_dir)`` returns either a
    plain ``{metric: value}`` dict or an object with a
    ``to_metrics(registry, model=)`` hook (``eval.Evaluation`` /
    ``RegressionEvaluation``). ``eval_thresholds`` are absolute floors
    (``{"accuracy": 0.8}``); ``regression_band`` is how far below the
    promoted baseline's metric a candidate may fall before the eval gate
    fails it."""

    def __init__(self, ckpt_dir: str,
                 pool=None, *,
                 tag: str = "latest",
                 workdir: str,
                 gates: Optional[Sequence[str]] = None,
                 eval_fn: Optional[Callable[[str], Any]] = None,
                 eval_thresholds: Optional[Dict[str, float]] = None,
                 regression_band: float = 0.05,
                 trace=None,
                 rules=None,
                 payload: Any = None,
                 n_clients: int = 4,
                 slo_threshold_ms: float = 250.0,
                 slo_target: float = 0.99,
                 burn_window_s: float = 0.5,
                 canary_ready_timeout: float = 60.0,
                 gate_timeout_s: float = 300.0,
                 retries: int = 2,
                 retry_backoff_s: float = 0.2,
                 registry: Optional[MetricsRegistry] = None):
        self.ckpt_dir = str(ckpt_dir)
        self.tag = tag
        self.pool = pool
        self.workdir = str(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        if gates is None:
            gates = GATE_CHAIN if pool is not None else ("integrity", "eval")
        unknown = [g for g in gates if g not in GATE_CHAIN]
        if unknown:
            raise ValueError(f"unknown gates {unknown}; choose from "
                             f"{GATE_CHAIN}")
        self.gates = tuple(gates)
        self.eval_fn = eval_fn
        self.eval_thresholds = dict(eval_thresholds or {})
        self.regression_band = float(regression_band)
        if trace is None and "canary" in self.gates:
            from ..serving.loadgen import TraceSpec

            trace = TraceSpec(duration_s=4.0, base_rate=40.0, seed=18)
        self.trace = trace
        self.rules = tuple(rules) if rules is not None \
            else default_canary_rules()
        self.payload = payload if payload is not None else [[0.0, 0.0, 0.0,
                                                             0.0]]
        self.n_clients = int(n_clients)
        self.slo_threshold_ms = float(slo_threshold_ms)
        self.slo_target = float(slo_target)
        self.burn_window_s = float(burn_window_s)
        self.canary_ready_timeout = float(canary_ready_timeout)
        self.gate_timeout_s = float(gate_timeout_s)
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.registry = registry if registry is not None else get_registry()
        self._m = deploy_metrics(self.registry)
        self.state_path = os.path.join(self.workdir, STATE_FILE)
        self.audit_path = os.path.join(self.workdir, AUDIT_FILE)
        self.flight_dir = os.path.join(self.workdir, "flight")
        self._own_recorder: Optional[flight.FlightRecorder] = None
        if not flight.active():
            # unattended means self-recording: without a supervisor's
            # TDL_FLIGHT_DIR the controller installs its own spool so every
            # deploy decision still reaches the audit's timeline
            self._own_recorder = flight.FlightRecorder(
                proc="deploy-controller", directory=self.flight_dir,
                interval=0.0)
            flight.set_flight_recorder(self._own_recorder)
        self.state = self._load_state()
        self._stop_evt = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._active_canary = None
        g = self.state.get("promoted") or {}
        self._m.promoted_generation.set(float(g.get("iteration", -1)))

    # -- durable state -----------------------------------------------------

    def _load_state(self) -> dict:
        try:
            with open(self.state_path) as f:
                st = json.load(f)
            # a candidate that was mid-gate when the previous incarnation
            # died resumes AT that gate — flag it so the audit says so
            for entry in st.get("candidates", {}).values():
                if entry.get("status") == "in_gate":
                    entry["resumed"] = True
            log.info("controller resumed from %s (%d candidates known)",
                     self.state_path, len(st.get("candidates", {})))
            return st
        except (OSError, ValueError):
            return {"version": 1, "tag": self.tag, "promoted": None,
                    "candidates": {}}

    def _save_state(self) -> None:
        durable_write_json(self.state_path, self.state)

    def close(self) -> None:
        self._stop_evt.set()
        t, self._watch_thread = self._watch_thread, None
        if t is not None:
            t.join(timeout=10.0)
        if self._active_canary is not None and self.pool is not None:
            try:
                self.pool.stop_canary(self._active_canary)
            except Exception:
                log.exception("canary cleanup failed on close")
            self._active_canary = None
        if self._own_recorder is not None:
            self._own_recorder.flush()
            flight.set_flight_recorder(None)
            self._own_recorder = None

    # -- watch loop --------------------------------------------------------

    def start(self, interval: float = 1.0) -> "FleetController":
        """Background watch: poll the lineage, process new committed
        generations as they appear. Idempotent."""
        if self._watch_thread is not None:
            return self
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.wait(interval):
                try:
                    self.run_once()
                except Exception:
                    log.exception("controller watch iteration failed")

        self._watch_thread = threading.Thread(
            target=loop, name="tdl-deploy-watch", daemon=True)
        self._watch_thread.start()
        return self

    def stop(self) -> None:
        self.close()

    def run_once(self) -> List[dict]:
        """One pass: pick up every committed generation not yet decided,
        run it through the gate chain, return the per-candidate audit rows
        (may be empty). Candidates no newer than the promoted baseline are
        skipped — the controller only ever moves the fleet forward."""
        st = lineage_state(self.ckpt_dir, self.tag)
        out = []
        promoted = self.state.get("promoted") or {}
        floor = promoted.get("iteration", -1)
        for cand in st["committed"]:
            entry = self.state["candidates"].get(cand["generation"])
            if entry and entry.get("status") in ("promoted", "rejected"):
                continue
            if entry is None and cand["iteration"] <= floor:
                continue  # older than what already serves
            out.append(self._process_candidate(cand, st))
            # a promotion raises the floor for the rest of this pass
            promoted = self.state.get("promoted") or {}
            floor = promoted.get("iteration", -1)
        if out:
            self._write_audit()
        return out

    # -- candidate pipeline ------------------------------------------------

    def _process_candidate(self, cand: dict, lineage: dict) -> dict:
        name = cand["generation"]
        gendir = os.path.join(lineage["dir"], name)
        entry = self.state["candidates"].setdefault(name, {
            "generation": name, "iteration": cand["iteration"],
            "dir": gendir, "status": "pending", "gate": None,
            "verdicts": [], "resumed": False})
        entry["dir"] = gendir
        if not entry.get("announced"):
            self._announce_candidate(entry)
        passed = {v["gate"] for v in entry["verdicts"] if v["ok"]}
        for gate in self.gates:
            if gate in passed:
                continue  # resume: this gate's pass verdict is durable
            entry["status"], entry["gate"] = "in_gate", gate
            self._save_state()  # crash here -> restart re-enters THIS gate
            verdict = self._run_gate(gate, entry, lineage)
            self._record_verdict(entry, verdict)
            if not verdict["ok"]:
                return self._rollback(entry, verdict)
        return self._promote(entry)

    # -- decision points (every one records its flight event; the AST lint
    # in tests/test_torch_controller.py keeps it that way) -----------------

    def _announce_candidate(self, entry: dict) -> None:
        flight.record("deploy_candidate", generation=entry["generation"],
                      iteration=entry["iteration"], dir=entry["dir"],
                      resumed=bool(entry.get("resumed")))
        self._m.candidates.inc()
        entry["announced"] = True
        self._save_state()

    def _record_verdict(self, entry: dict, verdict: dict) -> dict:
        flight.record("deploy_gate", gate=verdict["gate"],
                      verdict="pass" if verdict["ok"] else "fail",
                      generation=entry["generation"],
                      iteration=entry["iteration"],
                      reason=verdict.get("reason"),
                      seconds=verdict.get("seconds"))
        self._m.gate_verdicts.labels(
            verdict["gate"], "pass" if verdict["ok"] else "fail").inc()
        if verdict.get("seconds") is not None:
            self._m.gate_seconds.labels(verdict["gate"]).observe(
                verdict["seconds"])
        entry["verdicts"].append(verdict)
        self._save_state()
        return verdict

    def _promote(self, entry: dict) -> dict:
        if self.pool is not None:
            swap = self._swap_into_pool(entry)
            if not swap["ok"]:
                self._record_verdict(entry, swap)
                return self._rollback(entry, swap)
            self._record_verdict(entry, swap)
        flight.record("deploy_promote", generation=entry["generation"],
                      iteration=entry["iteration"], dir=entry["dir"])
        self._m.promotions.inc()
        self._m.promoted_generation.set(float(entry["iteration"]))
        entry["status"], entry["gate"] = "promoted", None
        self.state["promoted"] = {
            "generation": entry["generation"],
            "iteration": entry["iteration"], "dir": entry["dir"],
            "metrics": self._eval_metrics_of(entry)}
        self._save_state()
        log.info("promoted %s (iteration %d)", entry["generation"],
                 entry["iteration"])
        return entry

    def _rollback(self, entry: dict, verdict: dict) -> dict:
        flight.record("deploy_rollback", generation=entry["generation"],
                      iteration=entry["iteration"], gate=verdict["gate"],
                      reason=verdict.get("reason"), audit=self.audit_path)
        self._m.rollbacks.labels(verdict["gate"]).inc()
        entry["status"], entry["gate"] = "rejected", None
        entry["rejected_by"] = {"gate": verdict["gate"],
                                "reason": verdict.get("reason")}
        self._save_state()
        log.warning("rejected %s at the %s gate (%s) — fleet untouched",
                    entry["generation"], verdict["gate"],
                    verdict.get("reason"))
        return entry

    # -- gate driver -------------------------------------------------------

    def _run_gate(self, gate: str, entry: dict, lineage: dict) -> dict:
        """One gate, bounded and retried: the gate fn runs in its own
        thread under ``gate_timeout_s`` (a wedged gate is a failing verdict,
        never a hang); exceptions escaping it are treated as transient and
        retried with exponential backoff before counting as a verdict."""
        fn = getattr(self, f"_gate_{gate}")
        t0 = time.perf_counter()
        last_err: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            box: Dict[str, Any] = {}

            def runner():
                try:
                    box["v"] = fn(entry, lineage)
                except BaseException as e:  # noqa: BLE001 — verdict, below
                    box["e"] = e

            th = threading.Thread(target=runner, daemon=True,
                                  name=f"tdl-deploy-gate-{gate}")
            th.start()
            th.join(self.gate_timeout_s)
            if th.is_alive():
                self._cleanup_wedged_gate()
                return {"gate": gate, "ok": False, "reason": "timeout",
                        "seconds": round(time.perf_counter() - t0, 3),
                        "evidence": {"timeout_s": self.gate_timeout_s,
                                     "attempt": attempt}}
            if "v" in box:
                v = box["v"]
                v.setdefault("seconds",
                             round(time.perf_counter() - t0, 3))
                if attempt:
                    v.setdefault("evidence", {})["retries"] = attempt
                return v
            last_err = box.get("e")
            if isinstance(last_err, (KeyboardInterrupt, SystemExit)):
                raise last_err
            log.warning("gate %s attempt %d errored (%s) — backing off",
                        gate, attempt, last_err)
            time.sleep(self.retry_backoff_s * (2 ** attempt))
        return {"gate": gate, "ok": False,
                "reason": f"error:{type(last_err).__name__}",
                "seconds": round(time.perf_counter() - t0, 3),
                "evidence": {"error": str(last_err),
                             "attempts": self.retries + 1}}

    def _cleanup_wedged_gate(self) -> None:
        canary, self._active_canary = self._active_canary, None
        if canary is not None and self.pool is not None:
            try:
                self.pool.stop_canary(canary)
            except Exception:
                log.exception("wedged-gate canary cleanup failed")

    # -- the gates ---------------------------------------------------------

    def _gate_integrity(self, entry: dict, lineage: dict) -> dict:
        quarantined = [q for q in lineage.get("quarantined", ())
                       if q.startswith(entry["generation"])]
        if quarantined or not os.path.isdir(entry["dir"]):
            # the restore side already condemned (and renamed) it — honor
            # the evidence instead of re-verifying a dir that moved away
            return {"gate": "integrity", "ok": False, "reason": "quarantined",
                    "evidence": {"quarantined": quarantined or
                                 [entry["generation"]]}}
        report = verify_checkpoint(entry["dir"], deep=True,
                                   registry=self.registry)
        return {"gate": "integrity", "ok": bool(report["ok"]),
                "reason": None if report["ok"] else report["reason"],
                "evidence": {"verify": {k: report.get(k) for k in
                                        ("reason", "generation", "iteration",
                                         "format", "bytes", "seconds")},
                             "dir": entry["dir"]}}

    def _gate_eval(self, entry: dict, lineage: dict) -> dict:
        if self.eval_fn is None:
            return {"gate": "eval", "ok": True, "reason": "skipped:no_eval",
                    "evidence": {}}
        res = self.eval_fn(entry["dir"])
        if hasattr(res, "to_metrics"):
            metrics = res.to_metrics(self.registry,
                                     model=entry["generation"])
        else:
            metrics = {k: float(v) for k, v in dict(res).items()}
            # plain dicts still land on /metrics: the gate and the scrape
            # must agree on the judged numbers
            from ..eval.evaluation import eval_metrics as _em

            acc_g, f1_g, score_g = _em(self.registry)
            by_name = {"accuracy": acc_g, "f1": f1_g, "score": score_g}
            for k, g in by_name.items():
                if k in metrics:
                    g.labels(entry["generation"]).set(metrics[k])
        failures = []
        for metric, floor in self.eval_thresholds.items():
            v = metrics.get(metric)
            if v is None or v < floor:
                failures.append(f"{metric}={v} < {floor}")
        baseline = (self.state.get("promoted") or {}).get("metrics") or {}
        for metric, base in baseline.items():
            v = metrics.get(metric)
            if v is not None and v < base - self.regression_band:
                failures.append(
                    f"{metric}={v:.4f} regressed below promoted "
                    f"{base:.4f} - band {self.regression_band}")
        return {"gate": "eval", "ok": not failures,
                "reason": "; ".join(failures) or None,
                "evidence": {"metrics": metrics,
                             "thresholds": self.eval_thresholds,
                             "baseline": baseline,
                             "regression_band": self.regression_band}}

    def _gate_canary(self, entry: dict, lineage: dict) -> dict:
        if self.pool is None:
            return {"gate": "canary", "ok": False, "reason": "no_pool",
                    "evidence": {}}
        baseline_port = self._baseline_port()
        if baseline_port is None:
            return {"gate": "canary", "ok": False, "reason": "no_baseline",
                    "evidence": {"pool": self.pool.describe()}}
        try:
            canary = self.pool.start_canary(
                entry["dir"], ready_timeout=self.canary_ready_timeout)
        except TimeoutError as e:
            return {"gate": "canary", "ok": False,
                    "reason": "canary_not_ready",
                    "evidence": {"error": str(e),
                                 "ready_timeout_s":
                                     self.canary_ready_timeout}}
        self._active_canary = canary
        try:
            reports = self._paired_replay(baseline_port, canary.port)
        finally:
            self._active_canary = None
            self.pool.stop_canary(canary)
        windows = paired_canary_windows(
            reports["baseline"].pop("requests"),
            reports["candidate"].pop("requests"),
            duration_s=self.trace.duration_s, window_s=self.burn_window_s,
            threshold_ms=self.slo_threshold_ms, target=self.slo_target)
        verdict = judge_canary_windows(windows, self.rules,
                                       registry=self.registry)
        reason = None
        if not verdict["ok"]:
            rules = sorted({f["rule"] for f in verdict["fired"]})
            reason = "slo:" + ",".join(rules)
        return {"gate": "canary", "ok": verdict["ok"], "reason": reason,
                "evidence": {"fired": verdict["fired"],
                             "windows_judged": verdict["judged"],
                             "windows": windows,
                             "baseline": reports["baseline"],
                             "candidate": reports["candidate"],
                             "canary_replica": canary.id,
                             "baseline_port": baseline_port}}

    def _baseline_port(self) -> Optional[int]:
        for r in self.pool.describe()["replicas"]:
            if (r["state"] == "ready" and not r["canary"]
                    and not r["retiring"] and r["port"]):
                return r["port"]
        return None

    def _paired_replay(self, baseline_port: int,
                       canary_port: int) -> Dict[str, dict]:
        """The mirrored replay: the SAME seeded arrival schedule against
        both arms, concurrently, so every sub-window pairs like with like.
        Summaries keep outcome counts and latency percentiles; the raw rows
        feed the paired-window judgement."""
        from ..serving.loadgen import LoadGenerator

        out: Dict[str, dict] = {}

        def arm(name: str, port: int):
            gen = LoadGenerator(
                self.trace, port, n_clients=self.n_clients,
                payload=self.payload,
                request_id_prefix=f"canary-{name}",
                slo_threshold_ms=self.slo_threshold_ms,
                slo_target=self.slo_target,
                burn_window_s=self.burn_window_s,
                record_requests=True, registry=self.registry)
            out[name] = gen.run()

        threads = [threading.Thread(target=arm, args=("baseline",
                                                      baseline_port)),
                   threading.Thread(target=arm, args=("candidate",
                                                      canary_port))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    # -- promote helpers ---------------------------------------------------

    def _swap_into_pool(self, entry: dict) -> dict:
        """Complete the rolling swap — the promote 'gate'. The candidate
        already passed preflight-equivalent verification (integrity gate),
        but swap_model re-verifies; a surge that never probes ready rolls
        the swap back and the verdict fails."""
        try:
            result = self.pool.swap_model(entry["dir"])
        except (ValueError, RuntimeError) as e:
            return {"gate": "promote", "ok": False,
                    "reason": f"swap_rejected:{e}",
                    "evidence": {"error": str(e)}}
        if result.get("rolled_back") or not result.get("ok"):
            return {"gate": "promote", "ok": False,
                    "reason": "swap_rolled_back", "evidence": result}
        return {"gate": "promote", "ok": True, "reason": None,
                "evidence": result}

    def _eval_metrics_of(self, entry: dict) -> dict:
        for v in entry["verdicts"]:
            if v["gate"] == "eval" and v["ok"]:
                return dict(v.get("evidence", {}).get("metrics") or {})
        return {}

    # -- audit -------------------------------------------------------------

    def _write_audit(self) -> str:
        """Rewrite the postmortem-style audit: every candidate's gate
        verdicts with evidence pointers, the promoted baseline, and the
        merged timeline artifact."""
        timeline_path = None
        try:
            timeline_path = self._write_timeline()
        except Exception:
            log.exception("audit timeline merge failed (audit continues)")
        audit = {
            "wall": time.time(),  # wallclock-ok: human timestamp on the audit, never a duration
            "lineage": os.path.join(self.ckpt_dir, self.tag),
            "gates": list(self.gates),
            "promoted": self.state.get("promoted"),
            "candidates": [self.state["candidates"][k] for k in
                           sorted(self.state["candidates"])],
            "state": self.state_path,
            "timeline": timeline_path,
        }
        durable_write_json(self.audit_path, audit)
        return self.audit_path

    def _write_timeline(self) -> Optional[str]:
        path = os.path.join(self.workdir, "timeline.json")
        if self.pool is not None:
            return self.pool.write_timeline(path)
        from ..monitoring import timeline as _timeline

        dirs, extra = [], []
        rec = flight.get_flight_recorder() if flight.active() else None
        if rec is not None:
            if rec.directory is None:
                extra = rec.events()
            else:
                rec.flush()
                dirs.append(rec.directory)
        if not dirs and not extra:
            return None
        return _timeline.write_timeline(path, flight_dirs=dirs,
                                        extra_events=extra,
                                        registry=self.registry)


# -------------------------------------------------------- subprocess mode


def from_config(cfg: dict, registry: Optional[MetricsRegistry] = None):
    """Build ``(controller, pool)`` from a JSON-able config — the
    subprocess/unattended entry. Keys::

        ckpt_dir, tag, workdir                 lineage + durable state
        gates: ["integrity", "eval", "canary"]
        eval_target: "file.py:fn"              fn(gen_dir) -> metrics
        eval_thresholds: {"accuracy": 0.8}
        regression_band: 0.05
        trace: TraceSpec.to_dict()             canary replay recipe
        payload: [[...]]                       replay request payload
        slo: {threshold_ms, target, burn_window_s}
        canary: {ready_timeout_s, latency_ratio, min_availability,
                 burn_excess, for_duration}
        gate_timeout_s, retries, retry_backoff_s
        pool: {target, replicas, extra_env, ...}  ServingPool kwargs
    """
    pool = None
    if cfg.get("pool"):
        from ..serving.pool import ServingPool

        pkw = dict(cfg["pool"])
        target = pkw.pop("target")
        pkw.setdefault("workdir", os.path.join(cfg["workdir"], "pool"))
        pool = ServingPool(target, registry=registry, **pkw).start()
    trace = None
    if cfg.get("trace"):
        from ..serving.loadgen import TraceSpec

        trace = TraceSpec.from_dict(cfg["trace"])
    eval_fn = (_load_callable(cfg["eval_target"])
               if cfg.get("eval_target") else None)
    slo = cfg.get("slo") or {}
    canary = cfg.get("canary") or {}
    rules = None
    if canary:
        rules = default_canary_rules(
            latency_ratio=canary.get("latency_ratio", 2.0),
            min_availability=canary.get("min_availability", 0.95),
            burn_excess=canary.get("burn_excess", 2.0),
            for_duration=canary.get("for_duration", 2))
    ctl = FleetController(
        cfg["ckpt_dir"], pool,
        tag=cfg.get("tag", "latest"),
        workdir=cfg["workdir"],
        gates=cfg.get("gates"),
        eval_fn=eval_fn,
        eval_thresholds=cfg.get("eval_thresholds"),
        regression_band=cfg.get("regression_band", 0.05),
        trace=trace,
        rules=rules,
        payload=cfg.get("payload"),
        n_clients=cfg.get("n_clients", 4),
        slo_threshold_ms=slo.get("threshold_ms", 250.0),
        slo_target=slo.get("target", 0.99),
        burn_window_s=slo.get("burn_window_s", 0.5),
        canary_ready_timeout=canary.get("ready_timeout_s", 60.0),
        gate_timeout_s=cfg.get("gate_timeout_s", 300.0),
        retries=cfg.get("retries", 2),
        retry_backoff_s=cfg.get("retry_backoff_s", 0.2),
        registry=registry)
    return ctl, pool


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="unattended lineage->fleet deployment controller")
    ap.add_argument("config", help="JSON config (see from_config)")
    ap.add_argument("--once", action="store_true",
                    help="process the current committed set and exit")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="watch-mode poll seconds")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="watch-mode wall bound (0 = forever)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    with open(args.config) as f:
        cfg = json.load(f)
    ctl, pool = from_config(cfg)
    try:
        if args.once:
            ctl.run_once()
        else:
            deadline = (time.monotonic() + args.duration
                        if args.duration else None)
            while deadline is None or time.monotonic() < deadline:
                ctl.run_once()
                time.sleep(args.interval)
        ctl._write_audit()
        # the CLI's machine-readable output contract (not a debug print):
        # one JSON summary on stdout, diagnostics stay on logging/stderr
        sys.stdout.write(json.dumps({
            "audit": ctl.audit_path,
            "promoted": ctl.state.get("promoted"),
            "candidates": {k: v["status"] for k, v in
                           ctl.state["candidates"].items()}}) + "\n")
        return 0
    finally:
        ctl.close()
        if pool is not None:
            pool.stop()


if __name__ == "__main__":
    raise SystemExit(main())
