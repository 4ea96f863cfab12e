"""GangSupervisor — fault-tolerant supervision of a multi-process gang.

Counterpart of ``deeplearning4j_tpu/parallel/supervisor.py``, with its API,
env contract, metric families, flight events and ``postmortem.json``.

The launcher runs a gang exactly once: a worker that crashes or wedges
inside a gloo/NCCL collective stalls every other rank until the timeout
kill. The supervisor makes the gang restart from its checkpoint instead:

- workers write per-rank heartbeat files (iteration + timestamp) from their
  fit loops (``monitoring.heartbeat``, driven by ``ParallelTrainer`` /
  ``MultiProcessTrainer``);
- the supervisor polls process liveness and heartbeat freshness; a dead rank
  or a heartbeat stalled past ``hang_timeout`` condemns the WHOLE gang
  (a synchronous data-parallel step cannot survive a lost member);
- the gang is killed (SIGTERM, grace, SIGKILL) and respawned on a **fresh
  store port** with ``TDL_GANG_RESTART_COUNT`` incremented; worker targets
  restore from the latest complete checkpoint and replay;
- restarts are bounded (``max_restarts``) with exponential backoff + jitter;
- failures are classified: ``crash`` (nonzero exit), ``hang`` (stalled
  heartbeat), ``bind`` (store port race — retried on its own budget), and
  repeated crash at the same iteration ⇒ fatal (restarting cannot help a
  deterministic fault; surface it instead of looping);
- ``elastic=True``: when the restart budget at the current size is
  exhausted and the SAME rank(s) were implicated every time — the
  permanently-dead-host signature, a rank that cannot even boot — the
  supervisor degrades to the surviving healthy ranks instead of classifying
  fatal: it respawns the gang at size ``n - |suspects|`` (never below
  ``min_processes``), the workers build the largest valid ``SpecLayout`` for
  the survivor count and restore the bigger gang's checkpoint through the
  cross-layout ``reshard=True`` path, and the resize is recorded as a
  ``gang_resize`` flight event, ``tdl_gang_resizes_total{direction}``, and a
  ``resizes`` section in ``postmortem.json``. Repeated crash at the same
  ITERATION stays fatal — that is a deterministic software fault, not a
  dead host, and shrinking the gang cannot fix it.

Recovery is observable through the metrics registry:
``tdl_worker_deaths_total{reason}``, ``tdl_gang_restarts_total`` and the
``tdl_gang_recovery_seconds`` histogram (failure detection → gang respawned).

Torn and corrupt checkpoints are survivable: the checkpointer's
generational lineage quarantines an unverifiable generation and falls back
to the newest one whose checksums hold, so a kill mid-save — or a flipped
bit discovered at restore — costs the gang a respawn plus the steps since
the previous commit, not the run. The respawn classifies as an ordinary
recoverable ``crash``; the worker's ``ckpt_quarantine``/``ckpt_fallback``
flight events land on the postmortem timeline, and when ``ckpt_dir`` is
set the postmortem carries a ``checkpoint`` section with the full lineage
inventory (committed/torn/quarantined generations, pointer).

What is deliberately NOT survivable: any attempt to patch a single rank
back into a live gang — mid-collective partial state is unrecoverable by
construction — and a lineage whose every committed generation fails
verification (restore raises ``CheckpointVerifyError`` rather than
resurrecting corrupt weights or silently training from scratch).

The supervisor holds no tensor and imports no torch: the worker targets
decide the device. As in ``launcher``, each process runs one device
(``n_local_devices`` stays 1), the platform is the card unless the caller
asks for the CPU, and ``backend="gloo"`` lets several ranks share one card.
"""

from __future__ import annotations

import json
import logging
import os
import random
import signal
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..common import compile_cache
from ..monitoring import aggregate, flight, history
from ..monitoring.flight import FlightRecorder
from ..monitoring.heartbeat import ENV_DIR, ENV_INTERVAL, read_heartbeat
from ..monitoring.registry import MetricsRegistry, get_registry
from . import launcher
from .launcher import WorkerResult, _BIND_FAILURE_RE

log = logging.getLogger(__name__)

ENV_INCARNATION = "TDL_GANG_RESTART_COUNT"


class GangFailedError(RuntimeError):
    """The gang could not be driven to completion; carries the supervisor's
    failure classification and per-rank evidence."""

    def __init__(self, message: str, classification: str,
                 events: List["GangEvent"]):
        super().__init__(message)
        self.classification = classification
        self.events = events


@dataclass
class GangEvent:
    """One supervised failure observation (also the metrics evidence)."""
    time: float                      # time.monotonic at detection
    reason: str                      # crash | hang | bind | timeout
    attempt: int                     # spawn attempt the failure happened in
    ranks: Tuple[int, ...]           # ranks implicated
    iteration: Optional[int] = None  # last heartbeat iteration of rank[0]
    detail: str = ""


def _compile_churn(events: Sequence[dict]) -> List[dict]:
    """Per-(proc, fn) compile count + seconds from merged ``compile`` flight
    events, worst offender first — the postmortem's answer to "who kept
    recompiling"."""
    agg: Dict[Tuple[str, str], Dict[str, float]] = {}
    for e in events:
        if e.get("kind") != "compile":
            continue
        key = (str(e.get("proc", "?")), str(e.get("fn", "?")))
        row = agg.setdefault(key, {"compiles": 0, "seconds": 0.0})
        row["compiles"] += 1
        row["seconds"] += float(e.get("seconds") or 0.0)
    return [{"proc": proc, "fn": fn, "compiles": row["compiles"],
             "seconds": round(row["seconds"], 4)}
            for (proc, fn), row in sorted(
                agg.items(), key=lambda kv: -kv[1]["compiles"])]


def _alert_intervals(events: Sequence[dict]) -> List[dict]:
    """Pair ``alert`` / ``alert_clear`` flight events into firing INTERVALS
    per (proc, rule), longest first — the postmortem's answer to "what was
    alerting, and for how long, while we died". An alert still open at the
    end of the timeline reports ``end_t=None`` / ``still_firing=True``."""
    open_: Dict[Tuple[str, str], dict] = {}
    out: List[dict] = []
    for e in events:
        kind = e.get("kind")
        if kind not in ("alert", "alert_clear"):
            continue
        key = (str(e.get("proc", "?")), str(e.get("rule", "?")))
        if kind == "alert":
            # a duplicate rise without a clear (recorder ring evicted the
            # clear): close the dangling interval open-ended first
            if key in open_:
                s = open_.pop(key)
                out.append(_interval_row(key, s, None))
            open_[key] = e
        else:
            s = open_.pop(key, None)
            out.append(_interval_row(key, s, e))
    for key, s in open_.items():
        out.append(_interval_row(key, s, None))
    return sorted(out, key=lambda r: -(r["duration"]
                                       if r["duration"] is not None
                                       else float("inf")))


def _interval_row(key: Tuple[str, str], start: Optional[dict],
                  end: Optional[dict]) -> dict:
    src = start or end or {}
    duration = None
    if end is not None and end.get("duration") is not None:
        duration = float(end["duration"])
    elif start is not None and end is not None:
        duration = float(end.get("t", 0.0)) - float(start.get("t", 0.0))
    return {
        "proc": key[0],
        "rule": key[1],
        "severity": src.get("severity"),
        "start_t": start.get("t") if start else None,
        "end_t": end.get("t") if end else None,
        "duration": duration,
        "still_firing": end is None,
    }


def _supervisor_metrics(registry: MetricsRegistry):
    return (
        registry.counter("tdl_worker_deaths_total",
                         "Supervised worker deaths by failure classification",
                         labels=("reason",)),
        registry.counter("tdl_gang_restarts_total",
                         "Whole-gang restarts performed by GangSupervisor"),
        registry.histogram("tdl_gang_recovery_seconds",
                           "Failure detection to gang respawned"),
        # info-style gauge: ONE series whose labels say WHY the gang last
        # restarted (value = budgeted restarts performed when it happened)
        registry.gauge("tdl_gang_last_failure_info",
                       "Last gang failure (labels carry the classification; "
                       "value = restarts performed at that point)",
                       labels=("reason", "rank", "iteration")),
    )


class GangSupervisor:
    """Wraps ``launcher.spawn``/``wait`` with heartbeat liveness, whole-gang
    kill on any member failure, and bounded restart-from-checkpoint.

    The worker target owns the restore: on respawn the supervisor only
    guarantees a fresh store port and ``TDL_GANG_RESTART_COUNT`` > 0 in the
    env; targets call ``TrainingCheckpointer.restore`` (or equivalent)
    unconditionally and continue from whatever ``latest`` holds.
    """

    def __init__(
        self,
        target: str,
        n_processes: int,
        n_local_devices: int = 1,
        platform: str = "cuda",
        extra_env: Optional[Dict[str, str]] = None,
        args: Sequence[str] = (),
        cwd: Optional[str] = None,
        workdir: Optional[str] = None,
        max_restarts: int = 3,
        hang_timeout: float = 60.0,
        startup_grace: float = 240.0,
        poll_interval: float = 0.25,
        heartbeat_interval: Optional[float] = None,
        backoff_base: float = 0.5,
        backoff_max: float = 30.0,
        backoff_jitter: float = 0.25,
        port_retries: int = 3,
        kill_grace: float = 5.0,
        same_iteration_fatal: int = 3,
        elastic: bool = False,
        min_processes: int = 1,
        pipe_stages: int = 1,
        ckpt_dir: Optional[str] = None,
        proc_prefix: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
        backend: Optional[str] = None,
    ):
        if n_local_devices != 1:
            raise ValueError(f"n_local_devices={n_local_devices}: the port runs one device "
                             "per process")
        self.target = target
        self.n_processes = n_processes
        self.n_local_devices = n_local_devices
        self.platform = platform
        #: the process group's backend, as ``launcher.initialize`` takes it:
        #: None states the platform's own (nccl on the card, gloo on the
        #: CPU); "gloo" on the card lets several ranks share it
        self.backend = backend
        self.extra_env = dict(extra_env or {})
        self.args = tuple(args)
        self.cwd = cwd
        import tempfile

        self.workdir = workdir or tempfile.mkdtemp(prefix="tdl_gang_")
        os.makedirs(self.workdir, exist_ok=True)  # postmortem.json lands here
        self.max_restarts = max_restarts
        self.hang_timeout = hang_timeout
        self.startup_grace = startup_grace
        self.poll_interval = poll_interval
        # default throttles worker beats to a fraction of the hang budget:
        # liveness resolution is preserved while fast steps aren't taxed
        # with a write+rename each iteration (0.0 = every iteration,
        # test-only)
        self.heartbeat_interval = (min(1.0, hang_timeout / 4.0)
                                   if heartbeat_interval is None
                                   else heartbeat_interval)
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.backoff_jitter = backoff_jitter
        self.port_retries = port_retries
        self.kill_grace = kill_grace
        self.same_iteration_fatal = max(2, same_iteration_fatal)
        self.elastic = elastic
        self.min_processes = max(1, min_processes)
        #: preferred pipeline depth for elastic survivor layouts: a resized
        #: gang re-partitions its stages over at most this many pipe shards
        #: (largest_layout degrades it until it divides the surviving rank
        #: count) and restores cross-layout via reshard=True
        self.pipe_stages = max(1, pipe_stages)
        #: checkpoint lineage root the workers save/restore under — when
        #: set, every postmortem carries a ``checkpoint`` section with the
        #: lineage inventory (committed/torn/quarantined, pointer)
        self.ckpt_dir = ckpt_dir
        #: telemetry identity namespace: prepended to each rank's derived
        #: proc name (``rank{N}`` → ``<prefix>rank{N}``) so many gangs
        #: spooling into one shared metrics/flight dir stay distinguishable
        self.proc_prefix = proc_prefix
        self.registry = registry or get_registry()
        (self._deaths, self._restarts_ctr, self._recovery_hist,
         self._last_failure_info) = _supervisor_metrics(self.registry)
        from ..monitoring.partition import elastic_metrics

        self._resizes_ctr = elastic_metrics(self.registry).gang_resizes
        # one run id for the whole gang: every rank inherits it via
        # TDL_RUN_ID, so each spool — and the merged timeline — can say
        # which supervised run its events belong to
        import uuid

        self.run_id = uuid.uuid4().hex[:12]
        # the supervisor's own black box (restart decisions, classifications);
        # ring-only — its events merge into postmortem.json from memory
        self._flight = FlightRecorder(proc="supervisor", run=self.run_id)
        self.last_failure: Optional[Dict] = None
        #: merged flight-recorder timeline of the most recent failure
        self.postmortem_path = os.path.join(self.workdir, "postmortem.json")
        #: one stable spool dir for ALL attempts — attachable once
        self.spool_dir = os.path.join(self.workdir, "spool")
        #: stable per-proc history-ring dir: windowed /history
        self.history_dir = os.path.join(self.workdir, "history")
        #: stable kernel-build cache dir: a respawned incarnation loads the
        #: kernels incarnation N built instead of running nvcc again
        self.compile_cache_dir = os.path.join(self.workdir, "compile_cache")

        self.events: List[GangEvent] = []
        self.restarts = 0           # budgeted restarts performed (total)
        self.port_failures = 0      # bind-race respawns (separate budget)
        #: restarts burned at the CURRENT gang size — an elastic resize
        #: grants the smaller gang a fresh budget
        self._restarts_this_size = 0
        #: elastic resizes performed, newest last (mirrored into postmortems)
        self.resizes: List[Dict] = []
        #: index into ``events`` where the current gang size began — resize
        #: suspect analysis must never read events from a BIGGER gang whose
        #: rank ids no longer mean the same thing
        self._events_mark = 0
        # crash iterations only: which rank died can vary run-to-run (the
        # injected rank vs a sibling aborted by gloo noticing the dead peer),
        # but a deterministic fault replays the same ITERATION every time
        self._crash_history: List[Optional[int]] = []

    # ------------------------------------------------------------------ run

    def run(self, timeout: float = 600.0) -> List[WorkerResult]:
        """Drive the gang to completion, restarting on failures. Returns the
        per-rank results of the final (successful) incarnation, or raises
        :class:`GangFailedError`."""
        deadline = time.monotonic() + timeout
        attempt = 0
        failed_at: Optional[float] = None
        while True:
            procs, hb_dir = self._spawn(attempt)
            if failed_at is not None:  # time-to-recovery: detection → respawned
                self._recovery_hist.observe(time.monotonic() - failed_at)
                failed_at = None
            failure = self._monitor(procs, hb_dir, attempt, deadline)
            if failure is None:
                results = self._collect(procs)
                self._note_recovery_postmortem()
                return results
            self.events.append(failure)
            self._deaths.labels(failure.reason).inc(len(failure.ranks))
            self._note_failure(failure)
            self._kill_gang(procs)
            # gang is down: collect every rank's flight ring into ONE
            # monotonic-ordered postmortem BEFORE deciding what happens next
            self._write_postmortem(failure)
            if failure.reason == "timeout":
                raise GangFailedError("supervision deadline exceeded",
                                      "timeout", self.events)
            try:
                self._classify_or_raise(failure)
                if failure.reason == "bind":
                    self.port_failures += 1
                    if self.port_failures > self.port_retries:
                        raise GangFailedError(
                            f"store bind failed {self.port_failures} times",
                            "bind", self.events)
                else:
                    if self._restarts_this_size >= self.max_restarts:
                        # last resort before fatal: degrade to the surviving
                        # healthy ranks — only when elastic, only when the
                        # failures consistently name the same ranks
                        if not self._try_resize(failure):
                            raise GangFailedError(
                                f"gang failed ({failure.reason} at iteration "
                                f"{failure.iteration}, ranks {failure.ranks}) and the "
                                f"restart budget ({self.max_restarts}) is exhausted",
                                self._final_classification(failure), self.events)
                    else:
                        self.restarts += 1
                        self._restarts_this_size += 1
                        self._restarts_ctr.inc()
                        self._flight.record(
                            "restart_decision", decision="restart",
                            reason=failure.reason, ranks=list(failure.ranks),
                            iteration=failure.iteration, restart=self.restarts)
                        self._backoff(self._restarts_this_size)
            except GangFailedError as e:
                self._flight.record(
                    "restart_decision", decision="fatal",
                    classification=e.classification, reason=failure.reason,
                    ranks=list(failure.ranks), iteration=failure.iteration,
                    restart=self.restarts)
                self._write_postmortem(failure, classification=e.classification)
                raise
            attempt += 1
            if time.monotonic() >= deadline:
                raise GangFailedError("supervision deadline exceeded",
                                      "timeout", self.events)
            log.warning("gang restart %d (spawn attempt %d) after %s at "
                        "iteration %s", self.restarts, attempt,
                        failure.reason, failure.iteration)
            failed_at = failure.time

    # ------------------------------------------------------------ lifecycle

    def _child_env(self, attempt: int, hb_dir: str) -> Dict[str, str]:
        """The env contract one gang incarnation runs under (factored out of
        ``_spawn`` so tests can pin it without spawning processes)."""
        env = dict(self.extra_env)
        env[ENV_INCARNATION] = str(self.restarts)
        env[ENV_DIR] = hb_dir
        env[ENV_INTERVAL] = str(self.heartbeat_interval)
        # observability plane: every supervised gang flight-records and
        # spools metrics — postmortems and the aggregated /metrics need no
        # opt-in. Flight dirs are per-ATTEMPT (a postmortem must hold the
        # failing incarnation's events, not a respawn's overwrite); the
        # metrics spool dir is STABLE across attempts so a dashboard
        # attached once keeps seeing live counters after restarts —
        # read_spools dedupes respawned incarnations by newest spool per
        # proc. setdefault: callers may re-point either dir through
        # extra_env.
        self.flight_dir = os.path.join(self.workdir, f"flight_{attempt}")
        env.setdefault(flight.ENV_DIR, self.flight_dir)
        env.setdefault(flight.ENV_INTERVAL, str(self.heartbeat_interval))
        # every rank stamps the gang's run id into its flight events — the
        # timeline groups lanes by it
        env.setdefault(flight.ENV_RUN_ID, self.run_id)
        if self.proc_prefix:
            # trial-scoped identity: every rank of this gang spools as
            # ``<prefix>rank{N}`` — a shared spool dir stays collision-free
            # across many single-rank gangs
            env.setdefault(flight.ENV_PROC_PREFIX, self.proc_prefix)
        env.setdefault(aggregate.ENV_DIR, self.spool_dir)
        env.setdefault(aggregate.ENV_INTERVAL, str(self.heartbeat_interval))
        # history rings are STABLE across attempts like the metrics spool:
        # windowed alert/SLO views spanning a restart are the point —
        # read_rings dedupes incarnations by newest ring per proc
        env.setdefault(history.ENV_DIR, os.path.join(self.workdir, "history"))
        # kernel-build cache: STABLE across attempts by construction — the
        # whole point is that incarnation N+1 loads the shared libraries
        # incarnation N built, so a respawn-from-checkpoint pays a dlopen,
        # not an nvcc run
        env.setdefault(compile_cache.ENV_DIR,
                       os.path.join(self.workdir, "compile_cache"))
        self.flight_dir = env[flight.ENV_DIR]
        self.spool_dir = env[aggregate.ENV_DIR]
        self.history_dir = env[history.ENV_DIR]
        self.compile_cache_dir = env[compile_cache.ENV_DIR]
        return env

    def _spawn(self, attempt: int):
        # per-ATTEMPT dirs keep heartbeats/logs of a bind-race respawn from
        # colliding, but the worker-visible restart count is only the
        # BUDGETED restarts: a bind respawn never recovered from a failure,
        # so workers (and incarnation-gated fault clauses) must not see it
        hb_dir = os.path.join(self.workdir, f"hb_{attempt}")
        log_dir = os.path.join(self.workdir, f"logs_{attempt}")
        os.makedirs(hb_dir, exist_ok=True)
        env = self._child_env(attempt, hb_dir)
        procs = launcher.spawn(
            self.target, self.n_processes, self.n_local_devices,
            self.platform, extra_env=env, args=self.args, cwd=self.cwd,
            log_dir=log_dir, backend=self.backend)  # fresh free_port() per incarnation
        return procs, hb_dir

    def _monitor(self, procs, hb_dir: str, attempt: int,
                 deadline: float) -> Optional[GangEvent]:
        """Poll liveness + heartbeats until the gang finishes or fails.
        Returns None on clean completion, else the failure event."""
        spawned = time.monotonic()
        # rank → (iteration, mtime, monotonic time the pair last changed)
        last_progress: Dict[int, Tuple[Optional[int], float, float]] = {}
        # rank → iteration of its FIRST beat: the fit loop beats before the
        # step runs, so the stall between the first beat and the first
        # iteration ADVANCE is the first step (kernel builds and loads) —
        # budget it with startup_grace, not hang_timeout
        first_iter: Dict[int, Optional[int]] = {}
        while True:
            now = time.monotonic()
            codes = [p.poll() for p in procs]
            dead = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if dead:
                iters = [self._hb_iter(hb_dir, r) for r in dead]
                reason = "bind" if self._bind_failure(procs, dead) else "crash"
                return GangEvent(now, reason, attempt, tuple(dead),
                                 iters[0],
                                 detail=f"exit codes {[codes[r] for r in dead]}")
            if all(c == 0 for c in codes):
                return None
            hung = []
            for rank, c in enumerate(codes):
                if c == 0:
                    continue  # finished ranks are allowed to go quiet
                hb = read_heartbeat(hb_dir, rank)
                if hb is None:
                    # no beat yet: startup (imports + kernel builds) gets its
                    # own, larger grace window
                    if now - spawned > self.startup_grace:
                        hung.append(rank)
                    continue
                it, mtime = hb
                if rank not in first_iter:
                    first_iter[rank] = it
                prev = last_progress.get(rank)
                if prev is None or (it, mtime) != prev[:2]:
                    last_progress[rank] = (it, mtime, now)
                    continue
                stall_budget = (self.startup_grace
                                if it == first_iter[rank] else
                                self.hang_timeout)
                if now - prev[2] > stall_budget:
                    hung.append(rank)
            if hung:
                it = self._hb_iter(hb_dir, hung[0])
                if it is None:  # condemned via the startup-grace path
                    detail = (f"no heartbeat at all within startup grace "
                              f"({self.startup_grace}s) — wedged before the "
                              f"fit loop (imports / kernel build?)")
                elif it == first_iter.get(hung[0]):
                    detail = (f"heartbeat never advanced past its first "
                              f"iteration ({it}) within startup grace "
                              f"({self.startup_grace}s) — wedged in the "
                              f"first step (kernel build?)")
                else:
                    detail = (f"no heartbeat progress for "
                              f">{self.hang_timeout}s")
                return GangEvent(now, "hang", attempt, tuple(hung), it,
                                 detail=detail)
            if now >= deadline:
                return GangEvent(now, "timeout", attempt,
                                 tuple(r for r, c in enumerate(codes)
                                       if c is None),
                                 self._hb_iter(hb_dir, 0),
                                 detail="supervision deadline exceeded")
            time.sleep(self.poll_interval)

    def _kill_gang(self, procs) -> None:
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:  # already reaped
                    log.debug("SIGTERM race on pid %s", p.pid)
        t0 = time.monotonic()
        while (time.monotonic() - t0 < self.kill_grace
               and any(p.poll() is None for p in procs)):
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                # SIGTERM cannot help a rank wedged in a native collective —
                # the Python handler never runs while C++ holds the thread
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                log.warning("worker pid %s survived SIGKILL wait", p.pid)

    def _collect(self, procs) -> List[WorkerResult]:
        results = []
        for rank, p in enumerate(procs):
            out = err = ""
            paths = getattr(p, "tdl_log_paths", None)
            if paths:
                for i, path in enumerate(paths):
                    try:
                        with open(path) as f:
                            text = f.read()
                    except OSError:
                        text = ""
                    if i == 0:
                        out = text
                    else:
                        err = text
            results.append(WorkerResult(rank, p.returncode, out, err))
        return results

    # ------------------------------------------------------------ postmortem

    def _note_failure(self, failure: GangEvent) -> None:
        """Expose the last failure classification through the registry: a
        dashboard reading ``/metrics.json`` sees WHY the gang last
        restarted, not just that ``tdl_gang_restarts_total`` moved."""
        self.last_failure = {
            "reason": failure.reason,
            "ranks": list(failure.ranks),
            "iteration": failure.iteration,
            "restarts": self.restarts,
        }
        self._flight.record("gang_failure", reason=failure.reason,
                            ranks=list(failure.ranks),
                            iteration=failure.iteration,
                            attempt=failure.attempt, detail=failure.detail)
        self._last_failure_info.clear_children()  # one series: the LATEST
        self._last_failure_info.labels(
            failure.reason,
            str(failure.ranks[0]) if failure.ranks else "",
            str(failure.iteration) if failure.iteration is not None else "",
        ).set(self.restarts)

    def _note_recovery_postmortem(self) -> None:
        """After a successful completion that needed ≥1 restart: if the
        final incarnation's flight spools carry checkpoint quarantine /
        fallback events (the workers healed a torn or corrupt checkpoint on
        their way back up), re-write the postmortem with
        ``classification: "recovered"`` so the on-disk record shows HOW the
        gang healed: which generation was quarantined, which one restore
        fell back to, and (with ``ckpt_dir`` set) the final lineage state.
        Ordinary recoveries keep the failure-time postmortem untouched."""
        if not self.events:
            return
        flight_dir = getattr(self, "flight_dir", None)
        spools = flight.read_spools(
            flight_dir, on_error=aggregate.spool_error_counter(
                "flight", self.registry, prefix=flight.SPOOL_PREFIX)) \
            if flight_dir else []
        if not any(e.get("kind") in ("ckpt_quarantine", "ckpt_fallback")
                   for e in flight.merge_events(spools, [])):
            return
        self._write_postmortem(self.events[-1], classification="recovered",
                               spools=spools)

    def _write_postmortem(self, failure: GangEvent,
                          classification: Optional[str] = None,
                          spools: Optional[list] = None) -> str:
        """Merge every rank's flight-recorder spool (plus the supervisor's
        own ring) into ONE monotonic-clock-ordered ``postmortem.json`` so an
        unattended failure is debuggable after the fact. Overwritten on each
        failure — the file always describes the most recent one. ``spools``
        lets a caller that already read them skip the second disk pass."""
        if spools is None:
            flight_dir = getattr(self, "flight_dir", None)
            spools = flight.read_spools(
                flight_dir, on_error=aggregate.spool_error_counter(
                    "flight", self.registry, prefix=flight.SPOOL_PREFIX)) \
                if flight_dir else []
        events = flight.merge_events(spools, self._flight.events())
        doc = {
            "classification": classification or failure.reason,
            "reason": failure.reason,
            "ranks": list(failure.ranks),
            "iteration": failure.iteration,
            "attempt": failure.attempt,
            "restarts_performed": self.restarts,
            "detail": failure.detail,
            "written_wall": time.time(),  # wallclock-ok: report timestamp for humans
            "procs": sorted({e.get("proc", "?") for e in events}),
            # compile-churn offenders: per-(proc, fn) compile count +
            # seconds from ``compile`` events, worst first
            "compile_churn": _compile_churn(events),
            # alert INTERVALS: paired alert/alert_clear edges — what was
            # firing (and for how long) around the failure
            "alert_intervals": _alert_intervals(events),
            # elastic resizes performed so far: how the gang got to its
            # current size is headline material, not something to
            # reverse-engineer from the timeline
            "resizes": list(self.resizes),
            "gang_size": self.n_processes,
            "events": events,
        }
        if self.ckpt_dir:
            # checkpoint lineage inventory: a fallback respawn's postmortem
            # must SHOW the quarantined generation and where the pointer
            # stood, not make the reader diff the filesystem
            from ..serde.checkpoint import lineage_state

            try:
                doc["checkpoint"] = lineage_state(self.ckpt_dir)
            except Exception as e:  # inventory is evidence, never a new crash
                doc["checkpoint"] = {"error": str(e)}
        # the timeline rides along: every attempt's flight spools + the
        # supervisor's own ring, skew-corrected into one Perfetto-loadable
        # chrome trace next to the postmortem
        doc["timeline"] = self._write_timeline_artifact()
        tmp = self.postmortem_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, self.postmortem_path)
        log.warning("postmortem written to %s (%d events from %d procs)",
                    self.postmortem_path, len(events), len(doc["procs"]))
        return self.postmortem_path

    def _write_timeline_artifact(self) -> Optional[str]:
        """``workdir/timeline.json``: the merged chrome trace over EVERY
        attempt's flight dir (a postmortem wants the crashed incarnation
        AND its respawn on the same wall axis). Evidence, never a new
        crash — returns None on failure."""
        from ..monitoring import timeline as _timeline

        try:
            dirs = sorted(
                os.path.join(self.workdir, d)
                for d in os.listdir(self.workdir)
                if d.startswith("flight_")
                and os.path.isdir(os.path.join(self.workdir, d)))
            return _timeline.write_timeline(
                os.path.join(self.workdir, "timeline.json"),
                flight_dirs=dirs, extra_events=self._flight.events(),
                registry=self.registry)
        except Exception:
            log.exception("timeline export failed (postmortem continues "
                          "without it)")
            return None

    # -------------------------------------------------------- classification

    def _bind_failure(self, procs, dead_ranks) -> bool:
        # only rank 0 hosts the TCP store; bind-ish stderr on any other rank
        # is that worker's own failure (see launcher.coordinator_bind_failed)
        if 0 not in dead_ranks:
            return False
        paths = getattr(procs[0], "tdl_log_paths", None)
        if not paths:
            return False
        try:
            with open(paths[1]) as f:
                return bool(_BIND_FAILURE_RE.search(f.read()))
        except OSError:
            return False

    def _hb_iter(self, hb_dir: str, rank: int) -> Optional[int]:
        hb = read_heartbeat(hb_dir, rank)
        return hb[0] if hb else None

    def _classify_or_raise(self, failure: GangEvent) -> None:
        """Repeated crash at the same (ranks, iteration) is deterministic —
        restarting cannot help; surface it instead of burning the budget."""
        if failure.reason != "crash":
            return
        self._crash_history.append(failure.iteration)
        if failure.iteration is None:
            return
        repeats = self._crash_history.count(failure.iteration)
        if repeats >= self.same_iteration_fatal:
            raise GangFailedError(
                f"rank(s) {failure.ranks} crashed {repeats}x at iteration "
                f"{failure.iteration} — deterministic fault, not restarting",
                "repeated_crash_same_iteration", self.events)

    def _try_resize(self, failure: GangEvent) -> bool:
        """Elastic degrade: called when the restart budget at the current
        size is exhausted. Returns True when the gang was resized to the
        surviving healthy ranks (the run loop then respawns at the new size
        with a fresh budget); False means fatal is the right call.

        The culprit set is the INTERSECTION of the implicated ranks across
        the budget-exhausting failures at this size — a permanently dead
        host names itself every time; a wandering failure (different ranks
        each attempt) is a software fault resizing can't fix."""
        if not self.elastic or failure.reason not in ("crash", "hang"):
            return False
        # only crash/hang failures AT THIS SIZE vote: a bind race rides its
        # own budget (and implicates rank 0 by construction), and events
        # from before a previous resize carry renumbered rank ids — either
        # would poison the intersection and block a legitimate resize
        recent = [e for e in self.events[self._events_mark:]
                  if e.reason in ("crash", "hang")][-(self.max_restarts + 1):]
        suspects = set(failure.ranks)
        for e in recent:
            suspects &= set(e.ranks)
        if not suspects:
            return False
        new_n = self.n_processes - len(suspects)
        if new_n < self.min_processes or new_n >= self.n_processes:
            return False
        from .partition import largest_layout

        layout = largest_layout(new_n * self.n_local_devices,
                                pipe=self.pipe_stages)
        entry = {
            "direction": "down",
            "from_processes": self.n_processes,
            "to_processes": new_n,
            "suspect_ranks": sorted(suspects),
            "reason": failure.reason,
            "iteration": failure.iteration,
            "restarts_spent": self.restarts,
            "survivor_layout": layout.describe(),
        }
        self.resizes.append(entry)
        self._resizes_ctr.labels("down").inc()
        self._flight.record("gang_resize", **entry)
        log.warning(
            "elastic resize: gang degrades %d -> %d processes (ranks %s "
            "kept failing; survivors restore cross-layout and continue)",
            self.n_processes, new_n, sorted(suspects))
        self.n_processes = new_n
        # fresh budget + fresh crash history: the smaller gang is a new
        # context — but a deterministic same-iteration crash will re-classify
        # itself fatal there just as it would have here
        self._restarts_this_size = 0
        self._crash_history.clear()
        self._events_mark = len(self.events)
        # re-write the postmortem NOW so the on-disk record carries the
        # resize (the per-failure write above ran before the decision)
        self._write_postmortem(failure, classification="elastic_resize")
        return True

    def _final_classification(self, failure: GangEvent) -> str:
        if (failure.reason == "crash" and failure.iteration is not None
                and self._crash_history.count(failure.iteration) >= 2):
            return "repeated_crash_same_iteration"
        return failure.reason

    def _backoff(self, attempt: int) -> None:
        delay = min(self.backoff_max, self.backoff_base * (2 ** (attempt - 1)))
        delay *= 1.0 + self.backoff_jitter * random.random()
        time.sleep(delay)
