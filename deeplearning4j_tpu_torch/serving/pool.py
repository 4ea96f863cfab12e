"""ServingPool — elastic replica-pool serving (copy of the JAX package's
``serving.pool``; its replicas run the port, one CUDA context each).

DL4J's ``ParallelInference`` runs N model replicas behind one queue. Here the
replicas are whole serving PROCESSES under one supervisor: per-replica
heartbeat files, spawn/kill/respawn with bounded backoff, stable
spool/history/compile-cache env contracts — and, because replicas are
INDEPENDENT, a dead one drains and respawns alone.

Three cooperating parts:

- **replica processes** — each runs a replica target (``module:function`` or
  ``/path/file.py:fn`` returning a ``JsonModelServer``), publishes its bound
  port through a port file, beats a per-replica heartbeat, spools metrics
  with a RESTART-STABLE ``proc=replica{N}`` identity, and — because
  ``TDL_COMPILE_CACHE_DIR`` points at one stable pool-wide dir — loads the
  kernels that the first replica built there (``common.compile_cache``), so
  a respawn or a scale-up pays no ``nvcc``. Each replica process owns its
  own CUDA context; ``CUDA_VISIBLE_DEVICES`` passes through from the caller;
- **the front router** — one HTTP door with least-loaded dispatch over the
  READY replicas, per-replica circuit breakers (consecutive connection/5xx
  failures open a replica for a cooldown), transparent failover on
  connection errors, an aggregated ``/ready`` (200 iff >= ``min_replicas``
  replicas are warm, else 503 + ``Retry-After`` whose body says ``pool not
  ready`` — the marker ``JsonModelClient`` treats like a 429), and a
  ``/health`` that stays live while replicas restart;
- **the supervisor/monitor** — liveness + heartbeat-staleness polling,
  bounded per-replica respawn with exponential backoff, reconciliation of
  live replicas against the DESIRED size, and the ``tdl_pool_*`` gauges.
  Scale-downs and swaps DRAIN before they signal: the router stops
  dispatching (state ``draining``), in-flight requests finish, then
  SIGTERM — no request ever races into a dying replica.

:meth:`ServingPool.swap_model` rolls a new model version through the pool
replica-by-replica with zero downtime: surge-spawn one replica on the new
version, validate it behind the existing ``/ready`` aggregation, drain one
old replica, and repeat — the pool never drops below the desired ready
count, and a version that cannot serve rolls back before any old replica is
touched.

:class:`PoolAutoscaler` turns ``AlertEngine`` rules (queue-depth HWM,
windowed p99, burn rate, shed rate — with their ``for_duration`` /
``clear_hysteresis`` anti-flap semantics) into ``scale_to`` ACTIONS, with a
cooldown and an all-clear streak requirement so the pool cannot flap.

Not ported yet: the canary surge (``start_canary``/``stop_canary``), the
deployment controller's arm, which waits for ``deploy/controller.py``.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

from ..common import compile_cache
from ..monitoring import aggregate, flight, history
from ..monitoring.flight import ENV_PROC, atomic_json_write
from ..monitoring.heartbeat import (ENV_DIR as HB_ENV_DIR,
                                    ENV_INTERVAL as HB_ENV_INTERVAL,
                                    HeartbeatWriter, read_heartbeat)
from ..monitoring.registry import MetricsRegistry, get_registry
from ..monitoring.serving import pool_metrics, serving_metrics

log = logging.getLogger(__name__)

ENV_REPLICA_ID = "TDL_REPLICA_ID"
ENV_PORT_FILE = "TDL_REPLICA_PORT_FILE"
#: checkpoint handed to replica targets by swap_model — targets
#: read it at build time; a respawned replica keeps ITS version's value
ENV_MODEL_CKPT = "TDL_MODEL_CKPT"

#: delta-seconds hint on router 503s (matches json_server.RETRY_AFTER_S)
RETRY_AFTER_S = 1
#: router-level request-body cap (the replica enforces its own too)
DEFAULT_MAX_BODY_BYTES = 16 << 20
#: headers the router forwards verbatim to the chosen replica
_FORWARD_HEADERS = ("X-Request-Id", "X-Trace-Id", "X-Deadline-Ms",
                    "X-Max-New-Tokens", "Content-Type")


# ------------------------------------------------------------ replica entry


def _load_target(target: str):
    """``module:function`` or ``/path/to/file.py:function`` — the same two
    target forms ``parallel.launcher`` workers accept."""
    mod_name, _, fn_name = target.rpartition(":")
    if mod_name.endswith(".py"):
        import importlib.util

        spec = importlib.util.spec_from_file_location("_tdl_replica_target",
                                                      mod_name)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        import importlib

        mod = importlib.import_module(mod_name)
    return getattr(mod, fn_name)


def _replica_main(argv: Sequence[str]) -> None:
    """Replica process entry: build the target's ``JsonModelServer``, start
    it, publish the bound port, then beat/spool until SIGTERM asks for a
    graceful drain. ``python -m deeplearning4j_tpu_torch.serving.pool
    mod:fn``."""
    target = argv[0]
    replica_id = int(os.environ.get(ENV_REPLICA_ID, "0"))
    port_file = os.environ[ENV_PORT_FILE]
    # honor the pool's shared kernel build BEFORE the target builds a
    # model: warmup then loads the built kernels instead of running nvcc
    compile_cache.maybe_enable_from_env()
    server = _load_target(target)()
    if server is None:
        raise RuntimeError(f"replica target {target!r} returned None — it "
                           f"must return a JsonModelServer")
    server.start()
    atomic_json_write(port_file, {"port": server.port, "pid": os.getpid()})
    stop_evt = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_evt.set())
    hb_dir = os.environ.get(HB_ENV_DIR)
    writer = (HeartbeatWriter(hb_dir, replica_id,
                              float(os.environ.get(HB_ENV_INTERVAL, "0.25")))
              if hb_dir else None)
    beats = 0
    log.info("replica %d serving on port %d", replica_id, server.port)
    while not stop_evt.wait(0.1):
        beats += 1
        if writer:
            writer.beat(beats)
        aggregate.maybe_spool()
    server.stop(drain=True)
    aggregate.maybe_spool(force=True)
    # the final spans must reach the spool the fleet timeline reads — the
    # throttled in-loop flushes may be up to one interval behind
    flight.flush()


# ---------------------------------------------------------------- the pool


@dataclass
class ReplicaHandle:
    """Supervisor-side view of one replica process."""

    id: int
    proc: Optional[subprocess.Popen] = None
    port: Optional[int] = None
    state: str = "starting"          # starting|ready|unready|draining|dead
    spawned_at: float = 0.0
    restarts: int = 0
    retiring: bool = False
    surge: bool = False              # swap-roll extra: not a desired seat
    signaled: bool = False           # SIGTERM sent (drain complete/forced)
    drain_deadline: float = 0.0      # forced-signal time for a drain
    inflight: int = 0                # router's in-flight count (least-loaded)
    fails: int = 0                   # consecutive breaker failures
    breaker_open_until: float = 0.0
    next_spawn_at: float = 0.0
    port_file: str = ""
    hb_dir: str = ""                 # per-INCARNATION (see _spawn_replica)
    last_hb: Optional[Tuple[int, float]] = None
    hb_changed_at: float = 0.0
    #: per-replica env (the model version): survives respawns of THIS handle
    env_overrides: Dict[str, str] = field(default_factory=dict)

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def breaker_closed(self, now: float) -> bool:
        return now >= self.breaker_open_until


class ServingPool:
    """N independent serving replicas behind one least-loaded front door.

    ``target`` builds one replica's ``JsonModelServer`` (port 0 — each
    replica binds its own). The pool supervises: spawn, per-replica
    heartbeat/liveness, bounded respawn with backoff (cheap thanks to the
    shared kernel build), DESIRED-size reconciliation
    (:meth:`scale_to`), and the aggregated readiness contract — ``/ready``
    flips 503 the moment fewer than ``min_replicas`` replicas are warm
    while ``/health`` stays 200 throughout a restart.
    """

    def __init__(self, target: str, *, replicas: int = 2,
                 min_replicas: int = 1, max_replicas: int = 8,
                 workdir: Optional[str] = None,
                 extra_env: Optional[Dict[str, str]] = None,
                 endpoint: str = "/predict", port: int = 0,
                 heartbeat_interval: float = 0.25,
                 hang_timeout: float = 20.0, startup_grace: float = 120.0,
                 probe_interval: float = 0.15,
                 max_restarts_per_replica: int = 10,
                 restart_backoff_base: float = 0.2,
                 restart_backoff_max: float = 5.0,
                 breaker_threshold: int = 3, breaker_cooldown: float = 1.0,
                 request_timeout: float = 40.0,
                 max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
                 drain_grace: float = 45.0,
                 swap_ready_timeout: float = 180.0,
                 registry: Optional[MetricsRegistry] = None):
        if not (1 <= min_replicas <= max_replicas):
            raise ValueError(f"need 1 <= min_replicas <= max_replicas, got "
                             f"{min_replicas}/{max_replicas}")
        if not (min_replicas <= replicas <= max_replicas):
            raise ValueError(f"replicas={replicas} outside "
                             f"[{min_replicas}, {max_replicas}]")
        self.target = target
        self.desired = replicas
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.extra_env = dict(extra_env or {})
        self.endpoint = endpoint
        self.port = port
        self.heartbeat_interval = heartbeat_interval
        self.hang_timeout = hang_timeout
        self.startup_grace = startup_grace
        self.probe_interval = probe_interval
        self.max_restarts_per_replica = max_restarts_per_replica
        self.restart_backoff_base = restart_backoff_base
        self.restart_backoff_max = restart_backoff_max
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self.request_timeout = request_timeout
        self.max_body_bytes = max_body_bytes
        self.drain_grace = drain_grace
        self.swap_ready_timeout = swap_ready_timeout
        #: env applied to NEW replica handles (the current model version);
        #: swap_model updates it on success so scale-ups spawn the new model
        self._default_overrides: Dict[str, str] = {}
        self._swap_lock = threading.Lock()
        import tempfile

        self.workdir = workdir or tempfile.mkdtemp(prefix="tdl_pool_")
        os.makedirs(self.workdir, exist_ok=True)
        #: stable across replica incarnations — same contracts as
        #: GangSupervisor (spool merge dedupes by newest per proc identity)
        self.spool_dir = os.path.join(self.workdir, "spool")
        self.history_dir = os.path.join(self.workdir, "history")
        self.compile_cache_dir = os.path.join(self.workdir, "compile_cache")
        self.hb_dir = os.path.join(self.workdir, "hb")
        self.flight_dir = os.path.join(self.workdir, "flight")
        #: run identity: replicas inherit it via TDL_RUN_ID, so
        #: every lane of this pool's fleet timeline carries the same run id
        import uuid

        self.run_id = uuid.uuid4().hex[:12]
        self._ports_dir = os.path.join(self.workdir, "ports")
        self._logs_dir = os.path.join(self.workdir, "logs")
        for d in (self.hb_dir, self._ports_dir, self._logs_dir):
            os.makedirs(d, exist_ok=True)
        self.registry = registry if registry is not None else get_registry()
        self._m = pool_metrics(self.registry)
        self._sm = serving_metrics(self.registry)  # router response codes
        self._deaths = self.registry.counter(
            "tdl_worker_deaths_total",
            "Supervised worker deaths by failure classification",
            labels=("reason",))
        self._lock = threading.RLock()
        self._replicas: Dict[int, ReplicaHandle] = {}
        self._next_id = 0
        self._stop_evt = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._probe_pool = None  # ThreadPoolExecutor while started

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingPool":
        if self._monitor_thread is not None:
            return self
        self._stop_evt.clear()
        from concurrent.futures import ThreadPoolExecutor

        self._probe_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="tdl-pool-probe")
        with self._lock:
            for _ in range(self.desired):
                self._spawn_replica()
        self._monitor_thread = threading.Thread(
            target=self._monitor, name="tdl-pool-monitor", daemon=True)
        self._monitor_thread.start()
        self._start_router()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the router, SIGTERM every replica (their mains drain), then
        SIGKILL stragglers. Idempotent."""
        self._stop_evt.set()
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        thread, self._monitor_thread = self._monitor_thread, None
        if thread is not None:
            thread.join(timeout=10.0)
        probe_pool, self._probe_pool = self._probe_pool, None
        if probe_pool is not None:
            probe_pool.shutdown(wait=False)
        with self._lock:
            handles = list(self._replicas.values())
        for h in handles:
            if h.alive:
                try:
                    h.proc.send_signal(signal.SIGTERM)
                except OSError:
                    log.debug("SIGTERM race on replica %d", h.id)
        deadline = time.monotonic() + (timeout if drain else 2.0)
        while (time.monotonic() < deadline
               and any(h.alive for h in handles)):
            time.sleep(0.05)
        for h in handles:
            if h.alive:
                h.proc.kill()
        for h in handles:
            if h.proc is not None:
                try:
                    h.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    log.warning("replica %d survived SIGKILL wait", h.id)
        # drop the dead handles: a later start() must spawn a FRESH set, not
        # stack `desired` new replicas on top of stale ones the monitor
        # would then death-count, respawn, and re-retire
        with self._lock:
            self._replicas.clear()
        self._m.size.set(0)

    # -- scaling -----------------------------------------------------------

    def scale_to(self, n: int, reason: str = "") -> int:
        """Set the DESIRED replica count (clamped to
        ``[min_replicas, max_replicas]``); the monitor reconciles. Returns
        the clamped target. Counts ``tdl_pool_scale_events_total`` and
        leaves a ``pool_scale`` flight breadcrumb on actual changes."""
        n = max(self.min_replicas, min(self.max_replicas, int(n)))
        with self._lock:
            if n == self.desired:
                return n
            direction = "up" if n > self.desired else "down"
            prev, self.desired = self.desired, n
        self._m.scale_events.labels(direction=direction).inc()
        flight.record("pool_scale", direction=direction, from_replicas=prev,
                      to_replicas=n, reason=reason)
        log.info("pool scale %s: %d -> %d (%s)", direction, prev, n,
                 reason or "manual")
        return n

    # -- zero-downtime model swap -------------------------------------------

    def swap_model(self, ckpt: Optional[str] = None, *,
                   env: Optional[Dict[str, str]] = None,
                   ready_timeout: Optional[float] = None,
                   preflight_verify: bool = True) -> dict:
        """Roll every replica onto a new model version with zero downtime.

        ``ckpt`` lands in the replicas' env as ``TDL_MODEL_CKPT`` (targets
        read it at build time); ``env`` passes arbitrary extra version env.
        With ``preflight_verify`` (the default), ``ckpt`` is deep-verified
        first (``serde.checkpoint.verify_checkpoint``): a checkpoint that
        fails is REJECTED before any surge replica is spawned
        (``tdl_pool_swap_rejected_total``, a ``pool_swap_rejected`` flight
        event with the full verdict, ``ValueError``). A path that is no
        checkpoint at all (targets may interpret ``TDL_MODEL_CKPT`` however
        they like — a config file, a zip) passes through to the
        surge-replica readiness validation, which remains the universal
        gate. ``preflight_verify=False`` skips the check entirely.
        Surge-style roll, one replica at a time:

        1. spawn ONE extra replica on the new version (it loads the shared
           kernel build, so this is a model build, not an nvcc run),
        2. wait until it is READY behind the existing ``/ready`` aggregation
           — this is the swap validation: a version that cannot serve never
           touches the old fleet,
        3. DRAIN one old replica (the router stops dispatching first, its
           in-flight requests finish, then SIGTERM — the satellite drain
           fix), and repeat.

        The pool therefore never drops below ``desired`` ready replicas (let
        alone ``min_replicas``). A surge replica that fails validation is
        killed and the swap ROLLS BACK with the old version fully serving
        (``tdl_pool_swap_rollbacks_total``); validation happens before the
        first old replica is touched, so a bad checkpoint cannot degrade the
        pool at all. Returns ``{"ok", "swapped", "rolled_back", "window_s"}``.
        """
        overrides = dict(env or {})
        if ckpt is not None:
            overrides[ENV_MODEL_CKPT] = str(ckpt)
        if not overrides:
            raise ValueError("swap_model needs a checkpoint path or env")
        if ckpt is not None and preflight_verify:
            from ..serde.checkpoint import verify_checkpoint

            report = verify_checkpoint(str(ckpt))
            # reason "no_checkpoint" = the path is not a recognizable
            # TrainingCheckpointer lineage at all; such artifacts pass
            # through to the surge-replica validation
            if not report["ok"] and report["reason"] != "no_checkpoint":
                self._m.swap_rejected.inc()
                # the FULL verdict rides the event and the error: an audit
                # trail must name why the candidate was refused
                flight.record("pool_swap_rejected", model=str(ckpt),
                              reason=report["reason"],
                              generation=report.get("generation"),
                              iteration=report.get("iteration"),
                              format=report.get("format"),
                              verify_seconds=report.get("seconds"))
                raise ValueError(
                    f"swap_model rejected checkpoint {ckpt}: verification "
                    f"failed (reason={report['reason']}, generation="
                    f"{report.get('generation')}, iteration="
                    f"{report.get('iteration')}, format="
                    f"{report.get('format')}) — no surge replica was "
                    "spawned, the serving fleet is untouched")
        if not self._swap_lock.acquire(blocking=False):
            raise RuntimeError("a model swap is already in progress")
        t0 = time.perf_counter()
        swapped = 0

        def carries_new(h: ReplicaHandle) -> bool:
            return all(h.env_overrides.get(k) == v
                       for k, v in overrides.items())

        try:
            flight.record("pool_swap_begin",
                          model=overrides.get(ENV_MODEL_CKPT))
            with self._lock:
                # the new version becomes the pool default IMMEDIATELY: a
                # concurrent autoscaler scale-up or seat backfill mid-roll
                # must spawn the NEW model, not quietly re-introduce the old
                # one outside the roll's snapshot (reverted on rollback)
                prev_defaults = dict(self._default_overrides)
                self._default_overrides.update(overrides)
            # convergence loop, not a fixed snapshot: roll until no serving
            # replica still carries the old version (mid-roll deaths respawn
            # with THEIR handle's old env and re-enter the pending set)
            max_rolls = 2 * self.max_replicas + 4
            while True:
                with self._lock:
                    pending = [h for h in self._replicas.values()
                               if not h.retiring and not h.surge
                               and not carries_new(h)]
                    if not pending:
                        break
                    if swapped >= max_rolls:
                        raise RuntimeError(
                            f"model swap did not converge after {swapped} "
                            "rolls — replicas keep appearing on the old "
                            "version")
                    old = min(pending, key=lambda h: h.id)
                    surge = self._spawn_replica(
                        env_overrides=dict(overrides), surge=True)
                if not self._await_replica_ready(
                        surge, ready_timeout if ready_timeout is not None
                        else self.swap_ready_timeout):
                    self._rollback_swap(surge, overrides, prev_defaults,
                                        swapped)
                    return {"ok": False, "swapped": swapped,
                            "rolled_back": True,
                            "window_s": round(time.perf_counter() - t0, 3)}
                with self._lock:
                    # promote + drain under ONE lock hold: a reconcile pass
                    # between the two would see desired+1 serving replicas
                    # and drain the highest id — the replica just promoted
                    surge.surge = False
                    self._begin_drain(old, reason="model swap")
                self._await_gone(old, self.drain_grace + 15.0)
                swapped += 1
            self._m.swap_events.inc()
            window = round(time.perf_counter() - t0, 3)
            flight.record("pool_swap", swapped=swapped, window_s=window,
                          model=overrides.get(ENV_MODEL_CKPT))
            log.info("model swap complete: %d replicas rolled in %.2fs",
                     swapped, window)
            return {"ok": True, "swapped": swapped, "rolled_back": False,
                    "window_s": window}
        finally:
            self._swap_lock.release()

    def _rollback_swap(self, surge: ReplicaHandle, overrides, prev_defaults,
                       swapped: int) -> None:
        """Undo a failed validation: kill the surge, restore the previous
        default version for future spawns, and point any not-yet-ready
        replica that was spawned mid-roll on the broken version back at the
        old one (its next respawn reverts; replicas already READY on the new
        version keep it — they demonstrably serve)."""
        self._retire_now(surge)
        with self._lock:
            self._default_overrides = dict(prev_defaults)
            for h in self._replicas.values():
                if h.state != "ready" and all(
                        h.env_overrides.get(k) == v
                        for k, v in overrides.items()):
                    h.env_overrides = dict(prev_defaults)
        self._m.swap_rollbacks.inc()
        flight.record("pool_swap_rollback", replica=surge.id,
                      swapped=swapped,
                      model=overrides.get(ENV_MODEL_CKPT))
        log.error(
            "model swap rolled back: new-version replica %d never became "
            "ready (%d replicas already rolled keep the new version; the "
            "rest keep serving the old one)", surge.id, swapped)

    def _await_replica_ready(self, h: ReplicaHandle, timeout: float) -> bool:
        """Wait for ONE replica to probe ready; fail fast when its process
        dies (a crashing new version should not burn the whole timeout)."""
        r0 = h.restarts
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if h.state == "ready":
                return True
            if h.state == "dead" or h.restarts > r0 or not h.alive:
                return False
            time.sleep(0.02)
        return False

    def _retire_now(self, h: ReplicaHandle) -> None:
        """Kill + remove a replica that never served (failed surge): no
        drain needed, nothing is in flight on it by construction."""
        with self._lock:
            h.retiring = True
            h.signaled = True
            self._replicas.pop(h.id, None)
        if h.proc is not None:
            if h.alive:
                try:
                    h.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
            try:
                h.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(timeout=10)

    def _await_gone(self, h: ReplicaHandle, timeout: float) -> None:
        """Wait for a draining replica to exit and be reaped; force-kill at
        the deadline so a wedged old replica cannot hang the swap."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if h.id not in self._replicas:
                    return
            time.sleep(0.02)
        log.warning("replica %d outlived its drain window — force killing",
                    h.id)
        if h.alive:
            h.proc.kill()
        with self._lock:
            self._replicas.pop(h.id, None)

    # -- introspection -----------------------------------------------------

    @property
    def ready_count(self) -> int:
        with self._lock:
            return sum(1 for h in self._replicas.values()
                       if h.state == "ready" and not h.retiring)

    @property
    def live_count(self) -> int:
        with self._lock:
            return sum(1 for h in self._replicas.values() if h.alive)

    def replica_states(self) -> Dict[int, str]:
        with self._lock:
            return {h.id: h.state for h in self._replicas.values()}

    def replica_stats(self) -> Dict[int, dict]:
        """Best-effort ``GET /stats`` from every READY replica: for generative replicas over a paged pool this surfaces
        block occupancy, CoW savings and speculative acceptance fleet-wide
        — the numbers the capacity bench and a paging postmortem read.
        Replicas that fail the fetch are simply absent from the result."""
        import urllib.request

        with self._lock:
            targets = [(h.id, h.port) for h in self._replicas.values()
                       if h.state == "ready" and h.port]
        out: Dict[int, dict] = {}
        for rid, port in targets:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/stats", timeout=2.0) as resp:
                    out[rid] = json.loads(resp.read()).get("stats", {})
            except Exception:
                log.debug("replica %d /stats fetch failed", rid)
        return out

    def describe(self) -> dict:
        with self._lock:
            return {
                "desired": self.desired,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "replicas": [{
                    "id": h.id, "state": h.state, "port": h.port,
                    "inflight": h.inflight, "restarts": h.restarts,
                    "retiring": h.retiring, "surge": h.surge,
                    "model": h.env_overrides.get(ENV_MODEL_CKPT),
                    "breaker_open": not h.breaker_closed(time.monotonic()),
                } for h in self._replicas.values()],
            }

    def write_timeline(self, path: Optional[str] = None) -> str:
        """Merge every replica's flight spool (plus the router's own ring)
        into ONE Perfetto-loadable chrome-trace JSON under the workdir —
        request flows join the router's `route` slices to the replicas'
        request_spans by trace id. Returns the artifact path."""
        from ..monitoring import timeline as _timeline
        path = path or os.path.join(self.workdir, "timeline.json")
        dirs = [self.flight_dir]
        extra: List[dict] = []
        rec = flight.get_flight_recorder() if flight.active() else None
        if rec is not None:
            if rec.directory is None:
                extra = rec.events()  # in-memory ring: no spool to scan
            else:
                rec.flush()
                if rec.directory != self.flight_dir:
                    dirs.append(rec.directory)
        return _timeline.write_timeline(path, flight_dirs=dirs,
                                        extra_events=extra,
                                        registry=self.registry)

    def _readiness(self) -> Tuple[bool, str]:
        ready = self.ready_count
        if ready >= self.min_replicas:
            return True, ""
        return False, (f"pool not ready ({ready}/{self.min_replicas} "
                       f"replicas ready)")

    def wait_ready(self, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._readiness()[0]:
                return True
            time.sleep(0.02)
        return False

    # -- spawning ----------------------------------------------------------

    def _child_env(self, handle: ReplicaHandle) -> Dict[str, str]:
        """One replica's env contract (the GangSupervisor contracts, minus
        the gang): caller ``extra_env`` wins for the SHARED data contracts
        (spool/history/flight/compile-cache dirs); per-replica IDENTITY
        keys (replica id, port file, proc name, heartbeat dir/interval) are
        pool-owned and hard-assigned — inheriting a parent's values (e.g. a
        pool launched inside a supervised rank) would merge every replica's
        metrics under one proc and point heartbeats where the monitor never
        looks, a kill/respawn loop at startup_grace expiry."""
        env = dict(os.environ)
        env.update(self.extra_env)
        # per-handle model version (swap_model): after the identity block
        # below it could shadow pool-owned keys, so it applies FIRST
        env.update(handle.env_overrides)
        env[ENV_REPLICA_ID] = str(handle.id)
        env[ENV_PORT_FILE] = handle.port_file
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        # restart-stable proc identity: the spool/history merge dedupes a
        # respawned incarnation by proc name, never double-counts it
        env[ENV_PROC] = f"replica{handle.id}"
        env[HB_ENV_DIR] = handle.hb_dir or self.hb_dir
        env[HB_ENV_INTERVAL] = str(self.heartbeat_interval)
        env.setdefault(aggregate.ENV_DIR, self.spool_dir)
        env.setdefault(aggregate.ENV_INTERVAL, str(self.heartbeat_interval))
        env.setdefault(history.ENV_DIR, self.history_dir)
        env.setdefault(flight.ENV_DIR, self.flight_dir)
        env.setdefault(flight.ENV_RUN_ID, self.run_id)
        # shared kernel build: replica N+1's warmup (and a respawn of
        # replica N) loads what the first replica built — what makes
        # elastic scale-out cheap
        env.setdefault(compile_cache.ENV_DIR, self.compile_cache_dir)
        return env

    def _spawn_replica(self, handle: Optional[ReplicaHandle] = None,
                       env_overrides: Optional[Dict[str, str]] = None,
                       surge: bool = False) -> ReplicaHandle:
        """Spawn a new replica (fresh id) or respawn an existing handle's
        process in place. New handles inherit the pool's current model
        version (``_default_overrides``) unless ``env_overrides`` pins one;
        ``surge=True`` marks a swap-roll extra that must not count as a
        desired seat. Caller holds the lock."""
        if handle is None:
            handle = ReplicaHandle(id=self._next_id)
            handle.env_overrides = dict(self._default_overrides
                                        if env_overrides is None
                                        else env_overrides)
            handle.surge = surge
            self._next_id += 1
            self._replicas[handle.id] = handle
        handle.port_file = os.path.join(
            self._ports_dir, f"replica{handle.id}_{handle.restarts}.json")
        # heartbeats are keyed per INCARNATION (GangSupervisor's per-attempt
        # hb dirs, same reason): a respawn must earn startup_grace anew
        # — inheriting the dead incarnation's file would hand the
        # new process only hang_timeout to boot, a kill/respawn loop for
        # any replica that imports torch + builds a model before its first beat
        handle.hb_dir = os.path.join(self.hb_dir, f"i{handle.restarts}")
        os.makedirs(handle.hb_dir, exist_ok=True)
        handle.port = None
        handle.state = "starting"
        handle.retiring = False
        handle.signaled = False
        handle.drain_deadline = 0.0
        handle.fails = 0
        handle.breaker_open_until = 0.0
        handle.last_hb = None
        handle.spawned_at = handle.hb_changed_at = time.monotonic()
        log_path = os.path.join(
            self._logs_dir, f"replica{handle.id}_{handle.restarts}.log")
        logf = open(log_path, "w")
        handle.proc = subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.serving.pool",
             self.target],
            env=self._child_env(handle), stdout=logf, stderr=logf)
        logf.close()  # the child holds the fd
        flight.record("replica_spawn", replica=handle.id,
                      restarts=handle.restarts)
        log.info("spawned replica %d (pid %d, incarnation %d)", handle.id,
                 handle.proc.pid, handle.restarts)
        return handle

    # -- monitor -----------------------------------------------------------

    def _monitor(self) -> None:
        while not self._stop_evt.wait(self.probe_interval):
            try:
                self._reconcile()
                self._poll_replicas()
                self._update_gauges()
            except Exception:
                log.exception("pool monitor iteration failed")

    def _reconcile(self) -> None:
        """Drive the live replica set toward ``desired``: spawn the missing,
        DRAIN the surplus (highest ids first). Surge replicas (a swap roll
        in flight) are not desired seats — they neither satisfy the count
        nor get retired by it."""
        with self._lock:
            serving = [h for h in self._replicas.values()
                       if not h.retiring and not h.surge]
            if len(serving) < self.desired:
                for _ in range(self.desired - len(serving)):
                    self._spawn_replica()
            elif len(serving) > self.desired:
                for h in sorted(serving, key=lambda h: -h.id)[
                        :len(serving) - self.desired]:
                    self._begin_drain(h, reason="scale down")

    def _begin_drain(self, h: ReplicaHandle, reason: str) -> None:
        """Drain before signal: the ROUTER
        stops dispatching to the replica FIRST — retiring/draining replicas
        are excluded from ``_pick_replica`` under the same lock that admits
        in-flight requests — and only once its in-flight count hits zero (or
        ``drain_grace`` expires) does the monitor send SIGTERM. Before this,
        a request could race into a replica that was already being signaled,
        die on the closing socket, and burn a breaker count + a failover on
        a perfectly healthy pool transition."""
        with self._lock:
            if h.retiring:
                return
            h.retiring = True
            h.state = "draining"
            h.drain_deadline = time.monotonic() + self.drain_grace
        flight.record("replica_retire", replica=h.id, reason=reason)
        log.info("draining replica %d (%s)", h.id, reason)

    def _poll_replicas(self) -> None:
        now = time.monotonic()
        with self._lock:
            handles = list(self._replicas.values())
        to_probe = []
        for h in handles:
            if h.retiring:
                if not h.alive:
                    with self._lock:
                        self._replicas.pop(h.id, None)
                    continue
                if not h.signaled:
                    with self._lock:
                        idle = h.inflight == 0
                        forced = now >= h.drain_deadline
                        if idle or forced:
                            h.signaled = True
                    if idle or forced:
                        try:
                            h.proc.send_signal(signal.SIGTERM)
                        except OSError:
                            log.debug("drain-signal race on replica %d", h.id)
                        flight.record("replica_drain_complete", replica=h.id,
                                      forced=bool(forced and not idle))
                continue
            if not h.alive:
                self._on_death(h, "replica_crash", now)
                continue
            if h.port is None:
                self._read_port_file(h)
            self._check_heartbeat(h, now)
            if h.alive and h.port is not None and h.state != "dead":
                to_probe.append(h)
        # readiness probes run CONCURRENTLY: one wedged-but-accepting
        # replica costs the monitor iteration its 2s probe timeout once,
        # not 2s x replicas of delayed hang-kills and reconciliation
        probe_pool = self._probe_pool
        if not to_probe:
            return
        if probe_pool is None or len(to_probe) == 1:
            for h in to_probe:
                self._probe_ready(h)
        else:
            list(probe_pool.map(self._probe_ready, to_probe))

    def _on_death(self, h: ReplicaHandle, reason: str, now: float) -> None:
        if h.state != "dead":
            h.state = "dead"
            self._deaths.labels(reason).inc()
            flight.record("replica_death", replica=h.id, reason=reason,
                          restarts=h.restarts)
            log.warning("replica %d died (%s, incarnation %d)", h.id, reason,
                        h.restarts)
            if h.restarts >= self.max_restarts_per_replica:
                # retire the handle so it stops occupying a desired-count
                # seat: the poll loop reaps it and _reconcile backfills with
                # a FRESH replica (fresh id, fresh budget) — a crash-looping
                # target churns at backoff pace, but a transient failure
                # burst can never permanently pin the pool below
                # min_replicas with /ready stuck at 503
                log.error("replica %d exhausted its restart budget (%d) — "
                          "retiring it; a fresh replica will be spawned",
                          h.id, h.restarts)
                h.next_spawn_at = float("inf")
                h.retiring = True
                return
            backoff = min(self.restart_backoff_max,
                          self.restart_backoff_base * (2 ** h.restarts))
            h.next_spawn_at = now + backoff
        elif now >= h.next_spawn_at:
            with self._lock:
                # re-check under the lock: a swap rollback's _retire_now can
                # pop the handle between this poll's snapshot and here —
                # respawning a popped handle would launch a process nothing
                # ever polls, signals, or reaps
                if h.retiring or h.id not in self._replicas:
                    return
                h.restarts += 1
                self._spawn_replica(h)

    def _read_port_file(self, h: ReplicaHandle) -> None:
        try:
            with open(h.port_file) as f:
                doc = json.load(f)
            if doc.get("pid") == h.proc.pid:  # never trust a stale incarnation
                h.port = int(doc["port"])
        except (OSError, ValueError, KeyError):
            pass  # not published yet

    def _check_heartbeat(self, h: ReplicaHandle, now: float) -> None:
        hb = read_heartbeat(h.hb_dir or self.hb_dir, h.id)
        if hb != h.last_hb and hb is not None:
            h.last_hb = hb
            h.hb_changed_at = now
            return
        budget = self.startup_grace if h.last_hb is None else self.hang_timeout
        if now - h.hb_changed_at > budget:
            # a wedged replica is as gone as a dead one: kill + respawn path
            log.warning("replica %d heartbeat stalled >%.1fs — killing", h.id,
                        budget)
            if h.alive:
                h.proc.kill()
            self._on_death(h, "replica_hang", now)

    def _probe_ready(self, h: ReplicaHandle) -> None:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{h.port}/ready", timeout=2.0):
                h.state = "ready"
        except urllib.error.HTTPError:
            h.state = "unready"  # the process answers but is warming/draining
        except (urllib.error.URLError, OSError):
            h.state = "unready"

    #: the full state domain — the gauge emits 0 for a replica's OTHER
    #: states (as its help text promises), so alert/dashboard expressions
    #: like {state="dead"} == 0 match instead of seeing a missing series
    _STATES = ("starting", "ready", "unready", "draining", "dead")

    def _update_gauges(self) -> None:
        with self._lock:
            self._m.size.set(sum(1 for h in self._replicas.values()
                                 if h.alive))
            self._m.replica_state.clear_children()
            for h in self._replicas.values():
                for st in self._STATES:
                    self._m.replica_state.labels(
                        replica=str(h.id), state=st).set(
                            1.0 if st == h.state else 0.0)

    # -- router ------------------------------------------------------------

    def _pick_replica(self, exclude) -> Optional[ReplicaHandle]:
        """Least-loaded dispatch over ready, breaker-closed replicas. The
        in-flight count is taken UNDER the same lock that excludes draining
        replicas, so _begin_drain can trust inflight==0: no request can be
        between "picked" and "counted" when the drain decision is made."""
        now = time.monotonic()
        with self._lock:
            ok = [h for h in self._replicas.values()
                  if h.state == "ready" and not h.retiring and h.alive
                  and h.port is not None and h.id not in exclude
                  and h.breaker_closed(now)]
            if not ok:
                return None
            h = min(ok, key=lambda h: (h.inflight, h.id))
            h.inflight += 1
            return h

    def _note_success(self, h: ReplicaHandle) -> None:
        with self._lock:
            h.fails = 0

    def _note_failure(self, h: ReplicaHandle, reason: str) -> None:
        """Per-replica circuit breaker: consecutive connection/5xx failures
        open the replica for a cooldown so the router stops feeding a sick
        one while the monitor decides its fate."""
        with self._lock:
            h.fails += 1
            if h.fails >= self.breaker_threshold:
                h.breaker_open_until = time.monotonic() + self.breaker_cooldown
                flight.record("replica_breaker_open", replica=h.id,
                              reason=reason, fails=h.fails)
                log.warning("replica %d breaker open after %d consecutive "
                            "failures (%s)", h.id, h.fails, reason)

    def _start_router(self) -> None:
        pool = self

        class Handler(BaseHTTPRequestHandler):
            timeout = 30.0

            def log_message(self, *args):
                pass

            def _json(self, obj, code=200, retry_after=None, headers=None):
                self._raw(code, json.dumps(obj).encode(), "application/json",
                          retry_after, headers)

            def _raw(self, code, payload, content_type, retry_after=None,
                     headers=None):
                self.send_response(code)
                self.send_header("Content-Type",
                                 content_type or "application/json")
                self.send_header("Content-Length", str(len(payload)))
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                try:
                    self.wfile.write(payload)
                except (BrokenPipeError, ConnectionResetError):
                    log.debug("router client went away before the response")

            def do_GET(self):
                if self.path == "/health":
                    # LIVENESS of the front door: 200 while the router runs,
                    # replicas restarting or not — balancers must not kill
                    # the pool for a rolling restart
                    self._json({"status": "ok"})
                elif self.path == "/ready":
                    ready, reason = pool._readiness()
                    if ready:
                        self._json({"ready": True,
                                    "replicas_ready": pool.ready_count})
                    else:
                        self._json({"ready": False, "error": reason},
                                   503, retry_after=RETRY_AFTER_S)
                elif self.path == "/replicas":
                    self._json(pool.describe())
                elif self.path == "/stats":
                    # fleet view of the replicas' executor stats (paged
                    # decode: block occupancy / CoW / acceptance)
                    self._json({"replicas": pool.replica_stats()})
                else:
                    self._json({"error": "POST " + pool.endpoint}, 404)

            def do_POST(self):
                code, payload, ctype, retry_after, headers = pool._route(self)
                pool._sm.requests.labels(code=str(code)).inc()
                self._raw(code, payload, ctype, retry_after, headers)

        class _Httpd(ThreadingHTTPServer):
            allow_reuse_address = True
            daemon_threads = True
            request_queue_size = 128  # same burst contract as JsonModelServer

        self._httpd = _Httpd(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         name="tdl-pool-router", daemon=True).start()

    def _forward_timeout(self, fwd_headers: Dict[str, str]) -> float:
        """How long the router waits on a replica for THIS request: at
        least ``request_timeout`` (itself > the replica's 30s default
        deadline, so the replica's own 504 arrives as a response), stretched
        to cover an explicit ``X-Deadline-Ms`` plus margin — a slow-but-
        within-deadline generation must never be misclassified as a
        connection failure, breaker-counted, and re-dispatched."""
        dl = fwd_headers.get("X-Deadline-Ms")
        if dl is not None:
            try:
                return max(self.request_timeout, float(dl) / 1000.0 + 5.0)
            except ValueError:
                pass  # the replica answers 400 for the malformed header
        return self.request_timeout

    def _route(self, handler) -> Tuple[int, bytes, str, Optional[int], dict]:
        """Forward one POST to the least-loaded ready replica, failing over
        on connection errors. Returns (code, body, content_type,
        retry_after, extra headers)."""
        import http.client
        import urllib.error
        import urllib.request

        from .executor import span_sampled
        from .json_server import JsonModelServer, _request_id, _trace_id

        rid = _request_id(handler.headers.get("X-Request-Id"))
        # mint-or-adopt the trace id: forwarded replica-ward so
        # the router's `route` slice and the replica's request_span join
        # into one flow on the fleet timeline
        tid = _trace_id(handler.headers.get("X-Trace-Id"), rid)
        content_length = handler.headers.get("Content-Length")
        try:
            length = int(content_length)
        except (TypeError, ValueError):
            length = -1
        # early error paths drain the unread body first (bounded), same as
        # JsonModelServer: an unread body pending at close makes the kernel
        # RST the connection and the error JSON never reaches the client
        if handler.path != self.endpoint:
            JsonModelServer._discard_body(handler, max(0, length))
            return (404, json.dumps({"error": "unknown endpoint",
                                     "request_id": rid}).encode(),
                    "application/json", None, {"X-Request-Id": rid})
        if content_length is None:
            return (413, json.dumps(
                {"error": "Content-Length header required",
                 "request_id": rid}).encode(),
                "application/json", None, {"X-Request-Id": rid})
        if length < 0:
            return (400, json.dumps(
                {"error": f"bad Content-Length {content_length!r}",
                 "request_id": rid}).encode(),
                "application/json", None, {"X-Request-Id": rid})
        if length > self.max_body_bytes:
            JsonModelServer._discard_body(handler, length)
            return (413, json.dumps(
                {"error": f"request body {length}B exceeds "
                          f"{self.max_body_bytes}B limit",
                 "request_id": rid}).encode(),
                "application/json", None, {"X-Request-Id": rid})
        try:
            body = handler.rfile.read(length)
        except OSError:
            return (408, json.dumps({"error": "timed out reading body",
                                     "request_id": rid}).encode(),
                    "application/json", None, {"X-Request-Id": rid})
        fwd_headers = {}
        for name in _FORWARD_HEADERS:
            v = handler.headers.get(name)
            if v is not None:
                fwd_headers[name] = v
        # the SANITIZED ids win over whatever the client sent
        fwd_headers["X-Request-Id"] = rid
        fwd_headers["X-Trace-Id"] = tid
        timeout = self._forward_timeout(fwd_headers)
        t_route = time.monotonic()

        def note_route(replica_id: int, code: int) -> None:
            # the router half of the cross-process handshake pair the
            # timeline aligns (its `route` slice spans the forward; the
            # replica's request_span rides inside it)
            if span_sampled(rid, 1):
                flight.record("route", request_id=rid, trace_id=tid,
                              replica=replica_id, code=int(code),
                              seconds=time.monotonic() - t_route)

        tried: set = set()
        with self._lock:
            n_live = max(1, len(self._replicas))
        for _ in range(n_live):
            h = self._pick_replica(tried)  # also counts us in-flight on h
            if h is None:
                break
            tried.add(h.id)
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{h.port}{self.endpoint}",
                    data=body, headers=fwd_headers)
                try:
                    with urllib.request.urlopen(
                            req, timeout=timeout) as resp:
                        payload = resp.read()
                        self._note_success(h)
                        note_route(h.id, resp.status)
                        return (resp.status, payload,
                                resp.headers.get("Content-Type"),
                                resp.headers.get("Retry-After"),
                                {"X-Request-Id": rid, "X-Trace-Id": tid,
                                 "X-Replica": str(h.id)})
                except urllib.error.HTTPError as e:
                    payload = e.read()
                    if e.code == 500:
                        # model failure is a replica-health signal; 429/504
                        # are the replica doing its JOB under load
                        self._note_failure(h, f"http_{e.code}")
                    elif e.code == 503:
                        # draining/warming: the request was NOT processed —
                        # mark it unready and FAIL OVER like a connection
                        # error. Returning the replica's own 503 (no "pool
                        # not ready" marker) would march the client breaker
                        # during a rolling restart even though a sibling
                        # could have served the request; if no sibling can,
                        # the fallthrough answers the pool-level 503.
                        with self._lock:
                            h.state = "unready"
                        log.debug("request %s: replica %d answered 503 — "
                                  "failing over", rid, h.id)
                        continue
                    else:
                        self._note_success(h)
                    note_route(h.id, e.code)
                    return (e.code, payload,
                            e.headers.get("Content-Type") if e.headers else None,
                            e.headers.get("Retry-After") if e.headers else None,
                            {"X-Request-Id": rid, "X-Trace-Id": tid,
                             "X-Replica": str(h.id)})
                except (urllib.error.URLError, OSError,
                        http.client.HTTPException) as e:
                    # connection-level failure: the replica may be dying —
                    # breaker-count it, mark unready, FAIL OVER transparently
                    self._note_failure(h, "connection")
                    with self._lock:
                        h.state = "unready"
                    log.debug("request %s: replica %d unreachable (%s) — "
                              "failing over", rid, h.id, type(e).__name__)
                    continue
            finally:
                with self._lock:
                    h.inflight -= 1
        ready, reason = self._readiness()
        reason = reason or ("pool not ready (no dispatchable replica)")
        return (503, json.dumps({"error": reason,
                                 "request_id": rid}).encode(),
                "application/json", RETRY_AFTER_S,
                {"X-Request-Id": rid, "X-Trace-Id": tid})


# ------------------------------------------------------------- autoscaler


class PoolAutoscaler:
    """Alert rules → scale ACTIONS.

    Every :meth:`tick` evaluates the engine once. Any firing rule among
    ``scale_up_rules`` scales the pool up one ``step`` (bounded by
    ``max_replicas``); the pool scales DOWN one replica only after
    ``scale_down_idle_evals`` consecutive all-clear evaluations. Anti-flap
    is layered: the rules themselves carry ``for_duration`` (no fire on a
    single bad scrape) and ``clear_hysteresis`` (no clear-bounce at the
    threshold), and the autoscaler adds an action ``cooldown_s`` plus the
    all-clear streak — a burst produces one paired up/down, not a sawtooth.
    """

    DEFAULT_UP_RULES = ("inference_queue_depth_hwm", "p99_latency_rising",
                        "error_budget_burn_fast", "shed_rate")

    def __init__(self, pool: ServingPool, engine, *,
                 scale_up_rules: Optional[Sequence[str]] = None,
                 step: int = 1, cooldown_s: float = 3.0,
                 scale_down_idle_evals: int = 5):
        self.pool = pool
        self.engine = engine
        self.scale_up_rules = tuple(scale_up_rules
                                    if scale_up_rules is not None
                                    else self.DEFAULT_UP_RULES)
        known = {r.name for r in getattr(engine, "rules", ())}
        unknown = set(self.scale_up_rules) - known
        if known and unknown:
            raise ValueError(f"scale_up_rules not in the engine: "
                             f"{sorted(unknown)}")
        self.step = max(1, step)
        self.cooldown_s = cooldown_s
        self.scale_down_idle_evals = max(1, scale_down_idle_evals)
        self._clear_streak = 0
        self._cooldown_until = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.actions: List[dict] = []  # audit trail for tests/postmortems

    def tick(self) -> Optional[str]:
        """One evaluate-and-act pass; returns \"up\"/\"down\"/None."""
        results = self.engine.evaluate()
        firing = sorted(r["rule"] for r in results
                        if r["firing"] and r["rule"] in self.scale_up_rules)
        now = time.monotonic()
        if firing:
            self._clear_streak = 0
            if now >= self._cooldown_until:
                before = self.pool.desired
                after = self.pool.scale_to(before + self.step,
                                           reason=",".join(firing))
                if after != before:
                    self._cooldown_until = now + self.cooldown_s
                    self.actions.append({"t": now, "action": "up",
                                         "from": before, "to": after,
                                         "rules": firing})
                    return "up"
            return None
        self._clear_streak += 1
        if (self._clear_streak >= self.scale_down_idle_evals
                and now >= self._cooldown_until):
            before = self.pool.desired
            after = self.pool.scale_to(before - 1, reason="all-clear")
            if after != before:
                self._cooldown_until = now + self.cooldown_s
                self._clear_streak = 0
                self.actions.append({"t": now, "action": "down",
                                     "from": before, "to": after,
                                     "rules": []})
                return "down"
        return None

    def start(self, interval: float = 1.0) -> "PoolAutoscaler":
        if self._thread is not None:
            return self
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.wait(interval):
                try:
                    self.tick()
                except Exception:
                    log.exception("autoscaler tick failed")

        self._thread = threading.Thread(target=loop, name="tdl-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)


if __name__ == "__main__":  # replica entry: python -m ...serving.pool mod:fn
    _replica_main(sys.argv[1:])
