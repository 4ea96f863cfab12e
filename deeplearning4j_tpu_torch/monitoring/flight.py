"""Flight recorder — a bounded in-process ring of structured events (copy
of the JAX package's ``monitoring.flight``; a spool written by either
package reads the same to the other's readers).

When an unattended gang dies, the metrics registry says *that* something went
wrong (`tdl_worker_deaths_total`) but not *what the ranks were doing*. The
flight recorder is the black box: every process appends cheap structured
events (step begin/end with loss, heartbeat writes, checkpoint save/restore,
fault injections, queue-depth high-watermarks, supervisor restart decisions)
into a fixed-size ring, and — when ``TDL_FLIGHT_DIR`` is set, which the
``GangSupervisor`` does for every gang it spawns — spools the ring to a
per-process JSON file with the same atomic tmp+rename convention as
``monitoring.heartbeat``. On crash/hang classification the supervisor merges
every rank's spool (plus its own in-memory ring) into one
``postmortem.json`` ordered by the shared monotonic clock.

Ordering contract: events carry ``t`` = ``time.monotonic()``. On Linux that
is CLOCK_MONOTONIC, which is **system-wide per boot**, so events from every
process of a same-host gang merge into one true timeline without clock
agreement; ``wall`` rides along for human display only. ``seq`` breaks ties
within one process.

Cost contract: ``record()`` is one dict build + deque append under a lock —
safe on a hot step path. Disk writes are throttled by
``TDL_FLIGHT_INTERVAL`` seconds (same knob shape as the heartbeat writer);
the fault injector flushes unconditionally before killing/wedging a process
so the victim's final events survive ``os._exit``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import List, Optional

log = logging.getLogger(__name__)

ENV_DIR = "TDL_FLIGHT_DIR"
ENV_INTERVAL = "TDL_FLIGHT_INTERVAL"
ENV_RANK = "TDL_PROCESS_ID"
ENV_PROC = "TDL_PROC_NAME"
#: identity namespace for gangs that are one of MANY in a shared spool dir
#: (trial fleets): prepended to the derived ``rank{N}``/``pid{N}``
#: name, so eight single-rank trial gangs spooling into one fleet dir stay
#: eight distinct procs instead of eight colliding ``rank0`` spools
ENV_PROC_PREFIX = "TDL_PROC_PREFIX"
ENV_RUN_ID = "TDL_RUN_ID"
ENV_LOSS_EVERY = "TDL_FLIGHT_LOSS_EVERY"

#: spool filename prefix — the leak-audit conftest fixture and the
#: supervisor's postmortem collector both key on it
SPOOL_PREFIX = "tdl_flight_"

DEFAULT_CAPACITY = 512

#: anchors kept per spool: the open anchor plus the most recent flushes —
#: enough pairs for a robust (median) monotonic↔wall offset without letting
#: a long-lived recorder's payload grow one anchor per flush forever
MAX_ANCHORS = 16

#: THE flight-event vocabulary, the JAX package's set: every
#: ``flight.record(kind=...)`` literal in either package is declared here
#: and documented in docs/OBSERVABILITY.md's event table — an event kind
#: that exists only at its record site is invisible to the timeline and
#: postmortem readers that switch on it.
EVENT_KINDS = frozenset({
    # training step / fit loop
    "step_begin", "step_end", "heartbeat", "compile",
    # checkpoint lineage
    "ckpt_save", "ckpt_commit", "ckpt_restore", "ckpt_quarantine",
    "ckpt_fallback", "ckpt_reshard",
    # chaos / fault injection
    "fault_injected",
    # alerts
    "alert", "alert_clear",
    # serving request path
    "request_span", "route", "queue_hwm",
    # gang supervisor
    "gang_failure", "restart_decision", "gang_resize",
    # pipeline parallelism: a measured-skew stage re-partition,
    # naming the old and new stage boundaries
    "pipe_rebalance",
    # serving pool
    "pool_scale", "pool_swap_rejected", "pool_swap_begin", "pool_swap",
    "pool_swap_rollback", "replica_spawn", "replica_retire",
    "replica_drain_complete", "replica_death", "replica_breaker_open",
    # deployment controller
    "deploy_candidate", "deploy_gate", "deploy_promote", "deploy_rollback",
    # trial fleet meta-supervisor: spawn/score are the per-rung
    # audit spine; quarantine/demote/clone/promote are the trial-terminal
    # decisions the fleet lint (tests/test_fleet.py) pins to these kinds
    "trial_spawn", "trial_score", "trial_rung_promote", "trial_quarantine",
    "trial_demote", "trial_clone", "trial_promote",
})


def clock_anchor() -> dict:
    """One monotonic↔wall sample. A spool carrying a few of these lets a
    reader on any machine map the spool's monotonic timestamps onto the wall
    clock (``monitoring.timeline`` medians them), which is what aligns
    per-process lanes after a restart or across hosts whose boots differ."""
    return {"mono": time.monotonic(),
            "wall": time.time()}  # wallclock-ok: one half of the clock-skew anchor pair, never a duration


def run_id() -> Optional[str]:
    """The fleet run id (``TDL_RUN_ID``) — minted by the ``GangSupervisor``
    / ``ServingPool`` and inherited by every child, so spans and flight
    events from all ranks/replicas of one run correlate in a shared dir."""
    return os.environ.get(ENV_RUN_ID) or None


def proc_name(rank: Optional[int] = None) -> str:
    """Stable identity of this process in merged telemetry: an explicit
    ``TDL_PROC_NAME`` (how a rankless serving replica / ETL host gets a
    RESTART-STABLE identity, so the spool merge's newest-per-proc dedup
    works for it), else ``rank{N}`` for gang members (``TDL_PROCESS_ID``),
    else ``pid{N}`` — pid identities change on restart, so their dead
    incarnations' spools linger until the spool dir is rotated; give
    long-lived rankless processes a ``TDL_PROC_NAME``."""
    explicit = os.environ.get(ENV_PROC)
    if explicit:
        return explicit
    # ``TDL_PROC_PREFIX`` namespaces the DERIVED name (rank/pid), never an
    # explicit one: a trial fleet prefixes each gang with its trial id so
    # many gangs' rank0 spools coexist in one shared dir, while a process
    # that chose its own TDL_PROC_NAME already owns a unique identity
    prefix = os.environ.get(ENV_PROC_PREFIX, "")
    if rank is not None:
        return f"{prefix}rank{rank}"
    r = os.environ.get(ENV_RANK)
    base = f"rank{int(r)}" if r is not None else f"pid{os.getpid()}"
    return f"{prefix}{base}"


def proc_rank() -> Optional[int]:
    r = os.environ.get(ENV_RANK)
    return int(r) if r is not None else None


def atomic_json_write(path: str, payload: dict) -> None:
    """tmp-then-rename JSON write (a tmp per process and thread, so
    concurrent writers in one directory — or two threads of one process
    flushing one recorder — never tear each other). Shared by the flight
    recorder and the metrics spooler so the durability contract lives in
    one place."""
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def scan_spool_json(directory: str, prefix: str,
                    on_error=None) -> List[dict]:
    """Parse every ``{prefix}*.json`` spool in ``directory``, name-sorted;
    unreadable/torn files are skipped (a reader racing a crash must not
    raise — the writer re-replaces shortly, or the postmortem proceeds with
    what survived). ``on_error(filename)`` is called per skipped file so
    callers can count degradation instead of silently losing procs."""
    out = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if not (name.startswith(prefix) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            if on_error is not None:
                on_error(name)
            continue
    return out


class FlightRecorder:
    """Bounded ring of structured events with optional throttled spooling."""

    def __init__(self, proc: Optional[str] = None,
                 directory: Optional[str] = None,
                 capacity: int = DEFAULT_CAPACITY, interval: float = 1.0,
                 run: Optional[str] = None):
        self.proc = proc or proc_name()
        self.directory = directory
        self.capacity = max(1, int(capacity))
        self.interval = max(0.0, float(interval))
        self.run_id = run if run is not None else run_id()
        self.rank = proc_rank()
        self._events: deque = deque(maxlen=self.capacity)
        self._anchors: deque = deque([clock_anchor()], maxlen=MAX_ANCHORS)
        self._lock = threading.Lock()
        self._seq = 0
        self._last_spool: Optional[float] = None
        self._write_failed = False
        if directory:
            os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> Optional[str]:
        if self.directory is None:
            return None
        return os.path.join(self.directory, f"{SPOOL_PREFIX}{self.proc}.json")

    def record(self, kind: str, **fields) -> dict:
        ev = {"t": time.monotonic(),
              "wall": time.time(),  # wallclock-ok: event timestamp for humans, never compared as a duration
              "proc": self.proc, "pid": os.getpid(), "kind": str(kind)}
        if self.run_id is not None:
            ev["run_id"] = self.run_id
        if self.rank is not None:
            ev["rank"] = self.rank
        ev.update(fields)
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            self._events.append(ev)
        if self.directory is not None:
            now = time.monotonic()
            if self._last_spool is None or now - self._last_spool >= self.interval:
                self.flush()
        return ev

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def flush(self) -> Optional[str]:
        """Spool the ring to disk now (atomic rename). No-op without a
        directory; returns the spool path on a successful write. Failures
        (disk full, unserializable event field) are logged and swallowed —
        the black box runs on train/inference hot paths and must never take
        the workload down with it."""
        path = self.path
        if path is None:
            return None
        with self._lock:
            self._anchors.append(clock_anchor())
            anchors = list(self._anchors)
        payload = {"proc": self.proc, "pid": os.getpid(),
                   "capacity": self.capacity, "anchors": anchors,
                   "events": self.events()}
        if self.run_id is not None:
            payload["run_id"] = self.run_id
        if self.rank is not None:
            payload["rank"] = self.rank
        try:
            atomic_json_write(path, payload)
        except Exception:
            if not self._write_failed:  # once, not per event
                log.exception("flight-recorder spool to %s failed; "
                              "postmortems degraded (workload continues)",
                              path)
                self._write_failed = True
            # stamp anyway: a broken disk must not turn the throttle into
            # an attempt per record
            self._last_spool = time.monotonic()
            return None
        self._write_failed = False
        self._last_spool = time.monotonic()
        return path


# -- process-wide recorder (env contract, mirrors heartbeat.maybe_beat) ------

_recorder: Optional[FlightRecorder] = None
_recorder_key: Optional[tuple] = None
_override: Optional[FlightRecorder] = None


def set_flight_recorder(rec: Optional[FlightRecorder]) -> None:
    """Install an explicit recorder (tests, the supervisor's own ring);
    overrides the env contract until cleared with ``None``."""
    global _override
    _override = rec


def active() -> bool:
    """Whether :func:`record` will record anything — an explicit recorder is
    installed or ``TDL_FLIGHT_DIR`` is set. Library hooks gate on this so an
    unsupervised process pays one env lookup, nothing more."""
    return _override is not None or bool(os.environ.get(ENV_DIR))


def get_flight_recorder() -> Optional[FlightRecorder]:
    """The process recorder: the installed override, else an env-built one
    (rebuilt whenever the (dir, rank, interval) contract changes, so
    in-process supervisors/tests that re-point the dir never spool into a
    stale file)."""
    global _recorder, _recorder_key
    if _override is not None:
        return _override
    directory = os.environ.get(ENV_DIR)
    if not directory:
        return None
    key = (directory, os.environ.get(ENV_RANK), os.environ.get(ENV_RUN_ID),
           float(os.environ.get(ENV_INTERVAL, "1.0")))
    if _recorder is None or key != _recorder_key:
        try:
            _recorder = FlightRecorder(directory=directory, interval=key[3])
        except OSError:
            # unwritable flight dir: record in memory only (flush no-ops) —
            # never kill the step that wanted to leave a breadcrumb
            log.exception("cannot create flight dir %s; recording to the "
                          "in-memory ring only", directory)
            _recorder = FlightRecorder(directory=None)
        _recorder_key = key
    return _recorder


def record(kind: str, **fields) -> Optional[dict]:
    """Library hook: append an event iff flight recording is active."""
    rec = get_flight_recorder() if active() else None
    return rec.record(kind, **fields) if rec is not None else None


def flush() -> None:
    rec = get_flight_recorder() if active() else None
    if rec is not None:
        rec.flush()


# -- read side ---------------------------------------------------------------


def read_spools(directory: str, on_error=None) -> List[dict]:
    """Every flight spool in ``directory`` (unreadable/torn files skipped —
    a reader racing a crash must not raise). Pass
    ``aggregate.spool_error_counter("flight")`` (or any callable taking the
    skipped filename) as ``on_error`` to count the degradation."""
    return scan_spool_json(directory, SPOOL_PREFIX, on_error=on_error)


def merge_events(spools: List[dict], extra_events: List[dict] = ()) -> List[dict]:
    """One monotonic-clock-ordered timeline from per-process spools plus any
    in-memory events (the supervisor's own ring)."""
    events: List[dict] = []
    for spool in spools:
        events.extend(spool.get("events") or [])
    events.extend(extra_events)
    return sorted(events, key=lambda e: (e.get("t", 0.0),
                                         str(e.get("proc", "")),
                                         e.get("seq", 0)))


def loss_every() -> int:
    """Cadence of loss capture on a trainer's ``step_end`` events. Reading
    the loss waits for the device, so the default is every 10th step;
    ``TDL_FLIGHT_LOSS_EVERY=1`` records every step's loss."""
    try:
        return max(1, int(os.environ.get(ENV_LOSS_EVERY, "10")))
    except ValueError:
        return 10
