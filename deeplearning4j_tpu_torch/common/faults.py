"""Deterministic fault injection (copy of the JAX package's ``common.faults``).

One environment variable, ``TDL_FAULT_SPEC``, turns into deterministic
faults fired from hooks inside the real code paths, so a chaos test drives
the machinery a production failure would. The grammar is the JAX package's,
``;``-separated clauses::

    slow_infer@p=0.05            sleep 0.05 s inside every inference batch
    fail_infer@n=5               raise InjectedFault on every 5th inference
    latency_inject@value=0.4,model=gen-00000008
                                 sleep ``value`` seconds inside every
                                 inference batch, but only in processes whose
                                 ``TDL_MODEL_CKPT`` contains ``model``
    slow_ckpt_io=2.0             sleep 2.0 s inside every checkpoint write
    enospc@iter=4                raise OSError(ENOSPC) at the checkpoint write
    torn_ckpt@iter=4,stage=shard hard ``os._exit`` inside the checkpoint save at
                                 one two-phase-commit boundary: stage= shard
                                 (shard tmp bytes written, pre-rename) |
                                 manifest (post-shard, pre-manifest) | commit
                                 (pre-COMMIT marker, the default) | pointer
                                 (pre-pointer swap)
    corrupt_ckpt@iter=4          bit-flip one shard of the just-COMMITTED
                                 generation: latent disk corruption that the
                                 restore-side CRC check must catch
    crash@iter=7,rank=1, hang@..., loss_spike@..., corrupt_clone@...
                                 the training and trial-fleet faults

Every clause parses as in the JAX package, so one spec can be handed to a
fleet that runs both packages. The port fires four groups of sites:

- ``infer``, inside ``serving.executor``'s model calls (a failing model
  call is an HTTP 500, a slow one drives the deadline and shedding paths);
- the checkpoint sites of ``serde.checkpoint.TrainingCheckpointer.save``:
  ``ckpt_write`` (``slow_ckpt_io``, ``enospc``), the commit boundaries
  ``ckpt_shard``, ``ckpt_manifest``, ``ckpt_commit`` and ``ckpt_pointer``
  (``torn_ckpt``), and ``ckpt_committed`` (``corrupt_ckpt``, given the
  generation's path).

- ``train_step`` (``iteration=``), fired by ``parallel.trainer``'s
  ``ParallelTrainer`` before every step: ``crash`` (a hard ``os._exit``
  with :data:`CRASH_EXIT_CODE`) and ``hang`` (the rank sleeps forever);
  and ``loss_spike`` through :func:`poison_scale`, which returns the factor
  the trainer multiplies every parameter by.

- ``trial_clone`` (``iteration=`` the rung index, ``path=`` the clone
  source's generation), fired by ``arbiter.fleet.TrialFleet`` just before
  it deep-verifies a PBT clone source: ``corrupt_clone`` bit-flips one
  shard of that SOURCE (latent damage found only when the winner's
  checkpoint is read back). It fires once per injector unless ``every=1``:
  the fleet's fallback clone from an older generation must read healthy
  bytes, or the fault would prove nothing about recovery.

A clause without ``rank=`` fires on every rank; the rank comes from
``TDL_PROCESS_ID`` and the incarnation from ``TDL_GANG_RESTART_COUNT``.
``crash``, ``hang`` and ``loss_spike`` fire only in the first incarnation
unless ``every=1`` or ``restart=N`` says otherwise, so a restarted gang
replays the faulted iteration cleanly; ``torn_ckpt``, ``corrupt_ckpt`` and
``enospc`` model one-shot disk events
and fire only in the first incarnation unless ``every=1`` or
``restart=N`` says otherwise; a serving clause and ``slow_ckpt_io`` fire in
every incarnation unless ``restart=N`` pins them.
"""

from __future__ import annotations

import errno
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

ENV_SPEC = "TDL_FAULT_SPEC"
ENV_INCARNATION = "TDL_GANG_RESTART_COUNT"
ENV_RANK = "TDL_PROCESS_ID"

#: exit code of an injected crash — distinguishable from real worker errors
CRASH_EXIT_CODE = 43

#: checkpoint two-phase-commit boundaries a ``torn_ckpt`` clause can name
CKPT_STAGES = ("shard", "manifest", "commit", "pointer")

FAULT_KINDS = ("crash", "hang", "slow_ckpt_io", "slow_infer", "fail_infer",
               "torn_ckpt", "corrupt_ckpt", "enospc", "loss_spike",
               "latency_inject", "corrupt_clone")


class InjectedFault(RuntimeError):
    """Raised by ``fail_infer`` — a deterministic stand-in for a model-side
    failure; serving must map it to HTTP 500 like any other model error."""


@dataclass
class Fault:
    kind: str  # one of FAULT_KINDS
    params: Dict[str, str] = field(default_factory=dict)

    @property
    def iteration(self) -> Optional[int]:
        v = self.params.get("iter")
        return int(v) if v is not None else None

    @property
    def rank(self) -> Optional[int]:
        v = self.params.get("rank")
        return int(v) if v is not None else None

    @property
    def value(self) -> float:
        return float(self.params.get("value", "0"))

    def fires_in_incarnation(self, incarnation: int) -> bool:
        if self.params.get("every") in ("1", "true"):
            return True
        return incarnation == int(self.params.get("restart", "0"))


def parse_fault_spec(spec: str) -> List[Fault]:
    """``crash@iter=7,rank=1;slow_ckpt_io=2.0`` → [Fault, Fault]."""
    faults = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if "@" in clause:
            kind, _, rest = clause.partition("@")
            params = {}
            for kv in rest.split(","):
                k, _, v = kv.partition("=")
                if not _:
                    raise ValueError(f"bad fault param {kv!r} in {clause!r}")
                params[k.strip()] = v.strip()
        elif "=" in clause:
            kind, _, v = clause.partition("=")
            params = {"value": v.strip()}
        else:
            kind, params = clause, {}
        kind = kind.strip()
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {spec!r}")
        if kind == "torn_ckpt" and \
                params.get("stage", "commit") not in CKPT_STAGES:
            raise ValueError(
                f"unknown torn_ckpt stage {params.get('stage')!r} in "
                f"{clause!r}; choose from {CKPT_STAGES}")
        faults.append(Fault(kind, params))
    return faults


class FaultInjector:
    """Evaluates fault clauses at the port's sites (see the module
    docstring): ``infer``, the checkpoint sites ``ckpt_*``, ``train_step``
    and ``trial_clone``."""

    def __init__(self, faults: List[Fault], rank: Optional[int] = None,
                 incarnation: Optional[int] = None):
        self.faults = faults
        self.rank = rank if rank is not None else int(os.environ.get(ENV_RANK, "0"))
        self.incarnation = (incarnation if incarnation is not None
                            else int(os.environ.get(ENV_INCARNATION, "0")))
        self._infer_calls = 0  # deterministic fail_infer@n= cadence
        #: clause indices that already fired at the one-shot ``trial_clone``
        #: site
        self._fired_once: set = set()

    @classmethod
    def from_env(cls) -> "FaultInjector":
        return cls(parse_fault_spec(os.environ.get(ENV_SPEC, "")))

    def _matches(self, f: Fault, iteration: Optional[int]) -> bool:
        if f.rank is not None and f.rank != self.rank:
            return False
        if f.iteration is not None and f.iteration != iteration:
            return False
        return f.fires_in_incarnation(self.incarnation)

    def _flight_note(self, f: Fault, iteration: Optional[int]) -> None:
        """Record the injected fault and flush the flight ring: a torn save
        is ``os._exit``, so this is the victim's last chance to get its
        final events onto disk for the postmortem."""
        from ..monitoring import flight

        flight.record("fault_injected", fault=f.kind, iteration=iteration,
                      rank=self.rank, incarnation=self.incarnation)
        flight.flush()

    def fire(self, site: str, iteration: Optional[int] = None,
             path: Optional[str] = None) -> None:
        if site == "infer":
            self._fire_infer()
        elif site.startswith("ckpt_"):
            self._fire_ckpt(site, iteration, path)
        elif site == "train_step":
            self._fire_train(iteration)
        elif site == "trial_clone":
            self._fire_clone(iteration, path)

    def _fire_clone(self, iteration: Optional[int], path: Optional[str]) -> None:
        for i, f in enumerate(self.faults):
            if f.kind != "corrupt_clone" or not path or not self._matches(f, iteration):
                continue
            if f.params.get("every") not in ("1", "true"):
                if i in self._fired_once:
                    continue
                self._fired_once.add(i)
            self._flight_note(f, iteration)
            flipped = _flip_bit_in_shard(path)
            log.warning("fault injection: corrupt_clone bit-flipped clone source %s "
                        "(rung %s, incarnation %s)", flipped, iteration, self.incarnation)

    def _fire_train(self, iteration: Optional[int]) -> None:
        for f in self.faults:
            if f.kind not in ("crash", "hang") or not self._matches(f, iteration):
                continue
            self._flight_note(f, iteration)
            if f.kind == "crash":
                log.warning("fault injection: crash at iteration %s rank %s (incarnation %s)",
                            iteration, self.rank, self.incarnation)
                os._exit(CRASH_EXIT_CODE)  # no cleanup: a segfault or a preemption
            log.warning("fault injection: hang at iteration %s rank %s (incarnation %s)",
                        iteration, self.rank, self.incarnation)
            while True:  # alive but making no progress
                time.sleep(1.0)

    def poison(self, site: str, iteration: Optional[int] = None) -> Optional[float]:
        """The ``loss_spike`` factor for this train step, or None. It never
        raises or exits: the poisoned run keeps training and committing
        valid checkpoints whose weights are ruined."""
        if site != "train_step":
            return None
        for f in self.faults:
            if f.kind != "loss_spike" or not self._matches(f, iteration):
                continue
            self._flight_note(f, iteration)
            scale = float(f.params.get("scale", "40"))
            log.warning("fault injection: loss_spike x%g at iteration %s rank %s "
                        "(incarnation %s)", scale, iteration, self.rank, self.incarnation)
            return scale
        return None

    def _fire_infer(self) -> None:
        self._infer_calls += 1
        for f in self.faults:
            if f.kind not in ("slow_infer", "fail_infer", "latency_inject"):
                continue
            if f.kind == "latency_inject":
                # a regression that ships with one model version: only the
                # replica serving it slows down
                want = f.params.get("model")
                if want and want not in os.environ.get("TDL_MODEL_CKPT", ""):
                    continue
            if f.rank is not None and f.rank != self.rank:
                continue
            if ("restart" in f.params
                    and not f.fires_in_incarnation(self.incarnation)):
                continue
            if f.kind == "latency_inject":
                time.sleep(f.value)
            elif f.kind == "slow_infer":
                time.sleep(float(f.params.get("p", f.params.get("value", "0"))))
            else:
                n = int(f.params.get("n", "1"))
                if n <= 1 or self._infer_calls % n == 0:
                    raise InjectedFault(
                        f"fault injection: fail_infer "
                        f"(inference call {self._infer_calls})")

    def _fire_ckpt(self, site: str, iteration: Optional[int],
                   path: Optional[str]) -> None:
        for f in self.faults:
            if f.kind == "torn_ckpt":
                # exit at ONE named two-phase-commit boundary: a restorable
                # checkpoint must survive a death at any of them
                if site != f"ckpt_{f.params.get('stage', 'commit')}" or \
                        not self._matches(f, iteration):
                    continue
                self._flight_note(f, iteration)
                log.warning("fault injection: torn_ckpt at %s, iteration %s rank %s "
                            "(incarnation %s)", site, iteration, self.rank,
                            self.incarnation)
                os._exit(CRASH_EXIT_CODE)
            elif f.kind == "enospc" and site == "ckpt_write":
                if not self._matches(f, iteration):
                    continue
                self._flight_note(f, iteration)
                raise OSError(errno.ENOSPC, "No space left on device (injected enospc)")
            elif f.kind == "corrupt_ckpt" and site == "ckpt_committed":
                if not path or not self._matches(f, iteration):
                    continue
                self._flight_note(f, iteration)
                flipped = _flip_bit_in_shard(path)
                log.warning("fault injection: corrupt_ckpt bit-flipped %s (iteration %s, "
                            "incarnation %s)", flipped, iteration, self.incarnation)
            elif f.kind == "slow_ckpt_io" and site == "ckpt_write":
                # the straggler fault: rank-filtered, and unlike the one-shot
                # disk events it fires in EVERY incarnation unless restart=N
                if f.rank is not None and f.rank != self.rank:
                    continue
                if "restart" not in f.params or f.fires_in_incarnation(self.incarnation):
                    time.sleep(f.value)


def _flip_bit_in_shard(gendir: str) -> Optional[str]:
    """Flip one byte in the middle of the first shard file of a committed
    generation — latent disk corruption, injected AFTER the commit so the
    checkpoint looked perfectly healthy when written."""
    try:
        shards = sorted(f for f in os.listdir(gendir)
                        if f.startswith("shard_") and f.endswith(".npz"))
        if not shards:
            return None
        target = os.path.join(gendir, shards[0])
        size = os.path.getsize(target)
        with open(target, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
        return target
    except OSError:
        log.exception("corrupt_ckpt injection could not flip a bit in %s", gendir)
        return None


_cached: Optional[FaultInjector] = None
_cached_key: Optional[tuple] = None


def fault_point(site: str, iteration: Optional[int] = None,
                path: Optional[str] = None) -> None:
    """Library hook: no-op unless ``TDL_FAULT_SPEC`` is set (one dict lookup
    on the hot path). The injector is rebuilt whenever the env contract
    (spec, rank, incarnation) changes, so in-process tests can flip any of
    the three between cases."""
    injector = _injector()
    if injector is not None:
        injector.fire(site, iteration, path=path)


def poison_scale(site: str = "train_step",
                 iteration: Optional[int] = None) -> Optional[float]:
    """Library hook for ``loss_spike`` (the env contract and caching of
    :func:`fault_point`): the factor to multiply the parameters by at this
    step, or None."""
    injector = _injector()
    return None if injector is None else injector.poison(site, iteration)


def _injector() -> Optional[FaultInjector]:
    global _cached, _cached_key
    spec = os.environ.get(ENV_SPEC)
    if not spec:
        return None
    key = (spec, os.environ.get(ENV_RANK, "0"),
           os.environ.get(ENV_INCARNATION, "0"))
    if _cached is None or key != _cached_key:
        _cached = FaultInjector.from_env()
        _cached_key = key
    return _cached
