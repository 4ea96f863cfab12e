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
    crash@iter=7,rank=1, hang@..., slow_ckpt_io=2.0, torn_ckpt@...,
    corrupt_ckpt@..., enospc@..., loss_spike@..., corrupt_clone@...
                                 the training and checkpoint faults

Every clause parses as in the JAX package, so one spec can be handed to a
fleet that runs both packages. The port fires only the serving site,
``infer``, inside ``serving.executor``'s model calls (a failing model call
is an HTTP 500, a slow one drives the deadline and shedding paths). The
training and checkpoint sites belong to modules the port does not have yet.

A clause without ``rank=`` fires on every rank; the rank comes from
``TDL_PROCESS_ID`` and the incarnation from ``TDL_GANG_RESTART_COUNT``.
A serving clause fires in every incarnation unless ``restart=N`` pins it.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

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
    """Evaluates fault clauses at the ``infer`` site: ``slow_infer``,
    ``fail_infer`` and ``latency_inject`` (see the module docstring)."""

    def __init__(self, faults: List[Fault], rank: Optional[int] = None,
                 incarnation: Optional[int] = None):
        self.faults = faults
        self.rank = rank if rank is not None else int(os.environ.get(ENV_RANK, "0"))
        self.incarnation = (incarnation if incarnation is not None
                            else int(os.environ.get(ENV_INCARNATION, "0")))
        self._infer_calls = 0  # deterministic fail_infer@n= cadence

    @classmethod
    def from_env(cls) -> "FaultInjector":
        return cls(parse_fault_spec(os.environ.get(ENV_SPEC, "")))

    def fire(self, site: str) -> None:
        if site != "infer":
            return
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


_cached: Optional[FaultInjector] = None
_cached_key: Optional[tuple] = None


def fault_point(site: str) -> None:
    """Library hook: no-op unless ``TDL_FAULT_SPEC`` is set (one dict lookup
    on the hot path). The injector is rebuilt whenever the env contract
    (spec, rank, incarnation) changes, so in-process tests can flip any of
    the three between cases."""
    global _cached, _cached_key
    spec = os.environ.get(ENV_SPEC)
    if not spec:
        return
    key = (spec, os.environ.get(ENV_RANK, "0"),
           os.environ.get(ENV_INCARNATION, "0"))
    if _cached is None or key != _cached_key:
        _cached = FaultInjector.from_env()
        _cached_key = key
    _cached.fire(site)
