"""Gradient updaters and learning-rate schedules.

Counterpart of ``deeplearning4j_tpu/nn/updaters.py``. The config beans keep
the JAX package's (and nd4j's) names, fields, defaults and JSON form. An
updater is ``init(params) -> state`` and ``apply(grads, state, params,
iteration, epoch) -> (updates, state)``; the caller subtracts the updates.
Parameters, gradients and updates are dicts of tensors keyed by parameter
name (an ``nn.Module`` is taken for its ``named_parameters()``); a state is
a dict of such dicts (Adam: ``{"m": {...}, "v": {...}}``), and
``models.weights`` bridges it to and from the JAX package's state pytree.

One difference from the JAX package: ``apply`` updates the state's tensors
in place under ``torch.no_grad()`` (JAX returns new arrays), which saves
two parameter-sized allocations per step; the state it returns is the dict
it was given.

Ported: ``FixedSchedule``, ``WarmupLinearDecay``, ``NoOp``, ``Sgd``,
``Adam``. The other updaters and schedules are still to port (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

Tensors = Dict[str, torch.Tensor]

# ------------------------------------------------------------------ schedules


@dataclass
class Schedule:
    """ISchedule: value(iteration, epoch) -> lr."""

    def value(self, iteration, epoch) -> float:
        raise NotImplementedError

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d


@dataclass
class FixedSchedule(Schedule):
    value_: float

    def value(self, iteration, epoch) -> float:
        return self.value_


@dataclass
class WarmupLinearDecay(Schedule):
    """Transformer-style linear warmup to ``peak``, then linear decay to 0
    at ``total_steps``."""

    peak: float
    warmup_steps: int
    total_steps: int

    def value(self, iteration, epoch) -> float:
        it = float(iteration)
        if it < self.warmup_steps:
            return self.peak * it / max(self.warmup_steps, 1)
        return (self.peak * max(0.0, self.total_steps - it)
                / max(self.total_steps - self.warmup_steps, 1))


def _lr(updater, iteration, epoch) -> float:
    if updater.lr_schedule is not None:
        return updater.lr_schedule.value(iteration, epoch)
    return updater.learning_rate


def _named(params) -> Tensors:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _zeros(params) -> Tensors:
    return {n: torch.zeros_like(p) for n, p in _named(params).items()}


# ------------------------------------------------------------------- updaters


@dataclass
class IUpdater:
    """Base config bean; subclasses mirror nd4j field names and defaults.
    ``lr_schedule`` is keyword-only so positional construction matches nd4j
    (e.g. ``Adam(lr)``)."""

    learning_rate: float = 1e-3
    lr_schedule: Optional[Schedule] = dataclasses.field(default=None, kw_only=True)

    def init(self, params) -> Dict[str, Tensors]:
        """State for ``params`` (an nn.Module or a {name: tensor} dict)."""
        return {}

    def apply(self, grads: Tensors, state, params, iteration, epoch=0):
        """Return (updates to subtract, state)."""
        raise NotImplementedError

    def to_json(self) -> dict:
        d = {k: v for k, v in dataclasses.asdict(self).items() if not isinstance(v, dict)}
        if self.lr_schedule is not None:
            d["lr_schedule"] = self.lr_schedule.to_json()
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def from_json(d: dict) -> "IUpdater":
        d = dict(d)
        cls = _lookup(_UPDATERS, d.pop("@class"), "updater")
        sched = d.pop("lr_schedule", None)
        if sched:
            sd = dict(sched)
            d["lr_schedule"] = _lookup(_SCHEDULES, sd.pop("@class"), "schedule")(**sd)
        return cls(**d)


@dataclass
class NoOp(IUpdater):
    def apply(self, grads, state, params, iteration, epoch=0):
        return {n: torch.zeros_like(g) for n, g in grads.items()}, state


@dataclass
class Sgd(IUpdater):
    learning_rate: float = 1e-1

    @torch.no_grad()
    def apply(self, grads, state, params, iteration, epoch=0):
        names = list(grads)
        updates = torch._foreach_mul([grads[n] for n in names], _lr(self, iteration, epoch))
        return dict(zip(names, updates)), state


@dataclass
class Adam(IUpdater):
    """org.nd4j.linalg.learning.AdamUpdater semantics: bias-corrected first
    and second moments, ``alpha = lr * sqrt(1 - b2^t) / (1 - b1^t)`` with
    ``t = iteration + 1`` (computed in float32, as the JAX package does)."""

    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    @torch.no_grad()
    def apply(self, grads, state, params, iteration, epoch=0):
        names = list(grads)
        g = [grads[n] for n in names]
        m = [state["m"][n] for n in names]
        v = [state["v"][n] for n in names]
        b1, b2 = self.beta1, self.beta2
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        f32 = np.float32
        t = f32(iteration) + f32(1)
        alpha = (f32(_lr(self, iteration, epoch)) * np.sqrt(f32(1) - f32(b2) ** t)
                 / (f32(1) - f32(b1) ** t))
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.epsilon)
        updates = torch._foreach_div(m, denom)
        torch._foreach_mul_(updates, float(alpha))
        return dict(zip(names, updates)), state


_UPDATERS = {c.__name__: c for c in (NoOp, Sgd, Adam)}
_SCHEDULES = {c.__name__: c for c in (FixedSchedule, WarmupLinearDecay)}


def _lookup(table, name, what):
    if name not in table:
        raise ValueError(f"{what} {name!r} is not ported yet (ported: {sorted(table)}; "
                         "ROADMAP.md lists the rest)")
    return table[name]


def get(name_or_updater, **kwargs) -> IUpdater:
    """An updater by name (``"adam"``, ``"sgd"``, ``"no_op"``), or the one given."""
    if isinstance(name_or_updater, IUpdater):
        return name_or_updater
    name = str(name_or_updater).title().replace("_", "")
    return _lookup(_UPDATERS, name, "updater")(**kwargs)
