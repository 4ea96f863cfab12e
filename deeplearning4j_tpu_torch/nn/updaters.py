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

Ported: every schedule (``FixedSchedule``, ``ExponentialSchedule``,
``InverseSchedule``, ``StepSchedule``, ``PolySchedule``, ``SigmoidSchedule``,
``WarmupLinearDecay``) and every updater (``NoOp``, ``Sgd``, ``Nesterovs``,
``AdaGrad``, ``RmsProp``, ``AdaDelta``, ``Adam``, ``AdaMax``, ``Nadam``,
``AMSGrad``), with the JAX package's state slot names. Scalars that the JAX
package computes with ``jnp`` (the step and sigmoid schedules, the bias
corrections ``b ** t``) are computed here in float32 numpy, so that a
learning rate agrees with the reference's to the float32 ulp.
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


def _t(schedule, iteration, epoch):
    return iteration if schedule.schedule_type == "ITERATION" else epoch


_f32 = np.float32


@dataclass
class ExponentialSchedule(Schedule):
    """lr = initial * gamma^t (org.nd4j.linalg.schedule.ExponentialSchedule);
    t is the iteration or, with ``schedule_type="EPOCH"``, the epoch."""

    initial_value: float
    gamma: float
    schedule_type: str = "ITERATION"  # ITERATION | EPOCH

    def value(self, iteration, epoch) -> float:
        return self.initial_value * self.gamma ** _t(self, iteration, epoch)


@dataclass
class InverseSchedule(Schedule):
    """lr = initial / (1 + gamma t)^power."""

    initial_value: float
    gamma: float
    power: float
    schedule_type: str = "ITERATION"

    def value(self, iteration, epoch) -> float:
        return self.initial_value / (1 + self.gamma * _t(self, iteration, epoch)) ** self.power


@dataclass
class StepSchedule(Schedule):
    """lr = initial * decay_rate^floor(t / step), in float32."""

    initial_value: float
    decay_rate: float
    step: float
    schedule_type: str = "ITERATION"

    def value(self, iteration, epoch) -> float:
        n = np.floor(_f32(_t(self, iteration, epoch) / self.step))
        return float(_f32(self.initial_value) * _f32(self.decay_rate) ** n)


@dataclass
class PolySchedule(Schedule):
    """lr = initial * (1 - min(t, max_iter) / max_iter)^power, in float32."""

    initial_value: float
    power: float
    max_iter: int
    schedule_type: str = "ITERATION"

    def value(self, iteration, epoch) -> float:
        frac = _f32(min(_t(self, iteration, epoch), self.max_iter)) / _f32(self.max_iter)
        return float(_f32(self.initial_value) * (_f32(1) - frac) ** _f32(self.power))


@dataclass
class SigmoidSchedule(Schedule):
    """lr = initial / (1 + exp(gamma (t - step_size))), in float32."""

    initial_value: float
    gamma: float
    step_size: int
    schedule_type: str = "ITERATION"

    def value(self, iteration, epoch) -> float:
        x = _f32(self.gamma * (_t(self, iteration, epoch) - self.step_size))
        return float(_f32(self.initial_value) / (_f32(1) + np.exp(x)))


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
class Nesterovs(IUpdater):
    """org.nd4j.linalg.learning.NesterovsUpdater, in the JAX package's
    form: ``v = mu v - lr g``, then the update to subtract is
    ``-(mu v - lr g)`` with the new v."""

    learning_rate: float = 0.1
    momentum: float = 0.9

    def init(self, params):
        return {"v": _zeros(params)}

    @torch.no_grad()
    def apply(self, grads, state, params, iteration, epoch=0):
        names = list(grads)
        g = [grads[n] for n in names]
        v = [state["v"][n] for n in names]
        lr, mu = float(_lr(self, iteration, epoch)), self.momentum
        torch._foreach_mul_(v, mu)
        torch._foreach_add_(v, g, alpha=-lr)
        updates = torch._foreach_mul(g, lr)
        torch._foreach_add_(updates, v, alpha=-mu)
        return dict(zip(names, updates)), state


@dataclass
class AdaGrad(IUpdater):
    """``h += g^2``; update ``lr g / (sqrt(h) + eps)``."""

    learning_rate: float = 1e-1
    epsilon: float = 1e-6

    def init(self, params):
        return {"h": _zeros(params)}

    @torch.no_grad()
    def apply(self, grads, state, params, iteration, epoch=0):
        names = list(grads)
        g = [grads[n] for n in names]
        h = [state["h"][n] for n in names]
        torch._foreach_addcmul_(h, g, g)
        return dict(zip(names, _scaled_ratio(g, h, _lr(self, iteration, epoch),
                                             self.epsilon))), state


@dataclass
class RmsProp(IUpdater):
    """``g2 = d g2 + (1 - d) g^2``; update ``lr g / (sqrt(g2) + eps)``."""

    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init(self, params):
        return {"g2": _zeros(params)}

    @torch.no_grad()
    def apply(self, grads, state, params, iteration, epoch=0):
        names = list(grads)
        g = [grads[n] for n in names]
        g2 = [state["g2"][n] for n in names]
        d = self.rms_decay
        torch._foreach_mul_(g2, d)
        torch._foreach_addcmul_(g2, g, g, value=1 - d)
        return dict(zip(names, _scaled_ratio(g, g2, _lr(self, iteration, epoch),
                                             self.epsilon))), state


def _scaled_ratio(g, acc, lr, eps):
    """``lr g / (sqrt(acc) + eps)`` for each pair of the lists."""
    denom = torch._foreach_sqrt(acc)
    torch._foreach_add_(denom, eps)
    updates = torch._foreach_mul(g, float(lr))
    torch._foreach_div_(updates, denom)
    return updates


@dataclass
class AdaDelta(IUpdater):
    """``msg = rho msg + (1 - rho) g^2``; update ``g sqrt(msdx + eps) /
    sqrt(msg + eps)`` from the OLD msdx; then ``msdx = rho msdx + (1 - rho)
    update^2``. No learning rate, as in nd4j."""

    rho: float = 0.95
    epsilon: float = 1e-6

    def init(self, params):
        return {"msg": _zeros(params), "msdx": _zeros(params)}

    @torch.no_grad()
    def apply(self, grads, state, params, iteration, epoch=0):
        names = list(grads)
        g = [grads[n] for n in names]
        msg = [state["msg"][n] for n in names]
        msdx = [state["msdx"][n] for n in names]
        rho, eps = self.rho, self.epsilon
        torch._foreach_mul_(msg, rho)
        torch._foreach_addcmul_(msg, g, g, value=1 - rho)
        rms_dx = torch._foreach_add(msdx, eps)  # before msdx moves
        torch._foreach_sqrt_(rms_dx)
        rms_g = torch._foreach_add(msg, eps)
        torch._foreach_sqrt_(rms_g)
        updates = torch._foreach_mul(g, rms_dx)
        torch._foreach_div_(updates, rms_g)
        torch._foreach_mul_(msdx, rho)
        torch._foreach_addcmul_(msdx, updates, updates, value=1 - rho)
        return dict(zip(names, updates)), state


def _moments(upd, grads, state, names):
    """Adam's first and second moments of ``grads``, updated in place:
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``."""
    g = [grads[n] for n in names]
    m = [state["m"][n] for n in names]
    v = [state["v"][n] for n in names]
    torch._foreach_mul_(m, upd.beta1)
    torch._foreach_add_(m, g, alpha=1 - upd.beta1)
    torch._foreach_mul_(v, upd.beta2)
    torch._foreach_addcmul_(v, g, g, value=1 - upd.beta2)
    return g, m, v


def _bias_corrections(upd, iteration):
    """(1 - b1^t, 1 - b2^t) in float32, t = iteration + 1."""
    t = _f32(iteration) + _f32(1)
    return _f32(1) - _f32(upd.beta1) ** t, _f32(1) - _f32(upd.beta2) ** t


def _adam_alpha(upd, iteration, epoch):
    """``lr sqrt(1 - b2^t) / (1 - b1^t)`` in float32."""
    c1, c2 = _bias_corrections(upd, iteration)
    return float(_f32(_lr(upd, iteration, epoch)) * np.sqrt(c2) / c1)


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
        _, m, v = _moments(self, grads, state, names)
        return dict(zip(names, _adam_updates(m, v, _adam_alpha(self, iteration, epoch),
                                             self.epsilon))), state


def _adam_updates(m, v, alpha, eps):
    """``m / (sqrt(v) + eps) * alpha`` for each pair of the lists."""
    denom = torch._foreach_sqrt(v)
    torch._foreach_add_(denom, eps)
    updates = torch._foreach_div(m, denom)
    torch._foreach_mul_(updates, alpha)
    return updates


@dataclass
class AdaMax(IUpdater):
    """Adam's first moment, ``u = max(b2 u, |g|)``; update
    ``lr / (1 - b1^t) m / (u + eps)``."""

    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    @torch.no_grad()
    def apply(self, grads, state, params, iteration, epoch=0):
        names = list(grads)
        g = [grads[n] for n in names]
        m = [state["m"][n] for n in names]
        u = [state["u"][n] for n in names]
        torch._foreach_mul_(m, self.beta1)
        torch._foreach_add_(m, g, alpha=1 - self.beta1)
        torch._foreach_mul_(u, self.beta2)
        torch._foreach_maximum_(u, torch._foreach_abs(g))
        c1, _ = _bias_corrections(self, iteration)
        alpha = float(_f32(_lr(self, iteration, epoch)) / c1)
        denom = torch._foreach_add(u, self.epsilon)
        updates = torch._foreach_mul(m, alpha)
        torch._foreach_div_(updates, denom)
        return dict(zip(names, updates)), state


@dataclass
class Nadam(IUpdater):
    """Adam's moments; update ``lr (b1 m / c1 + (1 - b1) g / c1) /
    (sqrt(v / c2) + eps)`` with the bias corrections c1, c2."""

    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    @torch.no_grad()
    def apply(self, grads, state, params, iteration, epoch=0):
        names = list(grads)
        g, m, v = _moments(self, grads, state, names)
        c1, c2 = (float(c) for c in _bias_corrections(self, iteration))
        b1 = self.beta1
        updates = torch._foreach_mul(m, b1)
        torch._foreach_div_(updates, c1)
        fresh = torch._foreach_mul(g, 1 - b1)
        torch._foreach_div_(fresh, c1)
        torch._foreach_add_(updates, fresh)
        denom = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_div_(updates, denom)
        torch._foreach_mul_(updates, float(_lr(self, iteration, epoch)))
        return dict(zip(names, updates)), state


@dataclass
class AMSGrad(IUpdater):
    """Adam's moments and ``vhat = max(vhat, v)``; update
    ``alpha m / (sqrt(vhat) + eps)`` with Adam's alpha."""

    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": _zeros(params), "v": _zeros(params), "vhat": _zeros(params)}

    @torch.no_grad()
    def apply(self, grads, state, params, iteration, epoch=0):
        names = list(grads)
        _, m, v = _moments(self, grads, state, names)
        vhat = [state["vhat"][n] for n in names]
        torch._foreach_maximum_(vhat, v)
        return dict(zip(names, _adam_updates(m, vhat, _adam_alpha(self, iteration, epoch),
                                             self.epsilon))), state


_UPDATERS = {
    c.__name__: c
    for c in (NoOp, Sgd, Nesterovs, AdaGrad, RmsProp, AdaDelta, Adam, AdaMax, Nadam, AMSGrad)
}
_SCHEDULES = {
    c.__name__: c
    for c in (FixedSchedule, ExponentialSchedule, InverseSchedule, StepSchedule,
              PolySchedule, SigmoidSchedule, WarmupLinearDecay)
}


def _lookup(table, name, what):
    if name not in table:
        raise ValueError(f"unknown {what} {name!r}; known: {sorted(table)}")
    return table[name]


def get(name_or_updater, **kwargs) -> IUpdater:
    """An updater by name, or the one given. The name goes through the JAX
    package's rule, ``name.title().replace("_", "")``: ``"adam"``,
    ``"rms_prop"`` and ``"ada_grad"`` are found, ``"adagrad"`` is not."""
    if isinstance(name_or_updater, IUpdater):
        return name_or_updater
    name = str(name_or_updater).title().replace("_", "")
    return _lookup(_UPDATERS, name, "updater")(**kwargs)
