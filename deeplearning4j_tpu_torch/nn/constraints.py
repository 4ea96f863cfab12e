"""Parameter constraints and weight noise.

Counterpart of ``deeplearning4j_tpu/nn/constraints.py``: DL4J's
``MaxNormConstraint``, ``MinMaxNormConstraint``, ``UnitNormConstraint`` and
``NonNegativeConstraint``, which ``MultiLayerNetwork`` applies to each
layer's weights right after the update, and ``WeightNoise`` /
``DropConnect``, applied to the weights in each training forward (noise
drawn from an explicit generator per parameter).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .dropout import RngKey


def _norm(w, axes):
    return torch.sqrt(torch.sum(torch.square(w), dim=axes, keepdim=True) + 1e-12)


@dataclass
class MaxNormConstraint:
    """Clip the norm of each output unit to max_norm (norm over ``axes``)."""

    max_norm: float = 2.0
    axes: Tuple[int, ...] = (0,)

    def apply(self, w):
        return w * torch.clamp(self.max_norm / _norm(w, self.axes), max=1.0)


@dataclass
class MinMaxNormConstraint:
    """Force per-unit norms into [min_norm, max_norm] at ``rate``."""

    min_norm: float = 0.0
    max_norm: float = 2.0
    rate: float = 1.0
    axes: Tuple[int, ...] = (0,)

    def apply(self, w):
        n = _norm(w, self.axes)
        target = self.rate * torch.clamp(n, self.min_norm, self.max_norm) + (1.0 - self.rate) * n
        return w * (target / n)


@dataclass
class UnitNormConstraint:
    axes: Tuple[int, ...] = (0,)

    def apply(self, w):
        return w / _norm(w, self.axes)


@dataclass
class NonNegativeConstraint:
    def apply(self, w):
        return torch.clamp(w, min=0.0)


def apply_constraints(layer_params: dict, constraints, constrain_bias: bool = False) -> dict:
    """Every constraint applied to each weight param (bias excluded unless
    constrain_bias, matching BaseConstraint.paramNames handling)."""
    if not constraints:
        return layer_params
    out = {}
    for k, w in layer_params.items():
        if k == "b" and not constrain_bias:
            out[k] = w
            continue
        for c in constraints:
            w = c.apply(w)
        out[k] = w
    return out


@dataclass
class WeightNoise:
    """conf.weightnoise.WeightNoise: gaussian noise on weights during
    training forward (additive N(0, stddev) or multiplicative N(1, stddev));
    gradients flow through the noisy weights."""

    stddev: float = 0.01
    additive: bool = True
    apply_to_bias: bool = False

    def apply(self, params: dict, rng: RngKey, training: bool) -> dict:
        if not training or rng is None or self.stddev <= 0.0:
            return params
        out = {}
        for i, (k, w) in enumerate(sorted(params.items())):
            if k == "b" and not self.apply_to_bias:
                out[k] = w
                continue
            g = rng.fold_in(i).generator(w.device)
            noise = torch.randn(w.shape, generator=g, device=w.device, dtype=w.dtype) * self.stddev
            out[k] = w + noise if self.additive else w * (1.0 + noise)
        return out


@dataclass
class DropConnect:
    """conf.weightnoise.DropConnect: bernoulli-mask weights during training
    (p = retain probability, inverted scaling)."""

    p: float = 0.5
    apply_to_bias: bool = False

    def apply(self, params: dict, rng: RngKey, training: bool) -> dict:
        if not training or rng is None or self.p in (0.0, 1.0):
            return params
        out = {}
        for i, (k, w) in enumerate(sorted(params.items())):
            if k == "b" and not self.apply_to_bias:
                out[k] = w
                continue
            g = rng.fold_in(i).generator(w.device)
            mask = torch.rand(w.shape, generator=g, device=w.device) < self.p
            out[k] = torch.where(mask, w / self.p, torch.zeros_like(w))
        return out
