"""Dropout schemes (DL4J's ``IDropout`` implementations) and the port's
random keys.

Counterpart of ``deeplearning4j_tpu/nn/dropout.py``. A layer's ``dropout``
field takes a float (the probability of RETAINING an activation, DL4J's
``dropOut(p)``, inverted scaling) or one of these objects; all apply to the
layer's input in training only. Each ``apply`` takes an explicit
``torch.Generator``, so its masks differ from the JAX package's by
construction; the tests hold the schemes to their statistics, and parity
runs at dropout 0.

:class:`RngKey` stands in for a JAX key: the network derives one per step as
JAX does (``fold_in(key(seed ^ 0x5EED), iteration)``, then ``fold_in(·,
layer)``) and turns it into a generator only where random numbers are drawn.
Inside a data-parallel step over several ranks, every mask and noise array
is drawn at the global batch's shape and each rank takes its rows, so a
W-rank fit draws what a one-process fit on the global batch draws
(``common.data_parallel``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..common.data_parallel import batch_rows


@dataclass(frozen=True)
class RngKey:
    """A path of non-negative integers (a seed, then what was folded in)."""

    path: Tuple[int, ...]

    def fold_in(self, data: int) -> "RngKey":
        return RngKey(self.path + (int(data),))

    def seed(self) -> int:
        return int(np.random.SeedSequence(list(self.path)).generate_state(1, np.uint64)[0]
                   & 0x7FFF_FFFF_FFFF_FFFF)

    def generator(self, device) -> torch.Generator:
        return torch.Generator(device=torch.device(device)).manual_seed(self.seed())


def _bernoulli(p, shape, like, generator):
    """A keep-mask of ``shape`` (batch first). Inside a data-parallel step
    over several ranks, the mask is drawn at the global batch's shape and
    this rank takes its rows (``common.data_parallel.batch_rows``)."""
    draw, rows = batch_rows(shape)
    r = torch.rand(draw, generator=generator, device=like.device)
    return (r if rows is None else r[rows]) < p


def _normal(x, generator):
    """Standard normal noise shaped like ``x`` (batch first), drawn at the
    global batch's shape inside a data-parallel step, as :func:`_bernoulli`."""
    draw, rows = batch_rows(x.shape)
    n = torch.randn(draw, generator=generator, device=x.device, dtype=x.dtype)
    return n if rows is None else n[rows]


@dataclass
class Dropout:
    """Inverted dropout; p = probability of RETAINING an activation."""

    p: float = 0.5

    def apply(self, x, generator, training: bool):
        if not training or self.p in (0.0, 1.0) or generator is None:
            return x
        mask = _bernoulli(self.p, x.shape, x, generator)
        return torch.where(mask, x / self.p, torch.zeros_like(x))


@dataclass
class SpatialDropout(Dropout):
    """Drop entire channels (feature maps / rnn channels): one bernoulli per
    [B, C], broadcast over the spatial/time dims."""

    def apply(self, x, generator, training: bool):
        if not training or self.p in (0.0, 1.0) or generator is None:
            return x
        shape = tuple(x.shape[:2]) + (1,) * (x.dim() - 2)
        mask = _bernoulli(self.p, shape, x, generator)
        return torch.where(mask, x / self.p, torch.zeros_like(x))


@dataclass
class GaussianDropout:
    """Multiplicative gaussian noise N(1, rate/(1-rate)) (Srivastava et al.);
    mean-preserving, no rescale needed."""

    rate: float = 0.5

    def apply(self, x, generator, training: bool):
        if not training or self.rate <= 0.0 or generator is None:
            return x
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + std * _normal(x, generator))


@dataclass
class GaussianNoise:
    """Additive gaussian noise N(0, stddev)."""

    stddev: float = 0.1

    def apply(self, x, generator, training: bool):
        if not training or self.stddev <= 0.0 or generator is None:
            return x
        return x + self.stddev * _normal(x, generator)


@dataclass
class AlphaDropout:
    """SELU-compatible dropout (Klambauer et al. 2017): keeps self-normalizing
    mean/variance by dropping to alpha' and applying the affine correction."""

    p: float = 0.5  # retain probability

    _ALPHA = 1.6732632423543772
    _SCALE = 1.0507009873554805

    def apply(self, x, generator, training: bool):
        if not training or self.p in (0.0, 1.0) or generator is None:
            return x
        alpha_p = -self._ALPHA * self._SCALE
        keep = self.p
        a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * alpha_p * (1 - keep)
        mask = _bernoulli(keep, x.shape, x, generator)
        return (a * torch.where(mask, x, torch.full_like(x, alpha_p)) + b).to(x.dtype)


def apply_dropout(dropout, x, generator, training: bool):
    """Dispatch: float (retain prob) or IDropout object or None."""
    if dropout is None:
        return x
    if hasattr(dropout, "apply"):
        return dropout.apply(x, generator, training)
    if not training or dropout in (0.0, 1.0) or generator is None:
        return x
    mask = _bernoulli(dropout, x.shape, x, generator)
    return torch.where(mask, x / dropout, torch.zeros_like(x))
