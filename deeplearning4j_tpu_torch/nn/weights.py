"""Weight initialization schemes.

Counterpart of ``deeplearning4j_tpu/nn/weights.py`` (DL4J's ``WeightInit``
enum and ``WeightInitUtil``): the same schemes, names and fan formulas. The
values are drawn from an explicit ``torch.Generator``, so they differ from
the JAX package's draws by construction; tests compare each scheme's mean
and variance, and parity tests copy the JAX weights across.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _normal(g, shape, dtype):
    return torch.randn(shape, generator=g, dtype=dtype, device=g.device)


def _uniform(g, shape, dtype, a):
    return torch.empty(shape, dtype=dtype, device=g.device).uniform_(-a, a, generator=g)


def init_weights(generator: torch.Generator, shape: Tuple[int, ...], fan_in: float,
                 fan_out: float, scheme: str, dtype=torch.float32) -> torch.Tensor:
    """A tensor of ``shape`` on the generator's device, drawn by ``scheme``."""
    s = scheme.lower()
    g = generator
    if s == "zero":
        return torch.zeros(shape, dtype=dtype, device=g.device)
    if s == "ones":
        return torch.ones(shape, dtype=dtype, device=g.device)
    if s == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init needs a square 2-d shape")
        return torch.eye(shape[0], dtype=dtype, device=g.device)
    if s == "xavier":
        # WeightInitUtil: gaussian, var = 2/(fanIn+fanOut)
        return _normal(g, shape, dtype) * math.sqrt(2.0 / (fan_in + fan_out))
    if s in ("xavier_uniform", "xavieruniform"):
        return _uniform(g, shape, dtype, math.sqrt(6.0 / (fan_in + fan_out)))
    if s in ("xavier_fan_in", "xavierfanin"):
        return _normal(g, shape, dtype) / math.sqrt(fan_in)
    if s == "relu":
        # He init: gaussian var=2/fanIn
        return _normal(g, shape, dtype) * math.sqrt(2.0 / fan_in)
    if s in ("relu_uniform", "reluuniform"):
        return _uniform(g, shape, dtype, math.sqrt(6.0 / fan_in))
    if s in ("lecun_normal", "lecunnormal"):
        return _normal(g, shape, dtype) / math.sqrt(fan_in)
    if s in ("lecun_uniform", "lecununiform"):
        return _uniform(g, shape, dtype, math.sqrt(3.0 / fan_in))
    if s == "uniform":
        return _uniform(g, shape, dtype, 1.0 / math.sqrt(fan_in))
    if s == "normal":
        return _normal(g, shape, dtype) / math.sqrt(fan_in)
    if s in ("sigmoid_uniform", "sigmoiduniform"):
        return _uniform(g, shape, dtype, 4.0 * math.sqrt(6.0 / (fan_in + fan_out)))
    if s in ("var_scaling_normal_fan_in", "varscalingnormalfanin"):
        return _normal(g, shape, dtype) / math.sqrt(fan_in)
    if s in ("var_scaling_normal_fan_out", "varscalingnormalfanout"):
        return _normal(g, shape, dtype) / math.sqrt(fan_out)
    if s in ("var_scaling_normal_fan_avg", "varscalingnormalfanavg"):
        return _normal(g, shape, dtype) / math.sqrt((fan_in + fan_out) / 2.0)
    raise ValueError(f"unknown weight init scheme {scheme!r}")
