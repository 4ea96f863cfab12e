"""Activation functions.

Counterpart of ``deeplearning4j_tpu/nn/activations.py``: nd4j's
``Activation`` enum names (case-insensitive) mapped to elementwise torch
functions, with the same formulas; gradients come from autograd.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, Activation] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn

    return deco


def get(name) -> Activation:
    """Resolve an activation by nd4j enum name (case-insensitive)."""
    if callable(name):
        return name
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; known: {sorted(_REGISTRY)}") from None


def names():
    return sorted(_REGISTRY)


@register("identity")
def identity(x):
    return x


@register("relu")
def relu(x):
    return torch.relu(x)


@register("relu6")
def relu6(x):
    return F.relu6(x)


@register("leakyrelu")
def leakyrelu(x, alpha=0.01):
    return torch.where(x >= 0, x, alpha * x)


@register("elu")
def elu(x):
    return F.elu(x)


@register("selu")
def selu(x):
    return F.selu(x)


@register("gelu")
def gelu(x):
    return F.gelu(x)  # the exact erf form, as the reference's approximate=False


@register("precisegelu")
def precise_gelu(x):
    return F.gelu(x)


@register("tanh")
def tanh(x):
    return torch.tanh(x)


@register("rationaltanh")
def rationaltanh(x):
    # nd4j RationalTanh: 1.7159 * tanh(2x/3) approximation family
    a = torch.abs(2.0 * x / 3.0)
    approx = torch.sign(x) * (1.0 - 1.0 / torch.square(1.0 + a + a * a + 1.41645 * a ** 4))
    return 1.7159 * approx


@register("rectifiedtanh")
def rectifiedtanh(x):
    return torch.clamp(torch.tanh(x), min=0.0)


@register("hardtanh")
def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("hardsigmoid")
def hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


@register("softmax")
def softmax(x):
    return torch.softmax(x, dim=-1)


@register("logsoftmax")
def logsoftmax(x):
    return torch.log_softmax(x, dim=-1)


@register("softplus")
def softplus(x):
    return F.softplus(x)


@register("softsign")
def softsign(x):
    return F.softsign(x)


@register("swish")
def swish(x):
    return F.silu(x)


@register("mish")
def mish(x):
    return x * torch.tanh(F.softplus(x))


@register("cube")
def cube(x):
    return x ** 3


@register("thresholdedrelu")
def thresholdedrelu(x, theta=1.0):
    return torch.where(x > theta, x, torch.zeros_like(x))


def prelu(x, alpha):
    """Parametric ReLU (learned alpha)."""
    return torch.where(x >= 0, x, alpha * x)
