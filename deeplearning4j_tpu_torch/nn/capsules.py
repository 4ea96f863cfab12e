"""Capsule network layers (Sabour, Frosst & Hinton 2017, "Dynamic Routing
Between Capsules").

Counterpart of ``deeplearning4j_tpu/nn/capsules.py`` (DL4J's
``conf.layers.PrimaryCapsules``, ``CapsuleLayer``, ``CapsuleStrengthLayer``).
A set of capsules travels as [B, capsule_dim, n_capsules], the layout of a
recurrent tensor, so the layers compose with ``InputType.recurrent``. The
routing is three (``routings``) unrolled rounds of batched products, a
softmax over the output capsules and the squash; the prediction vectors are
detached in every round but the last.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .conf import LAYER_REGISTRY, InputType, Layer
from .weights import init_weights


def squash(s, dim=-1, eps=1e-8):
    """v = (|s|² / (1 + |s|²)) · s / |s| (Sabour et al. eq. 1), ``eps``
    under the square root."""
    sq = torch.sum(torch.square(s), dim=dim, keepdim=True)
    return (sq / (1.0 + sq)) * s / torch.sqrt(sq + eps)


@dataclass
class PrimaryCapsules(Layer):
    """conf.layers.PrimaryCapsules: a "valid" convolution of the image into
    ``capsules · capsule_dim`` channels (ordered capsule-major, then dim),
    reshaped to [B, capsule_dim, capsules · H' · W'] and squashed."""

    capsules: int = 8          # channel groups: n_caps = capsules * H' * W'
    capsule_dim: int = 8
    kernel_size: int = 3
    stride: int = 2

    def output_type(self, it: InputType) -> InputType:
        h = (it.height - self.kernel_size) // self.stride + 1
        w = (it.width - self.kernel_size) // self.stride + 1
        return InputType.recurrent(self.capsule_dim, self.capsules * h * w)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        c_in = it.channels
        out_ch = self.capsules * self.capsule_dim
        k = self.kernel_size
        return {"W": init_weights(generator, (out_ch, c_in, k, k), c_in * k * k, out_ch,
                                  self.weight_init, dtype),
                "b": torch.zeros((out_ch,), dtype=dtype, device=generator.device)}

    def forward(self, params, x, it, *, training, rng=None):
        dt = torch.promote_types(x.dtype, params["W"].dtype)
        z = F.conv2d(x.to(dt), params["W"].to(dt), params["b"].to(dt), stride=self.stride)
        B = z.shape[0]
        caps = z.reshape(B, self.capsules, self.capsule_dim, -1).transpose(1, 2)
        return squash(caps.reshape(B, self.capsule_dim, -1), dim=1)


@dataclass
class CapsuleLayer(Layer):
    """conf.layers.CapsuleLayer: dynamic routing from [B, in_dim, in_caps]
    to [B, capsule_dim, capsules]; W [capsules, in_caps, in_dim,
    capsule_dim]. The coupling coefficients are a softmax over the output
    capsules."""

    capsules: int = 10
    capsule_dim: int = 16
    routings: int = 3

    def __post_init__(self):
        if self.routings < 1:
            raise ValueError(f"routings must be >= 1, got {self.routings}")

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.capsule_dim, self.capsules)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        in_caps, in_dim = it.timeseries_length, it.size
        if in_caps is None:
            raise ValueError(
                "CapsuleLayer needs a known input capsule count: the incoming "
                "InputType has timeseries_length=None — set the sequence "
                "length in set_input_type / the upstream layer")
        return {"W": init_weights(generator, (self.capsules, in_caps, in_dim, self.capsule_dim),
                                  in_dim, self.capsule_dim, self.weight_init, dtype)}

    def forward(self, params, x, it, *, training, rng=None):
        dt = torch.promote_types(x.dtype, params["W"].dtype)
        u = x.to(dt).transpose(1, 2)                                     # [B, I, D]
        # prediction vectors û[j|i] = W_ij u_i: [B, J, I, E]
        u_hat = torch.einsum("bid,jide->bjie", u, params["W"].to(dt))
        u_hat_ng = u_hat.detach()
        b = torch.zeros(u_hat.shape[:3], dtype=dt, device=x.device)     # [B, J, I]
        for r in range(self.routings):
            c = torch.softmax(b, dim=1)                                  # over output capsules
            last = r == self.routings - 1
            v = squash(torch.einsum("bji,bjie->bje", c, u_hat if last else u_hat_ng), dim=-1)
            if not last:
                b = b + torch.einsum("bjie,bje->bji", u_hat_ng, v)
        return v.transpose(1, 2)                                         # [B, E, J]


@dataclass
class CapsuleStrengthLayer(Layer):
    """conf.layers.CapsuleStrengthLayer: each capsule's length, [B, n_caps]
    (the class scores of the margin loss)."""

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(it.timeseries_length)

    def forward(self, params, x, it, *, training, rng=None):
        return torch.sqrt(torch.sum(torch.square(x), dim=1) + 1e-12)


def margin_loss(labels, lengths, m_plus=0.9, m_minus=0.1, lam=0.5):
    """CapsNet's margin loss (Sabour et al. eq. 4), summed over the classes
    and averaged over the batch."""
    pos = labels * torch.square(torch.clamp(m_plus - lengths, min=0.0))
    neg = lam * (1.0 - labels) * torch.square(torch.clamp(lengths - m_minus, min=0.0))
    return torch.mean(torch.sum(pos + neg, dim=-1))


@dataclass
class CapsNetOutputLayer(Layer):
    """The margin-loss head over capsule lengths (DL4J pairs
    CapsuleStrengthLayer with a loss layer; fused here, as in the JAX
    package)."""

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return it

    def forward(self, params, x, it, *, training, rng=None):
        return x

    def compute_loss(self, params, x, labels, it, *, training, rng=None, mask=None):
        return margin_loss(labels, x.float())


for _cls in (PrimaryCapsules, CapsuleLayer, CapsuleStrengthLayer, CapsNetOutputLayer):
    LAYER_REGISTRY[_cls.__name__] = _cls
