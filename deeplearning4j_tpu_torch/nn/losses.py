"""Loss functions.

Counterpart of ``deeplearning4j_tpu/nn/losses.py`` (nd4j's
``LossFunctions.LossFunction`` names). Each loss is ``loss(labels, preds,
mask=None, weights=None) -> scalar`` under nd4j's contract
(:func:`_per_example_mean`): sum over the output dims, mask, then the mean
over unmasked examples (or example-timesteps for a [B, T] mask). Gradients
come from autograd.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

Loss = Callable

_REGISTRY: Dict[str, Loss] = {}
_EPS = 1e-7


def register(name: str):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn

    return deco


def get(name) -> Loss:
    if callable(name):
        return name
    try:
        return _REGISTRY[name.lower().replace("_", "")]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; known: {sorted(_REGISTRY)}") from None


def names():
    return sorted(_REGISTRY)


def _per_example_mean(per_elem, mask, weights):
    """nd4j contract: sum over output dims -> per-example score; mask zeroes
    examples/timesteps; weights scale per-output; final score = mean over
    unmasked examples (or example-timesteps for a [B,T] mask)."""
    if weights is not None:
        per_elem = per_elem * weights
    if mask is not None:
        m = torch.as_tensor(mask, device=per_elem.device)
        # trailing singleton dims on the mask ([B,1] etc.) collapse first
        while m.dim() > 1 and m.shape[-1] == 1 and m.dim() > per_elem.dim() - 1:
            m = m.squeeze(-1)
        # reduce per_elem over every dim beyond the mask's rank ([B] mask over
        # [B,C] preds; [B,T] mask over [B,T,C] time-distributed preds)
        axes = tuple(range(m.dim(), per_elem.dim()))
        per_unit = per_elem.sum(dim=axes) if axes else per_elem
        m = m.to(per_unit.dtype)
        return (per_unit * m).sum() / m.sum().clamp(min=1.0)
    axes = tuple(range(1, per_elem.dim()))
    per_example = per_elem.sum(dim=axes) if axes else per_elem
    return per_example.mean()


@register("mse")
def mse(labels, preds, mask=None, weights=None):
    return _per_example_mean(torch.square(preds - labels), mask, weights)


@register("l2")
def l2(labels, preds, mask=None, weights=None):
    # nd4j L2 = sum of squares (no mean over outputs), per-example mean overall
    return _per_example_mean(torch.square(preds - labels), mask, weights)


@register("mae")
def mae(labels, preds, mask=None, weights=None):
    return _per_example_mean(torch.abs(preds - labels), mask, weights)


@register("l1")
def l1(labels, preds, mask=None, weights=None):
    return _per_example_mean(torch.abs(preds - labels), mask, weights)


@register("xent")
def xent(labels, preds, mask=None, weights=None):
    """Binary cross-entropy on probabilities (LossBinaryXENT)."""
    p = torch.clamp(preds, _EPS, 1 - _EPS)
    ce = -(labels * torch.log(p) + (1 - labels) * torch.log1p(-p))
    return _per_example_mean(ce, mask, weights)


@register("mcxent")
def mcxent(labels, preds, mask=None, weights=None):
    """Multi-class cross-entropy on probabilities (LossMCXENT); labels one-hot."""
    ce = -labels * torch.log(torch.clamp(preds, _EPS, 1.0))
    return _per_example_mean(ce, mask, weights)


@register("sparsemcxent")
def sparse_mcxent(labels, preds, mask=None, weights=None):
    """Integer-label variant (LossSparseMCXENT)."""
    logp = torch.log(torch.clamp(preds, _EPS, 1.0))
    idx = torch.as_tensor(labels, device=logp.device).long()[..., None]
    ce = -torch.gather(logp, -1, idx)[..., 0]
    if mask is not None:
        m = torch.as_tensor(mask, device=ce.device).to(ce.dtype)
        while m.dim() > ce.dim():
            m = m.squeeze(-1)
        return (ce * m).sum() / m.sum().clamp(min=1.0)
    return ce.mean()


@register("negativeloglikelihood")
def negativeloglikelihood(labels, preds, mask=None, weights=None):
    return mcxent(labels, preds, mask, weights)


@register("kldivergence")
def kl_divergence(labels, preds, mask=None, weights=None):
    kl = labels * (torch.log(torch.clamp(labels, _EPS, 1.0))
                   - torch.log(torch.clamp(preds, _EPS, 1.0)))
    return _per_example_mean(kl, mask, weights)


@register("hinge")
def hinge(labels, preds, mask=None, weights=None):
    # labels in {-1, +1}
    return _per_example_mean(torch.clamp(1.0 - labels * preds, min=0.0), mask, weights)


@register("squaredhinge")
def squared_hinge(labels, preds, mask=None, weights=None):
    return _per_example_mean(torch.square(torch.clamp(1.0 - labels * preds, min=0.0)), mask,
                             weights)


@register("poisson")
def poisson(labels, preds, mask=None, weights=None):
    return _per_example_mean(preds - labels * torch.log(torch.clamp(preds, min=_EPS)), mask,
                             weights)


@register("cosineproximity")
def cosine_proximity(labels, preds, mask=None, weights=None):
    ln = labels / torch.linalg.vector_norm(labels, dim=-1, keepdim=True).clamp(min=1e-8)
    pn = preds / torch.linalg.vector_norm(preds, dim=-1, keepdim=True).clamp(min=1e-8)
    return _per_example_mean(-ln * pn, mask, weights)


@register("meansquaredlogarithmicerror")
def msle(labels, preds, mask=None, weights=None):
    return _per_example_mean(
        torch.square(torch.log1p(torch.clamp(preds, min=-0.999999)) - torch.log1p(labels)),
        mask, weights)


@register("meanabsolutepercentageerror")
def mape(labels, preds, mask=None, weights=None):
    return _per_example_mean(
        100.0 * torch.abs((labels - preds) / torch.abs(labels).clamp(min=1e-8)), mask, weights)


@register("huber")
def huber(labels, preds, mask=None, weights=None, delta: float = 1.0):
    err = torch.abs(preds - labels)
    quad = torch.clamp(err, max=delta)
    return _per_example_mean(0.5 * quad ** 2 + delta * (err - quad), mask, weights)


@register("wasserstein")
def wasserstein(labels, preds, mask=None, weights=None):
    return _per_example_mean(labels * preds, mask, weights)


def softmax_cross_entropy_with_logits(labels, logits, mask=None, weights=None):
    """The numerically stable fused path that ``OutputLayer`` takes for
    softmax + mcxent/NLL (libnd4j's softmax_cross_entropy_loss)."""
    ce = -labels * torch.log_softmax(logits, dim=-1)
    return _per_example_mean(ce, mask, weights)


def sigmoid_cross_entropy_with_logits(labels, logits, mask=None, weights=None):
    ce = (torch.clamp(logits, min=0) - logits * labels
          + torch.log1p(torch.exp(-torch.abs(logits))))
    return _per_example_mean(ce, mask, weights)
