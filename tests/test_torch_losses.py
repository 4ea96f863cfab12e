"""Port parity: every loss of ``deeplearning4j_tpu_torch.nn.losses`` and the
two fused logits losses against the JAX package's, on the CPU: the loss
within 1e-5 relative and its gradient with respect to the predictions within
1e-4 of its norm, without a mask, with a per-example mask and with
per-output weights (nd4j's contract, ``_per_example_mean``), float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import losses as JL
from deeplearning4j_tpu_torch.nn import losses as TL
from torch_mln_helpers import rel_err, t
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


def _loss_inputs(name, rs, B=6, C=5):
    probs = lambda: (np.exp(z := rs.randn(B, C)) / np.exp(z).sum(1, keepdims=True))  # noqa: E731
    if name in ("xent",):
        return rs.randint(0, 2, (B, C)).astype(np.float32), rs.uniform(0.05, 0.95, (B, C))
    if name in ("mcxent", "negativeloglikelihood", "kldivergence"):
        return np.eye(C)[rs.randint(0, C, B)] if name != "kldivergence" else probs(), probs()
    if name == "sparsemcxent":
        return rs.randint(0, C, B), probs()
    if name in ("hinge", "squaredhinge"):
        return rs.choice([-1.0, 1.0], (B, C)), rs.randn(B, C)
    if name in ("poisson", "meansquaredlogarithmicerror"):
        return rs.uniform(0.1, 3.0, (B, C)), rs.uniform(0.1, 3.0, (B, C))
    return rs.randn(B, C), rs.randn(B, C) * 1.5


FUSED = ["softmax_cross_entropy_with_logits", "sigmoid_cross_entropy_with_logits"]


@pytest.mark.parametrize("name", JL.names() + FUSED)
def test_loss_matches_jax(name):
    assert TL.names() == JL.names()
    rs = np.random.RandomState(len(name))
    labels, preds = _loss_inputs(name, rs)
    if name in FUSED:
        labels = (np.eye(5)[rs.randint(0, 5, 6)] if name.startswith("softmax")
                  else rs.randint(0, 2, (6, 5)))
        preds = rs.randn(6, 5) * 2.0
        jfn, tfn = getattr(JL, name), getattr(TL, name)
    else:
        jfn, tfn = JL.get(name), TL.get(name)
    labels = np.asarray(labels, np.int32 if name == "sparsemcxent" else np.float32)
    preds = np.asarray(preds, np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    weights = rs.uniform(0.5, 2.0, (5,)).astype(np.float32)
    cases = [dict(), dict(mask=mask)] + ([dict(weights=weights)] if name != "sparsemcxent" else [])
    for kw in cases:
        jl, jg = jax.value_and_grad(lambda p: jfn(jnp.asarray(labels), p,
                                                  **{k: jnp.asarray(v) for k, v in kw.items()})
                                    )(jnp.asarray(preds))
        tp = t(preds, True)
        tl = tfn(t(labels), tp, **{k: t(v) for k, v in kw.items()})
        (tg,) = torch.autograd.grad(tl, tp)
        assert abs(tl.item() - float(jl)) <= 1e-5 * max(abs(float(jl)), 1e-3), (name, kw)
        assert rel_err(tg, jg) <= 1e-4, (name, sorted(kw))
