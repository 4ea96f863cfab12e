"""Port parity: every activation of ``deeplearning4j_tpu_torch.nn.activations``
against the JAX package's, on the CPU: outputs within 1e-5 absolute (scaled
by the output's magnitude above 1), the input gradient of one seeded
cotangent within 1e-4 of its norm, float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import activations as JA
from deeplearning4j_tpu_torch.nn import activations as TA
from torch_mln_helpers import OUT_ATOL, close, rel_err, t
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


def test_activation_registry_matches():
    assert TA.names() == JA.names()
    assert TA.get("ReLU") is TA.relu
    with pytest.raises(ValueError, match="unknown activation"):
        TA.get("nope")


@pytest.mark.parametrize("name", JA.names())
def test_activation_matches_jax(name):
    rs = np.random.RandomState(sum(map(ord, name)))
    x = (rs.randn(4, 9) * 2.0).astype(np.float32)
    x[0, :3] = [0.3, -0.4, 1.7]  # both sides of relu/hardtanh/thresholdedrelu kinks
    cot = rs.randn(4, 9).astype(np.float32)
    jout, vjp = jax.vjp(JA.get(name), jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(cot))
    tx = t(x, True)
    tout = TA.get(name)(tx)
    (tg,) = torch.autograd.grad(tout, tx, grad_outputs=t(cot))
    close(tout, jout, atol=OUT_ATOL * max(1.0, float(np.abs(jout).max())), what=name)
    assert rel_err(tg, jg) <= 1e-4, name
