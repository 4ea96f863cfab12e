"""Port numerics: the float32 flash backward kernels' arithmetic
(``torch_flash_bwd_f32_model.kernel_model``) against the JAX package's
Pallas backward ``_flash_bwd``, run in interpret mode on the same
numpy-seeded float32 inputs and the same saved (out, lse), under
``chip_smoke.py`` phase 2's float32 backward bound. The model is set out in
``test_torch_flash_bwd_f32_numerics.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import attention as JA
from deeplearning4j_tpu_torch.kernels import attention as TA
from torch_flash_bwd_f32_model import bound_ratio, inputs, kernel_model
from torch_flash_bwd_f32_model import _one_torch_thread  # noqa: F401  (autouse)
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

# block-divisible cases, where the Pallas backward needs no pad shim; in the
# padded ones example 0 has no live key, and there the Pallas backward is
# wrong without its shim, so that example is left out of the comparison
JAX_CASES = ["bert_base", "bert_base_pad", "causal_256", "segments_128", "segments_pad_128",
             "rect_q64_k256_causal", "d128_256"]


@pytest.mark.parametrize("name", JAX_CASES)
def test_split_tf32_model_matches_jax_flash_backward(name):
    """The model against the TPU kernels run in interpret mode on the same
    float32 inputs and the same saved (out, lse), under the same bound."""
    (q, k, v, do), (qseg, kseg, causal, scale, q_offset) = inputs(name)
    j = [jnp.asarray(t.numpy()) for t in (q, k, v, do)]
    js = [None if t is None else jnp.asarray(t.numpy()) for t in (qseg, kseg)]
    _, res = JA._flash_fwd(*j[:3], *js, causal, scale, 64, 64, True, q_offset)
    jgrads = JA._flash_bwd(causal, scale, 64, 64, True, q_offset, res, j[3])[:3]
    out = torch.from_numpy(np.asarray(res[5]))
    lse = torch.from_numpy(np.asarray(res[6])[..., 0])
    model = kernel_model(q, k, v, out, do, lse, qseg, kseg, causal, scale, q_offset)
    first = 1 if bool((lse[0] <= TA.DEAD_ROW_LSE).all()) else 0  # a dead example
    assert not bool((lse[first:] <= TA.DEAD_ROW_LSE).any())
    for gname, g, a in zip(("dq", "dk", "dv"), model[:3], jgrads):
        ref = torch.from_numpy(np.asarray(a))
        ratio = bound_ratio(g[first:], ref[first:])
        assert ratio <= 1.0, f"{name}: {gname} worst element at {ratio:.3f} of the bound"
