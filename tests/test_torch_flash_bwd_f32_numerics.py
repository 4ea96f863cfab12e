"""Port numerics: the arithmetic of the float32 flash backward kernels
(``csrc/flash_bwd.cu``, ``flash_bwd_dkv_f32_kernel`` and
``flash_bwd_dq_f32_kernel``), modelled in plain torch on the CPU.

The kernels multiply on the TF32 tensor cores with split operands (3xTF32,
``torch_port_fixtures.product``): every operand x of S = Q K^T, dP = dO V^T,
dV = P^T dO, dK = dS^T Q and dQ = dS K is split x = hi + lo, hi rounded to
TF32 and lo truncated by the tensor core, and lo*hi + hi*lo + hi*hi go into
float32 accumulators. P = exp2(S scale log2 e - lse log2 e) and dS = P (dP -
delta) scale are formed in float32 on the accumulator fragments and split
in the same way before they feed dV, dK and dQ. The dq kernel runs first
and computes delta = rowsum(dO * O) in float32 FMA for the dkv kernel. The
dkv kernel sweeps 64-row q-tiles for its keys, the dq kernel 64-key tiles
for its rows. ``kernel_model`` repeats that arithmetic, TF32 rounding by
mantissa masking, with the number of TF32 terms chosen per product. On
numpy-seeded float32 inputs over ``chip_smoke.py`` phase 2's cases it is
held to:

- ``flash_backward_reference`` (float32 products, the TPU kernels'
  arithmetic) within phase 2's float32 backward bound, 1e-4 + 1e-4 |ref|
  (``BWD_FP32_ATOL``, ``BWD_FP32_RTOL``), for both sweeps, with delta
  within its own bound;
- the same model with one TF32 product in place of three, product by
  product: which products break that bound, and so why the kernels split
  every operand;
- the JAX package's Pallas backward ``_flash_bwd`` in interpret mode, under
  the same bound, except on rows with no live key, where the port follows
  ``mha_reference`` (``test_torch_attention_backward.py::
  test_dead_rows_follow_the_dense_reference``).

The model lives in ``torch_flash_bwd_f32_model.py``. This file holds it
against the plain version, with 3xTF32 and with one TF32 product;
``test_torch_flash_bwd_f32_vs_jax.py`` against the Pallas backward.

The kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import set_fp32_numerics
from deeplearning4j_tpu_torch.kernels import attention as TA
from torch_flash_bwd_f32_model import (CASES, PRODUCTS, assert_within_bound, bound_ratio,
                                       delta_tol, inputs, model_and_plain)
from torch_flash_bwd_f32_model import _one_torch_thread  # noqa: F401  (autouse)
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_split_tf32_model_within_phase_2_bound_of_plain_version(name):
    assert_within_bound(name)


# What one TF32 product (hi*hi alone, 10 mantissa bits) in place of the
# three does to the bound, product by product, at each head dim. Every
# product breaks it on every case, its worst gradient 2.2-20x over (3xTF32:
# at most 0.016 of it): S through exp, dP through dS (so dQ and dK), and dV,
# dK and dQ directly. So the kernels split every operand, and no product
# may use fewer terms.
ONE_TERM_CASES = ("bert_base", "causal_256", "d128_256", "d16_96", "segments_128",
                  "odd_77_d128")


@pytest.mark.parametrize("product_name", PRODUCTS)
def test_one_tf32_product_breaks_the_bound_for_every_product(product_name):
    ratios = {}
    for name in ONE_TERM_CASES:
        (dq, dk, dv, _), plain, _ = model_and_plain(name, terms={product_name: 1})
        ratios[name] = max(bound_ratio(g, r) for g, r in zip((dq, dk, dv), plain))
    assert all(r > 2.0 for r in ratios.values()), (product_name, ratios)


@pytest.mark.cuda
def test_cuda_f32_backward_kernels_match_plain_version_and_refuse_misaligned_rows():
    """On the card: both float32 kernels and the fused delta against the
    plain versions over every case above, at B=2 and at B=16 H=12 T=128
    (the float32 step check's shape), under phase 2's bounds; a float32
    tensor whose rows are not 16-byte aligned is refused with ValueError,
    never copied."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; run python3 chip_smoke.py there")
    set_fp32_numerics()
    rs = np.random.RandomState(9)
    big = [torch.from_numpy(rs.randn(16, 12, 128, 64).astype(np.float32)) for _ in range(4)]
    runs = [(name, *inputs(name)) for name, *_ in CASES]
    runs.append(("training_f32", big, (None, None, False, 0.125, 0)))
    for name, (q, k, v, do), (qseg, kseg, *rest) in runs:
        q, k, v, do = (t.cuda() for t in (q, k, v, do))
        args = (*(None if t is None else t.cuda() for t in (qseg, kseg)), *rest)
        out, lse = TA.flash_forward(q, k, v, *args)
        before = (TA.flash_backward_dq.launches, TA.flash_backward_dkv.launches)
        dq, delta = TA.flash_backward_dq(q, k, v, out, do, lse, *args)
        dk, dv = TA.flash_backward_dkv(q, k, v, do, lse, delta, *args)
        assert (TA.flash_backward_dq.launches, TA.flash_backward_dkv.launches) == \
            (before[0] + 1, before[1] + 1)
        rdq, rdelta = TA.flash_backward_dq_reference(q, k, v, out, do, lse, *args)
        rdk, rdv = TA.flash_backward_dkv_reference(q, k, v, do, lse, rdelta, *args)
        for g, r in ((dq, rdq), (dk, rdk), (dv, rdv)):
            assert g.dtype == torch.float32 and bound_ratio(g, r) <= 1.0, name
        assert bool(((delta - rdelta).abs() <= delta_tol(out, do)).all()), name
    flat = torch.zeros(2 * 2 * 64 * 64 + 1, dtype=torch.float32, device="cuda")
    shifted = flat[1:].view(2, 2, 64, 64)
    lse = torch.zeros((2, 2, 64), dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        TA.flash_backward_dq(shifted, shifted, shifted, shifted, shifted, lse, None, None,
                             False, 0.125, 0)
    with pytest.raises(ValueError, match="16-byte"):
        TA.flash_backward_dkv(shifted, shifted, shifted, shifted, lse, lse, None, None,
                              False, 0.125, 0)
