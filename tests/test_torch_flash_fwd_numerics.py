"""Port numerics: the arithmetic of the bf16 flash forward kernel
(``csrc/flash_fwd.cu``, ``flash_fwd_bf16_kernel``), modelled in plain torch
on the CPU.

The kernel computes S = Q K^T on the tensor cores from bf16 operands (each
product exact in float32, the sums in float32), the online softmax in
float32 with exp(x) taken as exp2(x log2 e), and P V with P split into two
bf16 terms, P = P_hi + P_lo with P_lo = bf16(P - P_hi), each multiplied by
the bf16 V into one float32 accumulator; the output is rounded to bf16
once. ``kernel_model`` repeats those roundings over 64-key tiles. On the
same numpy-seeded inputs it is held to:

- ``flash_forward_reference`` (float32 P V, the TPU kernel's arithmetic),
  under ``chip_smoke.py`` phase 2's bf16 bound: one bf16 ulp of the value
  (2^-7 |ref|) + 1e-5, and lse to 1e-5 relative;
- the same model with P rounded to bf16 once, which breaks that bound:
  the reason the kernel splits P;
- the JAX package's Pallas forward ``_flash_forward`` in interpret mode,
  under the same bound.

The kernel itself is held against the plain version on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import attention as JA
from deeplearning4j_tpu_torch import set_fp32_numerics
from deeplearning4j_tpu_torch.kernels import attention as TA
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

BF16_ULP_REL = 2.0 ** -7  # chip_smoke.py phase 2: one bf16 ulp of the value ...
BF16_ATOL = 1e-5          # ... plus float32 reordering near zero
LSE_TOL = 1e-5            # relative, float32 lse
LOG2E = 1.4426950408889634
TILE_K = 64


def kernel_model(q, k, v, qseg, kseg, causal, scale, q_offset, split=True):
    """(out in bf16, lse float32) by the bf16 kernel's arithmetic; with
    ``split=False`` P is rounded to bf16 once instead of split in two."""
    B, H, Tq, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, H, Tq, 1), -1e30)
    l = torch.zeros((B, H, Tq, 1))
    acc = torch.zeros((B, H, Tq, D))
    for k0 in range(0, k.shape[2], TILE_K):
        vt = vf[:, :, k0:k0 + TILE_K]
        s = TA._tile_scores(qf, kf[:, :, k0:k0 + TILE_K], k0, qseg, kseg, causal, scale,
                            q_offset)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((s - m_new) * LOG2E)
        hi = p.to(torch.bfloat16).float()
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = torch.matmul(hi, vt) + torch.matmul(lo, vt)
        else:
            pv = torch.matmul(hi, vt)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + pv
        m = m_new
    return (acc * (1.0 / l)).to(torch.bfloat16), (m + torch.log(l))[..., 0]


# chip_smoke.py phase 2's cases at a small B and H:
# (name, Tq, Tk, D, causal, masking)
CASES = [
    ("bert_base", 128, 128, 64, False, None),
    ("bert_base_pad", 128, 128, 64, False, "pad"),
    ("causal_256", 256, 256, 64, True, None),
    ("pad_200", 200, 200, 64, False, "pad"),
    ("pad_200_causal", 200, 200, 64, True, "pad"),
    ("segments_128", 128, 128, 32, False, "seg"),
    ("segments_pad_128", 128, 128, 32, False, "seg+pad"),
    ("rect_q64_k256_causal", 64, 256, 64, True, None),
    ("rect_q130_k70_causal", 130, 70, 32, True, None),
    ("odd_77_d128", 77, 77, 128, False, "pad"),
    ("odd_200_d32_causal", 200, 200, 32, True, None),
    ("d128_256", 256, 256, 128, False, None),
    ("d16_96", 96, 96, 16, True, "pad"),
]
B, H = 2, 2


def _inputs(name):
    """bf16 q/k/v (as numpy float32 holding bf16 values, and as torch bf16)
    and the int32 (qseg, kseg) the kernel takes, from a seed per case."""
    _, Tq, Tk, D, causal, kind = next(c for c in CASES if c[0] == name)
    rs = np.random.RandomState(sum(map(ord, name)))
    arrays = [rs.randn(B, H, t, D).astype(np.float32) for t in (Tq, Tk, Tk)]
    tq = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    mask = seg = None
    if kind in ("pad", "seg+pad"):
        mask = (rs.rand(B, Tk) > 0.25).astype(np.float32)
        mask[0, :] = 0.0  # one example with no live key at all
        mask = torch.from_numpy(mask)
    if kind in ("seg", "seg+pad"):
        ids = np.repeat(np.arange(4), -(-Tk // 4))[:Tk]
        seg = torch.from_numpy(np.broadcast_to(ids, (B, Tk)).astype(np.int32).copy())
    qseg, kseg = TA.attention_segments(mask, seg, B, Tq, Tk, "cpu")
    return tq, qseg, kseg, causal, 1.0 / math.sqrt(D), Tk - Tq


def _bound_ratio(out, ref):
    """Largest |out - ref| as a share of phase 2's bf16 bound."""
    diff = (out.float() - ref.float()).abs()
    return (diff / (BF16_ULP_REL * ref.float().abs() + BF16_ATOL)).max().item()


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_split_p_model_within_phase_2_bound_of_plain_version(name):
    (q, k, v), qseg, kseg, causal, scale, q_offset = _inputs(name)
    out, lse = kernel_model(q, k, v, qseg, kseg, causal, scale, q_offset)
    ref, ref_lse = TA.flash_forward_reference(q, k, v, qseg, kseg, causal, scale, q_offset)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    ratio = _bound_ratio(out, ref)
    assert ratio <= 1.0, f"{name}: worst element at {ratio:.3f} of the bf16 bound"
    assert bool(((lse - ref_lse).abs() <= LSE_TOL * ref_lse.abs().clamp(min=1.0)).all())


def test_rounding_p_once_breaks_the_bound():
    """Why the kernel splits P: one bf16 rounding of P misses phase 2's
    bound by far (about 2^-9 |v| ||p||_2 / l where outputs are near 0)."""
    ratios = {}
    for name in ("bert_base", "odd_77_d128", "causal_256"):
        (q, k, v), qseg, kseg, causal, scale, q_offset = _inputs(name)
        once, _ = kernel_model(q, k, v, qseg, kseg, causal, scale, q_offset, split=False)
        ref, _ = TA.flash_forward_reference(q, k, v, qseg, kseg, causal, scale, q_offset)
        ratios[name] = _bound_ratio(once, ref)
    assert all(r > 5.0 for r in ratios.values()), ratios


# block-divisible cases, where the Pallas forward needs no pad shim
JAX_CASES = ["bert_base", "bert_base_pad", "causal_256", "segments_128",
             "segments_pad_128", "rect_q64_k256_causal", "d128_256"]


@pytest.mark.parametrize("name", JAX_CASES)
def test_split_p_model_matches_jax_flash_forward(name):
    """The model against the TPU kernel run in interpret mode on the same
    bf16 inputs (float32 P V there), under the same bound."""
    (q, k, v), qseg, kseg, causal, scale, q_offset = _inputs(name)
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)]
    js = [None if t is None else jnp.asarray(t.numpy()) for t in (qseg, kseg)]
    jo, jl = JA._flash_forward(*j, *js, causal, scale, 64, 64, True, q_offset)
    out, lse = kernel_model(q, k, v, qseg, kseg, causal, scale, q_offset)
    ref = torch.from_numpy(np.asarray(jo.astype(jnp.float32)))
    ratio = _bound_ratio(out, ref)
    assert ratio <= 1.0, f"{name}: worst element at {ratio:.3f} of the bf16 bound"
    jlse = torch.from_numpy(np.asarray(jl)[..., 0])
    assert bool(((lse - jlse).abs() <= LSE_TOL * jlse.abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("ptr, strides, element_size, aligned", [
    (0x7f0000000000, (3 * 12 * 128 * 64, 64, 3 * 12 * 64), 2, True),  # views of fused QKV
    (0x7f0000000080, (12 * 128 * 64, 128 * 64, 64), 2, True),         # contiguous, offset 128 B
    (0x7f0000000002, (12 * 128 * 64, 128 * 64, 64), 2, False),        # pointer off by one element
    (0x7f0000000000, (12 * 77 * 64, 77 * 64, 68), 2, False),          # row stride 136 B
    (0x7f0000000000, (12 * 77 * 64 + 4, 77 * 64, 64), 2, False),      # batch stride off by 8 B
    (0x7f0000000000, (), 2, True),                                   # every axis of size 1
    (0x7f0000000004, (64, 16, 4), 4, False),                         # float32, pointer off by 4 B
])
def test_rows_16_byte_aligned(ptr, strides, element_size, aligned):
    assert TA.rows_16_byte_aligned(ptr, strides, element_size) is aligned


@pytest.mark.cuda
def test_cuda_bf16_kernel_matches_plain_version_and_refuses_misaligned_rows():
    """On the card: the bf16 kernel against the plain version over every
    case above, under phase 2's bound; a tensor whose rows are not 16-byte
    aligned is refused with ValueError, never copied."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; run python3 chip_smoke.py there")
    set_fp32_numerics()
    for name, *_ in CASES:
        (q, k, v), qseg, kseg, causal, scale, q_offset = _inputs(name)
        q, k, v = (t.cuda() for t in (q, k, v))
        qseg, kseg = (None if t is None else t.cuda() for t in (qseg, kseg))
        before = TA.flash_forward.launches
        out, lse = TA.flash_forward(q, k, v, qseg, kseg, causal, scale, q_offset)
        assert TA.flash_forward.launches == before + 1
        ref, ref_lse = TA.flash_forward_reference(q, k, v, qseg, kseg, causal, scale, q_offset)
        assert _bound_ratio(out, ref) <= 1.0, name
        assert bool(((lse - ref_lse).abs() <= LSE_TOL * ref_lse.abs().clamp(min=1.0)).all())
    flat = torch.zeros(2 * 2 * 64 * 64 + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view(2, 2, 64, 64)
    with pytest.raises(ValueError, match="16-byte"):
        TA.flash_forward(shifted, shifted, shifted, None, None, False, 0.125, 0)
