"""Port numerics: the arithmetic of the float32 flash forward kernel
(``csrc/flash_fwd.cu``, ``flash_fwd_f32_kernel``), modelled in plain torch
on the CPU.

The kernel multiplies on the TF32 tensor cores. Every operand x of Q K^T
and of P V is split x = hi + lo with hi = tf32(x) (round to nearest, ties
away from zero, to 10 mantissa bits) and lo = x - hi, which the tensor core
truncates to 10 mantissa bits; three products lo*hi + hi*lo + hi*hi go into
float32 accumulators (3xTF32).
The online softmax runs in float32 with exp(x) taken as exp2(x log2 e).
A block's four warps split every 64-key tile into ``splits`` key groups
(4 for a 16-row q-tile, 2 for a 32-row one): each group keeps its own
(m, l, acc) over its keys of every tile, and the epilogue combines the
groups' parts of a row, m = max m_s, l = sum l_s e_s, acc = sum acc_s e_s
with e_s = exp(m_s - m), then out = acc / l. ``kernel_model`` repeats that
arithmetic, TF32 rounding by mantissa masking. On numpy-seeded float32
inputs over ``chip_smoke.py`` phase 2's cases it is held to:

- ``flash_forward_reference`` (float32 products, the TPU kernel's
  arithmetic) within phase 2's float32 bound, ``FP32_ATOL = 2e-5``, and lse
  to 1e-5 relative, for every key split;
- the same model with one TF32 product (hi*hi alone), which breaks that
  bound: the reason the kernel splits its operands;
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

FP32_ATOL = 2e-5  # chip_smoke.py phase 2: float32 output, kernel vs plain
LSE_TOL = 1e-5    # relative, float32 lse
LOG2E = 1.4426950408889634
NEG_INF = -1e30
TILE_K = 64


def tf32(x):
    """x rounded to TF32 as the kernel's ``split_tf32`` does: add half of
    the 13 dropped mantissa bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate_tf32(x):
    """x as the tensor core reads a float32 register: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    """(hi, lo) as the products see them: hi rounded, lo = x - hi
    truncated."""
    hi = tf32(x)
    return hi, truncate_tf32(x - hi)


def product(a, b, terms):
    """a @ b as the kernel computes it: 3xTF32, or one TF32 product."""
    ah, al = split(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def kernel_model(q, k, v, qseg, kseg, causal, scale, q_offset, splits=4, terms=3):
    """(out, lse) float32 by the float32 kernel's arithmetic, with every
    64-key tile split into ``splits`` key groups."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    kw = TILE_K // splits
    parts = []
    for sp in range(splits):
        m = torch.full((B, H, Tq, 1), NEG_INF)
        l = torch.zeros((B, H, Tq, 1))
        acc = torch.zeros((B, H, Tq, D))
        for k0 in range(sp * kw, Tk, TILE_K):
            kt, vt = k[:, :, k0:k0 + kw], v[:, :, k0:k0 + kw]
            s = product(q, kt.transpose(-1, -2), terms) * scale
            if causal:
                qpos = q_offset + torch.arange(Tq)[:, None]
                s = torch.where(qpos >= k0 + torch.arange(kt.shape[2])[None, :], s, NEG_INF)
            if qseg is not None:
                same = qseg[:, :, None] == kseg[:, None, k0:k0 + kt.shape[2]]
                s = torch.where(same[:, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = torch.exp2((m - m_new) * LOG2E)
            p = torch.exp2((s - m_new) * LOG2E)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + product(p, vt, terms)
            m = m_new
        parts.append((m, l, acc))
    m = torch.stack([pm for pm, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Tq, D))
    for pm, pl, pacc in parts:
        e = torch.exp2((pm - m) * LOG2E)
        l = l + pl * e
        acc = acc + pacc * e
    dead = m == NEG_INF  # no live key: the mean of v over the Tk keys
    out = torch.where(dead, v.sum(dim=2, keepdim=True) / Tk, acc / l)
    lse = m + torch.log(torch.where(dead, torch.full_like(l, float(Tk)), l))
    return out, lse[..., 0]


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
    """float32 q/k/v and the int32 (qseg, kseg) the kernel takes, from a
    seed per case."""
    _, Tq, Tk, D, causal, kind = next(c for c in CASES if c[0] == name)
    rs = np.random.RandomState(sum(map(ord, name)) + 1)
    q, k, v = (torch.from_numpy(rs.randn(B, H, t, D).astype(np.float32)) for t in (Tq, Tk, Tk))
    mask = seg = None
    if kind in ("pad", "seg+pad"):
        mask = (rs.rand(B, Tk) > 0.25).astype(np.float32)
        mask[0, :] = 0.0  # one example with no live key at all
        mask = torch.from_numpy(mask)
    if kind in ("seg", "seg+pad"):
        ids = np.repeat(np.arange(4), -(-Tk // 4))[:Tk]
        seg = torch.from_numpy(np.broadcast_to(ids, (B, Tk)).astype(np.int32).copy())
    qseg, kseg = TA.attention_segments(mask, seg, B, Tq, Tk, "cpu")
    return (q, k, v), qseg, kseg, causal, 1.0 / math.sqrt(D), Tk - Tq


def _bound_ratio(out, ref):
    """Largest |out - ref| as a share of phase 2's float32 bound."""
    return ((out - ref).abs().max() / FP32_ATOL).item()


def _lse_ok(lse, ref_lse):
    return bool(((lse - ref_lse).abs() <= LSE_TOL * ref_lse.abs().clamp(min=1.0)).all())


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -12,
                      1.0 + 2.0 ** -12, 3.0e-3], dtype=torch.float32)
    want = [1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -10, 1.0]
    assert tf32(x)[:5].tolist() == want
    assert truncate_tf32(x)[:5].tolist() == [1.0, 1.0, -1.0, 1.0, 1.0]
    hi, lo = split(x)
    assert bool(((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all())
    assert bool((tf32(hi) == hi).all()) and bool((truncate_tf32(lo) == lo).all())


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_split_tf32_model_within_phase_2_bound_of_plain_version(name, splits):
    (q, k, v), qseg, kseg, causal, scale, q_offset = _inputs(name)
    out, lse = kernel_model(q, k, v, qseg, kseg, causal, scale, q_offset, splits)
    ref, ref_lse = TA.flash_forward_reference(q, k, v, qseg, kseg, causal, scale, q_offset)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    ratio = _bound_ratio(out, ref)
    assert ratio <= 1.0, f"{name}: worst element at {ratio:.3f} of the float32 bound"
    assert _lse_ok(lse, ref_lse)


def test_one_tf32_product_breaks_the_bound():
    """Why the kernel splits its operands: one TF32 product (10 mantissa
    bits) misses phase 2's 2e-5 by far, on every head dim."""
    ratios = {}
    for name in ("bert_base", "segments_128", "odd_77_d128", "d16_96", "causal_256"):
        (q, k, v), qseg, kseg, causal, scale, q_offset = _inputs(name)
        once, _ = kernel_model(q, k, v, qseg, kseg, causal, scale, q_offset, terms=1)
        ref, _ = TA.flash_forward_reference(q, k, v, qseg, kseg, causal, scale, q_offset)
        ratios[name] = _bound_ratio(once, ref)
    assert all(r > 5.0 for r in ratios.values()), ratios


# block-divisible cases, where the Pallas forward needs no pad shim
JAX_CASES = ["bert_base", "bert_base_pad", "causal_256", "segments_128",
             "segments_pad_128", "rect_q64_k256_causal", "d128_256"]


@pytest.mark.parametrize("name", JAX_CASES)
def test_split_tf32_model_matches_jax_flash_forward(name):
    """The model (16-row q-tiles, four key groups: generation's prefill)
    against the TPU kernel run in interpret mode on the same float32
    inputs, under the same bound."""
    (q, k, v), qseg, kseg, causal, scale, q_offset = _inputs(name)
    js = [None if t is None else jnp.asarray(t.numpy()) for t in (qseg, kseg)]
    jo, jl = JA._flash_forward(*(jnp.asarray(t.numpy()) for t in (q, k, v)), *js, causal,
                               scale, 64, 64, True, q_offset)
    out, lse = kernel_model(q, k, v, qseg, kseg, causal, scale, q_offset, splits=4)
    ratio = _bound_ratio(out, torch.from_numpy(np.asarray(jo)))
    assert ratio <= 1.0, f"{name}: worst element at {ratio:.3f} of the float32 bound"
    assert _lse_ok(lse, torch.from_numpy(np.asarray(jl)[..., 0]))


@pytest.mark.cuda
def test_cuda_f32_kernel_matches_plain_version_and_refuses_misaligned_rows():
    """On the card: the float32 kernel against the plain version over every
    case above, at B=2 (16-row q-tiles) and at B=32 H=12 T=128 (32-row
    q-tiles: 1536 blocks), under phase 2's bound; a
    float32 tensor whose rows are not 16-byte aligned is refused with
    ValueError, never copied."""
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
        assert _lse_ok(lse, ref_lse), name
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rs.randn(32, 12, 128, 64).astype(np.float32)).cuda()
               for _ in range(3))
    out, lse = TA.flash_forward(q, k, v, None, None, False, 0.125, 0)
    ref, ref_lse = TA.flash_forward_reference(q, k, v, None, None, False, 0.125, 0)
    assert _bound_ratio(out, ref) <= 1.0 and _lse_ok(lse, ref_lse)
    flat = torch.zeros(2 * 2 * 64 * 64 + 1, dtype=torch.float32, device="cuda")
    shifted = flat[1:].view(2, 2, 64, 64)
    with pytest.raises(ValueError, match="16-byte"):
        TA.flash_forward(shifted, shifted, shifted, None, None, False, 0.125, 0)
