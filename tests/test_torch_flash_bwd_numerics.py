"""Port numerics: the arithmetic of the bf16 flash backward kernels
(``csrc/flash_bwd.cu``, ``flash_bwd_dkv_bf16_kernel`` and
``flash_bwd_dq_bf16_kernel``), modelled in plain torch on the CPU.

The kernels compute S = Q K^T and dP = dO V^T on the tensor cores from bf16
operands (each product exact in float32, the sums in float32), P =
exp2(S scale log2 e - lse log2 e) and dS = P (dP - delta) scale in float32
on the accumulator fragments, and then dV = P^T dO, dK = dS^T Q and dQ = dS
K with P and dS each split into two bf16 terms, X = X_hi + X_lo with X_lo =
bf16(X - X_hi), both multiplied by the bf16 operand into one float32
accumulator; each gradient is rounded to bf16 once. The dq kernel also
computes delta = rowsum(dO * O) (bf16 products, float32 sums) and hands it
to the dkv kernel. ``kernel_model`` repeats those roundings over 64-key
tiles. On the same numpy-seeded inputs it is held to:

- the plain versions (``flash_backward_reference``: float32 P and dS, the
  TPU kernels' arithmetic) under ``chip_smoke.py`` phase 2's bf16 backward
  bound, one bf16 ulp of the value (2^-7 |ref|) + 1e-4, on phase 2's
  masking cases at D = 16, 32, 64 and 128;
- the same model with P and dS rounded to bf16 once, which breaks that
  bound: the reason the kernels split them;
- the JAX package's Pallas backward ``_flash_bwd`` in interpret mode, under
  the same bound.

The kernels themselves are held against the plain versions on the card by
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
BWD_BF16_ATOL = 1e-4      # ... plus 1e-4 near zero (float32 sums of up to 256 terms)
LOG2E = 1.4426950408889634
TILE_K = 64


def _delta_tol(out, do):
    """delta against the plain version: the worst-case float32 error of a
    sum of D products taken in two orders, 2 (D + 1) 2^-24 rowsum|dO O|."""
    D = do.shape[-1]
    return 2 * (D + 1) * 2.0 ** -24 * (do.float() * out.float()).abs().sum(-1)


def _split(x, split):
    hi = x.to(torch.bfloat16).float()
    return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi, torch.zeros_like(x))


def kernel_model(q, k, v, out, do, lse, qseg, kseg, causal, scale, q_offset, split=True):
    """(dq, dk, dv in bf16, delta float32) by the bf16 kernels' arithmetic;
    with ``split=False`` P and dS are rounded to bf16 once instead."""
    Tq, Tk = q.shape[2], k.shape[2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * out.float()).sum(dim=-1)
    dead = lse <= TA.DEAD_ROW_LSE
    neg_lse2 = torch.where(dead, -math.inf, -lse * LOG2E)[..., None]
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    qpos = q_offset + torch.arange(Tq)[:, None]
    for k0 in range(0, Tk, TILE_K):
        k1 = min(Tk, k0 + TILE_K)
        kt, vt = kf[:, :, k0:k1], vf[:, :, k0:k1]
        live = torch.ones((q.shape[0], 1, Tq, k1 - k0), dtype=torch.bool)
        if causal:
            live = live & (qpos >= torch.arange(k0, k1)[None, :])
        if qseg is not None:
            live = live & (qseg[:, :, None] == kseg[:, None, k0:k1])[:, None]
        s = torch.matmul(qf, kt.transpose(-1, -2))
        p = torch.where(live, torch.exp2(s * (scale * LOG2E) + neg_lse2), 0.0)
        ds = p * (torch.matmul(dof, vt.transpose(-1, -2)) - delta[..., None]) * scale
        (ph, pl), (sh, sl) = _split(p, split), _split(ds, split)
        dv[:, :, k0:k1] = (torch.matmul(ph.transpose(-1, -2), dof)
                           + torch.matmul(pl.transpose(-1, -2), dof))
        dk[:, :, k0:k1] = (torch.matmul(sh.transpose(-1, -2), qf)
                           + torch.matmul(sl.transpose(-1, -2), qf))
        dq += torch.matmul(sh, kt) + torch.matmul(sl, kt)
    dv += torch.where(dead[..., None], dof, 0.0).sum(dim=2, keepdim=True) / Tk
    bf = torch.bfloat16
    return dq.to(bf), dk.to(bf), dv.to(bf), delta


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
    """bf16 q/k/v/dO, the int32 (qseg, kseg) the kernels take, and the
    mask arguments, from a seed per case. 'pad' leaves example 0 with no
    live key (every row dead); causal with Tq > Tk has dead leading rows."""
    _, Tq, Tk, D, causal, kind = next(c for c in CASES if c[0] == name)
    rs = np.random.RandomState(100 + sum(map(ord, name)))
    q, k, v, do = (torch.from_numpy(rs.randn(B, H, t, D).astype(np.float32)).to(torch.bfloat16)
                   for t in (Tq, Tk, Tk, Tq))
    mask = seg = None
    if kind in ("pad", "seg+pad"):
        mask = (rs.rand(B, Tk) > 0.25).astype(np.float32)
        mask[0, :] = 0.0
        mask = torch.from_numpy(mask)
    if kind in ("seg", "seg+pad"):
        ids = np.repeat(np.arange(4), -(-Tk // 4))[:Tk]
        seg = torch.from_numpy(np.broadcast_to(ids, (B, Tk)).astype(np.int32).copy())
    qseg, kseg = TA.attention_segments(mask, seg, B, Tq, Tk, "cpu")
    return (q, k, v, do), (qseg, kseg, causal, 1.0 / math.sqrt(D), Tk - Tq)


def _bound_ratio(got, ref):
    """Largest |got - ref| as a share of phase 2's bf16 backward bound."""
    diff = (got.float() - ref.float()).abs()
    return (diff / (BF16_ULP_REL * ref.float().abs() + BWD_BF16_ATOL)).max().item()


def _model_and_plain(name, split=True):
    (q, k, v, do), args = _inputs(name)
    out, lse = TA.flash_forward_reference(q, k, v, *args)
    model = kernel_model(q, k, v, out, do, lse, *args, split=split)
    plain = TA.flash_backward_reference(q, k, v, out, lse, do, *args)
    return model, plain, (out, do)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_split_model_within_phase_2_bound_of_plain_version(name):
    (dq, dk, dv, delta), plain, (out, do) = _model_and_plain(name)
    for gname, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        ratio = _bound_ratio(g, r)
        assert ratio <= 1.0, f"{name}: {gname} worst element at {ratio:.3f} of the bf16 bound"
    ref_delta = TA.flash_backward_delta(out, do)
    assert bool(((delta - ref_delta).abs() <= _delta_tol(out, do)).all())


def test_rounding_p_and_ds_once_breaks_the_bound():
    """Why the kernels split P and dS: one bf16 rounding of each misses
    phase 2's bound by far where gradients are sums that cancel."""
    ratios = {}
    for name in ("bert_base", "odd_77_d128", "causal_256", "d128_256"):
        (dq, dk, dv, _), plain, _ = _model_and_plain(name, split=False)
        ratios[name] = max(_bound_ratio(g, r) for g, r in zip((dq, dk, dv), plain))
    assert all(r > 5.0 for r in ratios.values()), ratios


# block-divisible cases with no dead row, where the Pallas backward needs
# no pad shim and is right (it is wrong on dead rows, see
# test_torch_attention_backward.py)
JAX_CASES = ["bert_base", "causal_256", "segments_128", "rect_q64_k256_causal"]


@pytest.mark.parametrize("name", JAX_CASES)
def test_split_model_matches_jax_flash_backward(name):
    """The model against the TPU kernels run in interpret mode on the same
    bf16 inputs and the same saved (out, lse) (float32 P and dS there),
    under the same bound."""
    (q, k, v, do), (qseg, kseg, causal, scale, q_offset) = _inputs(name)
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v, do)]
    js = [None if t is None else jnp.asarray(t.numpy()) for t in (qseg, kseg)]
    _, res = JA._flash_fwd(*j[:3], *js, causal, scale, 64, 64, True, q_offset)
    jgrads = JA._flash_bwd(causal, scale, 64, 64, True, q_offset, res, j[3])[:3]
    out = torch.from_numpy(np.asarray(res[5].astype(jnp.float32))).to(torch.bfloat16)
    lse = torch.from_numpy(np.asarray(res[6])[..., 0])
    model = kernel_model(q, k, v, out, do, lse, qseg, kseg, causal, scale, q_offset)
    for gname, g, a in zip(("dq", "dk", "dv"), model[:3], jgrads):
        ref = torch.from_numpy(np.asarray(a.astype(jnp.float32)))
        ratio = _bound_ratio(g, ref)
        assert ratio <= 1.0, f"{name}: {gname} worst element at {ratio:.3f} of the bf16 bound"


def test_dq_reference_returns_the_fused_delta():
    """The dq half computes delta = rowsum(dO * O) itself and returns it
    beside dq, for the dkv half, as the dq kernel does on the card."""
    (q, k, v, do), args = _inputs("pad_200_causal")
    out, lse = TA.flash_forward_reference(q, k, v, *args)
    dq, delta = TA.flash_backward_dq_reference(q, k, v, out, do, lse, *args)
    assert delta.dtype == torch.float32 and tuple(delta.shape) == tuple(lse.shape)
    assert torch.equal(delta, TA.flash_backward_delta(out, do))
    dk, dv = TA.flash_backward_dkv_reference(q, k, v, do, lse, delta, *args)
    for g, r in zip((dq, dk, dv), TA.flash_backward_reference(q, k, v, out, lse, do, *args)):
        assert torch.equal(g, r)


def test_flash_backward_runs_dq_first_and_hands_its_delta_to_dkv(monkeypatch):
    """On the card no PyTorch reduction computes delta: ``flash_backward``
    launches the dq kernel, which returns delta, then the dkv kernel with
    it. The launches are stood in for here by the plain halves."""
    (q, k, v, do), args = _inputs("segments_pad_128")
    out, lse = TA.flash_forward_reference(q, k, v, *args)
    dq, delta = TA.flash_backward_dq_reference(q, k, v, out, do, lse, *args)
    dk, dv = TA.flash_backward_dkv_reference(q, k, v, do, lse, delta, *args)
    calls = []

    def dq_kernel(q_, k_, v_, out_, do_, lse_, *args_):
        calls.append("dq")
        assert out_ is out and do_ is do and lse_ is lse and args_ == args
        return dq, delta

    def dkv_kernel(q_, k_, v_, do_, lse_, delta_, *args_):
        calls.append("dkv")
        assert delta_ is delta and do_ is do and args_ == args
        return dk, dv

    def no_delta(*_):
        raise AssertionError("delta must come from the dq kernel")

    monkeypatch.setattr(TA, "flash_backward_dq", dq_kernel)
    monkeypatch.setattr(TA, "flash_backward_dkv", dkv_kernel)
    monkeypatch.setattr(TA, "flash_backward_delta", no_delta)
    got = TA.flash_backward(q, k, v, out, lse, do, *args)
    assert calls == ["dq", "dkv"]
    assert all(g is r for g, r in zip(got, (dq, dk, dv)))


@pytest.mark.cuda
def test_cuda_bf16_backward_kernels_match_plain_version_and_refuse_misaligned_rows():
    """On the card: both bf16 kernels and the fused delta against the plain
    versions over every case above, under phase 2's bounds; a tensor whose
    rows are not 16-byte aligned is refused with ValueError, never copied."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; run python3 chip_smoke.py there")
    set_fp32_numerics()
    for name, *_ in CASES:
        (q, k, v, do), (qseg, kseg, *rest) = _inputs(name)
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
            assert _bound_ratio(g, r) <= 1.0, name
        assert bool(((delta - rdelta).abs() <= _delta_tol(out, do)).all()), name
    flat = torch.zeros(2 * 2 * 64 * 64 + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view(2, 2, 64, 64)
    lse = torch.zeros((2, 2, 64), dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        TA.flash_backward_dq(shifted, shifted, shifted, shifted, shifted, lse, None, None,
                             False, 0.125, 0)
    with pytest.raises(ValueError, match="16-byte"):
        TA.flash_backward_dkv(shifted, shifted, shifted, shifted, lse, lse, None, None,
                              False, 0.125, 0)
