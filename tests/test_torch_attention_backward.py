"""Port parity: the flash-attention backward of ``deeplearning4j_tpu_torch.
kernels.attention`` against the JAX package.

On the CPU the port's backward is its plain version
(``flash_backward_reference``, and ``FlashAttentionFunction`` through
``flash_attention``); the CUDA kernels are held against that version on the
card (``chip_smoke.py`` and the ``cuda``-marked test below). The JAX side
runs its Pallas backward (``_flash_fwd`` + ``_flash_bwd``) in interpret mode
and its dense oracle ``_flash_bwd_dense``, as ``tests/test_kernels.py``
does, on the same numpy-seeded inputs and the same saved (out, lse).

Tolerances: float32 atol 3e-5 against JAX flash and its dense oracle (the
JAX package's own tolerance for that comparison: same algorithm, sums in
another order); 2e-4 against ``jax.grad`` of ``mha_reference`` (the JAX
package's own tolerance for flash-vs-dense gradients). bf16 inputs: one
bf16 ulp of the value plus 1e-5 (both sides compute in float32 from the
same bf16 inputs and round once; a reordered sum can flip that rounding).

Rows with no live key: the JAX flash backward is wrong there (it
recomputes P = exp(-1e30 - (-1e30)) = 1 for every key and never masks dS;
its pad shim hides that only where it zeroes dO). On the inputs of
``test_dead_rows_follow_the_dense_reference`` its largest error against
``jax.grad(mha_reference)`` is 51.6 / 53.2 / 37.7 on dq / dk / dv for
q/k/v [1,2,128,32] with an all-zero key mask, and 0.29 on dv for causal
Tq=128, Tk=64 (0.30 for Tq=130, Tk=70), where the port's is below 1e-6.
The port follows ``mha_reference``; that test pins both facts.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import attention as JA
from deeplearning4j_tpu_torch import set_fp32_numerics
from deeplearning4j_tpu_torch.kernels import attention as TA
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

ATOL = 3e-5
DENSE_GRAD_TOL = 2e-4
BF16_ULP_REL = 2.0 ** -7
BF16_ATOL = 1e-5

# name -> (B, H, Tq, Tk, D, causal, masking, JAX block)
CASES = {
    "plain_d32": (2, 2, 128, 128, 32, False, None, 64),
    "causal_d64": (2, 2, 128, 128, 64, True, None, 64),
    "key_padding_d16": (2, 2, 128, 128, 16, False, "pad", 64),
    "key_padding_causal_d128": (1, 2, 128, 128, 128, True, "pad", 64),
    "segments": (2, 2, 128, 128, 32, False, "seg", 64),
    "segments_and_padding": (2, 2, 128, 128, 32, False, "seg+pad", 64),
    "rect_q64_k256_causal": (1, 2, 64, 256, 32, True, None, 64),
    "odd_77_padded": (2, 2, 77, 77, 32, False, "pad", 77),
    "odd_200_causal": (1, 2, 200, 200, 64, True, None, 40),
}


def _inputs(name, dtype=np.float32, seed=0):
    """q, k, v, dO as numpy arrays and (qseg, kseg) int32 (or None) as the
    port's ``attention_segments`` makes them. Key padding keeps key 0 live,
    so no row is left without a live key."""
    B, H, Tq, Tk, D, causal, kind, _ = CASES[name]
    rs = np.random.RandomState(seed + sum(map(ord, name)))
    q, k, v = (rs.randn(B, H, t, D).astype(np.float32) for t in (Tq, Tk, Tk))
    do = rs.randn(B, H, Tq, D).astype(np.float32)
    mask = seg = None
    if kind in ("pad", "seg+pad"):
        m = (rs.rand(B, Tk) > 0.3).astype(np.float32)
        m[:, 0] = 1.0
        if kind == "seg+pad":
            m[:] = 1.0
            m[:, 120:] = 0.0
        mask = torch.from_numpy(m)
    if kind in ("seg", "seg+pad"):
        seg = torch.from_numpy(np.repeat(np.arange(4), Tk // 4)[None].repeat(B, 0)
                               .astype(np.int32))
    qseg, kseg = TA.attention_segments(mask, seg, B, Tq, Tk, "cpu")
    cast = (lambda a: a) if dtype == np.float32 else (lambda a: jnp.asarray(a, jnp.bfloat16))
    return [cast(a) for a in (q, k, v, do)], qseg, kseg, causal


def _jax_backward(q, k, v, do, qseg, kseg, causal, block):
    """JAX's Pallas forward and backward (interpret mode), and its dense
    oracle on the same residuals."""
    D, Tq, Tk = q.shape[-1], q.shape[2], k.shape[2]
    seg = [None if s is None else jnp.asarray(s.numpy()) for s in (qseg, kseg)]
    out, res = JA._flash_fwd(*map(jnp.asarray, (q, k, v)), *seg, causal, 1 / math.sqrt(D),
                             block, block, True, Tk - Tq)
    dq, dk, dv, _, _ = JA._flash_bwd(causal, 1 / math.sqrt(D), block, block, True, Tk - Tq,
                                     res, jnp.asarray(do))
    dense = JA._flash_bwd_dense(causal, 1 / math.sqrt(D), res, jnp.asarray(do))
    return res, (dq, dk, dv), dense


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_flash_and_dense_oracle(name):
    (q, k, v, do), qseg, kseg, causal = _inputs(name)
    res, jax_flash, jax_dense = _jax_backward(q, k, v, do, qseg, kseg, causal, CASES[name][7])
    _, _, _, _, _, out, lse = res
    D, Tq, Tk = q.shape[-1], q.shape[2], k.shape[2]
    got = TA.flash_backward_reference(*map(_t, (q, k, v, out)), _t(lse)[..., 0], _t(do),
                                      qseg, kseg, causal, 1 / math.sqrt(D), Tk - Tq)
    for g, a, b in zip(got, jax_flash, jax_dense):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(a), atol=ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("name", ["causal_d64", "segments_and_padding", "odd_77_padded"])
def test_plain_backward_bf16_matches_jax_flash(name):
    """The same bf16 inputs and residuals on both sides; grads come back in
    bf16, within one bf16 ulp of JAX's."""
    (q, k, v, do), qseg, kseg, causal = _inputs(name, dtype="bfloat16")
    res, jax_flash, _ = _jax_backward(q, k, v, do, qseg, kseg, causal, CASES[name][7])
    _, _, _, _, _, out, lse = res
    D, Tq, Tk = q.shape[-1], q.shape[2], k.shape[2]
    got = TA.flash_backward_reference(*map(_t, (q, k, v, out)), _t(lse)[..., 0], _t(do),
                                      qseg, kseg, causal, 1 / math.sqrt(D), Tk - Tq)
    for g, a in zip(got, jax_flash):
        assert g.dtype == torch.bfloat16
        ref = _f32(a)
        assert np.all(np.abs(_f32(g) - ref) <= BF16_ULP_REL * np.abs(ref) + BF16_ATOL)


def _dense_grads(q, k, v, do, mask, causal):
    """jax.grad of the JAX ``mha_reference`` (as a vjp with dO)."""
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: JA.mha_reference(a, b, c, jm, causal=causal),
                     *map(jnp.asarray, (q, k, v)))
    return vjp(jnp.asarray(do))


def _port_grads(q, k, v, do, mask, causal, segment_ids=None):
    """torch.autograd.grad through the port's ``flash_attention`` (CPU:
    FlashAttentionFunction over the plain versions)."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = TA.flash_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask),
                             causal=causal, segment_ids=segment_ids)
    return torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))


@pytest.mark.parametrize("name", ["plain_d32", "causal_d64", "key_padding_d16",
                                  "rect_q64_k256_causal", "odd_200_causal"])
def test_autograd_through_flash_attention_matches_jax_dense_grad(name):
    B, H, Tq, Tk, D, causal, kind, _ = CASES[name]
    rs = np.random.RandomState(7)
    q, k, v = (rs.randn(B, H, t, D).astype(np.float32) for t in (Tq, Tk, Tk))
    do = rs.randn(B, H, Tq, D).astype(np.float32)
    mask = None
    if kind == "pad":
        mask = (rs.rand(B, Tk) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
    for g, r in zip(_port_grads(q, k, v, do, mask, causal),
                    _dense_grads(q, k, v, do, mask, causal)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=DENSE_GRAD_TOL,
                                   rtol=DENSE_GRAD_TOL)


def _dead_case(kind):
    rs = np.random.RandomState(11)
    if kind == "all_keys_masked":  # every row of the one example is dead
        q, k, v = (rs.randn(1, 2, 128, 32).astype(np.float32) for _ in range(3))
        return q, k, v, rs.randn(1, 2, 128, 32).astype(np.float32), \
            np.zeros((1, 128), np.float32), False
    if kind == "fully_padded_example":  # example 0 dead, example 1 live
        q, k, v = (rs.randn(2, 2, 128, 32).astype(np.float32) for _ in range(3))
        mask = (rs.rand(2, 128) > 0.3).astype(np.float32)
        mask[0] = 0.0
        return q, k, v, rs.randn(2, 2, 128, 32).astype(np.float32), mask, False
    Tq, Tk = (128, 64) if kind == "causal_q128_k64" else (130, 70)
    q = rs.randn(1, 2, Tq, 32).astype(np.float32)
    k, v = (rs.randn(1, 2, Tk, 32).astype(np.float32) for _ in range(2))
    return q, k, v, rs.randn(1, 2, Tq, 32).astype(np.float32), None, True


@pytest.mark.parametrize("kind", ["all_keys_masked", "fully_padded_example",
                                  "causal_q128_k64", "causal_q130_k70"])
def test_dead_rows_follow_the_dense_reference(kind):
    """Rows with no live key: the port's gradients equal jax.grad of
    mha_reference (dq = 0, no dk, dv += dO / Tk), where JAX's Pallas
    backward, fed the same residuals without its pad shim, is off (see the
    module docstring for its errors)."""
    q, k, v, do, mask, causal = _dead_case(kind)
    ref = _dense_grads(q, k, v, do, mask, causal)
    for g, r in zip(_port_grads(q, k, v, do, mask, causal), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=DENSE_GRAD_TOL,
                                   rtol=DENSE_GRAD_TOL)
    B, Tq, Tk = q.shape[0], q.shape[2], k.shape[2]
    qseg, kseg = TA.attention_segments(None if mask is None else torch.from_numpy(mask),
                                       None, B, Tq, Tk, "cpu")
    block = 64 if Tq % 64 == 0 and Tk % 64 == 0 else math.gcd(Tq, Tk)
    _, jax_flash, _ = _jax_backward(q, k, v, do, qseg, kseg, causal, block)
    jax_err = max(float(np.abs(np.asarray(a) - np.asarray(r)).max())
                  for a, r in zip(jax_flash, ref))
    assert jax_err > 0.1


def test_dead_row_rule_in_both_halves_of_the_plain_backward():
    """The two plain halves, as the two kernels split the work: dq of a
    dead row is 0, and its dO / Tk lands on every key's dv."""
    rs = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rs.randn(1, 1, 8, 16).astype(np.float32)) for _ in range(3))
    do = torch.from_numpy(rs.randn(1, 1, 8, 16).astype(np.float32))
    qseg = torch.zeros((1, 8), dtype=torch.int32)
    kseg = torch.full((1, 8), -1, dtype=torch.int32)  # every key padded
    out, lse = TA.flash_forward_reference(q, k, v, qseg, kseg, False, 0.25, 0)
    assert bool((lse <= TA.DEAD_ROW_LSE).all())
    rest = (qseg, kseg, False, 0.25, 0)
    dq, delta = TA.flash_backward_dq_reference(q, k, v, out, do, lse, *rest)
    dk, dv = TA.flash_backward_dkv_reference(q, k, v, do, lse, delta, *rest)
    assert not dq.any() and not dk.any()
    np.testing.assert_allclose(dv.numpy(), np.broadcast_to(
        do.numpy().sum(axis=2, keepdims=True) / 8, dv.shape), atol=1e-6)


def test_flash_attention_grads_match_the_ports_dense_path():
    """Segment ids and key padding together, against autograd through the
    port's own ``mha_reference`` with the equivalent dense mask."""
    rs = np.random.RandomState(13)
    q, k, v = (rs.randn(2, 2, 96, 16).astype(np.float32) for _ in range(3))
    do = rs.randn(2, 2, 96, 16).astype(np.float32)
    segs = np.where(np.arange(96) < 50, 0, 1)[None].repeat(2, 0).astype(np.int32)
    mask = np.ones((2, 96), np.float32)
    mask[1, 90:] = 0.0
    got = _port_grads(q, k, v, do, mask, False, segment_ids=torch.from_numpy(segs))
    dense = ((segs[:, :, None] == segs[:, None, :]) & (mask[:, None, :] > 0))[:, None]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = TA.mha_reference(tq, tk, tv, torch.from_numpy(dense))
    ref = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=DENSE_GRAD_TOL)


def test_lse_carries_no_gradient_and_kernel_wrappers_refuse_cpu():
    rs = np.random.RandomState(14)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 16, 16).astype(np.float32)).requires_grad_()
               for _ in range(3))
    out, lse = TA.flash_attention(q, k, v, return_lse=True)
    assert out.requires_grad and not lse.requires_grad
    d = torch.zeros((1, 2, 16), dtype=torch.float32)
    q, k, v = q.detach(), k.detach(), v.detach()
    with pytest.raises(ValueError, match="CUDA"):
        TA.flash_backward_dkv(q, k, v, q, d, d, None, None, False, 0.25, 0)
    with pytest.raises(ValueError, match="CUDA"):
        TA.flash_backward_dq(q, k, v, q, q, d, None, None, False, 0.25, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_kernels_match_plain_version(dtype):
    """On the card: both backward kernels against the plain version on the
    same inputs (strided q/k/v and transposed dO as ``_block`` gives them,
    key padding with a fully padded example, a causal rectangle with dead
    rows). float32: 1e-4 + 1e-4 relative; bfloat16: one bf16 ulp + 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; run python3 chip_smoke.py there")
    set_fp32_numerics()
    dt = getattr(torch, dtype)
    rs = np.random.RandomState(15)
    qkv = torch.from_numpy(rs.randn(2, 77, 3 * 4 * 64).astype(np.float32)).cuda().to(dt)
    q, k, v = (t.reshape(2, 77, 4, 64).transpose(1, 2) for t in qkv.split(256, -1))
    do = torch.from_numpy(rs.randn(2, 77, 4, 64).astype(np.float32)).cuda().to(dt).transpose(1, 2)
    mask = torch.from_numpy((rs.rand(2, 77) > 0.3).astype(np.float32)).cuda()
    mask[0] = 0
    rect = [torch.from_numpy(rs.randn(1, 2, t, 32).astype(np.float32)).cuda().to(dt)
            for t in (130, 70, 70, 130)]
    for (q_, k_, v_, do_), mask_, causal in (((q, k, v, do), mask, False),
                                             (tuple(rect), None, True)):
        B, Tq, Tk = q_.shape[0], q_.shape[2], k_.shape[2]
        qseg, kseg = TA.attention_segments(mask_, None, B, Tq, Tk, q_.device)
        scale = 1 / math.sqrt(q_.shape[-1])
        out, lse = TA.flash_forward(q_, k_, v_, qseg, kseg, causal, scale, Tk - Tq)
        before = (TA.flash_backward_dkv.launches, TA.flash_backward_dq.launches)
        got = TA.flash_backward(q_, k_, v_, out, lse, do_, qseg, kseg, causal, scale, Tk - Tq)
        assert (TA.flash_backward_dkv.launches, TA.flash_backward_dq.launches) == \
            (before[0] + 1, before[1] + 1)
        ref = TA.flash_backward_reference(q_, k_, v_, out, lse, do_, qseg, kseg, causal,
                                          scale, Tk - Tq)
        for g, r in zip(got, ref):
            diff = (g.float() - r.float()).abs()
            tol = (1e-4 + 1e-4 * r.float().abs() if dt == torch.float32
                   else BF16_ULP_REL * r.float().abs() + 1e-4)
            assert bool((diff <= tol).all()) and bool(torch.isfinite(g).all())
