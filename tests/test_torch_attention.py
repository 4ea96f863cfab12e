"""Port parity: ``deeplearning4j_tpu_torch.kernels.attention`` against the
JAX package's ``kernels.attention``.

The same inputs, made with numpy from a seed, go through both packages. On
the CPU the port's ``flash_attention`` takes its plain version
(``flash_forward_reference``); the JAX flash runs its Pallas kernel in
interpret mode, as the JAX package's own tests run it. The CUDA kernel
itself is held against the plain version on the card (``chip_smoke.py``,
and the ``cuda``-marked test below).

Tolerance: float32 throughout, atol 2e-5 (the JAX package's own flash
parity tolerance): the algorithms agree and only the order of the sums
differs.
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

ATOL = 2e-5


def _qkv(seed, B, H, Tq, Tk, D):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, H, t, D).astype(np.float32) for t in (Tq, Tk, Tk)]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


def _key_mask(seed, B, T, p_drop=0.3):
    return (np.random.RandomState(seed).rand(B, T) > p_drop).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", [None, "key", "broadcast", "full"])
def test_mha_reference_matches_jax(causal, mask_kind):
    q, k, v = _qkv(0, 2, 3, 48, 48, 16)
    mask = None
    if mask_kind == "key":
        mask = _key_mask(1, 2, 48)
    elif mask_kind == "broadcast":
        mask = _key_mask(1, 2, 48)[:, None, None, :]
    elif mask_kind == "full":
        mask = (np.random.RandomState(2).rand(2, 1, 48, 48) > 0.4).astype(np.float32)
    ref = JA.mha_reference(*_jax(q, k, v, mask), causal=causal)
    out = TA.mha_reference(*_torch(q, k, v, mask), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def _flash_case(name):
    """(q, k, v, mask, segment_ids, causal) for the cases of
    tests/test_kernels.py, at a small size."""
    if name == "plain":
        return (*_qkv(3, 2, 2, 128, 128, 32), None, None, False)
    if name == "causal":
        return (*_qkv(4, 2, 2, 128, 128, 32), None, None, True)
    if name in ("key_padding", "key_padding_causal"):
        return (*_qkv(5, 2, 2, 128, 128, 32), _key_mask(6, 2, 128), None,
                name.endswith("causal"))
    if name == "fully_masked_example":
        mask = np.ones((2, 128), np.float32)
        mask[0] = 0.0
        return (*_qkv(7, 2, 2, 128, 128, 32), mask, None, False)
    if name == "all_keys_masked":
        return (*_qkv(8, 1, 2, 64, 64, 16), np.zeros((1, 64), np.float32), None, False)
    if name == "odd_200_dead_example":  # the JAX pad shim pads 200 -> 256
        mask = np.ones((2, 200), np.float32)
        mask[0] = 0.0
        return (*_qkv(9, 2, 2, 200, 200, 32), mask, None, False)
    if name in ("odd_100", "odd_130"):
        T = int(name.split("_")[1])
        return (*_qkv(T, 2, 2, T, T, 32), None, None, False)
    if name in ("odd_100_masked", "odd_130_masked_causal"):
        T = int(name.split("_")[1])
        return (*_qkv(T + 1, 2, 2, T, T, 32), _key_mask(T, 2, T, 0.2), None,
                name.endswith("causal"))
    if name == "rect_q64_k256_causal":  # decode with a prefix: q_offset 192
        return (*_qkv(10, 1, 2, 64, 256, 32), None, None, True)
    if name == "rect_q130_k70_causal":  # Tq > Tk: leading rows have no key
        return (*_qkv(11, 1, 2, 130, 70, 32), None, None, True)
    if name == "segments":
        segs = np.repeat(np.arange(4), 32)[None].repeat(2, 0).astype(np.int32)
        return (*_qkv(12, 2, 2, 128, 128, 32), None, segs, False)
    if name == "segments_and_padding":
        segs = np.repeat(np.arange(4), 32)[None].repeat(2, 0).astype(np.int32)
        mask = np.ones((2, 128), np.float32)
        mask[:, 120:] = 0.0
        return (*_qkv(13, 2, 2, 128, 128, 32), mask, segs, False)
    raise KeyError(name)


FLASH_CASES = ["plain", "causal", "key_padding", "key_padding_causal",
               "fully_masked_example", "all_keys_masked", "odd_200_dead_example",
               "odd_100", "odd_130", "odd_100_masked", "odd_130_masked_causal",
               "rect_q64_k256_causal", "rect_q130_k70_causal", "segments",
               "segments_and_padding"]


@pytest.mark.parametrize("name", FLASH_CASES)
def test_flash_attention_matches_jax_flash_and_reference(name):
    q, k, v, mask, segs, causal = _flash_case(name)
    jq, jk, jv, jm = _jax(q, k, v, mask)
    ref = JA.flash_attention(jq, jk, jv, jm, segment_ids=None if segs is None else
                             jnp.asarray(segs), causal=causal, block_q=64,
                             block_k=64, interpret=True)
    out = TA.flash_attention(*_torch(q, k, v, mask), causal=causal,
                             segment_ids=None if segs is None else torch.from_numpy(segs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert np.isfinite(out.numpy()).all()
    if segs is None:  # and the dense reference of both packages
        dense = JA.mha_reference(jq, jk, jv, jm, causal=causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(dense), atol=ATOL)


def test_segments_padding_and_dead_rows_differ_only_where_documented():
    """The one known difference from JAX flash: a row with segment ids,
    key padding and ZERO live keys. The JAX pad shim gives it a uniform
    softmax over the PADDED keys (its own docstring calls those values
    meaningless); the port gives the uniform softmax over the original
    keys, as the dense reference does for any dead row. Those rows are
    skipped in the JAX comparison and held to the dense reference instead."""
    q, k, v = _qkv(14, 2, 2, 100, 100, 16)
    segs = np.where(np.arange(100) < 60, 0, 1)[None].repeat(2, 0).astype(np.int32)
    mask = np.ones((2, 100), np.float32)
    mask[0, 60:] = 0.0  # example 0: every key of segment 1 is padded
    ref = np.asarray(JA.flash_attention(*_jax(q, k, v, mask), segment_ids=jnp.asarray(segs),
                                        block_q=64, block_k=64, interpret=True))
    out = TA.flash_attention(*_torch(q, k, v, mask),
                             segment_ids=torch.from_numpy(segs)).numpy()
    dead = np.zeros((2, 100), bool)
    dead[0, 60:] = True
    np.testing.assert_allclose(out[:, :, ~dead[0]][0], ref[:, :, ~dead[0]][0], atol=ATOL)
    np.testing.assert_allclose(out[1], ref[1], atol=ATOL)
    dense_mask = ((segs[:, :, None] == segs[:, None, :]) & (mask[:, None, :] > 0))[:, None]
    dense = np.asarray(JA.mha_reference(*_jax(q, k, v, dense_mask.astype(np.float32))))
    np.testing.assert_allclose(out, dense, atol=ATOL)
    np.testing.assert_allclose(out[0, :, 60:], np.broadcast_to(
        v[0].mean(axis=1, keepdims=True), out[0, :, 60:].shape), atol=ATOL)


@pytest.mark.parametrize("case", ["plain", "causal", "key_padding", "segments",
                                  "rect_q64_k256_causal", "fully_masked_example"])
def test_flash_lse_matches_jax_forward_kernel(case):
    """out and lse against the Pallas forward ``_flash_forward`` (interpret
    mode, multi-block), at block-divisible lengths where it needs no shim."""
    q, k, v, mask, segs, causal = _flash_case(case)
    B, Tq, Tk, D = q.shape[0], q.shape[2], k.shape[2], q.shape[3]
    qseg, kseg = TA.attention_segments(None if mask is None else torch.from_numpy(mask),
                                       None if segs is None else torch.from_numpy(segs),
                                       B, Tq, Tk, "cpu")
    jo, jl = JA._flash_forward(*_jax(q, k, v), *_jax(None if qseg is None else qseg.numpy(),
                                                     None if kseg is None else kseg.numpy()),
                               causal, 1.0 / math.sqrt(D), 64, 64, True, Tk - Tq)
    out, lse = TA.flash_attention(*_torch(q, k, v, mask), causal=causal, return_lse=True,
                                  segment_ids=None if segs is None else torch.from_numpy(segs))
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[..., 0], rtol=1e-6, atol=ATOL)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, q.shape[1], Tq)


def test_flash_reference_matches_jax_with_explicit_segment_ids():
    """The plain version takes (qseg, kseg) as the kernel does, -1 on
    padded keys included; same function as the Pallas forward."""
    q, k, v = _qkv(15, 2, 2, 128, 128, 16)
    rs = np.random.RandomState(16)
    qseg = np.zeros((2, 128), np.int32)
    kseg = np.where(rs.rand(2, 128) > 0.3, 0, -1).astype(np.int32)
    for causal in (False, True):
        jo, jl = JA._flash_forward(*_jax(q, k, v, qseg, kseg), causal, 0.25, 64, 64,
                                   True, 0)
        out, lse = TA.flash_forward_reference(*_torch(q, k, v, qseg, kseg), causal, 0.25, 0)
        np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=ATOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[..., 0], rtol=1e-6, atol=ATOL)


def test_negative_segment_ids_raise():
    """Deliberate difference from the JAX package: there, user ids of -1/-2
    collide with its pad-shim sentinels (kernels/attention.py:459-502) and
    silently change the mask; the port rejects negative ids."""
    q, k, v = _torch(*_qkv(17, 1, 1, 8, 8, 16))
    segs = torch.tensor([[0, 0, 1, 1, -1, -1, 2, 2]], dtype=torch.int32)
    with pytest.raises(ValueError, match=">= 0"):
        TA.flash_attention(q, k, v, segment_ids=segs)
    with pytest.raises(ValueError, match=">= 0"):
        TA.flash_attention(q, k, v, segment_ids=(torch.zeros((1, 8), dtype=torch.int32), segs))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", [None, "key", "full"])
def test_dot_product_attention_auto_on_cpu_matches_jax(causal, mask_kind):
    """Off the accelerator both front doors take the dense path."""
    q, k, v = _qkv(18, 2, 2, 40, 40, 16)
    mask = {None: None, "key": _key_mask(19, 2, 40),
            "full": (np.random.RandomState(20).rand(2, 1, 40, 40) > 0.3).astype(np.float32)
            }[mask_kind]
    ref = JA.dot_product_attention(*_jax(q, k, v, mask), causal=causal)
    out = TA.dot_product_attention(*_torch(q, k, v, mask), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    for impl in ("xla", "flash"):
        if impl == "flash" and mask_kind == "full":
            continue
        out = TA.dot_product_attention(*_torch(q, k, v, mask), causal=causal, impl=impl)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_dot_product_attention_rejects_what_flash_cannot_take():
    q, k, v = _torch(*_qkv(21, 1, 2, 16, 16, 16))
    full = torch.ones((1, 1, 16, 16))
    with pytest.raises(ValueError, match="mask must be"):
        TA.dot_product_attention(q, k, v, full, impl="flash")
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TA.dot_product_attention(q, k, v, impl=impl)
    with pytest.raises(ValueError, match="unknown attention impl"):
        TA.dot_product_attention(q, k, v, impl="cudnn")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches the kernel or raises: CPU tensors are refused,
    never run through the plain version."""
    q, k, v = _torch(*_qkv(22, 1, 2, 16, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        TA.flash_forward(q, k, v, None, None, False, 0.25, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """On the card: the CUDA kernel against the plain version on the same
    inputs (strided q/k/v, key padding with a dead example, causal
    rectangle). float32: atol 2e-5; bfloat16: one bf16 ulp + 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; run python3 chip_smoke.py there")
    set_fp32_numerics()
    dt = getattr(torch, dtype)
    rs = np.random.RandomState(23)
    qkv = torch.from_numpy(rs.randn(2, 77, 3 * 4 * 64).astype(np.float32)).cuda().to(dt)
    q, k, v = (t.reshape(2, 77, 4, 64).transpose(1, 2) for t in qkv.split(256, -1))
    mask = torch.from_numpy(_key_mask(24, 2, 77)).cuda()
    mask[0] = 0
    for kw in ({"mask": mask}, {"causal": True}):
        before = TA.flash_forward.launches
        out, lse = TA.flash_attention(q, k, v, return_lse=True, **kw)
        assert TA.flash_forward.launches == before + 1
        qseg, kseg = TA.attention_segments(kw.get("mask"), None, 2, 77, 77, q.device)
        ref, ref_lse = TA.flash_forward_reference(q, k, v, qseg, kseg, kw.get("causal", False),
                                                  1 / 8, 0)
        diff = (out.float() - ref.float()).abs()
        if dt == torch.float32:
            assert diff.max().item() <= 2e-5
        else:
            assert bool((diff <= 2 ** -7 * ref.float().abs() + 1e-5).all())
        assert (lse - ref_lse).abs().max().item() <= 1e-4
