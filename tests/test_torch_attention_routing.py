"""Port routing: which calls ``dot_product_attention(impl="auto")`` sends
to the flash kernels, and which to the dense path.

``flash_takes`` is the kernels' input contract, decided from dtypes and
shapes before any launch. A call it refuses goes to the dense path, which
is what the JAX package's ``auto`` returns for such a call; the same inputs,
made with numpy from a seed, go through both packages. Tolerance as in
``test_torch_attention.py``: float32, atol 2e-5.
"""

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


@pytest.mark.parametrize("shape, dtypes, takes", [
    ((2, 3, 8, 64), ("float32",) * 3, True),
    ((2, 3, 8, 16), ("bfloat16",) * 3, True),
    ((2, 3, 8, 128), ("float32",) * 3, True),
    ((2, 3, 8, 32), ("float32",) * 3, True),
    ((2, 3, 8, 48), ("float32",) * 3, False),
    ((2, 3, 8, 8), ("float32",) * 3, False),
    ((2, 3, 8, 256), ("bfloat16",) * 3, False),
    ((2, 3, 8, 64), ("float16",) * 3, False),
    ((2, 3, 8, 64), ("float64",) * 3, False),
    ((2, 3, 8, 64), ("float32", "bfloat16", "float32"), False),
    ((2, 3, 8, 64), ("float32", "float32", "bfloat16"), False),
    ((65535, 1, 1, 16), ("float32",) * 3, True),
    ((5, 13107, 1, 16), ("float32",) * 3, True),
    ((65536, 1, 1, 16), ("float32",) * 3, False),
    ((2, 3, 0, 64), ("float32",) * 3, False),
])
def test_flash_takes_is_the_kernels_input_contract(shape, dtypes, takes):
    """``flash_takes`` decides from dtypes and shapes alone (meta tensors:
    no data) what the kernels take: float32 or bfloat16, one dtype, D in
    KERNEL_HEAD_DIMS, B*H <= 65535, Tq and Tk >= 1."""
    q, k, v = (torch.empty(shape, dtype=getattr(torch, d), device="meta") for d in dtypes)
    assert TA.flash_takes(q, k, v) is takes


def test_flash_takes_needs_keys_and_four_axes():
    q = torch.empty((2, 3, 8, 64), device="meta")
    assert not TA.flash_takes(q, torch.empty((2, 3, 0, 64), device="meta"),
                              torch.empty((2, 3, 0, 64), device="meta"))
    flat = torch.empty((6, 8, 64), device="meta")
    assert not TA.flash_takes(flat, flat, flat)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", [None, "key"])
def test_dot_product_attention_auto_at_d48_matches_jax(causal, mask_kind):
    """A head dim the kernels are not built for: ``auto`` gives what the JAX
    package's ``auto`` gives (its dense path), and launches nothing."""
    q, k, v = _qkv(25, 2, 3, 40, 40, 48)
    mask = None if mask_kind is None else _key_mask(26, 2, 40)
    ref = JA.dot_product_attention(*_jax(q, k, v, mask), causal=causal)
    before = TA.flash_forward.launches
    out = TA.dot_product_attention(*_torch(q, k, v, mask), causal=causal)
    assert TA.flash_forward.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.cuda
def test_cuda_auto_routes_what_the_kernels_cannot_take_to_the_dense_path():
    """On the card: ``auto`` at D=48 (float32) and at float16 (D=64) returns
    the dense result without a kernel launch, while ``impl="flash"`` raises
    for both; a call the kernels take still launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; run python3 chip_smoke.py there")
    set_fp32_numerics()
    mask = torch.from_numpy(_key_mask(27, 2, 40)).cuda()
    for D, dt, err in ((48, torch.float32, ValueError), (64, torch.float16, TypeError)):
        q, k, v = (torch.from_numpy(a).cuda().to(dt) for a in _qkv(28, 2, 3, 40, 40, D))
        before = TA.flash_forward.launches
        out = TA.dot_product_attention(q, k, v, mask, causal=True)
        assert TA.flash_forward.launches == before
        assert torch.equal(out, TA.mha_reference(q, k, v, mask, causal=True))
        with pytest.raises(err):
            TA.dot_product_attention(q, k, v, mask, causal=True, impl="flash")
    q, k, v = (torch.from_numpy(a).cuda() for a in _qkv(29, 2, 3, 40, 40, 64))
    before = TA.flash_forward.launches
    TA.dot_product_attention(q, k, v, mask, causal=True)
    assert TA.flash_forward.launches == before + 1
