"""The float32 flash backward kernels' arithmetic (``csrc/flash_bwd.cu``,
``flash_bwd_dkv_f32_kernel`` and ``flash_bwd_dq_f32_kernel``) modelled in
plain torch on the CPU, with ``chip_smoke.py`` phase 2's cases and bounds,
for the tests ``test_torch_flash_bwd_f32_*.py``, which import the
``_one_torch_thread`` fixture: what the model is and how it is held is set
out in ``test_torch_flash_bwd_f32_numerics.py``.
"""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import attention as TA
from torch_port_fixtures import product


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the model on one thread: its tensors are small, and under
    ``pytest -n`` a thread pool per worker only spins against the other
    workers, slowing this test a hundredfold and its neighbours with it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BWD_FP32_ATOL = 1e-4  # chip_smoke.py phase 2: float32 backward, kernel vs plain ...
BWD_FP32_RTOL = 1e-4  # ... 1e-4 + 1e-4 |ref|
LOG2E = 1.4426950408889634
TILE = 64
PRODUCTS = ("s", "dp", "dv", "dk", "dq")  # S, dP, dV = P^T dO, dK = dS^T Q, dQ = dS K


def delta_tol(out, do):
    """delta against the plain version: the worst-case float32 error of a
    sum of D products taken in two orders, 2 (D + 1) 2^-24 rowsum|dO O|."""
    D = do.shape[-1]
    return 2 * (D + 1) * 2.0 ** -24 * (do * out).abs().sum(-1)


def _live(Tq, Tk, q0, q1, k0, k1, qseg, kseg, causal, q_offset):
    """[B or 1, 1, q1 - q0, k1 - k0] bool: which (query, key) scores of the
    tile pair are live."""
    live = torch.ones((1, 1, q1 - q0, k1 - k0), dtype=torch.bool)
    if causal:
        qpos = q_offset + torch.arange(q0, q1)[:, None]
        live = live & (qpos >= torch.arange(k0, k1)[None, :])
    if qseg is not None:
        live = live & (qseg[:, q0:q1, None] == kseg[:, None, k0:k1])[:, None]
    return live


def _p_ds(q, k, v, do, lse, delta, q0, q1, k0, k1, args, terms):
    """(P, dS) of the (query rows q0..q1, keys k0..k1) tile pair, float32, as
    the kernels form them on the accumulator fragments."""
    qseg, kseg, causal, scale, q_offset = args
    s = product(q[:, :, q0:q1], k[:, :, k0:k1].transpose(-1, -2), terms["s"])
    dp = product(do[:, :, q0:q1], v[:, :, k0:k1].transpose(-1, -2), terms["dp"])
    lse_t = lse[:, :, q0:q1, None]
    live = _live(q.shape[2], k.shape[2], q0, q1, k0, k1, qseg, kseg, causal, q_offset)
    live = live & (lse_t > TA.DEAD_ROW_LSE)
    p = torch.where(live, torch.exp2(s * (scale * LOG2E) - lse_t * LOG2E), 0.0)
    return p, p * (dp - delta[:, :, q0:q1, None]) * scale


def kernel_model(q, k, v, out, do, lse, qseg, kseg, causal, scale, q_offset, terms=None):
    """(dq, dk, dv, delta) float32 by the float32 kernels' arithmetic:
    ``terms`` maps each of PRODUCTS to 3 (3xTF32, the kernels) or 1 (one
    TF32 product)."""
    terms = {name: 3 for name in PRODUCTS} | (terms or {})
    args = (qseg, kseg, causal, scale, q_offset)
    Tq, Tk = q.shape[2], k.shape[2]
    # dq kernel, first: delta, then dQ over the 64-key tiles
    delta = (do * out).sum(dim=-1)
    dq = torch.zeros_like(q)
    for k0 in range(0, Tk, TILE):
        k1 = min(Tk, k0 + TILE)
        _, ds = _p_ds(q, k, v, do, lse, delta, 0, Tq, k0, k1, args, terms)
        dq += product(ds, k[:, :, k0:k1], terms["dq"])
    # dkv kernel: dV and dK over the 64-row q-tiles
    dv, dk = torch.zeros_like(v), torch.zeros_like(k)
    for q0 in range(0, Tq, TILE):
        q1 = min(Tq, q0 + TILE)
        p, ds = _p_ds(q, k, v, do, lse, delta, q0, q1, 0, Tk, args, terms)
        dv += product(p.transpose(-1, -2), do[:, :, q0:q1], terms["dv"])
        dk += product(ds.transpose(-1, -2), q[:, :, q0:q1], terms["dk"])
    dead = (lse <= TA.DEAD_ROW_LSE)[..., None]
    dv = dv + torch.where(dead, do, 0.0).sum(dim=2, keepdim=True) / Tk
    return dq, dk, dv, delta


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


def inputs(name):
    """float32 q/k/v/dO, the int32 (qseg, kseg) the kernels take, and the
    remaining arguments, from a seed per case. 'pad' leaves example 0 with
    no live key (every row dead); causal with Tq > Tk has dead leading
    rows."""
    _, Tq, Tk, D, causal, kind = next(c for c in CASES if c[0] == name)
    rs = np.random.RandomState(200 + sum(map(ord, name)))
    q, k, v, do = (torch.from_numpy(rs.randn(B, H, t, D).astype(np.float32))
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


def bound_ratio(got, ref):
    """Largest |got - ref| as a share of phase 2's float32 backward bound."""
    return ((got - ref).abs() / (BWD_FP32_ATOL + BWD_FP32_RTOL * ref.abs())).max().item()


def model_and_plain(name, terms=None):
    (q, k, v, do), args = inputs(name)
    out, lse = TA.flash_forward_reference(q, k, v, *args)
    model = kernel_model(q, k, v, out, do, lse, *args, terms=terms)
    plain = TA.flash_backward_reference(q, k, v, out, lse, do, *args)
    return model, plain, (out, do)


def assert_within_bound(name):
    """The model's dq, dk, dv within phase 2's float32 backward bound of
    the plain version on case ``name``, and its delta within delta_tol."""
    (dq, dk, dv, delta), plain, (out, do) = model_and_plain(name)
    for gname, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        ratio = bound_ratio(g, r)
        assert ratio <= 1.0, f"{name}: {gname} worst element at {ratio:.3f} of the bound"
    assert bool(((delta - TA.flash_backward_delta(out, do)).abs()
                 <= delta_tol(out, do)).all())
