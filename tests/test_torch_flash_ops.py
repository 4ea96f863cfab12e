"""The three flash kernels as PyTorch operators (``tdl::flash_fwd``,
``tdl::flash_bwd_dq``, ``tdl::flash_bwd_dkv``), on the CPU.

- ``torch.library.opcheck`` on each operator (float32; with and without
  segment ids; causal and not): schema, fake implementation, autograd
  registration and AOT dispatch with dynamic shapes;
- ``flash_attention``'s output and gradients through the operators equal
  the plain route of the port before the operators (the forward's plain
  version, then the plain backward on its out and lse) bit for bit;
- ``torch.export`` of a function that calls ``flash_attention`` keeps one
  ``tdl.flash_fwd`` node, and the exported program gives the eager result;
- the fake implementations touch no data and count no launch: CUDA-device
  fake tensors go through all three operators on a host without a card.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels import attention as TA
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

B, H, T, D = 2, 2, 40, 16
SCALE = 0.25


def _inputs(seed, segments):
    rs = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rs.randn(B, H, T, D).astype(np.float32)) for _ in range(3))
    seg = torch.from_numpy(rs.randint(0, 2, (B, T)).astype(np.int32)) if segments else None
    return q, k, v, seg


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_opcheck_flash_fwd(segments, causal):
    q, k, v, seg = _inputs(0, segments)
    args = tuple(t.requires_grad_() for t in (q, k, v)) + (seg, seg, causal, SCALE, 0, 0)
    torch.library.opcheck(torch.ops.tdl.flash_fwd.default, args)


@pytest.mark.parametrize("segments,causal", [(False, False), (True, True)])
def test_opcheck_flash_backward_ops(segments, causal):
    q, k, v, seg = _inputs(1, segments)
    out, lse = TA.flash_forward_reference(q, k, v, seg, seg, causal, SCALE, 0)
    do = torch.from_numpy(np.random.RandomState(2).randn(B, H, T, D).astype(np.float32))
    rest = (seg, seg, causal, SCALE, 0)
    torch.library.opcheck(torch.ops.tdl.flash_bwd_dq.default, (q, k, v, out, do, lse, *rest))
    _, delta = TA.flash_backward_dq_reference(q, k, v, out, do, lse, *rest)
    torch.library.opcheck(torch.ops.tdl.flash_bwd_dkv.default, (q, k, v, do, lse, delta, *rest))


@pytest.mark.parametrize("segments,causal", [(False, True), (True, False)])
def test_flash_attention_through_the_operators_equals_the_plain_route(segments, causal):
    """Strided q/k/v (views of one [B, T, 3, H, D] projection, as the
    attention layers give them) and a non-contiguous upstream gradient."""
    rs = np.random.RandomState(3)
    qkv = torch.from_numpy(rs.randn(B, T, 3, H, D).astype(np.float32)).requires_grad_()
    lq, lk, lv = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    q, k, v = (t.detach() for t in (lq, lk, lv))
    seg = torch.from_numpy(rs.randint(0, 3, (B, T)).astype(np.int32)) if segments else None
    out, lse = TA.flash_attention(lq, lk, lv, segment_ids=seg, causal=causal, return_lse=True)
    do = torch.from_numpy(rs.randn(B, T, H, D).astype(np.float32)).transpose(1, 2)
    grads = torch.autograd.grad(out, (lq, lk, lv), do)
    assert not lse.requires_grad
    ref_out, ref_lse = TA.flash_forward_reference(q, k, v, seg, seg, causal, SCALE, 0)
    ref = TA.flash_backward_reference(q, k, v, ref_out, ref_lse, do.contiguous(), seg, seg,
                                      causal, SCALE, 0)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    for g, r in zip(grads, ref):
        assert torch.equal(g, r)


def test_export_keeps_the_flash_operator():
    class Attend(torch.nn.Module):
        def forward(self, q, k, v, mask):
            return TA.flash_attention(q, k, v, mask, causal=True)

    q, k, v, _ = _inputs(4, False)
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, 30:] = 0
    program = torch.export.export(Attend(), (q, k, v, mask))
    calls = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert calls.count(torch.ops.tdl.flash_fwd.default) == 1
    assert torch.equal(program.module()(q, k, v, mask), Attend()(q, k, v, mask))


def test_fake_implementations_touch_no_data_and_count_no_launch(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_build(stem):
        raise AssertionError("a traced call must not build or load a kernel")

    monkeypatch.setattr(_build, "library", no_build)
    counters = (TA.flash_forward, TA.flash_backward_dkv, TA.flash_backward_dq)
    before = [f.launches for f in counters]
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        mode.allow_fallback_kernels = False
        q = torch.empty((B, H, T, 64), dtype=torch.bfloat16, device="cuda")
        kv = torch.empty((B, T, H, 64), dtype=torch.bfloat16, device="cuda").transpose(1, 2)
        seg = torch.empty((B, T), dtype=torch.int32, device="cuda")
        out, lse = torch.ops.tdl.flash_fwd(q, kv, kv, seg, seg, True, 0.125, 0, 64)
        dq, delta = torch.ops.tdl.flash_bwd_dq(q, kv, kv, out, out, lse, seg, seg, True,
                                               0.125, 0)
        dk, dv = torch.ops.tdl.flash_bwd_dkv(q, kv, kv, out, lse, delta, seg, seg, True,
                                             0.125, 0)
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and out.is_contiguous()
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32 and lse.is_contiguous()
    assert dq.shape == q.shape and delta.dtype == torch.float32
    assert dk.shape == dv.shape == kv.shape and dk.is_contiguous()
    assert all(t.device.type == "cuda" for t in (out, lse, dq, delta, dk, dv))
    assert [f.launches for f in counters] == before
