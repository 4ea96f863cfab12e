"""Mixture-of-Experts FFN, and its expert-parallel form over a mesh
(counterpart of ``deeplearning4j_tpu/models/moe.py``).

The JAX package writes the layer as GShard's dense algebra: a top-k router,
slot-major capacity positions by a cumsum, dispatch and combine tensors
[N, E, C], the experts' FFN batched over E, and the load-balancing
auxiliary loss ``E * sum(me * ce)`` (fraction of first choices times mean
router probability per expert). The port computes the same products with
``torch`` matmuls; nothing here reaches a Pallas kernel in the JAX package,
so nothing here is a hand-written kernel.

Expert parallelism. The JAX package shards ``w1``/``b1``/``w2``/``b2`` over
the mesh's ``expert`` axis and lets GSPMD keep the global semantics: the
capacity is that of the global token count, and a token's slot counts the
tokens of every data shard ahead of it. The port's :func:`moe_ffn` given a
``mesh`` whose expert axis is above 1 runs the same function with tokens
split over ``data`` and experts over ``expert``:

- one all-gather over ``data`` of each rank's [k, E] slot counts gives the
  offset of this rank's tokens in each expert (earlier slots on all data
  ranks, then this slot on lower data ranks), so positions, drops and the
  capacity are JAX's global ones;
- the expert inputs of this rank's expert shard, [E/ep, C, D], are summed
  over ``data`` (every slot is one token's, on one data rank), the shard's
  FFN runs, and the combined partial outputs [N/dp, D] are summed over
  ``expert``.

Per step that moves, per rank: the counts (k·E floats, gathered), the
expert inputs (E/ep·C·D, all-reduced over data, and their gradient on the
way back), the partial outputs (N/dp·D, all-reduced over expert) and a few
scalars per expert. Gradients come through the collectives' autograd forms
(:func:`parallel.collectives.reduce_from_axis` and
:func:`~parallel.collectives.copy_to_axis`); each rank's gradient is its
share, and :func:`reduce_expert_parallel_grads` sums the shares.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..common.device import resolve_device
from ..parallel.sharding import P, shard_slices
from .transformer import _generator


@dataclasses.dataclass
class MoEConfig:
    d_model: int = 128
    d_ff: int = 512
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    expert_axis: str = "expert"

    def capacity(self, n_tokens: int) -> int:
        # the JAX package's rounding, kept as it is (not a ceil)
        return max(1, int(self.top_k * n_tokens * self.capacity_factor
                          / self.n_experts + 0.999))


@torch.no_grad()
def init_moe_params(generator, cfg: MoEConfig, dtype=torch.float32, *,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Router ``wg`` [D, E] and experts ``w1`` [E, D, F], ``b1`` [E, F],
    ``w2`` [E, F, D], ``b2`` [E, D]: weights N(0, 0.02), biases 0, drawn on
    the CPU from ``generator`` (a ``torch.Generator`` or an int seed), so a
    seed gives the same weights on every device (JAX's numbers come through
    ``models.weights.moe_params_from_jax``). Leaves require grad."""
    dev = resolve_device(device)
    gen = _generator(generator)
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    out = {
        "wg": torch.randn((D, E), generator=gen) * 0.02,
        "w1": torch.randn((E, D, Fd), generator=gen) * 0.02,
        "b1": torch.zeros((E, Fd)),
        "w2": torch.randn((E, Fd, D), generator=gen) * 0.02,
        "b2": torch.zeros((E, D)),
    }
    return {k: v.to(device=dev, dtype=dtype).requires_grad_() for k, v in out.items()}


def moe_partition_specs(cfg: MoEConfig) -> Dict[str, P]:
    """Experts split over the expert axis; the router replicated."""
    e = cfg.expert_axis
    return {"wg": P(), "w1": P(e, None, None), "b1": P(e, None),
            "w2": P(e, None, None), "b2": P(e, None)}


def shard_moe_params(params, cfg: MoEConfig, mesh) -> Dict[str, torch.Tensor]:
    """The block of each whole parameter that ``mesh``'s rank holds under
    :func:`moe_partition_specs`, as new leaves that require grad."""
    specs = moe_partition_specs(cfg)
    out = {}
    for name, w in params.items():
        block = w.detach()[shard_slices(tuple(w.shape), specs[name], mesh)]
        out[name] = block.clone().requires_grad_()
    return out


def _positions(onehot, data_axis: Optional[str]):
    """Slot-major positions [N, k, E] of each (token, slot) in its expert.

    Without ``data_axis``: the JAX package's cumsum over the k·N flattened
    slot-major one-hots. With it: the same global cumsum, read from this
    rank's cumsum plus an offset from every data rank's [k, E] counts."""
    N, k, E = onehot.shape
    # the scans run along the last, contiguous dim: a cumsum over the
    # leading dim of [k·N, E] is PyTorch's outer-dim scan, which took 21.6%
    # of 20a's bf16 step on the H100 (chip_smoke.py)
    by_expert = onehot.permute(2, 1, 0)                    # [E, k, N]
    if data_axis is None:
        slot_major = by_expert.reshape(E, k * N)
        pos = torch.cumsum(slot_major, dim=1) - slot_major
        return pos.reshape(E, k, N).permute(2, 1, 0)
    from ..parallel.collectives import all_gather, axis_index

    by_slot = onehot.transpose(0, 1)                      # [k, N, E]
    local = (torch.cumsum(by_expert, dim=2) - by_expert).permute(1, 2, 0)  # this rank's slot
    counts = all_gather(by_slot.sum(1), data_axis, axis=0, tiled=False)  # [dp, k, E]
    total = counts.sum(0)
    offset = (torch.cumsum(total, 0) - total) + counts[:axis_index(data_axis)].sum(0)
    return (local + offset[:, None, :]).transpose(0, 1)


def _topk_dispatch(gates, k: int, capacity: int, data_axis: Optional[str] = None,
                   experts: Optional[slice] = None):
    """gates [N, E] → (combine [N, E', C], dispatch [N, E', C], me [E'],
    ce [E']) for the experts ``experts`` (all of them by default), where
    ``aux = E * sum(me * ce)`` over all experts.

    The routing runs in float32 whatever the activations' dtype: a bf16
    cumsum cannot count slots past 256. Ties in the top-k go to the lower
    expert index, as ``jax.lax.top_k`` gives them (a stable sort). ``me``
    and ``ce`` are sums over this rank's tokens (means once divided by the
    global token count)."""
    gates = gates.float()
    N, E = gates.shape
    order = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = order.values[:, :k], order.indices[:, :k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(topi, E).to(gates.dtype)            # [N, k, E]
    pos = _positions(onehot, data_axis)
    pos_in_expert = (pos * onehot).sum(-1)                 # [N, k]
    keep = (pos_in_expert < capacity).to(gates.dtype)
    # jax.nn.one_hot of a position past the capacity is a row of zeros
    cap_oh = (pos_in_expert[..., None] == torch.arange(capacity, device=gates.device)
              ).to(gates.dtype)                            # [N, k, C]
    sel = onehot if experts is None else onehot[..., experts]
    combine = torch.einsum("nke,nkc,nk->nec", sel, cap_oh, topv * keep)
    dispatch = torch.einsum("nke,nkc,nk->nec", sel, cap_oh, keep)
    cols = slice(None) if experts is None else experts
    me = onehot[:, 0, cols].sum(0)                         # 1st-choice counts
    ce = gates[:, cols].sum(0)
    return combine, dispatch, me, ce


def _experts(expert_in, w1, b1, w2, b2):
    """The FFN of each expert on its [C, D] slots: gelu (tanh form, as
    ``jax.nn.gelu``) of ``x @ w1 + b1``, then ``@ w2 + b2``."""
    h = F.gelu(torch.baddbmm(b1[:, None, :], expert_in, w1), approximate="tanh")
    return torch.baddbmm(b2[:, None, :], h, w2)


def moe_ffn(params, x, cfg: MoEConfig, *, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, D] → (y [B, T, D], aux_loss scalar).

    With a ``mesh`` whose ``cfg.expert_axis`` is above 1, ``x`` is this
    rank's rows of the global batch (split over ``data``), ``params`` this
    rank's blocks (:func:`shard_moe_params`), and the result is this rank's
    rows of what the whole layer gives on the global batch, with the global
    aux loss (module docstring)."""
    B, T, D = x.shape
    N = B * T
    xt = x.reshape(N, D)
    dt = x.dtype
    gates = torch.softmax(xt @ params["wg"].to(dt), dim=-1)
    ws = [params[n].to(dt) for n in ("w1", "b1", "w2", "b2")]
    ep = 1 if mesh is None else mesh.shape.get(cfg.expert_axis, 1)
    if ep == 1:
        combine, dispatch, me, ce = _topk_dispatch(gates, cfg.top_k, cfg.capacity(N))
        aux = cfg.n_experts * torch.sum((me / N) * (ce / N))
        expert_in = dispatch.to(dt).reshape(N, -1).t() @ xt          # [E*C, D]
        expert_out = _experts(expert_in.reshape(cfg.n_experts, -1, D), *ws)
        y = combine.to(dt).reshape(N, -1) @ expert_out.reshape(-1, D)
        return y.reshape(B, T, D), aux
    return _moe_ffn_expert_parallel(xt, gates, ws, cfg, mesh, (B, T, D))


def _moe_ffn_expert_parallel(xt, gates, ws, cfg: MoEConfig, mesh, shape):
    from ..parallel.collectives import copy_to_axis, psum, reduce_from_axis
    from ..parallel.mesh import use_mesh

    B, T, D = shape
    N, dt = xt.shape[0], xt.dtype
    ex, data = cfg.expert_axis, "data"
    dp = mesh.axis_size(data) if data in mesh.shape else 1
    el = cfg.n_experts // mesh.axis_size(ex)
    first = mesh.axis_index(ex) * el
    n_global = N * dp
    with use_mesh(mesh):
        combine, dispatch, me, ce = _topk_dispatch(
            gates, cfg.top_k, cfg.capacity(n_global), data if dp > 1 else None,
            slice(first, first + el))
        # aux over this rank's experts' columns, summed over the expert axis:
        # each rank's gates get the gradient of their own columns
        if dp > 1:
            me, ce = psum(me, data), reduce_from_axis(ce, data)
        aux_part = cfg.n_experts * torch.sum((me / n_global) * (ce / n_global))
        aux = reduce_from_axis(aux_part, ex)
        part_in = (dispatch.to(dt).reshape(N, -1).t() @ xt).reshape(el, -1, D)
        # every slot holds one token of one data rank: the sum over data is
        # the shard's whole input; its gradient is summed back the same way
        expert_in = copy_to_axis(reduce_from_axis(part_in, data), data) if dp > 1 else part_in
        expert_out = _experts(expert_in, *ws)
        y_part = combine.to(dt).reshape(N, -1) @ expert_out.reshape(-1, D)
        y = reduce_from_axis(y_part, ex)
    return y.reshape(B, T, D), aux


def reduce_expert_parallel_grads(grads, cfg: MoEConfig, mesh) -> Dict[str, torch.Tensor]:
    """Each rank's shares of the gradients of the global loss, summed: the
    router's over every axis, each expert block's over the axes that
    replicate it (``data``)."""
    from ..parallel.collectives import psum
    from ..parallel.mesh import use_mesh

    specs = moe_partition_specs(cfg)
    out = {}
    with use_mesh(mesh):
        for name, g in grads.items():
            axes = tuple(a for a in mesh.shape if a not in specs[name].axes()
                         and mesh.shape[a] > 1)
            out[name] = psum(g, axes) if axes else g
    return out
