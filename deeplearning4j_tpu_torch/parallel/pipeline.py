"""Pipeline parallelism over a ``pipe`` mesh axis: GPipe and 1F1B.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``. The JAX package
compiles one SPMD program: a ``lax.scan`` over ticks inside ``shard_map``,
one ``ppermute`` ring hop per tick. In the port each rank runs its own
stage's tick loop eagerly and sends its activations to the next stage with
point-to-point transfers over the pipe axis (``collectives.exchange``):

- **fill-drain forward**, ``M + S - 1`` ticks for M microbatches over S
  stages: at tick t stage s works on microbatch ``t - s``. A tick with no
  valid microbatch on a stage runs no stage and sends nothing (eager code
  has no static shapes to fill), so the launch counts are the real work.
  The last stage's outputs are then summed over ``pipe`` with every other
  stage contributing zeros (JAX's ``psum`` of the masked outputs), so every
  pipe rank holds them.
- **GPipe**: the forward keeps every microbatch's stage graph; the
  backward is the reverse fill-drain, one tick at a time: autograd through
  the tick's saved stage graph, and the input cotangent on the reverse
  ring. The ring hops are issued by the schedule, in the same order on
  every rank, never by autograd's engine: each rank's engine orders its
  own nodes, and a hop whose peer waits elsewhere would deadlock.
- **1F1B**: the same forward (so the losses are bitwise GPipe's); the
  backward is one loop of ``M + 2S - 1`` ticks. Each tick runs first the
  backward unit of microbatch ``u - (2S-1) + s`` (read the stash, run the
  stage again and differentiate it) and then the forward unit of
  microbatch ``u - s`` (recompute, stash its input, feed the forward
  ring). The stash is a ring of ``R = min(M, 2S-1)`` stage inputs, read
  before it is written: in-flight memory is bounded by the stage count.

Both backward passes sum the stage parameters' cotangents over the data
axis (each data rank saw its rows only) and broadcast stage 0's input
cotangents over ``pipe``, so that every pipe rank differentiates the
embedding itself. The cotangent of the broadcast outputs is read on the
last stage only: one copy of it, not S.

The flagship's wiring (:func:`transformer_pp_loss_fn`,
:func:`make_pp_train_step`, :class:`PipelineParallelTrainer`) keeps the
JAX package's two block layouts: staged ``[S, L/S, ...]`` (each rank holds
its stage's block) and canonical ``[L, ...]`` with cost-balanced
``boundaries``. The canonical layout is stored in the chunks of
``partition.PipelinePartitioner``; a stage whose layers lie partly in
another rank's chunk fetches those rows before its forward and sends their
gradients back to the owner, whose updater applies them. Storage never
moves, so a rebalance moves no parameter and checkpoints are unaffected.

Boundaries come from ``monitoring.costmodel.balance_stages``; measured skew
re-runs it (:meth:`PipelineParallelTrainer.maybe_rebalance`).
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..monitoring import aggregate, flight
from .mesh import AXIS_DATA, AXIS_PIPE, Mesh, use_mesh
from .trainer import ParallelTrainer

SCHEDULES = ("gpipe", "1f1b")

#: what the last pipeline call of this process ran, from its own loops:
#: ``schedule``, ``stages``, ``microbatches``, ``forward_ticks``,
#: ``backward_ticks``, ``stash_slots`` (1F1B), ``stage_forwards``,
#: ``stage_backwards`` (stage units run on this rank); the bytes this rank
#: sent on the rings (``ring_bytes``) and into the sums over ``pipe`` that
#: broadcast the outputs and the input cotangents (``broadcast_bytes``);
#: ``fetched_bytes`` (rows of the canonical blocks received from another
#: rank's chunk) and ``replicated_grad_bytes`` (the ``embed``/``mlm``
#: gradients summed over the data axis by :func:`reduce_replicated_grads`)
last_run: Dict[str, Any] = {}


# --------------------------------------------------------------- tree helpers


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _squeeze_leading(tree):
    from ..models.weights import _flatten

    return _unflatten(tree, [x.squeeze(0) if x.dim() > 0 and x.shape[0] == 1 else x
                             for _, x in _flatten(tree)])


# ------------------------------------------------------------ the schedules


def _valid(m: int, M: int) -> bool:
    return 0 <= m < M


def _hop(x, like, pairs, me: int, axis: str):
    """One ring hop over ``axis``: this rank sends ``x`` along its pair
    (source, destination) of ``pairs`` and returns what it receives (None
    when it receives nothing). Every rank derives the same ``pairs``."""
    from .collectives import exchange

    sends = {d: x for s, d in pairs if s == me}
    recvs = {s: like for s, d in pairs if d == me}
    last_run["ring_bytes"] = last_run.get("ring_bytes", 0) + sum(
        t.numel() * t.element_size() for t in sends.values())
    got = exchange(sends, recvs, axis)
    return next(iter(got.values())) if got else None


class _Schedule:
    """The static description of one pipeline call."""

    def __init__(self, stage_fn, treedef, mesh: Mesh, pipe_axis: str, data_axis, aux,
                 schedule: str):
        self.stage_fn = stage_fn
        self.treedef = treedef
        self.mesh = mesh
        self.pipe_axis = pipe_axis
        self.data_axis = data_axis
        self.aux = aux
        self.schedule = schedule
        self.S = mesh.axis_size(pipe_axis)
        self.s = mesh.axis_index(pipe_axis)

    def run_stage(self, leaves, x, m):
        p = _unflatten(self.treedef, leaves)
        if self.aux is None:
            return self.stage_fn(p, x)
        return self.stage_fn(p, x, _unflatten(self.aux[0], [a[m] for a in self.aux[1]]))


def _fill_drain(sched: _Schedule, xs, leaves, keep_graphs: bool):
    """The fill-drain forward: ``M + S - 1`` ticks. Returns the last
    stage's outputs [M, ...] (None on other stages) and, with
    ``keep_graphs``, each microbatch's (input, output) stage graph."""
    S, s = sched.S, sched.s
    M = xs.shape[0]
    like = xs[0]
    outs = [None] * M
    graphs = {}
    last_run.update(ring_bytes=0, broadcast_bytes=0)
    state = None
    ticks = runs = 0
    for t in range(M + S - 1):
        ticks += 1
        m = t - s
        y = None
        if _valid(m, M):
            inp = xs[m] if s == 0 else state
            runs += 1
            if keep_graphs:
                x_in = inp.detach().requires_grad_()
                with torch.enable_grad():
                    out = sched.run_stage(leaves, x_in, m)
                graphs[m] = (x_in, out)
                y = out.detach()
            else:
                y = sched.run_stage(leaves, inp, m)
            if s == S - 1:
                outs[m] = y
        pairs = [(i, i + 1) for i in range(S - 1) if _valid(t - i, M)]
        state = _hop(y, like, pairs, s, sched.pipe_axis)
    last_run.update(schedule=sched.schedule, stages=S, microbatches=M, forward_ticks=ticks,
                    stage_forwards=runs, backward_ticks=0, stage_backwards=0, stash_slots=0)
    return outs, graphs


def _broadcast_last(sched: _Schedule, outs, like):
    """Every pipe rank gets the last stage's outputs: the sum over ``pipe``
    of the last stage's stacked outputs and every other stage's zeros."""
    from .collectives import psum

    M = len(outs)
    if sched.s == sched.S - 1:
        ys = torch.stack(outs)
    else:
        ys = like.new_zeros((M,) + tuple(like.shape))
    last_run["broadcast_bytes"] += ys.numel() * ys.element_size()
    return psum(ys, sched.pipe_axis)


def _finish_backward(sched: _Schedule, dparams, dxs):
    """Sum the stage cotangents over the data axis and broadcast stage 0's
    input cotangents over ``pipe``."""
    from .collectives import psum

    if sched.data_axis is not None and sched.mesh.axis_size(sched.data_axis) > 1 and dparams:
        flat = psum(torch.cat([d.reshape(-1) for d in dparams]), sched.data_axis)
        out, off = [], 0
        for d in dparams:
            out.append(flat[off:off + d.numel()].view(d.shape))
            off += d.numel()
        dparams = out
    if sched.s != 0:
        dxs = torch.zeros_like(dxs)
    last_run["broadcast_bytes"] += dxs.numel() * dxs.element_size()
    return dparams, psum(dxs, sched.pipe_axis)


def _stage_grads(graph_out, x_in, p_leaves, g):
    grads = torch.autograd.grad(graph_out, [x_in] + p_leaves, g, allow_unused=True)
    return grads[0], grads[1:]


def _accumulate(dparams, grads):
    for d, g in zip(dparams, grads):
        if g is not None:
            d.add_(g)


def _gpipe_backward(sched: _Schedule, xs, p_leaves, graphs, dys):
    """The reverse fill-drain: at reverse tick t stage s differentiates
    microbatch ``t - s`` through its saved graph, then the input cotangents
    hop to the previous stage."""
    S, s = sched.S, sched.s
    M = xs.shape[0]
    like = xs[0]
    dparams = [torch.zeros_like(p) for p in p_leaves]
    dxs = torch.zeros_like(xs)
    g_state = None
    ticks = runs = 0
    for t in reversed(range(M + S - 1)):
        ticks += 1
        m = t - s
        dx = None
        if _valid(m, M):
            x_in, out = graphs.pop(m)
            g = dys[m] if s == S - 1 else g_state
            with torch.enable_grad():
                dx, grads = _stage_grads(out, x_in, p_leaves, g)
            _accumulate(dparams, grads)
            runs += 1
            if s == 0:
                dxs[m] = dx
        pairs = [(i, i - 1) for i in range(1, S) if _valid(t - i, M)]
        g_state = _hop(dx, like, pairs, s, sched.pipe_axis)
    last_run.update(backward_ticks=ticks, stage_backwards=runs)
    return _finish_backward(sched, dparams, dxs)


def _1f1b_backward(sched: _Schedule, xs, params, dys):
    """One loop of ``M + 2S - 1`` ticks: the backward unit (stash read,
    stage recomputed and differentiated), then the forward unit
    (recompute, stash write, forward ring)."""
    S, s = sched.S, sched.s
    M = xs.shape[0]
    like = xs[0]
    R = min(M, 2 * S - 1)
    stash = [None] * R
    p_leaves = [p.detach().requires_grad_() for p in params]
    dparams = [torch.zeros_like(p) for p in params]
    dxs = torch.zeros_like(xs)
    fstate = bstate = None
    ticks = fwd = bwd = 0
    for u in range(M + 2 * S - 1):
        ticks += 1
        # ---- backward unit: reads the stash before this tick's write
        mb = u - (2 * S - 1) + s
        dx = None
        if _valid(mb, M):
            g = dys[mb] if s == S - 1 else bstate
            with torch.enable_grad():
                x_in = stash[mb % R].detach().requires_grad_()
                out = sched.run_stage(p_leaves, x_in, mb)
                dx, grads = _stage_grads(out, x_in, p_leaves, g)
            _accumulate(dparams, grads)
            bwd += 1
            if s == 0:
                dxs[mb] = dx
        # ---- forward unit: the fill-drain tick's dataflow
        mf = u - s
        y = None
        if _valid(mf, M):
            a_in = xs[mf] if s == 0 else fstate
            y = sched.run_stage(params, a_in, mf)
            stash[mf % R] = a_in
            fwd += 1
        fstate = _hop(y, like, [(i, i + 1) for i in range(S - 1) if _valid(u - i, M)],
                      s, sched.pipe_axis)
        bstate = _hop(dx, like, [(i, i - 1) for i in range(1, S)
                                 if _valid(u - (2 * S - 1) + i, M)], s, sched.pipe_axis)
    last_run.update(backward_ticks=ticks, stage_backwards=bwd, stash_slots=R,
                    stage_forwards=last_run.get("stage_forwards", 0) + fwd)
    return _finish_backward(sched, dparams, dxs)


class _Pipeline(torch.autograd.Function):
    """The pipeline as one differentiable call: ``(xs, *stage leaves) ->
    ys``; the backward runs the schedule's backward loop."""

    @staticmethod
    def forward(ctx, sched, xs, *leaves):
        with use_mesh(sched.mesh):
            gpipe = sched.schedule == "gpipe"
            p_leaves = [p.detach().requires_grad_() for p in leaves] if gpipe else list(leaves)
            outs, graphs = _fill_drain(sched, xs, p_leaves, keep_graphs=gpipe)
            ys = _broadcast_last(sched, outs, xs[0])
        ctx.sched, ctx.graphs, ctx.p_leaves = sched, graphs, p_leaves
        ctx.save_for_backward(xs, *leaves)
        return ys

    @staticmethod
    def backward(ctx, dys):
        sched = ctx.sched
        xs, *leaves = ctx.saved_tensors
        with use_mesh(sched.mesh), torch.no_grad():
            if sched.schedule == "gpipe":
                dparams, dxs = _gpipe_backward(sched, xs, ctx.p_leaves, ctx.graphs, dys)
            else:
                dparams, dxs = _1f1b_backward(sched, xs, leaves, dys)
        ctx.graphs = ctx.p_leaves = None
        return (None, dxs, *dparams)


def _run_pipeline(stage_fn, stage_params, xs, mesh: Mesh, *, pipe_axis: str, data_axis,
                  aux, schedule: str):
    """``stage_params``: this rank's stage tree (as ``stage_fn`` takes it).
    Without autograd (``torch.no_grad``) only the forward runs."""
    from ..models.weights import _flatten

    leaves = [t for _, t in _flatten(stage_params)]
    aux_flat = None if aux is None else (aux, [a for _, a in _flatten(aux)])
    sched = _Schedule(stage_fn, stage_params, mesh, pipe_axis, data_axis, aux_flat, schedule)
    if torch.is_grad_enabled():
        return _Pipeline.apply(sched, xs, *leaves)
    with use_mesh(mesh):
        outs, _ = _fill_drain(sched, xs, leaves, keep_graphs=False)
        return _broadcast_last(sched, outs, xs[0])


def resolve_data_axis(mesh: Mesh, data_axis) -> Optional[str]:
    """'auto' picks the canonical batch axis present in the mesh ('data' or
    'dp'); an explicit axis missing from the mesh is an error (a silent miss
    would replicate the batch and quietly disable data parallelism)."""
    if data_axis == "auto":
        for cand in (AXIS_DATA, "dp"):
            if cand in mesh.shape:
                return cand
        return None
    if data_axis is not None and data_axis not in mesh.shape:
        raise ValueError(f"data_axis '{data_axis}' not in mesh axes {tuple(mesh.shape)}")
    return data_axis


def spmd_pipeline(stage_fn: Callable[..., Any], stacked_params, xs, mesh: Mesh,
                  *, pipe_axis: str = AXIS_PIPE, data_axis="auto", aux=None,
                  schedule: str = "gpipe"):
    """Pipeline the microbatches ``xs`` through ``S = mesh.shape[pipe_axis]``
    stages, this rank being stage ``mesh.axis_index(pipe_axis)``.

    - ``stacked_params``: this rank's block of the stage-stacked tree, as
      ``P(pipe_axis)`` gives it: every leaf with leading dim 1 (squeezed,
      as the JAX package's shard_map body does);
    - ``xs``: [M, mb, ...] microbatches: this rank's rows of each microbatch
      (the batch dim split over ``data_axis``, 'auto': whichever of
      'data'/'dp' the mesh has), on every pipe rank;
    - ``stage_fn(stage_params, x) -> y`` with ``y.shape == x.shape``, or
      ``stage_fn(stage_params, x, aux_mb)`` when ``aux`` (a tree of [M, ...]
      per-microbatch side inputs, e.g. key masks) is given;
    - ``schedule``: "gpipe" or "1f1b" (module docstring). Forward values are
      bitwise equal across schedules; gradients agree to float accumulation
      order.

    Returns ys [M, mb, ...] on every pipe rank. Differentiable with respect
    to ``xs`` and the stage parameters."""
    if pipe_axis not in mesh.shape:
        raise ValueError(f"mesh has no '{pipe_axis}' axis: {mesh.shape}")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule '{schedule}': {SCHEDULES}")
    dp = resolve_data_axis(mesh, data_axis)
    return _run_pipeline(stage_fn, _squeeze_leading(stacked_params), xs, mesh,
                         pipe_axis=pipe_axis, data_axis=dp, aux=aux, schedule=schedule)


def microbatch(x, n_microbatches: int):
    """[B, ...] -> [M, B/M, ...] (B must divide)."""
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} not divisible by {n_microbatches} microbatches")
    return x.reshape(n_microbatches, B // n_microbatches, *x.shape[1:])


def unmicrobatch(x):
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


# ------------------------------------------------------------ stage planning


def uniform_boundaries(n_layers: int, n_stages: int) -> List[Tuple[int, int]]:
    """Even contiguous split; raises on a ragged depth."""
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers do not divide evenly into {n_stages} pipeline "
            f"stages ({n_layers} % {n_stages} = {n_layers % n_stages}); pass "
            "boundaries= from monitoring.costmodel.balance_stages (the cost "
            "partitioner handles ragged depth), or pick a stage count that "
            "divides the layer count")
    c = n_layers // n_stages
    return [(s * c, (s + 1) * c) for s in range(n_stages)]


def stage_index_map(boundaries, n_layers: Optional[int] = None):
    """Padded view of contiguous stage boundaries: ``(idx, valid)`` numpy
    arrays of shape ``[S, Lmax]``, ``idx`` each stage slot's layer (padded
    slots alias layer 0) and ``valid`` the 1/0 gate, as the JAX package's
    compiled step takes them. Validates that the boundaries cover
    ``[0, L)`` contiguously with no empty stage. (The port's stages loop
    over their own layers and need no padding; this is the validation and
    the JAX package's map.)"""
    bs = [(int(a), int(b)) for a, b in boundaries]
    if not bs:
        raise ValueError("empty stage boundaries")
    if bs[0][0] != 0:
        raise ValueError(f"stage boundaries must start at layer 0: {bs}")
    for (_, b), (a2, _) in zip(bs, bs[1:]):
        if a2 != b:
            raise ValueError(f"stage boundaries not contiguous: {bs}")
    for a, b in bs:
        if b <= a:
            raise ValueError(f"empty pipeline stage in boundaries: {bs}")
    L = bs[-1][1]
    if n_layers is not None and L != int(n_layers):
        raise ValueError(f"stage boundaries cover {L} layers but the model has {n_layers}")
    S = len(bs)
    Lmax = max(b - a for a, b in bs)
    idx = np.zeros((S, Lmax), np.int32)
    valid = np.zeros((S, Lmax), np.float32)
    for s, (a, b) in enumerate(bs):
        idx[s, : b - a] = np.arange(a, b, dtype=np.int32)
        valid[s, : b - a] = 1.0
    return idx, valid


def transformer_stage_boundaries(cfg, n_stages: int, *, batch: int = 1,
                                 seq: Optional[int] = None,
                                 costs: Optional[Sequence[float]] = None):
    """Min-max-cost contiguous stage split of the flagship transformer, from
    ``models.transformer.layer_costs`` flops (or caller-supplied per-layer
    ``costs``, e.g. measured ones when rebalancing)."""
    from ..monitoring.costmodel import balance_stages

    if costs is None:
        from ..models import transformer as T

        rows = T.layer_costs(cfg, batch, int(seq or min(cfg.max_len, 128)))
        costs = [float(r["flops"]) for r in rows if r["kind"] == "TransformerBlock"]
    return balance_stages(list(costs), n_stages)


def graph_stage_partition(net, batch, n_stages: int):
    """Partition a MultiLayerNetwork / ComputationGraph layer chain into
    ``n_stages`` contiguous stages minimizing the largest predicted stage
    cost; returns the per-stage lists of layer names."""
    from ..monitoring.costmodel import balance_stages, layer_costs

    rows = layer_costs(net, batch)
    bounds = balance_stages([float(r["flops"]) for r in rows], n_stages)
    return [[rows[i]["layer"] for i in range(a, b)] for a, b in bounds]


# --------------------------------------------------------- transformer wiring


def _stack(xs):
    return torch.stack(list(xs)) if isinstance(xs[0], torch.Tensor) else np.stack(xs)


def stack_blocks(block_list):
    """List of per-layer param dicts -> {name: stacked leaf}, leading dim the
    layer (tensors or numpy arrays)."""
    return {k: _stack([b[k] for b in block_list]) for k in block_list[0]}


def unstack_blocks(stacked, n_layers: int):
    return [{k: v[i] for k, v in stacked.items()} for i in range(n_layers)]


def _tree_of(params):
    """A port ``Transformer`` as its JAX-shaped tree of tensors (blocks a
    list); a tree is returned as it is."""
    if isinstance(params, torch.nn.Module):
        return {"embed": dict(params.embed.named_parameters()),
                "blocks": [dict(b.named_parameters()) for b in params.blocks],
                "mlm": dict(params.mlm.named_parameters())}
    return params


def canonical_pp_params(params):
    """A port ``Transformer`` or the ``init_params`` tree -> the canonical
    pipeline train state: blocks stacked ``[L, ...]`` (layer-major),
    ``embed``/``mlm`` as they are. This is the layout
    :class:`PipelineParallelTrainer` stores (``PipelinePartitioner``'s
    chunks of it) and checkpoints: re-balancing, or restoring onto another
    topology, moves no parameter."""
    tree = _tree_of(params)
    blocks = tree["blocks"]
    if not isinstance(blocks, list):
        return tree  # canonical already
    return {"embed": dict(tree["embed"]), "blocks": stack_blocks(blocks),
            "mlm": dict(tree["mlm"])}


def pipeline_transformer_params(params, n_stages: int, boundaries=None):
    """The ``init_params`` tree (or a port ``Transformer``) in the pipeline
    layout: the staged ``{name: [S, L/S, ...]}`` blocks (a ragged depth
    raises, naming both numbers), or with ``boundaries`` the canonical
    ``[L, ...]`` layout, whose stage view the loss builds from them."""
    tree = _tree_of(params)
    blocks = tree["blocks"]
    L = len(blocks)
    if boundaries is not None:
        idx, _ = stage_index_map(boundaries, L)
        if idx.shape[0] != n_stages:
            raise ValueError(f"boundaries describe {idx.shape[0]} stages, expected {n_stages}")
        return canonical_pp_params(tree)
    uniform_boundaries(L, n_stages)  # raises on a ragged depth
    stacked = stack_blocks(blocks)
    staged = {k: x.reshape(n_stages, L // n_stages, *x.shape[1:]) for k, x in stacked.items()}
    return {"embed": dict(tree["embed"]), "blocks": staged, "mlm": dict(tree["mlm"])}


def pipeline_partition_specs(params_pp, *, pipe_axis: str = AXIS_PIPE):
    """Specs of the pipeline layout: blocks sharded on the stage dim, embed
    and mlm whole."""
    from .sharding import P

    return {
        "embed": {k: P() for k in params_pp["embed"]},
        "blocks": {k: P(pipe_axis, *([None] * (len(x.shape) - 1)))
                   for k, x in params_pp["blocks"].items()},
        "mlm": {k: P() for k in params_pp["mlm"]},
    }


def _ns(d):
    return SimpleNamespace(**d)


def _rows_of(B: int, M: int, mesh: Mesh, dp: Optional[str]) -> np.ndarray:
    """This rank's rows of a global batch of B: of every microbatch, the
    slice of its data coordinate (JAX's ``P(None, dp)`` over ``[M, B/M]``)."""
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mb = B // M
    n = mesh.axis_size(dp) if dp else 1
    if mb % n:
        raise ValueError(f"a microbatch of {mb} rows does not split over the {n} ranks of "
                         f"the data axis {dp!r}")
    i = mesh.axis_index(dp) if dp else 0
    local = mb // n
    return (np.arange(M)[:, None] * mb + i * local + np.arange(local)[None]).reshape(-1)


class _RowPlan:
    """Where the rows of stage ``me``'s layers ``[a, b)`` live: this rank's
    chunk of the canonical blocks (rows ``[me*C, (me+1)*C)`` of L, or all L
    when the blocks are stored whole), the pieces to fetch from other pipe
    ranks, and the rows other stages fetch from this one."""

    def __init__(self, mesh: Mesh, pipe_axis: str, boundaries, n_layers: int, chunk_rows: int):
        self.mesh, self.pipe_axis = mesh, pipe_axis
        S = len(boundaries)
        self.me = me = mesh.axis_index(pipe_axis)
        self.a, self.b = boundaries[me]
        self.whole = chunk_rows == n_layers
        C = chunk_rows
        self.own_lo = 0 if self.whole else me * C
        if self.whole:
            self.pieces, self.fetch, self.serve = [(me, self.a, self.b)], {}, {}
            return

        def overlap(lo, hi, o):
            return max(lo, o * C), min(hi, (o + 1) * C)

        self.pieces = [(o, *overlap(self.a, self.b, o)) for o in range(S)
                       if overlap(self.a, self.b, o)[0] < overlap(self.a, self.b, o)[1]]
        self.fetch = {o: (lo, hi) for o, lo, hi in self.pieces if o != me}
        self.serve = {}
        for o, (lo, hi) in enumerate(boundaries):
            if o != me:
                lo, hi = overlap(lo, hi, me)
                if lo < hi:
                    self.serve[o] = (lo, hi)

    def local(self, t, lo, hi):
        return t[lo - self.own_lo:hi - self.own_lo]


def _pack(parts):
    return torch.cat([p.reshape(-1) for p in parts])


def _unpack(buf, rows, likes):
    """Split a packed buffer into one [rows, *like.shape[1:]] tensor per
    leaf of ``likes``."""
    out, off = [], 0
    for like in likes:
        shape = (rows,) + tuple(like.shape[1:])
        n = int(np.prod(shape))
        out.append(buf[off:off + n].view(shape))
        off += n
    return out


def _buffer(rows, likes):
    n = sum(rows * int(np.prod(like.shape[1:])) for like in likes)
    return likes[0].new_empty((n,))


class _StageRows(torch.autograd.Function):
    """The canonical blocks this stage runs, ``[a, b)``, from this rank's
    storage chunk: rows it holds are sliced, rows another pipe rank holds
    are received from it (one packed transfer per peer). The backward sends
    those rows' gradients back to their owners and adds the ones it
    receives into its own chunk's. Blocks stored whole on every pipe rank
    (a layer count the pipe axis does not divide) sum their gradients over
    ``pipe`` instead: each layer's gradient arises on one stage."""

    @staticmethod
    def forward(ctx, plan, *chunks):
        from .collectives import exchange

        ctx.plan, ctx.shapes = plan, [c.shape for c in chunks]
        with use_mesh(plan.mesh):
            sends = {o: _pack([plan.local(c, lo, hi) for c in chunks])
                     for o, (lo, hi) in plan.serve.items()}
            recvs = {o: _buffer(hi - lo, chunks) for o, (lo, hi) in plan.fetch.items()}
            got = exchange(sends, recvs, plan.pipe_axis)
        last_run["fetched_bytes"] = sum(t.numel() * t.element_size() for t in got.values())
        pieces = [[plan.local(c, lo, hi) for c in chunks] if o == plan.me
                  else _unpack(got[o], hi - lo, chunks) for o, lo, hi in plan.pieces]
        return tuple(torch.cat([p[k] for p in pieces]) for k in range(len(chunks)))

    @staticmethod
    def backward(ctx, *grads):
        from .collectives import exchange, psum

        plan = ctx.plan
        full = [g.new_zeros(shape) for g, shape in zip(grads, ctx.shapes)]
        at = {}
        pos = 0
        for o, lo, hi in plan.pieces:
            at[o] = pos
            pos += hi - lo
        with use_mesh(plan.mesh):
            for o, lo, hi in plan.pieces:
                if o == plan.me:
                    for f, g in zip(full, grads):
                        plan.local(f, lo, hi).add_(g[at[o]:at[o] + hi - lo])
            if plan.whole:
                flat = psum(_pack(full), plan.pipe_axis)
                return (None, *_unpack(flat, full[0].shape[0], full))
            sends = {o: _pack([g[at[o]:at[o] + hi - lo] for g in grads])
                     for o, (lo, hi) in plan.fetch.items()}
            recvs = {o: _buffer(hi - lo, full) for o, (lo, hi) in plan.serve.items()}
            got = exchange(sends, recvs, plan.pipe_axis)
        for o, (lo, hi) in plan.serve.items():
            for f, g in zip(full, _unpack(got[o], hi - lo, full)):
                plan.local(f, lo, hi).add_(g)
        return (None, *full)


def _take_rows(x, rows):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(rows, device=x.device)]
    return np.asarray(x)[rows]


def _block_stage_fn(cfg):
    """A stage of the flagship: ``_block`` over the stage's layers (stacked
    leaves ``{name: [n, ...]}``), each through ``_remat_block`` under
    ``cfg.remat`` when autograd records; deterministic, as in JAX."""
    from ..models import transformer as T

    def stage_fn(p, h, pad_mask=None):
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(next(iter(p.values())).shape[0]):
            blk = _ns({k: v[i] for k, v in p.items()})
            h = (T._remat_block(cfg, blk, h, pad_mask, None, False) if remat
                 else T._block(cfg, blk, h, pad_mask, None, False))
        return h

    return stage_fn


def _ce_share(logits, labels, weights, mesh: Mesh, dp: Optional[str]):
    """This rank's share of ``token_ce_loss`` over the global batch: its
    rows' weighted cross-entropy over the global weight sum, summed over
    the data axis in the forward (the backward hands each rank its own
    share's cotangent)."""
    from ..models.transformer import _index_tensor
    from .collectives import psum, reduce_from_axis

    labels = _index_tensor(labels, logits.shape[-1], "label", logits.device)
    if weights is None:
        weights = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
    else:
        weights = torch.as_tensor(weights, device=logits.device).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    num = ((logz - gold) * weights).sum()
    if dp is None or mesh.axis_size(dp) == 1:
        return num / torch.clamp(weights.sum(), min=1.0)
    with use_mesh(mesh):
        total = psum(weights.sum(), dp)
        return reduce_from_axis(num / torch.clamp(total, min=1.0), dp)


def _stage_blocks(blocks, mesh: Mesh, pipe_axis: str, boundaries):
    """This stage's layers ``{name: [n, ...]}`` from this rank's blocks:
    its ``[1, L/S, ...]`` block of the staged layout, or with
    ``boundaries`` its chunk of the canonical ``[L, ...]`` blocks (rows
    fetched from their owners by :class:`_StageRows`)."""
    names = list(blocks)
    if boundaries is None:
        lead = blocks[names[0]].shape[0]
        if lead != 1:
            raise ValueError(f"the staged layout's blocks on a rank are its [1, L/S, ...] "
                             f"block of P({pipe_axis!r}); got a leading dim of {lead}")
        return {k: v[0] for k, v in blocks.items()}
    L = int(boundaries[-1][1])
    plan = _RowPlan(mesh, pipe_axis, boundaries, L, int(blocks[names[0]].shape[0]))
    return dict(zip(names, _StageRows.apply(plan, *[blocks[k] for k in names])))


def transformer_pp_loss_fn(cfg, n_microbatches: int, mesh: Mesh,
                           *, pipe_axis: str = AXIS_PIPE, data_axis="auto",
                           schedule: str = "gpipe", boundaries=None):
    """Build ``loss(params_pp, batch)`` running the blocks through a
    pipeline schedule; every rank of the mesh calls it on the same global
    ``batch`` and gets the global loss.

    ``params_pp`` holds this rank's tensors: ``embed`` and ``mlm`` whole,
    and ``blocks`` either its ``[1, L/S, ...]`` block of the staged layout
    (``boundaries=None``, :func:`pipeline_transformer_params` cut by
    :func:`pipeline_partition_specs`) or, with ``boundaries``, its
    ``PipelinePartitioner`` chunk of the canonical ``[L, ...]`` blocks
    (whole where the pipe axis does not divide L).

    The embedding and the MLM head run outside the pipeline on every pipe
    rank, on this rank's rows (its data coordinate's slice of every
    microbatch); ``pad_mask`` travels as per-microbatch aux. The batch is
    JAX's: ``tokens``, ``labels`` [B, T], optional ``weights``,
    ``pad_mask``, ``segments``. A batch with ``mlm_positions`` raises
    (the JAX function fails on the logits' shape). Deterministic: dropout
    above 0 raises, as in JAX. With ``cfg.remat`` each layer of a stage
    runs under ``_remat_block``."""
    from ..models import transformer as T

    if cfg.dropout and cfg.dropout > 0.0:
        raise ValueError(
            "pipeline-parallel training runs deterministic (per-stage dropout "
            "rng plumbing not implemented); set cfg.dropout=0.0 explicitly — "
            "silently dropping regularization would diverge from the "
            "single-device path")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule '{schedule}': {SCHEDULES}")
    if pipe_axis not in mesh.shape:
        raise ValueError(f"mesh has no '{pipe_axis}' axis: {mesh.shape}")
    dp = resolve_data_axis(mesh, data_axis)
    if boundaries is not None:
        idx, _ = stage_index_map(boundaries)
        S = idx.shape[0]
        if mesh.shape[pipe_axis] != S:
            raise ValueError(f"boundaries describe {S} stages but mesh axis '{pipe_axis}' "
                             f"has {mesh.shape[pipe_axis]} shards")
        boundaries = [(int(a), int(b)) for a, b in boundaries]
    stage_fn = _block_stage_fn(cfg)
    M = int(n_microbatches)

    def loss(params_pp, batch):
        if batch.get("mlm_positions") is not None:
            raise ValueError(
                "the pipelined loss scores every position: labels and weights are [B, T] "
                "(weight 0 where a position is not scored); mlm_positions is not read")
        model = SimpleNamespace(mesh=None, embed=_ns(params_pp["embed"]),
                                mlm=_ns(params_pp["mlm"]))
        rows = _rows_of(int(np.shape(batch["tokens"])[0]), M, mesh, dp)
        h = T._embed(model, _take_rows(batch["tokens"], rows), cfg,
                     segments=_take_rows(batch.get("segments"), rows))
        xs = microbatch(h, M)
        pm = batch.get("pad_mask")
        aux = None if pm is None else microbatch(
            torch.as_tensor(_take_rows(pm, rows), device=h.device), M)
        stage = _stage_blocks(params_pp["blocks"], mesh, pipe_axis, boundaries)
        ys = _run_pipeline(stage_fn, stage, xs, mesh, pipe_axis=pipe_axis, data_axis=dp,
                           aux=aux, schedule=schedule)
        logits = T._mlm_head(model, unmicrobatch(ys), cfg)
        return _ce_share(logits, _take_rows(batch["labels"], rows),
                         _take_rows(batch.get("weights"), rows), mesh, dp)

    return loss


_TOPS = ("embed", "blocks", "mlm")


def _flat_state(params_pp) -> Dict[str, torch.Tensor]:
    """``{"embed.tok": tensor, "blocks.qkv_w": ..., ...}``: the updater's keys."""
    return {f"{top}.{k}": t for top in _TOPS for k, t in params_pp[top].items()}


def reduce_replicated_grads(grads: Dict[str, torch.Tensor], mesh: Mesh,
                            data_axis: Optional[str]) -> Dict[str, torch.Tensor]:
    """The gradients of the global loss from autograd's on one rank
    (``{"embed.tok": ..., "blocks.qkv_w": ...}``): the ``embed`` and ``mlm``
    leaves saw this rank's rows only and are summed over the data axis (one
    all-reduce); the blocks come reduced from the schedule."""
    from .collectives import psum

    last_run["replicated_grad_bytes"] = 0
    if data_axis is None or mesh.axis_size(data_axis) == 1:
        return grads
    rep = [k for k in grads if not k.startswith("blocks.")]
    with use_mesh(mesh):
        buf = torch.cat([grads[k].reshape(-1) for k in rep])
        last_run["replicated_grad_bytes"] = buf.numel() * buf.element_size()
        buf = psum(buf, data_axis)
    out, off = dict(grads), 0
    for k in rep:
        n = grads[k].numel()
        out[k] = buf[off:off + n].view(grads[k].shape)
        off += n
    return out


def make_pp_train_step(cfg, updater, n_microbatches: int, mesh: Mesh,
                       *, pipe_axis: str = AXIS_PIPE, data_axis="auto",
                       schedule: str = "gpipe", boundaries=None):
    """One pipelined train step: ``step(params_pp, opt_state, batch,
    iteration) -> (params_pp, opt_state, loss)``, updating this rank's
    tensors and updater slots (keyed ``"embed.tok"``, ``"blocks.qkv_w"``,
    ...) in place. The stage gradients come reduced from the schedule (over
    the data axis, and to the owner of each canonical row); ``embed`` and
    ``mlm`` gradients are summed over the data axis here. Each rank updates
    only the blocks it stores: the pipeline's memory win."""
    loss_fn = transformer_pp_loss_fn(cfg, n_microbatches, mesh, pipe_axis=pipe_axis,
                                     data_axis=data_axis, schedule=schedule,
                                     boundaries=boundaries)
    dp = resolve_data_axis(mesh, data_axis)

    def step(params_pp, opt_state, batch, iteration):
        view = {top: {k: t.detach().requires_grad_() for k, t in params_pp[top].items()}
                for top in _TOPS}
        flat = _flat_state(view)
        with torch.enable_grad():
            loss = loss_fn(view, batch)
        got = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
        grads = reduce_replicated_grads(
            {k: g if g is not None else torch.zeros_like(flat[k]) for k, g in zip(flat, got)},
            mesh, dp)
        stored = _flat_state(params_pp)
        updates, opt_state = updater.apply(grads, opt_state, stored, iteration, 0)
        with torch.no_grad():
            for k, t in stored.items():
                t.sub_(updates[k].to(t.dtype))
        return params_pp, opt_state, loss.detach()

    return step


# ------------------------------------------------------------------- trainer


class _PipelineNet:
    """The network surface the trainer scaffolding (heartbeat, flight,
    faults, step phases) and ``TrainingCheckpointer`` read: ``params_``
    (``{"embed"|"blocks"|"mlm": {name: tensor}}``, the canonical state, this
    rank's chunk of ``blocks`` once partitioned), ``updater_state``
    (``{slot: {"blocks.qkv_w": tensor, ...}}``), ``bn_state`` (empty),
    ``iteration``, ``epoch``, ``score_``."""

    def __init__(self, params_pp, updater_state=None):
        self.params_ = params_pp
        self.updater_state = {} if updater_state is None else updater_state
        self.bn_state = {}
        self.iteration = 0
        self.epoch = 0
        self.score_ = float("nan")  # checkpointer idiom: nan -> no score yet

    @property
    def device(self) -> torch.device:
        return self.params_["embed"]["tok"].device

    def _params(self):
        return self.params_

    def _param_entries(self):
        for top in _TOPS:
            for name in sorted(self.params_[top]):
                yield top, name, self.params_[top][name]

    @torch.no_grad()
    def to(self, device) -> "_PipelineNet":
        for top in _TOPS:
            for name, t in self.params_[top].items():
                self.params_[top][name] = t.to(device)
        for slot in self.updater_state.values():
            for k, t in slot.items():
                slot[k] = t.to(device)
        return self


def pipeline_net(params, updater, *, updater_state=None, device="cuda") -> _PipelineNet:
    """A :class:`_PipelineNet` of the canonical state of ``params`` (a port
    ``Transformer``, the ``init_params`` tree or a canonical tree; numpy
    leaves are copied) on ``device``, with ``updater``'s fresh state or
    ``updater_state`` (the JAX package's ``{slot: canonical tree}``)."""
    from ..common.device import resolve_device
    from ..models.weights import _to_tensor, updater_state_from_jax

    dev = resolve_device(device)
    canonical = canonical_pp_params(params)
    state = {top: {k: (v.detach().clone() if isinstance(v, torch.Tensor) else _to_tensor(v))
                   .to(dev) for k, v in canonical[top].items()} for top in _TOPS}
    flat = _flat_state(state)
    opt = (updater_state_from_jax({slot: {top: tree[top] for top in _TOPS}
                                   for slot, tree in updater_state.items()}, flat)
           if updater_state is not None else updater.init(flat))
    return _PipelineNet(state, opt)


class PipelineParallelTrainer(ParallelTrainer):
    """Pipeline-parallel trainer of the flagship transformer over a ``pipe``
    mesh axis (with ``data`` beside it: ``SpecLayout(data=D, pipe=S)``, or a
    ``PipelinePartitioner``).

    The state is stored canonically (blocks stacked ``[L, ...]``), each rank
    holding its ``PipelinePartitioner`` chunk of the blocks and their updater
    slots, ``embed`` and ``mlm`` whole. Stage boundaries come from the cost
    model (``monitoring.costmodel.balance_stages`` over
    ``models.transformer.layer_costs``); :meth:`maybe_rebalance` re-runs it
    on measured skew, and moves no parameter: a stage fetches the rows of
    its layers that another rank stores. Checkpoints ride the lineage
    (``checkpointer()``); a ``pipe=S`` checkpoint restores onto an
    ``fsdp=F`` layout and back, bit for bit, with ``reshard=True``.

    Every rank feeds the same global dict batches (``tokens``/``labels`` and
    optional ``weights``/``pad_mask``/``segments``); the inherited
    ``_fit_core`` gives heartbeat, flight recording, fault points, step
    phases and step metrics. ``device`` is the card unless the caller asks
    for another (a gang worker passes ``launcher.local_device()``)."""

    _supports_pipe = True

    def __init__(self, params, cfg, updater, mesh_layout, *,
                 n_microbatches: int, schedule: str = "1f1b",
                 boundaries=None, layer_costs=None,
                 rebalance_threshold: float = 1.2, mesh: Optional[Mesh] = None,
                 updater_state=None, device="cuda"):
        from ..common.device import resolve_device
        from .partition import PipelinePartitioner, SpecLayout

        if schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule '{schedule}': {SCHEDULES}")
        dev = resolve_device(device)  # the card, or an error before any state is built
        layout = mesh_layout if isinstance(mesh_layout, SpecLayout) else mesh_layout.layout
        if layout.pipe == 1:
            raise ValueError(
                "PipelineParallelTrainer needs a pipe axis of size >= 2 in "
                "mesh_layout (got pipe=1); for pure data/fsdp/tp training "
                "use ParallelTrainer")
        if isinstance(mesh_layout, SpecLayout):
            mesh_layout = PipelinePartitioner(mesh_layout, mesh=mesh)
            mesh = None
        net = pipeline_net(params, updater, updater_state=updater_state, device="cpu")
        super().__init__(net, mesh=mesh, mesh_layout=mesh_layout)
        # each rank keeps its chunk: cut on the host, then moved to the card
        self.partition_report = self.partitioner.partition_net(net)
        net.to(dev)
        self.cfg = cfg
        self.updater = updater
        self.n_microbatches = int(n_microbatches)
        self.schedule = schedule
        self.rebalance_threshold = float(rebalance_threshold)
        self.n_stages = int(self.mesh.shape[layout.pipe_axis])
        self.n_layers = int(net._partition.shapes[("blocks", "qkv_w")][0])
        self._layer_costs = [float(c) for c in (
            layer_costs if layer_costs is not None else self.predicted_layer_costs())]
        if len(self._layer_costs) != self.n_layers:
            raise ValueError(f"{len(self._layer_costs)} layer costs for {self.n_layers} layers")
        if boundaries is None:
            from ..monitoring.costmodel import balance_stages

            boundaries = balance_stages(self._layer_costs, self.n_stages)
        idx, _ = stage_index_map(boundaries, self.n_layers)
        if idx.shape[0] != self.n_stages:
            raise ValueError(f"boundaries describe {idx.shape[0]} stages, layout has "
                             f"pipe={self.n_stages}")
        self.boundaries = [(int(a), int(b)) for a, b in boundaries]
        self._moved: Dict[str, int] = {}  # the last step's collective bytes, by kind
        from ..monitoring.partition import pipe_metrics

        pipe_metrics().stages.set(self.n_stages)

    # -- cost model ---------------------------------------------------------

    def predicted_layer_costs(self) -> List[float]:
        """Per-layer predicted flops of the transformer cost model: the input
        of the min-max stage partitioner."""
        from ..models import transformer as T

        rows = T.layer_costs(self.cfg, 1, min(self.cfg.max_len, 128))
        return [float(r["flops"]) for r in rows if r["kind"] == "TransformerBlock"]

    def predicted_stage_costs(self) -> List[float]:
        from ..monitoring.costmodel import stage_costs

        return stage_costs(self._layer_costs, self.boundaries)

    # -- the step -----------------------------------------------------------

    def _pp_step(self):
        return make_pp_train_step(
            self.cfg, self.updater, self.n_microbatches, self.mesh,
            pipe_axis=self.partitioner.layout.pipe_axis, data_axis=self.data_axis,
            schedule=self.schedule, boundaries=self.boundaries)

    def fit(self, batches, epochs: int = 1, prefetch: int = 0):
        """``batches``: an iterable of dict global batches (class
        docstring); ``prefetch`` is accepted for the JAX signature."""
        try:
            for _ in range(epochs):
                it = iter(batches)
                while True:
                    with self._phases.phase("input"):
                        try:
                            b = next(it)
                        except StopIteration:
                            break
                    self._fit_batch(b)
                self._phases.discard()
                self.net.epoch += 1
        finally:
            aggregate.maybe_spool(force=True)
            flight.flush()
        return self.net

    def _fit_batch(self, batch):
        self._fit_core(dict(batch))

    def _fit_core_inner(self, batch):
        from . import collectives

        n = self.net
        before = dict(collectives.traffic)
        _, n.updater_state, loss = self._pp_step()(n.params_, n.updater_state, batch,
                                                   n.iteration)
        self._moved = {k: v - before.get(k, 0) for k, v in collectives.traffic.items()
                       if v != before.get(k, 0)}
        n.score_ = float(loss)
        n.iteration += 1

    def _count_collectives(self):
        for kind, nbytes in self._moved.items():
            self._coll_bytes.labels(self._trainer_label, kind).inc(nbytes)

    def gather_state(self) -> Dict[str, np.ndarray]:
        """{checkpoint path: whole host array} of the state (a collective:
        every rank calls it)."""
        return self.net._partition.gather_state(self.net)

    # -- measured-skew re-balancing -----------------------------------------

    def profile_stages(self, *, seq: Optional[int] = None, batch_size: int = 1,
                       repeats: int = 3) -> List[float]:
        """Measured per-stage forward seconds on a probe activation,
        published as ``tdl_pipe_stage_seconds{stage}``. As in the JAX
        package, one process times every stage: the blocks are gathered
        over ``pipe`` and rank 0 runs the stages' forwards in turn,
        ``repeats`` rounds interleaved over the stages (on the card between
        ``torch.cuda.synchronize`` calls), each stage's time the median of
        its rounds, shared with every rank. On the CPU a stage's time is
        the process's CPU time, not the wall clock's. A collective: every rank calls
        it. Compared with :meth:`predicted_stage_costs` it drives
        :meth:`maybe_rebalance`."""
        from ..monitoring.partition import pipe_metrics
        from .collectives import all_gather, psum

        dev = self.net.device
        pipe = self.partitioner.layout.pipe_axis
        T_ = int(seq or min(self.cfg.max_len, 64))
        h = torch.zeros((int(batch_size), T_, self.cfg.d_model), dtype=torch.float32, device=dev)
        # on the card, wall time between synchronisations; on the CPU, this
        # process's CPU seconds: a wall clock also counts the time the
        # process waits for a core, and under oversubscription that wait
        # locks onto the stages' alternation and lands on one stage's rounds
        if dev.type == "cuda":
            sync, clock = torch.cuda.synchronize, time.perf_counter
        else:
            sync, clock = (lambda: None), time.process_time
        stage_fn = _block_stage_fn(self.cfg)
        vec = torch.zeros(self.n_stages, dtype=torch.float64, device=dev)
        with torch.no_grad(), use_mesh(self.mesh):
            blocks = {k: v if v.shape[0] == self.n_layers else all_gather(v, pipe, axis=0)
                      for k, v in self.net.params_["blocks"].items()}
            if self.mesh.rank == 0:
                stages = [{k: v[a:b] for k, v in blocks.items()} for a, b in self.boundaries]
                times = [[] for _ in stages]
                for r in range(max(1, repeats) + 1):  # round 0 warms up, off the clock
                    for s, stage in enumerate(stages):
                        sync()
                        t0 = clock()
                        stage_fn(stage, h)
                        sync()
                        if r:
                            times[s].append(clock() - t0)
                vec[:] = torch.tensor([float(np.median(t)) for t in times], dtype=vec.dtype)
            del blocks
            out = [float(v) for v in psum(vec, tuple(a for a in self.mesh.shape
                                                     if self.mesh.shape[a] > 1)).cpu()]
        pm = pipe_metrics()
        for s, dt in enumerate(out):
            pm.stage_seconds.labels(str(s)).set(dt)
        return out

    def maybe_rebalance(self, measured_stage_seconds: Optional[Sequence[float]] = None):
        """Re-partition the stages when the measured skew (max / mean of the
        stage seconds) exceeds ``rebalance_threshold`` (default 1.2x): each
        stage's layers get their predicted costs scaled by that stage's
        measured / predicted ratio and the min-max partitioner re-runs on
        them. A changed split records a ``pipe_rebalance`` flight event with
        the old and new boundaries and the skew, and bumps
        ``tdl_pipe_rebalances_total``; no parameter moves. Returns the new
        boundaries, or None. Every rank must pass the same timings (those of
        :meth:`profile_stages` are)."""
        from ..monitoring.costmodel import balance_stages
        from ..monitoring.partition import pipe_metrics

        measured = [float(x) for x in (
            measured_stage_seconds if measured_stage_seconds is not None
            else self.profile_stages())]
        if len(measured) != self.n_stages:
            raise ValueError(f"{len(measured)} stage timings for {self.n_stages} stages")
        mean = sum(measured) / self.n_stages
        skew = (max(measured) / mean) if mean > 0 else 1.0
        if skew <= self.rebalance_threshold:
            return None
        predicted = self.predicted_stage_costs()
        costs = list(self._layer_costs)
        for (a, b), meas, pred in zip(self.boundaries, measured, predicted):
            factor = (meas / pred) if pred > 0 else 1.0
            for i in range(a, b):
                costs[i] = self._layer_costs[i] * factor
        new = [(int(a), int(b)) for a, b in balance_stages(costs, self.n_stages)]
        self._layer_costs = costs
        if new == self.boundaries:
            return None
        old = self.boundaries
        self.boundaries = new
        pipe_metrics().rebalances.inc()
        flight.record("pipe_rebalance",
                      old_boundaries=[list(x) for x in old],
                      new_boundaries=[list(x) for x in new],
                      skew=float(skew))
        return new
