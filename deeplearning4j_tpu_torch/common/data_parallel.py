"""The data-parallel context of a train step: one logical step over W ranks.

The JAX package trains data-parallel by sharding the batch over a mesh and
letting GSPMD compile one logical step: the loss is the global batch's, the
gradients are its gradients, BatchNormalization's moments are the global
batch's and a dropout mask is drawn once at the global shape, each device
taking its rows. The port runs one device per process, so the trainers of
``parallel.trainer`` put a :class:`DataParallelContext` on the network
(``net._data_parallel``) for the duration of a fit and the network's step
reproduces those semantics by hand:

- **gradients** (:meth:`DataParallelContext.reduce_step`): after
  ``autograd.grad`` and before frozen-layer masking, normalisation, the
  updater and the constraints, every rank's gradients are summed in one
  flattened buffer per dtype, exactly once per step (once per tBPTT
  segment, which is a step of its own). DistributedDataParallel does not
  fit: its hooks fire on ``AccumulateGrad``, which ``autograd.grad`` never
  reaches;
- **the loss**: each rank's step objective is its loss times a weight,
  1 without a label mask and the rank's live count with one
  (:meth:`~DataParallelContext.loss_weight`); the weights travel in the
  same buffer and the sums are divided by their total. The port's losses
  are means over the unmasked examples, so ranks with different live
  counts would otherwise weigh their examples differently. The reported
  loss, ``score_``, is the global one (read from the card only when used).
  A ComputationGraph with label masks on several outputs has one live count
  per output: :meth:`~DataParallelContext.output_weights` all-reduces the
  vector of counts before the backward and weighs each output's loss by its
  local count over the global one (the regularisation by 1/W), so each
  rank's objective is its share of the global loss, and
  ``reduce_step(..., shares=True)`` only sums;
- **BatchNormalization** (:meth:`~DataParallelContext.sum_moments`): with
  W > 1 the sums ``x`` and ``x*x`` and the count are all-reduced through
  ``torch.distributed.nn.functional.all_reduce``, so the gradient flows
  through the reduction and the moments are the global batch's;
- **dropout** (:func:`batch_rows`): with W > 1 rank r of local batch b
  draws the mask at the global shape [W*b, ...] from the step's key and
  takes rows [r*b, (r+1)*b): a W-rank fit draws what a one-process fit on
  the global batch draws.

Sharded training (``parallel.partition``, a trainer's ``mesh_layout=`` or
``sharding_rules=``) uses the same context over the group of ranks that
compute distinct rows (``data``, and ``fsdp`` too under a layout), with
``shards``: the partitioned network's :class:`~..parallel.partition.
NetPartition`. The step then gathers each parameter into a whole tensor for
the forward, reduces the whole gradients as above (so gradient
normalization and constraints read whole-layer norms), and applies the
updater to this rank's blocks only.

Ranks feed equal local batches, as the JAX trainers require. Outside a
context (``use(None)``, the default) nothing here runs.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import torch

_current: contextvars.ContextVar = contextvars.ContextVar("tdl_data_parallel", default=None)


class DataParallelContext:
    """This rank's place in the data group: ``group`` (a
    ``torch.distributed`` process group, or None for a one-process run
    that issues no collective), ``rank`` and ``world``. ``phases`` (a
    ``monitoring.trace.StepPhaseRecorder``) times the gradient reduction
    as the step's ``collective`` phase; ``shards``, the partitioned
    network's ``NetPartition`` (None: whole parameters)."""

    def __init__(self, group=None, rank: int = 0, world: int = 1, phases=None, shards=None):
        self.group = group
        self.rank = int(rank)
        self.world = int(world)
        self.phases = phases
        self.shards = shards

    def _all_reduce(self, buf: torch.Tensor) -> None:
        import torch.distributed as dist

        if self.phases is None:
            dist.all_reduce(buf, group=self.group)
            return
        with self.phases.phase("collective"):
            dist.all_reduce(buf, group=self.group)

    def loss_weight(self, mask) -> Optional[torch.Tensor]:
        """The weight of this rank's loss: None (1) without a label mask,
        else the mask's live count, the denominator of the loss's mean."""
        if mask is None or self.group is None:
            return None
        return torch.as_tensor(mask).sum().to(torch.float32)

    def output_weights(self, masks) -> Optional[torch.Tensor]:
        """The weights of a several-output loss, one per output in the
        order of ``masks`` (a label mask or None each): this rank's live
        count over the group's (an output without a mask counts 1 per rank,
        its loss being a mean over equal local batches). One all-reduce of
        the counts; None without a group."""
        if self.group is None:
            return None
        counts = [torch.as_tensor(m).sum().to(torch.float32) if m is not None
                  else torch.ones((), dtype=torch.float32) for m in masks]
        device = next((m.device for m in masks if isinstance(m, torch.Tensor)), None)
        local = torch.stack([c.to(device) for c in counts])
        return local / self.all_reduce_sum(local).clamp(min=1.0)

    def reduce_step(self, grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                    weight: Optional[torch.Tensor],
                    shares: bool = False) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Global (gradients, loss) from this rank's gradients of
        ``loss * weight`` and its loss: one all-reduce (sum) per dtype of
        the flattened gradients, the float32 one also carrying
        ``loss * weight`` and ``weight``; everything is then divided by the
        summed weight (clamped at 1, as the losses clamp their
        denominators). With ``shares`` the loss and its gradients are
        already this rank's share of the global ones
        (:meth:`output_weights`): they are summed and not divided. Without a
        group, returns its arguments."""
        if self.group is None:
            return grads, loss
        if shares:
            weight = None
        w = (weight if weight is not None
             else torch.ones((), dtype=torch.float32, device=loss.device))
        by_dtype: Dict[torch.dtype, list] = {}
        for name, g in grads.items():
            by_dtype.setdefault(g.dtype, []).append(name)
        by_dtype.setdefault(torch.float32, [])
        out: Dict[str, torch.Tensor] = {}
        total = None
        for dtype in sorted(by_dtype, key=str):
            names = by_dtype[dtype]
            parts = [grads[n].reshape(-1) for n in names]
            if dtype == torch.float32:
                parts += [(loss.detach().float() * w).reshape(1), w.reshape(1)]
            buf = torch.cat(parts)
            self._all_reduce(buf)
            if dtype == torch.float32:
                total = (torch.ones((), dtype=torch.float32, device=buf.device) if shares
                         else buf[-1].clamp(min=1.0))
                loss = buf[-2] / total
                buf = buf[:-2]
            by_dtype[dtype] = (names, buf)
        for dtype, (names, buf) in by_dtype.items():
            buf = buf / total if dtype == torch.float32 else (buf.float() / total).to(dtype)
            off = 0
            for n in names:
                k = grads[n].numel()
                out[n] = buf[off:off + k].view(grads[n].shape)
                off += k
        return {n: out[n] for n in grads}, loss

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the group of a small tensor (a copy; no gradient)."""
        if self.group is None:
            return t
        t = t.detach().clone()
        self._all_reduce(t)
        return t

    def sum_moments(self, s1: torch.Tensor, s2: torch.Tensor,
                    n: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """BatchNormalization's sums over the group, with the gradient
        flowing back through the reduction: (sum x, sum x*x, count)."""
        from torch.distributed.nn.functional import all_reduce

        count = torch.full((1,), float(n), dtype=s1.dtype, device=s1.device)
        buf = all_reduce(torch.cat([s1, s2, count]), group=self.group)
        c = s1.shape[0]
        return buf[:c], buf[c:2 * c], buf[2 * c]


@contextlib.contextmanager
def use(ctx: Optional[DataParallelContext]):
    """Make ``ctx`` the current context inside the block (None: none)."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def spans_ranks() -> Optional[DataParallelContext]:
    """The current context if its group has more than one rank, else None:
    what BatchNormalization and dropout ask."""
    ctx = _current.get()
    return ctx if ctx is not None and ctx.group is not None and ctx.world > 1 else None


def batch_rows(shape) -> Tuple[tuple, Optional[slice]]:
    """(shape to draw, rows of it that are this rank's) for a random draw
    over a batch-first ``shape``: the global shape and this rank's slice
    under a context spanning several ranks, else ``(shape, None)``."""
    ctx = spans_ranks()
    shape = tuple(shape)
    if ctx is None:
        return shape, None
    b = shape[0]
    return (b * ctx.world, *shape[1:]), slice(ctx.rank * b, (ctx.rank + 1) * b)
