"""Collectives: reductions and exchanges over the axes of the mesh, their
differentiable forms, and the host-side control SPI with an in-process fake
that injects failures and delays.

Counterpart of ``deeplearning4j_tpu/parallel/collectives.py``. The JAX
package compiles its data-plane collectives into the step (``jax.lax.psum``
over a mesh axis); the port issues them eagerly through ``torch.distributed``
over the process groups of the active mesh (``parallel.mesh.use_mesh``, else
the data mesh over the whole group): NCCL between cards, gloo between CPU
processes or between ranks sharing one card. ``axis_name`` is an axis of the
mesh or a tuple of axes, as in ``jax.lax``; over a tuple, indices are
row-major, the first axis the major one. Each function returns a new tensor
and leaves its argument as it was.

Host staging. Gloo takes CUDA tensors for some collectives and not for
others (it passes the device pointer to a socket write, and the process
aborts). :func:`stages` decides, once per call and from the backend alone,
whether a collective goes through a host copy: only under gloo, only for a
CUDA tensor, and only for the operations in :data:`GLOO_CUDA_STAGED`, the
ones gloo refused on an H100 (``chip_smoke.py`` phase 11 prints them).
Under NCCL nothing stages. Compute never leaves the card.

Differentiable forms, for collectives inside a forward that autograd goes
through: :func:`all_to_all_grad` (backward: the swapped all-to-all),
:func:`ppermute_grad` (backward: the inverse permutation),
:func:`copy_to_axis` and :func:`reduce_from_axis` (Megatron's pair:
identity forward with a sum backward, and the reverse) and
:func:`all_gather_grad` (backward: the sum, then this rank's slice).

The host-side control plane keeps the JAX package's SPI and fake
(reference: the Aeron ``Transport`` SPI and its ``DummyTransport``): the
``Collectives`` facade, ``SingleProcessCollectives`` for one process,
``FakeCollectives`` for tests of restore paths, and, across real processes,
``launcher.ProcessCollectives``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .mesh import AXIS_DATA, Axes, active_mesh


# ------------------------------------------------------------- host staging

#: the collectives gloo refuses for CUDA tensors, which go through a host
#: copy under gloo. Seen with four ranks sharing an H100 (torch 2.11, one
#: gang per collective): point-to-point send/recv and
#: ``batch_isend_irecv`` abort in gloo's socket write ("Bad address");
#: ``all_reduce`` (sum, max), ``broadcast``, ``all_gather``,
#: ``all_gather_into_tensor``, ``all_to_all_single``, ``reduce_scatter``
#: and ``reduce_scatter_tensor`` take CUDA tensors. The list form of
#: ``all_to_all`` is refused by gloo on any device, so :func:`all_to_all`
#: uses ``all_to_all_single``.
GLOO_CUDA_STAGED = frozenset({"p2p"})

#: collectives that staged through the host in this process, by name
staged_counts: Dict[str, int] = {}
#: bytes each data-plane collective of this process sent, by name (a
#: tensor's bytes once per call; what a step moves is read around it)
traffic: Dict[str, int] = {}


def _count(op: str, x) -> None:
    traffic[op] = traffic.get(op, 0) + x.numel() * x.element_size()


def stages(op: str, x, group) -> bool:
    """Whether collective ``op`` on ``x`` over ``group`` goes through a host
    copy: gloo, a CUDA tensor, and an ``op`` in :data:`GLOO_CUDA_STAGED`."""
    import torch.distributed as dist

    if not x.is_cuda or op not in GLOO_CUDA_STAGED:
        return False
    return dist.get_backend(group) == "gloo"


def _host(op: str, x, group):
    if stages(op, x, group):
        staged_counts[op] = staged_counts.get(op, 0) + 1
        return x.detach().cpu(), True
    return x, False


# ------------------------------------------------------- data-plane wrappers


def _axis(axis_name: Axes):
    """(group, ranks in axis-index order, this rank's axis index) of
    ``axis_name`` on the active mesh; group None for one rank."""
    mesh = active_mesh()
    return mesh.group(axis_name), mesh.axis_ranks(axis_name), mesh.axis_index(axis_name)


def axis_size(axis_name: Axes) -> int:
    return active_mesh().axis_size(axis_name)


def axis_index(axis_name: Axes) -> int:
    return active_mesh().axis_index(axis_name)


def psum(x, axis_name: Axes = AXIS_DATA):
    """The sum of ``x`` over ``axis_name``."""
    import torch.distributed as dist

    group, _, _ = _axis(axis_name)
    y = x.detach().clone()
    if group is not None:
        _count("all_reduce", y)
        dist.all_reduce(y, group=group)
    return y


def pmax(x, axis_name: Axes):
    """The elementwise maximum of ``x`` over ``axis_name``."""
    import torch.distributed as dist

    group, _, _ = _axis(axis_name)
    y = x.detach().clone()
    if group is not None:
        _count("all_reduce", y)
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def pmean(x, axis_name: Axes = AXIS_DATA):
    """The mean of ``x`` over ``axis_name``."""
    return psum(x, axis_name) / axis_size(axis_name)


def all_gather(x, axis_name: Axes = AXIS_DATA, axis: int = 0, tiled: bool = True):
    """Every rank's ``x`` along ``axis_name``, in axis-index order,
    concatenated along ``axis`` (``tiled``) or stacked on a new axis
    there."""
    import torch
    import torch.distributed as dist

    group, ranks, _ = _axis(axis_name)
    if group is None:
        return x.detach().clone() if tiled else x.detach().unsqueeze(axis)
    src, staged = _host("all_gather", x.contiguous(), group)
    _count("all_gather", src)
    parts = [torch.empty_like(src) for _ in ranks]
    dist.all_gather(parts, src, group=group)
    parts = [parts[dist.get_group_rank(group, r)] for r in ranks]
    if staged:
        parts = [p.to(x.device) for p in parts]
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def ppermute(x, axis_name: Axes, perm: Sequence[Tuple[int, int]]):
    """``x`` sent along the (source, destination) pairs of ``perm``, in
    axis indices; a rank that receives from none gets zeros, as
    ``jax.lax.ppermute`` gives. The transfers are :func:`exchange`'s."""
    import torch

    me = axis_index(axis_name)
    pairs = [tuple(p) for p in perm]
    sends = {d: x for s, d in pairs if s == me and d != me}
    recvs = {s: x for s, d in pairs if d == me and s != me}
    got = exchange(sends, recvs, axis_name)
    if (me, me) in pairs:
        return x.detach().clone()
    return next(iter(got.values())) if got else torch.zeros_like(x)


def exchange(sends: Dict[int, Any], recvs: Dict[int, Any], axis_name: Axes):
    """Point-to-point transfers over ``axis_name``: ``sends`` maps an axis
    index to the tensor this rank sends it, ``recvs`` an axis index to a
    tensor of the shape, dtype and device this rank receives from it (its
    contents unused). Returns {axis index: received tensor}. The two ranks
    of a transfer name each other; a rank with nothing to send or receive
    issues nothing. Counts the bytes this rank sends under ``p2p``.

    Under NCCL a batched p2p among some ranks of a group must not be that
    group's first operation; :func:`mesh.build_mesh` runs one all-reduce on
    every group it creates, so it never is."""
    import torch
    import torch.distributed as dist

    if not sends and not recvs:
        return {}
    group, ranks, me = _axis(axis_name)
    if group is None:
        raise ValueError(f"exchange over {axis_name!r}: one rank, no peer")
    ops, out, staged = [], {}, {}
    for i in sorted(sends):
        src, _ = _host("p2p", sends[i].contiguous(), group)
        _count("p2p", src)
        ops.append(dist.P2POp(dist.isend, src, ranks[i]))
    for i in sorted(recvs):
        like = recvs[i]
        buf, staged[i] = _host("p2p", torch.empty_like(like, memory_format=torch.contiguous_format),
                               group)
        out[i] = buf
        ops.append(dist.P2POp(dist.irecv, buf, ranks[i]))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return {i: (t.to(recvs[i].device) if staged[i] else t) for i, t in out.items()}


def all_to_all(x, axis_name: Axes, split_axis: int, concat_axis: int):
    """``x`` split into axis-size chunks along ``split_axis``, chunk i sent
    to axis index i, and the received chunks concatenated along
    ``concat_axis`` in axis-index order (``jax.lax.all_to_all(...,
    tiled=True)``)."""
    import torch
    import torch.distributed as dist

    group, ranks, _ = _axis(axis_name)
    if group is None:
        return x.detach().clone()
    n = len(ranks)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    src, staged = _host("all_to_all", x, group)
    order = [dist.get_group_rank(group, r) for r in ranks]  # axis index -> group rank
    chunks = torch.chunk(src.movedim(split_axis, 0), n, dim=0)
    by_group = [None] * n
    for i, c in enumerate(chunks):
        by_group[order[i]] = c
    send = torch.stack(by_group).contiguous()  # [n, chunk, ...] in group-rank order
    _count("all_to_all", send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    got = [recv[order[i]].movedim(0, split_axis) for i in range(n)]
    out = torch.cat(got, dim=concat_axis)
    return out.to(x.device) if staged else out


# ------------------------------------------------------ differentiable forms


def _autograd():
    import torch

    from .mesh import use_mesh

    # each backward runs its collective on the mesh its forward ran on (the
    # backward pass may run after use_mesh's block has ended, or on
    # autograd's device thread)

    class AllToAll(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, axis_name, split_axis, concat_axis):
            ctx.mesh, ctx.args = active_mesh(), (axis_name, split_axis, concat_axis)
            return all_to_all(x, axis_name, split_axis, concat_axis)

        @staticmethod
        def backward(ctx, g):
            axis_name, split_axis, concat_axis = ctx.args
            with use_mesh(ctx.mesh):
                return (all_to_all(g.contiguous(), axis_name, concat_axis, split_axis),
                        None, None, None)

    class PPermute(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, axis_name, perm):
            ctx.mesh, ctx.args = active_mesh(), (axis_name, perm)
            return ppermute(x, axis_name, perm)

        @staticmethod
        def backward(ctx, g):
            axis_name, perm = ctx.args
            with use_mesh(ctx.mesh):
                return ppermute(g, axis_name, [(d, s) for s, d in perm]), None, None

    class CopyToAxis(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, axis_name):
            ctx.mesh, ctx.axis_name = active_mesh(), axis_name
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            with use_mesh(ctx.mesh):
                return psum(g, ctx.axis_name), None

    class ReduceFromAxis(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, axis_name):
            return psum(x, axis_name)

        @staticmethod
        def backward(ctx, g):
            return g, None

    class AllGather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, axis_name, axis):
            ctx.mesh, ctx.args = active_mesh(), (axis_name, axis, x.shape[axis])
            return all_gather(x, axis_name, axis=axis, tiled=True)

        @staticmethod
        def backward(ctx, g):
            axis_name, axis, n = ctx.args
            with use_mesh(ctx.mesh):
                i = axis_index(axis_name)
                return psum(g, axis_name).narrow(axis, i * n, n), None, None

    return AllToAll, PPermute, CopyToAxis, ReduceFromAxis, AllGather


_FUNCTIONS = None


def _fn(i):
    global _FUNCTIONS
    if _FUNCTIONS is None:
        _FUNCTIONS = _autograd()
    return _FUNCTIONS[i]


def all_to_all_grad(x, axis_name: Axes, split_axis: int, concat_axis: int):
    """:func:`all_to_all` with autograd: the backward is the all-to-all
    with the two axes swapped."""
    return _fn(0).apply(x, axis_name, split_axis, concat_axis)


def ppermute_grad(x, axis_name: Axes, perm):
    """:func:`ppermute` with autograd: the backward sends the gradient
    along the inverse permutation."""
    return _fn(1).apply(x, axis_name, tuple(tuple(p) for p in perm))


def copy_to_axis(x, axis_name: Axes):
    """Identity forward, sum over ``axis_name`` backward: where an input
    that every rank of the axis holds enters a product split over it
    (Megatron's f)."""
    return _fn(2).apply(x, axis_name)


def reduce_from_axis(x, axis_name: Axes):
    """Sum over ``axis_name`` forward, identity backward: the partial
    results of a product split over the axis, summed (Megatron's g)."""
    return _fn(3).apply(x, axis_name)


def all_gather_grad(x, axis_name: Axes, axis: int = 0):
    """Tiled :func:`all_gather` with autograd: the backward sums the
    gradient over ``axis_name`` and keeps this rank's slice."""
    return _fn(4).apply(x, axis_name, axis)


# ------------------------------------------------------ host-side control SPI


class TransportError(RuntimeError):
    pass


class Collectives:
    """Host-side control-plane SPI (barrier / broadcast / gather of small
    blobs between processes). Analog of the reference Transport SPI
    (``v2.transport.Transport``: send/propagate/onReceive)."""

    def barrier(self, name: str) -> None:
        raise NotImplementedError

    def broadcast(self, name: str, value: Any, root: int = 0) -> Any:
        raise NotImplementedError

    def gather(self, name: str, value: Any, root: int = 0) -> Optional[List[Any]]:
        raise NotImplementedError

    def allgather(self, name: str, value: Any) -> List[Any]:
        """Every rank contributes a blob, every rank receives the full
        rank-ordered list (the encoded gradient exchange's primitive)."""
        raise NotImplementedError


class SingleProcessCollectives(Collectives):
    """Trivial impl for one-process runs (the common single-host case)."""

    def barrier(self, name: str) -> None:
        return None

    def broadcast(self, name: str, value: Any, root: int = 0) -> Any:
        return value

    def gather(self, name: str, value: Any, root: int = 0):
        return [value]

    def allgather(self, name: str, value: Any):
        return [value]


class FakeCollectives(Collectives):
    """In-process multi-"worker" fake — the DummyTransport descendant.

    N logical workers share one router object; each worker thread gets a
    handle via ``worker(rank)``. ``inject_delay(rank, seconds)`` and
    ``inject_failure(rank)`` simulate slow and dead hosts; operations
    involving a failed rank raise TransportError on every live rank, which is
    the gang-scheduled failure model (whole-step abort, then a checkpoint
    restore).
    """

    def __init__(self, world_size: int, timeout: float = 10.0):
        self.world_size = world_size
        self.timeout = timeout
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # slots keyed by (name, generation): the Nth time a rank joins "name"
        # it enters generation N, so reusing a name (barrier("sync") once per
        # step) synchronizes every round instead of replaying round 0
        # (ADVICE r1). Fully-retrieved generations are garbage-collected.
        self._slots: Dict[Any, Dict[int, Any]] = {}
        self._complete: set = set()  # latched: (name, gen) whose rendezvous finished
        self._joins: Dict[Any, int] = {}  # (name, rank) -> generations entered
        self._retrieved: Dict[Any, int] = {}  # (name, gen) -> ranks done
        self._delays: Dict[int, float] = {}
        self._failed: set = set()

    def inject_delay(self, rank: int, seconds: float) -> None:
        self._delays[rank] = seconds

    def inject_failure(self, rank: int) -> None:
        with self._cond:
            self._failed.add(rank)
            # invalidate the dead rank's deposits: any collective it hadn't
            # fully completed must abort for the survivors (already-returned
            # collectives handed out copies and are unaffected)
            for key, slot in self._slots.items():
                if key not in self._complete:
                    slot.pop(rank, None)
            self._cond.notify_all()

    def worker(self, rank: int) -> "FakeWorkerCollectives":
        return FakeWorkerCollectives(self, rank)

    # internal rendezvous: every live rank deposits; waits for all live ranks
    def _rendezvous(self, name: str, rank: int, value: Any) -> Dict[int, Any]:
        delay = self._delays.get(rank, 0.0)
        if delay:
            time.sleep(delay)
        deadline = time.monotonic() + self.timeout
        with self._cond:
            if rank in self._failed:
                raise TransportError(f"rank {rank} is failed")
            gen = self._joins.get((name, rank), 0)
            self._joins[(name, rank)] = gen + 1
            key = (name, gen)
            slot = self._slots.setdefault(key, {})
            slot[rank] = value
            self._cond.notify_all()
            while True:
                # completeness first (and latched): a failure injected after
                # every rank deposited must not abort the finished collective,
                # even for ranks that have not woken yet
                if key in self._complete or set(range(self.world_size)).issubset(slot.keys()):
                    self._complete.add(key)
                    out = dict(slot)
                    done = self._retrieved.get(key, 0) + 1
                    self._retrieved[key] = done
                    if done >= self.world_size:  # all ranks served: GC the slot
                        self._slots.pop(key, None)
                        self._complete.discard(key)
                        self._retrieved.pop(key, None)
                    return out
                if self._failed:
                    # gang-scheduled semantics: any failed member aborts the
                    # collective for EVERY rank (whole-step abort → restore)
                    raise TransportError(f"ranks {sorted(self._failed)} failed during '{name}'")
                if not self._cond.wait(timeout=max(0.0, deadline - time.monotonic())):
                    raise TransportError(f"timeout in '{name}' (have {sorted(slot)}, "
                                         f"need {self.world_size} ranks)")


class FakeWorkerCollectives(Collectives):
    def __init__(self, router: FakeCollectives, rank: int):
        self.router = router
        self.rank = rank

    def barrier(self, name: str) -> None:
        self.router._rendezvous(name, self.rank, None)

    def broadcast(self, name: str, value: Any, root: int = 0) -> Any:
        slot = self.router._rendezvous(name, self.rank, value)
        return slot[root]

    def gather(self, name: str, value: Any, root: int = 0):
        slot = self.router._rendezvous(name, self.rank, value)
        if self.rank == root:
            return [slot[i] for i in sorted(slot)]
        return None

    def allgather(self, name: str, value: Any):
        slot = self.router._rendezvous(name, self.rank, value)
        return [slot[i] for i in sorted(slot)]
