"""Collectives: the data group's reductions, and the host-side control SPI
with an in-process fake that injects failures and delays.

Counterpart of ``deeplearning4j_tpu/parallel/collectives.py``. The JAX
package compiles its data-plane collectives into the step
(``jax.lax.psum`` over a mesh axis); the port issues them eagerly through
``torch.distributed`` over the data group (``parallel.mesh``): NCCL between
cards, gloo between CPU processes. ``axis_name`` names the mesh axis as in
the JAX package; the port's mesh has one, ``data``. Each function returns a
new tensor and leaves its argument as it was.

The host-side control plane keeps the JAX package's SPI and fake
(reference: the Aeron ``Transport`` SPI and its ``DummyTransport``): the
``Collectives`` facade, ``SingleProcessCollectives`` for one process,
``FakeCollectives`` for tests of restore paths, and, across real processes,
``launcher.ProcessCollectives``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from .mesh import AXIS_DATA, data_group


# ------------------------------------------------------- data-plane wrappers

def _check_axis(axis_name: str) -> None:
    if axis_name != AXIS_DATA:
        raise NotImplementedError(f"axis {axis_name!r}: the port's mesh has the {AXIS_DATA!r} "
                                  "axis only (sharded training is ROADMAP.md item 6)")


def psum(x, axis_name: str = AXIS_DATA):
    """The sum of ``x`` over the data group."""
    import torch.distributed as dist

    _check_axis(axis_name)
    y = x.clone()
    dist.all_reduce(y, group=data_group())
    return y


def pmean(x, axis_name: str = AXIS_DATA):
    """The mean of ``x`` over the data group."""
    import torch.distributed as dist

    return psum(x, axis_name) / dist.get_world_size(data_group())


def all_gather(x, axis_name: str = AXIS_DATA, axis: int = 0, tiled: bool = True):
    """Every rank's ``x`` concatenated along ``axis`` in rank order
    (``tiled``), or stacked on a new leading axis."""
    import torch
    import torch.distributed as dist

    _check_axis(axis_name)
    group = data_group()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def ppermute(x, axis_name: str, perm):
    """``x`` sent along the (source, destination) pairs of ``perm``; a rank
    that receives from none gets zeros, as ``jax.lax.ppermute`` gives."""
    import torch
    import torch.distributed as dist

    _check_axis(axis_name)
    group = data_group()
    rank = dist.get_rank(group)
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == rank:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  dist.get_global_rank(group, dst), group))
        if dst == rank:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    for work in (dist.batch_isend_irecv(ops) if ops else []):
        work.wait()
    return out


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int):
    """``x`` split into world-many chunks along ``split_axis``, chunk r sent
    to rank r, and the received chunks concatenated along ``concat_axis``
    (``jax.lax.all_to_all(..., tiled=True)``)."""
    import torch
    import torch.distributed as dist

    _check_axis(axis_name)
    group = data_group()
    world = dist.get_world_size(group)
    ins = [c.contiguous() for c in torch.chunk(x, world, dim=split_axis)]
    outs = [torch.empty_like(c) for c in ins]
    dist.all_to_all(outs, ins, group=group)
    return torch.cat(outs, dim=concat_axis)


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
