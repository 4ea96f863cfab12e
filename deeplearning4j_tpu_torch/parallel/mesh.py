"""The device mesh: the ranks of a run laid out on named axes.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``. The JAX package's
mesh is a grid of devices with named axes over which GSPMD shards a step.
The port runs one device per process (``parallel.launcher``), so its mesh is
a grid of the default group's ranks: a
``torch.distributed.device_mesh.DeviceMesh`` with one process group per
axis, plus a group for every tuple of axes a spec can name (``("fsdp",
"tp")``, ``("dp", "sp")``).

Rank r's coordinates are ``np.unravel_index(r, shape)``: the row-major order
in which the JAX package reshapes its device list into a ``Mesh``. So rank r
holds exactly the shard that JAX's device r holds, and the checkpoint chunks
of the two packages line up.

Axis names: the JAX package's vocabulary (``data``, ``model``, ``pipe``,
``seq``, ``expert``, ``fsdp``, ``tp``) and any other name (the flagship's
``dp``, ``tp``, ``sp``). ``MeshSpec`` resolves sizes as in the JAX package
(one axis may be -1: the rest of the ranks). A ``pipe`` axis carries the
stages of ``parallel.pipeline`` (its ring hops are ``collectives.exchange``
over it); an ``expert`` axis carries the expert blocks of
``models.moe`` (its expert-parallel ``moe_ffn``). Without a process group the mesh
spans the one process, every axis of size 1. :meth:`Mesh.virtual` gives rank
r's view of a mesh without any process group, for placement and checkpoint
arithmetic in one process.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_PIPE = "pipe"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
# the sharded-parameter layout axes: ``fsdp`` shards parameter and updater
# storage (ZeRO-3), ``tp`` a layer's math (Megatron); ``data`` stays the
# batch axis
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"

Axes = Union[str, Tuple[str, ...]]


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def device_count() -> int:
    """Devices a mesh can span: one per process of the default group
    (``launcher.initialize``), or 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if _initialized() else 1


def data_group():
    """The process group of the default mesh's data axis (the default
    group), or None when there is none."""
    import torch.distributed as dist

    return dist.group.WORLD if _initialized() else None


@dataclass
class MeshSpec:
    """Named axis sizes; -1 on one axis = absorb the remaining devices."""

    axes: Dict[str, int] = field(default_factory=lambda: {AXIS_DATA: -1})

    def resolve(self, n_devices: Optional[int] = None) -> Dict[str, int]:
        n = n_devices or device_count()
        sizes = dict(self.axes)
        fixed = 1
        wild = None
        for k, v in sizes.items():
            if v == -1:
                if wild is not None:
                    raise ValueError("only one axis may be -1")
                wild = k
            else:
                fixed *= v
        if wild is not None:
            if n % fixed != 0:
                raise ValueError(f"{n} devices not divisible by fixed axes product {fixed}")
            sizes[wild] = n // fixed
        total = math.prod(sizes.values())
        if total != n:
            raise ValueError(f"mesh axes {sizes} product {total} != device count {n}")
        return sizes


def _as_axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _known(shape: Dict[str, int], axes: Axes) -> Tuple[str, ...]:
    axes = _as_axes(axes)
    for a in axes:
        if a not in shape:
            raise ValueError(f"axis {a!r} is not an axis of the mesh {shape} (run "
                             "collectives over a mesh's axes inside parallel.mesh.use_mesh)")
    return axes


class Mesh:
    """A resolved mesh: ``shape`` ({axis: size}, in mesh order), this
    rank's ``rank`` and ``coords`` ({axis: index}), and the process groups
    of its axes and axis tuples (None for a group of one rank, and for a
    mesh without a process group).

    ``size`` is the size of the ``data`` axis (1 when there is none), what
    the data-parallel trainers divide a batch by."""

    def __init__(self, shape: Dict[str, int], rank: int = 0, device_mesh=None,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None):
        self.shape = dict(shape)
        self.rank = int(rank)
        self.device_mesh = device_mesh
        self._groups = groups or {}
        idx = np.unravel_index(self.rank, tuple(self.shape.values())) if self.shape else ()
        self.coords = {ax: int(i) for ax, i in zip(self.shape, idx)}

    @classmethod
    def virtual(cls, shape: Dict[str, int], rank: int) -> "Mesh":
        """Rank ``rank``'s view of a mesh of ``shape`` with no process
        group: for placement and checkpoint arithmetic in one process. A
        collective over one of its axes of size > 1 raises."""
        if not 0 <= rank < math.prod(shape.values()):
            raise ValueError(f"rank {rank} outside a mesh of {shape}")
        return cls(shape, rank)

    # -- sizes and indices ------------------------------------------------

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape.values()) if self.shape else 1

    @property
    def size(self) -> int:
        return self.shape.get(AXIS_DATA, 1)

    def axis_size(self, axes: Axes) -> int:
        """The product of the sizes of ``axes`` (an axis or a tuple)."""
        return math.prod(self.shape[a] for a in _known(self.shape, axes))

    def axis_index(self, axes: Axes) -> int:
        """This rank's index along ``axes``: row-major over a tuple, the
        first axis the major one (JAX's ``axis_index`` of a tuple)."""
        i = 0
        for a in _known(self.shape, axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def rank_at(self, coords: Dict[str, int]) -> int:
        """The rank at ``coords`` (axes not named keep this rank's)."""
        full = {**self.coords, **coords}
        return int(np.ravel_multi_index(tuple(full[a] for a in self.shape),
                                        tuple(self.shape.values())))

    def axis_ranks(self, axes: Axes) -> list:
        """The ranks of this rank's group along ``axes``, in axis-index
        order (index i of the list is the rank whose ``axis_index(axes)``
        is i)."""
        axes = _as_axes(axes)
        out = []
        for combo in itertools.product(*(range(self.shape[a]) for a in axes)):
            out.append(self.rank_at(dict(zip(axes, combo))))
        return out

    # -- groups -----------------------------------------------------------

    def group(self, axes: Axes = AXIS_DATA):
        """The process group of ``axes`` (an axis or a tuple of axes): the
        ranks that differ from this one only along them. None when those
        axes hold one rank, or when the mesh has no process group."""
        axes = _known(self.shape, axes)
        if self.axis_size(axes) == 1:
            return None
        # axes of size 1 add no rank: the group is that of the others
        key = tuple(a for a in self.shape if a in axes and self.shape[a] > 1)
        if key not in self._groups:
            raise RuntimeError(f"mesh {self.shape} has no process group for axes {axes} "
                               "(a virtual mesh runs no collective)")
        return self._groups[key]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _subsets(names: Sequence[str]) -> Iterable[Tuple[str, ...]]:
    for k in range(1, len(names) + 1):
        yield from itertools.combinations(names, k)


def build_mesh(spec: Optional[MeshSpec] = None, devices: Optional[Sequence] = None,
               **axes: int) -> Mesh:
    """``build_mesh(data=2, tp=2)`` (or ``build_mesh()``: the data mesh
    over every process of the default group). Axis order follows the
    arguments, the last axis the minor one. ``devices``, where given, names
    one device per process of the group: the port's mesh is the whole
    group.

    On every rank, in the same order, this creates one process group for
    each tuple of axes of size > 1 (each axis alone, each pair, ...) and
    runs one all-reduce on it: a process group must be created by all ranks
    together, and under NCCL its first operation must involve them all."""
    if spec is None:
        spec = MeshSpec(axes=dict(axes) if axes else {AXIS_DATA: -1})
    world = device_count()
    n = len(devices) if devices is not None else world
    sizes = spec.resolve(n)
    if n != world:
        raise NotImplementedError(
            f"a mesh of {n} devices in a group of {world} processes: the port's mesh "
            "spans the whole group, one device per process (start the run with "
            "parallel.launcher.launch)")
    if not _initialized():
        return Mesh(sizes)
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    rank = dist.get_rank()
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    names = tuple(sizes)
    device_mesh = DeviceMesh(device_type, np.arange(world).reshape(tuple(sizes.values())),
                             mesh_dim_names=names)
    base = Mesh(sizes, rank)
    groups: Dict[Tuple[str, ...], object] = {}
    for combo in _subsets([a for a in names if sizes[a] > 1]):
        if len(combo) == 1:
            groups[combo] = device_mesh.get_group(combo[0])
            continue
        mine = None
        others = [a for a in names if a not in combo]
        # every rank creates every group of this tuple, in one order
        for fixed in itertools.product(*(range(sizes[a]) for a in others)):
            ranks = sorted(Mesh(sizes, base.rank_at(dict(zip(others, fixed)))).axis_ranks(combo))
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        groups[combo] = mine
    # NCCL leaves a group's first operation undefined unless all its ranks
    # join it, and a pipeline's first hop is a batched p2p of two: so every
    # group runs one all-reduce of all its ranks here, in one order on every
    # rank
    import torch

    one = torch.zeros(1, device=device_type)
    for g in groups.values():
        dist.all_reduce(one, group=g)
    return Mesh(sizes, rank, device_mesh, groups)


def mesh_from_shape(shape: Dict[str, int], devices: Optional[Sequence] = None) -> Mesh:
    """``mesh_from_shape({"data": 1, "fsdp": 2, "tp": 2})``: a mesh of an
    axis map, axis order the dict's (size-1 axes are kept, so a spec naming
    them stays valid)."""
    if not shape:
        raise ValueError("mesh_from_shape needs at least one axis")
    return build_mesh(MeshSpec(axes=dict(shape)), devices=devices)


def data_parallel_mesh(n: Optional[int] = None) -> Mesh:
    """The data mesh over the group (``n``, when given, must be its size)."""
    return build_mesh(MeshSpec({AXIS_DATA: n or -1}))


def tp_dp_mesh(model: int, n: Optional[int] = None) -> Mesh:
    """2-D mesh: data outer, model inner."""
    return build_mesh(MeshSpec({AXIS_DATA: -1, AXIS_MODEL: model}),
                      devices=range(n) if n else None)


# ----------------------------------------------------------- the active mesh

_active: Optional[Mesh] = None


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the one the collectives of ``parallel.collectives``
    name their axes on, inside the block (``jax.sharding.set_mesh``)."""
    global _active
    prev, _active = _active, mesh
    try:
        yield mesh
    finally:
        _active = prev


def active_mesh() -> Mesh:
    """The mesh of :func:`use_mesh`, else the data mesh over the group."""
    if _active is not None:
        return _active
    return Mesh({AXIS_DATA: device_count()},
                groups={(AXIS_DATA,): data_group()} if device_count() > 1 else None,
                rank=_world_rank())


def _world_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _initialized() else 0
