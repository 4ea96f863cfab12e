"""The data mesh: the ranks of a data-parallel run.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``. The JAX package's
mesh is a grid of devices with named axes (data, model, pipe, seq, expert,
fsdp, tp) over which GSPMD shards a step. The port runs one device per
process (``parallel.launcher``), so its mesh is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` over the processes of the
default group, with the one axis ``data``. ``MeshSpec`` resolves axis sizes
as in the JAX package (one axis may be -1, the rest of the devices); any
axis but ``data`` of a size above 1 raises ``NotImplementedError`` (sharded
training is the next slice of ROADMAP.md item 6). Without a process group
the mesh spans the one process: ``data`` = 1 and no collective runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

AXIS_DATA = "data"


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def device_count() -> int:
    """Devices a data mesh can span: one per process of the default group
    (``launcher.initialize``), or 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if _initialized() else 1


def data_group():
    """The process group of the data axis (the default group), or None when
    there is none."""
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


@dataclass
class DataMesh:
    """A resolved mesh: ``shape`` ({axis: size}, ``data`` the only axis
    above 1) and the ``DeviceMesh`` over the default group's ranks (None
    for a mesh of one process without a group)."""

    shape: Dict[str, int]
    device_mesh: Optional[object] = None

    @property
    def size(self) -> int:
        return self.shape.get(AXIS_DATA, 1)

    def group(self):
        """The process group of the data axis (None without a process group)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(AXIS_DATA)


def build_mesh(spec: Optional[MeshSpec] = None, devices: Optional[Sequence] = None,
               **axes: int) -> DataMesh:
    """``build_mesh(data=-1)`` (or ``build_mesh()``): the data mesh over
    every process of the default group. ``devices``, where given, names one
    device per process of the group: the port's data mesh is the whole
    group."""
    if spec is None:
        spec = MeshSpec(axes=dict(axes) if axes else {AXIS_DATA: -1})
    world = device_count()
    n = len(devices) if devices is not None else world
    sizes = spec.resolve(n)
    others = {k: v for k, v in sizes.items() if k != AXIS_DATA and v > 1}
    if others:
        raise NotImplementedError(
            f"mesh axes {others}: the port trains data-parallel only; sharded training "
            "(fsdp/tp/pipe/seq axes) is the next slice (ROADMAP.md item 6)")
    if sizes.get(AXIS_DATA, 1) != world:
        raise NotImplementedError(
            f"a data axis of {sizes.get(AXIS_DATA, 1)} devices in a group of {world} "
            "processes: the port's data mesh spans the whole group, one device per process "
            "(start the run with parallel.launcher.launch)")
    if not _initialized():
        return DataMesh(sizes)
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DataMesh(sizes, DeviceMesh(device_type, list(range(world)),
                                      mesh_dim_names=(AXIS_DATA,)))


def mesh_from_shape(shape: Dict[str, int], devices: Optional[Sequence] = None) -> DataMesh:
    """``mesh_from_shape({"data": -1})``: :func:`build_mesh` of an axis map."""
    if not shape:
        raise ValueError("mesh_from_shape needs at least one axis")
    return build_mesh(MeshSpec(axes=dict(shape)), devices=devices)


def data_parallel_mesh(n: Optional[int] = None) -> DataMesh:
    """The data mesh over the group (``n``, when given, must be its size)."""
    return build_mesh(MeshSpec({AXIS_DATA: n or -1}))
