"""Sharded-parameter training: FSDP × tensor-parallel × pipeline mesh layouts.

Counterpart of ``deeplearning4j_tpu/parallel/partition.py``. The
data-parallel trainers replicate every
parameter and updater slot on every rank; this module lifts that cap:

- :class:`SpecLayout` — an axis map over a ``data``/``fsdp``/``tp`` mesh
  that assigns a :class:`~.sharding.PartitionSpec` to every parameter by
  LAYER ROLE (the role vocabulary is ``nn.conf``'s; layers tag their params
  through ``Layer.param_roles``). ``fsdp`` shards parameter and updater
  STORAGE (ZeRO-3), ``tp`` a kernel's second dim.
- :class:`Partitioner` — applies a layout to a network: keeps on each rank
  the slice of each parameter (and of each updater slot, which mirrors its
  parameter) that JAX's ``NamedSharding`` gives the device at the rank's
  mesh coordinates, keeps BN statistics whole, and publishes
  ``tdl_param_bytes_per_rank`` / ``tdl_mesh_layout_info``.

The spec trees are the JAX package's, leaf for leaf: the same role policy,
the same per-axis divisibility fallback and the same ``uncovered`` and
``replicated_fallback`` reports. A partitioned network's step gathers each
parameter for the forward and keeps only this rank's slice of its gradient
(:class:`NetPartition`, used by ``parallel.trainer``); its ``output()``,
``score()`` and ``params()`` raise (``MultiLayerNetwork._whole_params``),
and :meth:`NetPartition.gather_state` gives the whole arrays.

``pipe`` > 1 puts a ``pipe`` axis outermost in the mesh; the role policy
leaves it out (a plain :class:`Partitioner` replicates over it), and only
``parallel.pipeline.PipelineParallelTrainer`` runs the schedule it implies:
the plain trainers refuse such a layout. :class:`PipelinePartitioner` lays
out the canonical pipeline state (blocks stacked on a leading layer dim,
chunked over ``pipe``, or over ``fsdp`` when ``pipe`` is 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..nn.conf import ROLE_BIAS, ROLE_EMBEDDING, ROLE_KERNEL, ROLE_NORM, classify_param_tree
from .mesh import AXIS_DATA, AXIS_FSDP, AXIS_PIPE, AXIS_TP, Mesh, mesh_from_shape
from .sharding import P, PartitionSpec, dim_axes, is_spec, map_with_specs, shard_slices


@dataclass(frozen=True)
class SpecLayout:
    """Canonical PartitionSpecs over a ``[pipe ×] data × fsdp × tp`` mesh.

    Axis sizes define the mesh shape (one may be -1 to absorb the remaining
    ranks; size-1 axes are kept so the spec vocabulary stays valid on any
    topology; ``pipe`` joins the mesh, outermost, only above 1, so a
    pipe-less layout keeps its mesh and checkpoint identity). Role policy:

    - ``embedding`` tables: leading (vocab/class) dim over ``fsdp×tp``;
    - ``kernel`` matrices: dim 0 over ``fsdp``, dim 1 over ``tp``;
    - ``norm`` / ``bias`` vectors: over ``fsdp``.

    A dim that an axis does not divide falls back per axis
    (:meth:`Partitioner.spec_tree`)."""

    data: int = 1
    fsdp: int = -1
    tp: int = 1
    pipe: int = 1
    data_axis: str = AXIS_DATA
    fsdp_axis: str = AXIS_FSDP
    tp_axis: str = AXIS_TP
    pipe_axis: str = AXIS_PIPE

    def shape(self) -> Dict[str, int]:
        base = {self.data_axis: self.data, self.fsdp_axis: self.fsdp, self.tp_axis: self.tp}
        if self.pipe != 1:
            return {self.pipe_axis: self.pipe, **base}
        return base

    def build_mesh(self, devices: Optional[Sequence] = None) -> Mesh:
        return mesh_from_shape(self.shape(), devices=devices)

    def embedding(self, ndim: int = 2) -> PartitionSpec:
        return P((self.fsdp_axis, self.tp_axis), *([None] * (ndim - 1)))

    def kernel(self, ndim: int = 2) -> PartitionSpec:
        if ndim < 2:
            return self.bias() if ndim == 1 else P()
        return P(self.fsdp_axis, self.tp_axis, *([None] * (ndim - 2)))

    def norm(self, ndim: int = 1) -> PartitionSpec:
        return P(self.fsdp_axis, *([None] * (ndim - 1))) if ndim else P()

    def bias(self, ndim: int = 1) -> PartitionSpec:
        return self.norm(ndim)

    def spec_for(self, role: Optional[str], ndim: int) -> Optional[PartitionSpec]:
        """Untrimmed spec for one leaf; None = uncovered role."""
        if ndim == 0:
            return P()
        if role == ROLE_EMBEDDING:
            return self.embedding(ndim)
        if role == ROLE_KERNEL:
            return self.kernel(ndim)
        if role in (ROLE_NORM, ROLE_BIAS):
            return self.norm(ndim)
        return None

    def describe(self, mesh: Optional[Mesh] = None) -> Dict[str, Any]:
        """JSON-able layout identity for checkpoint manifests (the JAX
        package's, key for key): axis sizes RESOLVED against the mesh."""
        sizes = dict(mesh.shape) if mesh is not None else self.shape()
        out = {"axes": {"data": int(sizes.get(self.data_axis, self.data)),
                        "fsdp": int(sizes.get(self.fsdp_axis, self.fsdp)),
                        "tp": int(sizes.get(self.tp_axis, self.tp))},
               "axis_names": [self.data_axis, self.fsdp_axis, self.tp_axis]}
        pipe = int(sizes.get(self.pipe_axis, self.pipe))
        if pipe != 1:
            out["axes"]["pipe"] = pipe
            out["axis_names"] = [self.pipe_axis] + out["axis_names"]
        return out


def largest_layout(n_devices: int, tp: int = 1, data: int = 1, pipe: int = 1) -> SpecLayout:
    """The largest valid :class:`SpecLayout` for a device count: ``fsdp``
    absorbs every device not claimed by ``pipe``/``data``/``tp``; a requested
    size that does not divide falls back to its largest feasible divisor."""
    n = max(1, int(n_devices))
    pipe = max(1, int(pipe))
    while n % pipe:
        pipe -= 1
    rest = n // pipe
    data = max(1, int(data))
    while rest % data:
        data -= 1
    tp = max(1, min(int(tp), rest // data))
    while (rest // data) % tp:
        tp -= 1
    return SpecLayout(data=data, fsdp=rest // (data * tp), tp=tp, pipe=pipe)


# ------------------------------------------------------------------ role trees


def _net_layers(net) -> Optional[Dict[str, Any]]:
    conf = getattr(net, "conf", None)
    if conf is None:
        return None
    if hasattr(conf, "layers"):          # MultiLayerNetwork
        return {str(i): layer for i, layer in enumerate(conf.layers)}
    if hasattr(conf, "nodes"):           # ComputationGraph
        return {name: node.layer for name, node in conf.nodes.items()}
    return None


def param_tree(net) -> Dict[str, Dict[str, Any]]:
    """The JAX package's ``params_`` tree of a port network: ``{layer:
    {name: tensor}}`` (layer index for a MultiLayerNetwork, node name for
    a ComputationGraph). A plain dict/list tree is returned as it is."""
    if isinstance(net, (dict, list, tuple)):
        return net
    return net._params()


def whole_params(net):
    """:func:`param_tree` with each leaf's whole shape: a partitioned
    network's blocks stand in by their whole shapes."""
    part = getattr(net, "_partition", None)
    if part is None:
        return param_tree(net)
    return {layer: {name: SimpleNamespace(shape=part.shapes[(layer, name)]) for name in names}
            for layer, names in param_tree(net).items()}


def param_role_tree(net) -> Any:
    """Role tree mirroring :func:`param_tree`: each layer's
    ``param_roles``; graph vertices with parameters (AttentionVertex) and
    plain trees classify by leaf name."""
    layers = _net_layers(net)
    params = param_tree(net)
    if layers is None:
        return classify_param_tree(params)
    roles = {}
    for key, sub in params.items():
        layer = layers.get(key)
        if layer is not None and hasattr(layer, "param_roles"):
            roles[key] = layer.param_roles(sub)
        else:  # graph vertex: canonical names
            roles[key] = classify_param_tree(sub)
    return roles


def uncovered_params(params, roles) -> List[str]:
    """Leaf paths whose role is None: the params a layout would replicate."""
    out: List[str] = []

    def walk(p, r, prefix):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], r[k] if isinstance(r, dict) else None, f"{prefix}{k}/")
        elif isinstance(p, (list, tuple)):
            for i, v in enumerate(p):
                walk(v, r[i] if isinstance(r, (list, tuple)) else None, f"{prefix}{i}/")
        elif r is None:
            out.append(prefix[:-1])

    walk(params, roles, "")
    return out


# ----------------------------------------------------------------- partitioner


@dataclass
class PartitionReport:
    """What one partition pass did."""

    params_bytes_total: int
    params_bytes_per_rank: int
    opt_bytes_per_rank: int
    per_device_params_bytes: int     # one device per rank: params_bytes_per_rank
    uncovered: List[str]             # role=None paths (strict mode raises)
    replicated_fallback: List[str]   # covered but nothing divides → P()
    specs: Any                       # trimmed spec tree actually applied


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(n) for n in np.shape(leaf)) if not hasattr(leaf, "shape") \
        else tuple(int(n) for n in leaf.shape)


def _nbytes(leaf) -> int:
    if hasattr(leaf, "element_size"):
        return int(leaf.numel() * leaf.element_size())
    return int(getattr(leaf, "nbytes", 0))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)) and not is_spec(tree):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _rep_specs(tree):
    if isinstance(tree, dict):
        return {k: _rep_specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rep_specs(v) for v in tree)
    return P()


def _structure(tree):
    if isinstance(tree, dict):
        return ("d", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)) and not is_spec(tree):
        return ("l", tuple(_structure(v) for v in tree))
    return "*"


class Partitioner:
    """Applies a :class:`SpecLayout` to parameter and updater trees on a
    mesh (the layout's own over the process group by default, or a
    :meth:`Mesh.virtual` one for arithmetic in one process).

    ``strict=True`` (default) refuses a tree with uncovered params;
    divisibility fallback is reported per path, not an error."""

    def __init__(self, layout: SpecLayout, mesh: Optional[Mesh] = None, strict: bool = True):
        self.layout = layout
        self.mesh = mesh if mesh is not None else layout.build_mesh()
        self.strict = strict
        axes = (layout.data_axis, layout.fsdp_axis, layout.tp_axis) + (
            (layout.pipe_axis,) if layout.pipe != 1 else ())
        for ax in axes:
            if ax not in self.mesh.shape:
                raise ValueError(f"mesh {dict(self.mesh.shape)} lacks layout axis {ax!r}")

    def describe(self) -> Dict[str, Any]:
        return self.layout.describe(self.mesh)

    # ------------------------------------------------------------ spec trees

    def _trim(self, shape: Tuple[int, ...], spec: PartitionSpec) -> PartitionSpec:
        """Per-dim, per-axis divisibility fallback: keep only the spec axes
        whose (cumulative) product divides that dim."""
        dims = []
        for d, axes in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
            if axes is None:
                dims.append(None)
                continue
            kept, prod = [], 1
            for ax in (axes if isinstance(axes, tuple) else (axes,)):
                size = self.mesh.shape[ax]
                if shape[d] % (prod * size) == 0:
                    kept.append(ax)
                    prod *= size
            dims.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
        while dims and dims[-1] is None:  # canonical form: no trailing Nones
            dims.pop()
        return P(*dims)

    def spec_tree(self, params, roles: Optional[Any] = None,
                  report: Optional[dict] = None) -> Any:
        """Trimmed PartitionSpec tree for ``params`` (roles default to name
        classification). ``report`` (if given) collects ``uncovered`` and
        ``replicated_fallback`` path lists."""
        roles = roles if roles is not None else classify_param_tree(params)
        uncovered: List[str] = []
        fallback: List[str] = []

        def walk(p, r, prefix):
            if isinstance(p, dict):
                return {k: walk(p[k], r[k] if isinstance(r, dict) else None, f"{prefix}{k}/")
                        for k in p}
            if isinstance(p, (list, tuple)):
                return type(p)(walk(v, r[i] if isinstance(r, (list, tuple)) else None,
                                    f"{prefix}{i}/")
                               for i, v in enumerate(p))
            path = prefix[:-1]
            shape = _shape(p)
            spec = self.layout.spec_for(r, len(shape))
            if spec is None:
                uncovered.append(path)
                return P()
            trimmed = self._trim(shape, spec)
            if shape and all(a is None for a in trimmed) and not all(a is None for a in spec):
                fallback.append(path)
            return trimmed

        specs = walk(params, roles, "")
        if report is not None:
            report["uncovered"] = uncovered
            report["replicated_fallback"] = fallback
        if self.strict and uncovered:
            raise ValueError(
                "SpecLayout does not cover these params (unknown role — tag them via "
                "Layer.param_roles / nn.conf._PARAM_NAME_ROLES instead of silently "
                f"replicating): {uncovered}")
        return specs

    # ------------------------------------------------------------- placement

    def shard_of(self, leaf, spec: PartitionSpec):
        """This rank's block of a whole leaf (a tensor: a contiguous copy)."""
        block = leaf[shard_slices(_shape(leaf), spec, self.mesh)]
        return block.contiguous().clone() if hasattr(block, "contiguous") else np.array(block)

    def place(self, tree, specs) -> Any:
        """This rank's blocks of every leaf of ``tree``."""
        return map_with_specs(self.shard_of, tree, specs)

    @staticmethod
    def state_spec_tree(state, param_specs) -> Any:
        """Spec tree for updater state (``{slot: params-shaped tree}``):
        slots that mirror the param tree structurally take the params'
        specs; anything else replicates."""
        if not isinstance(state, dict):
            return _rep_specs(state)
        pstruct = _structure(param_specs)
        return {k: (param_specs if _structure(sub) == pstruct else _rep_specs(sub))
                for k, sub in state.items()}

    def state_specs(self, net) -> Dict[str, Any]:
        """{'params','updater','bn'} spec trees of a network's train state
        (``serde.net_state``'s trees): the layout contract the checkpoints
        restore against."""
        from ..serde.net_state import _tree

        tree = _tree(net)
        pspecs = self.spec_tree(whole_params(net), param_role_tree(net))
        return {"params": pspecs,
                "updater": self.state_spec_tree(tree["updater"], pspecs),
                "bn": _rep_specs(tree["bn"])}

    # ----------------------------------------------------------- whole-net

    def partition_net(self, net) -> PartitionReport:
        """Keep on this rank its blocks of a network's parameters and
        updater state (in place: each tensor is replaced by its block), BN
        statistics whole, and publish the per-rank byte gauges. The
        network's steps then go through :class:`NetPartition`."""
        rep: dict = {}
        params = param_tree(net)
        specs = self.spec_tree(params, param_role_tree(net), report=rep)
        total = sum(_nbytes(w) for w in _leaves(params))
        partition_with_specs(net, self.mesh, specs)
        return self.report(net, specs, total, uncovered=rep["uncovered"],
                           fallback=rep["replicated_fallback"])

    def report(self, net, specs, params_bytes_total: int, uncovered=(),
               fallback=()) -> PartitionReport:
        """Byte accounting + metric publication for a partitioned network."""
        from ..monitoring.partition import partition_metrics

        per_rank = sum(_nbytes(w) for w in _leaves(param_tree(net)))
        opt_rank = sum(_nbytes(t) for slot in net.updater_state.values()
                       for t in slot.values())
        m = partition_metrics()
        m.param_bytes.labels("params").set(per_rank)
        m.param_bytes.labels("opt_state").set(opt_rank)
        d = self.describe()["axes"]
        m.layout_info.clear_children()
        m.layout_info.labels(str(d["data"]), str(d["fsdp"]), str(d["tp"])).set(
            self.mesh.n_devices)
        return PartitionReport(
            params_bytes_total=params_bytes_total, params_bytes_per_rank=per_rank,
            opt_bytes_per_rank=opt_rank, per_device_params_bytes=per_rank,
            uncovered=list(uncovered), replicated_fallback=list(fallback), specs=specs)


def partition_with_specs(net, mesh: Mesh, specs) -> "NetPartition":
    """Replace each parameter and updater tensor of ``net`` by this rank's
    block under ``specs`` (a spec tree over :func:`param_tree`), in place,
    and mark the network partitioned (``net._partition``)."""
    import torch

    if getattr(net, "_partition", None) is not None:
        raise ValueError("the network is partitioned already")
    part = NetPartition(mesh, net, specs)
    with torch.no_grad():
        for layer, names in param_tree(net).items():
            for name, p in names.items():
                p.data = p.data[shard_slices(p.shape, part.spec(layer, name), mesh)].clone()
        for tensors in net.updater_state.values():
            for flat, t in list(tensors.items()):
                tensors[flat] = t[shard_slices(t.shape, part.spec_of_key(flat), mesh)].clone()
    net._partition = part
    return part


class PipelinePartitioner(Partitioner):
    """Partitioner of the CANONICAL pipeline train state
    (``parallel.pipeline``): ``{"embed": ..., "blocks": {name: [L, ...]},
    "mlm": ...}``, every leaf under ``blocks`` stacked on a leading layer
    dim.

    Storage shards on that layer dim: over ``pipe`` when the layout has one
    (each stage's rank holds a chunk of the layers and their updater
    slots), else over ``fsdp``, the same chunks of the same dim, which is
    why a ``pipe=2`` checkpoint restores onto an ``fsdp=2`` layout bit for
    bit through the chunk-intersection reshard. A layer count the axis does
    not divide falls back to whole (``_trim``). ``embed`` and ``mlm``
    replicate. Roles are not read: the layout is positional (dim 0 = layer).
    ``describe()`` and ``state_specs`` are :class:`Partitioner`'s, so the
    checkpoint lineage stamps and reshards this layout as any other."""

    BLOCKS_KEY = "blocks"

    def _depth_axis(self) -> str:
        return self.layout.pipe_axis if self.layout.pipe != 1 else self.layout.fsdp_axis

    def spec_tree(self, params, roles: Optional[Any] = None,
                  report: Optional[dict] = None) -> Any:
        ax = self._depth_axis()

        def walk(p, in_blocks):
            if isinstance(p, dict):
                return {k: walk(v, in_blocks or k == self.BLOCKS_KEY) for k, v in p.items()}
            if isinstance(p, (list, tuple)):
                return type(p)(walk(v, in_blocks) for v in p)
            shape = _shape(p)
            if not in_blocks or not shape:
                return P()
            return self._trim(shape, P(ax, *([None] * (len(shape) - 1))))

        specs = walk(params, False)
        if report is not None:
            report["uncovered"] = []
            report["replicated_fallback"] = []
        return specs


# ------------------------------------------------------------ the step's view


def gather_leaf(x, spec: PartitionSpec, mesh: Mesh):
    """The whole array of a block ``x`` that ``mesh``'s rank holds under
    ``spec``: all-gathered over the axes of each dim the spec splits."""
    from .collectives import all_gather
    from .mesh import use_mesh

    with use_mesh(mesh):
        for d in range(len(spec)):
            axes = dim_axes(spec, d)
            if axes and mesh.axis_size(axes) > 1:
                x = all_gather(x, axes, axis=d)
    return x


class NetPartition:
    """A partitioned network's view of its own parameters: the spec of
    each ``(layer, name)`` and of each updater key, the whole shapes, and
    the gather and slice that a step does around the network's own math
    (``MultiLayerNetwork._step``, ``ComputationGraph._step``)."""

    def __init__(self, mesh: Mesh, net, specs):
        self.mesh = mesh
        self.specs = specs
        params = param_tree(net)
        self.shapes = {(layer, name): tuple(p.shape) for layer, names in params.items()
                       for name, p in names.items()}
        self._itemsize = next((p.element_size() for names in params.values()
                               for p in names.values()), 4)
        keys = getattr(net, "_keys", None)  # graph: node name -> module key
        self._key_layer = {key: name for name, key in keys.items()} if keys else None

    def whole_bytes(self) -> int:
        """Bytes of the whole parameters."""
        return sum(int(np.prod(shape)) * self._itemsize for shape in self.shapes.values())

    def spec(self, layer: str, name: str) -> PartitionSpec:
        return self.specs[layer][name]

    def spec_of_key(self, flat: str) -> PartitionSpec:
        """The spec of an updater key ``"<module key>.<name>"``."""
        key, name = flat.rsplit(".", 1)
        layer = self._key_layer.get(key, key) if self._key_layer else key
        return self.spec(layer, name)

    def gather(self, params):
        """{layer: {name: whole tensor}} from the blocks ``params`` holds:
        fresh leaves that require gradients (the step's autograd leaves)."""
        return {layer: {name: gather_leaf(p.detach(), self.spec(layer, name),
                                          self.mesh).requires_grad_(p.requires_grad)
                        for name, p in names.items()}
                for layer, names in params.items()}

    def keep(self, grads):
        """This rank's blocks of whole (reduced) gradients."""
        return {layer: {name: g[shard_slices(g.shape, self.spec(layer, name),
                                             self.mesh)].contiguous()
                        for name, g in names.items()}
                for layer, names in grads.items()}

    def whole(self, layer: str, pd) -> Dict[str, Any]:
        """{name: whole tensor} of one layer's parameters (no gradient)."""
        return {name: gather_leaf(p.detach(), self.spec(layer, name), self.mesh)
                for name, p in pd.items()}

    def block(self, layer: str, name: str, whole):
        return whole[shard_slices(whole.shape, self.spec(layer, name), self.mesh)]

    def gather_state(self, net) -> Dict[str, np.ndarray]:
        """{checkpoint path: whole host array} of the network's parameters,
        updater state and BN statistics (``serde.net_state``'s paths): a
        collective, every rank of the mesh calls it."""
        from ..serde.checkpoint import _leaf_paths
        from ..serde.net_state import _tree, to_numpy

        tree = _tree(net)
        out = {}
        for path, t in _leaf_paths(tree):
            top, rest = path.split("/", 1)
            if top == "bn":
                spec = P()
            else:  # params/<layer>/<name> or updater/<slot>/<layer>/<name>, where a
                # nested layer's name holds "/" ("fwd/W")
                parts = rest.split("/")[1 if top == "updater" else 0:]
                spec = self.spec(parts[0], "/".join(parts[1:]))
            out[path] = to_numpy(gather_leaf(t.detach(), spec, self.mesh).cpu())
        return out
