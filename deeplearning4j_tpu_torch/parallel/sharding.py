"""Sharding rules: map parameter trees to PartitionSpecs, and the slice of
an array that a rank of a mesh holds under one.

Counterpart of ``deeplearning4j_tpu/parallel/sharding.py``. Layer params get
Megatron-style column/row splits expressed as :class:`PartitionSpec` s; the
port's trainers gather and scatter by them (``parallel.trainer``), where the
JAX package lets GSPMD insert the collectives.

:class:`PartitionSpec` is the port's own small tuple type with the JAX
package's meaning: entry d names the mesh axis (or tuple of axes) that dim d
is split over, ``None`` for a whole dim; a spec shorter than the array
leaves the remaining dims whole. :func:`shard_slices` is the slice of an
array that the rank at given mesh coordinates holds: the block that
``jax.sharding.NamedSharding`` gives the device at those coordinates (a dim
split over a tuple of axes is cut row-major, the first axis the major one).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from .mesh import AXIS_DATA, AXIS_MODEL, Mesh

# Strategy tags for per-param rules
DP = "dp"               # replicate params, shard batch (pure data parallel)
TP_COLUMN = "tp_column"  # split output features over the model axis
TP_ROW = "tp_row"        # split input features over the model axis


class PartitionSpec(tuple):
    """``P("fsdp", "tp")``, ``P(("fsdp", "tp"), None)``, ``P()``: per-dim
    mesh axes, as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec names."""
        out = []
        for d in self:
            if d is None:
                continue
            out.extend(d if isinstance(d, tuple) else (d,))
        return tuple(out)


P = PartitionSpec


def replicated() -> PartitionSpec:
    return P()


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def dim_axes(spec: PartitionSpec, d: int) -> Tuple[str, ...]:
    """The axes dim ``d`` is split over (empty for a whole dim)."""
    if d >= len(spec) or spec[d] is None:
        return ()
    return spec[d] if isinstance(spec[d], tuple) else (spec[d],)


def shard_slices(shape, spec: PartitionSpec, mesh: Mesh) -> Tuple[slice, ...]:
    """The slice of an array of ``shape`` that ``mesh``'s rank holds under
    ``spec``; every dim a spec names must divide by its axes' size."""
    out = []
    for d, n in enumerate(shape):
        axes = dim_axes(spec, d)
        if not axes:
            out.append(slice(0, n))
            continue
        k = mesh.axis_size(axes)
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {axes} ({k})")
        i, step = mesh.axis_index(axes), n // k
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def is_replica_zero(spec: PartitionSpec, mesh: Mesh) -> bool:
    """Whether this rank holds the first copy of its block: coordinate 0 on
    every mesh axis the spec does not name (JAX's ``replica_id == 0``)."""
    named = set(spec.axes())
    return all(c == 0 for a, c in mesh.coords.items() if a not in named)


def _spec_for(w, strategy: str, model_axis: str) -> PartitionSpec:
    ndim = len(w.shape)
    if strategy == DP or ndim == 0:
        return P()
    if strategy == TP_COLUMN:
        # last dim = output features for [in,out] dense kernels; 1-D bias
        # follows its features
        return P(*([None] * (ndim - 1) + [model_axis]))
    if strategy == TP_ROW:
        if ndim == 1:
            return P()  # bias of a row-split layer is replicated (added post-psum)
        return P(*([model_axis] + [None] * (ndim - 1)))
    raise ValueError(strategy)


def _map_tree(fn, tree, prefix=""):
    if isinstance(tree, dict) or (hasattr(tree, "items") and not hasattr(tree, "shape")):
        return {k: _map_tree(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not is_spec(tree):
        return type(tree)(_map_tree(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


class ShardingRules:
    """Per-param strategy table with a default, evaluated over a param tree.

    ``rule_fn(path, leaf) -> strategy | PartitionSpec`` overrides; paths
    are '/'-joined key sequences (``"3/W"`` for MLN layer 3's kernel)."""

    def __init__(self, default: str = DP,
                 rule_fn: Optional[Callable[[str, Any], Any]] = None,
                 model_axis: str = AXIS_MODEL):
        self.default = default
        self.rule_fn = rule_fn
        self.model_axis = model_axis

    def spec_tree(self, params) -> Any:
        def spec(path, leaf):
            rule = self.rule_fn(path, leaf) if self.rule_fn else None
            if rule is None:
                rule = self.default
            if is_spec(rule):
                return rule
            return _spec_for(leaf, rule, self.model_axis)

        return _map_tree(spec, params)

    def shard_tree(self, params, mesh: Mesh):
        """(this rank's slices of ``params``, the specs applied). A dim not
        divisible by its mesh axis (a 2-class head over model=4) falls back
        to replicated, as in the JAX package."""
        specs = map_with_specs(lambda w, s: s if _divisible(w, s, mesh) else P(),
                               params, self.spec_tree(params))
        return map_with_specs(lambda w, s: w[shard_slices(w.shape, s, mesh)],
                              params, specs), specs


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree of one structure."""
    if is_spec(specs):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: map_with_specs(fn, tree[k], specs[k]) for k in specs}
    return type(specs)(map_with_specs(fn, t, s) for t, s in zip(tree, specs))


def _divisible(w, spec: PartitionSpec, mesh: Mesh) -> bool:
    for d in range(len(spec)):
        axes = dim_axes(spec, d)
        for ax in axes:
            if w.shape[d] % mesh.shape[ax] != 0:
                return False
    return True


def alternating_dense_rules(model_axis: str = AXIS_MODEL) -> ShardingRules:
    """Megatron pairing for MLN stacks: even dense layers column-split, odd
    row-split, so activations stay sharded through pairs with a single
    all-reduce per pair."""

    def rule(path: str, leaf):
        parts = path.split("/")
        if len(parts) >= 2 and parts[-1] in ("W", "b") and parts[0].isdigit():
            return TP_COLUMN if int(parts[0]) % 2 == 0 else TP_ROW
        return DP

    return ShardingRules(default=DP, rule_fn=rule, model_axis=model_axis)


def shard_params(params, mesh: Mesh, rules: Optional[ShardingRules] = None):
    """This rank's slices of a param tree per ``rules`` (default: every
    leaf whole)."""
    rules = rules or ShardingRules()
    placed, _ = rules.shard_tree(params, mesh)
    return placed


def batch_sharding(mesh: Mesh, data_axis: str = AXIS_DATA) -> PartitionSpec:
    """The canonical minibatch spec: leading (batch) dim split over the
    mesh's data axis, the rest whole; on a 1-axis mesh whose axis has
    another name, that axis; a multi-axis mesh without a data axis
    replicates the batch."""
    if data_axis in mesh.shape:
        return P(data_axis)
    if len(mesh.axis_names) == 1:
        return P(mesh.axis_names[0])
    return P()


def shard_batch(batch, mesh: Mesh, data_axis: str = AXIS_DATA):
    """This rank's rows of every leaf of ``batch`` (leading dim split over
    ``data_axis``)."""
    spec = P(data_axis)
    return _map_tree(lambda path, x: x[shard_slices(x.shape, spec, mesh)[:1]], batch)
