"""Cost attribution on the host: per-layer cost rows of a network, and the
min-max contiguous split of a layer chain into pipeline stages.

Counterpart of ``deeplearning4j_tpu/monitoring/costmodel.py``, its host
half: :func:`layer_costs` walks a MultiLayerNetwork or ComputationGraph
configuration (``Layer.flops_per_example``, 2 flops per multiply-add) into
rows of (flops, parameter bytes, activation bytes), and
:func:`balance_stages` / :func:`stage_costs` are the stage partitioner that
``parallel.pipeline`` takes its boundaries from. The functional
transformer's rows are ``models.transformer.layer_costs``.

The JAX package's other half reads a compiled XLA step (``xla_step_cost``,
``live_hbm_breakdown`` and ``cost_table``, the percentage table joined
against it); the port has no XLA executable, so those raise
``NotImplementedError`` naming ROADMAP.md item 8.6.

Everything here is host arithmetic on configurations and shapes: nothing
reads a device value.
"""

from __future__ import annotations

from typing import List, Optional

#: train-step flops ~ forward + backward; the backward of a matmul or a
#: convolution is two contractions of the forward's shape (dX and dW)
TRAIN_FLOPS_FACTOR = 3.0
#: layers without parameters only back-propagate dX
PARAMLESS_TRAIN_FACTOR = 2.0

_ITEM_8_6 = ("reads a compiled XLA step, which the port does not have: the device-side "
             "cost table is ROADMAP.md item 8.6")


# ------------------------------------------------------------ layer estimate


def _act_numel(out_type) -> float:
    n = float(out_type.flat_size())
    if out_type.kind == "rnn":
        n *= float(out_type.timeseries_length or 1)
    return n


def _tree_bytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree.values()))


def _row(name: str, kind: str, fwd_flops: float, batch: int, train: bool,
         has_params: bool, param_bytes: int, act_numel: float, dtype_bytes: int) -> dict:
    factor = 1.0
    if train:
        factor = TRAIN_FLOPS_FACTOR if has_params else PARAMLESS_TRAIN_FACTOR
    return {
        "layer": name,
        "kind": kind,
        "flops": float(fwd_flops) * batch * factor,
        "param_bytes": int(param_bytes),
        "activation_bytes": int(act_numel * batch * dtype_bytes),
    }


def layer_costs(net, batch: int, train: bool = True) -> List[dict]:
    """Per-layer cost rows of a MultiLayerNetwork or ComputationGraph:
    ``{layer, kind, flops, param_bytes, activation_bytes}`` per layer or
    node, the flops of ONE train (or inference) step at ``batch``; the JAX
    package's rows, key for key (a graph's vertices are elementwise over
    their output)."""
    dtype_bytes = net._dtype.itemsize
    params = net._params()
    conf = net.conf
    rows: List[dict] = []
    if hasattr(conf, "nodes"):  # ComputationGraph
        types = conf.infer_types()
        for name in conf.topo_order():
            node = conf.nodes[name]
            ins = [types[i] for i in node.inputs]
            it = ins[0] if ins else None
            if node.preprocessor is not None and it is not None:
                it = node.preprocessor.output_type(it)
            out = types[name]
            if node.layer is not None:
                fwd = node.layer.flops_per_example(it)
                kind = type(node.layer).__name__
                has_params = node.layer.has_params()
            else:
                fwd = _act_numel(out)
                kind = type(node.vertex).__name__
                has_params = False
            rows.append(_row(name, kind, fwd, batch, train, has_params,
                             _tree_bytes(params.get(name, {})), _act_numel(out), dtype_bytes))
        return rows
    for i, layer in enumerate(conf.layers):  # MultiLayerNetwork
        it = net._input_types[i]
        rows.append(_row(
            f"{i}:{type(layer).__name__}", type(layer).__name__,
            layer.flops_per_example(it), batch, train, layer.has_params(),
            _tree_bytes(params.get(str(i), {})), _act_numel(layer.output_type(it)),
            dtype_bytes))
    return rows


def cost_table(rows: List[dict], xla: Optional[dict] = None) -> dict:
    """The JAX package's percentage table over per-layer rows, joined
    against a compiled step's totals: not ported (nothing in the port
    reads it yet)."""
    raise NotImplementedError(f"cost_table {_ITEM_8_6}")


def xla_step_cost(fn, *args, **kwargs) -> dict:
    """The JAX package's ``cost_analysis()`` of a compiled step: not ported."""
    raise NotImplementedError(f"xla_step_cost {_ITEM_8_6}")


def live_hbm_breakdown(*args, **kwargs) -> dict:
    """The JAX package's live-buffer attribution: not ported."""
    raise NotImplementedError(f"live_hbm_breakdown {_ITEM_8_6}")


# ------------------------------------------------- pipeline stage balancing


def balance_stages(costs: List[float], n_stages: int) -> List[tuple]:
    """Min-max contiguous partition of per-layer ``costs`` into ``n_stages``
    stages: the linear-partition dynamic program, O(L^2 S) over host floats,
    exact and deterministic. Returns ``[(start, end), ...]`` half-open layer
    ranges, one per stage, none empty, covering [0, L). Of several optimal
    splits it keeps the one with the earliest cuts, so every rank derives
    the same boundaries from the same costs."""
    L, S = len(costs), int(n_stages)
    if S < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if L < S:
        raise ValueError(f"cannot split {L} layers into {S} non-empty pipeline stages")
    c = [float(x) for x in costs]
    if any(x < 0 for x in c):
        raise ValueError(f"negative layer cost in {c}")
    prefix = [0.0]
    for x in c:
        prefix.append(prefix[-1] + x)

    def span(i, j):  # cost of layers [i, j)
        return prefix[j] - prefix[i]

    # best[s][j]: the least max stage cost of layers [0, j) in s + 1 stages;
    # cut[s][j]: where the last of those stages starts
    best = [[float("inf")] * (L + 1) for _ in range(S)]
    cut = [[0] * (L + 1) for _ in range(S)]
    for j in range(1, L + 1):
        best[0][j] = span(0, j)
    for s in range(1, S):
        for j in range(s + 1, L + 1):
            for i in range(s, j):
                cand = max(best[s - 1][i], span(i, j))
                if cand < best[s][j]:  # strict: the earliest optimal cut
                    best[s][j] = cand
                    cut[s][j] = i
    bounds = []
    j = L
    for s in range(S - 1, -1, -1):
        i = cut[s][j] if s else 0
        bounds.append((i, j))
        j = i
    return list(reversed(bounds))


def stage_costs(costs: List[float], boundaries: List[tuple]) -> List[float]:
    """Predicted cost of each stage of ``boundaries`` over per-layer
    ``costs``: the prediction that measured stage times are held to."""
    return [float(sum(costs[a:b])) for a, b in boundaries]
