"""Cost and memory attribution — where the flops and device bytes go
(counterpart of the JAX package's ``monitoring/costmodel.py``).

- **attribution**: :func:`layer_costs` walks a MultiLayerNetwork or
  ComputationGraph configuration (``Layer.flops_per_example``, 2 flops per
  multiply-add) into rows of (flops, parameter bytes, activation bytes);
  ``models.transformer.layer_costs`` does the same for the functional
  transformer. These rows are the JAX package's, key for key.
- **ground truth**: :func:`xla_step_cost` (the JAX package's name) counts
  the flops of one step without running it: the step runs under
  ``FakeTensorMode`` (shapes only: no kernel launches, no device memory)
  inside ``torch.utils.flop_counter.FlopCounterMode``. A network's step
  updates its tensors in place, so a network is counted on a copy whose
  tensors are fake (``FakeCopyMode``); the network itself is left as it
  was. ``FlopCounterMode`` counts the products (matmuls, convolutions,
  attention); the flash operators ``tdl::flash_fwd``,
  ``tdl::flash_bwd_dq`` and ``tdl::flash_bwd_dkv`` count through formulas
  registered here from the kernels' own products. XLA's other keys
  (``bytes_accessed``, ``transcendentals``, the executable's memory
  analysis) have no counterpart and are left out of the dict, not zeroed.
  The count is of what the port computes: a convolution after an explicit
  SAME pad is counted over its padded input, where XLA counts only the
  taps inside the image.
- :func:`cost_table` joins the two into a percentage table whose
  ``coverage`` says how much of the counted step the per-layer estimate
  accounts for; :func:`publish` exports both as gauges.
- **device-memory breakdown**: :func:`live_hbm_breakdown` buckets tensors by
  identity over named trees (parameters, updater state, BN state) and puts
  the rest of ``torch.cuda.memory_allocated()`` under ``"other"`` (staged
  batches, activations, the allocator's other tensors). The JAX package
  walks ``jax.live_arrays()``; the port has no registry of live tensors, so
  "other" is the allocator's total less what the trees claim on the card,
  and on the CPU it is 0.
- :func:`balance_stages` / :func:`stage_costs` are the stage partitioner
  that ``parallel.pipeline`` takes its boundaries from.

The attribution is host arithmetic on configurations and shapes: nothing
reads a device value.
"""

from __future__ import annotations

import copy
import logging
import threading
from typing import Any, Dict, List, Optional

from ..common.debug import named_tensors
from .registry import MetricsRegistry, get_registry

log = logging.getLogger(__name__)

#: train-step flops ~ forward + backward; the backward of a matmul or a
#: convolution is two contractions of the forward's shape (dX and dW)
TRAIN_FLOPS_FACTOR = 3.0
#: layers without parameters only back-propagate dX
PARAMLESS_TRAIN_FACTOR = 2.0



def cost_metrics(registry: Optional[MetricsRegistry] = None):
    """Get-or-create the cost-observatory gauge families (one declaration
    site so benches, tests and docs agree on names + labels)."""
    r = registry or get_registry()
    return {
        "flops": r.gauge(
            "tdl_model_flops_per_step",
            "Floating-point ops of one train step (counted under fake tensors "
            "when measured, else the per-layer estimate)", labels=("model",)),
        "peak": r.gauge(
            "tdl_hbm_peak_bytes",
            "Peak device bytes of one compiled step: arguments + outputs + "
            "temp allocations, donated aliases counted once",
            labels=("model",)),
        "layer": r.gauge(
            "tdl_layer_cost_info",
            "Estimated train-step flops attributed to one layer",
            labels=("model", "layer", "kind")),
        "hbm": r.gauge(
            "tdl_hbm_bytes",
            "Live device bytes bucketed by what holds them "
            "(params / opt_state / bn_state / other)",
            labels=("model", "kind")),
    }


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
    """Percentage table over per-layer rows, optionally joined against the
    counted step's totals (:func:`xla_step_cost`). ``coverage`` = estimated
    total / counted total — how much of the real step the attribution
    accounts for."""
    total = sum(r["flops"] for r in rows)
    table = {
        "layers": [{**r, "pct": round(100.0 * r["flops"] / total, 2)
                    if total else 0.0} for r in rows],
        "total_flops": total,
        "param_bytes": sum(r["param_bytes"] for r in rows),
        "activation_bytes": sum(r["activation_bytes"] for r in rows),
    }
    if xla is not None:
        table["xla"] = xla
        if xla.get("flops"):
            table["coverage"] = round(total / xla["flops"], 4)
    return table


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


# ------------------------------------------------------------ counted step

_FORMULAS_LOCK = threading.Lock()
_FORMULAS_DONE = False


def _live_pairs(Tq: int, Tk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs a flash kernel multiplies: all Tq x Tk, or under
    ``causal`` those with key <= q_offset + query."""
    if not causal:
        return Tq * Tk
    return sum(min(Tk, max(0, i + q_offset + 1)) for i in range(Tq))


def register_flash_flop_formulas() -> None:
    """Register ``FlopCounterMode`` formulas for the flash operators, from
    the kernels' own products per live (query, key) pair and head dim D:
    the forward S = QK^T and PV (4D flops); dkv recomputes S and forms dP =
    dO V^T, dV = P^T dO and dK = dS^T Q (8D); dq recomputes S and dP and
    forms dQ = dS K (6D) plus delta = rowsum(dO · out) (2D per row). Once
    per process."""
    global _FORMULAS_DONE
    with _FORMULAS_LOCK:
        if _FORMULAS_DONE:
            return
        import torch
        from torch.utils.flop_counter import register_flop_formula

        from ..kernels import attention  # noqa: F401  (defines the tdl operators)

        def per_pair(q, k, causal, q_offset):
            B, H, Tq, D = q
            return B * H * D * _live_pairs(Tq, k[2], bool(causal), int(q_offset))

        @register_flop_formula(torch.ops.tdl.flash_fwd)
        def _fwd(q, k, v, qseg, kseg, causal, scale, q_offset, block_q, *a,
                 out_shape=None, **kw) -> int:
            return 4 * per_pair(q, k, causal, q_offset)

        @register_flop_formula(torch.ops.tdl.flash_bwd_dkv)
        def _dkv(q, k, v, do, lse, delta, qseg, kseg, causal, scale, q_offset, *a,
                 out_shape=None, **kw) -> int:
            return 8 * per_pair(q, k, causal, q_offset)

        @register_flop_formula(torch.ops.tdl.flash_bwd_dq)
        def _dq(q, k, v, out, do, lse, qseg, kseg, causal, scale, q_offset, *a,
                out_shape=None, **kw) -> int:
            B, H, Tq, D = q
            return 6 * per_pair(q, k, causal, q_offset) + 2 * B * H * Tq * D

        _FORMULAS_DONE = True


def _is_network(fn) -> bool:
    return hasattr(fn, "_step") and hasattr(fn, "conf") and hasattr(fn, "params_")


def step_flop_counts(fn, *args, **kwargs) -> Dict[str, int]:
    """Flops of one call ``fn(*args, **kwargs)`` by operator (``aten.mm``,
    ``tdl.flash_fwd``, ...), counted without running it: nothing executes
    on the device and no tensor of the caller changes.

    ``fn`` is a step function (the functional transformer's
    ``make_train_step`` result, any callable over tensors), called on fake
    copies of the tensors in ``args``/``kwargs``; or a MultiLayerNetwork /
    ComputationGraph, whose train step ``_step(*args)`` (features, labels,
    masks, iteration) runs on a copy of the network with fake tensors — its
    step updates parameters, updater and BN state in place, which the copy
    absorbs."""
    import torch
    from torch._subclasses.fake_tensor import FakeCopyMode, FakeTensorMode
    from torch.utils._pytree import tree_map
    from torch.utils.flop_counter import FlopCounterMode

    register_flash_flop_formulas()
    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(t):
        return mode.from_tensor(t) if isinstance(t, torch.Tensor) else t

    if _is_network(fn):
        # share what a step only reads and need not copy: the configuration
        # and the listeners
        memo = {id(fn.conf): fn.conf, id(fn.listeners): []}
        with FakeCopyMode(mode):
            target = copy.deepcopy(fn, memo)
        call = target._step
    else:
        call = fn
    fargs, fkwargs = tree_map(fake, (list(args), dict(kwargs)))
    with mode, FlopCounterMode(display=False) as counter:
        call(*fargs, **fkwargs)
    return {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}


def xla_step_cost(fn, *args, **kwargs) -> dict:
    """The counterpart of the JAX package's ahead-of-time
    ``cost_analysis()`` of a step: ``{"flops": ...}`` of one call, counted
    by :func:`step_flop_counts` (same arguments). XLA's byte,
    transcendental and memory-analysis keys have no counterpart and are
    absent (module docstring)."""
    return {"flops": float(sum(step_flop_counts(fn, *args, **kwargs).values()))}


# ------------------------------------------------------------- HBM breakdown


def live_hbm_breakdown(state_trees: Dict[str, Any], model: str = "model",
                       registry: Optional[MetricsRegistry] = None) -> Dict[str, int]:
    """Bucket device bytes by WHAT holds them: each named tree in
    ``state_trees`` (e.g. ``{"params": ..., "opt_state": ...}``; dicts,
    lists, tensors and modules) claims its tensors by identity, the first
    tree to name a tensor owning it; ``"other"`` is
    ``torch.cuda.memory_allocated()`` less what the trees hold on the card
    (0 on the CPU, or where CUDA is not initialised). Published as
    ``tdl_hbm_bytes{model,kind}``."""
    import sys

    seen = set()
    out: Dict[str, int] = {k: 0 for k in state_trees}
    on_card = 0
    for kind, tree in state_trees.items():
        for _, t in named_tensors(tree):
            if id(t) in seen:
                continue
            seen.add(id(t))
            n = t.numel() * t.element_size()
            out[kind] += n
            if t.is_cuda:
                on_card += n
    torch = sys.modules.get("torch")
    out["other"] = 0
    if torch is not None and torch.cuda.is_initialized():
        out["other"] = max(0, int(torch.cuda.memory_allocated()) - on_card)
    gauge = cost_metrics(registry)["hbm"]
    for kind, b in out.items():
        gauge.labels(model, kind).set(b)
    return out


def net_hbm_breakdown(net, model: str = "model",
                      registry: Optional[MetricsRegistry] = None) -> Dict[str, int]:
    """:func:`live_hbm_breakdown` over a network's params / optimizer state /
    bn state trees."""
    return live_hbm_breakdown(
        {"params": net.params_, "opt_state": net.updater_state,
         "bn_state": getattr(net, "bn_state", {})},
        model=model, registry=registry)


# ------------------------------------------------------------------ publish


def publish(model: str, rows: List[dict], xla: Optional[dict] = None,
            registry: Optional[MetricsRegistry] = None) -> dict:
    """Export one model's cost attribution as gauges and return the joined
    :func:`cost_table`. ``tdl_model_flops_per_step`` carries the counted
    total when available (the estimate otherwise); ``tdl_layer_cost_info``
    carries the per-layer estimates the table is built from."""
    m = cost_metrics(registry)
    table = cost_table(rows, xla)
    m["flops"].labels(model).set(
        (xla or {}).get("flops") or table["total_flops"])
    if (xla or {}).get("peak_bytes"):
        m["peak"].labels(model).set(xla["peak_bytes"])
    for r in rows:
        m["layer"].labels(model, r["layer"], r["kind"]).set(r["flops"])
    return table
