"""ComputationGraph — the DAG runtime.

Counterpart of ``deeplearning4j_tpu/nn/graph.py`` (DL4J's
``org.deeplearning4j.nn.graph.ComputationGraph``): named inputs, layer and
vertex nodes run in ``topo_order``, several outputs, flat params. Like the
port's ``MultiLayerNetwork`` it is an ``nn.Module``: each node's parameters
are an ``nn.ParameterDict`` in ``params_`` (layers, and vertices with
parameters such as ``AttentionVertex``), BatchNormalization's running
statistics are buffers in ``bn_state``, and the updater state is keyed
``"<node key>.<name>"``. A node's key in those ``nn.ModuleDict``s is its
name with ``%`` and ``.`` escaped (:func:`module_key`); everything else
(``params()``, the JSON, ``models.weights.cg_params_from_jax``) uses the
node's own name.

A train step is the JAX package's ``_step_body`` run eagerly: the loss of
every network output whose layer has ``compute_loss``, plus L1/L2 over the
layers' parameters (not the vertices'), its gradients, frozen layers'
gradients zeroed, gradient normalization, ``updater.apply`` and
``p -= u``, then the constraints. Under the precision policy's bf16 (on the
card) the graph runs on bf16 copies of the float32 masters; losses and BN
moments stay float32. As in the reference, the train step passes no
features mask, so a GlobalPoolingLayer or LastTimeStep in a graph pools
every step.

Random numbers follow the reference's derivation: a step's key is
``(seed ^ 0x5EED, iteration)``, a node's that key folded with the node's
index in the topological order, vertices counted.

Not ported yet: ``set_bucketing`` and ``set_device_ingest`` (ROADMAP.md
queue 1 item 8), the monitoring trace and watchdog hooks (item 8).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..common.device import resolve_device
from ..common.dtypes import to_torch
from ..common.precision import amp_enabled, cast_floating, cast_input, compute_dtype
from ..data.dataset import DataSet, MultiDataSet
from ..eval.evaluation import Evaluation
from .conf import BatchNormalization, GlobalPoolingLayer, LastTimeStep
from .constraints import apply_constraints
from .dropout import RngKey
from .graph_conf import ComputationGraphConfiguration
from .multilayer import _WEIGHT_NOISE_SALT, _BnState, _grad_normalize, _LazyScoreMixin, _mask_frozen

_RESERVED = frozenset(dir(nn.ModuleDict()))


def module_key(name: str) -> str:
    """A node name as an ``nn.ModuleDict`` key: ``%`` and ``.`` escaped as
    ``%25`` and ``%2E``, and the first character escaped where the name
    would shadow an attribute of the dict (``"train"`` → ``"%74rain"``).
    ``urllib.parse.unquote`` gives the name back."""
    key = name.replace("%", "%25").replace(".", "%2E")
    if key in _RESERVED:
        key = f"%{ord(key[0]):02X}{key[1:]}"
    return key


class ComputationGraph(_LazyScoreMixin, nn.Module):
    def __init__(self, conf: ComputationGraphConfiguration, *, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.conf = conf
        self.params_ = nn.ModuleDict()
        self.bn_state = nn.ModuleDict()
        self.updater_state: Dict[str, Any] = {}
        self.iteration = 0
        self.epoch = 0
        self.listeners: List[Any] = []
        self.score_ = float("nan")
        self.last_batch_size = 0
        self._dtype = to_torch(conf.dtype)
        self._topo = conf.topo_order()
        self._types = conf.infer_types()  # output type per node
        self._in_types = self._compute_in_types()
        self._keys = {name: module_key(name) for name in conf.nodes}

    def _compute_in_types(self):
        """Input InputType per node AFTER its preprocessor."""
        types = dict(self.conf.input_types)
        types.update(self._types)
        in_types = {}
        for name in self._topo:
            node = self.conf.nodes[name]
            its = [types[i] for i in node.inputs]
            it = its[0] if its else None
            if node.preprocessor is not None:
                it = node.preprocessor.output_type(it)
            in_types[name] = it
        return in_types

    # ------------------------------------------------------------------ init

    def init(self) -> "ComputationGraph":
        """Allocate parameters (layers', and vertices' with ``init_params``),
        BN state and the updater state, node by node in topological order.
        Weights are drawn on the CPU from a generator seeded with
        ``conf.seed`` (the same weights on every device), then moved to the
        graph's device."""
        g = torch.Generator().manual_seed(self.conf.seed)
        self.params_ = nn.ModuleDict()
        self.bn_state = nn.ModuleDict()
        for name in self._topo:
            node, key, it = self.conf.nodes[name], self._keys[name], self._in_types[name]
            p = None
            if node.layer is not None and node.layer.has_params():
                p = node.layer.init_params(g, it, self._dtype)
            if node.vertex is not None and hasattr(node.vertex, "init_params"):
                p = node.vertex.init_params(g, self._dtype)
            if p is not None:
                self.params_[key] = nn.ParameterDict(
                    {k: nn.Parameter(v.to(self.device)) for k, v in p.items()})
            if isinstance(node.layer, BatchNormalization):
                self.bn_state[key] = _BnState(node.layer.init_state(it, self._dtype, self.device))
        self.updater_state = self.conf.updater.init(self.params_)
        return self

    def _params(self):
        """{node name: {param name: tensor}} of the nodes with parameters."""
        return {name: dict(self.params_[key].items()) for name, key in self._keys.items()
                if key in self.params_}

    def _bn(self):
        return {name: {"mean": self.bn_state[key].mean, "var": self.bn_state[key].var}
                for name, key in self._keys.items() if key in self.bn_state}

    # -------------------------------------------------------------- forward

    def _forward(self, params, bn_state, inputs: Dict[str, torch.Tensor], *, training: bool,
                 rng, labels: Optional[Dict[str, torch.Tensor]] = None, lmasks=None,
                 fmask=None):
        """Evaluate the DAG. With labels: (total loss with L1/L2, new BN
        state); without: ({output name: activation}, new BN state)."""
        acts: Dict[str, torch.Tensor] = dict(inputs)
        new_bn = dict(bn_state)
        total_loss = 0.0
        for idx, name in enumerate(self._topo):
            node = self.conf.nodes[name]
            xs = [acts[i] for i in node.inputs]
            if node.preprocessor is not None:
                xs = [node.preprocessor.pre_process(xs[0], None)] + xs[1:]
            sub = rng.fold_in(idx) if rng is not None else None
            if node.vertex is not None:
                if hasattr(node.vertex, "init_params"):
                    acts[name] = node.vertex.apply(xs, params.get(name))
                else:
                    acts[name] = node.vertex.apply(xs)
                continue
            layer = node.layer
            p = params.get(name, {})
            if layer.weight_noise is not None and training:
                p = layer.weight_noise.apply(p, sub.fold_in(_WEIGHT_NOISE_SALT)
                                             if sub is not None else None, training)
            it = self._in_types[name]
            # a network output is a loss head only if its layer has a loss
            if (labels is not None and name in self.conf.network_outputs
                    and hasattr(layer, "compute_loss")):
                lm = lmasks.get(name) if lmasks else None
                total_loss = total_loss + layer.compute_loss(p, xs[0], labels[name], it,
                                                             training=training, rng=sub,
                                                             mask=lm)
                continue
            if isinstance(layer, BatchNormalization):
                out, nb = layer.forward_bn(p, new_bn[name], xs[0], it, training=training)
                new_bn[name] = nb
                acts[name] = out
            elif isinstance(layer, (LastTimeStep, GlobalPoolingLayer)):
                acts[name] = layer.forward(p, xs[0], it, training=training, rng=sub, mask=fmask)
            else:
                acts[name] = layer.forward(p, xs[0], it, training=training, rng=sub)
        if labels is None:
            return {o: acts[o] for o in self.conf.network_outputs}, new_bn
        # L1/L2 over the layers' parameters but those named "b" (BN's gamma
        # and beta are regularised); a vertex's parameters get none
        reg = 0.0
        for name, node in self.conf.nodes.items():
            pj = params.get(name)
            if not pj or node.layer is None:
                continue
            if node.layer.l2 > 0.0:
                reg = reg + node.layer.l2 * 0.5 * sum(torch.sum(torch.square(w))
                                                      for k, w in pj.items() if k != "b")
            if node.layer.l1 > 0.0:
                reg = reg + node.layer.l1 * sum(torch.sum(torch.abs(w))
                                                for k, w in pj.items() if k != "b")
        return total_loss + reg, new_bn

    # ------------------------------------------------------------- train step

    def _step(self, inputs, labels, lmasks, iteration):
        """One update at ``iteration`` (its random key and the updater's
        step); returns the loss, detached."""
        rng = RngKey((self.conf.seed ^ 0x5EED, int(iteration)))
        amp = amp_enabled(self._dtype, self.device)
        cdt = compute_dtype(self.device)
        params = self._params()
        with torch.enable_grad():
            pc = cast_floating(params, cdt) if amp else params
            xc = {k: cast_input(v, cdt) for k, v in inputs.items()} if amp else inputs
            loss, new_bn = self._forward(pc, self._bn(), xc, training=True, rng=rng,
                                         labels=labels, lmasks=lmasks)
            flat = [(name, k, p) for name, pd in params.items() for k, p in pd.items()]
            raw = torch.autograd.grad(loss, [p for _, _, p in flat], allow_unused=True)
        grads = {name: {} for name in params}
        for (name, k, p), g in zip(flat, raw):
            grads[name][k] = torch.zeros_like(p) if g is None else g
        frozen = {name for name, node in self.conf.nodes.items()
                  if node.layer is not None and node.layer.frozen}
        grads = _mask_frozen(grads, frozen)
        grads = _grad_normalize(grads, self.conf.gradient_normalization,
                                self.conf.gradient_normalization_threshold)
        named = {f"{self._keys[name]}.{k}": p for name, k, p in flat}
        grads = {f"{self._keys[name]}.{k}": g for name, v in grads.items() for k, g in v.items()}
        updates, self.updater_state = self.conf.updater.apply(
            grads, self.updater_state, named, iteration, self.epoch)
        with torch.no_grad():
            for key, p in named.items():
                p.sub_(updates[key])
            self._apply_constraints()
            for name, st in new_bn.items():
                self.bn_state[self._keys[name]].mean.copy_(st["mean"])
                self.bn_state[self._keys[name]].var.copy_(st["var"])
        return loss.detach()

    @torch.no_grad()
    def _apply_constraints(self):
        """Post-update constraint projection (parity with MultiLayerNetwork)."""
        for name, node in self.conf.nodes.items():
            key = self._keys[name]
            if node.layer is not None and node.layer.constraints and key in self.params_:
                pd = self.params_[key]
                for k, w in apply_constraints(dict(pd.items()), node.layer.constraints).items():
                    pd[k].copy_(w)

    # ------------------------------------------------------------------- fit

    def _coerce_inputs(self, features) -> Dict[str, torch.Tensor]:
        if isinstance(features, dict):
            return {k: self._put(v, self._dtype) for k, v in features.items()}
        if not isinstance(features, (list, tuple)):
            features = [features]
        return {name: self._put(f, self._dtype)
                for name, f in zip(self.conf.network_inputs, features)}

    def _coerce_labels(self, labels) -> Dict[str, torch.Tensor]:
        if isinstance(labels, dict):
            return {k: self._put(v) for k, v in labels.items()}
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        return {name: self._put(l) for name, l in zip(self.conf.network_outputs, labels)}

    def _batch(self, ds):
        """(inputs, labels, label masks) of a DataSet or MultiDataSet."""
        outs = self.conf.network_outputs
        if isinstance(ds, DataSet):
            lmasks = ({outs[0]: self._put(ds.labels_mask)}
                      if ds.labels_mask is not None else None)
            return self._coerce_inputs([ds.features]), self._coerce_labels([ds.labels]), lmasks
        lmasks = ({n: self._put(m) for n, m in zip(outs, ds.labels_masks)}
                  if ds.labels_masks else None)
        return (self._coerce_inputs(list(ds.features)), self._coerce_labels(list(ds.labels)),
                lmasks)

    def fit(self, data, labels=None, epochs: int = 1):
        """fit(DataSet | MultiDataSet | iterator of either) or
        fit(features, labels): arrays, lists of arrays in the order of the
        network's inputs and outputs, or dicts keyed by their names."""
        for _ in range(epochs):
            if isinstance(data, (DataSet, MultiDataSet)):
                self._fit_batch(*self._batch(data))
            elif hasattr(data, "__iter__") and not isinstance(
                    data, (np.ndarray, torch.Tensor, list, tuple, dict)):
                for ds in data:
                    self._fit_batch(*self._batch(ds))
            else:
                self._fit_batch(self._coerce_inputs(data), self._coerce_labels(labels), None)
            self.epoch += 1
        return self

    def _fit_batch(self, inputs, labels, lmasks):
        self.last_batch_size = int(next(iter(inputs.values())).shape[0])
        self.score_ = self._step(inputs, labels, lmasks, self.iteration)  # read on first use
        self.iteration += 1
        self._notify()

    def fit_scan(self, datasets) -> np.ndarray:
        """Fit a list of equal-shaped DataSets/MultiDataSets one step each,
        in order; returns the per-step losses (the JAX package runs them as
        one compiled scan; the steps and losses are the same)."""
        batches = [self._batch(ds) for ds in datasets]
        if not batches:
            return np.zeros(0, np.float32)
        has_lm = batches[0][2] is not None
        if any((lm is not None) != has_lm for _, _, lm in batches):
            raise ValueError("fit_scan: all datasets must agree on label masks")
        losses = [self._step(x, y, lm, self.iteration + k)
                  for k, (x, y, lm) in enumerate(batches)]
        self.last_batch_size = int(next(iter(batches[0][0].values())).shape[0])
        self.iteration += len(batches)
        self.score_ = losses[-1]
        self._notify()
        return torch.stack(losses).float().cpu().numpy()

    # --------------------------------------------------------------- output

    @torch.no_grad()
    def output(self, *features) -> List[torch.Tensor]:
        """Every network output's activations, in the order of
        ``network_outputs``, in inference mode and the model's dtype."""
        inputs = self._coerce_inputs(list(features) if len(features) > 1 else features[0])
        outs, _ = self._forward(self._params(), self._bn(), inputs, training=False, rng=None)
        return [outs[o] for o in self.conf.network_outputs]

    def output_single(self, features) -> torch.Tensor:
        return self.output(features)[0]

    @torch.no_grad()
    def score(self, ds=None) -> float:
        """The loss on a DataSet or MultiDataSet in inference mode (as in the
        reference, without its label masks); the last fit's without one."""
        if ds is None:
            return self.score_
        inputs, labels, _ = self._batch(ds)
        loss, _ = self._forward(self._params(), self._bn(), inputs, training=False, rng=None,
                                labels=labels)
        return float(loss)

    def evaluate(self, iterator) -> Evaluation:
        ev = Evaluation()
        for ds in iterator:
            ev.eval(ds.labels, self.output_single(ds.features), mask=ds.labels_mask)
        return ev

    def clone(self) -> "ComputationGraph":
        """A graph of the same configuration and device with copies of the
        parameters, BN state and updater state."""
        g = ComputationGraph(self.conf, device=self.device)
        g.init()
        with torch.no_grad():
            for (_, _, dst), (_, _, src) in zip(g._param_entries(), self._param_entries()):
                dst.copy_(src)
            for key, st in self.bn_state.items():
                g.bn_state[key].mean.copy_(st.mean)
                g.bn_state[key].var.copy_(st.var)
        g.updater_state = copy.deepcopy(self.updater_state)
        return g

    # --------------------------------------------------------- params flat view

    def _param_entries(self):
        """(node name, param name, tensor): nodes in topological order, each
        node's tensors by sorted name, as the reference's ``params()``."""
        for name in self._topo:
            key = self._keys[name]
            if key in self.params_:
                pd = self.params_[key]
                for pname in sorted(pd):
                    yield name, pname, pd[pname]

    @torch.no_grad()
    def params(self) -> torch.Tensor:
        chunks = [w.reshape(-1) for _, _, w in self._param_entries()]
        return (torch.cat(chunks) if chunks
                else torch.zeros((0,), dtype=self._dtype, device=self.device))

    def num_params(self) -> int:
        return sum(w.numel() for _, _, w in self._param_entries())

    @torch.no_grad()
    def set_params(self, flat) -> None:
        arr = (flat if isinstance(flat, torch.Tensor)
               else torch.as_tensor(np.asarray(flat))).reshape(-1)
        expected = self.num_params()
        if arr.numel() != expected:
            raise ValueError(f"param vector length {arr.numel()} != model numParams {expected}")
        off = 0
        for _, _, w in self._param_entries():
            n = w.numel()
            w.copy_(arr[off:off + n].reshape(w.shape).to(device=w.device, dtype=w.dtype))
            off += n

    setParams = set_params
