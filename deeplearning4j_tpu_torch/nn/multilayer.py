"""MultiLayerNetwork — the sequential-stack runtime.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` (DL4J's
``org.deeplearning4j.nn.multilayer.MultiLayerNetwork``). The network is an
``nn.Module``: its parameters sit in ``params_``, an ``nn.ModuleDict`` of
per-layer ``nn.ParameterDict``s keyed by the layer index as in the JAX
package (``"0"``, ``"1"``, ...), the BatchNormalization running statistics
are buffers (``bn_state[i].mean``/``.var``), and the updater state is the
port's ``nn.updaters`` state keyed ``"<layer>.<name>"``.

A train step is the JAX package's ``_step_body`` run eagerly: the loss
(with L1/L2) and its gradients, frozen layers' gradients zeroed, gradient
normalization, ``updater.apply`` and ``p -= u``, then the constraints.
Under a data-parallel trainer (``parallel.trainer``) the step is one
logical step over the ranks: the gradients and the loss are reduced across
the data group right after ``autograd.grad`` (``common.data_parallel``).
With the precision policy's bf16 on the card (``common.precision``), the
forward and backward run on bf16 copies of the float32 masters; losses and
BN moments stay float32. ``fit`` takes an iterator, a ``DataSet`` or
arrays, and runs truncated BPTT when the configuration asks for it.

Random numbers follow the JAX package's derivation, with generators in
place of keys: a step's key is ``(seed ^ 0x5EED, iteration)``, a layer's
that key folded with its index (:class:`~.dropout.RngKey`).

Not ported yet: ``set_bucketing`` and ``set_device_ingest`` (ROADMAP.md
queue 1 item 8), the monitoring trace and watchdog hooks (item 8). Checkpoints of the network are ``serde.checkpoint`` and
``serde.model_serializer``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..common import data_parallel
from ..common.device import resolve_device
from ..common.dtypes import to_torch
from ..common.precision import amp_enabled, cast_floating, cast_input, compute_dtype
from ..data.dataset import DataSet
from ..data.iterators import ArrayDataSetIterator, DataSetIterator, ListDataSetIterator
from ..eval.evaluation import Evaluation, RegressionEvaluation
from .attention_layers import (LearnedSelfAttentionLayer, RecurrentAttentionLayer,
                               SelfAttentionLayer)
from .conf import (BatchNormalization, GlobalPoolingLayer, LastTimeStep, LSTM,
                   MultiLayerConfiguration)
from .constraints import apply_constraints
from .dropout import RngKey

_MASKED_LAYERS = (LastTimeStep, GlobalPoolingLayer, SelfAttentionLayer, LearnedSelfAttentionLayer,
                  RecurrentAttentionLayer)
_WEIGHT_NOISE_SALT = 0x9015E


def _mask_frozen(grads, frozen):
    """FrozenLayer semantics: zero the gradients of frozen layers (their
    updater still runs, on zeros, as in the JAX package)."""
    if not frozen:
        return grads
    return {k: ({n: torch.zeros_like(g) for n, g in v.items()} if k in frozen else v)
            for k, v in grads.items()}


def reduce_nested(dp, grads, loss, weight):
    """{layer: {name: gradient}} and the loss of this rank's step as the
    data group's (``DataParallelContext.reduce_step``)."""
    flat, loss = dp.reduce_step({(si, k): g for si, v in grads.items() for k, g in v.items()},
                                loss, weight)
    out = {si: {} for si in grads}
    for (si, k), g in flat.items():
        out[si][k] = g
    return out, loss


def constrain(pd, layer: str, constraints, shards=None) -> None:
    """Apply ``constraints`` to one layer's parameters ``pd`` in place; a
    partitioned network's (``shards``) are gathered first and each rank
    keeps its block of the result."""
    whole = dict(pd.items()) if shards is None else shards.whole(layer, pd)
    for k, w in apply_constraints(whole, constraints).items():
        pd[k].copy_(w if shards is None else shards.block(layer, k, w))


def _layer_norm(layer_grads):
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in layer_grads.values()) + 1e-12)


def _grad_normalize(grads, kind: Optional[str], threshold: float):
    """org.deeplearning4j.nn.conf.GradientNormalization semantics on
    {layer: {name: grad}}."""
    if kind is None:
        return grads
    if kind == "ClipElementWiseAbsoluteValue":
        return {k: {n: torch.clamp(g, -threshold, threshold) for n, g in v.items()}
                for k, v in grads.items()}
    if kind == "ClipL2PerLayer":
        def clip(v):
            if not v:
                return v
            scale = torch.clamp(threshold / _layer_norm(v), max=1.0)
            return {n: g * scale for n, g in v.items()}

        return {k: clip(v) for k, v in grads.items()}
    if kind == "ClipL2PerParamType":
        return {k: {n: g * torch.clamp(threshold / torch.sqrt(torch.sum(torch.square(g)) + 1e-12),
                                       max=1.0)
                    for n, g in v.items()} for k, v in grads.items()}
    if kind == "RenormalizeL2PerLayer":
        return {k: ({n: g / _layer_norm(v) for n, g in v.items()} if v else v)
                for k, v in grads.items()}
    raise ValueError(f"unknown gradient normalization {kind}")


class _BnState(nn.Module):
    """One BatchNormalization layer's running statistics, as buffers."""

    def __init__(self, state):
        super().__init__()
        self.register_buffer("mean", state["mean"])
        self.register_buffer("var", state["var"])


class _LazyScoreMixin:
    """What MultiLayerNetwork and ComputationGraph share: ``score_`` keeps the
    loss tensor of the last fit and reads it as a float on first use (so fit()
    does not wait for the card every batch), inputs are put on the network's
    device, and the iteration listeners are told of each step."""

    @property
    def score_(self) -> float:
        v = self.__dict__["_score_v"]
        if not isinstance(v, float):
            v = float(v)
            self.__dict__["_score_v"] = v
        return v

    @score_.setter
    def score_(self, v):
        self.__dict__["_score_v"] = float(v) if isinstance(v, (int, float)) else v

    #: set by ``parallel.partition.Partitioner.partition_net``: this rank
    #: holds blocks of the parameters and updater state
    _partition = None

    def _whole_params(self, what: str):
        """``_params()`` where ``what`` needs whole tensors: a partitioned
        network raises (its blocks are not the parameters)."""
        if self._partition is not None:
            raise RuntimeError(
                f"{what} on a partitioned network: each rank holds blocks of its "
                "parameters; gather them with net._partition.gather_state(net), or "
                "restore a checkpoint into a network without a partitioner")
        return self._params()

    def _put(self, arr, dtype=None):
        """An input array as a tensor on the network's device (float64
        becomes float32, as ``jnp.asarray`` makes it)."""
        if arr is None:
            return None
        t = torch.as_tensor(arr)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        elif t.dtype == torch.float64:
            t = t.float()
        return t.to(self.device)

    def _notify(self):
        for lst in self.listeners:
            if hasattr(lst, "iteration_done"):
                lst.iteration_done(self, self.iteration, self.epoch)

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)

    setListeners = add_listeners

    def set_bucketing(self, spec):
        raise NotImplementedError("set_bucketing: shape bucketing of the fit paths is not "
                                  "ported yet (ROADMAP.md queue 1 item 8)")

    def set_device_ingest(self, fn):
        raise NotImplementedError("set_device_ingest: on-device input ingest is not ported "
                                  "yet (ROADMAP.md queue 1 item 8)")


class MultiLayerNetwork(_LazyScoreMixin, nn.Module):
    def __init__(self, conf: MultiLayerConfiguration, *, device="cuda"):
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
        self._rnn_state: Dict[str, Any] = {}  # streaming rnnTimeStep state
        # set by the data-parallel trainers for the duration of a fit
        # (common.data_parallel); None: a one-process step
        self._data_parallel = None
        self._input_types = conf.input_types()
        self._dtype = to_torch(conf.dtype)

    # ------------------------------------------------------------------ init

    def init(self) -> "MultiLayerNetwork":
        """Allocate parameters, BN state and the updater state. Weights are
        drawn on the CPU from a generator seeded with ``conf.seed`` (the
        same weights on every device), then moved to the network's device."""
        g = torch.Generator().manual_seed(self.conf.seed)
        self.params_ = nn.ModuleDict()
        self.bn_state = nn.ModuleDict()
        for i, layer in enumerate(self.conf.layers):
            it = self._input_types[i]
            if layer.has_params():
                p = layer.init_params(g, it, self._dtype)
                self.params_[str(i)] = nn.ParameterDict(
                    {k: nn.Parameter(v.to(self.device)) for k, v in p.items()})
            if isinstance(layer, BatchNormalization):
                self.bn_state[str(i)] = _BnState(layer.init_state(it, self._dtype, self.device))
        self.updater_state = self.conf.updater.init(self.params_)
        return self

    def _params(self):
        return {si: dict(pd.items()) for si, pd in self.params_.items()}

    def _bn(self):
        return {si: {"mean": m.mean, "var": m.var} for si, m in self.bn_state.items()}

    # -------------------------------------------------------------- forward

    def _forward(self, params, bn_state, x, *, training: bool, rng, fmask=None, rnn_states=None,
                 collect=False):
        """Forward over all layers but the last; returns (activations|last,
        new_bn_state, new_rnn_states)."""
        new_bn = dict(bn_state)
        new_rnn = {}
        acts = []
        h = x
        for i, layer in enumerate(self.conf.layers[:-1]):
            h = self._apply_layer(i, layer, params, new_bn, h, self._input_types[i], training,
                                  rng, fmask, rnn_states, new_rnn)
            if collect:
                acts.append(h)
        return (acts if collect else h), new_bn, new_rnn

    def _apply_layer(self, i, layer, params, new_bn, h, it, training, rng, fmask, rnn_states,
                     new_rnn):
        si = str(i)
        if i in self.conf.preprocessors:
            h = self.conf.preprocessors[i].pre_process(h, it)
        p = params.get(si, {})
        sub = rng.fold_in(i) if rng is not None else None
        if layer.weight_noise is not None and training:
            p = layer.weight_noise.apply(p, sub.fold_in(_WEIGHT_NOISE_SALT)
                                         if sub is not None else None, training)
        if isinstance(layer, BatchNormalization):
            out, nb = layer.forward_bn(p, new_bn[si], h, it, training=training)
            new_bn[si] = nb
            return out
        if isinstance(layer, LSTM) and rnn_states is not None and si in rnn_states:
            h0, c0 = rnn_states[si]
            out, hT, cT = layer.forward_with_state(p, h, h0, c0)
            new_rnn[si] = (hT, cT)
            return out
        if isinstance(layer, _MASKED_LAYERS):
            return layer.forward(p, h, it, training=training, rng=sub, mask=fmask)
        return layer.forward(p, h, it, training=training, rng=sub)

    def _loss_fn(self, params, bn_state, x, y, fmask, lmask, rng, training: bool,
                 rnn_states=None):
        h, new_bn, new_rnn = self._forward(params, bn_state, x, training=training, rng=rng,
                                           fmask=fmask, rnn_states=rnn_states)
        i = len(self.conf.layers) - 1
        it = self._input_types[i]
        if i in self.conf.preprocessors:
            h = self.conf.preprocessors[i].pre_process(h, it)
        sub = rng.fold_in(i) if rng is not None else None
        loss = self.conf.layers[i].compute_loss(params.get(str(i), {}), h, y, it,
                                                training=training, rng=sub, mask=lmask)
        # L1/L2 (BaseLayer.calcRegularizationScore, part of the score): every
        # parameter but those named "b" (BN's gamma and beta are regularised)
        reg = 0.0
        for j, layer in enumerate(self.conf.layers):
            pj = params.get(str(j))
            if not pj:
                continue
            if layer.l2 > 0.0:
                reg = reg + layer.l2 * 0.5 * sum(torch.sum(torch.square(w))
                                                 for k, w in pj.items() if k != "b")
            if layer.l1 > 0.0:
                reg = reg + layer.l1 * sum(torch.sum(torch.abs(w))
                                           for k, w in pj.items() if k != "b")
        return loss + reg, (new_bn, new_rnn)

    # ------------------------------------------------------------- train step

    def _step(self, x, y, fmask, lmask, iteration, rnn_states=None):
        """One update at ``iteration`` (its random key and the updater's
        step): returns (loss, new rnn states), both detached."""
        rng = self._step_rng(iteration)
        amp = amp_enabled(self._dtype, self.device)
        cdt = compute_dtype(self.device)
        params = self._params()
        dp = self._data_parallel
        # a partitioned network (parallel.partition) holds blocks: the step
        # runs on the whole tensors and updates the blocks
        shards = getattr(dp, "shards", None)
        live = shards.gather(params) if shards is not None else params
        with torch.enable_grad(), data_parallel.use(dp):
            pc = cast_floating(live, cdt) if amp else live
            xc = cast_input(x, cdt) if amp else x
            loss, (new_bn, new_rnn) = self._loss_fn(pc, self._bn(), xc, y, fmask, lmask, rng,
                                                    True, rnn_states)
            weight = dp.loss_weight(lmask) if dp is not None else None
            flat = [(si, k, p) for si, pd in live.items() for k, p in pd.items()]
            raw = torch.autograd.grad(loss if weight is None else loss * weight,
                                      [p for _, _, p in flat], allow_unused=True)
        grads = {si: {} for si in params}
        for (si, k, p), g in zip(flat, raw):
            grads[si][k] = torch.zeros_like(p) if g is None else g
        if dp is not None:
            grads, loss = reduce_nested(dp, grads, loss, weight)
        frozen = {str(i) for i, l in enumerate(self.conf.layers) if l.frozen}
        grads = _mask_frozen(grads, frozen)
        grads = _grad_normalize(grads, self.conf.gradient_normalization,
                                self.conf.gradient_normalization_threshold)
        if shards is not None:
            grads = shards.keep(grads)
        named = {f"{si}.{k}": p for si, pd in params.items() for k, p in pd.items()}
        grads = {f"{si}.{k}": g for si, v in grads.items() for k, g in v.items()}
        updates, self.updater_state = self.conf.updater.apply(
            grads, self.updater_state, named, iteration, self.epoch)
        with torch.no_grad():
            for name, p in named.items():
                p.sub_(updates[name])
            self._apply_constraints(shards)
            for si, st in new_bn.items():
                self.bn_state[si].mean.copy_(st["mean"])
                self.bn_state[si].var.copy_(st["var"])
        new_rnn = {si: (h.detach(), c.detach()) for si, (h, c) in new_rnn.items()}
        return loss.detach(), new_rnn

    @torch.no_grad()
    def _apply_constraints(self, shards=None):
        """Post-update constraint projection (BaseConstraint.applyConstraint);
        on a partitioned network, of the whole tensors (a norm spans every
        block)."""
        for i, layer in enumerate(self.conf.layers):
            si = str(i)
            if layer.constraints and si in self.params_:
                constrain(self.params_[si], si, layer.constraints, shards)

    def _step_rng(self, iteration):
        return RngKey((self.conf.seed ^ 0x5EED, int(iteration)))

    # ------------------------------------------------------------------- fit

    def fit(self, data, labels=None, epochs: int = 1, batch_size: Optional[int] = None):
        """fit(DataSetIterator) | fit(DataSet) | fit(features, labels)."""
        if isinstance(data, DataSetIterator):
            it = data
        elif isinstance(data, DataSet):
            it = ListDataSetIterator([data])
        else:
            f = data.numpy() if hasattr(data, "numpy") else np.asarray(data)
            l = labels.numpy() if hasattr(labels, "numpy") else np.asarray(labels)
            it = ArrayDataSetIterator(f, l, batch_size or f.shape[0])
        for _ in range(epochs):
            for ds in it:
                self._fit_batch(ds)
            self.epoch += 1
            for lst in self.listeners:
                if hasattr(lst, "on_epoch_end"):
                    lst.on_epoch_end(self)
        return self

    def fit_scan(self, datasets) -> np.ndarray:
        """Fit a list of equal-shaped DataSets one step each, in order;
        returns the per-step losses (the JAX package runs them as one
        compiled scan; the steps and losses are the same)."""
        if self.conf.backprop_type == "TruncatedBPTT" and self.conf.tbptt_fwd_length > 0:
            raise ValueError("fit_scan: use fit() — tbptt already scan-fuses")
        datasets = list(datasets)
        if not datasets:
            return np.zeros(0, np.float32)
        has_fm = datasets[0].features_mask is not None
        has_lm = datasets[0].labels_mask is not None
        for ds in datasets[1:]:
            if (ds.features_mask is not None) != has_fm or \
                    (ds.labels_mask is not None) != has_lm:
                raise ValueError("fit_scan: all datasets must agree on "
                                 "features/labels masks")
        losses = []
        for k, ds in enumerate(datasets):
            loss, _ = self._step(self._put(ds.features, self._dtype), self._put(ds.labels),
                                 self._put(ds.features_mask), self._put(ds.labels_mask),
                                 self.iteration + k)
            losses.append(loss)
        self.last_batch_size = int(datasets[0].features.shape[0])
        self.iteration += len(datasets)
        self.score_ = losses[-1]
        self._notify()
        return torch.stack(losses).float().cpu().numpy()

    def _fit_batch(self, ds: DataSet):
        if self.conf.backprop_type == "TruncatedBPTT" and self.conf.tbptt_fwd_length > 0:
            self._fit_tbptt(ds)
            return
        x = self._put(ds.features, self._dtype)
        self.last_batch_size = int(x.shape[0])
        loss, _ = self._step(x, self._put(ds.labels), self._put(ds.features_mask),
                             self._put(ds.labels_mask), self.iteration)
        self.score_ = loss  # read as a float on first use
        self.iteration += 1
        self._notify()

    def _fit_tbptt(self, ds: DataSet):
        """Truncated BPTT (MultiLayerNetwork fitHelper's tbptt path): the time
        axis is padded to a multiple of ``tbptt_fwd_length`` (labels mask 0
        on the padding) and split into segments; one update per segment,
        with the LSTM states carried across segments, detached. As in the
        JAX package, every segment of one fit uses the fit's iteration and
        random key. The fit's score is the segments' losses weighted by
        their unmasked steps."""
        fwd = self.conf.tbptt_fwd_length
        x_all = self._put(ds.features, self._dtype)
        y_all = self._put(ds.labels)
        B, T = x_all.shape[0], x_all.shape[-1]
        if ds.labels_mask is None:
            lm_all = torch.ones((B, T), dtype=torch.float32, device=self.device)
        else:
            lm_all = self._put(ds.labels_mask, torch.float32)
            if lm_all.dim() == 1:  # a per-example [B] mask masks every step of its row
                lm_all = lm_all[:, None].expand(B, T)
        fm_all = None if ds.features_mask is None else self._put(ds.features_mask, torch.float32)
        pad = (-T) % fwd
        if pad:
            padt = lambda a: torch.nn.functional.pad(a, (0, pad))  # noqa: E731
            x_all, y_all, lm_all = padt(x_all), padt(y_all), padt(lm_all)
            fm_all = None if fm_all is None else padt(fm_all)
        S = x_all.shape[-1] // fwd
        seg_weights = lm_all.reshape(B, S, fwd).sum(dim=(0, 2))
        if self._data_parallel is not None:  # the global batch's steps
            seg_weights = self._data_parallel.all_reduce_sum(seg_weights)
        seg = lambda a, s: a[..., s * fwd:(s + 1) * fwd]  # noqa: E731
        rnn_states = self._zero_rnn_states(B)
        self.last_batch_size = B
        losses = []
        for s in range(S):
            loss, rnn_states = self._step(seg(x_all, s), seg(y_all, s),
                                          None if fm_all is None else seg(fm_all, s),
                                          seg(lm_all, s), self.iteration, rnn_states)
            losses.append(loss.float())
        losses = torch.stack(losses)
        wt = seg_weights.sum()
        self.score_ = torch.where(wt > 0, (losses * seg_weights).sum() / wt.clamp(min=1e-12),
                                  losses[-1])
        self.iteration += 1
        self._notify()

    def _zero_rnn_states(self, batch: int):
        states = {}
        for i, layer in enumerate(self.conf.layers):
            if isinstance(layer, LSTM):
                z = torch.zeros((batch, layer.n_out), dtype=self._dtype, device=self.device)
                states[str(i)] = (z, z)
        return states

    # --------------------------------------------------------------- output

    def _head_forward(self, params, h):
        """Final layer (preprocessor + forward) applied to the last hidden state."""
        i = len(self.conf.layers) - 1
        it = self._input_types[i]
        if i in self.conf.preprocessors:
            h = self.conf.preprocessors[i].pre_process(h, it)
        return self.conf.layers[i].forward(params.get(str(i), {}), h, it, training=False,
                                           rng=None)

    @torch.no_grad()
    def output(self, x, training: bool = False) -> torch.Tensor:
        """Forward to the final layer's activations (MultiLayerNetwork.output),
        in inference mode and the model's dtype."""
        params = self._whole_params("output()")
        h, _, _ = self._forward(params, self._bn(), self._put(x, self._dtype), training=False,
                                rng=None)
        return self._head_forward(params, h)

    @torch.no_grad()
    def feed_forward(self, x) -> List[torch.Tensor]:
        """All layer activations (MultiLayerNetwork.feedForward)."""
        params = self._whole_params("feed_forward()")
        xj = self._put(x, self._dtype)
        acts, _, _ = self._forward(params, self._bn(), xj, training=False, rng=None,
                                   collect=True)
        return acts + [self._head_forward(params, acts[-1] if acts else xj)]

    @torch.no_grad()
    def score(self, ds: Optional[DataSet] = None) -> float:
        """Score = loss on dataset (Model.score), in inference mode."""
        if ds is None:
            return self.score_
        loss, _ = self._loss_fn(self._whole_params("score()"), self._bn(),
                                self._put(ds.features, self._dtype),
                                self._put(ds.labels), self._put(ds.features_mask),
                                self._put(ds.labels_mask), None, False)
        return float(loss)

    # ----------------------------------------------------------- rnn streaming

    @torch.no_grad()
    def rnn_time_step(self, x) -> torch.Tensor:
        """Streaming inference with persistent hidden state
        (MultiLayerNetwork.rnnTimeStep); a [B, C] input is one step."""
        xj = self._put(x, self._dtype)
        if xj.dim() == 2:
            xj = xj[:, :, None]
        if not self._rnn_state:
            self._rnn_state = self._zero_rnn_states(xj.shape[0])
        params, bn = self._whole_params("rnn_time_step()"), self._bn()
        new_rnn = {}
        h = xj
        for i, layer in enumerate(self.conf.layers[:-1]):
            h = self._apply_layer(i, layer, params, dict(bn), h, self._input_types[i], False,
                                  None, None, self._rnn_state, new_rnn)
        self._rnn_state = new_rnn
        return self._head_forward(params, h)

    def rnn_clear_previous_state(self):
        self._rnn_state = {}

    # ------------------------------------------------------------- evaluation

    def evaluate(self, iterator: DataSetIterator) -> Evaluation:
        ev = Evaluation()
        for ds in iterator:
            ev.eval(ds.labels, self.output(ds.features), mask=ds.labels_mask)
        return ev

    def evaluate_regression(self, iterator: DataSetIterator) -> RegressionEvaluation:
        ev = RegressionEvaluation()
        for ds in iterator:
            ev.eval(ds.labels, self.output(ds.features), mask=ds.labels_mask)
        return ev

    # --------------------------------------------------------- params flat view

    def _param_entries(self):
        for i in sorted(self.params_, key=int):
            pd = self.params_[i]
            for name in sorted(pd):
                yield i, name, pd[name]

    @torch.no_grad()
    def params(self) -> torch.Tensor:
        """Flat 1-D copy of all parameters in the JAX package's order (layers
        by index, names sorted), as MultiLayerNetwork.params()'s buffer."""
        self._whole_params("params()")
        chunks = [w.reshape(-1) for _, _, w in self._param_entries()]
        return (torch.cat(chunks) if chunks
                else torch.zeros((0,), dtype=self._dtype, device=self.device))

    def num_params(self) -> int:
        return sum(w.numel() for _, _, w in self._param_entries())

    @torch.no_grad()
    def set_params(self, flat) -> None:
        self._whole_params("set_params()")
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

    def clone(self) -> "MultiLayerNetwork":
        """A network of the same configuration and device with copies of the
        parameters, BN state and updater state."""
        m = MultiLayerNetwork(self.conf, device=self.device)
        m.init()
        with torch.no_grad():
            for (_, _, dst), (_, _, src) in zip(m._param_entries(), self._param_entries()):
                dst.copy_(src)
            for si, st in self.bn_state.items():
                m.bn_state[si].mean.copy_(st.mean)
                m.bn_state[si].var.copy_(st.var)
        m.updater_state = copy.deepcopy(self.updater_state)
        return m

    # --------------------------------------------------------------- export

    def export(self, path: str, example_input):
        """Write the inference forward (``output()``) as a compiled artifact
        (``serde.compiled``): a ``torch.export`` program traced at
        ``example_input`` on the network's device, and the parameters and
        BN statistics as its weights. ``serde.compiled.load_compiled``
        reloads it without this class. Returns the seconds of the trace and
        of the write (``{"export", "save"}``)."""
        from ..serde.compiled import export_multilayer

        return export_multilayer(self, path, example_input)
