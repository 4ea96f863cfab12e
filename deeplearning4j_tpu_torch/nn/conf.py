"""Network configuration: builders, InputType shape inference, layer configs.

Counterpart of the core of ``deeplearning4j_tpu/nn/conf.py`` (DL4J's
``NeuralNetConfiguration.Builder``, ``MultiLayerConfiguration``,
``conf.layers.*``, ``conf.inputs.InputType``, ``conf.preprocessor.*``). As
in the JAX package, each layer config carries its runtime: ``init_params``
draws its tensors from a ``torch.Generator``, and ``forward`` is a function
of a {name: tensor} dict and the input. The public layouts are DL4J's: NCHW
images, OIHW convolution weights, [B, C, T] sequences, [in, out] dense
weights, so the JAX weights load as they are.

Ported layers: Dense, Output, Loss, Activation, Dropout, Convolution,
Subsampling, BatchNormalization, LSTM, GravesLSTM, LastTimeStep,
RnnOutputLayer, GlobalPooling, and (``nn.attention_layers``) the two
self-attention layers and RecurrentAttentionLayer. A layer of the JAX
package that is not ported yet, found in a configuration's JSON, raises
``NotImplementedError`` naming it and its ROADMAP.md item; it is never
dropped. ``NeuralNetConfiguration.Builder.graph_builder`` gives the
``nn.graph_conf.GraphBuilder`` of a ComputationGraph.

Dtypes follow the JAX package's promotion: a product of a bf16 and a float32
operand runs in float32 (:func:`_mm`), as ``jnp`` promotes it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..common import data_parallel
from ..common.device import DEFAULT_DEVICE, resolve_device
from . import activations as act
from . import losses as loss_fns
from .dropout import RngKey, apply_dropout
from .updaters import IUpdater, Sgd
from .weights import init_weights

# ----------------------------------------------------------------- InputType


@dataclass(frozen=True)
class InputType:
    """org.deeplearning4j.nn.conf.inputs.InputType — shape inference tokens.

    kind: "ff" (size,), "rnn" (size, tlen or None), "cnn" (h, w, channels),
    "cnnflat" (h, w, channels flattened).
    """

    kind: str
    size: int = 0
    height: int = 0
    width: int = 0
    channels: int = 0
    timeseries_length: Optional[int] = None
    depth: int = 0  # cnn3d (NCDHW)

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("ff", size=size)

    @staticmethod
    def recurrent(size: int, timeseries_length: Optional[int] = None) -> "InputType":
        return InputType("rnn", size=size, timeseries_length=timeseries_length)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", height=height, width=width, channels=channels)

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnnflat", height=height, width=width, channels=channels)

    @staticmethod
    def convolutional3d(depth: int, height: int, width: int, channels: int) -> "InputType":
        """NCDHW (Convolution3D.DataFormat.NCDHW)."""
        return InputType("cnn3d", depth=depth, height=height, width=width, channels=channels)

    def flat_size(self) -> int:
        if self.kind in ("ff", "rnn"):
            return self.size
        if self.kind == "cnn3d":
            return self.depth * self.height * self.width * self.channels
        return self.height * self.width * self.channels

    def to_json(self):
        return dataclasses.asdict(self)


# conv output-size helper (ConvolutionUtils.getOutputSize: 'truncate'/'same')
def _conv_out(size, k, s, p, same):
    if same:
        return -(-size // s)
    return (size + 2 * p - k) // s + 1


def _same_pads(size, k, s, d=1):
    """XLA's "SAME" padding of one spatial dim as (lo, hi): the output is
    ceil(size / s) and the odd pad goes to the end (bottom/right)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _conv_taps(in_size, k, s, p, d, same, out_size):
    """Total kernel taps landing INSIDE the input along one spatial dim,
    summed over output positions (padding positions multiply nothing, so
    the per-layer flop count leaves them out)."""
    pad_lo = _same_pads(in_size, k, s, d)[0] if same else p
    total = 0
    for o in range(out_size):
        start = o * s - pad_lo
        for j in range(k):
            if 0 <= start + j * d < in_size:
                total += 1
    return total


def _mm(a, b):
    """a @ b in the dtype ``jnp`` would promote the pair to."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _dense(x, params, has_bias):
    z = _mm(x, params["W"])
    return z + params["b"] if has_bias else z


# ---------------------------------------------------------------- param roles

# Role vocabulary for parameter partitioning (``parallel.partition.SpecLayout``
# maps each role to a PartitionSpec over the data/fsdp/tp mesh): a copy of
# the JAX package's table. nn owns the vocabulary and the name→role tagging;
# parallel owns the role→spec policy.
ROLE_EMBEDDING = "embedding"   # lookup tables: vocab/class dim shards fsdp×tp
ROLE_KERNEL = "kernel"         # dense/conv/recurrent projection matrices
ROLE_NORM = "norm"             # per-feature scales (gamma/beta/alpha/ln_*)
ROLE_BIAS = "bias"             # per-unit offsets (and scalar margins)

# Canonical param-name → role table covering every name the JAX package's
# layers and functional models produce. Partitioning treats an unknown name
# as UNCOVERED (no silent replication): add new names here, or override
# ``Layer.param_roles`` where a name's role is layer-dependent.
_PARAM_NAME_ROLES = {
    "W": ROLE_KERNEL, "RW": ROLE_KERNEL, "b": ROLE_BIAS,
    "gamma": ROLE_NORM, "beta": ROLE_NORM,
    "pi": ROLE_BIAS, "pf": ROLE_BIAS, "po": ROLE_BIAS,  # LSTM peepholes [H]
    "dW": ROLE_KERNEL, "pW": ROLE_KERNEL,  # separable conv depth/pointwise
    "rb": ROLE_BIAS,                       # GRU reset_after bias
    "alpha": ROLE_NORM,                    # PReLU per-feature slope
    "centers": ROLE_EMBEDDING,             # CenterLoss per-class centers
    "V": ROLE_KERNEL, "w": ROLE_KERNEL, "r": ROLE_BIAS,  # OCNN
    "Wq": ROLE_KERNEL, "Wk": ROLE_KERNEL, "Wv": ROLE_KERNEL,
    "Wo": ROLE_KERNEL, "Wr": ROLE_KERNEL,
    "Wh": ROLE_KERNEL, "Wx": ROLE_KERNEL,
    "Q": ROLE_EMBEDDING,                   # learned query table [n_queries, proj]
    # functional transformer (models/transformer.py)
    "tok": ROLE_EMBEDDING, "pos": ROLE_EMBEDDING, "seg": ROLE_EMBEDDING,
    "qkv_w": ROLE_KERNEL, "out_w": ROLE_KERNEL,
    "ffn_w1": ROLE_KERNEL, "ffn_w2": ROLE_KERNEL,
    "qkv_b": ROLE_BIAS, "out_b": ROLE_BIAS,
    "ffn_b1": ROLE_BIAS, "ffn_b2": ROLE_BIAS, "out_bias": ROLE_BIAS,
    "ln_scale": ROLE_NORM, "ln_bias": ROLE_NORM,
    "ln1_scale": ROLE_NORM, "ln1_bias": ROLE_NORM,
    "ln2_scale": ROLE_NORM, "ln2_bias": ROLE_NORM,
}


def param_role(name: str, leaf=None) -> Optional[str]:
    """Role for one param leaf by name (None = uncovered). Falls back to
    suffix patterns (``*_w``/``*_b``/``*_scale``/``*_bias``/``*embed*``)."""
    if name in _PARAM_NAME_ROLES:
        return _PARAM_NAME_ROLES[name]
    ln = name.lower()
    if "embed" in ln:
        return ROLE_EMBEDDING
    if ln.endswith("_scale") or ln.endswith("_gain"):
        return ROLE_NORM
    if ln.endswith("_bias") or ln.endswith("_b"):
        return ROLE_BIAS
    if ln.endswith("_w") or ln.endswith("_kernel"):
        return ROLE_KERNEL
    return None


def classify_param_tree(params) -> Any:
    """Mirror a params (sub)tree with role strings / None per leaf. Nested
    containers (graph node dicts, transformer block lists) recurse; a
    leaf's role comes from its own key name."""
    if isinstance(params, dict) or hasattr(params, "items"):
        return {k: (classify_param_tree(v) if isinstance(v, (dict, list, tuple))
                    else param_role(k, v))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(classify_param_tree(v) for v in params)
    return None  # bare leaf with no name context


# --------------------------------------------------------------- base config


@dataclass
class Layer:
    """Base layer config (org.deeplearning4j.nn.conf.layers.Layer)."""

    name: Optional[str] = None
    # cascaded defaults (filled by ListBuilder from NeuralNetConfiguration)
    updater: Optional[IUpdater] = None
    weight_init: str = "xavier"
    activation: str = "identity"
    l1: float = 0.0
    l2: float = 0.0
    dropout: float = 0.0  # retain prob (float) or an nn.dropout IDropout scheme
    frozen: bool = False  # FrozenLayer (TransferLearning): no param updates
    constraints: tuple = ()      # nn.constraints.*, applied after each update
    weight_noise: Optional[Any] = None  # nn.constraints.WeightNoise/DropConnect

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init_params(self, generator, input_type: InputType,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
        return {}

    def forward(self, params, x, it, *, training: bool, rng=None):
        return x

    def has_params(self) -> bool:
        return True

    def param_roles(self, params) -> Any:
        """Role tree mirroring ``init_params``' output (the role vocabulary
        above): each leaf classified by its canonical parameter name."""
        return classify_param_tree(params)

    def flops_per_example(self, it: InputType) -> float:
        """Estimated forward floating-point operations for one example; the
        default is one op per output element. Layers with real arithmetic
        override with the 2·MACs formulas."""
        out = self.output_type(it)
        T = out.timeseries_length if out.kind == "rnn" else 1
        return float(out.flat_size()) * float(T or 1)

    def _apply_dropout(self, x, training, rng: Optional[RngKey]):
        """DL4J conf .dropOut(...): a float (probability of RETAINING an
        activation, inverted scaling) or an IDropout scheme object, applied
        to the layer INPUT; the generator is made only when it is drawn from."""
        d = self.dropout
        if (not training or rng is None or d is None
                or (not hasattr(d, "apply") and d in (0.0, 1.0))):
            return x
        return apply_dropout(d, x, rng.generator(x.device), training)

    def to_json(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (IUpdater, InputType, Layer)):
                v = v.to_json()
            elif f.name == "dropout" and hasattr(v, "apply"):  # IDropout scheme
                v = {"@dropout": type(v).__name__, **dataclasses.asdict(v)}
            d[f.name] = v
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def from_json(d: dict) -> "Layer":
        d = dict(d)
        cls = layer_class(d.pop("@class"))
        if d.get("updater") and isinstance(d["updater"], dict):
            d["updater"] = IUpdater.from_json(d["updater"])
        if isinstance(d.get("dropout"), dict) and "@dropout" in d["dropout"]:
            from . import dropout as dropout_mod

            dd = dict(d["dropout"])
            d["dropout"] = getattr(dropout_mod, dd.pop("@dropout"))(**dd)
        for k, v in list(d.items()):
            if isinstance(v, dict) and "@class" in v:  # nested layer (LastTimeStep)
                d[k] = Layer.from_json(v)
        flds = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in flds})


# ------------------------------------------------------------- dense / output


@dataclass
class DenseLayer(Layer):
    """conf.layers.DenseLayer: preOut = x @ W + b."""

    n_in: int = 0
    n_out: int = 0
    has_bias: bool = True

    def output_type(self, it: InputType) -> InputType:
        if it.kind == "rnn":
            return InputType.recurrent(self.n_out, it.timeseries_length)
        return InputType.feed_forward(self.n_out)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        n_in = self.n_in or it.flat_size()
        p = {"W": init_weights(generator, (n_in, self.n_out), n_in, self.n_out,
                               self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=generator.device)
        return p

    def forward(self, params, x, it, *, training, rng=None):
        x = self._apply_dropout(x, training, rng)
        return act.get(self.activation)(_dense(x, params, self.has_bias))

    def flops_per_example(self, it: InputType) -> float:
        n_in = self.n_in or it.flat_size()
        T = (it.timeseries_length or 1) if it.kind == "rnn" else 1
        return float(T) * (2.0 * n_in * self.n_out + self.n_out)


def _fused_loss(activation, loss):
    """Which fused logits path (if any) the output layer takes."""
    a, l = activation.lower(), loss.lower().replace("_", "")
    if a == "softmax" and l in ("mcxent", "negativeloglikelihood"):
        return "softmax"
    if a == "sigmoid" and l == "xent":
        return "sigmoid"
    return None


@dataclass
class OutputLayer(DenseLayer):
    """conf.layers.OutputLayer: dense + loss head. Softmax with mcxent/NLL
    and sigmoid with xent take the fused logits losses; any other pair
    applies the activation and then the loss."""

    loss: str = "mcxent"
    activation: str = "softmax"

    def compute_loss(self, params, x, labels, it, *, training, rng=None, mask=None):
        x = self._apply_dropout(x, training, rng)
        # AMP policy: loss math in fp32 even when the stack ran bf16
        z = _dense(x, params, self.has_bias).float()
        fused = _fused_loss(self.activation, self.loss)
        if fused == "softmax":
            return loss_fns.softmax_cross_entropy_with_logits(labels, z, mask=mask)
        if fused == "sigmoid":
            return loss_fns.sigmoid_cross_entropy_with_logits(labels, z, mask=mask)
        return loss_fns.get(self.loss)(labels, act.get(self.activation)(z), mask=mask)


@dataclass
class LossLayer(Layer):
    """conf.layers.LossLayer — loss head without params."""

    loss: str = "mse"
    activation: str = "identity"

    def has_params(self):
        return False

    def compute_loss(self, params, x, labels, it, *, training, rng=None, mask=None):
        preds = act.get(self.activation)(x.float())
        return loss_fns.get(self.loss)(labels, preds, mask=mask)

    def forward(self, params, x, it, *, training, rng=None):
        return act.get(self.activation)(x)


@dataclass
class ActivationLayer(Layer):
    def has_params(self):
        return False

    def forward(self, params, x, it, *, training, rng=None):
        return act.get(self.activation)(x)


@dataclass
class DropoutLayer(Layer):
    def has_params(self):
        return False

    def forward(self, params, x, it, *, training, rng=None):
        return self._apply_dropout(x, training, rng)


# ------------------------------------------------------------------ conv 2d


def _spatial_pads(x, kernel, stride, padding, dilation, same):
    """F.pad's (left, right, top, bottom) for an NCHW input: XLA's SAME
    (odd pad at the end) or the symmetric explicit padding."""
    if same:
        top, bottom = _same_pads(x.shape[2], kernel[0], stride[0], dilation[0])
        left, right = _same_pads(x.shape[3], kernel[1], stride[1], dilation[1])
        return (left, right, top, bottom)
    return (padding[1], padding[1], padding[0], padding[0])


@dataclass
class ConvolutionLayer(Layer):
    """conf.layers.ConvolutionLayer: NCHW in and out, OIHW weights, the
    JAX package's "truncate" (explicit symmetric padding) and "same" (XLA's
    SAME, odd pad at the bottom/right) modes."""

    n_in: int = 0  # channels in (inferred)
    n_out: int = 0  # filters
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"  # truncate | same
    has_bias: bool = True
    activation: str = "identity"

    def output_type(self, it: InputType) -> InputType:
        same = self.convolution_mode == "same"
        kh = self.kernel_size[0] * self.dilation[0] - self.dilation[0] + 1
        kw = self.kernel_size[1] * self.dilation[1] - self.dilation[1] + 1
        h = _conv_out(it.height, kh, self.stride[0], self.padding[0], same)
        w = _conv_out(it.width, kw, self.stride[1], self.padding[1], same)
        return InputType.convolutional(h, w, self.n_out)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        c_in = self.n_in or it.channels
        kh, kw = self.kernel_size
        # OIHW weight layout (DL4J: [out, in, kH, kW])
        p = {"W": init_weights(generator, (self.n_out, c_in, kh, kw), c_in * kh * kw,
                               self.n_out * kh * kw, self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=generator.device)
        return p

    def forward(self, params, x, it, *, training, rng=None):
        x = self._apply_dropout(x, training, rng)
        W = params["W"]
        dt = torch.promote_types(x.dtype, W.dtype)
        pads = _spatial_pads(x, self.kernel_size, self.stride, self.padding, self.dilation,
                             self.convolution_mode == "same")
        if any(pads):
            x = F.pad(x, pads)
        z = F.conv2d(x.to(dt), W.to(dt), params["b"].to(dt) if self.has_bias else None,
                     stride=tuple(self.stride), dilation=tuple(self.dilation))
        return act.get(self.activation)(z)

    def _spatial_taps(self, it: InputType) -> float:
        out = self.output_type(it)
        same = self.convolution_mode == "same"
        th = _conv_taps(it.height, self.kernel_size[0], self.stride[0],
                        self.padding[0], self.dilation[0], same, out.height)
        tw = _conv_taps(it.width, self.kernel_size[1], self.stride[1],
                        self.padding[1], self.dilation[1], same, out.width)
        return float(th) * float(tw)

    def flops_per_example(self, it: InputType) -> float:
        c_in = self.n_in or it.channels
        return 2.0 * self._spatial_taps(it) * self.n_out * c_in


def _window_sum(x, kernel, stride):
    """Sum over each pooling window (no padding: the caller pads)."""
    return F.avg_pool2d(x, tuple(kernel), tuple(stride), divisor_override=1)


@dataclass
class SubsamplingLayer(Layer):
    """conf.layers.SubsamplingLayer (max/avg/pnorm pooling). Max pooling
    pads with -inf; average pooling divides by the count of the window's
    elements that are not padding (also where SAME pads one side only);
    pnorm pads with zeros."""

    pooling_type: str = "max"  # max | avg | pnorm
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        same = self.convolution_mode == "same"
        h = _conv_out(it.height, self.kernel_size[0], self.stride[0], self.padding[0], same)
        w = _conv_out(it.width, self.kernel_size[1], self.stride[1], self.padding[1], same)
        return InputType.convolutional(h, w, it.channels)

    def forward(self, params, x, it, *, training, rng=None):
        k, s = tuple(self.kernel_size), tuple(self.stride)
        pads = _spatial_pads(x, k, s, self.padding, (1, 1), self.convolution_mode == "same")
        padded = any(pads)
        if self.pooling_type == "max":
            if padded:
                x = F.pad(x, pads, value=float("-inf"))
            return F.max_pool2d(x, k, s)
        if self.pooling_type == "avg":
            total = _window_sum(F.pad(x, pads) if padded else x, k, s)
            if not padded:
                return total / float(k[0] * k[1])
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
            return total / _window_sum(F.pad(ones, pads), k, s)
        if self.pooling_type == "pnorm":
            p = float(self.pnorm)
            y = torch.abs(x) ** p
            return _window_sum(F.pad(y, pads) if padded else y, k, s) ** (1.0 / p)
        raise ValueError(f"unknown pooling {self.pooling_type}")

    def flops_per_example(self, it: InputType) -> float:
        out = self.output_type(it)
        return (float(out.height * out.width * out.channels)
                * self.kernel_size[0] * self.kernel_size[1])


@dataclass
class BatchNormalization(Layer):
    """conf.layers.BatchNormalization: gamma/beta, running mean/var.

    Training statistics are one pass and biased (var = E[x²] - E[x]², clipped
    at 0), in float32 whatever the activations' dtype; the running stats
    move as ``decay·old + (1 − decay)·batch`` (``F.batch_norm`` uses the
    opposite momentum and the unbiased variance, so it is not used). [B, C,
    H, W] normalises per channel over (B, H, W), [B, C, T] over (B, T).
    Inside a data-parallel step over several ranks the sums are the global
    batch's (``common.data_parallel``), as GSPMD makes them in the JAX
    package's ``ParallelTrainer``."""

    n_out: int = 0  # inferred from input
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False

    def output_type(self, it: InputType) -> InputType:
        return it

    def _n(self, it):
        return self.n_out or (it.channels if it.kind == "cnn" else it.flat_size())

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        if self.lock_gamma_beta:
            return {}
        n = self._n(it)
        return {"gamma": torch.ones((n,), dtype=dtype, device=generator.device),
                "beta": torch.zeros((n,), dtype=dtype, device=generator.device)}

    def init_state(self, it: InputType, dtype=torch.float32, device=DEFAULT_DEVICE):
        device = resolve_device(device)
        n = self._n(it)
        return {"mean": torch.zeros((n,), dtype=dtype, device=device),
                "var": torch.ones((n,), dtype=dtype, device=device)}

    def forward_bn(self, params, state, x, it, *, training):
        """(output, new state); the new state is detached from the graph."""
        if x.dim() == 4:
            axes, bshape = (0, 2, 3), (1, -1, 1, 1)
        elif x.dim() == 3:  # [B,C,T] recurrent: per-channel over (B,T)
            axes, bshape = (0, 2), (1, -1, 1)
        else:
            axes, bshape = (0,), (1, -1)
        xf = x.float()
        if training:
            n = 1
            for a in axes:
                n *= x.shape[a]
            s1, s2 = xf.sum(dim=axes), (xf * xf).sum(dim=axes)
            dp = data_parallel.spans_ranks()
            if dp is not None:  # the global batch's moments (common.data_parallel)
                s1, s2, n = dp.sum_moments(s1, s2, n)
            mean = s1 / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
            with torch.no_grad():
                new_state = {
                    "mean": self.decay * state["mean"] + (1 - self.decay) * mean,
                    "var": self.decay * state["var"] + (1 - self.decay) * var,
                }
        else:
            mean, var = state["mean"].float(), state["var"].float()
            new_state = state
        inv = torch.rsqrt(var + self.eps)
        if "gamma" in params:
            inv = inv * params["gamma"].float()
            off = params["beta"].float() - mean * inv
        else:
            off = -mean * inv
        xh = xf * inv.reshape(bshape) + off.reshape(bshape)
        return act.get(self.activation)(xh).to(x.dtype), new_state

    def forward(self, params, x, it, *, training, rng=None, state=None):
        out, _ = self.forward_bn(params, state or self.init_state(it, x.dtype, x.device), x,
                                 it, training=False)
        return out

    def flops_per_example(self, it: InputType) -> float:
        # one-pass moments (sum + sum-of-squares) + scale/offset apply
        T = (it.timeseries_length or 1) if it.kind == "rnn" else 1
        return 8.0 * it.flat_size() * float(T)


# ----------------------------------------------------------------- recurrent


def _lstm_scan(x_tbi, h0, c0, Wx, Wh, b, gate_act, cell_act, peephole=None):
    """LSTM over time. Input [T, B, I]; one [I, 4H] and one [H, 4H] matrix
    in gate order IFOG (input, forget, output, cell gate); peepholes on i
    and f read c_{t-1}, the one on o reads c_t. The input projections of
    all steps are one product before the loop. The step runs in the dtype
    ``jnp`` promotes (x W + b, h0, Wh) to. Returns outputs [T, B, H] and
    (h_T, c_T)."""
    xz = _mm(x_tbi, Wx) + b
    dt = torch.promote_types(xz.dtype, torch.promote_types(h0.dtype, Wh.dtype))
    xz, Wh, h, c = xz.to(dt), Wh.to(dt), h0.to(dt), c0.to(dt)
    outs = []
    for t in range(xz.shape[0]):
        i_g, f_g, o_g, g_g = torch.addmm(xz[t], h, Wh).chunk(4, dim=-1)
        if peephole is not None:
            pi, pf, po = peephole
            i_g = i_g + c * pi
            f_g = f_g + c * pf
        c = gate_act(f_g) * c + gate_act(i_g) * cell_act(g_g)
        if peephole is not None:
            o_g = o_g + c * po
        h = gate_act(o_g) * cell_act(c)
        outs.append(h)
    return torch.stack(outs), (h, c)


@dataclass
class LSTM(Layer):
    """conf.layers.LSTM (libnd4j lstmLayer): data layout [B, nIn, T]."""

    n_in: int = 0
    n_out: int = 0
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    peephole: bool = False

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        n_in = self.n_in or it.size
        H = self.n_out
        b = torch.zeros((4 * H,), dtype=dtype, device=generator.device)
        b[H:2 * H] = 1.0  # forget-gate bias 1.0 (DL4J forgetGateBiasInit default)
        p = {"W": init_weights(generator, (n_in, 4 * H), n_in, H, self.weight_init, dtype),
             "RW": init_weights(generator, (H, 4 * H), H, H, self.weight_init, dtype),
             "b": b}
        if self.peephole:
            for k in ("pi", "pf", "po"):
                p[k] = torch.zeros((H,), dtype=dtype, device=generator.device)
        return p

    def _scan(self, params, x, h0, c0):
        peep = (params["pi"], params["pf"], params["po"]) if self.peephole else None
        outs, (hT, cT) = _lstm_scan(
            x.permute(2, 0, 1), h0, c0, params["W"], params["RW"], params["b"],
            act.get(self.gate_activation), act.get(self.activation), peep)
        return outs.permute(1, 2, 0), hT, cT  # [T,B,H] -> [B,H,T]

    def forward(self, params, x, it, *, training, rng=None, initial_state=None):
        x = self._apply_dropout(x, training, rng)
        if initial_state is None:
            h0 = torch.zeros((x.shape[0], self.n_out), dtype=x.dtype, device=x.device)
            initial_state = (h0, h0)
        return self._scan(params, x, *initial_state)[0]

    def forward_with_state(self, params, x, h0, c0):
        """Streaming rnnTimeStep support: returns (out [B,H,T], hT, cT)."""
        return self._scan(params, x, h0, c0)

    def flops_per_example(self, it: InputType) -> float:
        n_in = self.n_in or it.size
        H = self.n_out
        T = float(it.timeseries_length or 1)
        # input + recurrent projections into 4 gates, plus ~10 elementwise
        # ops/unit for the gate math (peepholes add 3 multiply-adds)
        per_step = 2.0 * n_in * 4 * H + 2.0 * H * 4 * H + 10.0 * H
        if self.peephole:
            per_step += 6.0 * H
        return T * per_step


@dataclass
class GravesLSTM(LSTM):
    """conf.layers.GravesLSTM — peephole LSTM (Graves 2013)."""

    peephole: bool = True


@dataclass
class LastTimeStep(Layer):
    """recurrent.LastTimeStep wrapper: [B,C,T] → [B,C]; with a mask, each
    example's last unmasked step."""

    underlying: Optional[Layer] = None

    def output_type(self, it: InputType) -> InputType:
        inner = self.underlying.output_type(it) if self.underlying else it
        return InputType.feed_forward(inner.size)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        return self.underlying.init_params(generator, it, dtype) if self.underlying else {}

    def forward(self, params, x, it, *, training, rng=None, mask=None):
        if self.underlying is not None:
            x = self.underlying.forward(params, x, it, training=training, rng=rng)
        if mask is not None:
            m = torch.as_tensor(mask, device=x.device)
            idx = torch.clamp(m.to(torch.int64).sum(dim=-1) - 1, min=0)
            return torch.gather(x, 2, idx[:, None, None].expand(-1, x.shape[1], 1))[:, :, 0]
        return x[:, :, -1]

    def flops_per_example(self, it: InputType) -> float:
        return (self.underlying.flops_per_example(it)
                if self.underlying is not None else 0.0)


@dataclass
class RnnOutputLayer(OutputLayer):
    """conf.layers.RnnOutputLayer: time-distributed dense + loss over
    [B, C, T]. Softmax + mcxent with a mask: the masked sum over the mask's
    count; without one: the mean over the batch of per-sequence sums."""

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def forward(self, params, x, it, *, training, rng=None):
        x = self._apply_dropout(x, training, rng)
        z = _dense(x.transpose(1, 2), params, self.has_bias)
        return act.get(self.activation)(z).transpose(1, 2)

    def compute_loss(self, params, x, labels, it, *, training, rng=None, mask=None):
        x = self._apply_dropout(x, training, rng)
        z = _dense(x.transpose(1, 2), params, self.has_bias).float()  # [B,T,C], fp32 loss
        lab = labels.transpose(1, 2) if labels.dim() == 3 else labels
        if _fused_loss(self.activation, self.loss) == "softmax":
            ce = -(lab * torch.log_softmax(z, dim=-1)).sum(dim=-1)  # [B,T]
            if mask is not None:
                m = torch.as_tensor(mask, device=ce.device).to(ce.dtype)
                return (ce * m).sum() / m.sum().clamp(min=1.0)
            return ce.sum(dim=-1).mean()
        preds = act.get(self.activation)(z)
        return loss_fns.get(self.loss)(lab, preds, mask=mask)


# ------------------------------------------------------------ global pooling


@dataclass
class GlobalPoolingLayer(Layer):
    """conf.layers.GlobalPoolingLayer: MAX/AVG/SUM/PNORM over spatial or time
    dims; CNN [B,C,H,W]→[B,C]; RNN [B,C,T]→[B,C] (mask-aware)."""

    pooling_type: str = "max"
    pnorm: int = 2

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        if it.kind in ("cnn", "cnn3d"):
            return InputType.feed_forward(it.channels)
        return InputType.feed_forward(it.size)

    def forward(self, params, x, it, *, training, rng=None, mask=None):
        axes = tuple(range(2, x.dim()))
        pt = self.pooling_type
        if mask is not None and x.dim() == 3:
            m = torch.as_tensor(mask, device=x.device)[:, None, :].to(x.dtype)
            if pt == "max":
                return torch.where(m > 0, x, torch.full_like(x, float("-inf"))).amax(dim=2)
            if pt in ("avg", "mean"):
                return (x * m).sum(dim=2) / m.sum(dim=2).clamp(min=1.0)
            if pt == "sum":
                return (x * m).sum(dim=2)
        if pt == "max":
            return x.amax(dim=axes)
        if pt in ("avg", "mean"):
            return x.mean(dim=axes)
        if pt == "sum":
            return x.sum(dim=axes)
        if pt == "pnorm":
            p = float(self.pnorm)
            return (torch.abs(x) ** p).sum(dim=axes) ** (1.0 / p)
        raise ValueError(pt)


# -------------------------------------------------------------- preprocessors


@dataclass
class InputPreProcessor:
    """conf.preprocessor.* — shape adapters auto-inserted between layers."""

    def pre_process(self, x, it: InputType):
        return x

    def output_type(self, it: InputType) -> InputType:
        return it


@dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    def pre_process(self, x, it):
        return x.reshape(x.shape[0], -1)

    def output_type(self, it):
        return InputType.feed_forward(it.flat_size())


@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x, it):
        return x.reshape(x.shape[0], self.channels, self.height, self.width)

    def output_type(self, it):
        return InputType.convolutional(self.height, self.width, self.channels)


@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B,C,T] → [B,T,C]: dense layers then apply time-distributed over the
    trailing feature axis (the batch dim stays, as in the JAX package)."""

    def pre_process(self, x, it):
        return x.transpose(1, 2)

    def output_type(self, it):
        return InputType.feed_forward(it.size)


@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[B,T,C] (time-distributed ff) or [B,C] (single step) → [B,C,T]."""

    def pre_process(self, x, it):
        if x.dim() == 2:
            return x[:, :, None]
        return x.transpose(1, 2)

    def output_type(self, it):
        return InputType.recurrent(it.flat_size())


def infer_preprocessor(prev: InputType, layer: Layer) -> Optional[InputPreProcessor]:
    """Auto-insertion logic (InputType.getPreProcessorForInputType)."""
    wants_ff = isinstance(layer, DenseLayer) and not isinstance(layer, RnnOutputLayer)
    wants_cnn = isinstance(layer, (ConvolutionLayer, SubsamplingLayer))
    wants_rnn = isinstance(layer, (LSTM, RnnOutputLayer))
    if prev.kind in ("cnn", "cnn3d") and wants_ff:
        return CnnToFeedForwardPreProcessor()
    if prev.kind == "cnnflat" and wants_cnn:
        return FeedForwardToCnnPreProcessor(prev.height, prev.width, prev.channels)
    if prev.kind == "rnn" and wants_ff:
        return RnnToFeedForwardPreProcessor()
    if prev.kind == "ff" and wants_rnn:
        return FeedForwardToRnnPreProcessor()
    return None


# ------------------------------------------------- NeuralNetConfiguration


@dataclass
class MultiLayerConfiguration:
    """org.deeplearning4j.nn.conf.MultiLayerConfiguration."""

    layers: List[Layer] = field(default_factory=list)
    input_type: Optional[InputType] = None
    preprocessors: Dict[int, InputPreProcessor] = field(default_factory=dict)
    seed: int = 0
    updater: IUpdater = field(default_factory=lambda: Sgd(0.1))
    dtype: str = "float32"
    tbptt_fwd_length: int = 0
    tbptt_back_length: int = 0
    backprop_type: str = "Standard"  # Standard | TruncatedBPTT
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    mini_batch: bool = True

    def input_types(self) -> List[InputType]:
        """Per-layer input InputType after preprocessor application."""
        its = []
        it = self.input_type
        if it is None and self.layers:
            # DL4J allows omitting setInputType when the first layer declares
            # nIn explicitly — synthesize the InputType from it
            first = self.layers[0]
            if isinstance(first, (ConvolutionLayer, SubsamplingLayer)):
                raise ValueError(
                    "first layer is convolutional: call "
                    ".set_input_type(InputType.convolutional(h, w, c))")
            n_in = getattr(first, "n_in", 0)
            if n_in:
                it = (InputType.recurrent(n_in) if isinstance(first, LSTM)
                      else InputType.feed_forward(n_in))
        for i, layer in enumerate(self.layers):
            if i in self.preprocessors:
                it = self.preprocessors[i].output_type(it)
            its.append(it)
            it = layer.output_type(it)
        return its

    def to_json(self) -> str:
        d = {
            "layers": [l.to_json() for l in self.layers],
            "input_type": self.input_type.to_json() if self.input_type else None,
            "preprocessors": {str(k): type(v).__name__ for k, v in self.preprocessors.items()},
            "preprocessor_args": {
                str(k): dataclasses.asdict(v) for k, v in self.preprocessors.items()
            },
            "seed": self.seed,
            "updater": self.updater.to_json(),
            "dtype": self.dtype,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "backprop_type": self.backprop_type,
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold": self.gradient_normalization_threshold,
        }
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        layers = [Layer.from_json(ld) for ld in d["layers"]]
        it = InputType(**d["input_type"]) if d.get("input_type") else None
        pre = {}
        for k, name in d.get("preprocessors", {}).items():
            args = d.get("preprocessor_args", {}).get(k, {})
            pre[int(k)] = PREPROCESSOR_REGISTRY[name](**args)
        return MultiLayerConfiguration(
            layers=layers,
            input_type=it,
            preprocessors=pre,
            seed=d.get("seed", 0),
            updater=IUpdater.from_json(d["updater"]),
            dtype=d.get("dtype", "float32"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 0),
            tbptt_back_length=d.get("tbptt_back_length", 0),
            backprop_type=d.get("backprop_type", "Standard"),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get("gradient_normalization_threshold", 1.0),
        )


class ListBuilder:
    """NeuralNetConfiguration.ListBuilder — .layer(i, conf) chain →
    MultiLayerConfiguration with cascaded defaults."""

    def __init__(self, base: "NeuralNetConfiguration.Builder"):
        self._base = base
        self._layers: List[Layer] = []
        self._input_type: Optional[InputType] = None
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._tbptt_fwd = 0
        self._tbptt_back = 0
        self._backprop_type = "Standard"

    def layer(self, *args) -> "ListBuilder":
        self._layers.append(args[-1])
        return self

    def set_input_type(self, it: InputType) -> "ListBuilder":
        self._input_type = it
        return self

    setInputType = set_input_type

    def input_pre_processor(self, index: int, pre: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[index] = pre
        return self

    def backprop_type(self, t: str) -> "ListBuilder":
        self._backprop_type = t
        return self

    def t_bptt_length(self, fwd: int, back: Optional[int] = None) -> "ListBuilder":
        self._tbptt_fwd = fwd
        self._tbptt_back = back if back is not None else fwd
        self._backprop_type = "TruncatedBPTT"
        return self

    tBPTTLength = t_bptt_length

    def build(self) -> MultiLayerConfiguration:
        b = self._base
        # cascade global defaults into layers (NeuralNetConfiguration semantics)
        for l in self._layers:
            if l.updater is None:
                l.updater = b.updater_
            if l.weight_init == "xavier" and b.weight_init_ != "xavier":
                l.weight_init = b.weight_init_
            if l.l1 == 0.0:
                l.l1 = b.l1_
            if l.l2 == 0.0:
                l.l2 = b.l2_
            if l.dropout == 0.0 and b.dropout_ != 0.0:
                l.dropout = b.dropout_
            if l.activation == "identity" and b.activation_ is not None and not isinstance(
                l, (OutputLayer, LossLayer, SubsamplingLayer, BatchNormalization)
            ):
                l.activation = b.activation_
        conf = MultiLayerConfiguration(
            layers=self._layers,
            input_type=self._input_type,
            preprocessors=dict(self._preprocessors),
            seed=b.seed_,
            updater=b.updater_,
            dtype=b.dtype_,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            backprop_type=self._backprop_type,
            gradient_normalization=b.grad_norm_,
            gradient_normalization_threshold=b.grad_norm_threshold_,
            mini_batch=b.mini_batch_,
        )
        # auto-insert preprocessors where InputType demands (setInputType logic)
        if conf.input_type is not None:
            it = conf.input_type
            for i, layer in enumerate(conf.layers):
                if i in conf.preprocessors:
                    it = conf.preprocessors[i].output_type(it)
                else:
                    pre = infer_preprocessor(it, layer)
                    if pre is not None:
                        conf.preprocessors[i] = pre
                        it = pre.output_type(it)
                it = layer.output_type(it)
        return conf


class NeuralNetConfiguration:
    """org.deeplearning4j.nn.conf.NeuralNetConfiguration.Builder."""

    class Builder:
        def __init__(self):
            self.seed_ = 0
            self.updater_ = Sgd(0.1)
            self.weight_init_ = "xavier"
            self.activation_ = None
            self.l1_ = 0.0
            self.l2_ = 0.0
            self.dropout_ = 0.0
            self.dtype_ = "float32"
            self.grad_norm_ = None
            self.grad_norm_threshold_ = 1.0
            self.mini_batch_ = True

        def seed(self, s: int):
            self.seed_ = int(s)
            return self

        def updater(self, u: IUpdater):
            self.updater_ = u
            return self

        def weight_init(self, w: str):
            self.weight_init_ = str(w).lower()
            return self

        weightInit = weight_init

        def activation(self, a: str):
            self.activation_ = str(a).lower()
            return self

        def l1(self, v: float):
            self.l1_ = v
            return self

        def l2(self, v: float):
            self.l2_ = v
            return self

        def dropout(self, keep_prob: float):
            self.dropout_ = keep_prob
            return self

        dropOut = dropout

        def data_type(self, dt: str):
            self.dtype_ = dt
            return self

        def gradient_normalization(self, gn: str, threshold: float = 1.0):
            self.grad_norm_ = gn
            self.grad_norm_threshold_ = threshold
            return self

        def mini_batch(self, b: bool):
            self.mini_batch_ = b
            return self

        def list(self) -> ListBuilder:
            return ListBuilder(self)

        def graph_builder(self):
            from .graph_conf import GraphBuilder

            return GraphBuilder(self)

        graphBuilder = graph_builder


LAYER_REGISTRY = {
    c.__name__: c
    for c in (
        DenseLayer,
        OutputLayer,
        LossLayer,
        ActivationLayer,
        DropoutLayer,
        ConvolutionLayer,
        SubsamplingLayer,
        BatchNormalization,
        LSTM,
        GravesLSTM,
        LastTimeStep,
        RnnOutputLayer,
        GlobalPoolingLayer,
    )
}

def layer_class(name: str):
    """The layer class JSON names: a ported one, or ``NotImplementedError``
    naming the ROADMAP.md item that ports it (``nn.attention_layers``
    registers its three layers when the package is imported)."""
    if name in LAYER_REGISTRY:
        return LAYER_REGISTRY[name]
    raise NotImplementedError(
        f"layer {name!r} is not ported to deeplearning4j_tpu_torch yet (ROADMAP.md queue 1 "
        "item 8, the remaining layers)")


PREPROCESSOR_REGISTRY = {
    c.__name__: c
    for c in (
        CnnToFeedForwardPreProcessor,
        FeedForwardToCnnPreProcessor,
        RnnToFeedForwardPreProcessor,
        FeedForwardToRnnPreProcessor,
    )
}
