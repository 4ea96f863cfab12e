"""Extended layer set: 3-D and 1-D convolution and pooling, locally
connected layers, PReLU, cropping, the center-loss and one-class output
layers, the Keras-layout shape layers and the GRU.

Counterpart of ``deeplearning4j_tpu/nn/layers_ext.py`` (DL4J's
``conf.layers.Convolution3D``, ``Subsampling3DLayer``,
``LocallyConnected2D``, ``PReLULayer``, ``convolutional.Cropping2D``,
``CenterLossOutputLayer``, ``Convolution1DLayer``, ``Subsampling1DLayer``,
``ocnn.OCNNOutputLayer`` and the Keras importer's Reshape, Permute,
RepeatVector and GRU). Fields, defaults, parameter names, shapes and
layouts are the JAX package's, so its weights load as they are: NCDHW
volumes with OIDHW kernels, [B, C, T] sequences with OIH kernels.

"same" is XLA's SAME in every layer here (the odd pad at the end of each
axis, :func:`~.conf._same_pads`); max pooling pads with -inf and average
pooling divides each window's sum by the count of its cells that are not
padding, as the JAX package divides by a window sum of ones.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from . import activations as act
from . import losses as loss_fns
from .conf import (LAYER_REGISTRY, InputType, Layer, _conv_out, _mm, _pool, _same_pads,
                   _spatial_pads)
from .weights import init_weights


def _promoted(x, w):
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


# ------------------------------------------------------------ 3-D convolution


@dataclass
class Convolution3D(Layer):
    """conf.layers.Convolution3D: NCDHW in and out, OIDHW weights, dilation.
    ``output_type`` is the JAX package's (it leaves dilation out)."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (1, 1, 1)
    padding: Tuple[int, int, int] = (0, 0, 0)
    dilation: Tuple[int, int, int] = (1, 1, 1)
    convolution_mode: str = "truncate"
    has_bias: bool = True
    activation: str = "identity"

    def output_type(self, it: InputType) -> InputType:
        same = self.convolution_mode == "same"
        d = _conv_out(it.depth, self.kernel_size[0], self.stride[0], self.padding[0], same)
        h = _conv_out(it.height, self.kernel_size[1], self.stride[1], self.padding[1], same)
        w = _conv_out(it.width, self.kernel_size[2], self.stride[2], self.padding[2], same)
        return InputType.convolutional3d(d, h, w, self.n_out)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        c_in = self.n_in or it.channels
        kd, kh, kw = self.kernel_size
        p = {"W": init_weights(generator, (self.n_out, c_in, kd, kh, kw), c_in * kd * kh * kw,
                               self.n_out * kd * kh * kw, self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=generator.device)
        return p

    def forward(self, params, x, it, *, training, rng=None):
        x = self._apply_dropout(x, training, rng)
        x, W = _promoted(x, params["W"])
        pads = _spatial_pads(x, self.kernel_size, self.stride, self.padding, self.dilation,
                             self.convolution_mode == "same")
        if any(pads):
            x = F.pad(x, pads)
        z = F.conv3d(x, W, params["b"].to(W.dtype) if self.has_bias else None,
                     stride=tuple(self.stride), dilation=tuple(self.dilation))
        return act.get(self.activation)(z)


@dataclass
class Subsampling3DLayer(Layer):
    """conf.layers.Subsampling3DLayer (max/avg pooling over NCDHW)."""

    pooling_type: str = "max"
    kernel_size: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (2, 2, 2)
    padding: Tuple[int, int, int] = (0, 0, 0)
    convolution_mode: str = "truncate"

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        same = self.convolution_mode == "same"
        d = _conv_out(it.depth, self.kernel_size[0], self.stride[0], self.padding[0], same)
        h = _conv_out(it.height, self.kernel_size[1], self.stride[1], self.padding[1], same)
        w = _conv_out(it.width, self.kernel_size[2], self.stride[2], self.padding[2], same)
        return InputType.convolutional3d(d, h, w, it.channels)

    def forward(self, params, x, it, *, training, rng=None):
        pads = _spatial_pads(x, self.kernel_size, self.stride, self.padding, (1, 1, 1),
                             self.convolution_mode == "same")
        return _pool(x, self.pooling_type, self.kernel_size, self.stride, pads)


# ------------------------------------------------------- locally connected


def _local_product(patches, params, has_bias):
    """[B, F, P] patches against per-position banks W [P, F, O] (one
    batched product over positions), plus b [P, O]: [B, P, O]."""
    pt, W = _promoted(patches, params["W"])
    z = torch.einsum("bfp,pfo->bpo", pt, W)
    return z + params["b"].to(z.dtype) if has_bias else z


@dataclass
class LocallyConnected2D(Layer):
    """conf.layers.LocallyConnected2D: convolution with unshared weights, one
    filter bank [C·kh·kw, n_out] per output position. ``F.unfold`` orders
    a patch's features channel-major (c·kh·kw + i·kw + j), as
    ``conv_general_dilated_patches`` does."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    has_bias: bool = True
    activation: str = "identity"

    def _out_hw(self, it):
        same = self.convolution_mode == "same"
        h = _conv_out(it.height, self.kernel_size[0], self.stride[0], self.padding[0], same)
        w = _conv_out(it.width, self.kernel_size[1], self.stride[1], self.padding[1], same)
        return h, w

    def output_type(self, it: InputType) -> InputType:
        h, w = self._out_hw(it)
        return InputType.convolutional(h, w, self.n_out)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        c_in = self.n_in or it.channels
        kh, kw = self.kernel_size
        oh, ow = self._out_hw(it)
        fan_in = c_in * kh * kw
        p = {"W": init_weights(generator, (oh * ow, fan_in, self.n_out), fan_in, self.n_out,
                               self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.zeros((oh * ow, self.n_out), dtype=dtype, device=generator.device)
        return p

    def forward(self, params, x, it, *, training, rng=None):
        x = self._apply_dropout(x, training, rng)
        pads = _spatial_pads(x, self.kernel_size, self.stride, self.padding, (1, 1),
                             self.convolution_mode == "same")
        if any(pads):
            x = F.pad(x, pads)
        oh = (x.shape[2] - self.kernel_size[0]) // self.stride[0] + 1
        ow = (x.shape[3] - self.kernel_size[1]) // self.stride[1] + 1
        patches = F.unfold(x, tuple(self.kernel_size), stride=tuple(self.stride))
        z = _local_product(patches, params, self.has_bias)  # [B, OH·OW, O]
        z = z.reshape(x.shape[0], oh, ow, self.n_out).permute(0, 3, 1, 2)
        return act.get(self.activation)(z)


# ------------------------------------------------------------------- PReLU


@dataclass
class PReLULayer(Layer):
    """conf.layers.PReLULayer: y = max(0, x) + alpha · min(0, x) with a
    learned alpha per input feature; ``shared_axes`` (1-indexed past the
    batch, DL4J's convention) share one alpha along those axes."""

    n_in: int = 0  # inferred
    shared_axes: Tuple[int, ...] = ()

    def _alpha_shape(self, it: InputType):
        if it.kind == "cnn":
            shape = [it.channels, it.height, it.width]
        elif it.kind == "cnn3d":
            shape = [it.channels, it.depth, it.height, it.width]
        elif it.kind == "rnn":
            shape = [it.size, it.timeseries_length or 1]
        else:
            shape = [it.flat_size()]
        for ax in self.shared_axes:
            shape[ax - 1] = 1
        return tuple(shape)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        return {"alpha": torch.zeros(self._alpha_shape(it), dtype=dtype,
                                     device=generator.device)}

    def forward(self, params, x, it, *, training, rng=None):
        x = self._apply_dropout(x, training, rng)
        return torch.clamp(x, min=0) + params["alpha"][None] * torch.clamp(x, max=0)


@dataclass
class Cropping2D(Layer):
    """conf.layers.convolutional.Cropping2D: (top, bottom, left, right)."""

    cropping: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        t, b, l, r = self.cropping
        return InputType.convolutional(it.height - t - b, it.width - l - r, it.channels)

    def forward(self, params, x, it, *, training, rng=None):
        t, b, l, r = self.cropping
        return x[:, :, t:x.shape[2] - b, l:x.shape[3] - r]


# ------------------------------------------------------------ output layers


@dataclass
class CenterLossOutputLayer(Layer):
    """conf.layers.CenterLossOutputLayer: softmax cross-entropy plus
    ``lambda/2 · ||f − c_y||²``, which pulls each example's features toward
    its class's center. The centers are an ordinary parameter under the
    network's updater (the JAX package's documented semantics: plain SGD on
    the center term is DL4J's center update with rate lr · lambda)."""

    n_in: int = 0
    n_out: int = 0
    alpha: float = 0.05          # kept for API parity (center lr fold-in)
    lambda_: float = 2e-4
    has_bias: bool = True
    loss: str = "mcxent"
    activation: str = "softmax"

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        n_in = self.n_in or it.flat_size()
        p = {"W": init_weights(generator, (n_in, self.n_out), n_in, self.n_out,
                               self.weight_init, dtype),
             "centers": torch.zeros((self.n_out, n_in), dtype=dtype, device=generator.device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=generator.device)
        return p

    def _logits(self, params, x):
        z = _mm(x, params["W"])
        return z + params["b"] if self.has_bias else z

    def forward(self, params, x, it, *, training, rng=None):
        return act.get(self.activation)(self._logits(params, x))

    def compute_loss(self, params, x, labels, it, *, training, rng=None, mask=None):
        x = self._apply_dropout(x, training, rng)
        ce = loss_fns.softmax_cross_entropy_with_logits(labels, self._logits(params, x).float(),
                                                        mask=mask)
        c = _mm(labels.to(x.dtype), params["centers"])  # the labelled classes' centers
        return ce + 0.5 * self.lambda_ * torch.mean(torch.sum(torch.square(x - c), dim=-1))


@dataclass
class OCNNOutputLayer(Layer):
    """One-class neural network output (conf.ocnn.OCNNOutputLayer,
    Chalapathy et al. 2018): the score w·g(Vx) and the objective
    0.5||V||² + 0.5||w||² + (1/ν)·mean(relu(r − score)) − r. The margin
    ``r`` is a 0-d parameter under the network's updater, as in the JAX
    package (the objective is convex in r, minimised at the ν-quantile of
    the scores). Labels are ignored; ``forward`` gives score − r, positive
    for inliers."""

    hidden_size: int = 10
    nu: float = 0.04
    activation: str = "sigmoid"  # g in the paper

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(1)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        n_in = it.flat_size()
        return {
            "V": init_weights(generator, (n_in, self.hidden_size), n_in, self.hidden_size,
                              self.weight_init, dtype),
            "w": init_weights(generator, (self.hidden_size, 1), self.hidden_size, 1,
                              self.weight_init, dtype),
            "r": torch.zeros((), dtype=dtype, device=generator.device),
        }

    def _score(self, params, x):
        return _mm(act.get(self.activation)(_mm(x, params["V"])), params["w"])[:, 0]

    def forward(self, params, x, it, *, training, rng=None):
        return (self._score(params, x) - params["r"])[:, None]

    def compute_loss(self, params, x, labels, it, *, training, rng=None, mask=None):
        x = self._apply_dropout(x, training, rng)
        s = self._score(params, x).float()
        r = params["r"].float()
        reg = 0.5 * (torch.sum(torch.square(params["V"])) + torch.sum(torch.square(params["w"])))
        return reg + torch.mean(torch.relu(r - s)) / self.nu - r


# ------------------------------------------------------------- 1-D sequences


@dataclass
class Convolution1DLayer(Layer):
    """conf.layers.Convolution1DLayer: [B, C, T] → [B, n_out, T'], OIH
    weights; "same" (XLA's SAME) or "truncate" (no padding)."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    convolution_mode: str = "same"  # same | truncate
    has_bias: bool = True
    activation: str = "identity"

    def output_type(self, it: InputType) -> InputType:
        T = it.timeseries_length
        if T is not None:
            T = _conv_out(T, self.kernel_size, self.stride, 0, self.convolution_mode == "same")
        return InputType.recurrent(self.n_out, T)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        c_in = self.n_in or it.size
        p = {"W": init_weights(generator, (self.n_out, c_in, self.kernel_size),
                               c_in * self.kernel_size, self.n_out * self.kernel_size,
                               self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=generator.device)
        return p

    def forward(self, params, x, it, *, training, rng=None):
        x = self._apply_dropout(x, training, rng)
        x, W = _promoted(x, params["W"])
        if self.convolution_mode == "same":
            x = F.pad(x, _same_pads(x.shape[2], self.kernel_size, self.stride))
        z = F.conv1d(x, W, params["b"].to(W.dtype) if self.has_bias else None,
                     stride=self.stride)
        return act.get(self.activation)(z)


@dataclass
class Subsampling1DLayer(Layer):
    """conf.layers.Subsampling1DLayer (max/avg pooling over time, NCW)."""

    pooling_type: str = "max"
    kernel_size: int = 2
    stride: int = 2
    convolution_mode: str = "truncate"

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        T = it.timeseries_length
        if T is not None:
            T = _conv_out(T, self.kernel_size, self.stride, 0, self.convolution_mode == "same")
        return InputType.recurrent(it.size, T)

    def forward(self, params, x, it, *, training, rng=None):
        k, st = (self.kernel_size,), (self.stride,)
        pads = _spatial_pads(x, k, st, (0,), (1,), self.convolution_mode == "same")
        return _pool(x, self.pooling_type, k, st, pads)


# ------------------------------------------------- Keras-layout shape layers
# Reshape, Permute and RepeatVector apply in the Keras layout (NHWC images,
# [B, T, F] sequences) and convert back, so imported models keep Keras's
# semantics under DL4J's NCHW / [B, C, T] public layout.


def _to_keras_layout(x, it: InputType):
    if it.kind == "cnn" and x.dim() == 4:
        return x.permute(0, 2, 3, 1)  # NCHW -> NHWC
    if it.kind == "rnn" and x.dim() == 3:
        return x.permute(0, 2, 1)     # NCT -> NTF
    return x


def _from_keras_shape(z):
    """A Keras-layout tensor back in this package's layout by rank: 4-D
    NHWC -> NCHW, 3-D NTF -> NCT."""
    if z.dim() == 4:
        return z.permute(0, 3, 1, 2)
    if z.dim() == 3:
        return z.permute(0, 2, 1)
    return z


def _type_for_keras_shape(shape) -> InputType:
    if len(shape) == 3:
        return InputType.convolutional(shape[0], shape[1], shape[2])
    if len(shape) == 2:
        return InputType.recurrent(shape[1], shape[0])
    return InputType.feed_forward(int(math.prod(shape)))


@dataclass
class ReshapeLayer(Layer):
    """Keras Reshape: the reshape applies in the Keras layout."""

    target_shape: Tuple[int, ...] = ()

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return _type_for_keras_shape(self.target_shape)

    def forward(self, params, x, it, *, training, rng=None):
        z = _to_keras_layout(x, it).reshape((x.shape[0],) + tuple(self.target_shape))
        return _from_keras_shape(z)


@dataclass
class PermuteLayer(Layer):
    """Keras Permute: ``dims`` 1-indexed over the non-batch axes of the
    Keras layout."""

    dims: Tuple[int, ...] = ()

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        if it.kind == "rnn":
            ks = (it.timeseries_length, it.size)
        elif it.kind == "cnn":
            ks = (it.height, it.width, it.channels)
        else:
            ks = (it.size,)
        return _type_for_keras_shape(tuple(ks[d - 1] for d in self.dims))

    def forward(self, params, x, it, *, training, rng=None):
        z = _to_keras_layout(x, it).permute((0,) + tuple(self.dims))
        return _from_keras_shape(z)


@dataclass
class RepeatVectorLayer(Layer):
    """Keras RepeatVector: [B, F] -> Keras [B, n, F], which is [B, F, n]."""

    n: int = 1

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.flat_size(), self.n)

    def forward(self, params, x, it, *, training, rng=None):
        return x[:, :, None].expand(-1, -1, self.n)


@dataclass
class GRULayer(Layer):
    """GRU over [B, C, T] in Keras's gate order (z, r, candidate), W [nIn,
    3H], RW [H, 3H], b [3H]. ``reset_after`` (Keras's default since 2.3):
    the candidate is act(x W_h + r ⊙ (h RW_h + rb_h)), with the recurrent
    bias ``rb`` [3H]; otherwise act(x W_h + (r ⊙ h) RW_h), without ``rb``.
    The input projections of all steps are one product before the loop, as
    in ``conf._lstm_scan``."""

    n_in: int = 0
    n_out: int = 0
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    reset_after: bool = True

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        n_in = self.n_in or it.size
        H = self.n_out
        p = {"W": init_weights(generator, (n_in, 3 * H), n_in, H, self.weight_init, dtype),
             "RW": init_weights(generator, (H, 3 * H), H, H, self.weight_init, dtype),
             "b": torch.zeros((3 * H,), dtype=dtype, device=generator.device)}
        if self.reset_after:
            p["rb"] = torch.zeros((3 * H,), dtype=dtype, device=generator.device)
        return p

    def forward(self, params, x, it, *, training, rng=None):
        x = self._apply_dropout(x, training, rng)
        H = self.n_out
        ga, ca = act.get(self.gate_activation), act.get(self.activation)
        xz = _mm(x.permute(2, 0, 1), params["W"]) + params["b"]  # [T, B, 3H]
        RW = params["RW"]
        dt = torch.promote_types(xz.dtype, torch.promote_types(x.dtype, RW.dtype))
        xz, RW = xz.to(dt), RW.to(dt)
        rb = params["rb"].to(dt) if self.reset_after else None
        h = torch.zeros((x.shape[0], H), dtype=dt, device=x.device)
        outs = []
        for t in range(xz.shape[0]):
            xt = xz[t]
            if self.reset_after:
                hz = torch.addmm(rb, h, RW)
                z = ga(xt[:, :H] + hz[:, :H])
                r = ga(xt[:, H:2 * H] + hz[:, H:2 * H])
                hh = ca(xt[:, 2 * H:] + r * hz[:, 2 * H:])
            else:
                hz = h @ RW[:, :2 * H]
                z = ga(xt[:, :H] + hz[:, :H])
                r = ga(xt[:, H:2 * H] + hz[:, H:])
                hh = ca(xt[:, 2 * H:] + (r * h) @ RW[:, 2 * H:])
            h = z * h + (1.0 - z) * hh
            outs.append(h)
        return torch.stack(outs, dim=2)  # [B, H, T]


for _cls in (Convolution3D, Subsampling3DLayer, LocallyConnected2D, PReLULayer, Cropping2D,
             CenterLossOutputLayer, Convolution1DLayer, Subsampling1DLayer, ReshapeLayer,
             PermuteLayer, RepeatVectorLayer, GRULayer, OCNNOutputLayer):
    LAYER_REGISTRY[_cls.__name__] = _cls
