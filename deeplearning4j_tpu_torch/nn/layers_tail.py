"""The tail of the layer set: the bidirectional Graves LSTM, the mask
layers, the headless loss layers, the element-wise and wrapper layers,
space/batch reshapes, the 1-D/3-D crop, pad and upsample family,
Deconvolution3D, ConvLSTM2D, LocallyConnected1D, and DL4J's alias classes.

Counterpart of ``deeplearning4j_tpu/nn/layers_tail.py`` (DL4J's
``conf.layers.*``). Layouts are DL4J's: images [B, C, H, W], volumes
NCDHW, sequences [B, C, T]. A wrapper (``MaskZeroLayer``,
``FrozenLayerWithBackprop``, ``TimeDistributed``) holds its wrapped layer
under ``underlying`` and takes that layer's parameters as its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from . import activations as act
from . import losses as loss_fns
from .conf import (LAYER_REGISTRY, Bidirectional, ConvolutionLayer, GravesLSTM, InputType, Layer,
                   SubsamplingLayer, _same_pads, _transpose_same_pads)
from .layers_ext import Subsampling1DLayer, _local_product
from .weights import init_weights

# ------------------------------------------------------------ recurrent tail


@dataclass
class GravesBidirectionalLSTM(Layer):
    """conf.layers.GravesBidirectionalLSTM: a peephole (Graves) LSTM run in
    both time directions with weights of its own, the outputs summed;
    [B, nIn, T] → [B, nOut, T]. Dropout applies once, to the input; the
    cells get no random key.

    The JAX package's parameters are ``{"fwd": {...}, "bwd": {...}}``; the
    port keeps them as one flat dict keyed ``"fwd/W"``, as
    ``conf.Bidirectional`` does, so the network counts, orders, flattens
    and regularises them (the JAX package's ``num_params()``, ``params()``
    and L1/L2 raise on the nested tree, a reference bug the port does not
    copy)."""

    n_in: int = 0
    n_out: int = 0
    activation: str = "tanh"
    gate_activation: str = "sigmoid"

    def _pair(self) -> Bidirectional:
        """The two GravesLSTM cells as ``conf.Bidirectional`` in "add" mode."""
        return Bidirectional(fwd=GravesLSTM(n_in=self.n_in, n_out=self.n_out,
                                            activation=self.activation,
                                            gate_activation=self.gate_activation,
                                            weight_init=self.weight_init), mode="add")

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        return self._pair().init_params(generator, it, dtype)

    def forward(self, params, x, it, *, training, rng=None):
        x = self._apply_dropout(x, training, rng)
        return self._pair().forward(params, x, it, training=training)

    def param_roles(self, params) -> Any:
        return self._pair().param_roles(params)


# -------------------------------------------------------------- mask layers


@dataclass
class MaskLayer(Layer):
    """conf.layers.util.MaskLayer: zero the activations [B, C, T] at the
    steps the network's features mask [B, T] masks; identity without a
    mask."""

    def has_params(self):
        return False

    def forward(self, params, x, it, *, training, rng=None, mask=None):
        if mask is None:
            return x
        return x * torch.as_tensor(mask, device=x.device)[:, None, :].to(x.dtype)


class _Wrapper:
    """What the wrappers share: the wrapped layer's parameters and their
    roles (``Layer.to_json`` nests its configuration under
    ``underlying``)."""

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        return self.underlying.init_params(generator, it, dtype)

    def param_roles(self, params) -> Any:
        return self.underlying.param_roles(params)


@dataclass
class MaskZeroLayer(_Wrapper, Layer):
    """conf.layers.recurrent.MaskZeroLayer: zero the input steps whose every
    feature equals ``mask_value``, then run the wrapped layer."""

    underlying: Optional[Layer] = None
    mask_value: float = 0.0

    def output_type(self, it: InputType) -> InputType:
        return self.underlying.output_type(it)

    def forward(self, params, x, it, *, training, rng=None):
        step_is_pad = torch.all(x == self.mask_value, dim=1, keepdim=True)  # [B, 1, T]
        x = torch.where(step_is_pad, torch.zeros_like(x), x)
        return self.underlying.forward(params, x, it, training=training, rng=rng)


# ------------------------------------------------------- headless loss layers


@dataclass
class _RowsLossLayer(Layer):
    """A loss layer without parameters over [B, C, ...]: the loss of one row
    per timestep, pixel or voxel (channels as the class/feature axis),
    the labels and the labels mask flattened the same way."""

    loss: str = "mse"
    activation: str = "identity"

    def has_params(self):
        return False

    def forward(self, params, x, it, *, training, rng=None):
        return act.get(self.activation)(x)

    def compute_loss(self, params, x, labels, it, *, training, rng=None, mask=None):
        rows = lambda a: a.movedim(1, -1).reshape(-1, a.shape[1])  # noqa: E731
        preds = rows(x).float()
        m = None if mask is None else torch.as_tensor(mask, device=preds.device).reshape(-1)
        return loss_fns.get(self.loss)(rows(labels), act.get(self.activation)(preds), mask=m)


@dataclass
class RnnLossLayer(_RowsLossLayer):
    """conf.layers.RnnLossLayer: the loss at every timestep of [B, C, T]
    without a dense head; a [B, T] labels mask masks steps."""


@dataclass
class CnnLossLayer(_RowsLossLayer):
    """conf.layers.CnnLossLayer: the loss at every pixel of [B, C, H, W]."""


@dataclass
class Cnn3DLossLayer(_RowsLossLayer):
    """conf.layers.Cnn3DLossLayer: the loss at every voxel of NCDHW."""


# ---------------------------------------------------------------- misc tail


@dataclass
class ElementWiseMultiplicationLayer(Layer):
    """conf.layers.misc.ElementWiseMultiplicationLayer: act(x ⊙ W + b),
    nIn == nOut."""

    n_in: int = 0
    n_out: int = 0

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.n_out or it.size)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        n = self.n_out or it.flat_size()
        return {"W": torch.ones((n,), dtype=dtype, device=generator.device),
                "b": torch.zeros((n,), dtype=dtype, device=generator.device)}

    def forward(self, params, x, it, *, training, rng=None):
        x = self._apply_dropout(x, training, rng)
        return act.get(self.activation)(x * params["W"] + params["b"])


@dataclass
class FrozenLayerWithBackprop(_Wrapper, Layer):
    """conf.layers.misc.FrozenLayerWithBackprop: the wrapped layer's
    parameters get no updates (``frozen``: the network zeroes their
    gradients) while the gradient still flows through it to the layers
    before."""

    underlying: Optional[Layer] = None

    def __post_init__(self):
        self.frozen = True

    def output_type(self, it: InputType) -> InputType:
        return self.underlying.output_type(it)

    def has_params(self):
        return self.underlying.has_params()

    def forward(self, params, x, it, *, training, rng=None):
        return self.underlying.forward(params, x, it, training=training, rng=rng)


@dataclass
class TimeDistributed(_Wrapper, Layer):
    """conf.layers.recurrent.TimeDistributed: a feed-forward layer applied
    at every timestep of [B, C, T]."""

    underlying: Optional[Layer] = None

    def output_type(self, it: InputType) -> InputType:
        inner = self.underlying.output_type(InputType.feed_forward(it.size))
        return InputType.recurrent(inner.size, it.timeseries_length)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        return self.underlying.init_params(generator, InputType.feed_forward(it.size), dtype)

    def forward(self, params, x, it, *, training, rng=None):
        B, C, T = x.shape
        out = self.underlying.forward(params, x.transpose(1, 2).reshape(B * T, C),
                                      InputType.feed_forward(C), training=training, rng=rng)
        return out.reshape(B, T, -1).transpose(1, 2)


# ------------------------------------------------------ space/batch reshapes


@dataclass
class SpaceToDepth(Layer):
    """conf.layers.SpaceToDepthLayer: [B, C, H, W] → [B, C·bs², H/bs, W/bs];
    output channel (i·bs + j)·C + c holds input channel c at offset (i, j)
    of its block (TF's order)."""

    block_size: int = 2

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        bs = self.block_size
        return InputType.convolutional(it.height // bs, it.width // bs, it.channels * bs * bs)

    def forward(self, params, x, it, *, training, rng=None):
        B, C, H, W = x.shape
        bs = self.block_size
        x = x.reshape(B, C, H // bs, bs, W // bs, bs).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(B, C * bs * bs, H // bs, W // bs)


@dataclass
class SpaceToBatch(Layer):
    """conf.layers.SpaceToBatchLayer: the blocks move to the batch axis
    (TF's SpaceToBatchND on NCHW): output row (i·bw + j)·B + b is example b
    at block offset (i, j), after the zero ``padding``."""

    block_size: Tuple[int, int] = (2, 2)
    padding: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0))

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        bh, bw = self.block_size
        (pt, pb), (pl, pr) = self.padding
        return InputType.convolutional((it.height + pt + pb) // bh,
                                       (it.width + pl + pr) // bw, it.channels)

    def forward(self, params, x, it, *, training, rng=None):
        bh, bw = self.block_size
        (pt, pb), (pl, pr) = self.padding
        x = F.pad(x, (pl, pr, pt, pb))
        B, C, H, W = x.shape
        x = x.reshape(B, C, H // bh, bh, W // bw, bw).permute(3, 5, 0, 1, 2, 4)
        return x.reshape(bh * bw * B, C, H // bh, W // bw)


# ------------------------------------------------- 1-D / 3-D crop-pad-upsample


@dataclass
class Cropping1D(Layer):
    """conf.layers.convolutional.Cropping1D on [B, C, T]."""

    cropping: Tuple[int, int] = (0, 0)

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        lo, hi = self.cropping
        tl = it.timeseries_length
        return InputType.recurrent(it.size, None if tl is None else tl - lo - hi)

    def forward(self, params, x, it, *, training, rng=None):
        lo, hi = self.cropping
        return x[:, :, lo:x.shape[2] - hi]


@dataclass
class Cropping3D(Layer):
    """conf.layers.convolutional.Cropping3D on NCDHW."""

    cropping: Tuple[int, int, int, int, int, int] = (0, 0, 0, 0, 0, 0)

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        d0, d1, h0, h1, w0, w1 = self.cropping
        return InputType.convolutional3d(it.depth - d0 - d1, it.height - h0 - h1,
                                         it.width - w0 - w1, it.channels)

    def forward(self, params, x, it, *, training, rng=None):
        d0, d1, h0, h1, w0, w1 = self.cropping
        _, _, D, H, W = x.shape
        return x[:, :, d0:D - d1, h0:H - h1, w0:W - w1]


@dataclass
class ZeroPadding1DLayer(Layer):
    """conf.layers.ZeroPadding1DLayer on [B, C, T]."""

    padding: Tuple[int, int] = (0, 0)

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        tl = it.timeseries_length
        return InputType.recurrent(
            it.size, None if tl is None else tl + self.padding[0] + self.padding[1])

    def forward(self, params, x, it, *, training, rng=None):
        return F.pad(x, tuple(self.padding))


@dataclass
class ZeroPadding3DLayer(Layer):
    """conf.layers.ZeroPadding3DLayer on NCDHW."""

    padding: Tuple[int, int, int, int, int, int] = (0, 0, 0, 0, 0, 0)

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        d0, d1, h0, h1, w0, w1 = self.padding
        return InputType.convolutional3d(it.depth + d0 + d1, it.height + h0 + h1,
                                         it.width + w0 + w1, it.channels)

    def forward(self, params, x, it, *, training, rng=None):
        d0, d1, h0, h1, w0, w1 = self.padding
        return F.pad(x, (w0, w1, h0, h1, d0, d1))


@dataclass
class Upsampling1D(Layer):
    """conf.layers.Upsampling1D on [B, C, T]."""

    size: int = 2

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        tl = it.timeseries_length
        return InputType.recurrent(it.size, None if tl is None else tl * self.size)

    def forward(self, params, x, it, *, training, rng=None):
        return x.repeat_interleave(self.size, dim=2)


@dataclass
class Upsampling3D(Layer):
    """conf.layers.Upsampling3D on NCDHW."""

    size: Tuple[int, int, int] = (2, 2, 2)

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        sd, sh, sw = self.size
        return InputType.convolutional3d(it.depth * sd, it.height * sh, it.width * sw,
                                         it.channels)

    def forward(self, params, x, it, *, training, rng=None):
        sd, sh, sw = self.size
        return (x.repeat_interleave(sd, dim=2).repeat_interleave(sh, dim=3)
                .repeat_interleave(sw, dim=4))


@dataclass
class Deconvolution3D(Layer):
    """conf.layers.Deconvolution3D: transposed convolution on NCDHW, weights
    [nIn, nOut, kD, kH, kW] (IODHW). The JAX package applies the kernel as
    stored to the stride-dilated input (``conv_transpose`` without
    ``transpose_kernel``); ``F.conv_transpose3d`` applies it flipped, so the
    port flips it. "same": ``in · stride``, the full transposed output cut
    (or zero-extended) to XLA's SAME window per axis. "truncate": DL4J's
    ``(in − 1) · stride + k``, the full transposed output, which is what the
    JAX forward gives where k >= stride; the JAX ``output_type`` says
    ``in · stride`` in both modes (a reference bug the port does not
    copy)."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (2, 2, 2)
    convolution_mode: str = "same"

    def output_type(self, it: InputType) -> InputType:
        dims = (it.depth, it.height, it.width)
        if self.convolution_mode == "same":
            d, h, w = (n * s for n, s in zip(dims, self.stride))
        else:
            d, h, w = ((n - 1) * s + k for n, s, k in zip(dims, self.stride, self.kernel_size))
        return InputType.convolutional3d(d, h, w, self.n_out)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        n_in = self.n_in or it.channels
        kd, kh, kw = self.kernel_size
        return {"W": init_weights(generator, (n_in, self.n_out, kd, kh, kw), n_in * kd * kh * kw,
                                  self.n_out, self.weight_init, dtype),
                "b": torch.zeros((self.n_out,), dtype=dtype, device=generator.device)}

    def forward(self, params, x, it, *, training, rng=None):
        x = self._apply_dropout(x, training, rng)
        dt = torch.promote_types(x.dtype, params["W"].dtype)
        W = params["W"].to(dt).flip(-3, -2, -1)
        z = F.conv_transpose3d(x.to(dt), W, stride=tuple(self.stride))
        if self.convolution_mode == "same":
            # the full output pads the dilated input by k - 1 on each side;
            # SAME pads it by (lo, hi): crop or extend by the difference
            pads = []
            for k, s in reversed(list(zip(self.kernel_size, self.stride))):
                lo, hi = _transpose_same_pads(k, s)
                pads += [lo - k + 1, hi - k + 1]
            z = F.pad(z, pads)
        z = z + params["b"].to(dt).reshape(1, -1, 1, 1, 1)
        return act.get(self.activation)(z)


def _conv_same(x, W, b=None):
    """Stride-1 2-D convolution with XLA's SAME padding (the odd pad of an
    even kernel at the bottom/right)."""
    (t, bo), (l, r) = (_same_pads(n, k, 1) for n, k in zip(x.shape[2:], W.shape[2:]))
    if t == bo and l == r:
        return F.conv2d(x, W, b, padding=(t, l))
    return F.conv2d(F.pad(x, (l, r, t, bo)), W, b)


@dataclass
class ConvLSTM2D(Layer):
    """Convolutional LSTM (Shi et al. 2015; the Keras ConvLSTM2D import
    target): input [B, C, T, H, W] (time in NCDHW's depth slot), gates i, f,
    c, o (Keras's order) from SAME convolutions of x_t by ``Wx`` [4F, C, kH,
    kW] and of h_{t−1} by ``Wh`` [4F, F, kH, kW], plus ``b`` [4F]; no
    peepholes. The x-side convolutions of all steps are one convolution of
    [B·T, C, H, W] before the loop (the same sum); the first step's h-side
    convolution is of zeros and is left out. ``return_sequences``: [B, F,
    T, H, W], else the last step's [B, F, H, W]."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    return_sequences: bool = True

    def output_type(self, it: InputType) -> InputType:
        if self.return_sequences:
            return InputType.convolutional3d(it.depth, it.height, it.width, self.n_out)
        return InputType.convolutional(it.height, it.width, self.n_out)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        c_in = self.n_in or it.channels
        kh, kw = self.kernel_size
        F_ = self.n_out
        return {"Wx": init_weights(generator, (4 * F_, c_in, kh, kw), c_in * kh * kw, F_,
                                   self.weight_init, dtype),
                "Wh": init_weights(generator, (4 * F_, F_, kh, kw), F_ * kh * kw, F_,
                                   self.weight_init, dtype),
                "b": torch.zeros((4 * F_,), dtype=dtype, device=generator.device)}

    def forward(self, params, x, it, *, training, rng=None):
        x = self._apply_dropout(x, training, rng)
        B, C, T, H, W = x.shape
        g, a = act.get(self.gate_activation), act.get(self.activation)
        dt = torch.promote_types(x.dtype, params["Wx"].dtype)
        Wx, Wh, b = (params[k].to(dt) for k in ("Wx", "Wh", "b"))
        xz = _conv_same(x.to(dt).transpose(1, 2).reshape(B * T, C, H, W), Wx, b)
        xz = xz.reshape(B, T, -1, H, W)
        h = c = None
        outs = []
        for t in range(T):
            z = xz[:, t] if h is None else xz[:, t] + _conv_same(h, Wh)
            i, f, cc, o = z.chunk(4, dim=1)
            c = g(i) * a(cc) if c is None else g(f) * c + g(i) * a(cc)
            h = g(o) * a(c)
            outs.append(h)
        return torch.stack(outs, dim=2) if self.return_sequences else h


@dataclass
class LocallyConnected1D(Layer):
    """conf.layers.LocallyConnected1D: unshared-weight 1-D convolution over
    [B, C, T] ("valid"), one bank [C·k, n_out] per output step, patches
    channel-major as in ``layers_ext.LocallyConnected2D``."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: int = 2
    stride: int = 1
    has_bias: bool = True

    def _out_t(self, it: InputType) -> int:
        return (it.timeseries_length - self.kernel_size) // self.stride + 1

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, self._out_t(it))

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        c_in = self.n_in or it.size
        ot = self._out_t(it)
        fan_in = c_in * self.kernel_size
        p = {"W": init_weights(generator, (ot, fan_in, self.n_out), fan_in, self.n_out,
                               self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.zeros((ot, self.n_out), dtype=dtype, device=generator.device)
        return p

    def forward(self, params, x, it, *, training, rng=None):
        x = self._apply_dropout(x, training, rng)
        patches = F.unfold(x[:, :, None], (1, self.kernel_size), stride=(1, self.stride))
        z = act.get(self.activation)(_local_product(patches, params, self.has_bias))
        return z.transpose(1, 2)  # [B, n_out, OT]


# DL4J's Keras-flavoured alias classes (conf.layers.Convolution2D, Pooling2D,
# Pooling1D extend ConvolutionLayer, SubsamplingLayer and Subsampling1DLayer
# one to one); subclasses, so every isinstance dispatch takes them


class Convolution2D(ConvolutionLayer):
    """conf.layers.Convolution2D — alias of ConvolutionLayer."""


class Pooling2D(SubsamplingLayer):
    """conf.layers.Pooling2D — alias of SubsamplingLayer."""


class Pooling1D(Subsampling1DLayer):
    """conf.layers.Pooling1D — alias of Subsampling1DLayer."""


for _cls in (GravesBidirectionalLSTM, MaskLayer, MaskZeroLayer, RnnLossLayer, CnnLossLayer,
             Cnn3DLossLayer, ElementWiseMultiplicationLayer, FrozenLayerWithBackprop,
             TimeDistributed, SpaceToDepth, SpaceToBatch, Cropping1D, Cropping3D,
             ZeroPadding1DLayer, ZeroPadding3DLayer, Upsampling1D, Upsampling3D, Deconvolution3D,
             Convolution2D, Pooling1D, Pooling2D, ConvLSTM2D, LocallyConnected1D):
    LAYER_REGISTRY[_cls.__name__] = _cls

