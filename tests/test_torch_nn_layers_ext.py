"""Port parity: the convolution and shape layers the image zoo needs
(``deeplearning4j_tpu_torch.nn.conf``: DepthwiseConvolution2D,
SeparableConvolution2D, Deconvolution2D, Upsampling2D, ZeroPaddingLayer,
LocalResponseNormalization) against the JAX package's, on the CPU; the
configurations' JSON; and the layer registry.

Per layer: the same numpy-seeded input and weights go into both packages;
the output and the gradients of one seeded cotangent with respect to the
input and to every parameter (``jax.vjp``) are compared. Tolerances,
float32: outputs within 1e-5 absolute, each gradient within 1e-5 of its
norm.

Deconvolution2D is held to JAX in "same" mode and in "truncate" mode where
2 · padding = k − 1. Elsewhere in truncate mode the JAX forward (which pads
the stride-dilated input by ``padding``) disagrees with its own
``output_type`` (DL4J's ``(in − 1) · s + k − 2p``); the port follows
``output_type``, and a test pins the difference.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn import conf as TC
from torch_float64_step import _batch, lrn_stack
from torch_mln_helpers import layer_parity, pair, params_close, port_net, snapshot
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

OUT_ATOL = 1e-5   # outputs, absolute
GRAD_REL = 1e-5   # each gradient, of its norm
LOSS_REL = 1e-5   # a fit's score, relative
UPDATE_REL = 1e-5  # each parameter's update in a fit, of its norm


def _check(cls_name, it, x_shape, seed, **kw):
    rs = np.random.RandomState(seed)
    jl, tl = pair(cls_name, **kw)
    x = rs.randn(*x_shape).astype(np.float32)
    return layer_parity(jl, tl, it, x, rs, out_atol=OUT_ATOL, grad_rel=GRAD_REL)


@pytest.mark.parametrize("multiplier", [1, 2])
def test_depthwise_convolution_matches_jax(multiplier):
    """Output channel o reads input channel o // m in both packages (XLA's
    feature groups and PyTorch's ``groups`` order them alike): pinned at
    m = 2. m = 1 runs SAME at stride 2 on an odd size, m = 2 explicit
    padding with dilation."""
    kw = (dict(kernel_size=(3, 3), stride=(2, 2), convolution_mode="same") if multiplier == 1
          else dict(kernel_size=(3, 2), padding=(1, 2), dilation=(2, 1)))
    out = _check("DepthwiseConvolution2D", JC.InputType.convolutional(9, 8, 3), (2, 3, 9, 8),
                 10 + multiplier, depth_multiplier=multiplier, activation="tanh", **kw)
    assert out.shape[1] == 3 * multiplier


SEPARABLE = {
    "s1_same_even": dict(kernel_size=(3, 3), convolution_mode="same", hw=(8, 8)),
    "s2_same_even": dict(kernel_size=(3, 3), stride=(2, 2), convolution_mode="same", hw=(8, 10)),
    "s2_same_odd": dict(kernel_size=(5, 5), stride=(2, 2), convolution_mode="same", hw=(9, 7)),
    "s1_truncate_m2": dict(kernel_size=(3, 3), padding=(1, 0), depth_multiplier=2, hw=(7, 6)),
}


@pytest.mark.parametrize("case", list(SEPARABLE))
def test_separable_convolution_matches_jax(case):
    """The depthwise product, then the 1x1 product on ``pW``, the bias after
    both; SAME pads the odd row or column at the end, as XLA does."""
    kw = dict(SEPARABLE[case])
    h, w = kw.pop("hw")
    _check("SeparableConvolution2D", JC.InputType.convolutional(h, w, 3), (2, 3, h, w), 20,
           n_out=4, activation="relu", **kw)


DECONV_SAME = [(2, 2), (3, 2), (4, 2), (5, 1)]


@pytest.mark.parametrize("k,s", DECONV_SAME)
def test_deconvolution_same_matches_jax(k, s):
    """"same": the output is ``in · stride``; ``F.conv_transpose2d`` on the
    flipped kernel, cut to XLA's SAME window (offset (k − s) // 2)."""
    out = _check("Deconvolution2D", JC.InputType.convolutional(5, 6, 3), (2, 3, 5, 6), 30 + k,
                 n_out=4, kernel_size=(k, k), stride=(s, s), convolution_mode="same",
                 activation="tanh")
    assert tuple(out.shape[2:]) == (5 * s, 6 * s)


@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (3, 2, 1), (5, 2, 2)])
def test_deconvolution_truncate_matches_jax_where_it_is_consistent(k, s, p):
    """Truncate mode where 2p = k − 1: the JAX forward and DL4J's formula
    agree, and so do the packages."""
    out = _check("Deconvolution2D", JC.InputType.convolutional(5, 4, 2), (2, 2, 5, 4), 40 + k,
                 n_out=3, kernel_size=(k, k), stride=(s, s), padding=(p, p))
    assert tuple(out.shape[2:]) == ((5 - 1) * s + k - 2 * p, (4 - 1) * s + k - 2 * p)


def test_deconvolution_truncate_reference_bug_is_not_copied():
    """A JAX reference bug: in truncate mode its forward pads the dilated
    input by ``padding``, giving (in − 1) · s + 2p − k + 2, while its own
    ``output_type`` says DL4J's (in − 1) · s + k − 2p. At in = 5: k=3 s=2
    p=0 gives 7 (forward) against 11; k=4 s=2 p=1 8 against 10; k=2 s=2
    p=0 8 against 10. The port's output has ``output_type``'s shape: the
    transposed convolution of the flipped kernel, cropped by p."""
    rs = np.random.RandomState(50)
    x = rs.randn(1, 2, 5, 5).astype(np.float32)
    it = JC.InputType.convolutional(5, 5, 2)
    for (k, s, p), jax_forward, dl4j in (((3, 2, 0), 7, 11), ((4, 2, 1), 8, 10),
                                         ((2, 2, 0), 8, 10)):
        jl, tl = pair("Deconvolution2D", n_out=3, kernel_size=(k, k), stride=(s, s),
                      padding=(p, p))
        w = rs.randn(2, 3, k, k).astype(np.float32)
        params = {"W": w, "b": np.zeros(3, np.float32)}
        jout = jl.forward({n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x), it,
                          training=False)
        tout = tl.forward({n: torch.from_numpy(v) for n, v in params.items()},
                          torch.from_numpy(x), it, training=False)
        assert jl.output_type(it).height == tl.output_type(it).height == dl4j
        assert jout.shape[2] == jax_forward
        assert tuple(tout.shape) == (1, 3, dl4j, dl4j)
        want = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x), torch.from_numpy(w).flip(-2, -1), stride=s, padding=p)
        assert torch.equal(tout, want)


SHAPE_LAYERS = {
    "upsampling": ("Upsampling2D", dict(size=(2, 3))),
    "zero_padding": ("ZeroPaddingLayer", dict(padding=(1, 2, 0, 3))),
    "lrn_default": ("LocalResponseNormalization", {}),
    "lrn_even_window": ("LocalResponseNormalization", dict(k=1.0, n=4, alpha=0.3, beta=0.5)),
}


@pytest.mark.parametrize("case", list(SHAPE_LAYERS))
def test_shape_layers_match_jax(case):
    """Upsampling2D repeats each pixel (nearest), ZeroPaddingLayer pads
    (top, bottom, left, right), LRN sums x² over n channels with n // 2
    zero channels on each side and does not divide alpha by n (an even n
    takes one more channel before than after)."""
    cls_name, kw = SHAPE_LAYERS[case]
    _check(cls_name, JC.InputType.convolutional(5, 4, 6), (2, 6, 5, 4), 60, **kw)


def _new_layers(C):
    """One instance of each layer this module and
    ``test_torch_nn_layers_ext_rnn.py`` hold to JAX, away from its defaults."""
    return [
        C.Deconvolution2D(n_out=4, kernel_size=(4, 4), stride=(2, 2), convolution_mode="same"),
        C.DepthwiseConvolution2D(depth_multiplier=2, kernel_size=(5, 5), l2=1e-4),
        C.SeparableConvolution2D(n_out=8, stride=(2, 2), has_bias=False, dropout=0.8),
        C.Upsampling2D(size=(3, 2)),
        C.ZeroPaddingLayer(padding=(1, 0, 2, 0)),
        C.LocalResponseNormalization(n=3, beta=0.5),
        C.EmbeddingLayer(n_in=10, n_out=4, has_bias=True),
        C.EmbeddingSequenceLayer(n_in=12, n_out=5, activation="tanh"),
        C.SimpleRnn(n_out=6, weight_init="relu"),
        C.Bidirectional(fwd=C.LSTM(n_out=4, gate_activation="hardsigmoid"), mode="average",
                        name="bi"),
    ]


def test_json_equals_jax_and_the_registry_is_complete():
    """Each new layer's JSON is the JAX package's, character for character
    (Bidirectional nests its wrapped layer under ``fwd``), and reads back;
    the port's registry holds every class of the JAX package's
    ``nn/conf.py`` registry."""
    for jl, tl in zip(_new_layers(JC), _new_layers(TC)):
        text = json.dumps(tl.to_json())
        assert text == json.dumps(jl.to_json()), type(tl).__name__
        assert json.dumps(TC.Layer.from_json(json.loads(text)).to_json()) == text
    jax_conf_layers = {n for n, c in JC.LAYER_REGISTRY.items() if c.__module__ == JC.__name__}
    assert len(jax_conf_layers) == 23 and jax_conf_layers <= set(TC.LAYER_REGISTRY)
    # with the rest of the layer set ported, the registries are equal and an
    # unknown name raises as the JAX package's lookup does
    assert set(TC.LAYER_REGISTRY) == set(JC.LAYER_REGISTRY) and len(TC.LAYER_REGISTRY) == 66
    assert TC.layer_class("PReLULayer").__name__ == "PReLULayer"
    with pytest.raises(KeyError):
        TC.layer_class("NoSuchLayer")


def test_conv_stack_fit_matches_jax():
    """The new layers inside a MultiLayerNetwork (``lrn_stack``: ZeroPadding
    → Depthwise → Separable → LRN → Upsampling2D → Deconvolution2D → max
    pool → softmax): the same configuration JSON, ``output()`` and one Adam
    step from the JAX network's weights.

    JAX's step runs eagerly (``jax.disable_jit``): through LRN's power
    (alpha 0.1) its XLA-compiled CPU step lies further from a float64 step
    than its eager one (``python3 tests/torch_float64_step.py --jax
    --threads 1 --only lrn_stack`` prints both), a difference of the
    compiler's that the port does not copy."""
    jnet = JNet(lrn_stack(JC, JU)).init()
    tnet = port_net(jnet)
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert tnet.num_params() == jnet.num_params()
    x, y = _batch((2, 9, 8), 3, 4)
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x).numpy()),
                               rtol=0, atol=OUT_ATOL)
    before = snapshot(jnet)
    with jax.disable_jit():
        jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert abs(tnet.score_ - float(jnet.score_)) <= LOSS_REL * abs(float(jnet.score_))
    params_close(tnet, jnet, before, rel=UPDATE_REL)
