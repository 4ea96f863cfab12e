"""Port parity: ``deeplearning4j_tpu_torch.nn.layers_tail`` against the JAX
package's ``nn/layers_tail.py`` on the CPU.

Per layer: the same numpy-seeded input and weights (the JAX layer's
parameter shapes; a nested tree such as GravesBidirectionalLSTM's
``{"fwd", "bwd"}`` as the port's flat ``"fwd/W"`` keys) go into both
packages; the output and the gradients of one seeded cotangent with
respect to the input and every parameter are compared, with
``output_type`` and ``flops_per_example``; loss layers compare the loss
and its gradients under a labels mask. Tolerances, float32: outputs and
losses within 1e-5 (absolute; relative for a loss), each gradient within
1e-5 of its norm.

Deconvolution3D is held to JAX in both modes. In "truncate" mode its JAX
``output_type`` says ``in · stride`` while its forward gives ``(in − 1) ·
stride + k`` (where k >= stride); the port's ``output_type`` follows the
forward, and a test pins the difference.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import layers_tail as JT
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import layers_ext as TE
from deeplearning4j_tpu_torch.nn import layers_tail as TT
from torch_mln_helpers import built_pair, grads_close, layer_parity, layers, t
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

OUT_ATOL = 1e-5   # outputs, absolute
GRAD_REL = 1e-5   # each gradient, of its norm
LOSS_REL = 1e-5   # a loss, relative


def check(build, it, x, seed, **fwd):
    """``build(layers)`` in both packages held to JAX on ``x`` (an array,
    or the shape of a seeded one); returns the port's output."""
    rs = np.random.RandomState(seed)
    jl, tl = built_pair(build)
    if isinstance(x, tuple):
        x = rs.randn(*x).astype(np.float32)
    return layer_parity(jl, tl, it(JC.InputType), x, rs, out_atol=OUT_ATOL, grad_rel=GRAD_REL,
                        **fwd)


def test_graves_bidirectional_matches_jax():
    """Two peephole LSTMs over the two time directions, the outputs summed;
    the JAX ``{"fwd": {...}, "bwd": {...}}`` tree is the port's flat
    ``"fwd/W"`` keys."""
    out = check(lambda L: L.GravesBidirectionalLSTM(n_out=5), lambda I: I.recurrent(3, 6),
                (2, 3, 6), 1)
    assert out.shape == (2, 5, 6)


def test_mask_layers_match_jax():
    """MaskLayer zeroes the masked steps (identity without a mask);
    MaskZeroLayer zeroes the steps whose every feature is ``mask_value``
    before its wrapped LSTM."""
    rs = np.random.RandomState(2)
    x = rs.randn(3, 4, 5).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], np.float32)
    jl, tl = built_pair(lambda L: L.MaskLayer())
    it = JC.InputType.recurrent(4, 5)
    jout = jl.forward({}, jnp.asarray(x), it, training=False, mask=jnp.asarray(mask))
    tout = tl.forward({}, torch.from_numpy(x), None, training=False, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tl.forward({}, torch.from_numpy(x), None, training=False) is not None
    xs = x.copy()
    xs[0, :, 3:] = 2.5
    xs[2, :, 1] = 2.5
    out = check(lambda L: L.MaskZeroLayer(underlying=L.LSTM(n_out=6), mask_value=2.5),
                lambda I: I.recurrent(4, 5), xs, 3)
    assert out.shape == (3, 6, 5)


LOSSES = {
    "rnn": (lambda L: L.RnnLossLayer(loss="mcxent", activation="softmax"), (3, 4, 5), (3, 5)),
    "cnn": (lambda L: L.CnnLossLayer(loss="xent", activation="sigmoid"), (2, 3, 4, 5),
            (2, 4, 5)),
    "cnn3d": (lambda L: L.Cnn3DLossLayer(loss="mse"), (2, 3, 2, 3, 4), (2, 2, 3, 4)),
}


@pytest.mark.parametrize("kind", list(LOSSES))
def test_loss_layers_match_jax(kind):
    """The loss over one row per timestep, pixel or voxel, the labels and
    the labels mask flattened the same way; and the forward (the
    activation)."""
    build, shape, mask_shape = LOSSES[kind]
    rs = np.random.RandomState(4)
    x = rs.randn(*shape).astype(np.float32)
    if kind == "rnn":
        y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, (3, 5))].transpose(0, 2, 1)
    else:
        y = rs.rand(*shape).astype(np.float32)
    mask = (rs.rand(*mask_shape) > 0.3).astype(np.float32)
    jl, tl = built_pair(build)
    for m in (None, mask):
        jv, jg = jax.value_and_grad(lambda xx: jl.compute_loss(
            {}, xx, jnp.asarray(y), None, training=False,
            mask=None if m is None else jnp.asarray(m)))(jnp.asarray(x))
        tx = t(x, True)
        tv = tl.compute_loss({}, tx, t(y), None, training=False,
                             mask=None if m is None else t(m))
        (tg,) = torch.autograd.grad(tv, [tx])
        np.testing.assert_allclose(float(tv), float(jv), rtol=LOSS_REL)
        grads_close({"x": tg}, {"x": np.asarray(jg)}, GRAD_REL)
    it = (lambda I: I.recurrent(4, 5)) if kind == "rnn" else (
        (lambda I: I.convolutional(4, 5, 3)) if kind == "cnn"
        else (lambda I: I.convolutional3d(2, 3, 4, 3)))
    check(build, it, x, 5)


def test_wrappers_and_elementwise_match_jax():
    """ElementWiseMultiplicationLayer: act(x ⊙ W + b); the wrappers take
    their wrapped layer's parameters (FrozenLayerWithBackprop passes the
    gradient through to its input); TimeDistributed applies a dense layer at
    every step."""
    cases = [
        (lambda L: L.ElementWiseMultiplicationLayer(n_out=6, activation="tanh"),
         lambda I: I.feed_forward(6), (3, 6)),
        (lambda L: L.FrozenLayerWithBackprop(underlying=L.DenseLayer(n_out=4, activation="relu")),
         lambda I: I.feed_forward(5), (3, 5)),
        (lambda L: L.TimeDistributed(underlying=L.DenseLayer(n_out=4, activation="sigmoid")),
         lambda I: I.recurrent(3, 6), (2, 3, 6)),
    ]
    for i, (build, it, shape) in enumerate(cases):
        check(build, it, shape, 6 + i)
    assert TT.FrozenLayerWithBackprop(underlying=TC.DenseLayer(n_out=2)).frozen


def test_block_orders_match_jax():
    """SpaceToDepth and SpaceToBatch keep TF's block orders on NCHW: every
    input value is distinct (an arange), so the outputs are equal only if
    every value lands where JAX puts it."""
    x = np.arange(2 * 3 * 4 * 6, dtype=np.float32).reshape(2, 3, 4, 6)
    for build, it in (
            (lambda L: L.SpaceToDepth(block_size=2), lambda I: I.convolutional(4, 6, 3)),
            (lambda L: L.SpaceToBatch(block_size=(2, 3), padding=((1, 1), (0, 3))),
             lambda I: I.convolutional(4, 6, 3))):
        jl, tl = built_pair(build)
        jit = it(JC.InputType)
        jout = np.asarray(jl.forward({}, jnp.asarray(x), jit, training=False))
        tout = tl.forward({}, torch.from_numpy(x), it(TC.InputType), training=False)
        np.testing.assert_array_equal(tout.numpy(), jout)
        check(build, it, (2, 3, 4, 6), 8)
    assert TT.SpaceToDepth(block_size=2).forward({}, torch.from_numpy(x), None,
                                                 training=False)[0, 3, 0, 0] == x[0, 0, 0, 1]


def test_crop_pad_upsample_match_jax():
    cases = [
        (lambda L: L.Cropping1D(cropping=(1, 2)), lambda I: I.recurrent(3, 7), (2, 3, 7)),
        (lambda L: L.Cropping3D(cropping=(1, 0, 0, 2, 1, 1)),
         lambda I: I.convolutional3d(4, 5, 6, 2), (2, 2, 4, 5, 6)),
        (lambda L: L.ZeroPadding1DLayer(padding=(2, 1)), lambda I: I.recurrent(3, 5), (2, 3, 5)),
        (lambda L: L.ZeroPadding3DLayer(padding=(1, 0, 2, 1, 0, 3)),
         lambda I: I.convolutional3d(2, 3, 4, 2), (2, 2, 2, 3, 4)),
        (lambda L: L.Upsampling1D(size=3), lambda I: I.recurrent(3, 4), (2, 3, 4)),
        (lambda L: L.Upsampling3D(size=(2, 1, 3)), lambda I: I.convolutional3d(2, 3, 2, 2),
         (2, 2, 2, 3, 2)),
    ]
    for i, (build, it, shape) in enumerate(cases):
        check(build, it, shape, 9 + i)


DECONV3D = {
    "same_k3_s2": dict(kernel_size=(3, 2, 4), stride=(2, 2, 1), convolution_mode="same"),
    "same_k2_s2": dict(kernel_size=(2, 2, 2), stride=(2, 2, 2), convolution_mode="same"),
    "truncate": dict(kernel_size=(3, 2, 4), stride=(2, 2, 1), convolution_mode="truncate"),
}


@pytest.mark.parametrize("case", list(DECONV3D))
def test_deconvolution3d_matches_jax(case):
    """The kernel applied as stored to the stride-dilated input (the port
    flips it for ``F.conv_transpose3d``); "same" cut to XLA's window per
    axis. Truncate mode's ``output_type`` differs from JAX's (the next
    test), so its output is held here without it."""
    kw = DECONV3D[case]
    it = JC.InputType.convolutional3d(3, 4, 5, 2)
    rs = np.random.RandomState(12)
    x = rs.randn(2, 2, 3, 4, 5).astype(np.float32)
    jl, tl = built_pair(lambda L: L.Deconvolution3D(n_out=3, activation="tanh", **kw))
    if kw["convolution_mode"] == "same":
        out = layer_parity(jl, tl, it, x, rs, out_atol=OUT_ATOL, grad_rel=GRAD_REL)
        assert tuple(out.shape[2:]) == tuple(n * s for n, s in zip((3, 4, 5), kw["stride"]))
        return
    params = {"W": rs.randn(2, 3, 3, 2, 4).astype(np.float32), "b": rs.randn(3).astype(np.float32)}
    cot = rs.randn(2, 3, 7, 8, 8).astype(np.float32)
    jout, vjp = jax.vjp(lambda p, xx: jl.forward(p, xx, it, training=False),
                        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(cot))
    tp = {k: t(v, True) for k, v in params.items()}
    tx = t(x, True)
    tout = tl.forward(tp, tx, TC.InputType(**JC.dataclasses.asdict(it)), training=False)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=0, atol=OUT_ATOL)
    gs = torch.autograd.grad(tout, [tp["W"], tp["b"], tx], grad_outputs=t(cot))
    grads_close(dict(zip(("W", "b", "x"), gs)),
                {"W": np.asarray(jgp["W"]), "b": np.asarray(jgp["b"]), "x": np.asarray(jgx)},
                GRAD_REL)


def test_deconvolution3d_truncate_output_type_reference_bug():
    """A JAX reference bug: in truncate mode its forward gives (in − 1) · s
    + k (in = 5: k=3 s=2 → 11, k=3 s=1 → 7, k=4 s=2 → 12) while its
    ``output_type`` says in · s (10, 5, 10). The port's ``output_type``
    gives the forward's size, which is DL4J's truncate formula."""
    rs = np.random.RandomState(13)
    x = rs.randn(1, 2, 5, 5, 5).astype(np.float32)
    it = JC.InputType.convolutional3d(5, 5, 5, 2)
    tit = TC.InputType.convolutional3d(5, 5, 5, 2)
    for k, s, forward, jax_type in ((3, 2, 11, 10), (3, 1, 7, 5), (4, 2, 12, 10)):
        jl, tl = built_pair(lambda L: L.Deconvolution3D(
            n_out=3, kernel_size=(k, k, k), stride=(s, s, s), convolution_mode="truncate"))
        params = {"W": rs.randn(2, 3, k, k, k).astype(np.float32), "b": np.zeros(3, np.float32)}
        jout = jl.forward({n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x), it,
                          training=False)
        tout = tl.forward({n: torch.from_numpy(v) for n, v in params.items()},
                          torch.from_numpy(x), tit, training=False)
        assert jout.shape[2:] == tout.shape[2:] == (forward,) * 3
        assert jl.output_type(it).depth == jax_type
        assert tl.output_type(tit) == TC.InputType.convolutional3d(forward, forward, forward, 3)


CONVLSTM = {
    "odd_sequences": (dict(n_out=4, kernel_size=(3, 3)), (2, 3, 4, 5, 6)),
    "even_kernel_last": (dict(n_out=3, kernel_size=(2, 4), return_sequences=False,
                              gate_activation="hardsigmoid"), (2, 2, 3, 4, 5)),
}


@pytest.mark.parametrize("case", list(CONVLSTM))
def test_convlstm_matches_jax(case):
    """Gates i, f, c, o from SAME convolutions (asymmetric for an even
    kernel); the x-side convolutions hoisted out of the loop sum the same
    terms; [B, F, T, H, W] or the last step."""
    kw, shape = CONVLSTM[case]
    B, C, T, H, W = shape
    out = check(lambda L: L.ConvLSTM2D(**kw), lambda I: I.convolutional3d(T, H, W, C), shape, 14)
    want = (B, kw["n_out"], T, H, W) if kw.get("return_sequences", True) else (B, 3, H, W)
    assert tuple(out.shape) == want


def test_aliases_take_every_isinstance_dispatch():
    """Convolution2D, Pooling2D and Pooling1D are subclasses of the layers
    they alias: the preprocessor inference and the first-layer input-type
    check take them, and their JSON names them."""
    assert issubclass(TT.Convolution2D, TC.ConvolutionLayer)
    assert issubclass(TT.Pooling2D, TC.SubsamplingLayer)
    assert issubclass(TT.Pooling1D, TE.Subsampling1DLayer)
    flat = TC.InputType.convolutional_flat(6, 6, 1)
    for layer in (TT.Convolution2D(n_out=2), TT.Pooling2D()):
        assert isinstance(TC.infer_preprocessor(flat, layer), TC.FeedForwardToCnnPreProcessor)
        with pytest.raises(ValueError, match="first layer is convolutional"):
            TC.MultiLayerConfiguration(layers=[layer]).input_types()
    assert TT.Pooling1D(kernel_size=3).to_json()["@class"] == "Pooling1D"
    check(lambda L: L.Convolution2D(n_out=3, kernel_size=(2, 2), convolution_mode="same"),
          lambda I: I.convolutional(5, 5, 2), (2, 2, 5, 5), 15)
    check(lambda L: L.Pooling2D(pooling_type="avg", convolution_mode="same"),
          lambda I: I.convolutional(5, 5, 2), (2, 2, 5, 5), 16)


def _every_layer(L):
    """One instance of each class ``layers_tail`` registers, away from its
    defaults, with the wrappers nested two deep."""
    return [
        L.GravesBidirectionalLSTM(n_out=4, gate_activation="hardsigmoid"),
        L.MaskLayer(),
        L.MaskZeroLayer(underlying=L.LSTM(n_out=3), mask_value=-1.0),
        L.RnnLossLayer(loss="mcxent", activation="softmax"),
        L.CnnLossLayer(loss="xent"),
        L.Cnn3DLossLayer(activation="sigmoid"),
        L.ElementWiseMultiplicationLayer(n_out=5),
        L.FrozenLayerWithBackprop(underlying=L.TimeDistributed(
            underlying=L.DenseLayer(n_out=3, l2=1e-3))),
        L.TimeDistributed(underlying=L.DenseLayer(n_out=2, activation="relu")),
        L.SpaceToDepth(block_size=3),
        L.SpaceToBatch(block_size=(2, 3), padding=((0, 1), (2, 0))),
        L.Cropping1D(cropping=(1, 1)),
        L.Cropping3D(cropping=(0, 1, 1, 0, 2, 2)),
        L.ZeroPadding1DLayer(padding=(1, 2)),
        L.ZeroPadding3DLayer(padding=(1, 1, 0, 0, 2, 2)),
        L.Upsampling1D(size=3),
        L.Upsampling3D(size=(1, 2, 2)),
        L.Deconvolution3D(n_out=3, kernel_size=(3, 3, 3), convolution_mode="truncate"),
        L.Convolution2D(n_out=4, kernel_size=(5, 5)),
        L.Pooling1D(pooling_type="avg"),
        L.Pooling2D(kernel_size=(3, 3)),
        L.ConvLSTM2D(n_out=6, kernel_size=(5, 5), return_sequences=False),
        L.LocallyConnected1D(n_out=3, kernel_size=4, has_bias=False),
    ]


def test_json_and_nested_wrapper_round_trip():
    """Each layer's JSON is the JAX package's, character for character (a
    wrapper nests its wrapped layer's under ``underlying``, two deep here,
    and FrozenLayerWithBackprop says ``frozen``), and reads back in both
    packages; the 23 are all that ``layers_tail`` registers."""
    jlayers, tlayers = _every_layer(layers(False)), _every_layer(layers(True))
    assert {type(l).__name__ for l in tlayers} == {
        n for n, c in JC.LAYER_REGISTRY.items() if c.__module__ == JT.__name__}
    assert len(tlayers) == 23
    for jl, tl in zip(jlayers, tlayers):
        text = json.dumps(tl.to_json())
        assert text == json.dumps(jl.to_json()), type(tl).__name__
        back = TC.Layer.from_json(json.loads(text))
        assert type(back) is type(tl) and json.dumps(back.to_json()) == text
        assert json.dumps(JC.Layer.from_json(json.loads(text)).to_json()) == text
    frozen = TC.Layer.from_json(json.loads(json.dumps(tlayers[7].to_json())))
    assert frozen.frozen and isinstance(frozen.underlying, TT.TimeDistributed)
    assert isinstance(frozen.underlying.underlying, TC.DenseLayer)
    assert frozen.underlying.underlying.l2 == 1e-3
