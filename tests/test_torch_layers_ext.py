"""Port parity: ``deeplearning4j_tpu_torch.nn.layers_ext`` against the JAX
package's ``nn/layers_ext.py`` on the CPU (with LocallyConnected1D, the
twin of LocallyConnected2D in ``layers_tail``).

Per layer: the same numpy-seeded input and weights (the JAX layer's
parameter shapes) go into both packages; the output and the gradients of
one seeded cotangent with respect to the input and every parameter
(``jax.vjp``) are compared, with ``output_type`` and
``flops_per_example``. Loss heads compare the loss and its gradients.
Tolerances, float32: outputs and losses within 1e-5 (absolute; relative
for a loss), each gradient within 1e-5 of its norm.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import layers_ext as JE
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import layers_ext as TE
from torch_mln_helpers import (built_pair, flat_tree, grads_close, layer_parity, layers, t)
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

OUT_ATOL = 1e-5   # outputs, absolute
GRAD_REL = 1e-5   # each gradient, of its norm
LOSS_REL = 1e-5   # a loss, relative


def check(build, it, x_shape, seed, x=None):
    """``build(layers)`` in both packages, held to JAX on input ``x`` (or a
    seeded one of ``x_shape``); returns the port's output."""
    rs = np.random.RandomState(seed)
    jl, tl = built_pair(build)
    if x is None:
        x = rs.randn(*x_shape).astype(np.float32)
    return layer_parity(jl, tl, it(JC.InputType), x, rs, out_atol=OUT_ATOL, grad_rel=GRAD_REL)


CONV3D = {
    "same_odd_stride": (dict(n_out=4, kernel_size=(3, 2, 3), stride=(2, 1, 2),
                             convolution_mode="same", activation="tanh"), (5, 6, 7, 3)),
    "same_even_dilated": (dict(n_out=3, kernel_size=(2, 2, 2), dilation=(2, 1, 1),
                               convolution_mode="same"), (6, 4, 5, 2)),
    "truncate_padded": (dict(n_out=5, kernel_size=(3, 3, 2), stride=(1, 2, 1), padding=(1, 0, 1),
                             has_bias=False, activation="relu"), (4, 7, 5, 3)),
}


@pytest.mark.parametrize("case", list(CONV3D))
def test_convolution3d_matches_jax(case):
    """OIDHW weights on NCDHW volumes; SAME pads the odd cell at the end of
    each axis, also with dilation; explicit padding is symmetric."""
    kw, (d, h, w, c) = CONV3D[case]
    check(lambda L: L.Convolution3D(**kw), lambda I: I.convolutional3d(d, h, w, c),
          (2, c, d, h, w), 1)


POOLS = {
    "3d": [("Subsampling3DLayer", dict(kernel_size=(3, 3, 2), stride=(2, 2, 2), **mode))
           for mode in (dict(convolution_mode="same"), dict(padding=(1, 1, 0)), {})],
    "1d": [("Subsampling1DLayer", dict(kernel_size=3, stride=2, **mode))
           for mode in (dict(convolution_mode="same"), {})]
          + [("Pooling1D", dict(kernel_size=4, stride=3, convolution_mode="same"))],
}


@pytest.mark.parametrize("dims", list(POOLS))
def test_pooling_counts_only_live_cells(dims):
    """Max pooling pads with -inf; average pooling divides each window's sum
    by its cells that are not padding, in SAME mode (asymmetric pads at
    odd and even sizes) and with explicit padding. The ones input pins the
    count: every average of ones is exactly 1."""
    for cls_name, kw in POOLS[dims]:
        for kind in ("max", "avg"):
            build = lambda L: getattr(L, cls_name)(pooling_type=kind, **kw)  # noqa: E731
            for size in (7, 8):
                if dims == "3d":
                    it, shape = (lambda I: I.convolutional3d(5, size, 6, 2)), (2, 2, 5, size, 6)
                else:
                    it, shape = (lambda I: I.recurrent(3, size)), (2, 3, size)
                check(build, it, shape, size)
                ones = np.ones(shape, np.float32)
                tl = build(layers(True))
                out = tl.forward({}, torch.from_numpy(ones), None, training=False)
                assert torch.equal(out, torch.ones_like(out)), (cls_name, kind, size)


@pytest.mark.parametrize("case", ["same_even_kernel", "truncate"])
def test_convolution1d_matches_jax(case):
    kw = (dict(kernel_size=4, stride=2, convolution_mode="same") if case == "same_even_kernel"
          else dict(kernel_size=3, convolution_mode="truncate", has_bias=False))
    out = check(lambda L: L.Convolution1DLayer(n_out=5, activation="tanh", **kw),
                lambda I: I.recurrent(3, 9), (2, 3, 9), 2)
    assert out.shape[2] == (5 if case == "same_even_kernel" else 7)


LOCAL = {
    "2d_truncate_padded": (lambda L: L.LocallyConnected2D(n_out=4, kernel_size=(3, 2),
                                                          stride=(1, 2), padding=(1, 1),
                                                          activation="tanh"),
                           lambda I: I.convolutional(6, 7, 3), (2, 3, 6, 7)),
    "2d_same": (lambda L: L.LocallyConnected2D(n_out=3, kernel_size=(2, 2), stride=(2, 2),
                                               convolution_mode="same"),
                lambda I: I.convolutional(5, 6, 2), (2, 2, 5, 6)),
    "1d": (lambda L: L.LocallyConnected1D(n_out=4, kernel_size=3, stride=2, activation="relu"),
           lambda I: I.recurrent(3, 9), (2, 3, 9)),
}


@pytest.mark.parametrize("case", list(LOCAL))
def test_locally_connected_matches_jax(case):
    """One bank per output position; ``F.unfold`` orders a patch's features
    channel-major, as ``conv_general_dilated_patches`` does (pinned at
    c_in > 1); one batched product over positions."""
    build, it, shape = LOCAL[case]
    check(build, it, shape, 3)


def test_prelu_and_cropping_match_jax():
    """PReLU's alpha per feature, shared along ``shared_axes`` (1-indexed
    past the batch), on image, sequence and flat inputs; Cropping2D's
    (top, bottom, left, right)."""
    cases = [
        (lambda L: L.PReLULayer(shared_axes=(2, 3)), lambda I: I.convolutional(4, 5, 3),
         (2, 3, 4, 5)),
        (lambda L: L.PReLULayer(), lambda I: I.recurrent(4, 6), (2, 4, 6)),
        (lambda L: L.PReLULayer(), lambda I: I.feed_forward(7), (3, 7)),
        (lambda L: L.Cropping2D(cropping=(1, 0, 2, 1)), lambda I: I.convolutional(5, 6, 2),
         (2, 2, 5, 6)),
    ]
    for i, (build, it, shape) in enumerate(cases):
        check(build, it, shape, 10 + i)


def test_keras_shape_layers_match_jax():
    """Reshape and Permute apply in the Keras layout (NHWC, [B, T, F]) and
    convert back; RepeatVector gives [B, F, n]."""
    cases = [
        (lambda L: L.ReshapeLayer(target_shape=(12, 3)), lambda I: I.convolutional(3, 4, 3),
         (2, 3, 3, 4)),
        (lambda L: L.ReshapeLayer(target_shape=(2, 3, 4)), lambda I: I.recurrent(4, 6),
         (2, 4, 6)),
        (lambda L: L.PermuteLayer(dims=(2, 1)), lambda I: I.recurrent(3, 5), (2, 3, 5)),
        (lambda L: L.PermuteLayer(dims=(2, 1, 3)), lambda I: I.convolutional(3, 4, 2),
         (2, 2, 3, 4)),
        (lambda L: L.RepeatVectorLayer(n=3), lambda I: I.feed_forward(5), (2, 5)),
    ]
    for i, (build, it, shape) in enumerate(cases):
        check(build, it, shape, 20 + i)


@pytest.mark.parametrize("reset_after", [True, False])
def test_gru_matches_jax(reset_after):
    """Keras's gate order (z, r, candidate); ``reset_after`` applies r to
    h·RW + rb, otherwise the candidate is (r ⊙ h)·RW[:, 2H:] without
    ``rb``."""
    out = check(lambda L: L.GRULayer(n_out=5, reset_after=reset_after, gate_activation="sigmoid"),
                lambda I: I.recurrent(4, 7), (3, 4, 7), 30)
    assert out.shape == (3, 5, 7)


def _loss_parity(jl, tl, it, x, labels, rs):
    """The head's loss and its gradients (input and parameters) in both
    packages, from the JAX parameter shapes filled from ``rs``."""
    shapes = jax.tree.map(lambda a: a.shape, jl.init_params(jax.random.key(0), it))
    params = jax.tree.map(lambda s: np.asarray(rs.randn(*s) * 0.5, np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))

    def jloss(p, xx):
        return jl.compute_loss(p, xx, jnp.asarray(labels), it, training=False)

    jv, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: t(v, True) for k, v in flat_tree(params).items()}
    tx = t(x, True)
    tit = TC.InputType(**JC.dataclasses.asdict(it))
    tv = tl.compute_loss(tp, tx, t(labels), tit, training=False)
    gs = torch.autograd.grad(tv, list(tp.values()) + [tx])
    np.testing.assert_allclose(float(tv), float(jv), rtol=LOSS_REL)
    grads_close(dict(zip(list(tp) + ["x"], gs)),
                {**flat_tree(jax.tree.map(np.asarray, jgp)), "x": np.asarray(jgx)}, GRAD_REL)
    return tp


def test_center_loss_and_ocnn_heads_match_jax():
    """CenterLoss: softmax cross-entropy plus lambda/2 · |f − c_y|² with the
    centers a parameter; OCNN: the objective with the 0-d margin ``r``
    (its gradient is a 0-d tensor in both)."""
    rs = np.random.RandomState(40)
    it = JC.InputType.feed_forward(6)
    x = rs.randn(5, 6).astype(np.float32)
    jl, tl = built_pair(lambda L: L.CenterLossOutputLayer(n_out=4, lambda_=0.3))
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 5)]
    _loss_parity(jl, tl, it, x, y, rs)
    layer_parity(jl, tl, it, x, rs, out_atol=OUT_ATOL, grad_rel=GRAD_REL)
    jl, tl = built_pair(lambda L: L.OCNNOutputLayer(hidden_size=3, nu=0.2))
    tp = _loss_parity(jl, tl, it, x, np.zeros((5, 1), np.float32), rs)
    assert tp["r"].dim() == 0
    layer_parity(jl, tl, it, x, rs, out_atol=OUT_ATOL, grad_rel=GRAD_REL)


def _every_layer(L):
    """One instance of each class ``layers_ext`` registers, away from its
    defaults."""
    return [
        L.Convolution3D(n_out=4, kernel_size=(3, 3, 3), dilation=(1, 2, 1), l2=1e-4),
        L.Subsampling3DLayer(pooling_type="avg", convolution_mode="same"),
        L.LocallyConnected2D(n_out=3, has_bias=False, dropout=0.9),
        L.PReLULayer(shared_axes=(1,)),
        L.Cropping2D(cropping=(1, 2, 0, 1)),
        L.CenterLossOutputLayer(n_out=5, alpha=0.1, lambda_=1e-3),
        L.Convolution1DLayer(n_out=6, kernel_size=5, stride=2, convolution_mode="truncate"),
        L.Subsampling1DLayer(pooling_type="avg", kernel_size=3),
        L.ReshapeLayer(target_shape=(4, 6)),
        L.PermuteLayer(dims=(2, 1)),
        L.RepeatVectorLayer(n=4),
        L.GRULayer(n_out=7, reset_after=False, weight_init="relu"),
        L.OCNNOutputLayer(hidden_size=6, nu=0.1, activation="relu"),
    ]


def test_json_equals_jax_and_reads_back():
    """Each layer's JSON is the JAX package's, character for character, and
    reads back in both packages; the thirteen are all that ``layers_ext``
    registers."""
    jlayers, tlayers = _every_layer(layers(False)), _every_layer(layers(True))
    assert {type(l).__name__ for l in tlayers} == {
        n for n, c in JC.LAYER_REGISTRY.items() if c.__module__ == JE.__name__}
    for jl, tl in zip(jlayers, tlayers):
        text = json.dumps(tl.to_json())
        assert text == json.dumps(jl.to_json()), type(tl).__name__
        assert json.dumps(TC.Layer.from_json(json.loads(text)).to_json()) == text
        assert json.dumps(JC.Layer.from_json(json.loads(text)).to_json()) == text
    assert TE.GRULayer.__module__ == "deeplearning4j_tpu_torch.nn.layers_ext"
