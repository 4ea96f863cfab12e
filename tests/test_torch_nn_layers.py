"""Port parity: the port's feed-forward and convolutional layers of
``deeplearning4j_tpu_torch.nn.conf`` against the JAX package's, on the CPU.

Per layer: the same numpy-seeded input and weights go into both packages;
the output and the gradients of one seeded cotangent with respect to the
input and to every parameter (JAX's ``jax.vjp``) are compared. Tolerances,
float32: outputs 1e-5 absolute, losses 1e-5 relative, each gradient within
1e-4 of its norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu_torch.nn import conf as TC
from torch_mln_helpers import (LOSS_REL, close, grads_close, pair, random_params, t, vjp_pair)
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


def _check_layer(jl, tl, it, x, rs, **fwd):
    params = random_params(jl, it, rs)
    jout, jg, tout, tg = vjp_pair(
        lambda p, xx: jl.forward(p, xx, it, training=False, **fwd),
        lambda p, xx: tl.forward(p, xx, it, training=False, **fwd),
        params, x, rs.randn(*jl.forward(params, x, it, training=False, **fwd).shape)
        .astype(np.float32))
    assert tuple(tout.shape) == jout.shape
    close(tout, jout)
    grads_close(tg, jg)
    assert tl.output_type(it) == TC.InputType(**JC.dataclasses.asdict(jl.output_type(it)))
    assert tl.flops_per_example(it) == jl.flops_per_example(it)
    return tout


def test_dense_layer_matches_jax():
    rs = np.random.RandomState(0)
    jl, tl = pair("DenseLayer", n_in=7, n_out=5, activation="tanh")
    _check_layer(jl, tl, JC.InputType.feed_forward(7), rs.randn(4, 7).astype(np.float32), rs)


@pytest.mark.parametrize("activation,loss", [("softmax", "mcxent"), ("sigmoid", "xent"),
                                             ("tanh", "mse")])
def test_output_layer_matches_jax(activation, loss):
    """softmax+mcxent and sigmoid+xent take the fused logits losses; tanh+mse
    applies the activation, then the loss. A per-example mask too."""
    rs = np.random.RandomState(1)
    jl, tl = pair("OutputLayer", n_in=6, n_out=4, activation=activation, loss=loss)
    it = JC.InputType.feed_forward(6)
    params = random_params(jl, it, rs)
    x = rs.randn(5, 6).astype(np.float32)
    y = (np.eye(4)[rs.randint(0, 4, 5)] if loss == "mcxent" else
         rs.randint(0, 2, (5, 4)) if loss == "xent" else rs.randn(5, 4)).astype(np.float32)
    for mask in (None, np.array([1, 1, 0, 1, 0], np.float32)):
        def jloss(p, xx):
            return jl.compute_loss(p, xx, jnp.asarray(y), it, training=False,
                                   mask=None if mask is None else jnp.asarray(mask))

        def tloss(p, xx):
            return tl.compute_loss(p, xx, t(y), it, training=False,
                                   mask=None if mask is None else t(mask))

        jv, jg, tv, tg = vjp_pair(jloss, tloss, params, x, np.float32(1.0))
        assert abs(tv.item() - float(jv)) <= LOSS_REL * abs(float(jv))
        grads_close(tg, jg)
    _check_layer(jl, tl, it, x, rs)


CONVS = {
    "truncate": dict(n_out=4, kernel_size=(3, 3), padding=(1, 1), convolution_mode="truncate"),
    "same": dict(n_out=4, kernel_size=(5, 5), convolution_mode="same"),
    "4x4_stride2_same": dict(n_out=3, kernel_size=(4, 4), stride=(2, 2), convolution_mode="same"),
    "dilated": dict(n_out=3, kernel_size=(3, 3), dilation=(2, 2), padding=(1, 0),
                    convolution_mode="truncate"),
}


@pytest.mark.parametrize("case", list(CONVS))
def test_convolution_layer_matches_jax(case):
    """OIHW weights go across as they are (the JAX package computes NHWC
    inside); SAME with a 4x4 kernel at stride 2 pads one more row and column
    at the end than at the start, as XLA does."""
    rs = np.random.RandomState(2)
    jl, tl = pair("ConvolutionLayer", activation="relu", **CONVS[case])
    it = JC.InputType.convolutional(11, 9, 3)
    _check_layer(jl, tl, it, rs.randn(2, 3, 11, 9).astype(np.float32), rs)


POOLS = [(kind, mode) for kind in ("max", "avg", "pnorm") for mode in ("truncate", "same")]


@pytest.mark.parametrize("kind,mode", POOLS)
def test_subsampling_layer_matches_jax(kind, mode):
    """3x3 windows at stride 2 over 10x7: SAME pads (0, 1) rows and (1, 1)
    columns, so average pooling's divisor (the in-window count of real
    elements) differs by window; truncate mode pads (1, 0) symmetrically."""
    rs = np.random.RandomState(3)
    jl, tl = pair("SubsamplingLayer", pooling_type=kind, kernel_size=(3, 3), stride=(2, 2),
                  padding=(1, 0), convolution_mode=mode, pnorm=3)
    it = JC.InputType.convolutional(10, 7, 2)
    x = rs.randn(2, 2, 10, 7).astype(np.float32)
    _check_layer(jl, tl, it, x, rs)


def _bn_case(rs, shape, it):
    jl, tl = pair("BatchNormalization", decay=0.9, eps=1e-5)
    params = random_params(jl, it, rs)
    n = params["gamma"].shape[0]
    state = {"mean": rs.randn(n).astype(np.float32),
             "var": rs.uniform(0.5, 2.0, n).astype(np.float32)}
    x = (rs.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    return jl, tl, params, state, x


@pytest.mark.parametrize("shape,training", [((4, 3, 5, 6), True), ((4, 3, 5, 6), False),
                                            ((6, 5), True)])
def test_batch_normalization_matches_jax(shape, training):
    """Training: one-pass biased moments over (B, H, W) and the running state
    after one step (decay 0.9); inference: the running state."""
    rs = np.random.RandomState(4)
    it = (JC.InputType.convolutional(*shape[2:], shape[1]) if len(shape) == 4
          else JC.InputType.feed_forward(shape[1]))
    jl, tl, params, state, x = _bn_case(rs, shape, it)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: t(v) for k, v in state.items()}
    jout, jg, tout, tg = vjp_pair(
        lambda p, xx: jl.forward_bn(p, jstate, xx, it, training=training)[0],
        lambda p, xx: tl.forward_bn(p, tstate, xx, it, training=training)[0],
        params, x, rs.randn(*shape).astype(np.float32))
    close(tout, jout)
    grads_close(tg, jg)
    _, jnew = jl.forward_bn(jax.tree.map(jnp.asarray, params), jstate, jnp.asarray(x), it,
                            training=training)
    _, tnew = tl.forward_bn({k: t(v) for k, v in params.items()}, tstate, t(x), it,
                            training=training)
    for k in ("mean", "var"):
        close(tnew[k], jnew[k], what=k)
        assert not tnew[k].requires_grad


def test_batch_normalization_recurrent_input_matches_jax():
    """[B, C, T] normalises each channel over (B, T)."""
    rs = np.random.RandomState(5)
    it = JC.InputType.recurrent(4, 7)
    jl, tl, params, state, x = _bn_case(rs, (3, 4, 7), it)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: t(v) for k, v in state.items()}
    jout, jg, tout, tg = vjp_pair(
        lambda p, xx: jl.forward_bn(p, jstate, xx, it, training=True)[0],
        lambda p, xx: tl.forward_bn(p, tstate, xx, it, training=True)[0],
        params, x, rs.randn(3, 4, 7).astype(np.float32))
    close(tout, jout)
    grads_close(tg, jg)


def test_preprocessors_match_jax():
    rs = np.random.RandomState(6)
    cases = [
        ("CnnToFeedForwardPreProcessor", {}, rs.randn(2, 3, 4, 5), JC.InputType.convolutional(4, 5, 3)),
        ("FeedForwardToCnnPreProcessor", dict(height=4, width=5, channels=3), rs.randn(2, 60),
         JC.InputType.convolutional_flat(4, 5, 3)),
        ("RnnToFeedForwardPreProcessor", {}, rs.randn(2, 6, 7), JC.InputType.recurrent(6, 7)),
        ("FeedForwardToRnnPreProcessor", {}, rs.randn(2, 7, 6), JC.InputType.feed_forward(6)),
        ("FeedForwardToRnnPreProcessor", {}, rs.randn(2, 6), JC.InputType.feed_forward(6)),
    ]
    for name, kw, x, it in cases:
        jp, tp = getattr(JC, name)(**kw), getattr(TC, name)(**kw)
        x = x.astype(np.float32)
        close(tp.pre_process(t(x), it), jp.pre_process(jnp.asarray(x), it), atol=0, what=name)
        assert tp.output_type(it) == TC.InputType(**JC.dataclasses.asdict(jp.output_type(it)))
    # auto-insertion picks the same preprocessor class
    for prev, layer in ((JC.InputType.convolutional(4, 4, 2), "DenseLayer"),
                        (JC.InputType.recurrent(3), "DenseLayer"),
                        (JC.InputType.feed_forward(3), "LSTM"),
                        (JC.InputType.convolutional_flat(4, 4, 1), "ConvolutionLayer"),
                        (JC.InputType.recurrent(3), "RnnOutputLayer")):
        jl, tl = pair(layer)
        jp, tp = JC.infer_preprocessor(prev, jl), TC.infer_preprocessor(prev, tl)
        assert type(jp).__name__ == type(tp).__name__, (prev, layer)
