"""Port parity: the port's recurrent, pooling and attention layers against
the JAX package's, on the CPU.

Same scheme as ``test_torch_nn_layers.py``: numpy-seeded inputs and weights
in both packages, outputs 1e-5 absolute, losses 1e-5 relative, each
gradient (input, parameters, initial states) within 1e-4 of its norm,
float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu_torch.nn import conf as TC
from torch_mln_helpers import (LOSS_REL, close, grads_close, pair, random_params, t, vjp_pair)
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


@pytest.mark.parametrize("cls", ["LSTM", "GravesLSTM"])
def test_lstm_forward_with_state_matches_jax(cls):
    """Gate order IFOG, peepholes (GravesLSTM) on i/f from c_{t-1} and on o
    from c_t, over 9 steps from a nonzero (h0, c0): outputs, final states,
    and the gradients of a cotangent on all three with respect to the
    input, both initial states and every parameter."""
    rs = np.random.RandomState(10)
    B, I, H, T = 3, 5, 4, 9
    jl, tl = pair(cls, n_in=I, n_out=H)
    it = JC.InputType.recurrent(I, T)
    params = random_params(jl, it, rs)
    x = rs.randn(B, I, T).astype(np.float32)
    h0, c0 = (rs.randn(B, H).astype(np.float32) for _ in range(2))
    cots = [rs.randn(B, H, T).astype(np.float32), rs.randn(B, H).astype(np.float32),
            rs.randn(B, H).astype(np.float32)]

    def jfn(p, xs):
        out, hT, cT = jl.forward_with_state(p, xs[0], xs[1], xs[2])
        return jnp.sum(out * cots[0]) + jnp.sum(hT * cots[1]) + jnp.sum(cT * cots[2])

    jv, vjp = jax.vjp(jfn, jax.tree.map(jnp.asarray, params),
                      tuple(jnp.asarray(a) for a in (x, h0, c0)))
    jgp, jgx = vjp(jnp.float32(1.0))
    tp = {k: t(v, True) for k, v in params.items()}
    txs = [t(a, True) for a in (x, h0, c0)]
    out, hT, cT = tl.forward_with_state(tp, *txs)
    jout, jhT, jcT = jl.forward_with_state(jax.tree.map(jnp.asarray, params), *map(jnp.asarray,
                                                                                 (x, h0, c0)))
    for got, want in ((out, jout), (hT, jhT), (cT, jcT)):
        close(got, want)
    tv = sum((a * t(c)).sum() for a, c in zip((out, hT, cT), cots))
    names = list(tp)
    gs = torch.autograd.grad(tv, [tp[n] for n in names] + txs)
    grads_close({**dict(zip(names, gs[:len(names)])), "x": gs[-3], "h0": gs[-2], "c0": gs[-1]},
                {**jax.tree.map(np.asarray, jgp), "x": jgx[0], "h0": jgx[1], "c0": jgx[2]})
    # forward (zero initial state) and the forget-gate bias of a fresh init
    jo, jg, to, tg = vjp_pair(lambda p, xx: jl.forward(p, xx, it, training=False),
                              lambda p, xx: tl.forward(p, xx, it, training=False),
                              params, x, cots[0])
    close(to, jo)
    grads_close(tg, jg)
    b = tl.init_params(torch.Generator().manual_seed(0), it)["b"].numpy()
    np.testing.assert_array_equal(b, np.asarray(jl.init_params(jax.random.key(0), it)["b"]))
    assert tl.flops_per_example(it) == jl.flops_per_example(it)


@pytest.mark.parametrize("masked", [False, True])
def test_rnn_output_layer_matches_jax(masked):
    """Softmax + mcxent over [B, C, T]: with a mask the masked sum over the
    mask's count, without one the batch mean of per-sequence sums; and the
    unfused path (identity + mse) under the same mask."""
    rs = np.random.RandomState(11)
    B, C, K, T = 3, 5, 4, 6
    it = JC.InputType.recurrent(C, T)
    x = rs.randn(B, C, T).astype(np.float32)
    y = np.eye(K, dtype=np.float32)[rs.randint(0, K, (B, T))].transpose(0, 2, 1)
    mask = (np.arange(T)[None] < np.array([[6], [3], [4]])).astype(np.float32) if masked else None
    for act_, loss in (("softmax", "mcxent"), ("identity", "mse")):
        jl, tl = pair("RnnOutputLayer", n_in=C, n_out=K, activation=act_, loss=loss)
        params = random_params(jl, it, rs)
        jv, jg, tv, tg = vjp_pair(
            lambda p, xx: jl.compute_loss(p, xx, jnp.asarray(y), it, training=False,
                                          mask=None if mask is None else jnp.asarray(mask)),
            lambda p, xx: tl.compute_loss(p, xx, t(y), it, training=False,
                                          mask=None if mask is None else t(mask)),
            params, x, np.float32(1.0))
        assert abs(tv.item() - float(jv)) <= LOSS_REL * abs(float(jv)), (act_, loss)
        grads_close(tg, jg)
        jo, jg, to, tg = vjp_pair(lambda p, xx: jl.forward(p, xx, it, training=False),
                                  lambda p, xx: tl.forward(p, xx, it, training=False),
                                  params, x, rs.randn(B, K, T).astype(np.float32))
        close(to, jo)
        grads_close(tg, jg)


def test_last_time_step_matches_jax():
    rs = np.random.RandomState(12)
    jl, tl = pair("LastTimeStep")
    it = JC.InputType.recurrent(4, 7)
    x = rs.randn(3, 4, 7).astype(np.float32)
    for mask in (None, (np.arange(7)[None] < np.array([[7], [2], [5]])).astype(np.float32)):
        kw = lambda f: {} if mask is None else {"mask": f(mask)}  # noqa: E731
        jo, jg, to, tg = vjp_pair(
            lambda p, xx: jl.forward(p, xx, it, training=False, **kw(jnp.asarray)),
            lambda p, xx: tl.forward(p, xx, it, training=False, **kw(t)),
            {}, x, rs.randn(3, 4).astype(np.float32))
        close(to, jo)
        grads_close(tg, jg)


def test_global_pooling_matches_jax():
    rs = np.random.RandomState(13)
    x4 = rs.randn(2, 3, 4, 5).astype(np.float32)
    x3 = rs.randn(3, 4, 6).astype(np.float32)
    mask = (np.arange(6)[None] < np.array([[6], [1], [4]])).astype(np.float32)
    for kind in ("max", "avg", "sum", "pnorm"):
        jl, tl = pair("GlobalPoolingLayer", pooling_type=kind, pnorm=3)
        for x, it, m in ((x4, JC.InputType.convolutional(4, 5, 3), None),
                         (x3, JC.InputType.recurrent(4, 6), None),
                         (x3, JC.InputType.recurrent(4, 6), mask if kind != "pnorm" else None)):
            kw = lambda f: {} if m is None else {"mask": f(m)}  # noqa: E731
            jo, jg, to, tg = vjp_pair(
                lambda p, xx: jl.forward(p, xx, it, training=False, **kw(jnp.asarray)),
                lambda p, xx: tl.forward(p, xx, it, training=False, **kw(t)),
                {}, x, rs.randn(x.shape[0], x.shape[1]).astype(np.float32))
            close(to, jo, what=kind)
            grads_close(tg, jg)
            assert tl.output_type(it) == TC.InputType(**JC.dataclasses.asdict(jl.output_type(it)))


@pytest.mark.parametrize("projected", [True, False], ids=["heads4_projected", "unprojected"])
def test_self_attention_layer_matches_jax(projected):
    """Over [B, 32, T] with a ragged features mask (a key mask): four heads
    of 16 behind the Wq/Wk/Wv/Wo projections, or one head on the input
    features themselves. On CPU tensors the port's ``auto`` is the dense
    path; the flash route's plain versions are held to it at the kernels'
    layer (tests/test_torch_attention*.py)."""
    rs = np.random.RandomState(14)
    B, C, T = 3, 32, 20
    kw = dict(n_out=24, n_heads=4, head_size=16) if projected else \
        dict(n_out=C, project_input=False)
    n_out = kw["n_out"]
    jl, tl = pair("SelfAttentionLayer", n_in=C, activation="tanh", **kw)
    it = JC.InputType.recurrent(C, T)
    params = random_params(jl, it, rs, scale=0.2)  # about xavier's scale: tanh not saturated
    x = rs.randn(B, C, T).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[20], [7], [13]])).astype(np.float32)
    jo, jg, to, tg = vjp_pair(
        lambda p, xx: jl.forward(p, xx, it, training=False, mask=jnp.asarray(mask)),
        lambda p, xx: tl.forward(p, xx, it, training=False, mask=t(mask)),
        params, x, rs.randn(B, n_out, T).astype(np.float32))
    close(to, jo)
    grads_close(tg, jg)


def test_learned_self_attention_layer_matches_jax():
    rs = np.random.RandomState(15)
    B, C, T = 2, 16, 9
    jl, tl = pair("LearnedSelfAttentionLayer", n_in=C, n_out=12, n_heads=2, head_size=8,
                  n_queries=3)
    it = JC.InputType.recurrent(C, T)
    params = random_params(jl, it, rs)
    x = rs.randn(B, C, T).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[9], [4]])).astype(np.float32)
    jo, jg, to, tg = vjp_pair(
        lambda p, xx: jl.forward(p, xx, it, training=False, mask=jnp.asarray(mask)),
        lambda p, xx: tl.forward(p, xx, it, training=False, mask=t(mask)),
        params, x, rs.randn(B, 12, 3).astype(np.float32))
    close(to, jo)
    grads_close(tg, jg)
