"""Port parity: ``AttentionVertex`` and ``RecurrentAttentionLayer``
(``deeplearning4j_tpu_torch.nn.attention_layers``) and a ComputationGraph
that trains them, against the JAX package's, on the CPU.

The same seeded numpy weights and inputs go into both packages. Outputs
within 1e-5 absolute; the gradients of one seeded cotangent with respect to
every input and parameter (``jax.vjp`` against autograd) within 1e-4 of
their norms. On CPU tensors the vertex's attention takes the dense path (the
flash kernels run on the card, where ``chip_smoke.py`` phase 7c holds them
to it). The graph is the shape of phase 7c, cut to size: a cross-attention
vertex on (q, kv, kv), a self-attention vertex on q, RecurrentAttentionLayer
on q, MergeVertex → GlobalPooling(avg) → Output; three Sgd steps, each
parameter's update within 1e-4 of the norm of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import graph_conf as JG
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.attention_layers import AttentionVertex as JAttentionVertex
from deeplearning4j_tpu.nn.attention_layers import RecurrentAttentionLayer as JRecurrent
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.data import MultiDataSet
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import graph_conf as TG
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.attention_layers import AttentionVertex, RecurrentAttentionLayer
from torch_mln_helpers import (LOSS_REL, close, grads_close, pair, params_close, port_graph,
                               random_params, snapshot, t, vjp_pair)
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


def _vertex_vjp(jv, tv, params, xs, rs):
    """Output and gradients (every input and parameter) of a vertex's apply
    in both packages under one seeded cotangent, compared."""
    jfn = lambda p, *a: jv.apply(list(a), p)  # noqa: E731
    jout, vjp = jax.vjp(jfn, jax.tree.map(jnp.asarray, params), *[jnp.asarray(x) for x in xs])
    cot = rs.randn(*jout.shape).astype(np.float32)
    jgp, *jgx = vjp(jnp.asarray(cot))
    tp = {k: t(v, True) for k, v in params.items()}
    txs = [t(x, True) for x in xs]
    tout = tv.apply(txs, tp)
    close(tout, np.asarray(jout))
    names = list(tp)
    gs = torch.autograd.grad(tout, [tp[n] for n in names] + txs, grad_outputs=t(cot))
    want = {**jax.tree.map(np.asarray, jgp), **{f"x{i}": np.asarray(g) for i, g in enumerate(jgx)}}
    got = {**dict(zip(names, gs)), **{f"x{i}": g for i, g in enumerate(gs[len(names):])}}
    grads_close(got, want)


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_attention_vertex_matches_jax(kind):
    """Self-attention on one input; cross-attention on (q, kv, kv) with
    Tq != Tk (the shape phase 7c sends through the kernels on the card)."""
    rs = np.random.RandomState(11)
    kw = dict(n_in=8, n_out=6, n_heads=2, head_size=4)
    jv, tv = JAttentionVertex(**kw), AttentionVertex(**kw)
    shapes = jax.tree.map(lambda a: a.shape, jv.init_params(jax.random.key(0)))
    params = {k: (rs.randn(*s) * 0.5).astype(np.float32) for k, s in shapes.items()}
    assert {k: tuple(v.shape) for k, v in tv.init_params(torch.Generator()).items()} == \
        {k: tuple(s) for k, s in shapes.items()}
    q = rs.randn(3, 8, 5).astype(np.float32)
    xs = [q] if kind == "self" else [q, rs.randn(3, 8, 7).astype(np.float32)]
    if kind == "cross":
        xs.append(xs[1])
    _vertex_vjp(jv, tv, params, xs, rs)
    its = [TC.InputType.recurrent(8, x.shape[2]) for x in xs]
    assert tv.output_type(its) == TC.InputType.recurrent(6, 5)
    with pytest.raises(ValueError, match="needs params"):
        tv.apply([t(q)])


@pytest.mark.parametrize("masked", [False, True])
def test_recurrent_attention_layer_matches_jax(masked):
    """The reference's lax.scan against the port's eager loop: the output
    [B, nOut, T] and the gradients of every weight and the input; with a
    features mask, masked keys get no attention."""
    rs = np.random.RandomState(12)
    jl, tl = pair("RecurrentAttentionLayer", n_in=5, n_out=6, n_heads=2, head_size=3,
                  activation="tanh")
    it = JC.InputType.recurrent(5, 7)
    params = random_params(jl, it, rs)
    assert set(params) == {"W", "Wr", "Wq", "Wk", "Wv", "b"}
    x = rs.randn(3, 5, 7).astype(np.float32)
    mask = (np.arange(7)[None] < np.array([[7], [4], [1]])).astype(np.float32) if masked else None
    tit = TC.InputType.recurrent(5, 7)
    cot = rs.randn(3, 6, 7).astype(np.float32)
    jout, jg, tout, tg = vjp_pair(
        lambda p, a: jl.forward(p, a, it, training=False,
                                mask=None if mask is None else jnp.asarray(mask)),
        lambda p, a: tl.forward(p, a, tit, training=False,
                                mask=None if mask is None else torch.from_numpy(mask)),
        params, x, cot)
    close(tout, jout)
    grads_close(tg, jg)
    assert tl.output_type(tit) == TC.InputType.recurrent(6, 7)


def _graph_conf(C, G, U, AV, RA):
    g = (C.NeuralNetConfiguration.Builder().seed(13).updater(U.Sgd(0.1)).l2(1e-2).graph_builder()
         .add_inputs("q", "kv")
         .set_input_types(C.InputType.recurrent(8, 5), C.InputType.recurrent(8, 7)))
    g.add_vertex("cross", AV(n_in=8, n_out=8, n_heads=2, head_size=4), "q", "kv", "kv")
    g.add_vertex("self", AV(n_in=8, n_out=8, n_heads=2, head_size=4), "q")
    g.add_layer("rec", RA(n_out=4, n_heads=2, head_size=2), "q")
    g.add_vertex("cat", G.MergeVertex(), "cross", "self", "rec")
    g.add_layer("pool", C.GlobalPoolingLayer(pooling_type="avg"), "cat")
    g.add_layer("out", C.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "pool")
    return g.set_outputs("out").build()


def test_attention_graph_steps_match_jax():
    """Vertex parameters are initialised by the graph and trained; the
    builder's L2 reaches the layers (RecurrentAttentionLayer's weights) and
    not the vertices; the JSON (AttentionVertex included) is the
    reference's."""
    tconf = _graph_conf(TC, TG, TU, AttentionVertex, RecurrentAttentionLayer)
    jnet = JGraph(_graph_conf(JC, JG, JU, JAttentionVertex, JRecurrent))
    jnet.init()
    assert tconf.to_json() == jnet.conf.to_json()
    assert tconf.infer_types()["cat"] == TC.InputType.recurrent(20, 5)
    tnet = port_graph(jnet, tconf)
    assert sorted(tnet.params_["cross"]) == ["Wk", "Wo", "Wq", "Wv"]
    rs = np.random.RandomState(14)
    for _ in range(3):
        features = [rs.randn(4, 8, 5).astype(np.float32), rs.randn(4, 8, 7).astype(np.float32)]
        labels = [np.eye(3, dtype=np.float32)[rs.randint(0, 3, 4)]]
        before = snapshot(jnet)
        jnet.fit(JMultiDataSet(features, labels))
        tnet.fit(MultiDataSet(features, labels))
        assert abs(tnet.score_ - float(jnet.score_)) / float(jnet.score_) <= LOSS_REL
        params_close(tnet, jnet, before)
    close(tnet.output(*features)[0], jnet.output(*features)[0].numpy())
