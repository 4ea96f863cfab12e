"""Port parity: ``deeplearning4j_tpu_torch.nn.graph_conf`` (the graph
vertices, ``ComputationGraphConfiguration`` and ``GraphBuilder``) against the
JAX package's ``nn/graph_conf.py``, on the CPU.

Each vertex takes the same seeded numpy inputs in both packages; its output
is held within 1e-5 absolute, and the gradients of one seeded cotangent with
respect to every input (``jax.vjp`` against autograd) within 1e-4 of their
norms. Type inference, the builder's preprocessor inference and the JSON are
compared exactly.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import graph_conf as JG
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.attention_layers import AttentionVertex as JAttentionVertex
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import graph_conf as TG
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.attention_layers import AttentionVertex as TAttentionVertex
from torch_mln_helpers import close, rel_err, t
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

GRAD_REL = 1e-4


def _vjp(jfn, tfn, xs, rs):
    """Outputs and input gradients of a vertex's apply in both packages,
    under one seeded cotangent; compared here."""
    jout, vjp = jax.vjp(lambda *a: jfn(list(a)), *[jnp.asarray(x) for x in xs])
    cot = rs.randn(*jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    txs = [t(x, True) for x in xs]
    tout = tfn(txs)
    close(tout, np.asarray(jout))
    tgrads = torch.autograd.grad(tout, txs, grad_outputs=t(cot), allow_unused=True)
    for i, (g, jg) in enumerate(zip(tgrads, jgrads)):
        got = torch.zeros_like(txs[i]) if g is None else g
        assert rel_err(got, np.asarray(jg)) <= GRAD_REL, f"input {i}"


def _x(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


# (name, [(JAX vertex, port vertex, input shapes), ...])
_CASES = [
    ("merge", [(JG.MergeVertex(), TG.MergeVertex(), [(3, 4), (3, 5)]),
               (JG.MergeVertex(), TG.MergeVertex(), [(2, 2, 4, 4), (2, 3, 4, 4), (2, 1, 4, 4)]),
               (JG.MergeVertex(), TG.MergeVertex(), [(2, 3, 6), (2, 2, 6)])]),
    ("elementwise", [(JG.ElementWiseVertex(op), TG.ElementWiseVertex(op),
                      [(3, 5)] * (2 if op == "subtract" else 3))
                     for op in ("add", "subtract", "product", "average", "max")]),
    ("subset", [(JG.SubsetVertex(1, 3), TG.SubsetVertex(1, 3), [(3, 6)])]),
    ("stack", [(JG.StackVertex(), TG.StackVertex(), [(2, 4), (3, 4)])]),
    ("unstack", [(JG.UnstackVertex(1, 3), TG.UnstackVertex(1, 3), [(6, 4)])]),
    ("l2normalize", [(JG.L2NormalizeVertex(), TG.L2NormalizeVertex(), [(3, 5)]),
                     (JG.L2NormalizeVertex(), TG.L2NormalizeVertex(), [(2, 3, 4, 4)])]),
    ("scale", [(JG.ScaleVertex(0.17), TG.ScaleVertex(0.17), [(3, 5)])]),
    ("shift", [(JG.ShiftVertex(-0.5), TG.ShiftVertex(-0.5), [(3, 5)])]),
    ("reshape", [(JG.ReshapeVertex((2, 6)), TG.ReshapeVertex((2, 6)), [(3, 12)])]),
    ("preprocessor", [(JG.PreprocessorVertex(JC.CnnToFeedForwardPreProcessor()),
                       TG.PreprocessorVertex(TC.CnnToFeedForwardPreProcessor()),
                       [(2, 3, 4, 4)])]),
    ("flatten", [(JG.FlattenVertex(), TG.FlattenVertex(), [(2, 3, 2, 5)])]),
]


@pytest.mark.parametrize("name, cases", _CASES, ids=[c[0] for c in _CASES])
def test_vertex_output_and_gradients_match_jax(name, cases):
    rs = np.random.RandomState(len(name))
    for jv, tv, shapes in cases:
        xs = [_x(rs, *s) for s in shapes]
        if name == "elementwise" and jv.op == "max":  # no ties: max is not differentiable there
            xs = [x + 3.0 * i for i, x in enumerate(xs)]
        _vjp(jv.apply, tv.apply, xs, rs)


def _types(types):
    return {k: dataclasses.asdict(v) for k, v in types.items()}


def _typed_graph(C, G, pre=True):
    """Every vertex with a type rule of its own, on ff, rnn and cnn inputs
    (``pre``: with the PreprocessorVertex, which the reference cannot read
    back from JSON)."""
    g = (C.NeuralNetConfiguration.Builder().seed(3).graph_builder()
         .add_inputs("ff", "seq", "img")
         .set_input_types(C.InputType.feed_forward(6), C.InputType.recurrent(5, 7),
                          C.InputType.convolutional(4, 4, 3)))
    g.add_vertex("m_ff", G.MergeVertex(), "ff", "ff")
    g.add_vertex("m_rnn", G.MergeVertex(), "seq", "seq")
    g.add_vertex("m_cnn", G.MergeVertex(), "img", "img")
    g.add_vertex("sub_ff", G.SubsetVertex(1, 3), "m_ff")
    g.add_vertex("sub_rnn", G.SubsetVertex(0, 2), "m_rnn")
    g.add_vertex("flat", G.FlattenVertex(), "m_cnn")
    if pre:
        g.add_vertex("pre", G.PreprocessorVertex(C.CnnToFeedForwardPreProcessor()), "img")
    g.add_vertex("sum", G.ElementWiseVertex("add"), "flat", "pre" if pre else "flat")
    g.add_layer("dense", C.DenseLayer(n_out=4), "sum")
    g.add_layer("out", C.OutputLayer(n_out=2), "dense")
    return g.set_outputs("out").build()


def test_output_types_and_infer_types_match_jax():
    tconf, jconf = _typed_graph(TC, TG), _typed_graph(JC, JG)
    assert tconf.topo_order() == jconf.topo_order()
    assert _types(tconf.infer_types()) == _types(jconf.infer_types())
    assert tconf.infer_types()["sub_rnn"] == TC.InputType.recurrent(3, 7)
    assert tconf.infer_types()["m_cnn"] == TC.InputType.convolutional(4, 4, 6)


def _builder_graph(C, G, U):
    """A layer after each input kind that needs an adapter: cnn → dense,
    cnnflat → conv, rnn → dense, ff → LSTM; and one that needs none."""
    g = (C.NeuralNetConfiguration.Builder().seed(5).updater(U.Adam(1e-3)).l2(1e-4)
         .weight_init("relu").graph_builder().add_inputs("img", "flat", "seq", "vec")
         .set_input_types(C.InputType.convolutional(4, 4, 2),
                          C.InputType.convolutional_flat(4, 4, 1),
                          C.InputType.recurrent(3, 5), C.InputType.feed_forward(3)))
    g.add_layer("d_img", C.DenseLayer(n_out=4), "img")
    g.add_layer("c_flat", C.ConvolutionLayer(n_out=2, kernel_size=(3, 3)), "flat")
    g.add_layer("d_seq", C.DenseLayer(n_out=4), "seq")
    g.add_layer("lstm", C.LSTM(n_out=4), "vec")
    g.add_layer("d_vec", C.DenseLayer(n_out=4), "vec")
    g.add_vertex("cat", G.MergeVertex(), "d_img", "d_vec")
    g.add_layer("out", C.OutputLayer(n_out=2), "cat")
    return g.set_outputs("out").build()


def test_builder_infers_preprocessors_like_jax():
    tconf, jconf = _builder_graph(TC, TG, TU), _builder_graph(JC, JG, JU)
    got = {n: type(node.preprocessor).__name__ for n, node in tconf.nodes.items()
           if node.preprocessor is not None}
    assert got == {n: type(node.preprocessor).__name__ for n, node in jconf.nodes.items()
                   if node.preprocessor is not None}
    assert got == {"d_img": "CnnToFeedForwardPreProcessor",
                   "c_flat": "FeedForwardToCnnPreProcessor",
                   "d_seq": "RnnToFeedForwardPreProcessor", "lstm": "FeedForwardToRnnPreProcessor"}
    # the builder cascades updater, weight init and l2 into every layer
    assert all(node.layer.weight_init == "relu" and node.layer.l2 == 1e-4
               for node in tconf.nodes.values() if node.layer is not None)
    assert tconf.to_json() == jconf.to_json()


def test_json_is_the_reference_json_both_ways():
    """Without the two vertices the reference cannot read back, the port
    writes the JAX package's JSON character for character, and each package
    reads the other's."""
    for tconf, jconf in ((_typed_graph(TC, TG, False), _typed_graph(JC, JG, False)),
                         (_builder_graph(TC, TG, TU), _builder_graph(JC, JG, JU))):
        text = jconf.to_json()
        assert tconf.to_json() == text
        assert TG.ComputationGraphConfiguration.from_json(text).to_json() == text
        assert JG.ComputationGraphConfiguration.from_json(tconf.to_json()).to_json() == text
    gn = (TC.NeuralNetConfiguration.Builder().gradient_normalization("ClipL2PerLayer", 0.5)
          .updater(TU.Nesterovs(0.1, 0.9)).graph_builder().add_inputs("x")
          .set_input_types(TC.InputType.feed_forward(3)))
    gn.add_layer("out", TC.OutputLayer(n_out=2), "x")
    text = gn.set_outputs("out").build().to_json()
    back = JG.ComputationGraphConfiguration.from_json(text)
    assert back.gradient_normalization == "ClipL2PerLayer"
    assert back.gradient_normalization_threshold == 0.5
    assert back.to_json() == text


def _fault_graph(C, G, AV):
    g = (C.NeuralNetConfiguration.Builder().seed(1).graph_builder().add_inputs("seq", "img")
         .set_input_types(C.InputType.recurrent(8, 5), C.InputType.convolutional(2, 2, 3)))
    g.add_vertex("att", AV(n_in=8, n_out=8, n_heads=2, head_size=4), "seq")
    g.add_vertex("pre", G.PreprocessorVertex(C.CnnToFeedForwardPreProcessor()), "img")
    g.add_layer("pool", C.GlobalPoolingLayer(pooling_type="avg"), "att")
    g.add_vertex("cat", G.MergeVertex(), "pool", "pre")
    g.add_layer("out", C.OutputLayer(n_out=2), "cat")
    return g.set_outputs("out").build()


def test_attention_and_preprocessor_vertices_round_trip_where_the_reference_cannot():
    """A reference fault the port does not copy: the JAX ``VERTEX_REGISTRY``
    (graph_conf.py:174) lists neither AttentionVertex nor PreprocessorVertex,
    and its PreprocessorVertex JSON drops the preprocessor's class, so the
    JAX ``from_json`` (:298) raises KeyError on such a graph, its own JSON
    and the port's alike. The port writes the preprocessor as a nested
    ``@class`` dict and reads both vertices back."""
    tconf = _fault_graph(TC, TG, TAttentionVertex)
    text = tconf.to_json()
    back = TG.ComputationGraphConfiguration.from_json(text)
    assert back.to_json() == text
    assert back.nodes["att"].vertex == tconf.nodes["att"].vertex
    assert isinstance(back.nodes["pre"].vertex.pre, TC.CnnToFeedForwardPreProcessor)
    assert json.loads(text)["nodes"][1]["vertex"] == {
        "pre": {"@class": "CnnToFeedForwardPreProcessor"}, "@class": "PreprocessorVertex"}
    with pytest.raises(KeyError, match="AttentionVertex"):
        JG.ComputationGraphConfiguration.from_json(text)
    jtext = _fault_graph(JC, JG, JAttentionVertex).to_json()
    with pytest.raises(KeyError, match="AttentionVertex"):
        JG.ComputationGraphConfiguration.from_json(jtext)
    # everything but the preprocessor vertex is the reference's JSON
    jd, td = json.loads(jtext), json.loads(text)
    jd["nodes"][1]["vertex"]["pre"] = td["nodes"][1]["vertex"]["pre"]
    assert jd == td


def test_topo_order_is_a_depth_first_walk_in_insertion_order():
    """The order is part of the semantics: a node's dropout key is folded
    with its index, and params() concatenates nodes in this order."""
    for C, G in ((TC, TG), (JC, JG)):
        g = (C.NeuralNetConfiguration.Builder().graph_builder().add_inputs("in")
             .set_input_types(C.InputType.feed_forward(3)))
        g.add_vertex("z", G.ElementWiseVertex("add"), "b", "a")
        g.add_layer("a", C.DenseLayer(n_out=3), "in")
        g.add_layer("b", C.DenseLayer(n_out=3), "c")
        g.add_layer("c", C.DenseLayer(n_out=3), "in")
        g.set_outputs("z")
        assert g.build().topo_order() == ["c", "b", "a", "z"]
    cyc = TC.NeuralNetConfiguration.Builder().graph_builder().add_inputs("in")
    cyc.add_vertex("p", TG.ScaleVertex(2.0), "q")
    cyc.add_vertex("q", TG.ScaleVertex(2.0), "p")
    with pytest.raises(ValueError, match="cycle"):
        cyc._conf.topo_order()
