"""Port parity: ``deeplearning4j_tpu_torch.nn.graph.ComputationGraph``
against the JAX package's, on the CPU.

The graph has two inputs and two outputs: dense layers (one with L1, L2 and
a max-norm constraint, one named "a.b"), a MergeVertex into a
BatchNormalization (L2 on gamma and beta), an ElementWiseVertex into a
frozen dense layer, a softmax head and an MSE head, per-layer gradient
clipping and Adam. Both packages build it alike (JSON cannot carry
constraints); the port takes the JAX graph's weights, BN state and updater
state (``models.weights.cg_params_from_jax``). Batches are seeded numpy
arrays. Tolerances: losses and scores 1e-5 relative; outputs and BN
statistics 1e-5 absolute; each parameter's update within 1e-4 of the norm
of JAX's update; Adam's moments within 1e-4 of their norms.
"""

from urllib.parse import unquote

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.data.iterators import ListMultiDataSetIterator as JListMulti
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import constraints as JK
from deeplearning4j_tpu.nn import graph_conf as JG
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator, ListMultiDataSetIterator,
                                           MultiDataSet)
from deeplearning4j_tpu_torch.models.weights import updater_state_to_numpy
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import constraints as TK
from deeplearning4j_tpu_torch.nn import graph_conf as TG
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, module_key
from torch_mln_helpers import LOSS_REL, close, params_close, port_graph, rel_err, snapshot
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

GRAD_REL = 1e-4


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _graph_conf(C, G, K, U):
    b = (C.NeuralNetConfiguration.Builder().seed(7).updater(U.Adam(1e-2))
         .gradient_normalization("ClipL2PerLayer", 0.5))
    g = (b.graph_builder().add_inputs("x1", "x2")
         .set_input_types(C.InputType.feed_forward(5), C.InputType.feed_forward(4)))
    g.add_layer("d1", C.DenseLayer(n_out=6, activation="tanh", l1=1e-3, l2=1e-2,
                                   constraints=(K.MaxNormConstraint(0.9),)), "x1")
    g.add_layer("a.b", C.DenseLayer(n_out=6, activation="relu"), "x2")
    g.add_vertex("cat", G.MergeVertex(), "d1", "a.b")
    g.add_layer("bn", C.BatchNormalization(l2=1e-2), "cat")
    g.add_vertex("prod", G.ElementWiseVertex("product"), "d1", "a.b")
    g.add_layer("frozen", C.DenseLayer(n_out=5, activation="sigmoid", frozen=True), "prod")
    g.add_layer("cls", C.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "bn")
    g.add_layer("reg", C.OutputLayer(n_out=2, activation="identity", loss="mse"), "frozen")
    return g.set_outputs("cls", "reg").build()


def _nets():
    jnet = JGraph(_graph_conf(JC, JG, JK, JU))
    jnet.init()
    return jnet, port_graph(jnet, _graph_conf(TC, TG, TK, TU))


def _batches(n, seed=3, B=8):
    rs = np.random.RandomState(seed)
    return [([rs.randn(B, 5).astype(np.float32), rs.randn(B, 4).astype(np.float32)],
             [np.eye(3, dtype=np.float32)[rs.randint(0, 3, B)],
              rs.randn(B, 2).astype(np.float32)]) for _ in range(n)]


def _state_close(tnet, jnet):
    """BN running statistics and the updater state of the two graphs equal."""
    jbn = jax.tree.map(np.asarray, jnet.bn_state)
    for name, st in jbn.items():
        for k in ("mean", "var"):
            close(getattr(tnet.bn_state[module_key(name)], k), st[k])
    ju = jax.tree.map(np.asarray, jnet.updater_state)
    tu = updater_state_to_numpy(tnet.updater_state)
    assert set(tu) == set(ju) == {"m", "v"}
    for slot in ju:
        for name, tensors in ju[slot].items():
            for k, want in tensors.items():
                assert rel_err(tu[slot][module_key(name)][k], want) <= GRAD_REL, (slot, name, k)


def test_three_steps_match_jax():
    """Score (both heads' losses plus L1/L2 over layers only), every
    parameter, BN state and Adam's moments after each of three steps on a
    MultiDataSet; the frozen layer keeps its weights, the constraint holds."""
    jnet, tnet = _nets()
    for features, labels in _batches(3):
        before = snapshot(jnet)
        jnet.fit(JMultiDataSet(features, labels))
        tnet.fit(MultiDataSet(features, labels))
        assert _rel(tnet.score_, jnet.score_) <= LOSS_REL
        params_close(tnet, jnet, before)
        _state_close(tnet, jnet)
    assert tnet.iteration == jnet.iteration == 3
    frozen = snapshot(jnet)["frozen"]
    for k, w in tnet.params_["frozen"].items():
        np.testing.assert_array_equal(w.detach().numpy(), frozen[k])
    assert np.linalg.norm(tnet.params_["d1"]["W"].detach().numpy(), axis=0).max() <= 0.9 + 1e-5


def test_outputs_params_order_and_set_params_match_jax():
    """output() gives both heads in the order of network_outputs; params()
    concatenates nodes in topological order, each node's tensors by sorted
    name, so a flat vector moves between the packages."""
    jnet, tnet = _nets()
    features, _ = _batches(1, seed=5)[0]
    for got, want in zip(tnet.output(*features), jnet.output(*features)):
        close(got, want.numpy())
    np.testing.assert_array_equal(tnet.params().numpy(), np.asarray(jnet.params().numpy()))
    assert tnet.num_params() == jnet.num_params()
    flat = np.random.RandomState(1).randn(tnet.num_params()).astype(np.float32) * 0.3
    jnet.set_params(flat)
    tnet.set_params(flat)
    np.testing.assert_array_equal(tnet.params().numpy(), flat)
    out = tnet.output({"x1": features[0], "x2": features[1]})
    close(out[0], jnet.output(*features)[0].numpy())
    close(tnet.output_single(features)[:, 0], jnet.output_single(features).numpy()[:, 0])
    with pytest.raises(ValueError, match="numParams"):
        tnet.set_params(flat[:-1])


def test_fit_scan_iterators_arrays_and_score_match_jax():
    """fit_scan's per-step losses; fit over a ListMultiDataSetIterator; fit
    of dicts of arrays keyed by input and output names; score of a
    MultiDataSet in inference mode."""
    jnet, tnet = _nets()
    batches = _batches(4, seed=9)
    before = snapshot(jnet)
    jl = np.asarray(jnet.fit_scan([JMultiDataSet(f, l) for f, l in batches[:2]]))
    tl = tnet.fit_scan([MultiDataSet(f, l) for f, l in batches[:2]])
    np.testing.assert_allclose(tl, jl, rtol=LOSS_REL)
    params_close(tnet, jnet, before)
    before = snapshot(jnet)
    jnet.fit(JListMulti([JMultiDataSet(f, l) for f, l in batches[2:]]))
    tnet.fit(ListMultiDataSetIterator([MultiDataSet(f, l) for f, l in batches[2:]]))
    assert _rel(tnet.score_, jnet.score_) <= LOSS_REL
    params_close(tnet, jnet, before)
    (f1, f2), (y1, y2) = batches[0]
    before = snapshot(jnet)
    jnet.fit({"x1": f1, "x2": f2}, {"cls": y1, "reg": y2})
    tnet.fit({"x1": f1, "x2": f2}, {"cls": y1, "reg": y2})
    params_close(tnet, jnet, before)
    _state_close(tnet, jnet)
    assert tnet.iteration == jnet.iteration == 5 and tnet.epoch == jnet.epoch == 2
    assert _rel(tnet.score(MultiDataSet(*batches[1])),
                jnet.score(JMultiDataSet(*batches[1]))) <= LOSS_REL


def _single_conf(C, U):
    g = (C.NeuralNetConfiguration.Builder().seed(2).updater(U.Sgd(0.5)).graph_builder()
         .add_inputs("x").set_input_types(C.InputType.feed_forward(4)))
    g.add_layer("h", C.DenseLayer(n_out=8, activation="relu"), "x")
    g.add_layer("out", C.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "h")
    return g.set_outputs("out").build()


def test_dataset_fit_with_labels_mask_and_evaluate_match_jax():
    """A one-input graph fed DataSets (a labels mask goes to the first
    output) and evaluated over a DataSet iterator."""
    jnet = JGraph(_single_conf(JC, JU))
    jnet.init()
    tnet = port_graph(jnet)
    rs = np.random.RandomState(4)
    x = rs.randn(24, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, 0] > 0).astype(int) + (x[:, 1] > 1).astype(int)]
    lm = (rs.rand(24) > 0.3).astype(np.float32)
    for _ in range(3):
        before = snapshot(jnet)
        jnet.fit(JDataSet(x, y, labels_mask=lm))
        tnet.fit(DataSet(x, y, labels_mask=lm))
        assert _rel(tnet.score_, jnet.score_) <= LOSS_REL
        params_close(tnet, jnet, before)
    jev = jnet.evaluate(JList([JDataSet(x[:12], y[:12]), JDataSet(x[12:], y[12:])]))
    tev = tnet.evaluate(ListDataSetIterator([DataSet(x[:12], y[:12]), DataSet(x[12:], y[12:])]))
    np.testing.assert_array_equal(tev.confusion, jev.confusion)
    assert tev.accuracy() == jev.accuracy()


def test_node_names_are_kept_and_escaped_for_the_module():
    """nn.ModuleDict refuses "." in a key and names that shadow its
    attributes; the reference accepts any node name. The port keeps the
    name everywhere but in the module key, which escapes it reversibly."""
    for name in ("a.b", "50%.x", "train", "forward", "%2E", "plain"):
        key = module_key(name)
        assert "." not in key and unquote(key) == name
        assert not hasattr(torch.nn.ModuleDict(), key)
    jnet, tnet = _nets()
    assert "a%2Eb" in tnet.params_ and "a.b" in tnet._keys
    assert "params_.a%2Eb.W" in tnet.state_dict()
    assert [(n, k) for n, k, _ in tnet._param_entries()] == [
        (n, k) for n in jnet._topo if n in jnet.params_ for k in sorted(jnet.params_[n])]
    assert "a%2Eb.W" in tnet.updater_state["m"]
    clone = tnet.clone()
    features, labels = _batches(1, seed=6)[0]
    tnet.fit(MultiDataSet(features, labels))
    assert not torch.equal(clone.params(), tnet.params())
    clone.fit(MultiDataSet(features, labels))
    assert torch.equal(clone.params(), tnet.params())
    for call in (lambda: tnet.set_bucketing(True), lambda: tnet.set_device_ingest(None)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 8"):
            call()


def _dropout_conf(p):
    g = (TC.NeuralNetConfiguration.Builder().seed(4).updater(TU.Sgd(0.0)).graph_builder()
         .add_inputs("x").set_input_types(TC.InputType.feed_forward(6)))
    g.add_layer("d", TC.DenseLayer(n_out=16, activation="tanh"), "x")
    g.add_layer("drop1", TC.DropoutLayer(dropout=p), "d")
    g.add_layer("drop2", TC.DropoutLayer(dropout=p), "d")
    g.add_vertex("cat", TG.MergeVertex(), "drop1", "drop2")
    g.add_layer("out", TC.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "cat")
    return g.set_outputs("out").build()


def test_dropout_is_drawn_per_node_from_the_step_key():
    """A node's random key is the step's (seed ^ 0x5EED, iteration) folded
    with the node's topological index, vertices counted: two DropoutLayers
    on one input draw different masks, one iteration repeats them (a clone's
    first step gives the same loss) and the next draws others. The masks
    come from torch generators, so they differ from JAX's by construction;
    parity runs at dropout 0."""
    net = ComputationGraph(_dropout_conf(0.5), device="cpu").init()
    x = np.random.RandomState(0).randn(32, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.arange(32) % 3]
    clone = net.clone()
    net.fit(x, y)
    clone.fit(x, y)
    assert net.score_ == clone.score_
    net.fit(x, y)
    assert net.score_ != clone.score_
    from deeplearning4j_tpu_torch.nn.dropout import RngKey

    key = RngKey((4 ^ 0x5EED, 0))
    idx = net._topo.index("drop1"), net._topo.index("drop2")
    assert key.fold_in(idx[0]).seed() != key.fold_in(idx[1]).seed()
    full = ComputationGraph(_dropout_conf(0.0), device="cpu").init()
    full.set_params(net.params())
    assert full.score(DataSet(x, y)) == net.score(DataSet(x, y))
