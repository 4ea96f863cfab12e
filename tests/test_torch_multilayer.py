"""Port parity: ``deeplearning4j_tpu_torch.nn.multilayer.MultiLayerNetwork``
and LeNet against the JAX package's, on the CPU.

Both networks come from one configuration (the JAX package's JSON, loaded by
the port) and hold the same weights (the JAX network's, bridged by
``models.weights.mln_params_from_jax``, with its BN and updater state);
batches are numpy arrays from seeds, float32, dropout 0. Tolerances: losses
and scores 1e-5 relative; outputs 1e-5 absolute; after each step, each
parameter's update (its change from the step's start) within 1e-4 of the
norm of JAX's update.
"""

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.datasets import _synthetic_mnist as j_synthetic_mnist
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.models import LeNet as JLeNet
from deeplearning4j_tpu.models import SimpleCNN as JSimpleCNN
from deeplearning4j_tpu.models import TextGenerationLSTM as JTextLSTM
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import constraints as JK
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.attention_layers import SelfAttentionLayer as JSelfAttention
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator, MnistDataSetIterator
from deeplearning4j_tpu_torch.data.datasets import _synthetic_mnist
from deeplearning4j_tpu_torch.models import LeNet
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import constraints as TK
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from torch_mln_helpers import LOSS_REL, close, params_close, port_net, snapshot
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _mnist_batches(n_batches, batch, seed=7):
    imgs, labels = _synthetic_mnist(n_batches * batch, seed, True)
    x = (imgs.astype(np.float32) / 255.0).reshape(-1, 1, 28, 28)
    y = np.eye(10, dtype=np.float32)[labels]
    return [(x[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch])
            for i in range(n_batches)]


def test_synthetic_mnist_is_byte_identical_to_the_reference():
    for train in (True, False):
        ji, jl = j_synthetic_mnist(300, 123, train)
        ti, tl = _synthetic_mnist(300, 123, train)
        assert ji.dtype == ti.dtype == np.uint8
        assert ji.tobytes() == ti.tobytes() and np.array_equal(jl, tl)
    it = MnistDataSetIterator(64, train=True, num_examples=128)
    assert it.synthetic and it.total_examples() == 128
    ds = it.next()
    assert ds.features.shape == (64, 1, 28, 28) and ds.labels.shape == (64, 10)


def test_lenet_output_matches_jax():
    """LeNet at its published widths (conv 20 and 50 of 5x5 "same", max pool
    2x2, dense 500, softmax over 10), batch 8."""
    jnet = JLeNet().init()
    tnet = port_net(jnet)
    assert tnet.num_params() == jnet.num_params() == 1_256_080
    x, _ = _mnist_batches(1, 8)[0]
    close(tnet.output(x), jnet.output(x).numpy())


def test_lenet_three_adam_steps_match_jax():
    jnet = JLeNet().init()
    tnet = port_net(jnet)
    for x, y in _mnist_batches(3, 8):
        before = snapshot(jnet)
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
        assert _rel(tnet.score_, jnet.score_) <= LOSS_REL
        params_close(tnet, jnet, before)
    assert tnet.iteration == jnet.iteration == 3


def test_simple_cnn_output_matches_jax():
    """SimpleCNN (4 blocks of conv, BN, conv, max pool; dense 512, a
    DropoutLayer, softmax) at [3, 16, 16], batch 2, with random BN running
    statistics: inference (dropout off, running stats in use)."""
    jnet = JSimpleCNN(input_shape=(3, 16, 16)).init()
    rs = np.random.RandomState(5)
    jnet.bn_state = {k: {"mean": rs.randn(*v["mean"].shape).astype(np.float32) * 0.1,
                         "var": rs.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)}
                     for k, v in jnet.bn_state.items()}
    tnet = port_net(jnet)
    x = rs.rand(2, 3, 16, 16).astype(np.float32)
    close(tnet.output(x), jnet.output(x).numpy())


def _mlp_conf(C, K, U, grad_norm):
    """Dense (L1, L2, a max-norm constraint) → BN (L2 on gamma/beta) →
    frozen dense → output, with one gradient normalization, built alike in
    both packages (JSON cannot carry constraints)."""
    b = (C.NeuralNetConfiguration.Builder().seed(11).updater(U.Sgd(0.1)).list()
         .layer(C.DenseLayer(n_out=8, activation="tanh", l1=1e-3, l2=1e-2,
                             constraints=(K.MaxNormConstraint(0.9),)))
         .layer(C.BatchNormalization(l2=1e-2))
         .layer(C.DenseLayer(n_out=6, activation="relu", frozen=True))
         .layer(C.OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
         .set_input_type(C.InputType.feed_forward(5)))
    if grad_norm is not None:
        b._base.gradient_normalization(grad_norm, 0.05)
    return b.build()


@pytest.mark.parametrize("grad_norm", [None, "ClipElementWiseAbsoluteValue", "ClipL2PerLayer",
                                       "ClipL2PerParamType", "RenormalizeL2PerLayer"])
def test_train_step_gradient_normalization_matches_jax(grad_norm):
    """Two steps: the loss with L1/L2, frozen layer 2 (its updater runs on
    zero gradients), each gradient normalization, the constraint after the
    update, and the BN running state."""
    jnet = JNet(_mlp_conf(JC, JK, JU, grad_norm)).init()
    tnet = port_net(jnet, _mlp_conf(TC, TK, TU, grad_norm))
    rs = np.random.RandomState(3)
    for _ in range(2):
        x = rs.randn(16, 5).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 16)]
        before = snapshot(jnet)
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
        assert _rel(tnet.score_, jnet.score_) <= LOSS_REL
        params_close(tnet, jnet, before)
        for k in ("mean", "var"):
            close(getattr(tnet.bn_state["1"], k), np.asarray(jnet.bn_state["1"][k]))
    frozen = snapshot(jnet)["2"]
    for k, w in tnet.params_["2"].items():
        np.testing.assert_array_equal(w.detach().numpy(), frozen[k])
    norms = np.linalg.norm(tnet.params_["0"]["W"].detach().numpy(), axis=0)
    assert norms.max() <= 0.9 + 1e-5


def test_fit_scan_and_fit_arrays_match_jax():
    """fit_scan: per-step losses of a list of batches, as JAX's one scan;
    fit(features, labels, batch_size) batches like JAX's ArrayDataSetIterator."""
    conf = lambda C, U: (C.NeuralNetConfiguration.Builder().seed(2).updater(U.Adam(1e-2))  # noqa: E731
                         .list().layer(C.DenseLayer(n_out=7, activation="relu"))
                         .layer(C.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                         .set_input_type(C.InputType.feed_forward(4)).build())
    jnet = JNet(conf(JC, JU)).init()
    tnet = port_net(jnet)
    rs = np.random.RandomState(4)
    batches = [(rs.randn(10, 4).astype(np.float32),
                np.eye(3, dtype=np.float32)[rs.randint(0, 3, 10)]) for _ in range(3)]
    before = snapshot(jnet)
    jl = np.asarray(jnet.fit_scan([JDataSet(x, y) for x, y in batches]))
    tl = tnet.fit_scan([DataSet(x, y) for x, y in batches])
    np.testing.assert_allclose(tl, jl, rtol=LOSS_REL)
    params_close(tnet, jnet, before)
    x = np.concatenate([b[0] for b in batches])
    y = np.concatenate([b[1] for b in batches])
    before = snapshot(jnet)
    jnet.fit(x, y, batch_size=8)
    tnet.fit(x, y, batch_size=8)
    assert tnet.iteration == jnet.iteration == 7
    assert _rel(tnet.score_, jnet.score_) <= LOSS_REL
    params_close(tnet, jnet, before)


def test_inference_surface_matches_jax():
    """output, feed_forward, score(ds), evaluate and evaluate_regression on
    a BN network after a training step (running stats in use)."""
    conf = lambda C, U: (C.NeuralNetConfiguration.Builder().seed(5).updater(U.Sgd(0.05))  # noqa: E731
                         .list().layer(C.DenseLayer(n_out=6, activation="sigmoid"))
                         .layer(C.BatchNormalization())
                         .layer(C.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                         .set_input_type(C.InputType.feed_forward(4)).build())
    jnet = JNet(conf(JC, JU)).init()
    tnet = port_net(jnet)
    rs = np.random.RandomState(6)
    x = rs.randn(12, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 12)]
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    close(tnet.output(x), jnet.output(x).numpy())
    for got, want in zip(tnet.feed_forward(x), jnet.feed_forward(x)):
        close(got, want.numpy())
    assert _rel(tnet.score(DataSet(x, y)), jnet.score(JDataSet(x, y))) <= LOSS_REL
    assert tnet.evaluate(ListDataSetIterator([DataSet(x, y)])).accuracy() == \
        jnet.evaluate(JList([JDataSet(x, y)])).accuracy()
    tr = tnet.evaluate_regression(ListDataSetIterator([DataSet(x, y)]))
    jr = jnet.evaluate_regression(JList([JDataSet(x, y)]))
    assert _rel(tr.mean_squared_error(1), jr.mean_squared_error(1)) <= LOSS_REL


def test_self_attention_network_step_matches_jax():
    """SelfAttentionLayer (4 heads of 8) → GlobalPooling(avg) → Output over
    [B, 16, T] with a ragged features mask: one Adam step, the layers
    masked by the features mask (a key mask for attention)."""
    conf = (JC.NeuralNetConfiguration.Builder().seed(9).updater(JU.Adam(1e-2)).list()
            .layer(JSelfAttention(n_out=32, n_heads=4, head_size=8))
            .layer(JC.GlobalPoolingLayer(pooling_type="avg"))
            .layer(JC.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JC.InputType.recurrent(16, 12)).build())
    jnet = JNet(conf).init()
    tnet = port_net(jnet)
    rs = np.random.RandomState(8)
    x = rs.randn(4, 16, 12).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 4)]
    fm = (np.arange(12)[None] < np.array([[12], [5], [9], [1]])).astype(np.float32)
    before = snapshot(jnet)
    jnet.fit(JDataSet(x, y, features_mask=fm))
    tnet.fit(DataSet(x, y, features_mask=fm))
    assert _rel(tnet.score_, jnet.score_) <= LOSS_REL
    params_close(tnet, jnet, before)


def test_config_json_round_trip_both_ways():
    """A JAX ``conf.to_json()`` loads in the port and back, giving the same
    layers: LeNet, the char-RNN (tBPTT), and a network with a dropout
    scheme, BN, LastTimeStep, GlobalPooling, SelfAttention and LossLayer."""
    from deeplearning4j_tpu.nn import dropout as JD

    mixed = (JC.NeuralNetConfiguration.Builder().seed(3).updater(JU.Nesterovs(1e-2, 0.8))
             .l2(1e-4).activation("relu").list()
             .layer(JC.LSTM(n_out=6, dropout=JD.GaussianDropout(0.2)))
             .layer(JSelfAttention(n_out=8, n_heads=2, head_size=4))
             .layer(JC.BatchNormalization())
             .layer(JC.GlobalPoolingLayer(pooling_type="max"))
             .layer(JC.DenseLayer(n_out=5))
             .layer(JC.ActivationLayer(activation="tanh"))
             .layer(JC.LossLayer(loss="mse"))
             .set_input_type(JC.InputType.recurrent(4)).build())
    for jconf in (JLeNet().conf(), JTextLSTM().conf(), mixed):
        text = jconf.to_json()
        tconf = TC.MultiLayerConfiguration.from_json(text)
        assert [type(l).__name__ for l in tconf.layers] == \
            [type(l).__name__ for l in jconf.layers]
        back = tconf.to_json()
        assert json.loads(back) == json.loads(text)
        again = JC.MultiLayerConfiguration.from_json(back)
        assert again.to_json() == text
        assert tconf.input_types() == [TC.InputType(**JC.dataclasses.asdict(i))
                                       for i in jconf.input_types()]


def test_unported_layer_in_json_raises():
    jconf = (JC.NeuralNetConfiguration.Builder().list()
             .layer(JC.EmbeddingLayer(n_in=10, n_out=4))
             .layer(JC.OutputLayer(n_out=2)).build())
    with pytest.raises(NotImplementedError, match="EmbeddingLayer.*ROADMAP.md"):
        TC.MultiLayerConfiguration.from_json(jconf.to_json())
    # a graph configuration is ported (nn.graph_conf): the builder gives one
    from deeplearning4j_tpu_torch.nn.graph_conf import GraphBuilder

    assert isinstance(TC.NeuralNetConfiguration.Builder().graph_builder(), GraphBuilder)


def test_params_order_and_set_params_match_jax():
    jnet = JLeNet().init()
    tnet = port_net(jnet)
    np.testing.assert_array_equal(tnet.params().numpy(), jnet.params().numpy())
    flat = np.random.RandomState(1).randn(tnet.num_params()).astype(np.float32) * 0.05
    jnet.set_params(flat)
    tnet.set_params(flat)
    np.testing.assert_array_equal(tnet.params().numpy(), flat)
    x, _ = _mnist_batches(1, 4)[0]
    close(tnet.output(x), jnet.output(x).numpy())
    with pytest.raises(ValueError, match="numParams"):
        tnet.set_params(flat[:-1])


def test_clone_is_independent_and_not_ported_calls_raise():
    tnet = LeNet().init(device="cpu")
    copy = tnet.clone()
    x, y = _mnist_batches(1, 4)[0]
    tnet.fit(DataSet(x, y))
    assert not torch.equal(copy.params(), tnet.params())
    copy.fit(DataSet(x, y))
    assert torch.equal(copy.params(), tnet.params())
    for call in (lambda: tnet.set_bucketing(True), lambda: tnet.set_device_ingest(None),
                 lambda: tnet.export("m.zip", x), lambda: LeNet().init_pretrained()):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call()


def test_dropout_in_a_network_is_seeded_by_iteration():
    """Dropout draws from generators derived from (seed ^ 0x5EED, iteration,
    layer): one iteration repeats its masks (a clone's first step gives the
    same loss), the next iteration draws others, dropout changes the loss."""
    def conf(p):
        return (TC.NeuralNetConfiguration.Builder().seed(4).updater(TU.Sgd(0.0)).list()
                .layer(TC.DenseLayer(n_out=32, activation="relu", dropout=p))
                .layer(TC.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(TC.InputType.feed_forward(6)).build())

    rs = np.random.RandomState(2)
    ds = DataSet(rs.randn(64, 6).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rs.randint(0, 3, 64)])
    net = MultiLayerNetwork(conf(0.5), device="cpu").init()
    twin = net.clone()
    net.fit(ds)
    twin.fit(ds)
    first = net.score_
    assert first == twin.score_
    net.fit(ds)  # lr 0: only the masks change
    assert net.score_ != first
    plain = MultiLayerNetwork(conf(0.0), device="cpu").init()
    plain.fit(ds)
    assert plain.score_ != first


def test_wrapped_layer_json_where_the_reference_cannot_write_it():
    """A deliberate difference: the JAX package's ``Layer.to_json`` leaves a
    wrapped layer (``LastTimeStep(underlying=LSTM(...))``) as an object, so
    its ``conf.to_json()`` raises TypeError. The port writes the wrapped
    layer as a nested ``@class`` dict, which both packages' ``from_json``
    read back (JAX's already recurses into such dicts)."""
    def conf(C):
        return (C.NeuralNetConfiguration.Builder().seed(1).list()
                .layer(C.LastTimeStep(underlying=C.LSTM(n_out=4)))
                .layer(C.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(C.InputType.recurrent(3)).build())

    with pytest.raises(TypeError, match="not JSON serializable"):
        conf(JC).to_json()
    text = conf(TC).to_json()
    jconf = JC.MultiLayerConfiguration.from_json(text)
    assert isinstance(jconf.layers[0].underlying, JC.LSTM)
    assert TC.MultiLayerConfiguration.from_json(text).to_json() == text
    jnet = JNet(jconf).init()
    tnet = port_net(jnet, TC.MultiLayerConfiguration.from_json(text))
    x = np.random.RandomState(0).randn(2, 3, 5).astype(np.float32)
    close(tnet.output(x), jnet.output(x).numpy())
