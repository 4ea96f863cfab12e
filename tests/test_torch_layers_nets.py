"""The new layers inside networks, against the JAX package on the CPU: the
ConvLSTM frame predictor at narrow widths, a GRU stack under a labels mask,
MaskLayer under a features mask, MaskZeroLayer and TimeDistributed,
FrozenLayerWithBackprop, the center-loss and one-class heads, every new loss
head as the last layer of a MultiLayerNetwork and as an output of a
ComputationGraph, and the learning tests of the JAX package's OCNN and
Conv1D family.

Each network is built by both packages; the port's takes the JAX
network's weights and Adam state through the bridge. Held: the
configuration JSON and ``num_params()`` equal, ``output()`` within 1e-5
(absolute), and one Adam step with the score within 1e-6 relative and each
parameter's update within 2e-5 of its norm. ``python3
tests/torch_float64_step.py --jax --threads 1 --only convlstm_8`` puts the
port's and the JAX package's float32 ConvLSTM steps 8.8e-6 and 8.8e-6
(worst tensor) from a float64 step of the same network and batch, and the
scores within 1e-7; the bound is the sum, rounded up, and the smaller
networks here take the same.

GravesBidirectionalLSTM: the JAX package's ``num_params()``, ``params()``
and L2 raise on its nested ``{"fwd", "bwd"}`` tree (a reference bug); the
port counts, orders and regularises the flat keys, pinned here.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import partition as JPart
from deeplearning4j_tpu.parallel.mesh import mesh_from_shape as jmesh_from_shape
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import partition as TPart
from deeplearning4j_tpu_torch.parallel.mesh import Mesh
from torch_float64_step import (SMALL_CONVLSTM, convlstm_conf, mask_zero_stack,
                                padded_sequences, small_frames)
from torch_mln_helpers import flat_tree, layers, port_graph, port_net, snapshot
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

OUT_ATOL = 1e-5    # outputs, absolute
LOSS_REL = 1e-6    # a fit's score, relative (float64-derived, module docstring)
UPDATE_REL = 2e-5  # each parameter's update in a fit, of its norm (likewise)


def _mln(build, seed=3, lr=1e-2, **builder):
    """(JAX network, port network bridged from it) of ``build(L, b)``, where
    ``L`` is :func:`layers` of a package and ``b`` its list builder."""
    nets = []
    for port, (C, U) in ((False, (JC, JU)), (True, (TC, TU))):
        b = C.NeuralNetConfiguration.Builder().seed(seed).updater(U.Adam(lr))
        for k, v in builder.items():
            b = getattr(b, k)(v)
        nets.append(build(layers(port), b.list()).build())
    jnet = JNet(nets[0]).init()
    return jnet, port_net(jnet, nets[1])


def fit_like_jax(jnet, tnet, x, y, fmask=None, lmask=None, graph=False, counts=True):
    """The JSON, ``num_params()`` (where the JAX package can count:
    ``counts``), ``output()`` and one Adam step of the two networks: the
    score and each parameter's update (nested trees by their flat
    ``"fwd/W"`` keys)."""
    assert tnet.conf.to_json() == jnet.conf.to_json()
    if counts:
        assert tnet.num_params() == jnet.num_params()
    if not graph:
        np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x).numpy()),
                                   rtol=0, atol=OUT_ATOL)
    before = {f"{si}/{k}": v for si, d in snapshot(jnet).items() for k, v in flat_tree(d).items()}
    jnet.fit(JDataSet(x, y, fmask, lmask))
    tnet.fit(DataSet(x, y, fmask, lmask))
    assert abs(tnet.score_ - float(jnet.score_)) <= LOSS_REL * abs(float(jnet.score_))
    after = {f"{si}/{k}": v for si, d in jax.tree.map(np.asarray, jnet.params_).items()
             for k, v in flat_tree(d).items()}
    entries = {f"{si}/{k}": p for si, k, p in tnet._param_entries()}
    assert sorted(entries) == sorted(after)
    for key, p in entries.items():
        want = after[key] - before[key]
        n = np.linalg.norm(want)
        err = np.linalg.norm(p.detach().numpy() - before[key] - want) / (n if n > 0 else 1.0)
        assert err <= UPDATE_REL, f"{key}: update off by {err:.2e}"


def test_convlstm_frame_predictor_matches_jax():
    """Two ConvLSTM layers of 8 over 4 frames of 4 patch channels of 8x8,
    a 1x1x1 convolution and the per-voxel sigmoid cross-entropy against the
    next frame (``chip_smoke.py`` phase 18b at narrow widths)."""
    jnet = JNet(convlstm_conf(JC, JU, **SMALL_CONVLSTM)).init()
    x, y = small_frames(2)
    fit_like_jax(jnet, port_net(jnet), x, y)


def test_gru_stack_under_a_labels_mask_matches_jax():
    """GRU (reset after) → GRU (reset before) → RnnLossLayer's per-step
    softmax cross-entropy, steps masked by the labels mask."""
    jnet, tnet = _mln(lambda L, b: b.layer(L.GRULayer(n_in=3, n_out=5))
                      .layer(L.GRULayer(n_out=4, reset_after=False))
                      .layer(L.RnnLossLayer(loss="mcxent", activation="softmax"))
                      .set_input_type(L.InputType.recurrent(3, 6)))
    rs = np.random.RandomState(1)
    x = rs.randn(3, 3, 6).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, (3, 6))].transpose(0, 2, 1)
    lmask = np.array([[1, 1, 1, 1, 0, 0], [1] * 6, [1, 1, 0, 0, 0, 0]], np.float32)
    fit_like_jax(jnet, tnet, x, y, lmask=lmask)


def test_mask_layer_takes_the_features_mask():
    """The network hands MaskLayer the features mask (as the JAX package
    does): the masked steps of the LSTM's output are zero before the
    per-step head, in ``output()``'s forward and in the fit."""
    jnet, tnet = _mln(lambda L, b: b.layer(L.LSTM(n_in=3, n_out=5))
                      .layer(L.MaskLayer())
                      .layer(L.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                      .set_input_type(L.InputType.recurrent(3, 5)))
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 5).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (2, 5))].transpose(0, 2, 1)
    fmask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    fit_like_jax(jnet, tnet, x, y, fmask=fmask, lmask=fmask)
    h, _, _ = tnet._forward(tnet._params(), tnet._bn(), torch.from_numpy(x), training=False,
                            rng=None, fmask=torch.from_numpy(fmask))
    assert torch.all(h[0, :, 3:] == 0) and torch.all(h[1] != 0)


def test_mask_zero_and_time_distributed_match_jax():
    """MaskZeroLayer(LSTM) over padded steps → TimeDistributed(Dense) →
    RnnOutputLayer: the wrappers take their wrapped layers' parameters.
    ``python3 tests/torch_float64_step.py --jax --threads 1 --only
    mask_zero`` puts both packages' float32 steps 1.8e-6 (worst tensor) from
    a float64 step."""
    jnet = JNet(mask_zero_stack(JC, JU)).init()
    fit_like_jax(jnet, port_net(jnet), *padded_sequences(3))


def test_frozen_layer_with_backprop_matches_jax():
    """The wrapped layer's parameters keep their values through a fit while
    the layer before it learns through it, as in the JAX package."""
    jnet, tnet = _mln(lambda L, b: b.layer(L.DenseLayer(n_in=5, n_out=6, activation="tanh"))
                      .layer(L.FrozenLayerWithBackprop(underlying=L.DenseLayer(
                          n_out=4, activation="relu")))
                      .layer(L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                      .set_input_type(L.InputType.feed_forward(5)))
    frozen = {k: v.detach().clone() for k, v in tnet.params_["1"].items()}
    first = tnet.params_["0"]["W"].detach().clone()
    rs = np.random.RandomState(4)
    x = rs.randn(6, 5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 6)]
    fit_like_jax(jnet, tnet, x, y)
    assert all(torch.equal(tnet.params_["1"][k], v) for k, v in frozen.items())
    assert not torch.equal(tnet.params_["0"]["W"], first)


def test_center_loss_head_matches_jax():
    """Dense → PReLU → CenterLossOutputLayer: the centers are a parameter
    under Adam."""
    jnet, tnet = _mln(lambda L, b: b.layer(L.DenseLayer(n_in=6, n_out=5, activation="identity"))
                      .layer(L.PReLULayer())
                      .layer(L.CenterLossOutputLayer(n_out=3, lambda_=0.5))
                      .set_input_type(L.InputType.feed_forward(6)))
    rs = np.random.RandomState(5)
    x = rs.randn(8, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
    fit_like_jax(jnet, tnet, x, y)
    assert float(tnet.params_["2"]["centers"].abs().sum()) > 0


def test_ocnn_zero_d_margin_through_params_and_set_params():
    """OCNN's 0-d margin ``r``: the bridge, the updater state, one Adam step,
    ``params()`` in the JAX package's order (layers by index, names sorted:
    V, r, w), ``set_params`` back, and the partitioner's roles and specs."""
    jnet, tnet = _mln(lambda L, b: b.layer(L.DenseLayer(n_in=4, n_out=6, activation="relu"))
                      .layer(L.OCNNOutputLayer(hidden_size=3, nu=0.2))
                      .set_input_type(L.InputType.feed_forward(4)))
    assert tnet.params_["1"]["r"].dim() == 0
    assert tnet.updater_state["m"]["1.r"].dim() == 0
    rs = np.random.RandomState(6)
    x = rs.randn(7, 4).astype(np.float32)
    fit_like_jax(jnet, tnet, x, np.zeros((7, 1), np.float32))
    np.testing.assert_allclose(tnet.params().numpy(), np.asarray(jnet.params().numpy()), rtol=0,
                               atol=1e-6)
    assert [k for si, k, _ in tnet._param_entries() if si == "1"] == ["V", "r", "w"]
    flat = rs.randn(tnet.num_params()).astype(np.float32)
    tnet.set_params(flat)
    np.testing.assert_array_equal(tnet.params().numpy(), flat)
    assert float(tnet.params_["1"]["r"]) == flat[4 * 6 + 6 + 6 * 3]
    # the partitioner: "r" is a bias, its 0-d spec replicated, as in JAX
    jroles, troles = JPart.param_role_tree(jnet), TPart.param_role_tree(tnet)
    assert troles == jroles and troles["1"]["r"] == "bias"
    jmesh = jmesh_from_shape({"data": 1, "fsdp": 2, "tp": 2}, devices=jax.devices()[:4])
    jspecs = JPart.Partitioner(JPart.SpecLayout(1, 2, 2), mesh=jmesh).spec_tree(jnet.params_,
                                                                                 jroles)
    tspecs = TPart.Partitioner(TPart.SpecLayout(1, 2, 2), mesh=Mesh.virtual(
        {"data": 1, "fsdp": 2, "tp": 2}, 0)).spec_tree(TPart.param_tree(tnet), troles)
    assert {k: tuple(v) for k, v in tspecs["1"].items()} == \
        {k: tuple(v) for k, v in jspecs["1"].items()}
    assert tuple(tspecs["1"]["r"]) == ()


def _heads(L, container):
    """(name, layers before the head, head, input type, batch) of each new
    loss head."""
    return [
        ("center_loss", [L.DenseLayer(n_out=4, activation="tanh")],
         L.CenterLossOutputLayer(n_out=3, lambda_=0.2), L.InputType.feed_forward(5)),
        ("ocnn", [L.DenseLayer(n_out=4, activation="tanh")], L.OCNNOutputLayer(hidden_size=3),
         L.InputType.feed_forward(5)),
        ("rnn_loss", [L.SimpleRnn(n_out=3)], L.RnnLossLayer(loss="mse"),
         L.InputType.recurrent(4, 5)),
        ("cnn_loss", [L.ConvolutionLayer(n_out=3, kernel_size=(3, 3), convolution_mode="same")],
         L.CnnLossLayer(loss="xent", activation="sigmoid"), L.InputType.convolutional(5, 4, 2)),
        ("cnn3d_loss", [L.Convolution3D(n_out=3, kernel_size=(2, 2, 2), convolution_mode="same")],
         L.Cnn3DLossLayer(loss="mse"), L.InputType.convolutional3d(3, 4, 4, 2)),
        ("capsnet", [L.PrimaryCapsules(capsules=2, capsule_dim=4, kernel_size=3, stride=2),
                     L.CapsuleLayer(capsules=3, capsule_dim=4), L.CapsuleStrengthLayer()],
         L.CapsNetOutputLayer(), L.InputType.convolutional(7, 7, 2)),
    ]


def _head_batch(name, it, rs):
    B = 4
    if it.kind == "ff":
        x = rs.randn(B, it.size).astype(np.float32)
    elif it.kind == "rnn":
        x = rs.randn(B, it.size, it.timeseries_length).astype(np.float32)
    elif it.kind == "cnn":
        x = rs.randn(B, it.channels, it.height, it.width).astype(np.float32)
    else:
        x = rs.randn(B, it.channels, it.depth, it.height, it.width).astype(np.float32)
    y = {"center_loss": lambda: np.eye(3, dtype=np.float32)[rs.randint(0, 3, B)],
         "ocnn": lambda: np.zeros((B, 1), np.float32),
         "rnn_loss": lambda: rs.randn(B, 3, 5).astype(np.float32),
         "cnn_loss": lambda: rs.rand(B, 3, 5, 4).astype(np.float32),
         "cnn3d_loss": lambda: rs.randn(B, 3, 3, 4, 4).astype(np.float32),
         "capsnet": lambda: np.eye(3, dtype=np.float32)[rs.randint(0, 3, B)]}[name]()
    return x, y


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_every_loss_head_trains_like_jax(container):
    """CenterLoss, OCNN, the three headless loss layers and CapsNet's margin
    head as the last layer of a MultiLayerNetwork and as the output of a
    ComputationGraph: one Adam step each, from the JAX network's weights."""
    rs = np.random.RandomState(7)
    for i, (jhead, thead) in enumerate(zip(_heads(layers(False), container),
                                           _heads(layers(True), container))):
        nets = []
        for (name, body, head, it), (C, U) in ((jhead, (JC, JU)), (thead, (TC, TU))):
            b = C.NeuralNetConfiguration.Builder().seed(9 + i).updater(U.Adam(1e-2))
            if container == "mln":
                lb = b.list()
                for layer in body + [head]:
                    lb = lb.layer(layer)
                nets.append(lb.set_input_type(it).build())
            else:
                g = b.graph_builder().add_inputs("in").set_input_types(it)
                prev = "in"
                for k, layer in enumerate(body + [head]):
                    g.add_layer(f"l{k}", layer, prev)
                    prev = f"l{k}"
                nets.append(g.set_outputs(prev).build())
        if container == "mln":
            jnet = JNet(nets[0]).init()
            tnet = port_net(jnet, nets[1])
        else:
            jnet = JGraph(nets[0])
            jnet.init()
            tnet = port_graph(jnet)
        x, y = _head_batch(jhead[0], jhead[3], rs)
        fit_like_jax(jnet, tnet, x, y, graph=container == "graph")


def test_graves_bidirectional_counts_and_regularisation_reference_bug():
    """A JAX reference bug: on an MLN holding a GravesBidirectionalLSTM its
    ``num_params()`` raises AttributeError, ``params()`` TypeError and a fit
    under L2 TypeError (the nested {"fwd", "bwd"} tree). The port counts
    both directions' peephole LSTMs, orders them "bwd/..." then "fwd/...",
    each sorted, and its L2 covers each direction's weights and peepholes
    but not its bias; without L2 a fit matches JAX's."""
    def build(L, b):
        return (b.layer(L.GravesBidirectionalLSTM(n_in=3, n_out=4))
                .layer(L.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(L.InputType.recurrent(3, 5)))

    rs = np.random.RandomState(8)
    x = rs.randn(2, 3, 5).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (2, 5))].transpose(0, 2, 1)
    jl2, tl2 = _mln(build, l2=1e-1)
    with pytest.raises(AttributeError):
        jl2.num_params()
    with pytest.raises(TypeError):
        jl2.params()
    with pytest.raises(TypeError):
        jl2.fit(JDataSet(x, y))
    H, I = 4, 3
    per_direction = I * 4 * H + H * 4 * H + 4 * H + 3 * H
    assert tl2.num_params() == 2 * per_direction + 4 * 2 + 2
    names = [k for si, k, _ in tl2._param_entries() if si == "0"]
    assert names == [f"{d}/{n}" for d in ("bwd", "fwd") for n in ("RW", "W", "b", "pf", "pi",
                                                                     "po")]
    assert tl2.params().shape == (tl2.num_params(),)
    ds = DataSet(x, y)
    weights = sum(float((p.double() ** 2).sum()) for si, k, p in tl2._param_entries()
                  if not k.endswith("b"))
    plain = MultiLayerNetwork(TC.MultiLayerConfiguration.from_json(
        tl2.conf.to_json().replace('"l2": 0.1', '"l2": 0.0')), device="cpu").init()
    plain.set_params(tl2.params())
    np.testing.assert_allclose(tl2.score(ds) - plain.score(ds), 0.1 * 0.5 * weights, rtol=1e-5)
    jnet, tnet = _mln(build)
    fit_like_jax(jnet, tnet, x, y, counts=False)


def test_partitioned_graves_bidirectional_gathers_its_nested_keys():
    """A partitioned network's ``gather_state`` finds the spec of a nested
    layer's flat key (``params/0/fwd/W``, ``updater/m/0/fwd/W``); it looked
    up layer "fwd" before. A one-rank mesh: the blocks are the whole
    tensors, so the gathered state is the network's own."""
    from deeplearning4j_tpu_torch.serde.net_state import snapshot as port_state

    conf = (TC.NeuralNetConfiguration.Builder().seed(1).updater(TU.Adam(1e-2)).list()
            .layer(TC.LAYER_REGISTRY["GravesBidirectionalLSTM"](n_in=3, n_out=4))
            .layer(TC.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(TC.InputType.recurrent(3, 5)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    want = port_state(net)
    TPart.Partitioner(TPart.SpecLayout(1, 1, 1), mesh=Mesh.virtual(
        {"data": 1, "fsdp": 1, "tp": 1}, 0)).partition_net(net)
    got = net._partition.gather_state(net)
    assert "params/0/fwd/W" in got and "updater/m/0/bwd/pi" in got
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_ocnn_separates_inliers():
    """The JAX package's OCNN test in the port: trained on one cluster,
    inliers score above far outliers."""
    rs = np.random.RandomState(0)
    X = (rs.randn(256, 4) * 0.3 + 2.0).astype(np.float32)
    conf = (TC.NeuralNetConfiguration.Builder().seed(3).updater(TU.Adam(1e-2)).list()
            .layer(TC.DenseLayer(n_out=16, activation="relu"))
            .layer(TC.LAYER_REGISTRY["OCNNOutputLayer"](hidden_size=8, nu=0.1))
            .set_input_type(TC.InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    for _ in range(120):
        net.fit(DataSet(X, np.zeros((256, 1), np.float32)))
    inl = net.output(X[:32]).numpy().mean()
    outl = net.output((rs.randn(32, 4) * 0.3 - 6.0).astype(np.float32)).numpy().mean()
    assert inl > outl + 0.05, (inl, outl)


def test_conv1d_family_learns():
    """The JAX package's Conv1D-family test in the port: a bump early or
    late in the sequence, two Conv1D layers around a pooling, global max
    pooling, above 90% after 60 steps."""
    L = layers(True)
    conf = (TC.NeuralNetConfiguration.Builder().seed(3).updater(TU.Adam(5e-3)).list()
            .layer(L.Convolution1DLayer(n_in=4, n_out=8, kernel_size=3, activation="relu"))
            .layer(L.Subsampling1DLayer(kernel_size=2, stride=2))
            .layer(L.Convolution1DLayer(n_out=8, kernel_size=3, activation="relu"))
            .layer(L.GlobalPoolingLayer(pooling_type="max"))
            .layer(L.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(L.InputType.recurrent(4, 16)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rs = np.random.RandomState(0)
    x = rs.randn(64, 4, 16).astype(np.float32) * 0.1
    y = rs.randint(0, 2, 64)
    for i, c in enumerate(y):
        x[i, :, 2 if c == 0 else 12] += 2.0
    labels = np.eye(2, dtype=np.float32)[y]
    assert net.output(x[:4]).shape == (4, 2)
    for _ in range(60):
        net.fit(DataSet(x, labels))
    assert (net.output(x).numpy().argmax(-1) == y).mean() > 0.9


def test_space_to_batch_output_matches_jax():
    """SpaceToBatch moves blocks to the batch axis mid-network; the port
    does with it what the JAX package does (``output()`` of bh·bw·B rows)
    and nothing more."""
    jnet, tnet = _mln(lambda L, b: b.layer(L.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                                              convolution_mode="same"))
                      .layer(L.SpaceToBatch(block_size=(2, 2)))
                      .layer(L.CnnLossLayer(activation="tanh"))
                      .set_input_type(L.InputType.convolutional(6, 4, 2)))
    x = np.random.RandomState(9).randn(3, 2, 6, 4).astype(np.float32)
    out = tnet.output(x)
    assert tuple(out.shape) == (12, 3, 3, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x).numpy()), rtol=0,
                               atol=OUT_ATOL)
