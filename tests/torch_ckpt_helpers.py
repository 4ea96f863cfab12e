"""Helpers the port's checkpoint tests share (``tests/test_torch_checkpoint.py``,
``test_torch_verify_checkpoint.py``, ``test_torch_model_serializer.py``,
``test_torch_earlystopping.py``).

Three network kinds, each built by both packages from numpy-seeded data:
LeNet (Adam) at 28x28, the GravesLSTM char-RNN (vocab 16, hidden 32, tbptt
10) and a small ComputationGraph with BatchNormalization, a MergeVertex and
an ElementWiseVertex (node names "a.b" and "train" exercise the port's
module-key escapes). A network's state is compared as the flat {path:
array} map of the checkpoint format, bit for bit and dtype for dtype.
"""

import jax
import numpy as np

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.data.iterators import ArrayDataSetIterator as JArrayIt
from deeplearning4j_tpu.models import LeNet as JLeNet
from deeplearning4j_tpu.models import TextGenerationLSTM as JTextLSTM
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import graph_conf as JG
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serde.checkpoint import _leaf_paths
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator, DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import graph_conf as TG
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serde.net_state import snapshot

KINDS = ("lenet", "char_rnn", "bn_graph")
LOSS_REL = 1e-5  # the next fit step's score, relative (the MLN/CG parity bound)


def graph_conf(C, G, U, dtype="float32"):
    """Two inputs; Dense "d1" and "a.b" into a MergeVertex → BN → softmax
    head; their ElementWise product → Dense "train" → MSE head; Adam."""
    b = C.NeuralNetConfiguration.Builder().seed(5).updater(U.Adam(1e-2)).data_type(dtype)
    g = (b.graph_builder().add_inputs("x1", "x2")
         .set_input_types(C.InputType.feed_forward(5), C.InputType.feed_forward(4)))
    g.add_layer("d1", C.DenseLayer(n_out=6, activation="tanh"), "x1")
    g.add_layer("a.b", C.DenseLayer(n_out=6, activation="relu"), "x2")
    g.add_vertex("cat", G.MergeVertex(), "d1", "a.b")
    g.add_layer("bn", C.BatchNormalization(), "cat")
    g.add_vertex("prod", G.ElementWiseVertex("product"), "d1", "a.b")
    g.add_layer("train", C.DenseLayer(n_out=5, activation="sigmoid"), "prod")
    g.add_layer("cls", C.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "bn")
    g.add_layer("reg", C.OutputLayer(n_out=2, activation="identity", loss="mse"), "train")
    return g.set_outputs("cls", "reg").build()


def jax_net(kind, dtype="float32"):
    if kind == "lenet":
        return JLeNet().init()
    if kind == "char_rnn":
        return JNet(JTextLSTM(vocab_size=16, hidden=32, tbptt_length=10).conf()).init()
    if kind == "bn_graph":
        net = JGraph(graph_conf(JC, JG, JU, dtype))
        net.init()
        return net
    if kind == "bf16_mln":
        return JNet(bf16_conf(JC, JU)).init()
    raise ValueError(kind)


def port_net(kind, dtype="float32"):
    """The port's network of ``kind`` on the CPU, from its own seed (other
    weights than JAX's)."""
    if kind == "bn_graph":
        return ComputationGraph(graph_conf(TC, TG, TU, dtype), device="cpu").init()
    if kind == "bf16_mln":
        return MultiLayerNetwork(bf16_conf(TC, TU), device="cpu").init()
    conf = jax_net_conf(kind)
    return MultiLayerNetwork(TC.MultiLayerConfiguration.from_json(conf.to_json()),
                             device="cpu").init()


def jax_net_conf(kind):
    if kind == "lenet":
        return JLeNet().conf()
    return JTextLSTM(vocab_size=16, hidden=32, tbptt_length=10).conf()


def bf16_conf(C, U):
    """A bfloat16 Dense → Output MLN (the reference's bf16 checkpoint case)."""
    return (C.NeuralNetConfiguration.Builder().seed(3).updater(U.Adam(1e-2))
            .data_type("bfloat16").list()
            .layer(C.DenseLayer(n_in=4, n_out=5, activation="tanh"))
            .layer(C.OutputLayer(n_out=3, activation="softmax", loss="mcxent")).build())


def data(kind, n_batches=4, seed=0):
    """(features, labels, batch size) of ``n_batches`` batches."""
    rs = np.random.RandomState(seed)
    if kind == "lenet":
        B = 4
        x = rs.rand(n_batches * B, 1, 28, 28).astype(np.float32)
        return x, np.eye(10, dtype=np.float32)[rs.randint(0, 10, n_batches * B)], B
    if kind == "char_rnn":
        B, V, T = 3, 16, 23
        idx = rs.randint(0, V, (n_batches * B, T))
        x = np.eye(V, dtype=np.float32)[idx].transpose(0, 2, 1)
        y = np.eye(V, dtype=np.float32)[np.roll(idx, -1, 1)].transpose(0, 2, 1)
        return x, y, B
    B = 8
    n = n_batches * B
    feats = [rs.randn(n, 5).astype(np.float32), rs.randn(n, 4).astype(np.float32)]
    labels = [np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)],
              rs.randn(n, 2).astype(np.float32)]
    return feats, labels, B


def iterators(kind, n_batches=4, seed=0):
    """(JAX iterator, port iterator) over the same batches, or (None, None)
    for the graph (its MultiDataSet iterator has no position state)."""
    if kind == "bn_graph":
        return None, None
    x, y, B = data(kind, n_batches, seed)
    return JArrayIt(x, y, B), ArrayDataSetIterator(x, y, B)


def batch(kind, i, n_batches=4, seed=0):
    """Batch ``i`` as (JAX DataSet, port DataSet)."""
    x, y, B = data(kind, n_batches, seed)
    sl = slice(i * B, (i + 1) * B)
    if kind == "bn_graph":
        f, l = [a[sl] for a in x], [a[sl] for a in y]
        return JMultiDataSet(f, l), MultiDataSet(f, l)
    return JDataSet(x[sl], y[sl]), DataSet(x[sl], y[sl])


def jax_state(jnet):
    """The JAX network's state as {path: numpy array}, the checkpoint's keys."""
    out = {}
    for top, tree in (("params", jnet.params_), ("updater", jnet.updater_state),
                      ("bn", jnet.bn_state)):
        for path, leaf in _leaf_paths(jax.tree.map(np.asarray, tree)):
            out[f"{top}/{path}"] = leaf
    return out


def _raw(a):
    """An array's raw bytes and shape (ml_dtypes' bfloat16 and numpy's |V2
    compare as the same two bytes)."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint8).tobytes(), a.shape, a.dtype.itemsize


def assert_same_state(tnet, jnet):
    """Parameters, updater state and BN statistics bit for bit."""
    got, want = snapshot(tnet), jax_state(jnet)
    assert sorted(got) == sorted(want)
    for path in want:
        assert _raw(got[path]) == _raw(want[path]), path


def assert_states_equal(a, b):
    """Two port networks' state bit for bit."""
    sa, sb = snapshot(a), snapshot(b)
    assert sorted(sa) == sorted(sb)
    for path in sa:
        assert sa[path].dtype == sb[path].dtype and _raw(sa[path]) == _raw(sb[path]), path
