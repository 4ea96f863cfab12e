"""Port parity: shape bucketing (``deeplearning4j_tpu_torch.common.bucketing``,
``set_bucketing`` on the MultiLayerNetwork and the ComputationGraph,
``ParallelTrainer(bucketing=)``) against the JAX package's, on the CPU.

The padded DataSets and MultiDataSets equal the JAX package's array for
array (numpy in, numpy out; a tensor pads to the same values); a bucketed
fit equals the JAX package's bucketed fit and the port's unbucketed fit
within 1e-6 (losses and every parameter), as the JAX package pins its own;
BatchNormalization is refused; ``last_batch_size`` stays the true count;
``tdl_bucket_pad_rows_total`` counts the phantom rows.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common import bucketing as JB
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.common import bucketing as TB
from deeplearning4j_tpu_torch.data import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.monitoring.registry import get_registry
from torch_mln_helpers import port_graph, port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

PARITY = 1e-6  # bucketed against unbucketed and against JAX: losses and parameters


def _arrays(ds):
    if hasattr(ds, "features_masks"):
        return [*ds.features, *ds.labels, *(ds.features_masks or []), *(ds.labels_masks or [])]
    return [ds.features, ds.labels, ds.features_mask, ds.labels_mask]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else a


def _cases():
    rs = np.random.RandomState(0)
    ones = lambda *s: rs.rand(*s).astype(np.float32)  # noqa: E731
    return {
        "rows": ((ones(17, 3), ones(17, 5), None, None), JB.BucketSpec(min_batch=32)),
        "aligned": ((ones(32, 3), ones(32, 5), None, None), JB.BucketSpec(min_batch=32)),
        "aligned_masked": ((ones(32, 3), ones(32, 5), None, np.ones(32, np.float32)),
                           JB.BucketSpec(min_batch=32)),
        "sequence": ((ones(4, 2, 37), ones(4, 2, 37), None, np.ones((4, 37), np.float32)),
                     JB.BucketSpec(min_batch=4, sequence=True, min_seq=16)),
        "multiple": ((ones(5, 3), ones(5, 2), None, None), JB.BucketSpec(batch_multiple=3)),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_pad_dataset_matches_jax(case):
    arrays, jspec = _cases()[case]
    spec = TB.BucketSpec(**{f: getattr(jspec, f) for f in jspec.__dataclass_fields__})
    jpad, jn = JB.pad_dataset(JDataSet(*arrays), jspec)
    tpad, tn = TB.pad_dataset(DataSet(*arrays), spec)
    assert tn == jn
    for got, want in zip(_arrays(tpad), _arrays(jpad)):
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, np.asarray(want))
    # the same batch as CPU tensors pads to the same values, as tensors
    tens = DataSet(*arrays)
    tens.features, tens.labels = torch.from_numpy(arrays[0]), torch.from_numpy(arrays[1])
    padded, _ = TB.pad_dataset(tens, spec)
    for got, want in zip(_arrays(padded), _arrays(jpad)):
        if want is not None:
            np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_pad_multidataset_matches_jax_and_counts_the_pad():
    rs = np.random.RandomState(1)
    feats = [rs.rand(9, 3).astype(np.float32), rs.rand(9, 2).astype(np.float32)]
    labels = [rs.rand(9, 4).astype(np.float32), rs.rand(9, 1).astype(np.float32)]
    counter = get_registry().counter("tdl_bucket_pad_rows_total", labels=("path",))
    before = counter.labels("train").value
    jpad, jn = JB.pad_multidataset(JMultiDataSet(feats, labels), JB.BucketSpec(min_batch=16))
    tpad, tn = TB.pad_multidataset(MultiDataSet(feats, labels), TB.BucketSpec(min_batch=16))
    assert tn == jn == 9
    assert counter.labels("train").value - before == 7
    for got, want in zip(_arrays(tpad), _arrays(jpad)):
        np.testing.assert_array_equal(got, np.asarray(want))
    again, _ = TB.pad_multidataset(tpad, TB.BucketSpec(min_batch=16))
    assert again is tpad  # aligned and masked: untouched
    with pytest.raises(ValueError, match="labels_mask"):
        TB.pad_dataset(DataSet(np.ones((4, 2, 37), np.float32), np.ones((4, 2, 37), np.float32)),
                       TB.BucketSpec(sequence=True, min_seq=16))


def _lenet_conf(C, U):
    return (C.NeuralNetConfiguration.Builder().seed(0).updater(U.Adam(1e-2)).list()
            .layer(C.ConvolutionLayer(n_out=4, kernel_size=(3, 3), activation="relu"))
            .layer(C.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
            .layer(C.DenseLayer(n_out=16, activation="relu"))
            .layer(C.OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(C.InputType.convolutional(12, 12, 1)).build())


def _params(tnet):
    return np.concatenate([p.detach().numpy().ravel() for _, _, p in tnet._param_entries()])


def test_lenet_bucketed_fit_matches_jax_and_the_unbucketed_fit():
    """Batches of 16, 16 and a ragged 13 padded to 16: per-step losses and
    the final parameters equal the JAX package's bucketed fit and the port's
    unbucketed fit within 1e-6."""
    rs = np.random.RandomState(0)
    X = rs.rand(45, 1, 12, 12).astype(np.float32)
    Y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 45)]
    jnet = JNet(_lenet_conf(JC, JU)).init()
    plain, bucketed = port_net(jnet), port_net(jnet)
    jnet.set_bucketing(JB.BucketSpec(min_batch=16))
    assert bucketed.set_bucketing(TB.BucketSpec(min_batch=16)) is bucketed
    for lo in range(0, 45, 16):
        jnet._fit_batch(JDataSet(X[lo:lo + 16], Y[lo:lo + 16]))
        plain._fit_batch(DataSet(X[lo:lo + 16], Y[lo:lo + 16]))
        bucketed._fit_batch(DataSet(X[lo:lo + 16], Y[lo:lo + 16]))
        assert abs(bucketed.score_ - plain.score_) <= PARITY
        assert abs(bucketed.score_ - float(jnet.score_)) <= PARITY
    assert bucketed.last_batch_size == 13
    np.testing.assert_allclose(_params(bucketed), _params(plain), atol=PARITY)
    np.testing.assert_allclose(_params(bucketed), np.asarray(jnet.params().numpy()),
                               atol=PARITY)


def _graph_conf(C, U):
    g = (C.NeuralNetConfiguration.Builder().seed(0).updater(U.Adam(1e-2)).graph_builder()
         .add_inputs("in").set_input_types(C.InputType.feed_forward(6)))
    g.add_layer("d", C.DenseLayer(n_out=12, activation="relu"), "in")
    g.add_layer("out", C.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "d")
    g.set_outputs("out")
    return g.build()


def test_graph_bucketed_fit_matches_jax_and_the_unbucketed_fit():
    rs = np.random.RandomState(1)
    X = rs.randn(21, 6).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 21)]
    jnet = JGraph(_graph_conf(JC, JU)).init()
    plain, bucketed = port_graph(jnet), port_graph(jnet)
    jnet.set_bucketing(JB.BucketSpec(min_batch=16))
    assert bucketed.set_bucketing(True)._bucketing == TB.BucketSpec()
    bucketed.set_bucketing(TB.BucketSpec(min_batch=16))
    for lo in range(0, 21, 16):
        jnet.fit(JDataSet(X[lo:lo + 16], Y[lo:lo + 16]))
        plain.fit(DataSet(X[lo:lo + 16], Y[lo:lo + 16]))
        bucketed.fit(DataSet(X[lo:lo + 16], Y[lo:lo + 16]))
        assert abs(bucketed.score_ - plain.score_) <= PARITY
        assert abs(bucketed.score_ - float(jnet.score_)) <= PARITY
    assert bucketed.last_batch_size == jnet.last_batch_size == 5
    np.testing.assert_allclose(_params(bucketed), _params(plain), atol=PARITY)
    # a MultiDataSet pads every stream
    bucketed.fit(MultiDataSet([X[:5]], [Y[:5]]))
    assert bucketed.last_batch_size == 5


def test_batchnorm_is_refused_and_none_turns_bucketing_off():
    conf = (JC.NeuralNetConfiguration.Builder().seed(0).list()
            .layer(JC.DenseLayer(n_in=4, n_out=4)).layer(JC.BatchNormalization())
            .layer(JC.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(JC.InputType.feed_forward(4)).build())
    jnet = JNet(conf).init()
    tnet = port_net(jnet)
    for net, spec in ((jnet, JB.BucketSpec()), (tnet, TB.BucketSpec())):
        with pytest.raises(ValueError, match="BatchNormalization"):
            net.set_bucketing(spec)
    tnet.set_bucketing(TB.BucketSpec(batch=False, sequence=True))  # no rows padded: allowed
    assert tnet.set_bucketing(None)._bucketing is None


def _lstm_conf(C, U, tbptt):
    b = (C.NeuralNetConfiguration.Builder().seed(0).updater(U.Adam(1e-2)).list()
         .layer(C.LSTM(n_in=2, n_out=4))
         .layer(C.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
         .set_input_type(C.InputType.recurrent(2)))
    return (b.t_bptt_length(4) if tbptt else b).build()


@pytest.mark.parametrize("tbptt", [False, True], ids=["sequence", "tbptt"])
def test_recurrent_bucketing_matches_jax(tbptt):
    """Sequence bucketing (T 11 → 16 with the labels mask extended) and,
    under tBPTT, the per-example [B] mask of batch bucketing broadcast over
    the time steps: the port's bucketed step equals JAX's and its own
    unbucketed step within 1e-6."""
    rs = np.random.RandomState(7)
    T = 8 if tbptt else 11
    x = rs.randn(3, 2, T).astype(np.float32)
    y = np.zeros((3, 2, T), np.float32)
    y[:, 1] = 1.0
    lm = None if tbptt else np.ones((3, T), np.float32)
    spec = dict(min_batch=4) if tbptt else dict(min_batch=4, sequence=True, min_seq=16)
    jnet = JNet(_lstm_conf(JC, JU, tbptt)).init()
    plain, bucketed = port_net(jnet), port_net(jnet)
    jnet.set_bucketing(JB.BucketSpec(**spec))
    bucketed.set_bucketing(TB.BucketSpec(**spec))
    jnet._fit_batch(JDataSet(x, y, None, lm))
    plain._fit_batch(DataSet(x, y, None, lm))
    bucketed._fit_batch(DataSet(x, y, None, lm))
    assert bucketed.last_batch_size == 3
    assert abs(bucketed.score_ - plain.score_) <= PARITY
    assert abs(bucketed.score_ - float(jnet.score_)) <= PARITY
    np.testing.assert_allclose(_params(bucketed), _params(plain), atol=PARITY)


def test_parallel_trainer_bucketing_folds_the_data_group_into_the_multiple(monkeypatch):
    """``ParallelTrainer(bucketing=)`` pads to a bucket that the data group
    divides (the lcm of the spec's multiple and the group's size), so no
    bucketed batch takes the remainder step; one rank's fit equals the
    unbucketed fit within 1e-6, and ``last_batch_size`` is the true 19."""
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer

    conf = (JC.NeuralNetConfiguration.Builder().seed(3).updater(JU.Adam(1e-2)).list()
            .layer(JC.DenseLayer(n_in=8, n_out=16, activation="relu"))
            .layer(JC.OutputLayer(n_out=4, activation="softmax", loss="mcxent")).build())
    rs = np.random.RandomState(2)
    X = rs.randn(19, 8).astype(np.float32)
    Y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 19)]
    jnet = JNet(conf).init()
    plain, net = port_net(jnet), port_net(jnet)
    plain._fit_batch(DataSet(X, Y))
    trainer = ParallelTrainer(net, bucketing=TB.BucketSpec(min_batch=8, batch_multiple=2))
    monkeypatch.setattr(trainer, "_bucket_multiple", lambda: 3)
    padded, true_n = trainer._bucket_for_mesh(DataSet(X, Y))
    assert true_n == 19 and padded.num_examples() == 24  # 6 · 2², lcm(2, 3) = 6
    monkeypatch.undo()
    trainer._fit_batch(DataSet(X, Y))
    assert net.last_batch_size == 19
    assert abs(net.score_ - plain.score_) <= PARITY
    np.testing.assert_allclose(_params(net), _params(plain), atol=PARITY)
