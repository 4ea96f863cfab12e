"""Port parity: ``deeplearning4j_tpu_torch.data.normalizers`` and the
on-device ingest (``make_device_ingest``, ``set_device_ingest``) against the
JAX package's, on the CPU.

Normalizer statistics from a streamed fit within 1e-6 of JAX's; transform
and revert equal JAX's bit for bit (the same numpy arithmetic); the JSON of
``save`` read by either package; ``device_transform`` of a tensor equal to
``transform`` (the image scaler bit for bit: one IEEE division on either
side; the standardizer within 1e-6); a fit whose ingest casts, permutes and
scales uint8 NHWC batches equal to a fit on host-normalized NCHW batches
within 1e-6, and to JAX's ingest fit. ``write_model(normalizer=)`` writes
the normalizer's JSON, where the JAX package's raises (a reference bug the
port does not copy).
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import normalizers as JN
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import graph_conf as JG
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serde.model_serializer import ModelSerializer as JMS
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.data import normalizers as TN
from deeplearning4j_tpu_torch.serde.model_serializer import ModelSerializer
from torch_mln_helpers import port_graph, port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

STAT_ATOL = 1e-6  # normalizer statistics and fits through an ingest


def _batches(seed=0, shape=(6, 3, 5, 5), n=4, scale=10.0):
    rs = np.random.RandomState(seed)
    return [(rs.rand(*shape).astype(np.float32) * scale + i,
             rs.rand(shape[0], 2).astype(np.float32)) for i in range(n)]


def _pair(kind, **kw):
    name = {"standardize": "NormalizerStandardize", "minmax": "NormalizerMinMaxScaler",
            "image": "ImagePreProcessingScaler"}[kind]
    return getattr(JN, name)(**kw), getattr(TN, name)(**kw)


@pytest.mark.parametrize("shape", [(6, 4), (6, 3, 7), (6, 3, 5, 5)], ids=["2d", "3d", "4d"])
def test_streamed_fit_statistics_match_jax(shape):
    batches = _batches(shape=shape)
    jst, tst = _pair("standardize", fit_labels=True)
    jst.fit(JList([JDataSet(x, y) for x, y in batches]))
    tst.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    for attr in ("mean", "std", "label_mean", "label_std"):
        np.testing.assert_allclose(getattr(tst, attr), getattr(jst, attr), rtol=0, atol=STAT_ATOL)
    jmm, tmm = _pair("minmax", min_range=-1.0, max_range=1.0)
    jmm.fit(JList([JDataSet(x, y) for x, y in batches]))
    tmm.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    np.testing.assert_array_equal(tmm.data_min, jmm.data_min)
    np.testing.assert_array_equal(tmm.data_max, jmm.data_max)


@pytest.mark.parametrize("kind", ["standardize", "minmax", "image"])
def test_transform_and_revert_equal_jax(kind):
    (x, y), = _batches(seed=3, n=1, scale=255.0)
    j, t = _pair(kind)
    j.fit(JDataSet(x, y))
    t.fit(DataSet(x, y))
    jd, td = JDataSet(x.copy(), y.copy()), DataSet(x.copy(), y.copy())
    j.transform(jd)
    t.pre_process(td)
    np.testing.assert_array_equal(td.features, jd.features)
    np.testing.assert_array_equal(t.revert_features(td.features), j.revert_features(jd.features))


@pytest.mark.parametrize("kind", ["standardize", "minmax", "image"])
def test_saved_json_is_read_by_both_packages(kind, tmp_path):
    (x, y), = _batches(seed=4, n=1)
    j, t = _pair(kind)
    j.fit(JDataSet(x, y))
    t.fit(DataSet(x, y))
    t.save(str(tmp_path / "t.json"))
    j.save(str(tmp_path / "j.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    back_j = type(j).restore(str(tmp_path / "t.json"))
    back_t = type(t).restore(str(tmp_path / "j.json"))
    assert back_t._state() == back_j._state() == t._state()


@pytest.mark.parametrize("kind", ["standardize", "minmax", "image"])
def test_device_transform_equals_transform(kind):
    """A uint8 batch as a tensor through ``device_transform`` against the
    host ``transform`` of the same batch: the image scaler bit for bit, the
    others within 1e-6 (the same float32 operations in the same order)."""
    rs = np.random.RandomState(5)
    x = rs.randint(0, 256, (4, 3, 6, 6)).astype(np.uint8)
    j, t = _pair(kind)
    t.fit(DataSet(x.astype(np.float32), None))
    ds = DataSet(x.astype(np.float32), None)
    t.transform(ds)
    got = t.device_transform(torch.from_numpy(x))
    assert got.dtype == torch.float32
    if kind == "image":
        np.testing.assert_array_equal(got.numpy(), ds.features)
    else:
        np.testing.assert_allclose(got.numpy(), ds.features, rtol=0, atol=STAT_ATOL)


@pytest.mark.parametrize("kind", ["image", "standardize"])
def test_nhwc_ingest_equals_the_host_transform_of_nchw(kind):
    rs = np.random.RandomState(6)
    u8 = rs.randint(0, 256, (4, 6, 6, 3)).astype(np.uint8)
    nchw = u8.transpose(0, 3, 1, 2).astype(np.float32)
    j, t = _pair(kind)
    t.fit(DataSet(nchw, None))
    j.fit(JDataSet(nchw, None))
    host = DataSet(nchw.copy(), None)
    t.transform(host)
    got = TN.make_device_ingest(t, "NHWC")(torch.from_numpy(u8))
    want = np.asarray(JN.make_device_ingest(j, "NHWC")(u8))
    assert tuple(got.shape) == (4, 3, 6, 6) and got.dtype == torch.float32
    if kind == "image":
        np.testing.assert_array_equal(got.numpy(), host.features)
    np.testing.assert_allclose(got.numpy(), host.features, rtol=0, atol=STAT_ATOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=STAT_ATOL)
    with pytest.raises(ValueError, match="NCHW or NHWC"):
        TN.make_device_ingest(t, "CHWN")


def _cnn_conf(C, U):
    return (C.NeuralNetConfiguration.Builder().seed(1).updater(U.Adam(1e-2)).list()
            .layer(C.ConvolutionLayer(n_out=4, kernel_size=(3, 3), activation="relu"))
            .layer(C.DenseLayer(n_out=8, activation="relu"))
            .layer(C.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(C.InputType.convolutional(6, 6, 3)).build())


def test_ingest_fit_equals_host_normalised_fit_and_jax():
    """Three steps on uint8 NHWC batches through ``set_device_ingest`` (the
    batch staged as uint8; the ingest casts, permutes and scales inside the
    step) against three steps on the host-scaled NCHW float batches, and
    against the JAX package's ingest fit: losses, parameters and
    ``output()`` within 1e-6."""
    rs = np.random.RandomState(7)
    u8 = [rs.randint(0, 256, (5, 6, 6, 3)).astype(np.uint8) for _ in range(3)]
    ys = [np.eye(3, dtype=np.float32)[rs.randint(0, 3, 5)] for _ in range(3)]
    jnet = JNet(_cnn_conf(JC, JU)).init()
    ingested, host = port_net(jnet), port_net(jnet)
    jnet.set_device_ingest(JN.make_device_ingest(JN.ImagePreProcessingScaler(), "NHWC"))
    assert ingested.set_device_ingest(
        TN.make_device_ingest(TN.ImagePreProcessingScaler(), "NHWC")) is ingested
    assert ingested._features_dtype() is None and host._features_dtype() == torch.float32
    with pytest.raises(TypeError, match="ComputationGraph"):
        host.set_device_ingest({"in": lambda x: x})
    scaler = TN.ImagePreProcessingScaler()
    for x, y in zip(u8, ys):
        jnet.fit(JDataSet(x, y))
        ingested.fit(DataSet(x, y))
        hd = DataSet(x.transpose(0, 3, 1, 2).astype(np.float32), y)
        scaler.transform(hd)
        host.fit(hd)
        assert abs(ingested.score_ - host.score_) <= STAT_ATOL
        assert abs(ingested.score_ - float(jnet.score_)) <= STAT_ATOL
    for (_, _, a), (_, _, b) in zip(ingested._param_entries(), host._param_entries()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=STAT_ATOL)
    hx = u8[0].transpose(0, 3, 1, 2).astype(np.float32) / np.float32(255.0)
    np.testing.assert_allclose(ingested.output(u8[0]).numpy(), host.output(hx).numpy(),
                               rtol=0, atol=STAT_ATOL)
    np.testing.assert_allclose(ingested.output(u8[0]).numpy(),
                               np.asarray(jnet.output(u8[0]).numpy()), rtol=0, atol=STAT_ATOL)
    assert abs(ingested.score(DataSet(u8[0], ys[0])) - host.score(DataSet(hx, ys[0]))) <= STAT_ATOL
    ingested.set_device_ingest(None)
    assert ingested._features_dtype() == torch.float32


def test_graph_ingest_dict_scopes_one_input():
    """A dict ingest on a two-input graph scales the image input and leaves
    the dense side input alone, as in the JAX package."""
    g = (JC.NeuralNetConfiguration.Builder().seed(2).updater(JU.Sgd(0.1)).graph_builder()
         .add_inputs("img", "side")
         .set_input_types(JC.InputType.feed_forward(12), JC.InputType.feed_forward(2)))
    g.add_vertex("m", JG.MergeVertex(), "img", "side")
    g.add_layer("out", JC.OutputLayer(n_out=2, activation="softmax", loss="mcxent"), "m")
    g.set_outputs("out")
    jnet = JGraph(g.build()).init()
    tnet = port_graph(jnet)
    jnet.set_device_ingest({"img": JN.make_device_ingest(JN.ImagePreProcessingScaler())})
    tnet.set_device_ingest({"img": TN.make_device_ingest(TN.ImagePreProcessingScaler())})
    rs = np.random.RandomState(8)
    img = rs.randint(0, 256, (4, 12)).astype(np.uint8)
    side = rs.rand(4, 2).astype(np.float32) * 100
    assert tnet._wire_dtype("img") is None and tnet._wire_dtype("side") == torch.float32
    got = tnet.output(img, side)[0].numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.output(img, side)[0].numpy()),
                               rtol=0, atol=STAT_ATOL)


def test_write_model_normalizer_and_the_reference_bug(tmp_path):
    """The port writes ``normalizer.json`` (the normalizer's ``_state()``,
    as ``Normalizer.save`` writes it; JAX's ``restore`` reads it); a restore
    ignores it. The JAX package's ``write_model`` calls
    ``normalizer.to_json()``, which none of its normalizers has, so it
    raises ``AttributeError``: a reference bug the port does not copy."""
    jnet = JNet(_cnn_conf(JC, JU)).init()
    tnet = port_net(jnet)
    (x, y), = _batches(seed=9, n=1)
    tst = TN.NormalizerStandardize().fit(DataSet(x, y))
    jst = JN.NormalizerStandardize().fit(JDataSet(x, y))
    assert not hasattr(jst, "to_json")
    with pytest.raises(AttributeError, match="to_json"):
        JMS.write_model(jnet, str(tmp_path / "j.zip"), normalizer=jst)
    path = str(tmp_path / "t.zip")
    ModelSerializer.write_model(tnet, path, normalizer=tst)
    with zipfile.ZipFile(path) as z:
        state = json.loads(z.read("normalizer.json"))
    (tmp_path / "n.json").write_text(json.dumps(state))
    assert JN.NormalizerStandardize.restore(str(tmp_path / "n.json"))._state() == tst._state()
    back = ModelSerializer.restore(path, device="cpu")
    for (_, _, a), (_, _, b) in zip(back._param_entries(), tnet._param_entries()):
        assert torch.equal(a, b)
