"""One on-disk format for the new layers: port ``serde.model_serializer`` and
``serde.checkpoint`` against the JAX package's, on the CPU.

The network holds a GravesBidirectionalLSTM (its nested ``{"fwd", "bwd"}``
tree: the zip's and the checkpoint's ``0/fwd/W`` path in both packages), a
TimeDistributed(DenseLayer) and a FrozenLayerWithBackprop(DenseLayer) (the
wrapped layers' parameters under the wrapper's index) and an
OCNNOutputLayer (its 0-d margin ``r``, and the 0-d Adam moments of it). A
zip and a lineage checkpoint written by either package restore into the
other with the parameters, updater state and counters equal bit for bit,
and the restored networks give the same output.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serde import ModelSerializer as JMS
from deeplearning4j_tpu.serde import checkpoint as JCK
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serde import ModelSerializer
from deeplearning4j_tpu_torch.serde import checkpoint as TCK
from torch_ckpt_helpers import assert_same_state
from torch_mln_helpers import layers
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


def _conf(port):
    C, U = (TC, TU) if port else (JC, JU)
    L = layers(port)
    return (C.NeuralNetConfiguration.Builder().seed(11).updater(U.Adam(1e-2)).list()
            .layer(L.GravesBidirectionalLSTM(n_in=3, n_out=4))
            .layer(L.TimeDistributed(underlying=L.DenseLayer(n_out=5, activation="tanh")))
            .layer(L.GlobalPoolingLayer(pooling_type="avg"))
            .layer(L.FrozenLayerWithBackprop(underlying=L.DenseLayer(n_out=6, activation="relu")))
            .layer(L.OCNNOutputLayer(hidden_size=4, nu=0.2))
            .set_input_type(L.InputType.recurrent(3, 5)).build())


def _batch(i):
    rs = np.random.RandomState(i)
    return rs.randn(4, 3, 5).astype(np.float32), np.zeros((4, 1), np.float32)


def _trained(port, steps=2):
    net = (MultiLayerNetwork(_conf(True), device="cpu") if port else JNet(_conf(False))).init()
    for i in range(steps):
        net.fit((DataSet if port else JDataSet)(*_batch(i)))
    return net


def _same_output(tnet, jnet):
    x, _ = _batch(7)
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x).numpy()),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_zip_restores_across_packages(writer, tmp_path):
    path = str(tmp_path / "m.zip")
    if writer == "jax":
        jnet = _trained(False)
        JMS.write_model(jnet, path)
        tnet = ModelSerializer.restore(path, device="cpu")
        assert tnet.conf.to_json() == jnet.conf.to_json()
    else:
        tnet = _trained(True)
        ModelSerializer.write_model(tnet, path)
        jnet = JMS.restore(path)
    assert_same_state(tnet, jnet)
    assert tnet.iteration == jnet.iteration == 2
    assert tnet.params_["4"]["r"].dim() == 0 and tnet.conf.layers[3].frozen
    _same_output(tnet, jnet)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lineage_checkpoint_restores_across_packages(writer, tmp_path):
    if writer == "jax":
        jnet = _trained(False)
        JCK.TrainingCheckpointer(str(tmp_path), async_write=False).save(jnet)
        tnet = MultiLayerNetwork(_conf(True), device="cpu").init()
        assert TCK.TrainingCheckpointer(str(tmp_path)).restore(tnet)
    else:
        tnet = _trained(True)
        TCK.TrainingCheckpointer(str(tmp_path), async_write=False).save(tnet)
        jnet = JNet(_conf(False)).init()
        assert JCK.TrainingCheckpointer(str(tmp_path)).restore(jnet)
        assert JCK.verify_checkpoint(str(tmp_path))["ok"]
    assert_same_state(tnet, jnet)
    assert tnet.iteration == jnet.iteration == 2
    _same_output(tnet, jnet)
