"""One on-disk format for the new layers and the image zoo: port
``serde.model_serializer`` against the JAX package's, on the CPU.

A zip written by either package restores into the other with the
parameters, updater state and BN statistics equal bit for bit, for a text
network (EmbeddingSequenceLayer → Bidirectional(SimpleRnn) → per-step
softmax: the wrapped layer's nested ``{"fwd", "bwd"}`` tree is the zip's
``1/fwd/W`` path in both) and an image network (SeparableConvolution2D,
DepthwiseConvolution2D, BatchNormalization, Deconvolution2D). A zoo model
(Xception, small) written by the JAX package restores through the port's
``ZooModel.init_pretrained`` from the local zip checked against its
sha256, and gives the JAX network's output.
"""

import hashlib

import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import Xception as JXception
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serde import ModelSerializer as JMS
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.models import Xception
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serde import ModelSerializer
from torch_ckpt_helpers import assert_same_state
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

XCEPTION = dict(num_classes=7, input_shape=(3, 32, 32), middle_blocks=1)


def _conf(kind, C, U):
    b = C.NeuralNetConfiguration.Builder().seed(9).updater(U.Adam(1e-2)).list()
    if kind == "text":
        return (b.layer(C.EmbeddingSequenceLayer(n_in=11, n_out=6))
                .layer(C.Bidirectional(fwd=C.SimpleRnn(n_out=5), mode="concat"))
                .layer(C.RnnOutputLayer(n_out=4, activation="softmax", loss="mcxent"))
                .set_input_type(C.InputType.recurrent(1, 8)).build())
    return (b.layer(C.SeparableConvolution2D(n_out=6, kernel_size=(3, 3), stride=(2, 2),
                                             convolution_mode="same", activation="relu"))
            .layer(C.DepthwiseConvolution2D(depth_multiplier=2, kernel_size=(3, 3),
                                            convolution_mode="same"))
            .layer(C.BatchNormalization())
            .layer(C.Deconvolution2D(n_out=3, kernel_size=(2, 2), stride=(2, 2),
                                     convolution_mode="same", activation="tanh"))
            .layer(C.OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(C.InputType.convolutional(8, 8, 2)).build())


def _batch(kind, i):
    rs = np.random.RandomState(i)
    if kind == "text":
        x = rs.randint(0, 11, (3, 8)).astype(np.float32)
        return x, np.eye(4, dtype=np.float32)[rs.randint(0, 4, (3, 8))].transpose(0, 2, 1)
    return rs.randn(3, 2, 8, 8).astype(np.float32), np.eye(4, dtype=np.float32)[[0, 3, 1]]


@pytest.mark.parametrize("kind", ["text", "image"])
def test_jax_zip_restores_into_the_port(kind, tmp_path):
    jnet = JNet(_conf(kind, JC, JU)).init()
    for i in range(2):
        jnet.fit(JDataSet(*_batch(kind, i)))
    path = str(tmp_path / "m.zip")
    JMS.write_model(jnet, path)
    tnet = ModelSerializer.restore(path, device="cpu")
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert_same_state(tnet, jnet)
    assert (tnet.iteration, tnet.score_) == (2, float(jnet.score_))


@pytest.mark.parametrize("kind", ["text", "image"])
def test_port_zip_restores_into_jax(kind, tmp_path):
    tnet = MultiLayerNetwork(_conf(kind, TC, TU), device="cpu").init()
    for i in range(2):
        tnet.fit(DataSet(*_batch(kind, i)))
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(tnet, path)
    jnet = JMS.restore(path)
    assert_same_state(tnet, jnet)
    assert (jnet.iteration, jnet.score_) == (2, tnet.score_)
    x, _ = _batch(kind, 5)
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x).numpy()),
                               rtol=0, atol=1e-5)


def test_zoo_model_restores_through_init_pretrained(tmp_path):
    """The JAX package's Xception (a graph of SeparableConvolution2D and BN
    nodes) as a local zip: ``init_pretrained`` checks its sha256, restores
    it bit for bit and gives the JAX network's output; a wrong checksum
    raises."""
    jnet = JXception(**XCEPTION).init()
    path = tmp_path / "xception.zip"
    JMS.write_model(jnet, str(path))
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    tnet = Xception(**XCEPTION).init_pretrained(str(path), checksum=digest, device="cpu")
    assert_same_state(tnet, jnet)
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    np.testing.assert_allclose(tnet.output(x)[0].numpy(), np.asarray(jnet.output(x)[0].numpy()),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="checksum mismatch"):
        Xception(**XCEPTION).init_pretrained(str(path), checksum="0" * 64, device="cpu")
