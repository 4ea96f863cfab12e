"""The port's transfer learning (``deeplearning4j_tpu_torch.nn.transfer``)
against the JAX package's, on the CPU.

A small CNN with BatchNormalization (conv 4x3x3 -> BN -> max pool -> dense
16 -> dense 12 -> softmax 3 on 8x8x1) goes through the same
``TransferLearning.Builder`` chains in both packages:

- every chain gives the JAX package's configuration JSON;
- a retained layer takes the source's weights (BN statistics included), a
  replaced layer, the layer after it and an appended layer do not;
- fine-tuning from carried weights (the JAX package's built network loaded
  into the port's: ``nOutReplace`` re-initialises with each package's own
  generator) agrees within 1e-5 absolute (parameters and losses, float32)
  over 3 steps, frozen layers and the source network stay bit for bit;
- ``TransferLearningHelper``'s features agree within 1e-5, its head has the
  JAX package's configuration and parameters, and a head step agrees.
"""

import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import transfer as JT
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.weights import mln_params_from_jax
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import transfer as TT
from deeplearning4j_tpu_torch.nn import updaters as TU
from torch_mln_helpers import port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

ATOL = 1e-5  # float32 fine-tune steps and features, absolute
STEPS = 3


def _jax_source():
    conf = (JNNC.Builder().seed(3).updater(JU.Adam(1e-2)).list()
            .layer(JC.ConvolutionLayer(n_out=4, kernel_size=(3, 3), stride=(1, 1),
                                       activation="relu"))
            .layer(JC.BatchNormalization())
            .layer(JC.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(JC.DenseLayer(n_out=16, activation="relu"))
            .layer(JC.DenseLayer(n_out=12, activation="tanh"))
            .layer(JC.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JC.InputType.convolutional(8, 8, 1)).build())
    net = JMLN(conf).init()
    # a trained source: BN statistics and weights away from their init
    for i in range(2):
        net.fit(JDataSet(*_batch(100 + i, 3)))
    return net


def _batch(seed, classes, n=16):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 1, 8, 8).astype(np.float32),
            np.eye(classes, dtype=np.float32)[rs.randint(0, classes, n)])


CHAINS = {
    "feature_extractor": (lambda C, U, b: b.fine_tune_configuration(
        TTFC(U, updater=U.Adam(1e-3), seed=9)).set_feature_extractor(2), 3),
    "n_out_replace_output": (lambda C, U, b: b.n_out_replace(5, 5), 5),
    "n_out_replace_hidden": (lambda C, U, b: b.set_feature_extractor(1).n_out_replace(3, 20), 3),
    "remove_output_add": (lambda C, U, b: b.remove_output_layer().add_layer(
        C.OutputLayer(n_out=4, activation="softmax", loss="mcxent")), 4),
    "remove_two_add_two": (lambda C, U, b: b.remove_layers_from_output(2)
                           .add_layer(C.DenseLayer(n_out=8, activation="tanh"))
                           .add_layer(C.OutputLayer(n_out=3, activation="softmax",
                                                    loss="mcxent")), 3),
    "ftc_regularised": (lambda C, U, b: b.fine_tune_configuration(
        TTFC(U, updater=U.Sgd(0.1), l1=1e-4, l2=1e-3)).set_feature_extractor(1), 3),
}


def TTFC(U, **kw):
    """A FineTuneConfiguration of the package that ``U`` (its updaters)
    belongs to, through its builder."""
    mod = JT if U is JU else TT
    b = mod.FineTuneConfiguration.Builder()
    for k, v in kw.items():
        getattr(b, k)(v)
    return b.build()


def _transfer(name, jsrc, tsrc):
    chain, classes = CHAINS[name]
    jnet = chain(JC, JU, JT.TransferLearning.Builder(jsrc)).build()
    tnet = chain(TC, TU, TT.TransferLearning.Builder(tsrc)).build()
    return jnet, tnet, classes


def _params(net):
    if isinstance(net, JMLN):
        return {f"{si}.{k}": np.asarray(v) for si, pd in jax.tree.map(np.asarray,
                                                                     net.params_).items()
                for k, v in pd.items()}
    return {f"{si}.{k}": p.detach().numpy().copy() for si, k, p in net._param_entries()}


@pytest.fixture(scope="module")
def sources():
    jsrc = _jax_source()
    return jsrc, port_net(jsrc)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_builder_gives_jax_conf_json(sources, name):
    jsrc, tsrc = sources
    jnet, tnet, _ = _transfer(name, jsrc, tsrc)
    assert json.loads(tnet.conf.to_json()) == json.loads(jnet.conf.to_json())
    assert [l.frozen for l in tnet.conf.layers] == [l.frozen for l in jnet.conf.layers]
    assert tnet.device.type == "cpu"


def test_ftc_dropout_reaches_every_layer_frozen_ones_too(sources):
    jsrc, tsrc = sources

    def chain(U, T, src):
        ftc = T.FineTuneConfiguration.Builder().dropout(0.8).l2(1e-4).build()
        return T.TransferLearning.Builder(src).fine_tune_configuration(ftc) \
            .set_feature_extractor(1).build()

    jnet, tnet = chain(JU, JT, jsrc), chain(TU, TT, tsrc)
    assert json.loads(tnet.conf.to_json()) == json.loads(jnet.conf.to_json())
    assert [(l.dropout, l.l2) for l in tnet.conf.layers] == [(0.8, 1e-4)] * 6


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_retained_layers_take_the_source_weights(sources, name):
    """Which layers the builder copies from the source (and BN statistics),
    as in the JAX package; a copy, never an alias of the source's tensors."""
    jsrc, tsrc = sources
    jnet, tnet, _ = _transfer(name, jsrc, tsrc)
    jsp, jp, tp, tsp = _params(jsrc), _params(jnet), _params(tnet), _params(tsrc)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        copied_in_jax = k in jsp and jsp[k].shape == jp[k].shape and \
            np.array_equal(jp[k], jsp[k])
        assert copied_in_jax == (k in tsp and tsp[k].shape == tp[k].shape
                                 and np.array_equal(tp[k], tsp[k])), k
    for si, st in tnet.bn_state.items():
        want = jax.tree.map(np.asarray, jnet.bn_state[si])
        np.testing.assert_array_equal(st.mean.numpy(), want["mean"])
        np.testing.assert_array_equal(st.var.numpy(), want["var"])
    shared = {id(p) for p in tsrc.parameters()} & {id(p) for p in tnet.parameters()}
    assert not shared
    assert all(p.data_ptr() != q.data_ptr() for p in tsrc.parameters()
               for q in tnet.parameters())


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_fine_tune_from_carried_weights_agrees_with_jax(sources, name):
    jsrc, tsrc = sources
    src_before = _params(tsrc)
    jnet, tnet, classes = _transfer(name, jsrc, tsrc)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    mln_params_from_jax(tnet, to_np(jnet.params_), to_np(jnet.bn_state),
                        to_np(jnet.updater_state))
    built = _params(tnet)
    for i in range(STEPS):
        x, y = _batch(i, classes)
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
        assert abs(tnet.score_ - jnet.score_) <= ATOL, (i, tnet.score_, jnet.score_)
    jp, tp = _params(jnet), _params(tnet)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=ATOL, err_msg=k)
    frozen = {str(i) for i, l in enumerate(tnet.conf.layers) if l.frozen}
    for k, v in tp.items():
        if k.split(".")[0] in frozen:
            np.testing.assert_array_equal(v, built[k], err_msg=f"frozen {k} moved")
    for k, v in _params(tsrc).items():
        np.testing.assert_array_equal(v, src_before[k], err_msg=f"the source's {k} moved")


def test_appended_layers_never_take_removed_layers_weights(sources):
    """An output layer appended where one of the same shape was removed keeps
    its own initialisation (``TransferLearning.Builder``'s ``n_retained``)."""
    jsrc, tsrc = sources
    tnet = (TT.TransferLearning.Builder(tsrc).remove_output_layer()
            .add_layer(TC.OutputLayer(n_out=3, activation="softmax", loss="mcxent")).build())
    assert tnet.params_["5"]["W"].shape == tsrc.params_["5"]["W"].shape
    assert not torch.equal(tnet.params_["5"]["W"], tsrc.params_["5"]["W"])
    assert torch.equal(tnet.params_["4"]["W"], tsrc.params_["4"]["W"])


def test_helper_features_and_head_agree_with_jax(sources):
    jsrc, tsrc = sources
    jnet, tnet, classes = _transfer("feature_extractor", jsrc, tsrc)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    mln_params_from_jax(tnet, to_np(jnet.params_), to_np(jnet.bn_state),
                        to_np(jnet.updater_state))
    jh, th = JT.TransferLearningHelper(jnet, 2), TT.TransferLearningHelper(tnet, 2)
    x, y = _batch(7, classes)
    jf, tf = jh.featurize(JDataSet(x, y)), th.featurize(DataSet(x, y))
    assert isinstance(tf.features, np.ndarray) and tf.features.shape == (16, 4, 3, 3)
    np.testing.assert_allclose(tf.features, np.asarray(jf.features), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tf.labels, y)
    jhead, thead = jh.unfrozen_mln(), th.unfrozen_mln()
    assert json.loads(thead.conf.to_json()) == json.loads(jhead.conf.to_json())
    assert sorted(thead.conf.preprocessors) == sorted(jhead.conf.preprocessors) == [0]
    jp, tp = _params(jhead), _params(thead)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])
    thead.fit(DataSet(tf.features, y))
    jhead.fit(JDataSet(np.asarray(jf.features), y))
    assert abs(thead.score_ - jhead.score_) <= ATOL
    jp, tp = _params(jhead), _params(thead)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=ATOL, err_msg=k)
    # the head's parameters are copies: training it leaves the network alone
    np.testing.assert_array_equal(_params(tnet)["3.W"], np.asarray(jnet.params_["3"]["W"]))
