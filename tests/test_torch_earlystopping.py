"""Port early stopping (``nn.earlystopping``), listeners (``listeners``) and
``ZooModel.init_pretrained`` on the CPU.

Early stopping on LeNet (Adam, 2 batches of 8 per epoch, the held-out loss
of 8 more examples as the score, at most 4 epochs, patience 2) gives the JAX
package's best epoch, termination and per-epoch scores (1e-5 relative, the
MLN parity bound) from the same weights. The graph trainer path, the file
saver (ModelSerializer zips, the best model restored onto the saved
network's device) and the iteration conditions run on a BN graph. The
listeners are told of every step; the checkpoint listener's rotating zips
restore in the JAX package too. ``init_pretrained`` loads a local zip only
after its sha256 checks.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.models import LeNet as JLeNet
from deeplearning4j_tpu.nn import earlystopping as JE
from deeplearning4j_tpu.serde import ModelSerializer as JMS
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.listeners import (CheckpointListener,
                                                CollectScoresIterationListener,
                                                EvaluativeListener, PerformanceListener,
                                                ScoreIterationListener, TimeIterationListener)
from deeplearning4j_tpu_torch.models import LeNet
from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
from deeplearning4j_tpu_torch.nn import earlystopping as TE
from deeplearning4j_tpu_torch.serde import ModelSerializer
from torch_ckpt_helpers import assert_same_state, assert_states_equal, batch, port_net
from torch_mln_helpers import port_net as bridged_port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

LOSS_REL = 1e-5


def _lenet_data(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 1, 28, 28).astype(np.float32)
    return x, np.eye(10, dtype=np.float32)[rs.randint(0, 10, n)]


def _config(E, held_out):
    return (E.EarlyStoppingConfiguration.Builder()
            .epoch_termination_conditions(E.MaxEpochsTerminationCondition(4),
                                          E.ScoreImprovementEpochTerminationCondition(2))
            .score_calculator(E.DataSetLossCalculator(held_out))
            .model_saver(E.InMemoryModelSaver())
            .build())


def test_early_stopping_on_lenet_matches_jax():
    x, y = _lenet_data(16, 0)
    hx, hy = _lenet_data(8, 1)
    jnet = JLeNet().init()
    tnet = bridged_port_net(jnet)
    jres = JE.EarlyStoppingTrainer(
        _config(JE, JList([JDataSet(hx, hy)])), jnet,
        JList([JDataSet(x[:8], y[:8]), JDataSet(x[8:], y[8:])])).fit()
    tres = TE.EarlyStoppingTrainer(
        _config(TE, ListDataSetIterator([DataSet(hx, hy)])), tnet,
        ListDataSetIterator([DataSet(x[:8], y[:8]), DataSet(x[8:], y[8:])])).fit()
    assert (tres.termination_reason, tres.termination_details, tres.total_epochs,
            tres.best_model_epoch) == (jres.termination_reason, jres.termination_details,
                                       jres.total_epochs, jres.best_model_epoch)
    assert len(tres.score_vs_epoch) == len(jres.score_vs_epoch) >= 3
    for got, want in zip(tres.score_vs_epoch, jres.score_vs_epoch):
        assert abs(got - want) <= LOSS_REL * abs(want), (tres.score_vs_epoch,
                                                         jres.score_vs_epoch)
    assert abs(tres.best_model_score - jres.best_model_score) <= LOSS_REL * jres.best_model_score
    assert isinstance(tres.get_best_model(), type(tnet)) and tres.best_model is not tnet
    assert tnet.iteration == jnet.iteration == 2 * tres.total_epochs


def test_graph_trainer_with_the_file_saver_and_iteration_conditions(tmp_path):
    net = port_net("bn_graph")
    batches = [batch("bn_graph", i)[1] for i in range(2)]
    conf = (TE.EarlyStoppingConfiguration.Builder()
            .epoch_termination_conditions(TE.MaxEpochsTerminationCondition(1))
            .model_saver(TE.LocalFileModelSaver(str(tmp_path)))
            .save_last_model(True).build())
    res = TE.EarlyStoppingTrainer(conf, net, batches).fit()
    assert (res.termination_details, res.total_epochs, res.best_model_epoch) == \
        ("MaxEpochsTerminationCondition", 1, 0)
    assert sorted(os.listdir(tmp_path)) == ["bestModel.zip", "latestModel.zip"]
    best = res.get_best_model()
    assert best.device == torch.device("cpu") and best.iteration == 2
    assert_states_equal(best, net)

    conf = (TE.EarlyStoppingConfiguration.Builder()
            .epoch_termination_conditions(TE.MaxEpochsTerminationCondition(5))
            .iteration_termination_conditions(TE.MaxScoreIterationTerminationCondition(0.0))
            .build())
    res = TE.EarlyStoppingGraphTrainer(conf, port_net("bn_graph"), batches).fit()
    assert (res.termination_reason, res.termination_details, res.best_model_epoch) == \
        ("IterationTerminationCondition", "MaxScoreIterationTerminationCondition", -1)


def test_listeners_see_every_step_and_checkpoint_zips_restore_in_jax(tmp_path):
    net = port_net("char_rnn")
    data = ListDataSetIterator([batch("char_rnn", i)[1] for i in range(3)])
    reg = MetricsRegistry()
    collect = CollectScoresIterationListener(1)
    perf = PerformanceListener(1, registry=reg)
    ckpt = CheckpointListener(str(tmp_path), save_every_n_iterations=1, save_every_n_epochs=1,
                              keep_last=2)
    evaluative = EvaluativeListener(data)
    net.add_listeners(ScoreIterationListener(1), collect, perf, TimeIterationListener(6, 1),
                      ckpt, evaluative)
    net.fit(data, epochs=2)
    assert [i for i, _ in collect.scores] == list(range(1, 7))
    assert collect.scores[-1][1] == net.score_
    assert perf.last_samples_per_sec > 0 and reg.get("tdl_host_rss_bytes").value > 0
    assert len(evaluative.history) == 2
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_epoch_2.zip", "checkpoint_iter_6.zip"]
    jnet = JMS.restore(ckpt.last_checkpoint())
    assert_same_state(net, jnet)
    assert jnet.epoch == 2


def test_init_pretrained_checks_the_sha256(tmp_path):
    model = LeNet()
    path = str(tmp_path / "lenet.zip")
    ModelSerializer.write_model(model.init(device="cpu"), path)
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    net = model.init_pretrained(path, checksum=digest.upper(), device="cpu")
    assert_states_equal(net, model.init(device="cpu"))
    assert model.pretrained_url() is None and model.pretrained_checksum() is None
    with pytest.raises(ValueError, match="checksum mismatch"):
        model.initPretrained(path, checksum="0" * 64, device="cpu")
    with pytest.raises(ValueError, match="no pretrained weights can be downloaded"):
        model.init_pretrained()
