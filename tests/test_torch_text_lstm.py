"""Port parity: the GravesLSTM char-RNN (``models.text_lstm.TextGenerationLSTM``)
and the MultiLayerNetwork's recurrent paths against the JAX package's, on
the CPU.

Truncated BPTT pads the time axis to a multiple of the segment length (labels
mask 0 on the padding), runs one update per segment with the LSTM states
carried across segments, and scores the fit by the segments' unmasked steps.
Inputs are one-hot characters from numpy seeds, float32, weights bridged
from the JAX network. Tolerances: scores 1e-5 relative; outputs 1e-5
absolute; each parameter's update within 1e-4 of the norm of JAX's.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import TextGenerationLSTM as JTextLSTM
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.models import TextGenerationLSTM
from torch_mln_helpers import LOSS_REL, close, params_close, port_net, snapshot
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


def _chars(rs, B, V, T):
    idx = rs.randint(0, V, (B, T))
    x = np.eye(V, dtype=np.float32)[idx].transpose(0, 2, 1)  # [B, V, T]
    y = np.eye(V, dtype=np.float32)[np.roll(idx, -1, 1)].transpose(0, 2, 1)
    return x, y


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _fit_both(jnet, tnet, x, y, **masks):
    before = snapshot(jnet)
    jnet.fit(JDataSet(x, y, **masks))
    tnet.fit(DataSet(x, y, **masks))
    assert _rel(tnet.score_, jnet.score_) <= LOSS_REL, (tnet.score_, jnet.score_)
    params_close(tnet, jnet, before)


def test_tbptt_fit_with_padding_and_labels_mask_matches_jax():
    """vocab 16, hidden 32, 2 GravesLSTM layers, tbptt 10 over T=23: the
    third segment is 3 steps and 7 of padding; a ragged labels mask on top.
    Two fits (the second from the first's Adam state)."""
    jnet = JNet(JTextLSTM(vocab_size=16, hidden=32, tbptt_length=10).conf()).init()
    tnet = port_net(jnet)
    rs = np.random.RandomState(0)
    for _ in range(2):
        x, y = _chars(rs, 4, 16, 23)
        lm = (np.arange(23)[None] < np.array([[23], [17], [9], [21]])).astype(np.float32)
        _fit_both(jnet, tnet, x, y, labels_mask=lm)
    assert tnet.iteration == jnet.iteration == 2


def test_tbptt_per_example_mask_and_features_mask_match_jax():
    """A per-example [B] labels mask broadcasts over time; a features mask
    rides along (the LSTM layers do not read it)."""
    jnet = JNet(JTextLSTM(vocab_size=12, hidden=16, layers=1, tbptt_length=8).conf()).init()
    tnet = port_net(jnet)
    rs = np.random.RandomState(1)
    x, y = _chars(rs, 3, 12, 20)
    _fit_both(jnet, tnet, x, y, labels_mask=np.array([1, 0, 1], np.float32),
              features_mask=np.ones((3, 20), np.float32))


def test_rnn_time_step_matches_output_and_jax():
    """Fed one step at a time (and then a 2-step chunk), ``rnn_time_step``
    equals ``output`` over the whole sequence; the states clear."""
    jnet = JNet(JTextLSTM(vocab_size=16, hidden=32, tbptt_length=10).conf()).init()
    tnet = port_net(jnet)
    x, _ = _chars(np.random.RandomState(2), 3, 16, 12)
    full = tnet.output(x)
    close(full, jnet.output(x).numpy())
    steps = [tnet.rnn_time_step(x[:, :, t]) for t in range(10)] + [tnet.rnn_time_step(x[:, :, 10:])]
    close(torch.cat(steps, dim=2), full.numpy())
    jsteps = [jnet.rnn_time_step(x[:, :, t]).numpy() for t in range(10)]
    close(torch.cat(steps[:10], dim=2), np.concatenate(jsteps, axis=2))
    tnet.rnn_clear_previous_state()
    close(tnet.rnn_time_step(x[:, :, 0]), full[:, :, :1].numpy())


@pytest.mark.parametrize("layer", ["LSTM", "GravesLSTM"])
def test_standard_backprop_lstm_fit_matches_jax(layer):
    """No tBPTT: one update over the whole sequence from zero states, the
    softmax output's mean over the batch of per-sequence sums; then with a
    labels mask."""
    conf = (JC.NeuralNetConfiguration.Builder().seed(5).updater(JU.RmsProp(1e-2)).list()
            .layer(getattr(JC, layer)(n_out=10))
            .layer(JC.RnnOutputLayer(n_out=6, activation="softmax", loss="mcxent"))
            .set_input_type(JC.InputType.recurrent(6)).build())
    jnet = JNet(conf).init()
    tnet = port_net(jnet)
    rs = np.random.RandomState(3)
    x, y = _chars(rs, 4, 6, 9)
    _fit_both(jnet, tnet, x, y)
    _fit_both(jnet, tnet, x, y, labels_mask=(rs.rand(4, 9) > 0.3).astype(np.float32))


def test_char_rnn_at_published_widths_matches_jax():
    """vocab 77, hidden 256, 2 layers, tbptt 50 over T=60 (a 10-step second
    segment, 40 steps of padding), batch 2: one fit."""
    jnet = JNet(JTextLSTM().conf()).init()
    tnet = port_net(jnet)
    assert TextGenerationLSTM().conf().to_json() == jnet.conf.to_json()
    assert tnet.num_params() == jnet.num_params()
    x, y = _chars(np.random.RandomState(4), 2, 77, 60)
    _fit_both(jnet, tnet, x, y)
