"""Port parity: the embedding and recurrent layers of
``deeplearning4j_tpu_torch.nn.conf`` that the JAX package's ``nn/conf.py``
holds beside LSTM (EmbeddingLayer, EmbeddingSequenceLayer, SimpleRnn,
Bidirectional) against the JAX package's, on the CPU, alone and inside
MultiLayerNetworks.

Per layer: the same numpy-seeded input and weights go into both packages
(Bidirectional's nested ``{"fwd", "bwd"}`` tree as the port's flat
``"fwd/W"`` keys); the output and the gradients of one seeded cotangent
with respect to every parameter and (for float inputs) the input are
compared. Tolerances, float32: outputs within 1e-5 absolute, each gradient
within 1e-5 of its norm; a fit's score within 1e-5 relative and each
parameter's update within 1e-5 of its norm.

Out-of-range ids: JAX clamps the gather; the port raises (a CUDA gather
would hit a device-side assert), as it does for token ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.dropout import RngKey
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from torch_mln_helpers import flat_tree, layer_parity, pair, port_net, snapshot
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

OUT_ATOL = 1e-5    # outputs, absolute
GRAD_REL = 1e-5    # each gradient, of its norm
LOSS_REL = 1e-5    # a fit's score, relative
UPDATE_REL = 1e-5  # each parameter's update in a fit, of its norm

V, E = 9, 5  # vocabulary, embedding width


def _ids(rs, shape):
    return rs.randint(0, V, shape)


EMBEDDING = {
    "int_index": lambda rs: _ids(rs, (6,)).astype(np.int32),
    "one_hot": lambda rs: np.eye(V, dtype=np.float32)[_ids(rs, 6)],
    "float_index": lambda rs: _ids(rs, (6, 1)).astype(np.float32),
}


@pytest.mark.parametrize("case", list(EMBEDDING))
def test_embedding_layer_matches_jax(case):
    """The three inputs of the JAX dispatch: an integer index (a row
    gather), a one-hot [B, V] float matrix (``x @ W``, with a gradient for
    x) and float indices (cast to ids)."""
    rs = np.random.RandomState(1)
    jl, tl = pair("EmbeddingLayer", n_in=V, n_out=E, has_bias=True, activation="tanh")
    x = EMBEDDING[case](rs)
    layer_parity(jl, tl, JC.InputType.feed_forward(V), x, rs, out_atol=OUT_ATOL,
                 grad_rel=GRAD_REL, x_grad=case == "one_hot")


@pytest.mark.parametrize("shape", [(3, 7), (3, 1, 7)])
def test_embedding_sequence_layer_matches_jax(shape):
    """Ids [B, T] or [B, 1, T] (float, as a DataSet carries them) → [B,
    n_out, T]."""
    rs = np.random.RandomState(2)
    jl, tl = pair("EmbeddingSequenceLayer", n_in=V, n_out=E)
    out = layer_parity(jl, tl, JC.InputType.recurrent(1, 7), _ids(rs, shape).astype(np.float32),
                       rs, out_atol=OUT_ATOL, grad_rel=GRAD_REL, x_grad=False)
    assert tuple(out.shape) == (3, E, 7)


def test_out_of_range_ids_raise():
    """JAX clamps an out-of-range id to the table's edge; the port raises
    for both layers and every input kind, before any gather."""
    it = TC.InputType.feed_forward(V)
    W = {"W": torch.zeros(V, E)}
    for layer, x in ((TC.EmbeddingLayer(n_in=V, n_out=E), torch.tensor([0, V])),
                     (TC.EmbeddingLayer(n_in=V, n_out=E), torch.tensor([[-1.0]])),
                     (TC.EmbeddingSequenceLayer(n_in=V, n_out=E), torch.tensor([[1.0, V]])),
                     (TC.EmbeddingSequenceLayer(n_in=V, n_out=E), torch.tensor([[[-1, 2]]]))):
        with pytest.raises(ValueError, match=rf"\[0, {V}\)"):
            layer.forward(W, x, it, training=False)
    jl = JC.EmbeddingLayer(n_in=V, n_out=E)
    table = jnp.arange(V * E, dtype=jnp.float32).reshape(V, E)
    clamped = jl.forward({"W": table}, jnp.asarray([V + 3]), JC.InputType.feed_forward(V),
                         training=False)
    np.testing.assert_array_equal(np.asarray(clamped), np.asarray(table[V - 1:]))


def test_simple_rnn_matches_jax():
    rs = np.random.RandomState(3)
    jl, tl = pair("SimpleRnn", n_in=4, n_out=6, activation="tanh")
    layer_parity(jl, tl, JC.InputType.recurrent(4, 5), rs.randn(3, 4, 5).astype(np.float32), rs,
                 out_atol=OUT_ATOL, grad_rel=GRAD_REL)


BIDIRECTIONAL = [(mode, inner) for inner in ("SimpleRnn", "LSTM")
                 for mode in ("concat", "add", "mul", "average")]


@pytest.mark.parametrize("mode,inner", BIDIRECTIONAL)
def test_bidirectional_matches_jax(mode, inner):
    """Both directions of the wrapped layer, each with its own parameters
    (the JAX tree ``{"fwd": ..., "bwd": ...}``), the backward one over the
    time-reversed input and reversed back, combined by ``mode``."""
    rs = np.random.RandomState(4)
    jl = JC.Bidirectional(fwd=getattr(JC, inner)(n_in=3, n_out=4), mode=mode)
    tl = TC.Bidirectional(fwd=getattr(TC, inner)(n_in=3, n_out=4), mode=mode)
    out = layer_parity(jl, tl, JC.InputType.recurrent(3, 6), rs.randn(2, 3, 6).astype(np.float32),
                       rs, out_atol=OUT_ATOL, grad_rel=GRAD_REL)
    assert out.shape[1] == (8 if mode == "concat" else 4)


def test_bidirectional_gives_both_directions_one_random_key():
    """As in the JAX package, both directions draw their dropout from the
    layer's one key: each half of the output is the wrapped layer run with
    that key (on the reversed input for the backward half)."""
    rs = np.random.RandomState(5)
    inner = TC.SimpleRnn(n_in=3, n_out=4, dropout=0.5)
    layer = TC.Bidirectional(fwd=inner, mode="concat")
    it = TC.InputType.recurrent(3, 6)
    params = layer.init_params(torch.Generator().manual_seed(0), it)
    x = torch.from_numpy(rs.randn(2, 3, 6).astype(np.float32))
    key = RngKey((11, 3))
    out = layer.forward(params, x, it, training=True, rng=key)
    fwd = inner.forward(layer.direction(params, "fwd"), x, it, training=True, rng=key)
    bwd = inner.forward(layer.direction(params, "bwd"), x.flip(2), it, training=True,
                        rng=key).flip(2)
    assert torch.equal(out, torch.cat([fwd, bwd], dim=1))
    assert not torch.equal(out[:, :4], inner.forward(layer.direction(params, "fwd"), x, it,
                                                     training=False))


def _text_rnn(C, U):
    """Ids → EmbeddingSequence → Bidirectional(SimpleRnn) concat →
    Bidirectional(LSTM) add → per-step softmax."""
    return (C.NeuralNetConfiguration.Builder().seed(3).updater(U.Adam(1e-2)).list()
            .layer(C.EmbeddingSequenceLayer(n_in=V, n_out=6))
            .layer(C.Bidirectional(fwd=C.SimpleRnn(n_out=5), mode="concat"))
            .layer(C.Bidirectional(fwd=C.LSTM(n_out=4), mode="add"))
            .layer(C.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(C.InputType.recurrent(1, 7)).build())


def _embedding_ff(C, U):
    """Index → Embedding → Dense → softmax."""
    return (C.NeuralNetConfiguration.Builder().seed(4).updater(U.Nesterovs(0.1, 0.9)).list()
            .layer(C.EmbeddingLayer(n_in=V, n_out=6, has_bias=True))
            .layer(C.DenseLayer(n_out=5, activation="relu"))
            .layer(C.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(C.InputType.feed_forward(1)).build())


def _batch(name, rs):
    if name == "text_rnn":
        return (_ids(rs, (4, 7)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rs.randint(0, 3, (4, 7))].transpose(0, 2, 1))
    return _ids(rs, (6, 1)).astype(np.float32), np.eye(3, dtype=np.float32)[rs.randint(0, 3, 6)]


@pytest.mark.parametrize("name", ["text_rnn", "embedding_ff"])
def test_networks_fit_like_jax(name):
    """The layers inside MultiLayerNetworks: the configuration JSON,
    ``output()`` and two steps from the JAX network's weights, the nested
    Bidirectional trees bridged to the port's flat keys (parameters and
    Adam state)."""
    build = {"text_rnn": _text_rnn, "embedding_ff": _embedding_ff}[name]
    jnet = JNet(build(JC, JU)).init()
    tnet = port_net(jnet)
    assert tnet.conf.to_json() == jnet.conf.to_json()
    rs = np.random.RandomState(6)
    x, y = _batch(name, rs)
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x).numpy()),
                               rtol=0, atol=OUT_ATOL)
    for _ in range(2):
        before = flat_tree(snapshot(jnet))
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
        assert abs(tnet.score_ - float(jnet.score_)) <= LOSS_REL * abs(float(jnet.score_))
        after = flat_tree(jax.tree.map(np.asarray, jnet.params_))
        entries = {f"{si}/{k}": p for si, k, p in tnet._param_entries()}
        assert sorted(entries) == sorted(after)
        for key, p in entries.items():
            want = after[key] - before[key]
            err = np.linalg.norm(p.detach().numpy() - before[key] - want) / np.linalg.norm(want)
            assert err <= UPDATE_REL, f"{key}: update off by {err:.2e}"


def test_bidirectional_regularisation_and_params_vector():
    """L2 (which the JAX package cannot apply to a nested tree: it squares
    the dict) covers each direction's weights but not its bias, as it skips
    a layer's "b"; ``params()`` lists layers by index and each layer's
    names sorted, the directions' "bwd/..." before "fwd/..."."""
    conf = _text_rnn(TC, TU)
    conf.layers[1].l2 = 0.5
    with_l2 = MultiLayerNetwork(TC.MultiLayerConfiguration.from_json(conf.to_json()),
                                device="cpu").init()
    conf.layers[1].l2 = 0.0
    without = MultiLayerNetwork(TC.MultiLayerConfiguration.from_json(conf.to_json()),
                                device="cpu").init()
    without.set_params(with_l2.params())
    rs = np.random.RandomState(7)
    ds = DataSet(*_batch("text_rnn", rs))
    names = [k for si, k, _ in with_l2._param_entries() if si == "1"]
    assert names == ["bwd/RW", "bwd/W", "bwd/b", "fwd/RW", "fwd/W", "fwd/b"]
    weights = sum(float((p.double() ** 2).sum()) for si, k, p in with_l2._param_entries()
                  if si == "1" and not k.endswith("/b"))
    np.testing.assert_allclose(with_l2.score(ds) - without.score(ds), 0.5 * 0.5 * weights,
                               rtol=1e-5)
