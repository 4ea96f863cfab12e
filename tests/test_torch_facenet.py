"""Port parity: ``deeplearning4j_tpu_torch.models.InceptionResNetV1`` (a
ComputationGraph with MergeVertex, ScaleVertex, a DropoutLayer and two
network outputs) against the JAX package's, on the CPU.

The configuration (topological order, JSON) is compared exactly at the
published defaults (3x160x160, blocks (5, 10, 5), embedding 128, 1001
classes). Inference and a training step run the JAX network's weights at
blocks (1, 1, 1), 3x96x96, 7 classes, embedding 32 (as the JAX package's
``test_zoo.py`` builds it), batch 2, float32; the JAX network is built once
for the module (its init takes ~22 s on a CPU). Both heads: the softmax
``"output"`` and the unit-norm ``"embeddings"`` vertex, within 1e-5
absolute.

The step runs with the DropoutLayer off in both packages (their masks come
from different generators). Its tolerances come from ``python3
tests/torch_float64_step.py --jax`` (this network, its JAX weights, batch
and seed, on the CPU): against a float64 step of the port (BN in float64
too), JAX's float32 step and the port's lie: score 3.9e-5 and 2.5e-5
relative; the update of all parameters as one vector 6.4% and 3.0% of its
norm; the worst tensor's (a BN scale or shift: BN over few values per
channel amplifies float32 rounding in the gradients that pass through it)
29.8% and 27.2%, while the median tensor's is 5.7e-5 and 4.0e-5. By the
triangle inequality the port is held to JAX within the sum, rounded up:
score 1e-4, all parameters 0.1, each tensor 0.6.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import InceptionResNetV1 as JInception
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.models import InceptionResNetV1
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from torch_mln_helpers import close, port_graph
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

SMALL = dict(num_classes=7, input_shape=(3, 96, 96), blocks=(1, 1, 1), embedding_size=32)
BATCH = 2
SCORE_REL = 1e-4
UPDATE_REL_ALL = 0.1
UPDATE_REL_TENSOR = 0.6


@pytest.fixture(scope="module")
def nets():
    """The JAX network at the small size, dropout off, and its port."""
    conf = JInception(**SMALL).conf()
    conf.nodes["drop"].layer.dropout = 0.0
    jnet = JGraph(conf)
    jnet.init()
    return jnet, port_graph(jnet)


def _batch():
    rs = np.random.RandomState(0)
    x = rs.rand(BATCH, *SMALL["input_shape"]).astype(np.float32)
    return x, np.eye(SMALL["num_classes"], dtype=np.float32)[rs.randint(0, 7, BATCH)]


def test_configuration_matches_jax():
    for kw in ({}, SMALL):
        tconf, jconf = InceptionResNetV1(**kw).conf(), JInception(**kw).conf()
        assert tconf.topo_order() == jconf.topo_order()
        assert tconf.to_json() == jconf.to_json()
        assert tconf.network_outputs == ["output", "embeddings"]
    assert len(tconf.topo_order()) == 86
    back = ComputationGraphConfiguration.from_json(InceptionResNetV1().conf().to_json())
    assert len(back.topo_order()) == 323
    assert back.nodes["drop"].layer.dropout == 0.2


def test_both_heads_match_jax_in_inference(nets):
    jnet, tnet = nets
    x, _ = _batch()
    assert tnet.num_params() == jnet.num_params()
    want = [o.numpy() for o in jnet.output(x)]
    got = tnet.output(x)
    assert [tuple(g.shape) for g in got] == [(BATCH, 7), (BATCH, 32)]
    for g, w in zip(got, want):
        close(g, w)
    np.testing.assert_allclose(got[1].norm(dim=1).numpy(), 1.0, atol=1e-6)


def test_one_step_matches_jax(nets):
    """The loss comes from the "output" head only: "embeddings" is a vertex
    and gets no label."""
    jnet, tnet = nets
    x, y = _batch()
    before = jax.tree.map(np.asarray, jnet.params_)
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert abs(tnet.score_ - float(jnet.score_)) / float(jnet.score_) <= SCORE_REL
    after = jax.tree.map(np.asarray, jnet.params_)
    num = den = 0.0
    for name, k, p in tnet._param_entries():
        want = after[name][k].astype(np.float64) - before[name][k]
        got = p.detach().numpy().astype(np.float64) - before[name][k]
        num += np.sum((got - want) ** 2)
        den += np.sum(want ** 2)
        e = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert e <= UPDATE_REL_TENSOR, f"update of {name}.{k} off by {e:.3f}"
    assert np.sqrt(num / den) <= UPDATE_REL_ALL
    # with its DropoutLayer on (retain 0.2), the port's step draws the
    # layer's mask from the step key and stays finite
    net = ComputationGraph(InceptionResNetV1(**SMALL).conf(), device="cpu").init()
    net.fit(DataSet(x, y))
    assert np.isfinite(net.score_)
