"""Port parity: ``deeplearning4j_tpu_torch.models.ResNet50`` (a
ComputationGraph) against the JAX package's, on the CPU.

The configuration (node names, topological order, JSON) and the parameter
count are compared exactly, at the published widths. Outputs and training
steps run the JAX network's weights (``models.weights.cg_params_from_jax``)
at 3x64x64, 10 classes, batch 2, float32. The JAX network is built once for
the module (its init takes ~16 s on a CPU).

Why 64x64 and not 32x32: at 32x32 the res5 stage is 1x1, so each of its BN
layers normalises two values per channel at batch 2: its output is +-1 (up
to eps) whatever its input, and float32 rounding alone decides the
gradients that pass through it. At 64x64 res5 is 2x2 (eight values per
channel).

Tolerances, from ``python3 tests/torch_float64_step.py --jax`` (this
network, its JAX weights, batch and seed, on the CPU): a random ResNet-50 at
batch 2 amplifies float32 rounding ~1e5-fold in its updates. Against a
float64 step of the port (BN in float64 too), JAX's float32 step and the
port's lie: score 1.31e-4 and 1.33e-5 relative; the update of all
parameters as one vector 7.9% and 4.1% of its norm, the worst tensor's 9.4%
and 6.4%; the worst BN running statistic 4.3e-4 and 1.0e-4. By the triangle
inequality the port is held to JAX within the sum, rounded up: score 2e-4,
all parameters 0.12, each tensor 0.16, BN statistics 1e-3. Each step starts
from JAX's state (parameters, BN statistics and the Nesterov velocity), so
the second step checks the update with a nonzero velocity rather than the
first step's rounding grown by a step of lr 0.1; it is held to the first
step's bounds (they were measured for the first step). Inference outputs
(softmax probabilities, with the BN statistics set to the batch's moments)
lie 1.3e-4 (JAX) and 6.9e-5 (the port) from float64's: within 3e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import ResNet50 as JResNet50
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.models import ResNet50, cg_params_from_jax
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, module_key
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from torch_mln_helpers import close
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

SHAPE, CLASSES, BATCH = (3, 64, 64), 10, 2
SCORE_REL = 2e-4
UPDATE_REL_ALL = 0.12
UPDATE_REL_TENSOR = 0.16
BN_REL = 1e-3
OUT_ATOL = 3e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_state():
    """The JAX ResNet-50's configuration and initial state as numpy trees."""
    jnet = JResNet50(num_classes=CLASSES, input_shape=SHAPE).init()
    return jnet.conf, _np(jnet.params_), _np(jnet.bn_state), _np(jnet.updater_state)


def _jax_net(conf, params, bn, upd):
    net = JGraph(conf)
    net.params_ = jax.tree.map(jnp.asarray, params)
    net.bn_state = jax.tree.map(jnp.asarray, bn)
    net.updater_state = jax.tree.map(jnp.asarray, upd)
    return net


def _port_net(conf, params, bn, upd):
    net = ComputationGraph(ComputationGraphConfiguration.from_json(conf.to_json()),
                           device="cpu").init()
    return cg_params_from_jax(net, params, bn, upd)


def _batch():
    rs = np.random.RandomState(0)
    x = rs.rand(BATCH, *SHAPE).astype(np.float32)
    return x, np.eye(CLASSES, dtype=np.float32)[rs.randint(0, CLASSES, BATCH)]


def test_configuration_matches_jax():
    """Topological order name for name, and the JSON character for
    character, at the published 224x224 and 1000 classes and at the test's
    size."""
    for kw in ({}, {"num_classes": CLASSES, "input_shape": SHAPE}):
        tconf, jconf = ResNet50(**kw).conf(), JResNet50(**kw).conf()
        assert tconf.topo_order() == jconf.topo_order()
        assert len(tconf.topo_order()) == 141
        assert tconf.to_json() == jconf.to_json()
    assert tconf.updater == type(tconf.updater)(0.1, 0.9)  # the zoo's Nesterovs(0.1, 0.9)


def test_parameter_count_at_1000_classes():
    net = ResNet50().init(device="cpu")
    assert net.num_params() == 25_557_032
    assert [n for n, _, _ in net._param_entries()][:3] == ["stem_conv", "stem_bn", "stem_bn"]


def test_output_matches_jax(jax_state):
    """Inference with BN running statistics set to the batch's own moments
    (the initial mean 0 and variance 1 let the activations grow layer by
    layer until the softmax saturates): both packages get the same
    statistics, taken from one training-mode forward of the port."""
    conf, params, bn, upd = jax_state
    x, _ = _batch()
    tnet = _port_net(conf, params, bn, upd)
    _, moved = tnet._forward(tnet._params(), tnet._bn(), {"input": torch.from_numpy(x)},
                             training=True, rng=None)
    decay = 0.9  # BatchNormalization's default: new = decay * old + (1 - decay) * batch
    bn = {k: {s: ((moved[k][s].double().numpy() - decay * v[s]) / (1 - decay)).astype(np.float32)
              for s in ("mean", "var")} for k, v in bn.items()}
    want = _jax_net(conf, params, bn, upd).output(x)[0].numpy()
    got = _port_net(conf, params, bn, upd).output(x)
    assert len(got) == 1 and got[0].shape == (BATCH, CLASSES)
    assert want.max() < 0.99  # not saturated
    close(got[0], want, atol=OUT_ATOL)


def test_two_nesterovs_steps_match_jax(jax_state):
    conf, params, bn, upd = jax_state
    x, y = _batch()
    jnet = _jax_net(conf, params, bn, upd)
    for step in range(2):
        tnet = _port_net(conf, _np(jnet.params_), _np(jnet.bn_state), _np(jnet.updater_state))
        tnet.iteration = jnet.iteration
        before = _np(jnet.params_)
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
        score_rel = abs(tnet.score_ - float(jnet.score_)) / abs(float(jnet.score_))
        assert score_rel <= SCORE_REL, f"step {step}: score {tnet.score_} vs {jnet.score_}"
        after = _np(jnet.params_)
        num = den = 0.0
        for name, k, p in tnet._param_entries():
            want = after[name][k].astype(np.float64) - before[name][k]
            got = p.detach().numpy().astype(np.float64) - before[name][k]
            num += np.sum((got - want) ** 2)
            den += np.sum(want ** 2)
            e = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert e <= UPDATE_REL_TENSOR, f"step {step}: update of {name}.{k} off by {e:.3f}"
        assert np.sqrt(num / den) <= UPDATE_REL_ALL, f"step {step}: {np.sqrt(num / den):.3f}"
        for name, st in _np(jnet.bn_state).items():
            for k in ("mean", "var"):
                got = getattr(tnet.bn_state[module_key(name)], k).numpy()
                e = np.linalg.norm(got - st[k]) / np.linalg.norm(st[k])
                assert e <= BN_REL, f"step {step}: BN {name}.{k} off by {e:.2e}"
    assert jnet.iteration == 2
