"""Port parity: the image zoo (``deeplearning4j_tpu_torch.models``: VGG16,
VGG19, AlexNet and Darknet19 as MultiLayerNetworks; SqueezeNet, UNet,
Xception and NASNet as ComputationGraphs) against the JAX package's, on the
CPU.

Per model: the configuration's JSON character for character (and a graph's
topological order) at the published defaults and at the JAX tests' small
sizes (``tests/test_zoo.py``, ``tests/test_zoo_ext.py``); the parameter
count equal to JAX's at the small size and, at the published defaults, to
the JAX network's (from ``jax.eval_shape`` of its init) and the table's;
``output()`` and one fit step from the JAX network's weights
(``mln_params_from_jax`` / ``cg_params_from_jax``) at the small size, batch
2, float32, dropout off in both packages (their masks differ by
construction). Each JAX network is built once for the module; torch runs on
one thread.

Tolerances, from ``python3 tests/torch_float64_step.py --jax --threads 1``
(these networks, their JAX weights, batch and seed; torch on one CPU
thread): each float32 step, JAX's and the port's, lies some distance from a
float64 step of the port (BN moments in float64 too), and by the triangle
inequality the port is held to JAX within the sum of the two, rounded up
(a score both packages reproduce exactly gets one float32 rounding, 1e-7):
the score (relative), each tensor's update and the update of all
parameters as one vector (of their norms), the BN running statistics (of
their norms) and the largest absolute difference of the inference output
(softmax probabilities, UNet's per-pixel sigmoid; for the BN models with
the running statistics set to the batch's own moments, as
``tests/test_torch_resnet.py`` does). The distances (port; JAX), score,
worst tensor, all parameters, BN, output:
- VGG16 0; 9.8e-8, 5.9e-3; 1.7e-5, 1.1e-3; 3.0e-6, -, 1.0e-7; 9.1e-8. One
  pre-activation of the third block lies within float32 rounding of zero
  and its ReLU opens in the port's float32 and closes in float64: 0.6% of
  the gradient of the layers below it.
- VGG19 0; 1.4e-7, 7.9e-4; 3.4e-5, 1.2e-4; 4.5e-6, -, 7.7e-8; 7.7e-8.
- AlexNet 0; 6.1e-8, 2.5e-4; 2.5e-4, 4.1e-5; 4.1e-5, -, 2.4e-8; 1.9e-8.
- Darknet19 1.7e-6; 1.6e-6, 1.3e-2; 1.3e-2, 7.1e-3; 7.1e-3, 1.2e-5;
  4.8e-5, 8.1e-6; 1.0e-5 (BN over 8 values per channel at 2x2).
- SqueezeNet 0; 0, 9.8e-6; 9.8e-6, 2.7e-6; 2.7e-6, -, 9.1e-9; 1.3e-8.
- UNet 0; 8.6e-8, 1.0e-5; 9.9e-6, 5.2e-6; 5.6e-6, -, 5.9e-8; 5.9e-8.
- Xception 1.1e-7; 1.1e-7, 7.5e-5; 1.9e-4, 5.3e-5; 8.1e-5, 3.4e-7; 1.0e-6,
  3.8e-8; 8.1e-8.
- NASNet 0; 2.1e-7, 8.6e-5; 1.4e-4, 2.5e-3; 1.0e-2, 6.1e-6; 3.7e-5, 5.2e-8;
  3.7e-8. Its 17 null updates (below) and the means of its 3 zero-mean BN
  inputs are left out of the worst tensor and the BN statistic there, as
  here: a null update is held in the all-parameters check only, a
  zero-mean input's mean as a share of its variance's norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import models as J
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch import models as T
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, module_key
from torch_float64_step import ZOO_BN, ZOO_SMALL, _batch, gradient_norms, no_dropout
from torch_mln_helpers import port_graph, port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)
from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# A tensor whose gradient is below this share of the largest one's has a
# null update (zero in exact arithmetic: a shift a later BatchNormalization
# removes; ~1e-8 of the largest in float32, a real gradient above 1e-3): it
# counts in the all-parameters check only. NASNet's small graph has 17.
NULL_GRAD_REL = 1e-5
NULL_UPDATES = {"NASNet": 17}

# the JAX package's num_params() at the published defaults
PUBLISHED = {"VGG16": 138_357_544, "VGG19": 143_667_240, "AlexNet": 62_378_344,
             "Darknet19": 21_843_376, "SqueezeNet": 1_722_320, "UNet": 449_777,
             "Xception": 488_296, "NASNet": 3_666_688}

# port against JAX, the sums of the float64 distances rounded up (module
# docstring): score (relative), each tensor's update, all parameters'
# update, BN running statistics, inference output (absolute)
BOUNDS = {
    "VGG16": dict(score=1e-7, tensor=6e-3, all=2e-3, out=2e-7),
    "VGG19": dict(score=2e-7, tensor=9e-4, all=2e-4, out=2e-7),
    "AlexNet": dict(score=7e-8, tensor=6e-4, all=9e-5, out=5e-8),
    "Darknet19": dict(score=4e-6, tensor=3e-2, all=2e-2, bn=6e-5, out=2e-5),
    "SqueezeNet": dict(score=1e-7, tensor=2e-5, all=6e-6, out=3e-8),
    "UNet": dict(score=9e-8, tensor=3e-5, all=2e-5, out=2e-7),
    "Xception": dict(score=3e-7, tensor=3e-4, all=2e-4, bn=2e-6, out=2e-7),
    "NASNet": dict(score=3e-7, tensor=3e-4, all=2e-2, bn=5e-5, out=9e-8),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_states():
    """{model: (configuration, params, BN state, updater state)} of the JAX
    networks at the small sizes, dropout off, built on first use."""
    return {}


def _jax_state(states, name):
    if name not in states:
        conf = no_dropout(getattr(J, name)(**ZOO_SMALL[name]).conf())
        if hasattr(conf, "layers"):
            jnet = JNet(conf).init()
        else:
            jnet = JGraph(conf)
            jnet.init()
        states[name] = (conf, _np(jnet.params_), _np(jnet.bn_state), _np(jnet.updater_state))
    return states[name]


def _jax_net(conf, params, bn, upd):
    net = JNet(conf) if hasattr(conf, "layers") else JGraph(conf)
    net.params_ = jax.tree.map(jnp.asarray, params)
    net.bn_state = jax.tree.map(jnp.asarray, bn)
    net.updater_state = jax.tree.map(jnp.asarray, upd)
    return net


def _port(jnet):
    return port_graph(jnet) if isinstance(jnet, JGraph) else port_net(jnet)


def _first(out):
    out = out[0] if isinstance(out, list) else out
    return np.asarray(out.numpy(), np.float64)


def _data(name):
    kw = ZOO_SMALL[name]
    return _batch(kw["input_shape"], None if name == "UNet" else kw["num_classes"], 2)


@pytest.mark.parametrize("name", list(ZOO_SMALL))
def test_configuration_and_parameter_count_match_jax(name, jax_states):
    for kw in ({}, ZOO_SMALL[name]):
        tconf, jconf = getattr(T, name)(**kw).conf(), getattr(J, name)(**kw).conf()
        assert tconf.to_json() == jconf.to_json()
        if hasattr(jconf, "nodes"):
            assert tconf.topo_order() == jconf.topo_order()
    if name == "NASNet":
        assert len(T.NASNet().conf().topo_order()) == 399
    conf, params, bn, upd = _jax_state(jax_states, name)
    assert _port(_jax_net(conf, params, bn, upd)).num_params() == \
        sum(a.size for a in jax.tree.leaves(params))
    jconf = getattr(J, name)().conf()

    def jax_params():
        net = JNet(jconf) if hasattr(jconf, "layers") else JGraph(jconf)
        return net.init().params_

    shapes = jax.eval_shape(jax_params)
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == PUBLISHED[name]
    assert getattr(T, name)().init(device="cpu").num_params() == PUBLISHED[name]


def _bn_moments(tnet, x):
    """The BN running statistics that equal the batch's own moments (from
    one training-mode forward of the port), as {layer key: {mean, var}}."""
    xt = torch.from_numpy(x)
    if isinstance(tnet, ComputationGraph):
        _, moved = tnet._forward(tnet._params(), tnet._bn(), {"input": xt}, training=True,
                                 rng=None)
    else:
        _, moved, _ = tnet._forward(tnet._params(), tnet._bn(), xt, training=True, rng=None)
    decay = 0.9  # new = decay * old + (1 - decay) * batch; old: mean 0, var 1
    return {n: {"mean": (st["mean"].double() / (1 - decay)).float().numpy(),
                "var": ((st["var"].double() - decay) / (1 - decay)).float().numpy()}
            for n, st in moved.items()}


@pytest.mark.parametrize("name", list(ZOO_SMALL))
def test_output_and_fit_step_match_jax(name, jax_states):
    conf, params, bn, upd = _jax_state(jax_states, name)
    bound = BOUNDS[name]
    x, y = _data(name)
    if name in ZOO_BN:
        bn = _bn_moments(_port(_jax_net(conf, params, bn, upd)), x)
    want = _first(_jax_net(conf, params, bn, upd).output(x))
    got = _first(_port(_jax_net(conf, params, bn, upd)).output(x))
    assert got.shape == want.shape and want.max() < 0.99
    assert np.abs(got - want).max() <= bound["out"]

    conf, params, bn, upd = _jax_state(jax_states, name)
    jnet = _jax_net(conf, params, bn, upd)
    tnet = _port(jnet)
    grads = gradient_norms(tnet, torch.from_numpy(x), torch.from_numpy(y))
    null = {key for key, g in grads.items() if g <= NULL_GRAD_REL * max(grads.values())}
    assert len(null) == NULL_UPDATES.get(name, 0)
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    score_rel = abs(tnet.score_ - float(jnet.score_)) / abs(float(jnet.score_))
    assert score_rel <= bound["score"], f"score {tnet.score_} vs {float(jnet.score_)}"
    after = _np(jnet.params_)
    num = den = 0.0
    for key, k, p in tnet._param_entries():
        want = after[key][k].astype(np.float64) - params[key][k]
        got = p.detach().numpy().astype(np.float64) - params[key][k]
        num += np.sum((got - want) ** 2)
        den += np.sum(want ** 2)
        if (key, k) in null:
            continue
        e = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert e <= bound["tensor"], f"update of {key}.{k} off by {e:.2e}"
    assert np.sqrt(num / den) <= bound["all"], f"all parameters off by {np.sqrt(num / den):.2e}"
    for key, st in _np(jnet.bn_state).items():
        tkey = module_key(key) if isinstance(tnet, ComputationGraph) else key
        for k in ("mean", "var"):
            got = getattr(tnet.bn_state[tkey], k).numpy()
            scale = np.linalg.norm(st[k])
            if k == "mean" and scale <= NULL_GRAD_REL * np.linalg.norm(st["var"]):
                scale = np.linalg.norm(st["var"])  # the mean of a zero-mean input
            e = np.linalg.norm(got - st[k]) / scale
            assert e <= bound["bn"], f"BN {key}.{k} off by {e:.2e}"
