"""Port parity: ``deeplearning4j_tpu_torch.nn.capsules`` against the JAX
package's ``nn/capsules.py`` on the CPU: squash, the margin loss, the three
capsule layers alone, and CapsNet as a MultiLayerNetwork.

Layers: the same numpy-seeded input and weights in both packages; the
output and the gradients of one seeded cotangent with respect to the input
and every parameter. Tolerances, float32: outputs and losses within 1e-5
(absolute; relative for a loss), each gradient within 1e-5 of its norm.
CapsNet (the 12x12 configuration of the JAX package's
``tests/test_capsules.py``): the configuration JSON, ``num_params()``,
``output()`` within 1e-5, and one Adam step from the JAX network's weights
with the score within 1e-6 relative and each parameter's update within
2e-5 of its norm: ``python3 tests/torch_float64_step.py --jax --threads 1
--only capsnet_12`` puts the port's and the JAX package's float32 steps
4.9e-6 and 5.5e-6 (worst tensor) and 1.3e-7 and 6.7e-8 (score) from a
float64 step of the same network and batch; the bound is their sum,
rounded up.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import capsules as JK
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn import capsules as TK
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from torch_float64_step import (CAPSNET_PARAMS, CONVLSTM_PARAMS, bars_batch, capsnet_conf,
                                convlstm_conf, small_capsnet)
from torch_mln_helpers import built_pair, grads_close, layer_parity, params_close, port_net, t
from torch_mln_helpers import snapshot
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

OUT_ATOL = 1e-5     # outputs, absolute
GRAD_REL = 1e-5     # each gradient, of its norm
LOSS_REL = 1e-5     # a loss, relative
FIT_LOSS_REL = 1e-6   # a fit's score, relative (float64-derived, module docstring)
UPDATE_REL = 2e-5     # each parameter's update in a fit, of its norm (likewise)


def test_squash_and_margin_loss_match_jax():
    """squash (eps 1e-8 under the root) along either axis, and the margin
    loss (m+ 0.9, m- 0.1, lambda 0.5), values and gradients."""
    rs = np.random.RandomState(0)
    s = rs.randn(4, 8, 3).astype(np.float32) * 3
    cot = rs.randn(*s.shape).astype(np.float32)
    for dim in (1, -1):
        jv, vjp = jax.vjp(lambda a: JK.squash(a, axis=dim), jnp.asarray(s))
        ts = t(s, True)
        tv = TK.squash(ts, dim=dim)
        (tg,) = torch.autograd.grad(tv, [ts], grad_outputs=t(cot))
        np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=0, atol=OUT_ATOL)
        grads_close({"s": tg}, {"s": np.asarray(vjp(jnp.asarray(cot))[0])}, GRAD_REL)
    y = np.eye(5, dtype=np.float32)[rs.randint(0, 5, 6)]
    lengths = rs.rand(6, 5).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda a: JK.margin_loss(jnp.asarray(y), a))(jnp.asarray(lengths))
    tl = t(lengths, True)
    tv = TK.margin_loss(t(y), tl)
    (tg,) = torch.autograd.grad(tv, [tl])
    np.testing.assert_allclose(float(tv), float(jv), rtol=LOSS_REL)
    grads_close({"l": tg}, {"l": np.asarray(jg)}, GRAD_REL)
    assert np.all(np.linalg.norm(TK.squash(torch.from_numpy(s)).numpy(), axis=-1) < 1.0)


@pytest.mark.parametrize("routings", [1, 3])
def test_capsule_layers_match_jax(routings):
    """PrimaryCapsules orders its channels capsule-major, then dim, before
    the reshape to [B, dim, caps·H'·W']; CapsuleLayer's W is [J, I, D, E],
    its coupling softmax runs over the output capsules and the prediction
    vectors are detached in every round but the last (the gradients pin
    it); CapsuleStrengthLayer's lengths (+1e-12 under the root)."""
    rs = np.random.RandomState(routings)
    layer_parity(*built_pair(lambda L: L.PrimaryCapsules(capsules=3, capsule_dim=4, kernel_size=3,
                                                        stride=2)),
                 JC.InputType.convolutional(7, 8, 2), rs.randn(2, 2, 7, 8).astype(np.float32),
                 rs, out_atol=OUT_ATOL, grad_rel=GRAD_REL)
    layer_parity(*built_pair(lambda L: L.CapsuleLayer(capsules=3, capsule_dim=5,
                                                      routings=routings)),
                 JC.InputType.recurrent(4, 6), rs.randn(2, 4, 6).astype(np.float32) * 0.5, rs,
                 out_atol=OUT_ATOL, grad_rel=GRAD_REL)
    layer_parity(*built_pair(lambda L: L.CapsuleStrengthLayer()), JC.InputType.recurrent(5, 3),
                 rs.randn(2, 5, 3).astype(np.float32), rs, out_atol=OUT_ATOL, grad_rel=GRAD_REL)


def test_capsule_layer_refusals_match_jax():
    """``routings < 1`` and an unknown input capsule count raise with the JAX
    package's messages."""
    for mod in (JK, TK):
        with pytest.raises(ValueError, match="routings must be >= 1, got 0"):
            mod.CapsuleLayer(routings=0)
    with pytest.raises(ValueError) as jerr:
        JK.CapsuleLayer().init_params(jax.random.key(0), JC.InputType.recurrent(8))
    with pytest.raises(ValueError) as terr:
        TK.CapsuleLayer().init_params(torch.Generator(), TC.InputType.recurrent(8))
    assert str(terr.value) == str(jerr.value)


def test_capsnet_mln_matches_jax():
    """The JAX package's 12x12 CapsNet: the configuration JSON, the
    parameter count, ``output()`` and one Adam step from its weights."""
    jnet = JNet(small_capsnet(JC, JU)).init()
    tnet = port_net(jnet)
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert tnet.num_params() == jnet.num_params()
    x, y = bars_batch(4)
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x).numpy()),
                               rtol=0, atol=OUT_ATOL)
    before = snapshot(jnet)
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert abs(tnet.score_ - float(jnet.score_)) <= FIT_LOSS_REL * abs(float(jnet.score_))
    params_close(tnet, jnet, before, rel=UPDATE_REL)


def test_capsnet_learns_synthetic_shapes():
    """The JAX package's learning test in the port: horizontal against
    vertical bars, 40 full-batch Adam steps halve the margin loss and
    classify above 90%."""
    net = MultiLayerNetwork(small_capsnet(TC, TU), device="cpu").init()
    x, y = bars_batch(64, seed=1)
    assert net.output(x[:4]).shape == (4, 2)
    net.fit(DataSet(x, y))
    s0 = net.score_
    for _ in range(39):
        net.fit(DataSet(x, y))
    assert net.score_ < s0 * 0.5
    assert (net.output(x).numpy().argmax(-1) == y.argmax(-1)).mean() > 0.9


def test_published_widths_match_jax():
    """CapsNet at Sabour et al.'s widths and the ConvLSTM frame predictor at
    Shi et al.'s (``chip_smoke.py`` phase 18): the JAX package's JSON, and
    the parameter counts of its ``num_params()`` (6,804,224 and 3,893,264)."""
    for build, count in ((capsnet_conf, CAPSNET_PARAMS), (convlstm_conf, CONVLSTM_PARAMS)):
        tconf = build(TC, TU)
        assert tconf.to_json() == build(JC, JU).to_json()
        assert TC.MultiLayerConfiguration.from_json(tconf.to_json()).to_json() == \
            tconf.to_json()
        assert MultiLayerNetwork(tconf, device="cpu").init().num_params() == count
    assert json.loads(capsnet_conf(TC, TU).to_json())["layers"][2]["@class"] == "CapsuleLayer"
