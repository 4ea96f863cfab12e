"""Port parity: the port's weight init, dropout schemes, random keys and
constraints against the JAX package's, on the CPU (activations and losses:
``test_torch_activations.py``, ``test_torch_losses.py``).

Tolerances, float32:
- weight init (the draws differ by construction): each scheme's sample mean
  within 4 standard errors of JAX's, its variance within 3%;
- dropout schemes (masks differ by construction): their mean and variance
  within 4 standard errors of the scheme's own, over 400k draws;
- constraints: 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import constraints as JK
from deeplearning4j_tpu.nn import weights as JW
from deeplearning4j_tpu_torch.nn import constraints as TK
from deeplearning4j_tpu_torch.nn import dropout as TD
from deeplearning4j_tpu_torch.nn import weights as TW
from torch_mln_helpers import close, t
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


SCHEMES = ["xavier", "xavier_uniform", "xavier_fan_in", "relu", "relu_uniform", "lecun_normal",
           "lecun_uniform", "uniform", "normal", "sigmoid_uniform", "var_scaling_normal_fan_in",
           "var_scaling_normal_fan_out", "var_scaling_normal_fan_avg"]


def test_weight_init_statistics_match_jax():
    shape, fan_in, fan_out = (300, 400), 300.0, 400.0
    n = shape[0] * shape[1]
    g = torch.Generator().manual_seed(0)
    for scheme in SCHEMES:
        j = np.asarray(JW.init_weights(jax.random.key(1), shape, fan_in, fan_out, scheme),
                       np.float64)
        p = TW.init_weights(g, shape, fan_in, fan_out, scheme).numpy().astype(np.float64)
        assert p.shape == shape and p.dtype == np.float64
        se = np.sqrt(j.var() / n)
        assert abs(p.mean() - j.mean()) <= 4 * se * np.sqrt(2), scheme
        assert abs(p.var() / j.var() - 1.0) <= 0.03, scheme
    for scheme, want in (("zero", 0.0), ("ones", 1.0)):
        assert np.all(TW.init_weights(g, (3, 4), 3, 4, scheme).numpy() == want)
    np.testing.assert_array_equal(TW.init_weights(g, (3, 3), 3, 3, "identity").numpy(),
                                  np.eye(3))
    with pytest.raises(ValueError, match="unknown weight init"):
        TW.init_weights(g, (3, 3), 3, 3, "bogus")


DROPOUTS = {
    "float": lambda: 0.7,
    "Dropout": lambda: TD.Dropout(0.6),
    "SpatialDropout": lambda: TD.SpatialDropout(0.8),
    "GaussianDropout": lambda: TD.GaussianDropout(0.3),
    "GaussianNoise": lambda: TD.GaussianNoise(0.2),
    "AlphaDropout": lambda: TD.AlphaDropout(0.9),
}


@pytest.mark.parametrize("kind", list(DROPOUTS))
def test_dropout_statistics(kind):
    """Each scheme on x = 1 + N(0, 0.5²) over [40, 100, 100] (AlphaDropout on
    N(0, 1), the SELU fixed point): the output's mean and variance are the
    scheme's, a seeded generator repeats its draw, and inference is the
    identity."""
    scheme = DROPOUTS[kind]()
    rs = np.random.RandomState(3)
    alpha = kind == "AlphaDropout"
    x_np = (rs.randn(40, 100, 100) * (1.0 if alpha else 0.5) + (0.0 if alpha else 1.0))
    x = torch.tensor(x_np, dtype=torch.float32)
    y = TD.apply_dropout(scheme, x, torch.Generator().manual_seed(5), True).double().numpy()
    assert torch.equal(TD.apply_dropout(scheme, x, torch.Generator().manual_seed(5), True),
                       TD.apply_dropout(scheme, x, torch.Generator().manual_seed(5), True))
    assert torch.equal(TD.apply_dropout(scheme, x, torch.Generator().manual_seed(5), False), x)
    n = y.size
    xm, xv = x_np.mean(), x_np.var()
    if kind in ("float", "Dropout", "SpatialDropout"):
        p = scheme if kind == "float" else scheme.p
        want_mean, want_var = xm, (xv + xm ** 2) / p - xm ** 2
        if kind == "SpatialDropout":  # one draw per [B, C]: 4000 independent masks
            n = x.shape[0] * x.shape[1]
            kept = (y != 0).all(axis=-1) | (y == 0).all(axis=-1)
            assert kept.all(), "spatial dropout must drop whole channels"
    elif kind == "GaussianDropout":
        s2 = scheme.rate / (1 - scheme.rate)
        want_mean, want_var = xm, (xv + xm ** 2) * (1 + s2) - xm ** 2
    elif kind == "GaussianNoise":
        want_mean, want_var = xm, xv + scheme.stddev ** 2
    else:  # AlphaDropout keeps a standard normal's mean 0 and variance 1
        want_mean, want_var = 0.0, 1.0
    assert abs(y.mean() - want_mean) <= 4 * np.sqrt(want_var / n), (y.mean(), want_mean)
    assert abs(y.var() / want_var - 1.0) <= 4 * np.sqrt(2.0 / n) + 0.01, (y.var(), want_var)


def test_rng_key_derivation():
    """The port's stand-in for JAX keys: the same path gives the same
    generator stream, another fold gives another."""
    k = TD.RngKey((123 ^ 0x5EED, 4))
    a = torch.rand(8, generator=k.fold_in(2).generator("cpu"))
    assert torch.equal(a, torch.rand(8, generator=TD.RngKey(k.path + (2,)).generator("cpu")))
    assert not torch.equal(a, torch.rand(8, generator=k.fold_in(3).generator("cpu")))


def test_constraints_and_weight_noise_match_jax():
    rs = np.random.RandomState(9)
    w = (rs.randn(6, 4) * 2).astype(np.float32)
    for name, kw in (("MaxNormConstraint", dict(max_norm=1.5)),
                     ("MinMaxNormConstraint", dict(min_norm=0.5, max_norm=1.5, rate=0.7)),
                     ("UnitNormConstraint", {}), ("NonNegativeConstraint", {})):
        got = getattr(TK, name)(**kw).apply(t(w))
        close(got, getattr(JK, name)(**kw).apply(jnp.asarray(w)), atol=1e-6, what=name)
    layer = {"W": t(w), "b": t(w[0])}
    out = TK.apply_constraints(layer, [TK.MaxNormConstraint(1.0)])
    assert out["b"] is layer["b"]
    noisy = TK.WeightNoise(0.1).apply(layer, TD.RngKey((1,)), True)
    assert noisy["b"] is layer["b"] and not torch.equal(noisy["W"], layer["W"])
    dc = TK.DropConnect(0.5).apply(layer, TD.RngKey((1,)), True)
    vals = dc["W"].numpy()
    assert set(np.unique(vals == 0)) <= {True, False}
    np.testing.assert_allclose(vals[vals != 0], (w * 2)[vals != 0], rtol=1e-6)
    assert TK.WeightNoise(0.1).apply(layer, TD.RngKey((1,)), False) is layer
