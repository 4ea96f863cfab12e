"""The port's variational autoencoder (``deeplearning4j_tpu_torch.models.vae``)
against the JAX package's ``models/vae.py``: the same weights (JAX's
``params`` through ``vae_params_from_jax``), the same inputs, and JAX's own
noise draws handed to the port's ``eps`` arguments.

Tolerance: 1e-5, relative to the largest magnitude of what is compared
(float32 MLPs of a few hundred units; the port sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.vae import VariationalAutoencoder as JVAE
from deeplearning4j_tpu_torch.models.vae import VariationalAutoencoder as TVAE
from deeplearning4j_tpu_torch.models.vae import _flat
from deeplearning4j_tpu_torch.models.weights import vae_params_from_jax
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

REL = 1e-5
KW = dict(n_in=20, latent=4, encoder_layers=(16, 12), decoder_layers=(12,), seed=5)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _pair(reconstruction):
    jv = JVAE(reconstruction=reconstruction, **KW)
    tv = TVAE(reconstruction=reconstruction, device="cpu", **KW)
    vae_params_from_jax(tv, jax.tree.map(np.asarray, jv.params))
    return jv, tv


def _data(n=8, reconstruction="bernoulli", seed=0):
    rs = np.random.RandomState(seed)
    if reconstruction == "bernoulli":
        return (rs.rand(n, KW["n_in"]) > 0.5).astype(np.float32)
    return rs.randn(n, KW["n_in"]).astype(np.float32)


def _jax_tree(tv):
    return {k: v.detach().numpy() for k, v in _flat(tv.params).items()}


def _jax_flat(jv):
    return {f"{part}.{i}.{k}": np.asarray(v) for part in ("enc", "dec")
            for i, layer in enumerate(jv.params[part]) for k, v in layer.items()}


@pytest.mark.parametrize("reconstruction", ["bernoulli", "gaussian"])
def test_elbo_and_its_gradients_with_jax_noise(reconstruction):
    jv, tv = _pair(reconstruction)
    x = _data(reconstruction=reconstruction)
    rng = jax.random.key(7)
    eps = np.asarray(jax.random.normal(rng, (x.shape[0], KW["latent"])))
    jl, jg = jax.jit(jax.value_and_grad(jv._elbo))(jv.params, jnp.asarray(x), rng)
    tl, tg = tv._grads(torch.from_numpy(x), torch.from_numpy(eps))
    assert abs(float(tl) - float(jl)) <= REL * abs(float(jl))
    jflat = {f"{p}.{i}.{k}": np.asarray(v) for p in ("enc", "dec")
             for i, layer in enumerate(jg[p]) for k, v in layer.items()}
    assert set(jflat) == set(tg)
    for name, g in tg.items():
        assert _rel(g.numpy(), jflat[name]) <= REL, name


@pytest.mark.parametrize("reconstruction", ["bernoulli", "gaussian"])
def test_adam_steps_with_jax_noise(reconstruction):
    """Three of the JAX package's jitted steps (their noise drawn as its fit
    draws it) against the port's ``_fit_batch`` given the same noise."""
    jv, tv = _pair(reconstruction)
    x = _data(16, reconstruction, seed=1)
    step = jv._step_fn()
    params, opt = jv.params, jv.opt_state
    for it in range(3):
        rng = jax.random.fold_in(jax.random.key(jv.seed ^ 0xE1B0), it)
        eps = np.asarray(jax.random.normal(rng, (x.shape[0], KW["latent"])))
        params, opt, jl = step(params, opt, jnp.asarray(x), jnp.asarray(it, jnp.int32), rng)
        tl = tv._fit_batch(torch.from_numpy(x), torch.from_numpy(eps))
        assert abs(float(tl) - float(jl)) <= REL * abs(float(jl))
    jv.params = params
    want, got = _jax_flat(jv), _jax_tree(tv)
    for name in want:
        assert _rel(got[name], want[name]) <= REL, name
    assert tv.iteration == 3


@pytest.mark.parametrize("reconstruction", ["bernoulli", "gaussian"])
def test_importance_sampling_estimator_with_jax_noise(reconstruction):
    jv, tv = _pair(reconstruction)
    x = _data(6, reconstruction, seed=2)
    S = 5
    rng = jax.random.key(jv.seed ^ 0x1517)
    eps = np.stack([np.asarray(jax.random.normal(k, (x.shape[0], KW["latent"])))
                    for k in jax.random.split(rng, S)])
    want = np.asarray(jv._estimator(S)(jv.params, jnp.asarray(x), rng))
    got = tv._estimate(tv.params, torch.from_numpy(x), torch.from_numpy(eps)).numpy()
    assert got.shape == want.shape == (x.shape[0],)
    assert _rel(got, want) <= REL
    # the public call draws its own noise: finite log-probabilities, alias kept
    lp = tv.reconstruction_probability(x, num_samples=S)
    assert lp.shape == (x.shape[0],) and np.all(np.isfinite(lp))
    assert TVAE.reconstructionLogProbability is TVAE.reconstruction_probability


@pytest.mark.parametrize("reconstruction", ["bernoulli", "gaussian"])
def test_activate_reconstruct_generate_equal_jax(reconstruction):
    jv, tv = _pair(reconstruction)
    x = _data(5, reconstruction, seed=3)
    z = np.random.RandomState(4).randn(3, KW["latent"]).astype(np.float32)
    for fn, arg in (("activate", x), ("reconstruct", x), ("generate", z)):
        want, got = getattr(jv, fn)(arg), getattr(tv, fn)(arg)
        assert got.shape == want.shape
        assert _rel(got, want) <= REL, fn


def test_fit_trains_and_checks_its_arguments():
    tv = TVAE(device="cpu", **KW)
    x = _data(64, seed=5)
    tv.fit(x, epochs=3, batch_size=16)
    assert len(tv.loss_curve) == 3 and tv.iteration == 12
    assert all(np.isfinite(tv.loss_curve))
    with pytest.raises(ValueError, match="empty"):
        tv.fit(np.zeros((0, KW["n_in"]), np.float32))
    with pytest.raises(ValueError):
        TVAE(reconstruction="poisson", device="cpu", **KW)
    with pytest.raises(RuntimeError, match="cuda"):
        TVAE(**KW)
    with pytest.raises(ValueError, match="layers"):
        vae_params_from_jax(TVAE(device="cpu", **{**KW, "decoder_layers": (12, 12)}),
                            jax.tree.map(np.asarray, JVAE(**KW).params))
