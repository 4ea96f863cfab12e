"""Variational autoencoder (counterpart of ``deeplearning4j_tpu/models/vae.py``).

Reference: ``org.deeplearning4j.nn.layers.variational.VariationalAutoencoder``
— encoder → (mean, log-variance) → reparameterized sample → decoder, trained
unsupervised on the ELBO; ``reconstructionProbability`` estimates p(x) by
importance sampling; Bernoulli or Gaussian reconstruction distributions.

The JAX package jits one train step and vmaps the estimator's samples; the
port runs the same eager products and batches the samples on a leading
axis. The noise comes from a ``torch.Generator`` on the model's device (not
JAX's numbers); ``_elbo``, ``_fit_batch`` and ``_estimate`` take the noise
``eps`` explicitly, so that a test hands both packages the same draws.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..common.device import resolve_device
from ..nn.updaters import Adam

_LOG_2PI = math.log(2 * math.pi)


def _mlp_init(generator: torch.Generator, sizes: Sequence[int], device, dtype=torch.float32):
    """He-normal weights [a, b] and zero biases, drawn on the CPU."""
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=generator) * np.sqrt(2.0 / a)
        params.append({"W": w.to(device=device, dtype=dtype),
                       "b": torch.zeros(b, device=device, dtype=dtype)})
    return params


def _clip(x, lo: float, hi: float):
    """``jnp.clip``: max then min, so that a value on a bound passes half its
    gradient, as JAX's (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _mlp(params, x, act=torch.relu, last_act=None):
    for i, layer in enumerate(params):
        x = x @ layer["W"] + layer["b"]
        if i < len(params) - 1:
            x = act(x)
        elif last_act is not None:
            x = last_act(x)
    return x


def _flat(params) -> Dict[str, torch.Tensor]:
    """{"enc.0.W": tensor, ...}: the updater's view of the two lists."""
    return {f"{part}.{i}.{k}": t for part in ("enc", "dec")
            for i, layer in enumerate(params[part]) for k, t in layer.items()}


class VariationalAutoencoder:
    """VariationalAutoencoder capability surface as a standalone model."""

    def __init__(self, n_in: int, latent: int = 8,
                 encoder_layers: Sequence[int] = (64,),
                 decoder_layers: Sequence[int] = (64,),
                 reconstruction: str = "bernoulli",  # bernoulli | gaussian
                 learning_rate: float = 1e-3, seed: int = 42, *, device="cuda"):
        if reconstruction not in ("bernoulli", "gaussian"):
            raise ValueError(reconstruction)
        self.device = resolve_device(device)
        self.n_in = n_in
        self.latent = latent
        self.reconstruction = reconstruction
        self.seed = seed
        gen = torch.Generator().manual_seed(seed)
        enc_sizes = [n_in, *encoder_layers, 2 * latent]          # mu ++ logvar
        out_mult = 2 if reconstruction == "gaussian" else 1
        dec_sizes = [latent, *decoder_layers, out_mult * n_in]
        self.params = {"enc": _mlp_init(gen, enc_sizes, self.device),
                       "dec": _mlp_init(gen, dec_sizes, self.device)}
        self.updater = Adam(learning_rate)
        self.opt_state = self.updater.init(_flat(self.params))
        self.iteration = 0
        self.loss_curve: List[float] = []
        self._noise = torch.Generator(device=self.device).manual_seed(seed ^ 0xE1B0)

    # ------------------------------------------------------------ internals

    def _encode(self, params, x):
        h = _mlp(params["enc"], x)
        return h[:, : self.latent], h[:, self.latent:]

    def _decode(self, params, z):
        out = _mlp(params["dec"], z)
        if self.reconstruction == "gaussian":
            return out[..., : self.n_in], out[..., self.n_in:]
        return torch.sigmoid(out), None

    def _recon_loglik(self, x, mean, logvar2):
        if self.reconstruction == "bernoulli":
            p = _clip(mean, 1e-7, 1 - 1e-7)
            return torch.sum(x * torch.log(p) + (1 - x) * torch.log(1 - p), dim=-1)
        return torch.sum(-0.5 * (_LOG_2PI + logvar2 + torch.square(x - mean)
                                 / torch.exp(logvar2)), dim=-1)

    def _draw(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._noise, device=self.device)

    def _elbo(self, params, x, eps=None):
        """Negative ELBO of ``x``; ``eps`` [B, latent] is the noise of the
        reparameterized sample (drawn from the model's generator if None)."""
        mu, logvar = self._encode(params, x)
        if eps is None:
            eps = self._draw(mu.shape)
        z = mu + torch.exp(0.5 * logvar) * eps
        mean, lv2 = self._decode(params, z)
        recon = self._recon_loglik(x, mean, lv2)
        kl = 0.5 * torch.sum(torch.exp(logvar) + torch.square(mu) - 1.0 - logvar, dim=-1)
        return torch.mean(kl - recon)

    def _grads(self, xb, eps=None):
        """(loss, {flat name: grad}) of one batch."""
        flat = _flat(self.params)
        with torch.enable_grad():
            leaves = {n: t.detach().requires_grad_() for n, t in flat.items()}
            tree = {part: [{k: leaves[f"{part}.{i}.{k}"] for k in layer}
                           for i, layer in enumerate(self.params[part])]
                    for part in ("enc", "dec")}
            loss = self._elbo(tree, xb, eps)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    @torch.no_grad()
    def _fit_batch(self, xb, eps=None) -> torch.Tensor:
        """One Adam step on ``xb`` (a tensor on the model's device)."""
        loss, grads = self._grads(xb, eps)
        updates, self.opt_state = self.updater.apply(grads, self.opt_state,
                                                     _flat(self.params), self.iteration, 0)
        for name, p in _flat(self.params).items():
            p.sub_(updates[name])
        self.iteration += 1
        return loss

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # ------------------------------------------------------------ public API

    def fit(self, data, epochs: int = 1, batch_size: int = 128) -> "VariationalAutoencoder":
        """Unsupervised ELBO training (the reference's pretrain phase)."""
        x = np.asarray(data, np.float32)
        if len(x) == 0:
            raise ValueError("empty dataset")
        batch_size = min(batch_size, len(x))
        rs = np.random.RandomState(self.seed)
        loss = float("nan")
        for _ in range(epochs):
            order = rs.permutation(len(x))
            for off in range(0, len(x) - batch_size + 1, batch_size):
                loss = self._fit_batch(self._tensor(x[order[off:off + batch_size]]))
            self.loss_curve.append(float(loss))
        return self

    @torch.no_grad()
    def activate(self, x) -> np.ndarray:
        """Latent means (the layer's feed-forward activation)."""
        mu, _ = self._encode(self.params, self._tensor(x))
        return mu.cpu().numpy()

    @torch.no_grad()
    def reconstruct(self, x) -> np.ndarray:
        mu, _ = self._encode(self.params, self._tensor(x))
        mean, _ = self._decode(self.params, mu)
        return mean.cpu().numpy()

    @torch.no_grad()
    def generate(self, z) -> np.ndarray:
        """Decode latent codes (generateAtMeanGivenZ)."""
        mean, _ = self._decode(self.params, self._tensor(z))
        return mean.cpu().numpy()

    @torch.no_grad()
    def reconstruction_probability(self, x, num_samples: int = 16) -> np.ndarray:
        """log p(x) importance-sampling estimate
        (VariationalAutoencoder.reconstructionLogProbability); the samples'
        noise comes from a generator seeded ``seed ^ 0x1517`` on the model's
        device."""
        xt = self._tensor(x)
        gen = torch.Generator(device=self.device).manual_seed(self.seed ^ 0x1517)
        eps = torch.randn((num_samples, xt.shape[0], self.latent), generator=gen,
                          device=self.device)
        return self._estimate(self.params, xt, eps).cpu().numpy()

    def _estimate(self, params, x, eps):
        """``logsumexp_s log w_s - log S`` with ``eps`` [S, B, latent]:
        ``log w = log p(x|z) + log p(z) - log q(z|x)``."""
        mu, logvar = self._encode(params, x)
        z = mu + torch.exp(0.5 * logvar) * eps                   # [S, B, latent]
        mean, lv2 = self._decode(params, z)
        recon = self._recon_loglik(x, mean, lv2)
        logp_z = torch.sum(-0.5 * (_LOG_2PI + torch.square(z)), -1)
        logq = torch.sum(-0.5 * (_LOG_2PI + logvar + torch.square(eps)), -1)
        logw = recon + logp_z - logq                             # [S, B]
        return torch.logsumexp(logw, dim=0) - math.log(eps.shape[0])

    reconstructionLogProbability = reconstruction_probability
