"""t-SNE embedding, the exact O(N²) method.

Counterpart of ``deeplearning4j_tpu/nlp/tsne.py`` (the name
``BarnesHutTsne`` is kept; the implementation is dense, as there): the
pairwise distances, a bisection for each point's Gaussian precision
vectorized over the points, then gradient descent with momentum, gains and
early exaggeration, a loop of ``n_iter`` steps on the device that reads
nothing back until it ends.

The start ``y0`` is 1e-4 N(0, 1), drawn by a CPU ``torch.Generator`` seeded with
``seed``, so the card and the CPU start from the same point. The JAX
package draws it from its own generator (``jax.random``), which this
package cannot reproduce: the two packages are compared from a shared
``y0``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..common.device import DEFAULT_DEVICE, resolve_device


def _pairwise_sq_dists(x):
    s = torch.square(x).sum(1)
    d = s[:, None] - 2.0 * (x @ x.T) + s[None, :]
    return torch.clamp(d, min=0.0)


def _cond_probs(dists, perplexity: float, tol: float = 1e-5, iters: int = 50):
    """Each point's conditional P_{j|i} at the precision beta whose entropy
    matches log(perplexity): ``iters`` bisection steps, all points at once."""
    N = dists.shape[0]
    dev = dists.device
    log_u = torch.log(torch.tensor(perplexity, dtype=torch.float32))
    eye = torch.eye(N, dtype=torch.bool, device=dev)

    def entropy_and_p(beta):
        p = torch.exp(-dists * beta[:, None])
        p = torch.where(eye, 0.0, p)
        sum_p = torch.clamp(p.sum(1), min=1e-12)
        h = torch.log(sum_p) + beta * (dists * p).sum(1) / sum_p
        return h, p / sum_p[:, None]

    beta = torch.ones(N, dtype=torch.float32, device=dev)
    lo = torch.full((N,), -torch.inf, dtype=torch.float32, device=dev)
    hi = torch.full((N,), torch.inf, dtype=torch.float32, device=dev)
    for _ in range(iters):
        h, _ = entropy_and_p(beta)
        too_high = h > log_u   # entropy too high → beta up
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0,
                           torch.where(torch.isinf(lo), beta / 2.0, (lo + hi) / 2.0))
    _, p = entropy_and_p(beta)
    return p


def _tsne_run(p_sym, y0, *, n_iter: int, learning_rate: float, momentum_final: float,
              exaggeration: float, exaggeration_iters: int):
    """``n_iter`` gradient steps from ``y0``: (y, the KL of each step [n_iter])."""
    N = p_sym.shape[0]
    eye = torch.eye(N, dtype=torch.bool, device=p_sym.device)
    y = y0.clone()
    vel = torch.zeros_like(y0)
    gains = torch.ones_like(y0)
    kls = []
    for i in range(n_iter):
        num = 1.0 / (1.0 + _pairwise_sq_dists(y))
        num = torch.where(eye, 0.0, num)
        q = torch.clamp(num / num.sum(), min=1e-12)
        pp = p_sym * exaggeration if i < exaggeration_iters else p_sym
        pq = (pp - q) * num                                   # [N, N]
        grad = 4.0 * (torch.diag(pq.sum(1)) - pq) @ y
        momentum = 0.5 if i < 250 else momentum_final
        same_sign = torch.sign(grad) == torch.sign(vel)
        gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2), min=0.01)
        vel = momentum * vel - learning_rate * gains * grad
        y = y + vel
        y = y - y.mean(0, keepdim=True)
        kls.append((pp * torch.log(torch.clamp(pp, min=1e-12) / q)).sum())
    return y, torch.stack(kls) if kls else torch.zeros(0, device=y.device)


class BarnesHutTsne:
    """Reference-parity surface (name kept; the implementation is exact and
    dense, see the module docstring)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_iter: int = 500,
                 momentum: float = 0.8, exaggeration: float = 12.0,
                 seed: int = 42, device=DEFAULT_DEVICE):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.momentum = momentum
        self.exaggeration = exaggeration
        self.seed = seed
        self.device = device
        self.embedding_: Optional[np.ndarray] = None
        self.kl_curve_: Optional[np.ndarray] = None

    class Builder:
        def __init__(self):
            self._kw = {}

        def set_max_iter(self, n):
            self._kw["n_iter"] = n; return self  # noqa: E702

        def perplexity(self, p):
            self._kw["perplexity"] = p; return self  # noqa: E702

        def learning_rate(self, lr):
            self._kw["learning_rate"] = lr; return self  # noqa: E702

        def theta(self, t):
            return self  # Barnes-Hut approximation knob: N/A (exact impl)

        def seed(self, s):
            self._kw["seed"] = s; return self  # noqa: E702

        def device(self, d):
            self._kw["device"] = d; return self  # noqa: E702

        def build(self) -> "BarnesHutTsne":
            return BarnesHutTsne(**self._kw)

    def _initial_y(self, n: int) -> torch.Tensor:
        """The start of a fit on ``n`` points: N(0, 1) * 1e-4 from a CPU
        generator seeded with ``seed`` (the same on every device)."""
        gen = torch.Generator().manual_seed(int(self.seed))
        return torch.randn((n, self.n_components), generator=gen, dtype=torch.float32) * 1e-4

    def fit_transform(self, x) -> np.ndarray:
        dev = resolve_device(self.device)
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32))).to(dev)
        n = x.shape[0]
        perp = min(self.perplexity, max((n - 1) / 3.0, 2.0))
        d = _pairwise_sq_dists(x)
        p = _cond_probs(d, perp)
        p_sym = (p + p.T) / (2.0 * n)
        y, kls = _tsne_run(
            p_sym, self._initial_y(n).to(dev), n_iter=self.n_iter,
            learning_rate=self.learning_rate, momentum_final=self.momentum,
            exaggeration=self.exaggeration, exaggeration_iters=min(250, self.n_iter // 2))
        self.embedding_ = y.cpu().numpy()
        self.kl_curve_ = kls.cpu().numpy()
        return self.embedding_

    fit = fit_transform
