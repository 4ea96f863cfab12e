"""Advantage actor-critic: A3C (async workers) + vectorized A2C (counterpart
of ``deeplearning4j_tpu/rl/actor_critic.py``).

Reference: rl4j ``org.deeplearning4j.rl4j.learning.async.a3c.discrete.
A3CDiscrete`` — N async worker threads, each rolling out t_max steps in its
own environment copy, computing n-step advantage gradients, and applying
them to a shared global network (``AsyncGlobal``).

One update (policy + value joint loss over n-step returns, entropy bonus,
the reference's RMSProp) serves two trainers:

- :class:`A3CDiscrete` — worker threads with private env copies push
  updates into the global parameters under a lock;
- :class:`A2CVectorized` — one batched rollout across N env copies per
  update (synchronous A3C == A2C).

The parameters are a nested dict of tensors, as the JAX package's tree;
an update returns new tensors and leaves the old ones as they were, so a
worker's snapshot stays fixed while another thread updates (the JAX
package's immutable trees give the same). Action draws come from each
trainer's ``RandomState``, as in the JAX package.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..common.device import resolve_device
from .history import run_workers

Params = Dict[str, Dict[str, torch.Tensor]]


# ------------------------------------------------------------- policy net


def init_actor_critic(generator, n_in: int, n_actions: int, hidden=(64, 64),
                      dtype=torch.float32, *, device="cuda") -> Params:
    """Separate torso → (policy logits, value) heads (rl4j
    ActorCriticFactorySeparateStdDense equivalent, merged torso); drawn on
    the CPU from ``generator`` (a ``torch.Generator`` or an int seed). JAX's
    numbers come through ``models.weights.actor_critic_params_from_jax``."""
    gen = generator if isinstance(generator, torch.Generator) else \
        torch.Generator().manual_seed(int(generator))
    dev = resolve_device(device)
    sizes = (n_in,) + tuple(hidden)
    params: Params = {}

    def layer(a, b, scale):
        return {"W": (torch.randn((a, b), generator=gen) * scale).to(dev, dtype),
                "b": torch.zeros(b, device=dev, dtype=dtype)}

    for i in range(len(hidden)):
        params[f"h{i}"] = layer(sizes[i], sizes[i + 1], np.sqrt(2.0 / sizes[i]))
    params["pi"] = layer(sizes[-1], n_actions, 0.01)
    params["v"] = layer(sizes[-1], 1, 0.01)
    return params


def actor_critic_forward(params, obs):
    h = obs
    i = 0
    while f"h{i}" in params:
        h = torch.relu(h @ params[f"h{i}"]["W"] + params[f"h{i}"]["b"])
        i += 1
    logits = h @ params["pi"]["W"] + params["pi"]["b"]
    value = (h @ params["v"]["W"] + params["v"]["b"])[..., 0]
    return logits, value


def _ac_loss(params, obs, actions, returns, *, vf_coef: float, ent_coef: float):
    logits, values = actor_critic_forward(params, obs)
    logp = torch.log_softmax(logits, dim=-1)
    adv = (returns - values).detach()
    pg = -torch.mean(torch.gather(logp, 1, actions[:, None])[:, 0] * adv)
    vf = torch.mean(torch.square(returns - values))
    ent = -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))
    return pg + vf_coef * vf - ent_coef * ent


@dataclass
class A3CConfiguration:
    """rl4j A3CConfiguration field parity."""

    seed: int = 0
    max_epoch_step: int = 200
    t_max: int = 8
    gamma: float = 0.99
    learning_rate: float = 7e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    num_threads: int = 2


def _make_update(cfg: A3CConfiguration):
    """``update(params, opt, obs, actions, returns) -> (params, opt, loss)``:
    the joint loss's gradient and RMSProp (the reference's updater for
    A3C), as new trees."""

    def update(params, opt, obs, actions, returns):
        leaves = [(k, n) for k, layer in params.items() for n in layer]
        with torch.enable_grad():
            live = {k: {n: t.detach().requires_grad_() for n, t in layer.items()}
                    for k, layer in params.items()}
            loss = _ac_loss(live, obs, actions, returns,
                            vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef)
            grads = torch.autograd.grad(loss, [live[k][n] for k, n in leaves])
        new_params: Params = {k: {} for k in params}
        new_opt: Params = {k: {} for k in params}
        with torch.no_grad():
            for (k, n), g in zip(leaves, grads):
                s = 0.99 * opt[k][n] + 0.01 * g * g
                new_opt[k][n] = s
                new_params[k][n] = params[k][n] - cfg.learning_rate * g / (torch.sqrt(s) + 1e-5)
        return new_params, new_opt, loss.detach()

    return update


def _nstep_returns(rewards, bootstrap, dones, gamma):
    """Backward n-step discounted returns (host-side, tiny arrays)."""
    out = np.zeros(len(rewards), np.float32)
    r = bootstrap
    for t in reversed(range(len(rewards))):
        r = rewards[t] + gamma * r * (1.0 - dones[t])
        out[t] = r
    return out


def _zeros_like(params) -> Params:
    return {k: {n: torch.zeros_like(t) for n, t in layer.items()} for k, layer in params.items()}


def _device_of(params) -> torch.device:
    return next(iter(params["pi"].values())).device


class A3CDiscrete:
    """Async worker threads + shared global params (reference semantics)."""

    def __init__(self, mdp_factory: Callable[[], Any], cfg: A3CConfiguration,
                 n_in: int, n_actions: int, *, device="cuda"):
        self.cfg = cfg
        self.mdp_factory = mdp_factory
        self.params = init_actor_critic(cfg.seed, n_in, n_actions, device=device)
        self.opt = _zeros_like(self.params)
        self._update = _make_update(cfg)
        self._lock = threading.Lock()
        self.episode_rewards: List[float] = []

    def train(self, total_steps: int = 5000):
        n = self.cfg.num_threads
        run_workers(self._worker, [(i, total_steps // n) for i in range(n)])
        return self

    @torch.no_grad()
    def _worker(self, widx: int, steps: int):
        cfg = self.cfg
        env = self.mdp_factory()
        rng = np.random.RandomState(cfg.seed * 997 + widx)
        obs = env.reset()
        ep_reward, done_steps = 0.0, 0
        while done_steps < steps:
            with self._lock:
                params = self.params
            dev = _device_of(params)
            as_t = lambda o: torch.as_tensor(np.asarray(o, np.float32), device=dev)  # noqa: E731
            traj_o, traj_a, traj_r, traj_d = [], [], [], []
            for _ in range(cfg.t_max):
                logits, _ = actor_critic_forward(params, as_t(obs)[None])
                p = torch.softmax(logits[0], dim=-1).cpu().numpy()
                a = int(rng.choice(len(p), p=p / p.sum()))
                nxt, r, done, _ = env.step(a)
                traj_o.append(np.asarray(obs, np.float32))
                traj_a.append(a)
                traj_r.append(r)
                traj_d.append(float(done))
                ep_reward += r
                obs = nxt
                done_steps += 1
                if done:
                    self.episode_rewards.append(ep_reward)
                    ep_reward = 0.0
                    obs = env.reset()
                    break
            if traj_d[-1]:
                boot = 0.0
            else:
                _, v = actor_critic_forward(params, as_t(obs)[None])
                boot = float(v[0])
            rets = _nstep_returns(np.asarray(traj_r, np.float32), boot,
                                  np.asarray(traj_d, np.float32), cfg.gamma)
            with self._lock:
                self.params, self.opt, _ = self._update(
                    self.params, self.opt, as_t(np.stack(traj_o)),
                    torch.as_tensor(traj_a, dtype=torch.long, device=dev), as_t(rets))

    def policy(self):
        return ACPolicy(self.params)


class A2CVectorized:
    """Synchronous batched A3C: N env copies stepped together, one update
    per rollout — the accelerator-shaped training mode."""

    def __init__(self, mdp_factory: Callable[[], Any], cfg: A3CConfiguration,
                 n_in: int, n_actions: int, n_envs: int = 8, *, device="cuda"):
        self.cfg = cfg
        self.envs = [mdp_factory() for _ in range(n_envs)]
        self.params = init_actor_critic(cfg.seed, n_in, n_actions, device=device)
        self.opt = _zeros_like(self.params)
        self._update = _make_update(cfg)
        self.episode_rewards: List[float] = []

    @torch.no_grad()
    def train(self, updates: int = 200):
        cfg = self.cfg
        dev = _device_of(self.params)
        as_t = lambda o: torch.as_tensor(o, device=dev)  # noqa: E731
        rng = np.random.RandomState(cfg.seed)
        obs = np.stack([e.reset() for e in self.envs]).astype(np.float32)
        ep_rew = np.zeros(len(self.envs))
        for _ in range(updates):
            O, Aa, Rr, Dd = [], [], [], []
            for _ in range(cfg.t_max):
                logits, _ = actor_critic_forward(self.params, as_t(obs))
                probs = torch.softmax(logits, dim=-1).cpu().numpy()
                acts = np.array([rng.choice(probs.shape[1], p=p / p.sum())
                                 for p in probs])
                nxt, rew, done = [], [], []
                for e, a in zip(self.envs, acts):
                    n, r, d, _ = e.step(int(a))
                    if d:
                        n = e.reset()
                    nxt.append(n)
                    rew.append(r)
                    done.append(float(d))
                O.append(obs.copy())
                Aa.append(acts)
                Rr.append(np.asarray(rew, np.float32))
                Dd.append(np.asarray(done, np.float32))
                ep_rew += np.asarray(rew)
                for j, d in enumerate(done):
                    if d:
                        self.episode_rewards.append(float(ep_rew[j]))
                        ep_rew[j] = 0.0
                obs = np.stack(nxt).astype(np.float32)
            _, v = actor_critic_forward(self.params, as_t(obs))
            boot = v.cpu().numpy()
            rets = np.zeros((cfg.t_max, len(self.envs)), np.float32)
            r = boot
            for t in reversed(range(cfg.t_max)):
                r = Rr[t] + cfg.gamma * r * (1.0 - Dd[t])
                rets[t] = r
            self.params, self.opt, _ = self._update(
                self.params, self.opt, as_t(np.concatenate(O)),
                as_t(np.concatenate(Aa).astype(np.int64)), as_t(rets.reshape(-1)))
        return self

    def policy(self):
        return ACPolicy(self.params)


class ACPolicy:
    """Greedy policy over the trained actor (rl4j ACPolicy)."""

    def __init__(self, params):
        self.params = params

    @torch.no_grad()
    def next_action(self, obs) -> int:
        x = torch.as_tensor(np.asarray(obs, np.float32), device=_device_of(self.params))
        logits, _ = actor_critic_forward(self.params, x[None])
        return int(torch.argmax(logits[0]))

    nextAction = next_action

    def play(self, env, max_steps: int = 200) -> float:
        obs = env.reset()
        total = 0.0
        for _ in range(max_steps):
            obs, r, done, _ = env.step(self.next_action(obs))
            total += r
            if done:
                break
        return total
