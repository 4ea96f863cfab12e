"""DQN: replay buffer, target network, eps-greedy Q-learning (counterpart of
``deeplearning4j_tpu/rl/qlearning.py``).

Reference: ``org.deeplearning4j.rl4j.learning.sync.qlearning.discrete.
QLearningDiscrete``: ExpReplay buffer, target-net sync every
``target_dqn_update_freq`` steps, eps-greedy annealed over
``eps_anneal_steps``, double-DQN option; ``policy.DQNPolicy``;
``network.dqn.DQNFactoryStdDense``.

The Q-update (Q(s, a) of the replay batch, the TD target from the target
net, the Huber-clamped error, the updater) is the port MLN's forward, head,
autograd and updater over the whole batch, run eagerly where the JAX
package jits it. The host side (replay sampling and eps-greedy draws from
the configuration's ``RandomState``) is the JAX package's, draw for draw.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..nn.conf import DenseLayer, NeuralNetConfiguration, OutputLayer
from ..nn.multilayer import MultiLayerNetwork
from ..nn.updaters import Adam
from .mdp import MDP


class ExpReplay:
    """Ring-buffer experience replay (learning.sync.ExpReplay)."""

    def __init__(self, max_size: int = 10000, batch_size: int = 32, seed: int = 0):
        self.buffer: Deque = deque(maxlen=max_size)
        self.batch_size = batch_size
        self.rs = np.random.RandomState(seed)

    def store(self, s, a, r, s2, done):
        self.buffer.append((s, a, r, s2, done))

    def sample(self) -> Tuple[np.ndarray, ...]:
        idx = self.rs.randint(0, len(self.buffer), self.batch_size)
        s, a, r, s2, d = zip(*[self.buffer[i] for i in idx])
        return (np.stack(s), np.asarray(a, np.int32), np.asarray(r, np.float32),
                np.stack(s2), np.asarray(d, np.float32))

    def __len__(self):
        return len(self.buffer)


@dataclasses.dataclass
class QLearningConfiguration:
    """QLearning.QLConfiguration parity (field names kept)."""

    seed: int = 123
    max_epoch_step: int = 200
    max_step: int = 5000
    exp_rep_max_size: int = 10000
    batch_size: int = 32
    target_dqn_update_freq: int = 100
    update_start: int = 100
    reward_factor: float = 1.0
    gamma: float = 0.99
    error_clamp: float = 1.0
    min_epsilon: float = 0.05
    eps_anneal_steps: int = 1000
    double_dqn: bool = True


class DQNFactoryStdDense:
    """network.dqn.DQNFactoryStdDense: the MLP Q-network's factory."""

    @staticmethod
    def build(n_in: int, n_out: int, hidden: int = 64, n_layers: int = 2,
              lr: float = 1e-3, seed: int = 0, *, device="cuda") -> MultiLayerNetwork:
        b = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(lr))
             .weight_init("xavier").list())
        for i in range(n_layers):
            b = b.layer(DenseLayer(n_in=n_in if i == 0 else hidden,
                                   n_out=hidden, activation="relu"))
        conf = b.layer(OutputLayer(n_out=n_out, activation="identity", loss="mse")).build()
        return MultiLayerNetwork(conf, device=device).init()


def clone_params(net: MultiLayerNetwork) -> Dict[str, Dict[str, torch.Tensor]]:
    """A detached copy of the network's parameters ({layer: {name: tensor}}):
    a target network, or a rollout's snapshot."""
    return {si: {k: p.detach().clone() for k, p in pd.items()}
            for si, pd in net.params_.items()}


def q_values(net: MultiLayerNetwork, params, x) -> torch.Tensor:
    """The network's head output on ``x`` under ``params`` (inference mode:
    no dropout, BN on its running statistics)."""
    h, _, _ = net._forward(params, net._bn(), x, training=False, rng=None)
    return net._head_forward(params, h)


def apply_gradients(net: MultiLayerNetwork, loss_fn) -> torch.Tensor:
    """One update of ``net`` by the gradient of ``loss_fn(params)``: the
    configuration's updater at the network's iteration (epoch 0), applied in
    place; the iteration advances. Returns the loss, detached."""
    named = {f"{si}.{k}": p for si, pd in net.params_.items() for k, p in pd.items()}
    with torch.enable_grad():
        loss = loss_fn(net._params())
        grads = torch.autograd.grad(loss, list(named.values()))
    updates, net.updater_state = net.conf.updater.apply(
        dict(zip(named, grads)), net.updater_state, named, net.iteration, 0)
    with torch.no_grad():
        for name, p in named.items():
            p.sub_(updates[name])
    net.iteration += 1
    return loss.detach()


def _take(q, a):
    return torch.gather(q, 1, a[:, None])[:, 0]


class QLearningDiscrete:
    def __init__(self, mdp: MDP, config: QLearningConfiguration = None,
                 q_network: Optional[MultiLayerNetwork] = None, hidden: int = 64, *,
                 device="cuda"):
        self.mdp = mdp
        self.cfg = config or QLearningConfiguration()
        n_in = int(np.prod(mdp.observation_space.shape))
        n_act = mdp.action_space.size
        self.qnet = q_network or DQNFactoryStdDense.build(
            n_in, n_act, hidden=hidden, seed=self.cfg.seed, device=device)
        self.device = self.qnet.device
        self.target_params = clone_params(self.qnet)
        self.replay = ExpReplay(self.cfg.exp_rep_max_size, self.cfg.batch_size,
                                self.cfg.seed)
        self.rs = np.random.RandomState(self.cfg.seed)
        self.step_count = 0
        self.epoch_rewards: List[float] = []

    # ---------------------------------------------------------------- q step

    def _update(self, s, a, r, s2, done) -> torch.Tensor:
        net, cfg = self.qnet, self.cfg
        with torch.no_grad():
            q_next_t = q_values(net, self.target_params, s2)
            if cfg.double_dqn:
                # double DQN: argmax from online net, value from target net
                a_star = torch.argmax(q_values(net, net._params(), s2), dim=1)
                q_next = _take(q_next_t, a_star)
            else:
                q_next = q_next_t.max(dim=1).values
            target = r + cfg.gamma * (1.0 - done) * q_next

        def loss_fn(params):
            qa = _take(q_values(net, params, s), a)
            # error clamp = Huber loss (linear beyond the clamp), not a hard
            # clip of the TD error, which would zero the gradient exactly
            # where learning is needed
            td = torch.abs(qa - target)
            clamp = cfg.error_clamp
            return torch.mean(torch.where(td <= clamp, 0.5 * torch.square(td),
                                          clamp * (td - 0.5 * clamp)))

        return apply_gradients(net, loss_fn)

    # ------------------------------------------------------------------ act

    def epsilon(self) -> float:
        frac = min(1.0, self.step_count / max(1, self.cfg.eps_anneal_steps))
        return 1.0 + frac * (self.cfg.min_epsilon - 1.0)

    def act(self, obs: np.ndarray, greedy: bool = False) -> int:
        if not greedy and self.rs.rand() < self.epsilon():
            return self.mdp.action_space.random_action(self.rs)
        q = self.qnet.output(obs[None].reshape(1, -1)).cpu().numpy()
        return int(np.argmax(q[0]))

    # ---------------------------------------------------------------- train

    def train(self) -> List[float]:
        """Run until cfg.max_step env steps; returns per-epoch rewards."""
        cfg = self.cfg
        while self.step_count < cfg.max_step:
            obs = self.mdp.reset()
            ep_reward, ep_steps = 0.0, 0
            while not self.mdp.is_done() and ep_steps < cfg.max_epoch_step:
                a = self.act(obs)
                obs2, r, done, _ = self.mdp.step(a)
                self.replay.store(obs.reshape(-1), a, r * cfg.reward_factor,
                                  obs2.reshape(-1), float(done))
                obs = obs2
                ep_reward += r
                ep_steps += 1
                self.step_count += 1
                if self.step_count >= cfg.update_start and len(self.replay) >= cfg.batch_size:
                    self._learn()
                if self.step_count % cfg.target_dqn_update_freq == 0:
                    self.target_params = clone_params(self.qnet)
                if self.step_count >= cfg.max_step:
                    break
            self.epoch_rewards.append(ep_reward)
        return self.epoch_rewards

    def _learn(self) -> torch.Tensor:
        """One update from a replay sample; returns its loss (on the device)."""
        s, a, r, s2, d = self.replay.sample()
        dev = self.device
        as_t = lambda v, dt=torch.float32: torch.as_tensor(v, dtype=dt, device=dev)  # noqa: E731
        return self._update(as_t(s), as_t(a, torch.long), as_t(r), as_t(s2), as_t(d))

    def get_policy(self) -> "DQNPolicy":
        return DQNPolicy(self.qnet)

    getPolicy = get_policy


class DQNPolicy:
    """policy.DQNPolicy: greedy play."""

    def __init__(self, qnet: MultiLayerNetwork):
        self.qnet = qnet

    def next_action(self, obs: np.ndarray) -> int:
        q = self.qnet.output(np.asarray(obs).reshape(1, -1)).cpu().numpy()
        return int(np.argmax(q[0]))

    nextAction = next_action

    def play(self, mdp: MDP, max_steps: int = 1000) -> float:
        obs = mdp.reset()
        total, steps = 0.0, 0
        while not mdp.is_done() and steps < max_steps:
            obs, r, _, _ = mdp.step(self.next_action(obs))
            total += r
            steps += 1
        return total
