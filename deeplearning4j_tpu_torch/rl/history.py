"""HistoryProcessor + async n-step Q-learning (counterpart of
``deeplearning4j_tpu/rl/history.py``).

Reference: ``org.deeplearning4j.rl4j.util.HistoryProcessor`` (frame
skip/stack/scale/crop for pixel observations — the DQN-on-Atari
preprocessing) and ``rl4j-core``'s ``AsyncNStepQLearningDiscrete`` (Mnih
2016 asynchronous n-step Q-learning: worker threads each roll out n steps,
compute n-step targets against a shared target network, and apply gradients
to the shared online network).

The frame pipeline is host numpy, a copy of the JAX package's. The async
learner keeps its split: Python threads collect rollouts, and every update
of the one shared network is the port MLN's step, serialized through a lock
like the reference's ``AsyncGlobal.applyGradient``. The port updates the
network in place, so a worker's rollout reads a snapshot copied under the
lock (the JAX package's snapshot is its immutable parameter tree).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .mdp import MDP
from .qlearning import (
    DQNFactoryStdDense,
    QLearningConfiguration,
    _take,
    apply_gradients,
    clone_params,
    q_values,
)


@dataclass
class HistoryProcessorConfiguration:
    """rl4j HistoryProcessor.Configuration parity."""

    history_length: int = 4
    rescaled_width: int = 84
    rescaled_height: int = 84
    cropping_width: int = 84
    cropping_height: int = 84
    offset_x: int = 0
    offset_y: int = 0
    skip_frame: int = 4


class HistoryProcessor:
    """Frame pipeline: grayscale → rescale → crop → stack last k frames,
    recording every ``skip_frame``-th frame (others repeat the last stack).

    ``record(frame)`` takes HWC uint8/float [H,W,3] or [H,W]; ``history()``
    returns [k, h, w] float32 in [0,1] (the reference returns the stacked
    INDArray the DQN consumes).
    """

    def __init__(self, conf: Optional[HistoryProcessorConfiguration] = None):
        self.conf = conf or HistoryProcessorConfiguration()
        self._frames: List[np.ndarray] = []
        self._step = 0

    def _preprocess(self, frame: np.ndarray) -> np.ndarray:
        # scaling decided by DTYPE, not content: a near-black uint8 frame
        # must scale identically to a bright one in the same stack
        is_int = np.issubdtype(np.asarray(frame).dtype, np.integer)
        f = np.asarray(frame, np.float32)
        if f.ndim == 3:  # BT.601 luma, matching the reference's grayscale
            f = f @ np.asarray([0.299, 0.587, 0.114], np.float32)
        if is_int:
            f = f / 255.0
        c = self.conf
        if f.shape != (c.rescaled_height, c.rescaled_width):
            f = self._rescale(f, c.rescaled_height, c.rescaled_width)
        return f[c.offset_y:c.offset_y + c.cropping_height,
                 c.offset_x:c.offset_x + c.cropping_width]

    @staticmethod
    def _rescale(f: np.ndarray, h: int, w: int) -> np.ndarray:
        """Nearest-neighbor resize (no PIL dependency in the RL hot loop)."""
        ys = (np.arange(h) * f.shape[0] / h).astype(np.int32)
        xs = (np.arange(w) * f.shape[1] / w).astype(np.int32)
        return f[ys][:, xs]

    def record(self, frame: np.ndarray) -> bool:
        """Returns True when this frame was added (i.e. a skip boundary)."""
        take = self._step % self.conf.skip_frame == 0
        self._step += 1
        if take:
            self._frames.append(self._preprocess(frame))
            if len(self._frames) > self.conf.history_length:
                self._frames.pop(0)
        return take

    def start(self, frame: np.ndarray):
        """Reset and fill the stack with the initial frame (episode start)."""
        self._frames = [self._preprocess(frame)] * self.conf.history_length
        self._step = 1

    def history(self) -> np.ndarray:
        k = self.conf.history_length
        frames = ([self._frames[0]] * (k - len(self._frames)) + self._frames
                  if self._frames else
                  [np.zeros((self.conf.cropping_height, self.conf.cropping_width),
                            np.float32)] * k)
        return np.stack(frames[-k:])

    getHistory = history



def run_workers(target, args_list) -> None:
    """Run ``target(*args)`` on one thread per entry of ``args_list`` and
    join them all; the first exception a worker raised is raised here (the
    JAX package's threads end silently on one)."""
    errors: List[BaseException] = []

    def run(*args):
        try:
            target(*args)
        except BaseException as e:  # noqa: BLE001 - handed to the caller below
            errors.append(e)

    threads = [threading.Thread(target=run, args=args, daemon=True) for args in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


@dataclass
class AsyncQLearningConfiguration(QLearningConfiguration):
    """rl4j AsyncQLearningConfiguration: adds n-step + worker count."""

    n_step: int = 5
    num_threads: int = 2


class AsyncNStepQLearningDiscrete:
    """rl4j ``AsyncNStepQLearningDiscrete``: each worker thread rolls out up
    to ``n_step`` transitions, bootstraps G = r_t + γ r_{t+1} + … + γ^n
    max_a Q_target(s', a), and applies one gradient step on the SHARED
    online network; the target network refreshes every
    ``target_dqn_update_freq`` global steps."""

    def __init__(self, mdp_factory: Callable[[int], MDP],
                 config: Optional[AsyncQLearningConfiguration] = None,
                 hidden: int = 64, *, device="cuda"):
        self.cfg = config or AsyncQLearningConfiguration()
        self.mdp_factory = mdp_factory
        probe = mdp_factory(0)
        n_in = int(np.prod(probe.observation_space.shape))
        self.n_act = probe.action_space.size
        probe.close()
        self.qnet = DQNFactoryStdDense.build(n_in, self.n_act, hidden=hidden,
                                             seed=self.cfg.seed, device=device)
        self.device = self.qnet.device
        self.target_params = clone_params(self.qnet)
        self._lock = threading.Lock()
        self.global_steps = 0
        self.epoch_rewards: List[float] = []

    # -------------------------------------------------------------- train op

    def _q(self, params, obs) -> np.ndarray:
        with torch.no_grad():
            x = torch.as_tensor(obs[None], dtype=torch.float32, device=self.device)
            return q_values(self.qnet, params, x).cpu().numpy()

    def _update(self, s_b, a_b, g_b) -> torch.Tensor:
        net, dev = self.qnet, self.device
        s = torch.as_tensor(s_b, device=dev)
        a = torch.as_tensor(a_b, dtype=torch.long, device=dev)
        g = torch.as_tensor(g_b, device=dev)
        return apply_gradients(
            net, lambda params: torch.mean(torch.square(_take(q_values(net, params, s), a) - g)))

    # -------------------------------------------------------------- rollout

    def _worker(self, tid: int):
        cfg = self.cfg
        mdp = self.mdp_factory(tid)
        rs = np.random.RandomState(cfg.seed + 1000 * (tid + 1))
        obs = mdp.reset().reshape(-1)
        ep_reward = 0.0
        while self.global_steps < cfg.max_step:
            # n-step rollout against a params snapshot
            with self._lock:
                params_snap = clone_params(self.qnet)
            traj: List[Tuple[np.ndarray, int, float]] = []
            done = False
            for _ in range(cfg.n_step):
                frac = min(1.0, self.global_steps / max(1, cfg.eps_anneal_steps))
                eps = 1.0 + frac * (cfg.min_epsilon - 1.0)
                if rs.rand() < eps:
                    a = mdp.action_space.random_action(rs)
                else:
                    a = int(np.argmax(self._q(params_snap, obs)[0]))
                obs2, r, done, _ = mdp.step(a)
                traj.append((obs, a, r * cfg.reward_factor))
                ep_reward += r
                obs = obs2.reshape(-1)
                with self._lock:
                    self.global_steps += 1
                if done:
                    break
            # n-step returns, bootstrapped from the target net unless done
            if done:
                g = 0.0
            else:
                with self._lock:
                    target = self.target_params
                g = float(np.max(self._q(target, obs)[0]))
            gs = []
            for (_, _, r) in reversed(traj):
                g = r + cfg.gamma * g
                gs.append(g)
            gs.reverse()
            s_b = np.stack([t[0] for t in traj]).astype(np.float32)
            a_b = np.asarray([t[1] for t in traj], np.int32)
            g_b = np.asarray(gs, np.float32)
            with self._lock:  # AsyncGlobal.applyGradient: serialized apply
                self._update(s_b, a_b, g_b)
                if self.global_steps % cfg.target_dqn_update_freq < cfg.n_step:
                    self.target_params = clone_params(self.qnet)
            if done:
                with self._lock:
                    self.epoch_rewards.append(ep_reward)
                ep_reward = 0.0
                obs = mdp.reset().reshape(-1)
        mdp.close()

    def train(self) -> List[float]:
        run_workers(self._worker, [(t,) for t in range(self.cfg.num_threads)])
        return self.epoch_rewards

    def get_policy(self):
        from .qlearning import DQNPolicy

        return DQNPolicy(self.qnet)
