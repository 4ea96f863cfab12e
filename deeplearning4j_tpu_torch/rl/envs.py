"""Gym-API-shaped environments + adapter (a copy of
``deeplearning4j_tpu/rl/envs.py``: host numpy, no gym import).

Reference: ``rl4j-gym``'s ``GymEnv`` wraps OpenAI Gym through the (long
dead) gym-java-client; ALE/Malmo adapters ship in sibling modules. This
environment has zero egress, so no gym/ALE install exists — documented
exclusion in README. What ships instead:

- ``GymEnvAdapter``: wraps ANY object following the gymnasium duck-type
  (``reset() -> obs | (obs, info)``, ``step(a) -> (obs, r, terminated,
  truncated, info)`` or the legacy 4-tuple) into this package's ``MDP``
  interface, so a user with gymnasium installed plugs in with one line.
- ``CartPoleEnv``: a self-contained implementation of the classic
  cart-pole control problem exposing exactly the gymnasium API — the local
  stand-in that proves the adapter against real dynamics.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np

from .mdp import MDP, DiscreteSpace, ObservationSpace


class CartPoleEnv:
    """Cart-pole with the gymnasium duck-type (classic Barto-Sutton-Anderson
    dynamics; episode ends at |x|>2.4, |theta|>12deg, or 500 steps)."""

    def __init__(self, seed: int = 0, max_steps: int = 500):
        self._rs = np.random.RandomState(seed)
        self.max_steps = max_steps
        self.action_space_n = 2
        self.observation_shape = (4,)
        self._state: Optional[np.ndarray] = None
        self._steps = 0

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rs = np.random.RandomState(seed)
        self._state = self._rs.uniform(-0.05, 0.05, 4).astype(np.float32)
        self._steps = 0
        return self._state.copy(), {}

    def step(self, action: int):
        x, x_dot, th, th_dot = self._state
        force = 10.0 if action == 1 else -10.0
        costh, sinth = math.cos(th), math.sin(th)
        # masscart=1, masspole=0.1, length(half)=0.5, dt=0.02
        temp = (force + 0.05 * th_dot**2 * sinth) / 1.1
        th_acc = (9.8 * sinth - costh * temp) / (0.5 * (4.0 / 3.0 - 0.1 * costh**2 / 1.1))
        x_acc = temp - 0.05 * th_acc * costh / 1.1
        x += 0.02 * x_dot
        x_dot += 0.02 * x_acc
        th += 0.02 * th_dot
        th_dot += 0.02 * th_acc
        self._state = np.asarray([x, x_dot, th, th_dot], np.float32)
        self._steps += 1
        terminated = bool(abs(x) > 2.4 or abs(th) > 12 * math.pi / 180)
        truncated = self._steps >= self.max_steps
        return self._state.copy(), 1.0, terminated, truncated, {}

    def close(self):
        return None


class GymEnvAdapter(MDP):
    """rl4j GymEnv parity: MDP over any gymnasium-duck-typed env.

    Handles both gymnasium 5-tuple steps and legacy gym 4-tuple steps, and
    both ``reset() -> (obs, info)`` and bare-obs resets.
    """

    def __init__(self, env: Any, n_actions: Optional[int] = None,
                 obs_shape: Optional[Tuple[int, ...]] = None):
        self.env = env
        n = n_actions
        if n is None:
            space = getattr(env, "action_space", None)
            n = getattr(space, "n", None) if space is not None else None
            if n is None:
                n = getattr(env, "action_space_n", None)
        if n is None:
            raise ValueError("cannot infer action count; pass n_actions")
        self.action_space = DiscreteSpace(int(n))
        shape = obs_shape
        if shape is None:
            space = getattr(env, "observation_space", None)
            shape = getattr(space, "shape", None) if space is not None else None
            if shape is None:
                shape = getattr(env, "observation_shape", None)
        if shape is None:
            raise ValueError("cannot infer observation shape; pass obs_shape")
        self.observation_space = ObservationSpace(tuple(shape))
        self._done = False

    def reset(self) -> np.ndarray:
        out = self.env.reset()
        obs = out[0] if isinstance(out, tuple) else out
        self._done = False
        return np.asarray(obs, np.float32)

    def step(self, action: int):
        out = self.env.step(int(action))
        if len(out) == 5:
            obs, reward, terminated, truncated, info = out
            done = bool(terminated or truncated)
        else:
            obs, reward, done, info = out
        self._done = bool(done)
        return np.asarray(obs, np.float32), float(reward), self._done, dict(info)

    def is_done(self) -> bool:
        return self._done

    def close(self):
        if hasattr(self.env, "close"):
            self.env.close()
