"""MDP interface + spaces (a copy of ``deeplearning4j_tpu/rl/mdp.py``: host
numpy, nothing of JAX).

Reference: ``org.deeplearning4j.rl4j.mdp.MDP`` (reset/step/isDone/close,
getObservationSpace/getActionSpace), ``space.DiscreteSpace`` (SURVEY §2.7 R1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class DiscreteSpace:
    def __init__(self, size: int):
        self.size = size

    def random_action(self, rs: np.random.RandomState) -> int:
        return int(rs.randint(0, self.size))

    def get_size(self) -> int:
        return self.size

    getSize = get_size


class ObservationSpace:
    def __init__(self, shape: Tuple[int, ...]):
        self.shape = tuple(shape)


class MDP:
    """reset() -> obs; step(action) -> (obs, reward, done, info)."""

    observation_space: ObservationSpace
    action_space: DiscreteSpace

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, dict]:
        raise NotImplementedError

    def is_done(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        return None

    getObservationSpace = property(lambda self: self.observation_space)
    getActionSpace = property(lambda self: self.action_space)


class SimpleToyMDP(MDP):
    """Deterministic chain MDP for tests (the rl4j test-suite pattern of tiny
    synthetic MDPs): states 0..n-1 one-hot; action 1 moves right (+reward at
    the end), action 0 moves left (small negative reward). Optimal policy =
    always right; optimal return = n - 1 steps of 0 then +10."""

    def __init__(self, n: int = 6, max_steps: int = 50):
        self.n = n
        self.max_steps = max_steps
        self.observation_space = ObservationSpace((n,))
        self.action_space = DiscreteSpace(2)
        self._state = 0
        self._steps = 0
        self._done = False

    def _obs(self):
        o = np.zeros(self.n, np.float32)
        o[self._state] = 1.0
        return o

    def reset(self):
        self._state, self._steps, self._done = 0, 0, False
        return self._obs()

    def step(self, action: int):
        self._steps += 1
        if action == 1:
            self._state += 1
        else:
            self._state = max(0, self._state - 1)
        reward = -0.01
        if self._state >= self.n - 1:
            reward = 10.0
            self._done = True
        if self._steps >= self.max_steps:
            self._done = True
        return self._obs(), reward, self._done, {}

    def is_done(self):
        return self._done
