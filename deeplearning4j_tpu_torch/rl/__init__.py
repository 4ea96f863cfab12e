"""Reinforcement learning (rl4j parity; counterpart of
``deeplearning4j_tpu/rl``).

Reference: ``rl4j-core``: ``MDP`` interface + observation/action spaces,
``QLearningDiscrete`` (ExpReplay buffer, target-network sync, eps-greedy
anneal), ``DQNPolicy``, ``HistoryProcessor`` frame stacking,
``DQNFactoryStdDense``, the async n-step Q-learner and A3C/A2C
(``rl.actor_critic``). Environments and replay are host numpy; the networks
and their updates run on the model's device.
"""

from .mdp import MDP, DiscreteSpace, ObservationSpace
from .envs import CartPoleEnv, GymEnvAdapter
from .history import (
    AsyncNStepQLearningDiscrete,
    AsyncQLearningConfiguration,
    HistoryProcessor,
    HistoryProcessorConfiguration,
)
from .qlearning import DQNFactoryStdDense, DQNPolicy, ExpReplay, QLearningConfiguration, QLearningDiscrete

__all__ = [
    "MDP",
    "DiscreteSpace",
    "ObservationSpace",
    "ExpReplay",
    "QLearningConfiguration",
    "QLearningDiscrete",
    "DQNPolicy",
    "DQNFactoryStdDense",
]
