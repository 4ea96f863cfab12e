"""Replica targets for the port's ServingPool tests (``tests/test_torch_pool.py``;
the port's twin of ``tests/pool_workers.py``).

Loaded BY PATH inside replica subprocesses
(``python -m deeplearning4j_tpu_torch.serving.pool /path/torch_pool_workers.py:fn``).
Deliberately free of jax and of the JAX package, and, but for
``mln_server``, of torch: the pool mechanics under test (spawn, heartbeat,
respawn, routing, readiness, autoscaling) are model-agnostic, and a
numpy-only replica spawns in well under a second.

Knobs ride the pool's ``extra_env``:

- ``TDL_STUB_START_DELAY``  seconds to sleep before serving (warmup window)
- ``TDL_STUB_STEP_DELAY``   fake decode-step seconds (generative stub)
- ``TDL_STUB_MAX_NEW``      default max_new_tokens (generative stub)
- ``TDL_STUB_QUEUE``        admission queue size
"""

import os
import time

import numpy as np


class DoubleModel:
    """output(x) = 2x — deterministic, numpy-only."""

    def output(self, x):
        return np.asarray(x, np.float32) * 2.0


class StubSession:
    """FakeSession twin (see tests/test_torch_serving_generative.py): emits
    ``prompt[-1]+1, +2, ...`` with a configurable per-step delay."""

    def __init__(self, slots=4, max_len=100_000, step_delay=0.0):
        self.slots = slots
        self.max_len = max_len
        self.step_delay = step_delay
        self.eos_id = None
        self._next = {}

    @property
    def free_slots(self):
        return self.slots - len(self._next)

    def admit(self, prompt, max_new_tokens):
        prompt = np.asarray(prompt)
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError("prompt too long for the cache")
        if len(self._next) >= self.slots:
            raise RuntimeError("no free decode slot")
        slot = min(set(range(self.slots)) - set(self._next))
        first = int(prompt[-1]) + 1
        self._next[slot] = first + 1
        return slot, first

    def step(self):
        if self.step_delay:
            time.sleep(self.step_delay)
        out = dict(self._next)
        self._next = {s: t + 1 for s, t in self._next.items()}
        return out

    def release(self, slot):
        del self._next[slot]


def _maybe_start_delay():
    delay = float(os.environ.get("TDL_STUB_START_DELAY", "0"))
    if delay:
        time.sleep(delay)


def stub_server():
    """Plain inference replica: POST [[...]] -> 2x."""
    from deeplearning4j_tpu_torch.serving import JsonModelServer

    _maybe_start_delay()
    return JsonModelServer(
        DoubleModel(), port=0,
        max_queue=int(os.environ.get("TDL_STUB_QUEUE", "64")),
        warmup_input=np.zeros((1, 4), np.float32))


class ScaledModel:
    """output(x) = scale·x — the 'model version' is the scale factor."""

    def __init__(self, scale):
        self.scale = float(scale)

    def output(self, x):
        return np.asarray(x, np.float32) * self.scale


def swappable_server():
    """Versioned inference replica (the swap tests): the model version
    rides ``TDL_MODEL_CKPT`` — a json file ``{"scale": k}`` (``{"fail":
    true}`` simulates a checkpoint the new build cannot load, the swap
    validation-failure path). No env = the historical 2x model."""
    import json as _json

    from deeplearning4j_tpu_torch.serving import JsonModelServer

    _maybe_start_delay()
    ckpt = os.environ.get("TDL_MODEL_CKPT")
    scale = 2.0
    if ckpt:
        with open(ckpt) as f:
            doc = _json.load(f)
        if doc.get("fail"):
            raise RuntimeError(f"injected model-load failure from {ckpt}")
        scale = float(doc["scale"])
    return JsonModelServer(
        ScaledModel(scale), port=0,
        max_queue=int(os.environ.get("TDL_STUB_QUEUE", "64")),
        warmup_input=np.zeros((1, 4), np.float32))


def generative_stub_server():
    """Continuous-batching generative replica over the stub session."""
    from deeplearning4j_tpu_torch.serving import JsonModelServer

    _maybe_start_delay()
    session = StubSession(
        slots=4, step_delay=float(os.environ.get("TDL_STUB_STEP_DELAY", "0")))
    return JsonModelServer(
        None, port=0, generative_session=session,
        default_max_new_tokens=int(os.environ.get("TDL_STUB_MAX_NEW", "8")),
        max_queue=int(os.environ.get("TDL_STUB_QUEUE", "64")),
        warmup_input=[1])


class ModulesModel:
    """output(x) = [[jax imported?, the JAX package imported?]] per row."""

    def output(self, x):
        import sys

        flags = [float("jax" in sys.modules),
                 float(any(m == "deeplearning4j_tpu"
                           or m.startswith("deeplearning4j_tpu.")
                           for m in sys.modules))]
        return np.tile(np.asarray([flags], np.float32), (len(x), 1))


def isolation_server():
    """Reports what the replica process has imported."""
    from deeplearning4j_tpu_torch.serving import JsonModelServer

    return JsonModelServer(ModulesModel(), port=0,
                           warmup_input=np.zeros((1, 4), np.float32))


def mln_server():
    """A port MultiLayerNetwork on the CPU, built from its seed: Dense(4->8,
    tanh) -> Output(3, softmax), seed 7, micro-batched (batch_limit 4); when
    ``TDL_MODEL_CKPT`` names a checkpointer root, its newest verifiable
    generation is restored into it (the swap tests' model version)."""
    from deeplearning4j_tpu_torch.serde import TrainingCheckpointer
    from deeplearning4j_tpu_torch.serving import JsonModelServer

    net = mln_net()
    ckpt = os.environ.get("TDL_MODEL_CKPT")
    if ckpt and not TrainingCheckpointer(ckpt).restore(net):
        raise RuntimeError(f"no checkpoint to restore in {ckpt}")
    return (JsonModelServer.Builder(net).port(0).batch_limit(4)
            .warmup_input(np.zeros((1, 4), np.float32)).build())


def mln_net():
    from deeplearning4j_tpu_torch.nn import (DenseLayer, MultiLayerNetwork,
                                             NeuralNetConfiguration, OutputLayer)

    conf = (NeuralNetConfiguration.Builder().seed(7).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()
