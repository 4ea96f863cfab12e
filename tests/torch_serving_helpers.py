"""Helpers the port's serving tests share (``tests/test_torch_serving*.py``,
``test_torch_loadgen.py``): stand-in models, HTTP helpers, and the small
networks built in both packages from one configuration, the port's carrying
the JAX network's weights (``tests/torch_mln_helpers.port_net``).
"""

import json
import threading
import time
import urllib.request

import numpy as np

from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf import OutputLayer as JOut
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from torch_mln_helpers import port_net


def jax_net():
    """The JAX package's serving test network: Dense(4->8, tanh) ->
    Output(3, softmax), seed 7."""
    conf = (JConf.Builder().seed(7).updater(JAdam(0.01)).list()
            .layer(JDense(n_in=4, n_out=8, activation="tanh"))
            .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return JNet(conf).init()


def nets():
    """(JAX network, port network on the CPU with the same weights)."""
    jnet = jax_net()
    return jnet, port_net(jnet)


def net():
    return nets()[1]


def out(model, x):
    """``model.output(x)`` as numpy, either package."""
    y = model.output(x)
    return y.detach().numpy() if hasattr(y, "detach") else np.asarray(y.numpy())


class SlowModel:
    """Deterministic stand-in: 2x the input after a fixed delay, counting
    calls and flagging when a forward has started."""

    def __init__(self, delay=0.0):
        self.delay = delay
        self.calls = 0
        self.started = threading.Event()

    def output(self, x):
        self.calls += 1
        self.started.set()
        if self.delay:
            time.sleep(self.delay)
        return np.asarray(x, np.float32) * 2.0


class FlakyModel(SlowModel):
    def __init__(self, fail_first=2):
        super().__init__()
        self.fail_first = fail_first

    def output(self, x):
        self.calls += 1
        self.started.set()
        if self.calls <= self.fail_first:
            raise RuntimeError("transient replica failure")
        return np.asarray(x, np.float32) * 2.0


def counter_values(reg, name):
    m = reg.get(name)
    if m is None:
        return {}
    snap = m.snapshot()
    return {tuple(s["labels"].values()): s["value"] for s in snap["series"]}


def post(port, body, headers=None, timeout=15):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=body,
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def get(port, path, timeout=15):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)
