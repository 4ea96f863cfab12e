"""Eval and replica targets of the port's deploy-controller tests
(``test_torch_controller.py``, ``test_torch_isolation.py``).

Loaded BY PATH: ``eval_sleepy`` as the ``eval_target`` of a
``python -m deeplearning4j_tpu_torch.deploy.controller`` subprocess;
``eval_on_default_device`` and ``default_device_server`` build a port
network without naming a device, as a user's target would, to show that it
lands on the card. Free of jax and of the JAX package.
"""

import os
import time

import numpy as np


def eval_sleepy(gendir):
    """Sleep ``TDL_EVAL_SLEEP`` seconds (long in the run that gets killed
    mid-gate, unset in the resumed run), then return a fixed verdict."""
    time.sleep(float(os.environ.get("TDL_EVAL_SLEEP", "0")))
    return {"accuracy": float(os.environ.get("TDL_EVAL_ACC", "0.9"))}


def _default_device_net():
    from deeplearning4j_tpu_torch.nn import (DenseLayer, MultiLayerNetwork,
                                             NeuralNetConfiguration, OutputLayer)

    conf = (NeuralNetConfiguration.Builder().seed(7).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init()  # no device: the card


def eval_on_default_device(gendir):
    """Restore the candidate into a network on the default device and
    score it with ``Evaluation.to_metrics``."""
    from deeplearning4j_tpu_torch.eval import Evaluation

    net = _default_device_net()
    ev = Evaluation()
    x = np.zeros((4, 4), np.float32)
    ev.eval(np.eye(3, dtype=np.float32)[[0, 1, 2, 0]], net.output(x))
    return ev


def default_device_server():
    """A replica whose network sits on the default device."""
    from deeplearning4j_tpu_torch.serving import JsonModelServer

    return JsonModelServer(_default_device_net(), port=0,
                           warmup_input=np.zeros((1, 4), np.float32))
