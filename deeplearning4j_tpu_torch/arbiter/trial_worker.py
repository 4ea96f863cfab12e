"""Trial-gang worker target (counterpart of the JAX package's
``arbiter/trial_worker.py``, with its env contract and tasks).

One rung of one trial: ``launcher.spawn`` (driven by the fleet's per-trial
``GangSupervisor``) runs :func:`trial_train` in a fresh process, which

1. builds the task's net from the trial's hyperparameters on this rank's
   device (``launcher.local_device()``: the card unless the gang runs on
   the CPU),
2. restores unconditionally from the trial's checkpoint lineage (the gang
   restart contract — also how a PBT clone lands: the fleet committed the
   winner's generation into THIS lineage as a suffixed sibling, and the
   plain newest-committed restore walk picks it up),
3. trains to the rung's target iteration through ``MultiProcessTrainer``
   (so heartbeats, flight step events, fault injection and the metrics
   spool all ride the trainer's hooks),
4. saves the rung-end generation, evaluates, and publishes
   ``tdl_trial_score{trial}`` / ``tdl_trial_iteration{trial}`` through the
   fleet's SHARED metrics spool dir — the rung barrier reads the verdict
   from the spool, never from a side channel.

Env contract (set by ``TrialFleet`` through ``GangSupervisor.extra_env``)::

    TDL_TRIAL_ID           trial identity — metric label + proc prefix stem
    TDL_TRIAL_HPARAMS      JSON hyperparameter dict for the task's builder
    TDL_TRIAL_CKPT         checkpoint lineage root (per trial)
    TDL_TRIAL_TARGET_ITER  train UNTIL this iteration, then score
    TDL_TRIAL_TASK         JSON task spec: {"kind": <registry key>, ...}
    TDL_TRIAL_CKPT_EVERY   optional mid-rung save cadence (crash recovery)
    TDL_TRIAL_KEEP_LAST    lineage generations the worker's own GC keeps

On the card every trial process is one NCCL rank of a gang of its own, so
up to the fleet's ``max_concurrent`` such processes share one card.

Two tasks, the JAX package's: ``synth_classify`` (noisy blobs, seconds of
CPU) and ``lenet_images`` (a LeNet-style network over an image directory,
decoded by the ETL service's ``ImageEtlSpec`` through a ``DecodedBatchCache``
that every trial of a sweep shares).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np


def _hparams() -> Dict:
    return json.loads(os.environ["TDL_TRIAL_HPARAMS"])


def _task_spec() -> Dict:
    return json.loads(os.environ.get("TDL_TRIAL_TASK",
                                     '{"kind": "synth_classify"}'))


class SynthClassifyTask:
    """Deterministic noisy-blobs classification — the fast task.

    Three gaussian clusters in ``n_in`` dims whose overlap makes accuracy
    genuinely sensitive to ``learning_rate``/``hidden``: a bad config
    plateaus, a good one separates — enough signal for ASHA cuts and PBT
    exploits to mean something, at seconds of CPU. The batches and the
    evaluation split are the JAX package's bit for bit (same seeds, same
    ``RandomState`` draws)."""

    def __init__(self, spec: Dict):
        self.seed = int(spec.get("seed", 7))
        self.n_in = int(spec.get("n_in", 8))
        self.n_classes = int(spec.get("n_classes", 3))
        self.batch_size = int(spec.get("batch", 32))
        self.noise = float(spec.get("noise", 0.9))
        rs = np.random.RandomState(self.seed)
        self.centers = rs.randn(self.n_classes, self.n_in).astype(np.float32)

    def _draw(self, rs: np.random.RandomState,
              n: int) -> Tuple[np.ndarray, np.ndarray]:
        y = rs.randint(0, self.n_classes, n)
        x = (self.centers[y]
             + rs.randn(n, self.n_in).astype(np.float32) * self.noise)
        return x.astype(np.float32), np.eye(self.n_classes,
                                            dtype=np.float32)[y]

    def build_net(self, hp: Dict, device="cuda"):
        from ..nn import MultiLayerNetwork, NeuralNetConfiguration
        from ..nn.conf import DenseLayer, InputType, OutputLayer
        from ..nn.updaters import Adam

        hidden = int(hp.get("hidden", 16))
        conf = (
            NeuralNetConfiguration.Builder().seed(self.seed)
            .updater(Adam(float(hp.get("learning_rate", 1e-2)))).list()
            .layer(DenseLayer(n_in=self.n_in, n_out=hidden,
                              activation=str(hp.get("activation", "tanh"))))
            .layer(OutputLayer(n_out=self.n_classes, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(self.n_in))
            .build())
        return MultiLayerNetwork(conf, device=device).init()

    def batch(self, iteration: int) -> Tuple[np.ndarray, np.ndarray]:
        # keyed by iteration, not by wall order: a respawned incarnation
        # resuming at iteration k replays the exact stream a crash-free run
        # would have seen — scores stay deterministic under chaos
        rs = np.random.RandomState(self.seed * 100_003 + iteration)
        return self._draw(rs, self.batch_size)

    def evaluate(self, net) -> float:
        rs = np.random.RandomState(self.seed + 999_331)  # fixed eval split
        x, y = self._draw(rs, 512)
        pred = net.output(x).cpu().numpy()  # the card's answer, on the host
        return float((pred.argmax(1) == y.argmax(1)).mean())


class LenetImagesTask:
    """LeNet-style conv task over an image directory, decoded through the
    ETL pipeline with a SHARED ``DecodedBatchCache``: every trial of the
    fleet points at the same ``cache_dir``, the spec fingerprint is
    identical across trials (hyperparameters don't change decode geometry),
    so the sweep pays the PNG decode once and every later trial memmaps it.
    Cache traffic lands in ``tdl_etl_cache_{hits,misses}_total`` — the
    bench's shared-ETL evidence. The batches, the network and the
    evaluation are the JAX package's."""

    def __init__(self, spec: Dict):
        from ..data.etl_service import ImageEtlSpec

        self.seed = int(spec.get("seed", 123))
        self.spec = ImageEtlSpec.from_directory(
            spec["data_dir"], height=int(spec.get("height", 24)),
            width=int(spec.get("width", 24)), channels=int(spec.get("channels", 1)),
            batch_size=int(spec.get("batch", 16)),
            store_pad=int(spec.get("store_pad", 4)), seed=self.seed,
            augment=False, shuffle=True,
            cache_dir=spec.get("cache_dir"))
        self.num_batches = max(1, len(self.spec.files) // self.spec.batch_size)
        self._cache = self.spec.open_cache()
        self._hits = 0
        self._misses = 0

    def build_net(self, hp: Dict, device="cuda"):
        from ..nn import MultiLayerNetwork, NeuralNetConfiguration
        from ..nn.conf import (ConvolutionLayer, DenseLayer, InputType,
                               OutputLayer, SubsamplingLayer)
        from ..nn.updaters import Adam

        c1 = int(hp.get("conv_channels", 8))
        hidden = int(hp.get("hidden", 32))
        conf = (
            NeuralNetConfiguration.Builder().seed(self.seed)
            .updater(Adam(float(hp.get("learning_rate", 1e-3)))).list()
            .layer(ConvolutionLayer(n_out=c1, kernel_size=(5, 5),
                                    stride=(1, 1), activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=hidden, activation="relu"))
            .layer(OutputLayer(n_out=self.spec.num_classes,
                               activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(
                self.spec.height, self.spec.width, self.spec.channels))
            .build())
        return MultiLayerNetwork(conf, device=device).init()

    def _publish_cache_counters(self) -> None:
        from ..monitoring.etl import etl_metrics

        m = etl_metrics()
        m.cache_hits.inc(self._hits)
        m.cache_misses.inc(self._misses)
        self._hits = 0
        self._misses = 0

    def _produce(self, b: int, epoch: int) -> Tuple[np.ndarray, np.ndarray]:
        img, labels, hit = self.spec.produce(b, epoch, self._cache)
        self._hits += int(hit)
        self._misses += int(not hit)
        # ETL hands back NHWC uint8; the net's inter-layer layout is NCHW
        x = img.astype(np.float32).transpose(0, 3, 1, 2) / 255.0
        y = np.eye(self.spec.num_classes, dtype=np.float32)[labels]
        return x, y

    def batch(self, iteration: int) -> Tuple[np.ndarray, np.ndarray]:
        out = self._produce(iteration % self.num_batches,
                            iteration // self.num_batches)
        self._publish_cache_counters()
        return out

    def evaluate(self, net) -> float:
        correct = total = 0
        for b in range(self.num_batches):
            x, y = self._produce(b, 0)  # augment=False: epoch is geometry-free
            pred = net.output(x).cpu().numpy()  # the card's answer, on the host
            correct += int((pred.argmax(1) == y.argmax(1)).sum())
            total += len(y)
        self._publish_cache_counters()
        return correct / max(1, total)


TASKS = {
    "synth_classify": SynthClassifyTask,
    "lenet_images": LenetImagesTask,
}


def build_task(spec: Dict):
    kind = spec.get("kind", "synth_classify")
    if kind not in TASKS:
        raise ValueError(f"unknown trial task {kind!r}; "
                         f"choose from {sorted(TASKS)}")
    return TASKS[kind](spec)


def trial_train() -> None:
    """The gang worker entry point (module docstring for the contract)."""
    from ..data.dataset import DataSet
    from ..monitoring import aggregate, flight
    from ..monitoring.trial import trial_metrics
    from ..parallel.launcher import local_device
    from ..parallel.mesh import build_mesh
    from ..parallel.trainer import MultiProcessTrainer
    from ..serde.checkpoint import TrainingCheckpointer

    trial = os.environ["TDL_TRIAL_ID"]
    hp = _hparams()
    target = int(os.environ["TDL_TRIAL_TARGET_ITER"])
    every = int(os.environ.get("TDL_TRIAL_CKPT_EVERY", "0")) \
        or max(1, target // 4)
    task = build_task(_task_spec())

    net = task.build_net(hp, device=local_device())
    ck = TrainingCheckpointer(
        os.environ["TDL_TRIAL_CKPT"], async_write=False,
        keep_last=int(os.environ.get("TDL_TRIAL_KEEP_LAST", "2")))
    start = 0
    if ck.restore(net):  # cold lineage on rung 0 incarnation 0 → False
        start = int(net.iteration)
    trainer = MultiProcessTrainer(net, build_mesh(data=-1))
    for it in range(start, target):
        x, y = task.batch(it)
        trainer.fit([DataSet(x, y)])
        if (it + 1) % every == 0 and (it + 1) < target:
            ck.save(net)  # mid-rung durability: a crash respawn resumes here
    if int(net.iteration) > start or start == 0:
        ck.save(net)  # the rung-end generation PBT clones from
    score = task.evaluate(net)
    m = trial_metrics()
    m.score.labels(trial).set(score)
    m.iteration.labels(trial).set(int(net.iteration))
    flight.record("trial_score", trial=trial, score=round(score, 6),
                  iteration=int(net.iteration))
    flight.flush()
    aggregate.maybe_spool(force=True)
