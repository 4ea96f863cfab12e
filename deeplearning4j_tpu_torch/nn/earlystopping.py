"""Early stopping (copy of the JAX package's ``nn.earlystopping``).

Reference: ``org.deeplearning4j.earlystopping``:
``EarlyStoppingConfiguration`` (termination conditions, score calculator,
model saver, evaluate-every-N), ``EarlyStoppingTrainer`` for MLN/CG,
``EarlyStoppingResult`` (reason, best epoch/score/model). The savers keep
the best model as a ``clone()`` (in memory) or as a ModelSerializer zip
(``LocalFileModelSaver``, restored onto the device of the network it
saved).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional


# ------------------------------------------------- termination conditions


class EpochTerminationCondition:
    def terminate(self, epoch: int, score: float, history: List[float]) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score, history):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no improvement (optionally by min delta)."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement

    def terminate(self, epoch, score, history):
        if len(history) <= self.patience:
            return False
        best_before = min(history[: -self.patience])
        recent_best = min(history[-self.patience:])
        # terminate unless the recent window IMPROVED by more than min_delta
        return recent_best >= best_before - self.min_improvement


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    def __init__(self, target_score: float):
        self.target = target_score

    def terminate(self, epoch, score, history):
        return score <= self.target


class IterationTerminationCondition:
    def terminate(self, iteration: int, score: float) -> bool:
        raise NotImplementedError


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def start(self):
        self._start = time.monotonic()

    def terminate(self, iteration, score):
        return self._start is not None and time.monotonic() - self._start > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort on divergence (score exceeds threshold or NaN)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, iteration, score):
        return score != score or score > self.max_score


# ------------------------------------------------------------------ savers


class InMemoryModelSaver:
    def __init__(self):
        self.best = None
        self.latest = None

    @staticmethod
    def _snapshot(net):
        if hasattr(net, "clone"):
            return net.clone()
        raise TypeError(f"{type(net).__name__} has no clone(); snapshot impossible")

    def save_best_model(self, net, score):
        self.best = self._snapshot(net)

    def save_latest_model(self, net, score):
        self.latest = self._snapshot(net)

    def get_best_model(self):
        return self.best

    saveBestModel = save_best_model
    getBestModel = get_best_model


class LocalFileModelSaver:
    def __init__(self, directory: str):
        self.directory = directory
        self._device = None  # the saved network's: get_best_model restores there
        os.makedirs(directory, exist_ok=True)

    def save_best_model(self, net, score):
        from ..serde.model_serializer import ModelSerializer

        self._device = net.device
        ModelSerializer.write_model(net, os.path.join(self.directory, "bestModel.zip"))

    def save_latest_model(self, net, score):
        from ..serde.model_serializer import ModelSerializer

        ModelSerializer.write_model(net, os.path.join(self.directory, "latestModel.zip"))

    def get_best_model(self):
        from ..serde.model_serializer import ModelSerializer

        return ModelSerializer.restore(os.path.join(self.directory, "bestModel.zip"),
                                       device=self._device or "cuda")


# ------------------------------------------------------------ score calc


class DataSetLossCalculator:
    """org.deeplearning4j.earlystopping.scorecalc.DataSetLossCalculator."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        total, n = 0.0, 0
        for ds in self.iterator:
            total += net.score(ds) * ds.num_examples()
            n += ds.num_examples()
        return total / max(n, 1) if self.average else total

    calculateScore = calculate_score


# ------------------------------------------------------------------ config


@dataclass
class EarlyStoppingConfiguration:
    epoch_termination_conditions: List[EpochTerminationCondition] = field(default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = field(default_factory=list)
    score_calculator: Optional[DataSetLossCalculator] = None
    model_saver: Any = field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False

    class Builder:
        def __init__(self):
            self._c = EarlyStoppingConfiguration()

        def epoch_termination_conditions(self, *conds):
            self._c.epoch_termination_conditions = list(conds)
            return self

        epochTerminationConditions = epoch_termination_conditions

        def iteration_termination_conditions(self, *conds):
            self._c.iteration_termination_conditions = list(conds)
            return self

        iterationTerminationConditions = iteration_termination_conditions

        def score_calculator(self, sc):
            self._c.score_calculator = sc
            return self

        scoreCalculator = score_calculator

        def model_saver(self, saver):
            self._c.model_saver = saver
            return self

        modelSaver = model_saver

        def evaluate_every_n_epochs(self, n):
            self._c.evaluate_every_n_epochs = n
            return self

        evaluateEveryNEpochs = evaluate_every_n_epochs

        def save_last_model(self, b: bool = True):
            self._c.save_last_model = b
            return self

        def build(self):
            return self._c


@dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    score_vs_epoch: List[float]
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any

    def get_best_model(self):
        return self.best_model

    getBestModel = get_best_model


class EarlyStoppingTrainer:
    """org.deeplearning4j.earlystopping.trainer.EarlyStoppingTrainer (the
    Graph variant is the same class here — both nets share the fit SPI)."""

    def __init__(self, config: EarlyStoppingConfiguration, net, train_iterator):
        self.config = config
        self.net = net
        self.train_iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.iteration_termination_conditions:
            if isinstance(c, MaxTimeIterationTerminationCondition):
                c.start()
        history: List[float] = []
        best_score, best_epoch = float("inf"), -1
        epoch = 0
        reason, details = "EpochTerminationCondition", ""
        while True:
            # one epoch of fitting, checking iteration conditions per batch
            aborted = False
            for ds in self.train_iterator:
                if hasattr(self.net, "_batch"):  # ComputationGraph
                    self.net._fit_batch(*self.net._batch(ds))
                elif hasattr(self.net, "_fit_batch"):  # MultiLayerNetwork
                    self.net._fit_batch(ds)
                else:
                    self.net.fit(ds)
                if not cfg.iteration_termination_conditions:
                    continue
                score = self.net.score_  # waits for the step: only when read
                for c in cfg.iteration_termination_conditions:
                    if c.terminate(self.net.iteration, score):
                        reason = "IterationTerminationCondition"
                        details = type(c).__name__
                        aborted = True
                        break
                if aborted:
                    break
            self.net.epoch += 1
            if aborted:
                break
            if epoch % cfg.evaluate_every_n_epochs == 0:
                score = (cfg.score_calculator.calculate_score(self.net)
                         if cfg.score_calculator else self.net.score_)
                history.append(score)
                if score < best_score:
                    best_score, best_epoch = score, epoch
                    cfg.model_saver.save_best_model(self.net, score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.net, score)
            else:
                score = history[-1] if history else self.net.score_
            # epoch conditions run EVERY epoch (a MaxEpochs cap must not
            # overshoot just because this wasn't an evaluation epoch)
            stop = False
            for c in cfg.epoch_termination_conditions:
                if c.terminate(epoch, score, history):
                    details = type(c).__name__
                    stop = True
                    break
            if stop:
                break
            epoch += 1
        best = cfg.model_saver.get_best_model() if hasattr(cfg.model_saver, "get_best_model") else None
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            score_vs_epoch=history, best_model_epoch=best_epoch,
            best_model_score=best_score, total_epochs=epoch + 1,
            best_model=best or self.net)


EarlyStoppingGraphTrainer = EarlyStoppingTrainer
