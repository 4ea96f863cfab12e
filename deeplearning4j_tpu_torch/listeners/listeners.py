"""Training listeners (copy of the JAX package's ``listeners.listeners``).

Reference: deeplearning4j ``org.deeplearning4j.optimize.api.TrainingListener``
SPI + ``org.deeplearning4j.optimize.listeners.*``: ``ScoreIterationListener``,
``PerformanceListener`` (samples/sec, memory), ``CheckpointListener``
(rotating ModelSerializer zips), ``TimeIterationListener``,
``EvaluativeListener``, ``CollectScoresIterationListener``.

The port's networks call ``iteration_done(model, iteration, epoch)`` after
each step and (MultiLayerNetwork) ``on_epoch_end(model)`` per epoch, as the
JAX package's do. ``model.score()`` reads the lazy score: on the card that
waits for the step, so a listener reads it only at its own frequency.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from typing import List, Optional, Tuple

logger = logging.getLogger("deeplearning4j_tpu_torch")


_console_handler = None


def _ensure_console_handler() -> None:
    """Console-feedback listeners must be visible out of the box (the
    reference prints via slf4j-simple by default). If the application
    configured logging — any handler on this logger or the root — respect
    it; otherwise attach a plain stderr handler. If the app configures root
    logging later, the next listener construction removes ours again (no
    duplicate lines). An explicitly-set logger level is never overridden."""
    global _console_handler
    root_configured = bool(logging.getLogger().handlers)
    if _console_handler is not None and root_configured:
        logger.removeHandler(_console_handler)
        _console_handler = None
        return
    if logger.handlers or root_configured:
        return
    _console_handler = logging.StreamHandler()
    _console_handler.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(_console_handler)
    if logger.level == logging.NOTSET:  # respect an explicit user level
        logger.setLevel(logging.INFO)


class TrainingListener:
    def iteration_done(self, model, iteration: int, epoch: int) -> None:
        pass

    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass


class ScoreIterationListener(TrainingListener):
    """Log score every N iterations (ScoreIterationListener)."""

    def __init__(self, print_iterations: int = 10):
        _ensure_console_handler()
        self.n = max(1, print_iterations)

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.n == 0:
            # score() waits for the card (lazy score_) — read it ONCE
            logger.info("Score at iteration %d is %.6f", iteration, model.score())


class PerformanceListener(TrainingListener):
    """Throughput reporting (PerformanceListener: samples/sec, batches/sec,
    iteration time). GC stats are meaningless here; reports host RSS instead
    (``resource.getrusage`` current/peak) and mirrors both throughput and RSS
    into the monitoring registry as gauges."""

    def __init__(self, frequency: int = 10, report_samples: bool = True,
                 registry=None):
        _ensure_console_handler()
        self.frequency = max(1, frequency)
        self.report_samples = report_samples
        self._last_time = None
        self._last_iter = None
        self.last_samples_per_sec = float("nan")
        self.last_rss_bytes = 0
        from ..monitoring.registry import get_registry

        r = registry or get_registry()
        self._rss_gauge = r.gauge(
            "tdl_host_rss_bytes", "Host resident set size (PerformanceListener)")
        self._sps_gauge = r.gauge(
            "tdl_listener_samples_per_sec",
            "Throughput as observed by PerformanceListener")

    def iteration_done(self, model, iteration, epoch):
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            batch = getattr(model, "last_batch_size", None)
            ips = iters / dt if dt > 0 else float("nan")
            msg = f"iteration {iteration}: {ips:.1f} iters/sec"
            if batch:
                self.last_samples_per_sec = ips * batch
                self._sps_gauge.set(self.last_samples_per_sec)
                msg += f", {self.last_samples_per_sec:.1f} samples/sec"
            from ..monitoring.heartbeat import host_rss_bytes

            self.last_rss_bytes = host_rss_bytes()
            self._rss_gauge.set(self.last_rss_bytes)
            msg += f", host RSS {self.last_rss_bytes / 1e6:.1f} MB"
            logger.info("%s", msg)
            self._last_time, self._last_iter = now, iteration
        elif self._last_time is None:
            self._last_time, self._last_iter = now, iteration


class TimeIterationListener(TrainingListener):
    """ETA logging (TimeIterationListener)."""

    def __init__(self, total_iterations: int, frequency: int = 50):
        _ensure_console_handler()
        self.total = total_iterations
        self.frequency = max(1, frequency)  # clamp like the other listeners
        # clock starts on the FIRST iteration, not at construction — a
        # listener built long before fit() would skew every ETA
        self._start = None
        self._first_iter = None

    def iteration_done(self, model, iteration, epoch):
        if self._start is None:
            self._start, self._first_iter = time.perf_counter(), iteration
        if iteration % self.frequency == 0 and iteration > self._first_iter:
            elapsed = time.perf_counter() - self._start
            done = iteration - self._first_iter
            remaining = elapsed / done * (self.total - iteration)
            logger.info("iteration %d/%d, ETA %.0fs",
                        iteration, self.total, remaining)


class CollectScoresIterationListener(TrainingListener):
    """Capture (iteration, score) pairs for plotting."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score()))


class CheckpointListener(TrainingListener):
    """Rotating checkpoint saves (CheckpointListener.Builder: every N
    iterations/epochs, keepLast(n)) as ModelSerializer zips
    ``checkpoint_iter_<n>.zip`` / ``checkpoint_epoch_<n>.zip``."""

    def __init__(
        self,
        directory: str,
        save_every_n_iterations: Optional[int] = None,
        save_every_n_epochs: Optional[int] = None,
        keep_last: int = 3,
    ):
        self.dir = directory
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.keep_last = keep_last
        self._saved: deque = deque()
        os.makedirs(directory, exist_ok=True)

    def _save(self, model, tag: str):
        from ..serde.model_serializer import ModelSerializer

        path = os.path.join(self.dir, f"checkpoint_{tag}.zip")
        ModelSerializer.write_model(model, path, save_updater=True)
        self._saved.append(path)
        while len(self._saved) > self.keep_last:
            old = self._saved.popleft()
            if os.path.exists(old):
                os.remove(old)

    def iteration_done(self, model, iteration, epoch):
        if self.every_iter and iteration % self.every_iter == 0 and iteration > 0:
            self._save(model, f"iter_{iteration}")

    def on_epoch_end(self, model):
        if self.every_epoch and (model.epoch % self.every_epoch) == 0:
            self._save(model, f"epoch_{model.epoch}")

    def last_checkpoint(self) -> Optional[str]:
        return self._saved[-1] if self._saved else None


class EvaluativeListener(TrainingListener):
    """Periodic held-out evaluation (EvaluativeListener)."""

    def __init__(self, iterator, frequency_epochs: int = 1):
        _ensure_console_handler()
        self.iterator = iterator
        self.frequency = max(1, frequency_epochs)
        self.history: List[float] = []

    def on_epoch_end(self, model):
        if model.epoch % self.frequency == 0:
            ev = model.evaluate(self.iterator)
            self.history.append(ev.accuracy())
            logger.info("epoch %d: eval accuracy %.4f",
                        model.epoch, ev.accuracy())
