"""MetricsListener — the TrainingListener → MetricsRegistry bridge (copy
of the JAX package's ``monitoring.listener``).

Attach to any network (``net.add_listeners(MetricsListener())``) and the fit
loop emits the operational core of DL4J's ``StatsListener``/
``PerformanceListener`` into the metrics registry instead of a stats file:
step-duration histogram, samples/sec + score gauges, iteration/epoch
counters. ``tdl_samples_per_sec`` uses the network's ``last_batch_size``,
the true example count under bucketing.

Score reads wait for the device, so the score gauge updates at
``score_every`` like the reference listeners' frequency knob; pure
host-side metrics update every iteration. Optional periodic device-memory
sampling rides along (``memory_every``); the recompile watchdog's step
clock is driven by the fit loops themselves, so it works with or without
this listener attached.
"""

from __future__ import annotations

import time
from typing import Optional

from . import heartbeat
from .registry import MetricsRegistry, get_registry
from .watchdogs import DeviceMemoryWatchdog


class MetricsListener:
    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 score_every: int = 10, memory_every: int = 0,
                 memory_watchdog: Optional[DeviceMemoryWatchdog] = None):
        self.registry = registry or get_registry()
        self.score_every = max(1, score_every)
        self.memory_every = max(0, memory_every)
        self._mem = memory_watchdog
        if self._mem is None and self.memory_every:
            self._mem = DeviceMemoryWatchdog(self.registry)
        r = self.registry
        self._iterations = r.counter(
            "tdl_iterations_total", "Training iterations completed",
            labels=("model",))
        self._epochs = r.counter(
            "tdl_epochs_total", "Training epochs completed", labels=("model",))
        self._step_duration = r.histogram(
            "tdl_step_duration_seconds",
            "Host-observed wall time between iteration_done callbacks",
            labels=("model",))
        self._samples_per_sec = r.gauge(
            "tdl_samples_per_sec", "Training throughput, examples/sec",
            labels=("model",))
        self._score = r.gauge(
            "tdl_score", "Training score (loss) at last sampled iteration",
            labels=("model",))
        # per-model (time, iteration) marks: one listener can serve several
        # nets without recording cross-model deltas as step durations
        self._last: dict = {}

    def iteration_done(self, model, iteration: int, epoch: int) -> None:
        # supervised-gang liveness: nets not driven through ParallelTrainer
        # still heartbeat when a MetricsListener is attached (no-op unless
        # TDL_HEARTBEAT_DIR is set)
        heartbeat.maybe_beat(iteration)
        name = type(model).__name__
        now = time.perf_counter()
        self._iterations.labels(name).inc()
        prev = self._last.get(name)
        if prev is not None:
            dt = now - prev[0]
            self._step_duration.labels(name).observe(dt)
            batch = getattr(model, "last_batch_size", None)
            # last_batch_size is per STEP; fit_scan advances iteration by K
            # per callback, so scale by the iteration delta
            steps = max(1, iteration - prev[1])
            if batch and dt > 0:
                self._samples_per_sec.labels(name).set(batch * steps / dt)
        self._last[name] = (now, iteration)
        if iteration % self.score_every == 0:
            score = getattr(model, "score_", None)  # lazy: syncs on read
            if score is not None:
                self._score.labels(name).set(float(score))
        if self._mem is not None and self.memory_every and \
                iteration % self.memory_every == 0:
            self._mem.sample()

    def on_epoch_start(self, model) -> None:
        self._last.pop(type(model).__name__, None)

    def on_epoch_end(self, model) -> None:
        self._epochs.labels(type(model).__name__).inc()
        # between-epoch work (evaluate(), checkpointing) is not a train
        # step; without this reset it would land in the histogram as one
        self._last.pop(type(model).__name__, None)
        if self._mem is not None:
            self._mem.sample()
