"""Nestable host-side spans aligned with the ``torch.profiler`` device
timeline, and step-phase attribution of a training loop (counterpart of
the JAX package's ``monitoring/trace.py``).

A :func:`span` does three things at once:

- enters a ``torch.profiler.record_function`` range of the span's own name
  (the JAX package enters ``jax.profiler.TraceAnnotation``, or
  ``StepTraceAnnotation`` for a :func:`step_span`), so the span shows up on
  a ``torch.profiler`` capture whenever one is active — host spans and the
  device's kernels line up by name; a step span passes its step number as
  the range's ``args``;
- records a chrome-trace complete event into an :class:`~..ops.profiler.
  OpProfiler` (the one attached via :func:`set_trace_profiler`, or an
  explicit ``profiler=``), so ONE ``to_chrome_trace`` file carries both op
  events and span events;
- optionally observes the span duration into a registry histogram.

Spans nest: names are qualified with the enclosing span path
(``fit/step/h2d``), per thread.

A :class:`StepPhaseRecorder` times the phases of each train step, exclusive
of nested phases, and observes them at the step's end into the
``tdl_step_phase_seconds{phase=...}`` histogram family of the port's
metrics registry; :meth:`StepPhaseRecorder.summary` gives the
phase-percentage table. The data-parallel trainers record ``input`` (the
next batch), ``h2d`` (placing it on the device), ``compute`` (the step) and
``collective`` (the gradient reduction, nested in ``compute``). With a
trace profiler attached, each phase is also a span.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

_tls = threading.local()

_trace_profiler = None  # OpProfiler every span also records into (optional)


def set_trace_profiler(profiler) -> None:
    """Attach an ``OpProfiler`` that every span records into (give it
    ``ProfilerConfig(trace_events=True)`` to capture the events). Pass
    ``None`` to detach."""
    global _trace_profiler
    _trace_profiler = profiler


def get_trace_profiler():
    return _trace_profiler


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span_path() -> str:
    """Qualified name of the innermost active span ('' outside any span)."""
    return "/".join(_stack())


class Span:
    def __init__(self, name: str, profiler=None, histogram=None,
                 step_num: Optional[int] = None):
        self.name = name
        self._profiler = profiler
        self._histogram = histogram
        self._step_num = step_num
        self._range = None
        self.qualified_name: Optional[str] = None
        self.duration_s: Optional[float] = None

    def __enter__(self):
        import torch

        stack = _stack()
        stack.append(self.name)
        self.qualified_name = "/".join(stack)
        # a step span carries its step number as the range's args, where
        # the JAX package's StepTraceAnnotation carries step_num
        self._range = torch.profiler.record_function(
            self.name, None if self._step_num is None else str(self._step_num))
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur_ns = time.perf_counter_ns() - self._t0
        self._range.__exit__(*exc)
        _stack().pop()
        self.duration_s = dur_ns / 1e9
        prof = self._profiler if self._profiler is not None else _trace_profiler
        if prof is not None:
            prof.record(self.qualified_name, dur_ns)
        if self._histogram is not None:
            self._histogram.observe(self.duration_s)
        return False


def span(name: str, profiler=None, histogram=None) -> Span:
    """Open a nestable host span: ``with span("h2d"): ...``"""
    return Span(name, profiler=profiler, histogram=histogram)


def step_span(step_num: int, name: str = "train",
              profiler=None, histogram=None) -> Span:
    """A span marking ONE training step, so a profiler capture's ranges and
    the host cadence agree on step boundaries."""
    return Span(name, profiler=profiler, histogram=histogram,
                step_num=step_num)


# -- step-time attribution ----------------------------------------------------

#: canonical phase names; recorders accept others
STEP_PHASES = ("input", "h2d", "compute", "collective")


def step_phase_histogram(registry=None):
    """Get-or-create the ``tdl_step_phase_seconds`` family — one declaration
    site so trainers, masters and tests agree on name and labels."""
    if registry is None:
        from .registry import get_registry

        registry = get_registry()
    return registry.histogram(
        "tdl_step_phase_seconds",
        "Seconds of one train step attributed to a phase (exclusive time: "
        "a phase nested inside another counts only toward itself)",
        labels=("phase",))


class _PhaseTimer:
    """Context manager timing one phase occurrence. Host timing only unless
    a trace profiler is attached — then a full :class:`Span` rides along so
    the phase also lands on the chrome-trace and profiler timelines."""

    __slots__ = ("_rec", "_name", "_span", "_t0", "_children")

    def __init__(self, rec: "StepPhaseRecorder", name: str):
        self._rec = rec
        self._name = name
        self._span = None

    def __enter__(self):
        if _trace_profiler is not None:
            self._span = Span(self._name)
            self._span.__enter__()
        self._t0 = time.perf_counter()
        self._children = 0.0
        self._rec._frames.append(self)
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        frames = self._rec._frames
        frames.pop()
        # exclusive time: nested phases already claimed their share
        self._rec.add(self._name, max(0.0, dur - self._children))
        if frames:
            frames[-1]._children += dur
        if self._span is not None:
            self._span.__exit__(*exc)
        return False


class StepPhaseRecorder:
    """Accumulates per-phase seconds across one step, observes them into the
    histogram family at :meth:`step_done`, and keeps running totals for the
    phase-percentage table. One instance per fit loop thread."""

    def __init__(self, registry=None):
        self._hist = step_phase_histogram(registry)
        self._acc: dict = {}
        self._totals: dict = {}
        self._frames: list = []
        self._steps = 0
        self._wall = 0.0
        self._last_done: Optional[float] = None

    def phase(self, name: str) -> _PhaseTimer:
        """``with recorder.phase("input"): ds = next(it)``"""
        return _PhaseTimer(self, name)

    def add(self, name: str, seconds: float) -> None:
        """Attribute already-measured seconds."""
        self._acc[name] = self._acc.get(name, 0.0) + float(seconds)

    def discard(self) -> None:
        """Drop phase time accumulated since the last :meth:`step_done`: the
        ``next()`` that raises StopIteration records an ``input`` slice that
        belongs to no step."""
        self._acc = {}

    def step_done(self) -> None:
        for name, s in self._acc.items():
            self._hist.labels(name).observe(s)
            self._totals[name] = self._totals.get(name, 0.0) + s
        now = time.perf_counter()
        if self._last_done is not None:
            self._wall += now - self._last_done
        else:
            # the first step has no prior boundary: its wall is what was timed
            self._wall += sum(self._acc.values())
        self._last_done = now
        self._steps += 1
        self._acc = {}

    def summary(self) -> dict:
        """Phase-percentage table over the recorded steps' total wall. The
        canonical phases always appear (0.0 when never recorded);
        ``other_pct`` is the unattributed remainder."""
        wall = max(self._wall, sum(self._totals.values()), 1e-9)
        phases = {}
        for name in list(STEP_PHASES) + sorted(set(self._totals) - set(STEP_PHASES)):
            s = self._totals.get(name, 0.0)
            phases[name] = {"seconds": round(s, 4),
                            "pct": round(100.0 * s / wall, 2)}
        attributed = sum(p["pct"] for p in phases.values())
        return {"steps": self._steps, "wall_seconds": round(wall, 4),
                "phases": phases,
                "other_pct": round(max(0.0, 100.0 - attributed), 2)}
