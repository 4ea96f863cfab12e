"""Step-phase attribution of a training loop (the host-only pieces of the
JAX package's ``monitoring/trace.py``).

A :class:`StepPhaseRecorder` times the phases of each train step, exclusive
of nested phases, and observes them at the step's end into the
``tdl_step_phase_seconds{phase=...}`` histogram family of the port's
metrics registry; :meth:`StepPhaseRecorder.summary` gives the
phase-percentage table. The data-parallel trainers record ``input`` (the
next batch), ``h2d`` (placing it on the device), ``compute`` (the step) and
``collective`` (the gradient reduction, nested in ``compute``).

The JAX module's spans, trace profiler and chrome-trace export are not
ported yet (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import time
from typing import Optional

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
    """Context manager timing one phase occurrence on the host clock."""

    __slots__ = ("_rec", "_name", "_t0", "_children")

    def __init__(self, rec: "StepPhaseRecorder", name: str):
        self._rec = rec
        self._name = name

    def __enter__(self):
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
