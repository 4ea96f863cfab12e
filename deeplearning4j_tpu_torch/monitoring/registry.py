"""Metrics registry — labeled counters / gauges / fixed-bucket histograms
(copy of the JAX package's ``monitoring.registry``).

One process-wide registry every layer of the port writes into (the serving
executors, the HTTP server, the replica pool), exposed in Prometheus text
format at ``/metrics`` and as a JSON snapshot. The port's registry is its
own: a process that imports both packages holds two registries, and the same
operations on each print the same text.

The model follows the Prometheus client data model deliberately — counters
only go up, gauges are set, histograms have fixed cumulative buckets — so the
exposition needs no translation layer. Everything is plain host-side Python:
no metric touches device tensors or forces a sync (callers decide when a
device value is cheap to read).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Default histogram buckets for step/span durations, in seconds. Wide on
# purpose: one set serves both a 1 ms request and a multi-second step.
DEFAULT_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_LabelKey = Tuple[str, ...]


def _validate_name(name: str) -> str:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(f"invalid metric name {name!r}")
    if name[0].isdigit():
        raise ValueError(f"metric name must not start with a digit: {name!r}")
    return name


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _escape_help(v: str) -> str:
    # HELP lines escape backslash and newline only (no quotes to close), per
    # the text-format spec — an unescaped newline in help text splits the
    # line and every strict scraper rejects the file
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _validate_label_name(name: str) -> str:
    if (not name or not (name[0].isalpha() or name[0] == "_")
            or not all(c.isalnum() or c == "_" for c in name)):
        raise ValueError(f"invalid label name {name!r}")
    return name


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(names: Sequence[str], values: _LabelKey,
                extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = [f'{n}="{_escape_label_value(str(v))}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label_value(str(v))}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Metric:
    """Base: one named metric family holding per-labelset children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()):
        self.name = _validate_name(name)
        self.help = help
        self.label_names = tuple(_validate_label_name(l) for l in labels)
        self._children: Dict[_LabelKey, object] = {}
        self._lock = threading.Lock()

    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(str(kw[n]) for n in self.label_names)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                self._children[values] = child
        return child

    def _default_child(self):
        """The no-label child (metrics declared without labels)."""
        if self.label_names:
            raise ValueError(
                f"{self.name} has labels {self.label_names}; use .labels(...)")
        return self.labels()

    def _make_child(self):
        raise NotImplementedError

    def _iter_children(self) -> List[Tuple[_LabelKey, object]]:
        with self._lock:
            return sorted(self._children.items())

    def clear_children(self) -> None:
        """Drop every labelset child. For info-style metrics that must show
        only the LATEST labelset (e.g. the gang's last failure
        classification) — without this, every historic labelset lingers as
        its own series forever."""
        with self._lock:
            self._children.clear()

    # -- exposition -------------------------------------------------------

    def expose(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key, child in self._iter_children():
            lines.extend(self._expose_child(key, child))
        return lines

    def _expose_child(self, key: _LabelKey, child) -> List[str]:
        raise NotImplementedError

    def snapshot(self) -> dict:
        out = {"type": self.kind, "help": self.help,
               "labels": list(self.label_names), "series": []}
        for key, child in self._iter_children():
            out["series"].append({"labels": dict(zip(self.label_names, key)),
                                  **self._snapshot_child(child)})
        return out

    def _snapshot_child(self, child) -> dict:
        raise NotImplementedError


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Counter(_Metric):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value

    def _expose_child(self, key, child):
        return [f"{self.name}{_fmt_labels(self.label_names, key)} "
                f"{_fmt_value(child.value)}"]

    def _snapshot_child(self, child):
        return {"value": child.value}


class _GaugeChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_to_max(self, value: float) -> None:
        """High-watermark update (used by the device-memory watchdog)."""
        with self._lock:
            if value > self._value:
                self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    def set_to_max(self, value: float) -> None:
        self._default_child().set_to_max(value)

    @property
    def value(self) -> float:
        return self._default_child().value

    def _expose_child(self, key, child):
        return [f"{self.name}{_fmt_labels(self.label_names, key)} "
                f"{_fmt_value(child.value)}"]

    def _snapshot_child(self, child):
        return {"value": child.value}


class _HistogramChild:
    __slots__ = ("buckets", "counts", "sum", "count", "_lock")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.sum += value
            self.count += 1
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labels=(),
                 buckets: Iterable[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help, labels)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def time(self):
        """Context manager observing the wall duration of a block."""
        hist = self

        class _Timer:
            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self._t0)
                return False

        return _Timer()

    def _expose_child(self, key, child):
        lines = []
        cumulative = 0
        for ub, c in zip(child.buckets, child.counts):
            cumulative += c
            lines.append(
                f"{self.name}_bucket"
                f"{_fmt_labels(self.label_names, key, [('le', _fmt_value(ub))])}"
                f" {cumulative}")
        cumulative += child.counts[-1]
        lines.append(f"{self.name}_bucket"
                     f"{_fmt_labels(self.label_names, key, [('le', '+Inf')])}"
                     f" {cumulative}")
        base = _fmt_labels(self.label_names, key)
        lines.append(f"{self.name}_sum{base} {_fmt_value(child.sum)}")
        lines.append(f"{self.name}_count{base} {cumulative}")
        return lines

    def _snapshot_child(self, child):
        return {"count": child.count, "sum": child.sum,
                "buckets": dict(zip((_fmt_value(b) for b in child.buckets),
                                    child.counts[:-1])),
                "inf": child.counts[-1]}


class MetricsRegistry:
    """Named collection of metrics with one-call exposition.

    get-or-create semantics: ``registry.counter("x", ...)`` returns the
    existing metric when already registered (so instrumentation sites don't
    need to coordinate creation order), raising only on a kind/labels
    mismatch.
    """

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labels, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} "
                        f"with labels {m.label_names}")
                return m
            m = cls(name, help, labels, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Iterable[float] = DEFAULT_TIME_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    # -- exposition --------------------------------------------------------

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-able snapshot of every metric (``/metrics.json``, bench)."""
        with self._lock:
            metrics = dict(self._metrics)
        return {name: metrics[name].snapshot() for name in sorted(metrics)}


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (what ``/metrics`` serves)."""
    return _DEFAULT
