"""Device-memory and recompilation watchdogs (counterpart of the JAX
package's ``monitoring/watchdogs.py``).

Two failure modes a long training job cannot see from its listeners:

- **device-memory creep / OOM**: by the time an allocation fails the job is
  dead. :class:`DeviceMemoryWatchdog` samples ``torch.cuda.memory_stats()``
  (the caching allocator's bytes in use and high water) and the card's
  capacity into the ``tdl_device_memory_*`` gauges, and can dump the
  allocator's largest live blocks when a threshold is crossed. A process
  that has not initialised CUDA (the CPU tests, a host-only worker) reads
  its host RSS instead, as the JAX package does on backends without
  memory stats; the watchdog never imports torch or initialises CUDA
  itself.

- **shape churn and recompiles**: the fit loops note each step's input
  signature (:func:`note_signature`); :class:`RecompileWatchdog` keeps a
  bounded per-function table of the signatures seen, counts the new ones
  into ``tdl_jit_new_signatures_total{fn}`` and warns into
  ``tdl_shape_churn_warnings_total`` when the SAME function sees
  ``churn_threshold`` new signatures within ``window_steps`` steps. This
  half is the JAX package's, line for line: the same batch shapes give the
  same counts and warnings in both packages.

**What the port counts as a compile.** The JAX package hooks XLA's backend
compile event. The port's eager steps compile nothing per shape; its
compiled programs are two, and each is counted under
``tdl_xla_compiles_total{fn}`` / ``tdl_xla_compile_seconds_total{fn}``
(family names kept: the stock ``recompiles_after_warmup`` alert rule and
both packages' spool readers use them):

- an nvcc build of one kernel library (``kernels/_build.py`` ``build_all``:
  one compile per source built, its seconds the build's wall time; a
  library found built is not a compile);
- a ``torch.export`` trace (``serde/compiled.py`` ``export_compiled``).

Each is attributed as in the JAX package: to the function whose new
signature this thread announced last (within ``ATTRIBUTION_WINDOW_S``),
else to ``fn="_unattributed"``, and leaves a ``compile`` event in the
flight recorder. Inactive watchdogs cost nothing: :func:`active` is false
and the fit loops compute no signature.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from collections import OrderedDict, defaultdict, deque
from typing import Dict, List, Optional, Tuple

from ..common.debug import live_tensors
from . import flight
from .heartbeat import host_rss_bytes
from .registry import MetricsRegistry, get_registry

logger = logging.getLogger("deeplearning4j_tpu_torch.monitoring")

__all__ = ["DeviceMemoryWatchdog", "RecompileWatchdog", "active", "host_rss_bytes",
           "note_compile", "note_signature", "note_step", "signature_of"]


def _cuda():
    """``torch`` when it is imported and CUDA is initialised in this process,
    else None: the watchdog reads the card only where the process already
    uses it."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch


class DeviceMemoryWatchdog:
    """Watermark sampler over the caching allocator of each card.

    ``sample()`` is explicit (cheap, host-side only: it reads the
    allocator's counters, no CUDA call that a graph capture on another
    thread would forbid); ``start(interval)`` runs it on a daemon thread for
    long jobs. The high-water gauge is OURS (max over samples and the
    allocator's own peak), so it also works on the host-RSS fallback.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 threshold_bytes: Optional[int] = None,
                 dump_live_buffers: bool = False, dump_top: int = 10):
        self.registry = registry or get_registry()
        self.threshold_bytes = threshold_bytes
        self.dump_live_buffers = dump_live_buffers
        self.dump_top = dump_top
        r = self.registry
        self._in_use = r.gauge(
            "tdl_device_memory_bytes_in_use",
            "Device memory currently allocated (torch.cuda.memory_stats; host "
            "RSS in a process without CUDA)",
            labels=("device",))
        self._high_water = r.gauge(
            "tdl_device_memory_high_water_bytes",
            "High-water mark of device memory in use since watchdog creation "
            "(and the allocator's own peak)",
            labels=("device",))
        self._limit = r.gauge(
            "tdl_device_memory_limit_bytes",
            "Device memory capacity (the card's total memory)",
            labels=("device",))
        self._exceeded = r.counter(
            "tdl_device_memory_threshold_exceeded_total",
            "Samples that found memory in use above the configured threshold")
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def sample(self) -> Dict[str, int]:
        """One sampling pass; returns {device_label: bytes_in_use}."""
        out: Dict[str, int] = {}
        torch = _cuda()
        if torch is not None:
            for d in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(d)
                label = f"cuda:{d}"
                in_use = int(stats.get("allocated_bytes.all.current", 0))
                out[label] = in_use
                self._in_use.labels(label).set(in_use)
                self._high_water.labels(label).set_to_max(
                    max(in_use, int(stats.get("allocated_bytes.all.peak", 0))))
                self._limit.labels(label).set(
                    int(torch.cuda.get_device_properties(d).total_memory))
        else:
            # no CUDA in this process: host RSS is the best available proxy
            rss = host_rss_bytes()
            out["host"] = rss
            self._in_use.labels("host").set(rss)
            self._high_water.labels("host").set_to_max(rss)
        self._check_threshold(out)
        return out

    def _check_threshold(self, sampled: Dict[str, int]) -> None:
        if self.threshold_bytes is None:
            return
        over = {k: v for k, v in sampled.items() if v > self.threshold_bytes}
        if not over:
            return
        self._exceeded.inc()
        worst = max(over, key=over.get)
        logger.warning(
            "device memory watchdog: %s at %.1f MB exceeds threshold %.1f MB",
            worst, over[worst] / 1e6, self.threshold_bytes / 1e6)
        if self.dump_live_buffers:
            for line in self.live_buffer_summary(self.dump_top):
                logger.warning("  %s", line)

    def live_buffer_summary(self, top: int = 10) -> List[str]:
        """The largest live allocations, grouped — the 'what is actually
        holding device memory' dump. With CUDA initialised: the caching
        allocator's active blocks grouped by size (``memory_snapshot``);
        without: live tensors grouped by (shape, dtype), as the JAX package
        groups ``jax.live_arrays()``."""
        torch = _cuda()
        if torch is not None:
            groups: Dict[Tuple[str, str], List[int]] = defaultdict(list)
            for seg in torch.cuda.memory_snapshot():
                for blk in seg.get("blocks", ()):
                    if blk.get("state") == "active_allocated":
                        groups[(f"block {blk['size']} B", f"cuda:{seg.get('device', 0)}")
                               ].append(int(blk["size"]))
        else:
            groups = _live_tensor_groups()
        rows = sorted(((sum(v), len(v), k) for k, v in groups.items()),
                      reverse=True)[:top]
        return [f"{total / 1e6:9.2f} MB x{count:<5} {shape} {dtype}"
                for total, count, (shape, dtype) in rows]

    # -- background sampling ----------------------------------------------

    def start(self, interval_s: float = 10.0) -> "DeviceMemoryWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.sample()
                except Exception:  # sampling must never kill the job
                    logger.exception("device memory watchdog sample failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="tdl-memory-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def _live_tensor_groups() -> Dict[Tuple[str, str], List[int]]:
    """Live tensors of this process grouped by (shape, dtype) → their byte
    sizes."""
    groups: Dict[Tuple[str, str], List[int]] = defaultdict(list)
    for t in live_tensors():
        groups[(str(tuple(t.shape)), str(t.dtype).replace("torch.", ""))].append(
            t.numel() * t.element_size())
    return groups


# --------------------------------------------------------------- recompiles

_ACTIVE: List["RecompileWatchdog"] = []

# -- shared thread announcements ------------------------------------------
# The compile-cache monitor (monitoring.compilecache) attributes cache hits
# and misses per fn through the SAME note_signature announcements the
# watchdogs use, but it must work with no RecompileWatchdog installed (a
# serving replica wants cache counters without churn tracking). One
# module-level store, thread-keyed like the per-watchdog tables. The kernel
# build reports its cache traffic first (a hit consumes the announcement,
# a miss peeks it) and then one compile per library it built, which claims
# the announcement: the JAX package's event order.
_CC_LOCK = threading.Lock()
_CC_PENDING: Dict[int, Tuple[str, float]] = {}
_ANNOUNCE_EXTRA = False


def enable_announcements() -> None:
    """Make ``note_signature`` record thread announcements even with no
    RecompileWatchdog — the compile-cache monitor's attribution path."""
    global _ANNOUNCE_EXTRA
    _ANNOUNCE_EXTRA = True


def disable_announcements() -> None:
    """Stop cache-monitor announcements: with no active watchdog either,
    instrumented call sites go back to paying nothing per step."""
    global _ANNOUNCE_EXTRA
    _ANNOUNCE_EXTRA = False


def _cc_note(fn_name: str, signature) -> None:
    # every announcement overwrites: the newest one is what a build that
    # follows on this thread was for
    with _CC_LOCK:
        _CC_PENDING[threading.get_ident()] = (fn_name, time.monotonic())


def peek_pending_fn() -> Optional[str]:
    """This thread's fresh pending announcement WITHOUT consuming it
    (cache-MISS attribution: the compile that follows claims it)."""
    now = time.monotonic()
    with _CC_LOCK:
        pending = _CC_PENDING.get(threading.get_ident())
    if pending is not None and now - pending[1] <= ATTRIBUTION_WINDOW_S:
        return pending[0]
    return None


def take_pending_fn() -> Optional[str]:
    """Consume this thread's pending announcement (cache-HIT attribution:
    nothing will compile). None when nothing fresh is pending."""
    now = time.monotonic()
    with _CC_LOCK:
        pending = _CC_PENDING.pop(threading.get_ident(), None)
    if pending is not None and now - pending[1] <= ATTRIBUTION_WINDOW_S:
        return pending[0]
    return None


def note_compile(seconds: float) -> None:
    """One compile of a program of the port (an nvcc build of a kernel
    library, a ``torch.export`` trace) that took ``seconds``, on this
    thread: consumes the thread's announcement and fans out to every
    active watchdog."""
    with _CC_LOCK:
        _CC_PENDING.pop(threading.get_ident(), None)
    for wd in list(_ACTIVE):
        wd._on_compile(float(seconds))


def active() -> bool:
    """True when an instrumented call site should compute signatures: a
    RecompileWatchdog is installed, or the compile-cache monitor asked for
    announcements (zero-cost when both are off)."""
    return bool(_ACTIVE) or _ANNOUNCE_EXTRA


def note_step() -> None:
    """Advance every active watchdog's step clock (called by the fit loops
    once per training iteration)."""
    for wd in list(_ACTIVE):
        wd.step()


def note_signature(fn_name: str, signature) -> None:
    """Record a call signature for ``fn_name`` (called by the fit loops
    with the minibatch shape/dtype signature). No-op with no active
    watchdog or cache monitor."""
    if not _ACTIVE and not _ANNOUNCE_EXTRA:
        return
    _cc_note(fn_name, signature)
    for wd in list(_ACTIVE):
        wd.note_signature(fn_name, signature)


def _leaves(tree, out: list) -> None:
    """The JAX package's ``jax.tree.leaves`` order: dict values by sorted
    key, lists and tuples in order, None dropped."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _leaves(t, out)
    else:
        out.append(tree)


def signature_of(*trees) -> Tuple:
    """Hashable (shape, dtype) signature of nested dicts, lists and tuples
    of tensors or arrays (dtype names without ``torch.``, as numpy and JAX
    print them)."""
    leaves: list = []
    _leaves(trees, leaves)
    sig = []
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        if shape is None:
            sig.append(repr(leaf))
        else:
            sig.append((tuple(shape),
                        str(getattr(leaf, "dtype", "?")).replace("torch.", "")))
    return tuple(sig)


#: label for compiles no instrumented call site announced
UNATTRIBUTED = "_unattributed"

#: pending signature→compile attributions older than this are stale
ATTRIBUTION_WINDOW_S = 120.0


class RecompileWatchdog:
    """Counts compiles and compile seconds — attributed per function — and
    warns on shape churn.

    - every compile (:func:`note_compile`: a kernel build, an export trace)
      increments ``tdl_xla_compiles_total{fn}`` /
      ``tdl_xla_compile_seconds_total{fn}``. Attribution: an instrumented
      fit loop calls :func:`note_signature` immediately before its step; a
      NEW signature becomes that THREAD's pending announcement, and the
      next compile on the same thread claims it. Compiles with no pending
      announcement land under ``fn="_unattributed"``. Each also leaves a
      ``compile`` event (fn, signature, seconds) in the flight recorder;
    - when the same function accumulates ≥ ``churn_threshold`` distinct
      signatures within ``window_steps`` steps, a warning is logged and
      ``tdl_shape_churn_warnings_total`` increments;
    - the per-fn signature table is an LRU bounded at
      ``max_signatures_per_fn``; evictions are exported as
      ``tdl_jit_signature_evictions_total{fn}``.

    Use as a context manager (or ``install()``/``close()``); inactive
    instances cost nothing on the hot path.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 window_steps: int = 50, churn_threshold: int = 3,
                 max_signatures_per_fn: int = 512):
        self.registry = registry or get_registry()
        self.window_steps = max(1, window_steps)
        self.churn_threshold = max(2, churn_threshold)
        self.max_signatures_per_fn = max(1, max_signatures_per_fn)
        r = self.registry
        self._compiles = r.counter(
            "tdl_xla_compiles_total",
            "Compiles of a program of the port (an nvcc build of one kernel "
            "library, a torch.export trace), attributed to the function whose "
            "new input signature preceded them",
            labels=("fn",))
        self._compile_seconds = r.counter(
            "tdl_xla_compile_seconds_total",
            "Seconds spent in those compiles (nvcc builds, torch.export "
            "traces), per attributed function",
            labels=("fn",))
        self._churn = r.counter(
            "tdl_shape_churn_warnings_total",
            "Shape-churn warnings (same function saw many new input signatures)")
        self._sig_counter = r.counter(
            "tdl_jit_new_signatures_total",
            "Distinct step input signatures first seen, per function",
            labels=("fn",))
        self._evictions = r.counter(
            "tdl_jit_signature_evictions_total",
            "Signatures evicted from the bounded per-fn LRU table (churn so "
            "sustained the watchdog stopped remembering old shapes)",
            labels=("fn",))
        self._lock = threading.Lock()
        self._step = 0
        self._seen: Dict[str, OrderedDict] = defaultdict(OrderedDict)  # LRU
        self._recent: Dict[str, deque] = defaultdict(deque)  # (step,) of new sigs
        self._warned_at: Dict[str, int] = {}
        # per-THREAD latest unclaimed (fn, signature, noted_at): a compile
        # runs on the thread that asked for it, so claiming is thread-keyed
        # and a stale announcement is overwritten by the thread's next one
        self._pending: Dict[int, Tuple[str, object, float]] = {}
        self.compile_count = 0
        self.compile_seconds = 0.0
        self.per_fn_compiles: Dict[str, int] = defaultdict(int)
        self.per_fn_compile_seconds: Dict[str, float] = defaultdict(float)

    # -- lifecycle ---------------------------------------------------------

    def install(self) -> "RecompileWatchdog":
        if self not in _ACTIVE:
            _ACTIVE.append(self)
        return self

    def close(self) -> None:
        if self in _ACTIVE:
            _ACTIVE.remove(self)

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- signals -----------------------------------------------------------

    def _on_compile(self, duration: float) -> None:
        now = time.monotonic()
        with self._lock:
            self.compile_count += 1
            self.compile_seconds += duration
            fn, sig = UNATTRIBUTED, None
            claimed = self._pending.pop(threading.get_ident(), None)
            # staleness is judged at compile START (the event comes at the
            # END and carries the duration)
            if (claimed is not None
                    and now - duration - claimed[2] <= ATTRIBUTION_WINDOW_S):
                fn, sig = claimed[0], claimed[1]
            self.per_fn_compiles[fn] += 1
            self.per_fn_compile_seconds[fn] += duration
        self._compiles.labels(fn).inc()
        self._compile_seconds.labels(fn).inc(duration)
        # black-box breadcrumb: postmortems list churn offenders from these
        flight.record("compile", fn=fn, seconds=round(duration, 4),
                      signature=None if sig is None else repr(sig))

    def step(self) -> None:
        with self._lock:
            self._step += 1

    def note_signature(self, fn_name: str, signature) -> None:
        evicted = 0
        with self._lock:
            seen = self._seen[fn_name]
            if signature in seen:
                seen.move_to_end(signature)  # LRU touch
                return
            seen[signature] = None
            while len(seen) > self.max_signatures_per_fn:
                seen.popitem(last=False)
                evicted += 1
            self._pending[threading.get_ident()] = (
                fn_name, signature, time.monotonic())
            step = self._step
            recent = self._recent[fn_name]
            recent.append(step)
            while recent and recent[0] < step - self.window_steps:
                recent.popleft()
            fresh = len(recent)
            warned = self._warned_at.get(fn_name)
            should_warn = (fresh >= self.churn_threshold and
                           (warned is None or step - warned >= self.window_steps))
            if should_warn:
                self._warned_at[fn_name] = step
        self._sig_counter.labels(fn_name).inc()
        if evicted:
            self._evictions.labels(fn_name).inc(evicted)
        if should_warn:
            self._churn.inc()
            logger.warning(
                "recompile watchdog: %s saw %d distinct input signatures in "
                "the last %d steps — pad or bucket your minibatch shapes",
                fn_name, fresh, self.window_steps)

    # -- reading -----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "compiles": self.compile_count,
                "compile_seconds": self.compile_seconds,
                "steps": self._step,
                "signatures": {k: len(v) for k, v in self._seen.items()},
                "per_fn_compiles": dict(self.per_fn_compiles),
                "per_fn_compile_seconds": {
                    k: round(v, 4)
                    for k, v in self.per_fn_compile_seconds.items()},
            }
