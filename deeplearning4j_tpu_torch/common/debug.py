"""Runtime invariant checks: live-buffer accounting and in-place update
misuse (counterpart of the JAX package's ``common/debug.py``).

Reference analog: libnd4j's sanitizer builds and the JVM side's workspace
leak detector (``MemoryWorkspace`` validation on close). Two failure
classes:

- **device-memory leaks**: allocations that keep accumulating across steps
  (a python reference keeping old state alive, listeners caching per-step
  tensors). :class:`LiveBufferMonitor` snapshots counts and bytes each
  tick and flags monotonic growth. The JAX package counts
  ``jax.live_arrays()``; the port reads the CUDA caching allocator (its
  active blocks and allocated bytes) where CUDA is initialised, and counts
  live tensors through the garbage collector where it is not (the CPU).
- **state kept twice**: the JAX step donates the parameter, updater and BN
  buffers and :func:`donation_guard` checks that they died. The port has
  no donation: its step updates those tensors in place. So the port's
  guard checks the port's own promise — after a step every state tensor is
  the same tensor object on the same storage as before, so no second copy
  of the state was made for an old one to survive in. A step that
  replaces a state tensor instead of updating it fails the guard.

Enable for the training loops with TDL_DEBUG_BUFFERS=1
(MultiLayerNetwork and ComputationGraph read it at their first fit).
"""

from __future__ import annotations

import gc
import logging
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)


def live_tensors():
    """The live tensors of this process, found through the garbage collector
    (none before torch is imported)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return
    for obj in gc.get_objects():
        try:
            if issubclass(type(obj), torch.Tensor) and not obj.is_meta:
                yield obj
        except Exception as e:  # a half-built object mid-collection
            log.debug("live tensor %r unreadable: %s", type(obj), e)


def _live_stats() -> Dict[str, float]:
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats()
        return {"count": int(stats.get("active.all.current", 0)),
                "bytes": float(stats.get("allocated_bytes.all.current", 0))}
    n = 0
    nbytes = 0
    for t in live_tensors():
        n += 1
        nbytes += t.numel() * t.element_size()
    return {"count": n, "bytes": float(nbytes)}


class LiveBufferMonitor:
    """Detect monotonic device-buffer growth across training steps.

    Usage::

        mon = LiveBufferMonitor(warn_after=20)
        for step in ...:
            train_step(...)
            mon.tick()
        mon.assert_no_leak()

    A steady-state training loop's live-buffer count oscillates but does
    not grow; ``warn_after`` consecutive strictly-increasing ticks trips
    the leak verdict (the reference's workspace close-validation analog).
    """

    def __init__(self, warn_after: int = 20):
        self.warn_after = warn_after
        self.history: List[Dict[str, float]] = []
        self._grew = 0
        self.leak_detected = False

    def tick(self) -> Dict[str, float]:
        s = _live_stats()
        if self.history and s["count"] > self.history[-1]["count"]:
            self._grew += 1
            if self._grew >= self.warn_after:
                self.leak_detected = True
                import warnings

                warnings.warn(
                    f"LiveBufferMonitor: device buffer count grew for "
                    f"{self._grew} consecutive ticks "
                    f"({self.history[0]['count']} -> {s['count']}; "
                    f"{s['bytes'] / 1e6:.1f} MB live) — a reference is "
                    "retaining per-step tensors", stacklevel=2)
        else:
            self._grew = 0
        self.history.append(s)
        return s

    def assert_no_leak(self):
        if self.leak_detected:
            raise AssertionError(
                "device-buffer leak: live buffer count grew monotonically "
                f"across {self.warn_after}+ steps "
                f"({self.history[0]['count']} -> {self.history[-1]['count']})")


def named_tensors(tree, path: str = "", out: Optional[List[Tuple[str, object]]] = None
                  ) -> List[Tuple[str, object]]:
    """(path, tensor) of every tensor in nested dicts, lists, tuples and
    modules (a module's parameters and buffers)."""
    torch = sys.modules["torch"]
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append((path, tree))
    elif isinstance(tree, torch.nn.Module):
        for name, t in tree.named_parameters():
            out.append((f"{path}.{name}", t))
        for name, t in tree.named_buffers():
            out.append((f"{path}.{name}", t))
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            named_tensors(tree[k], f"{path}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            named_tensors(t, f"{path}[{i}]", out)
    return out


def _placement(trees: Dict[str, object]) -> Dict[str, Tuple[int, int]]:
    return {path: (id(t), t.untyped_storage().data_ptr())
            for name, tree in trees.items() for path, t in named_tensors(tree, name)}


def donation_guard(step_fn, donate_argnums: Sequence[int] = (),
                   state: Optional[Callable[[], Dict[str, object]]] = None):
    """Wrap a step that updates its state in place: after each call, assert
    that every state tensor — the tensors of the arguments at
    ``donate_argnums`` (the JAX package's argument) and of the named trees
    ``state()`` returns (a network's parameters, updater and BN state) — is
    the same tensor on the same storage as before the call. A replaced
    tensor means the step allocated a second copy of the state, and the old
    one survives wherever it is still referenced (device memory held twice).

    Returns the wrapped callable; the check is host bookkeeping after the
    call (no device read)."""

    def trees(args) -> Dict[str, object]:
        out = {f"arg{i}": args[i] for i in donate_argnums}
        if state is not None:
            out.update(state())
        return out

    def wrapped(*args, **kwargs):
        before = _placement(trees(args))
        out = step_fn(*args, **kwargs)
        after = _placement(trees(args))
        survivors = sorted(p for p in set(before) | set(after)
                           if before.get(p) != after.get(p))
        if survivors:
            raise AssertionError(
                "in-place update misuse: the step replaced state tensors instead "
                "of updating them in place (the old copies may still be held): "
                + ", ".join(survivors[:8])
                + (f" … +{len(survivors) - 8} more" if len(survivors) > 8 else ""))
        return out

    return wrapped


def buffers_debug_enabled() -> bool:
    return os.environ.get("TDL_DEBUG_BUFFERS") == "1"
