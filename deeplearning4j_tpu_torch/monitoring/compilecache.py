"""Compile-cache hit/miss metrics, attributed per function (counterpart of
the JAX package's ``monitoring/compilecache.py``).

The port's persistent compile cache is the kernel build directory under
``TDL_COMPILE_CACHE_DIR`` (``common.compile_cache``, ``kernels/_build.py``).
The kernel build reports, once per library and process, what it found:

- a **hit**: the library was found built in the cache directory (a replica
  that loads what another process built) — nothing compiles;
- a **miss**: the library was built by nvcc (and written into the cache).

Both count only while the cache is enabled and the monitor installed
(:func:`install`, called by ``common.compile_cache.enable``), attributed
through the same ``note_signature`` thread announcements the
RecompileWatchdog claims (``watchdogs.take_pending_fn`` for hits,
``watchdogs.peek_pending_fn`` for misses: the compile that follows still
claims it). Builds nobody announced land under ``fn="_unattributed"``.

``tdl_compile_cache_bytes`` is the cache directory's size on disk,
refreshed when the monitor is installed and by :func:`stats`.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from . import watchdogs
from .registry import MetricsRegistry, get_registry

log = logging.getLogger(__name__)

_LOCK = threading.Lock()
_INSTALLED = False
_DIR: Optional[str] = None


def cache_metrics(registry: Optional[MetricsRegistry] = None):
    """Get-or-create the compile-cache metric families."""
    r = registry or get_registry()
    hits = r.counter(
        "tdl_compile_cache_hits_total",
        "Kernel libraries found built in the persistent compile cache instead "
        "of running nvcc, attributed to the announcing function",
        labels=("fn",))
    misses = r.counter(
        "tdl_compile_cache_misses_total",
        "Kernel libraries built by nvcc into the persistent compile cache "
        "(first build of these sources on this cache dir)",
        labels=("fn",))
    size = r.gauge(
        "tdl_compile_cache_bytes",
        "On-disk bytes of the persistent compile cache directory")
    return hits, misses, size


def refresh_bytes() -> int:
    """Re-scan the cache directory into ``tdl_compile_cache_bytes``."""
    from ..common import compile_cache

    _, _, size = cache_metrics()
    n = compile_cache.cache_size_bytes(_DIR)
    size.set(n)
    return n


def on_cache_hit() -> None:
    """One kernel library found built in the cache (the kernel build calls
    this, once per library and process)."""
    if not _INSTALLED:
        return
    fn = watchdogs.take_pending_fn() or watchdogs.UNATTRIBUTED
    hits, _, _ = cache_metrics()
    hits.labels(fn).inc()


def on_cache_miss() -> None:
    """One kernel library that nvcc built into the cache: peek the
    announcement (the compile that follows claims it)."""
    if not _INSTALLED:
        return
    fn = watchdogs.peek_pending_fn() or watchdogs.UNATTRIBUTED
    _, misses, _ = cache_metrics()
    misses.labels(fn).inc()


def install(directory: str) -> None:
    """Start counting cache traffic for ``directory`` and announcing
    signatures so hits and misses can be attributed. Called by
    ``common.compile_cache.enable``."""
    global _INSTALLED, _DIR
    with _LOCK:
        _DIR = directory
        # (re-)arm announcements every time: a disable() turned them off
        watchdogs.enable_announcements()
        cache_metrics()  # declare families up front: /metrics shows zeros
        _INSTALLED = True
    refresh_bytes()


def uninstall() -> None:
    """Stop counting (``common.compile_cache.disable``)."""
    global _INSTALLED
    with _LOCK:
        _INSTALLED = False
        watchdogs.disable_announcements()


def stats() -> dict:
    """Point-in-time counters for bench blocks and tests."""
    out = {"dir": _DIR,
           "bytes": refresh_bytes() if _INSTALLED else 0,
           "hits": {}, "misses": {}}
    r = get_registry()
    for key, field in (("tdl_compile_cache_hits_total", "hits"),
                       ("tdl_compile_cache_misses_total", "misses")):
        m = r.get(key)
        if m is None:
            continue
        for s in m.snapshot()["series"]:
            out[field][s["labels"].get("fn", "")] = s["value"]
    return out
