"""Heartbeat files — the worker-side half of pool and gang supervision
(copy of the JAX package's ``monitoring.heartbeat``; the files read the same
to either package's supervisor).

Each replica of a ``ServingPool`` (and each rank of a supervised gang)
writes ``hb_rank{r}.json`` (iteration, pid, wall time) into
``TDL_HEARTBEAT_DIR``; the supervisor polls the files and treats a stale
mtime as a hung process. File mtime (not the embedded timestamp) carries
liveness, so supervisor and worker need no clock agreement beyond sharing a
filesystem.

Writes are atomic (tmp + rename) so the supervisor never reads a torn file,
and throttled by ``TDL_HEARTBEAT_INTERVAL`` seconds so production steps are
not taxed with an fsync per iteration.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional, Tuple

log = logging.getLogger(__name__)

ENV_DIR = "TDL_HEARTBEAT_DIR"
ENV_INTERVAL = "TDL_HEARTBEAT_INTERVAL"


def host_rss_bytes() -> int:
    """Current resident set size of this process, in bytes (copy of the JAX
    package's ``monitoring.watchdogs.host_rss_bytes``)."""
    try:  # /proc gives CURRENT rss; getrusage only gives the peak
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        import resource

        # ru_maxrss is KB on Linux but BYTES on macOS (the only platform
        # that actually reaches this fallback — no /proc there)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return rss if sys.platform == "darwin" else rss * 1024


def sample_memory(registry=None) -> Dict[str, int]:
    """Memory telemetry piggybacked on the heartbeat cadence: host RSS plus
    — when torch is already imported and CUDA already initialised — the
    caching allocator's ``torch.cuda.memory_stats()`` into the
    ``tdl_mem_*`` gauges. Never imports torch or initialises CUDA itself
    (a process with no card must not pay for a heartbeat), and never raises:
    memory numbers are telemetry, not control flow. Returns {label: bytes}
    for what it sampled.

    It reads the allocator's own counters and nothing else: no
    ``torch.cuda.mem_get_info``, a CUDA API call that is not
    allowed while another thread of the process captures a CUDA graph (the
    paged decode pool captures its step on the serving executor's thread)."""
    from .registry import get_registry  # lazy: keep import-time deps flat

    reg = registry if registry is not None else get_registry()
    out: Dict[str, int] = {}
    try:
        rss = int(host_rss_bytes())
        reg.gauge("tdl_mem_host_rss_bytes",
                  "Resident set size of this process (VmRSS; getrusage "
                  "high-water fallback where /proc is absent)").set(rss)
        out["host_rss"] = rss
    except Exception:
        log.debug("host RSS sampling failed", exc_info=True)
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return out
    try:
        in_use_g = reg.gauge(
            "tdl_mem_device_bytes_in_use",
            "Device memory currently allocated (torch.cuda.memory_stats, "
            "sampled each heartbeat write)", labels=("device",))
        peak_g = reg.gauge(
            "tdl_mem_device_peak_bytes",
            "Backend-reported peak device memory since process start",
            labels=("device",))
        index = torch.cuda.current_device()
        stats = torch.cuda.memory_stats(index)
        label = f"cuda:{index}"
        in_use = int(stats.get("allocated_bytes.all.current", 0))
        in_use_g.labels(label).set(in_use)
        out[label] = in_use
        peak_g.labels(label).set(int(stats.get("allocated_bytes.all.peak", 0)))
    except Exception:
        log.debug("device memory sampling failed", exc_info=True)
    return out


def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"hb_rank{rank}.json")


class HeartbeatWriter:
    def __init__(self, directory: str, rank: int, interval: float = 1.0):
        self.path = heartbeat_path(directory, rank)
        self.rank = rank
        self.interval = max(0.0, float(interval))
        self._last_write = 0.0
        self.iteration = -1
        os.makedirs(directory, exist_ok=True)

    def beat(self, iteration: int) -> bool:
        """Record progress; returns True if a file write happened."""
        now = time.monotonic()
        if self._last_write and now - self._last_write < self.interval:
            self.iteration = int(iteration)
            return False
        self._last_write = now
        self.iteration = int(iteration)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"iteration": int(iteration), "pid": os.getpid(),
                       "time": time.time()}, f)  # wallclock-ok: embedded event timestamp; liveness rides file mtime
        os.replace(tmp, self.path)
        from . import flight  # lazy: flight imports nothing from here

        flight.record("heartbeat", iteration=int(iteration), rank=self.rank)
        # memory gauges ride the SAME throttle — one sample per actual
        # heartbeat write, zero extra cost on suppressed beats
        sample_memory()
        return True


def read_heartbeat(directory: str, rank: int) -> Optional[Tuple[int, float]]:
    """(iteration, mtime) of rank's heartbeat, or None before the first beat.
    A beat mid-replace or half-written legacy file reads as None — the
    supervisor just sees the previous poll's value next round."""
    path = heartbeat_path(directory, rank)
    try:
        mtime = os.path.getmtime(path)
        with open(path) as f:
            data = json.load(f)
        return int(data["iteration"]), mtime
    except (OSError, ValueError, KeyError):
        return None
