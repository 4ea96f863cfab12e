"""Global environment singleton and flag registry.

Counterpart of ``deeplearning4j_tpu/common/environment.py`` (a copy: the
port imports nothing of the JAX package). Every runtime flag lives in one
namespace (``TDL_*``), parsed from the environment when the singleton is
first made and dumpable at once. The port's singleton is its own: setting
a flag here does not touch the JAX package's, nor the other way round.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, fields


@dataclass
class _Flags:
    # name -> (env var, default, parser)
    verbose: bool = False            # TDL_VERBOSE — per-op logging
    debug: bool = False              # TDL_DEBUG — shape/alloc logging
    profiling: bool = False          # TDL_PROFILING — op timing collection
    check_nan: bool = False          # TDL_CHECK_NAN — NaN panic after each op
    check_inf: bool = False          # TDL_CHECK_INF — Inf panic after each op
    default_float: str = "float32"   # TDL_DEFAULT_FLOAT — eager default dtype
    matmul_precision: str = "auto"   # TDL_MATMUL_PRECISION — auto|bf16|float32|tf32
    max_host_threads: int = 0        # TDL_MAX_HOST_THREADS — 0 = auto
    eager_cache_size: int = 4096     # TDL_EAGER_CACHE_SIZE — compiled-op LRU cap
    seed: int = 0                    # TDL_SEED — initial global RNG seed


def _parse(val: str, like):
    if isinstance(like, bool):
        return val.lower() in ("1", "true", "yes", "on")
    return type(like)(val)


class Environment:
    """Process-wide singleton mirroring ``sd::Environment::getInstance()``."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self._flags = _Flags()
        for f in fields(_Flags):
            env_name = "TDL_" + f.name.upper()
            if env_name in os.environ:
                setattr(self._flags, f.name,
                        _parse(os.environ[env_name], getattr(self._flags, f.name)))

    @classmethod
    def get_instance(cls) -> "Environment":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    def __getattr__(self, name):
        try:
            return getattr(self.__dict__["_flags"], name)
        except AttributeError:
            raise AttributeError(name) from None

    def set(self, name: str, value) -> None:
        if not hasattr(self._flags, name):
            raise KeyError(f"unknown flag {name}; known: {self.dump()}")
        setattr(self._flags, name, value)

    def dump(self) -> dict:
        """Every flag and its current value."""
        return {f.name: getattr(self._flags, f.name) for f in fields(_Flags)}


def env() -> Environment:
    return Environment.get_instance()


def host_cpu_count() -> int:
    """CPUs this process may run on: the scheduler affinity mask (what a
    cgroup- or taskset-limited container really has), else
    ``os.cpu_count()`` where affinity is not supported."""
    try:
        n = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # non-Linux / restricted
        n = os.cpu_count() or 1
    return max(1, n)
