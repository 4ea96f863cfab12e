"""Host-side op profiling of the port (counterpart of the JAX package's
``ops``: its ``profiler``; ``executioner.py`` is not ported yet, ROADMAP.md
queue 1 item 8.8)."""

from .profiler import OpProfiler, ProfileAnalyzer, ProfilerConfig

__all__ = ["OpProfiler", "ProfileAnalyzer", "ProfilerConfig"]
