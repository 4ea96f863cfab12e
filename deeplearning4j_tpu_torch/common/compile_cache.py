"""Persistent compiled-kernel cache: the port's ``TDL_COMPILE_CACHE_DIR``.

The JAX package keeps serialized XLA executables under this directory. The
port has no executable cache: its persistent compiled artefact is the nvcc
build of ``csrc/*.cu`` (``kernels/_build.py``). So here the same env
contract and the same API point the kernel build directory under the cache
directory (``<dir>/kernels``):

- ``TDL_COMPILE_CACHE_DIR`` — set by ``ServingPool`` as one stable
  ``workdir/compile_cache`` for every replica (the caller's own value wins),
  and by the serving builder (``JsonModelServer.Builder.compile_cache_dir``);
  any process may also export it directly.

The first replica of a pool builds the kernels there; a respawned or
scaled-up replica finds the libraries built and loads them without running
nvcc. Concurrent builds are safe: each build writes a per-process temporary
file and renames it into place. An explicit ``enable()`` wins over the env
contract, as in the JAX package. Kernel libraries already loaded by this
process stay loaded: the setting decides where the next build goes.
``enable`` installs ``monitoring.compilecache``: the build's hits (a library
found built here) and misses (an nvcc build) count per function.
"""

from __future__ import annotations

import logging
import os
import threading
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

ENV_DIR = "TDL_COMPILE_CACHE_DIR"

_lock = threading.Lock()
_enabled_dir: Optional[str] = None


def enable(directory: str) -> str:
    """Build and load the kernels under ``directory`` (created if missing).
    Idempotent; a second call with a DIFFERENT directory re-points the
    cache and logs the switch."""
    global _enabled_dir
    directory = os.path.abspath(directory)
    with _lock:
        if _enabled_dir == directory:
            return directory
        os.makedirs(directory, exist_ok=True)
        if _enabled_dir is not None:
            log.info("compile cache re-pointed %s -> %s",
                     _enabled_dir, directory)
        _enabled_dir = directory
    from ..monitoring import compilecache

    compilecache.install(directory)
    return directory


def maybe_enable_from_env() -> Optional[str]:
    """Enable the cache iff ``TDL_COMPILE_CACHE_DIR`` is set and no explicit
    :func:`enable` came first. Called from the serving entry points before
    their warm-up launches a kernel; one env lookup when unset."""
    directory = os.environ.get(ENV_DIR)
    if not directory or _enabled_dir is not None:
        return _enabled_dir
    return enable(directory)


def disable() -> None:
    """Stop using the cache directory: the next build goes to the default
    build directory again (tests point the cache at a temporary directory
    and must reset it)."""
    global _enabled_dir
    with _lock:
        _enabled_dir = None
    from ..monitoring import compilecache

    compilecache.uninstall()


def cache_dir() -> Optional[str]:
    """The enabled cache directory, or None."""
    return _enabled_dir


def enabled() -> bool:
    return _enabled_dir is not None


def kernel_build_dir() -> Optional[Path]:
    """Where ``kernels/_build.py`` builds while the cache is enabled."""
    return Path(_enabled_dir) / "kernels" if _enabled_dir else None


def cache_size_bytes(directory: Optional[str] = None) -> int:
    """Total bytes of files under the cache directory (the built kernel
    libraries and their nvcc logs)."""
    directory = directory or _enabled_dir
    if not directory:
        return 0
    total = 0
    for root, _, files in os.walk(directory):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                continue
    return total
