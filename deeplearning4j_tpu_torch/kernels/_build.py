"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``*.cu`` under ``deeplearning4j_tpu_torch/csrc/`` becomes one shared
library with a plain C interface (no source includes PyTorch's headers, so
a build takes seconds rather than minutes). All sources compile at once, one
``nvcc`` process each. A library is named after its source and a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded from the build directory.

The build directory is ``<dir>/kernels`` while the compile cache is enabled
(``common.compile_cache``, ``TDL_COMPILE_CACHE_DIR``: the replicas of a
serving pool share one build), else ``$TDL_TORCH_BUILD_DIR``, else
``build/kernels/`` beside the package (listed in ``.gitignore``). Nothing
is built when a module is imported: the first launch builds. A failed build
raises. Each library built is one compile to ``monitoring.watchdogs`` (its
seconds the build's wall time); with the compile cache enabled, each
library is also, once per process, a cache hit (found built) or a miss
(built) to ``monitoring.compilecache``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

from ..common import compile_cache
from ..monitoring import compilecache, watchdogs

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build did: seconds, the libraries, and nvcc's messages
build_info: Dict[str, object] = {}
# libraries this process has already reported to the compile-cache monitor
_reported: set = set()


def build_dir() -> Path:
    cached = compile_cache.kernel_build_dir()
    if cached is not None:
        return cached
    env = os.environ.get("TDL_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parents[1] / "build" / "kernels"


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "cannot be built on this host")
    return found


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def nvcc_command(nvcc: str, src: Path, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]


def build_all() -> Dict[str, Path]:
    """Compile every source not yet built; returns ``{stem: library path}``.
    nvcc's messages are kept beside each library (``.log``) and, for every
    library, in ``build_info["log"]``."""
    digest = _digest()
    out_dir = build_dir()
    targets = {src.stem: out_dir / f"lib{src.stem}-{digest}.so" for src in sources()}
    todo = [s for s in sources() if not targets[s.stem].is_file()]
    for src in sources():
        if targets[src.stem] not in _reported and src not in todo:
            _reported.add(targets[src.stem])
            compilecache.on_cache_hit()
    t0 = time.perf_counter()
    log = []
    if todo:
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in todo:
            tmp = targets[src.stem].with_suffix(f".{os.getpid()}.tmp")
            procs.append((src, tmp, subprocess.Popen(
                nvcc_command(nvcc, src, tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, tmp, proc in procs:
            output, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{output}")
            else:
                targets[src.stem].with_suffix(".log").write_text(output)
                os.replace(tmp, targets[src.stem])
                # per library, the JAX package's event order: the cache miss
                # peeks the announcement, the compile claims it
                _reported.add(targets[src.stem])
                compilecache.on_cache_miss()
                watchdogs.note_compile(time.perf_counter() - t0)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for stem, lib in targets.items():
        messages = lib.with_suffix(".log")
        log.append(f"== {stem}.cu\n{messages.read_text() if messages.is_file() else ''}")
    build_info.update(seconds=time.perf_counter() - t0, built=[s.name for s in todo],
                      libraries={k: str(v) for k, v in targets.items()},
                      log="\n".join(log))
    return targets


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            path = build_all()[stem]
            lib = _libs[stem] = ctypes.CDLL(str(path))
        return lib
