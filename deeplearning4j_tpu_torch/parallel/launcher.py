"""Multi-process launcher and cross-process collectives (the control plane).

Counterpart of ``deeplearning4j_tpu/parallel/launcher.py``, with its env
contract and API. The JAX package joins processes through
``jax.distributed.initialize``; the port through
``torch.distributed.init_process_group`` against rank 0's TCP store:

- :func:`initialize` — one-call worker-side init from the ``TDL_*`` env
  that :func:`launch` sets (``TDL_COORDINATOR``, ``TDL_NUM_PROCESSES``,
  ``TDL_PROCESS_ID``, ``TDL_PLATFORM``; ``TDL_BACKEND`` for the explicit
  gloo-on-the-card mode). The backend is stated, never guessed: ``nccl``
  on the card (the default platform, ``cuda``), ``gloo`` on the CPU
  (``TDL_PLATFORM=cpu``). ``backend="gloo"`` on the card must be asked for:
  it is how several ranks share one card (NCCL refuses two ranks on one
  device), and there the data plane's collectives (all-reduce) run on
  CUDA tensors through gloo.
- :class:`ProcessCollectives` — the host-side ``Collectives`` SPI over
  real process boundaries: pickled objects over a gloo group of their own,
  so under NCCL the control plane never goes through NCCL.
- :func:`launch` / :func:`spawn` / :func:`wait` — the parent-side
  spawner: N workers running ``module:function`` targets.

One deliberate difference: the JAX launcher gives each process
``n_local_devices`` XLA devices; the port runs ONE device per process
(rank r on ``cuda:r``, or the CPU), so ``n_local_devices`` > 1 raises.
"""

from __future__ import annotations

import logging
import os
import re
import socket
import subprocess
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from .collectives import Collectives

log = logging.getLogger(__name__)

_ENV_COORD = "TDL_COORDINATOR"
_ENV_NPROC = "TDL_NUM_PROCESSES"
_ENV_PID = "TDL_PROCESS_ID"
_ENV_LOCAL = "TDL_LOCAL_DEVICES"
_ENV_PLATFORM = "TDL_PLATFORM"
_ENV_BACKEND = "TDL_BACKEND"

_control_group = None


def free_port() -> int:
    """Best-effort free port. Inherently racy: the socket closes before the
    store binds, so a concurrent process can take the port in the gap —
    :func:`launch` treats rank 0's bind failure as retryable."""
    with socket.socket() as s:  # bind-only probe, no network I/O
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# stderr signatures of a rank 0 whose TCP store lost the free_port() race
_BIND_FAILURE_RE = re.compile(
    r"address already in use|EADDRINUSE|failed to bind|bind address|"
    r"server socket has failed to listen|could not start .*coordin",
    re.IGNORECASE)


def coordinator_bind_failed(results: Sequence["WorkerResult"]) -> bool:
    """True when a gang's failure matches the free_port() race: rank 0 (the
    process hosting the store) exited nonzero with a bind signature on
    stderr. Only rank 0 counts: a sibling failing with its own bind-ish
    message is a real worker error."""
    return any(r.rank == 0 and r.returncode != 0
               and _BIND_FAILURE_RE.search(r.stderr or "")
               for r in results)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_devices: Optional[int] = None,
    platform: Optional[str] = None,
    backend: Optional[str] = None,
) -> None:
    """Initialize this process as rank ``process_id`` of a distributed run.

    Arguments default from the ``TDL_*`` env vars :func:`launch` sets, so a
    worker target can just call ``initialize()``. ``platform`` is ``cuda``
    (the default: rank r takes ``cuda:r``, and raises without a card or with
    more ranks than cards under NCCL) or ``cpu``; ``backend`` defaults to
    ``nccl`` on the card and ``gloo`` on the CPU. A gloo group for the
    control plane (:class:`ProcessCollectives`) is created here, on every
    rank in the same order."""
    import torch
    import torch.distributed as dist

    from ..common.device import resolve_device

    global _control_group
    coordinator_address = coordinator_address or os.environ[_ENV_COORD]
    num_processes = int(num_processes or os.environ[_ENV_NPROC])
    process_id = int(process_id if process_id is not None else os.environ[_ENV_PID])
    local_devices = int(local_devices or os.environ.get(_ENV_LOCAL, "1"))
    platform = platform or os.environ.get(_ENV_PLATFORM) or "cuda"
    if local_devices != 1:
        raise ValueError(f"local_devices={local_devices}: the port runs one device per "
                         "process (launch n_processes ranks instead)")
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"TDL_PLATFORM={platform!r}: cuda or cpu")
    backend = backend or os.environ.get(_ENV_BACKEND) or ("nccl" if platform == "cuda"
                                                          else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if platform == "cpu" and backend != "gloo":
        raise ValueError("the CPU platform takes the gloo backend")
    resolve_device(platform)  # the card, or an error: no quiet fallback to the CPU
    if platform == "cuda":
        if backend == "nccl":
            if num_processes > torch.cuda.device_count():
                raise RuntimeError(
                    f"{num_processes} NCCL ranks on {torch.cuda.device_count()} card(s): NCCL "
                    "refuses two ranks on one device (ask for backend='gloo' to share a card)")
            torch.cuda.set_device(process_id)
        else:
            torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _control_group = dist.new_group(backend="gloo")


def local_device():
    """This rank's device: ``cuda:<current device>`` on the card, else the
    CPU (``TDL_PLATFORM=cpu``)."""
    import torch

    if (os.environ.get(_ENV_PLATFORM) or "cuda") == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def shutdown() -> None:
    """Leave the process group (the end of a worker)."""
    import torch.distributed as dist

    global _control_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _control_group = None


class ProcessCollectives(Collectives):
    """Host-side control-plane SPI over real process boundaries: pickled
    objects through ``torch.distributed``'s object collectives on the gloo
    control group that :func:`initialize` made, the production counterpart of
    ``FakeCollectives`` and the transport ``EncodedGradientsAccumulator.
    exchange`` uses between processes."""

    def __init__(self):
        import torch.distributed as dist

        if _control_group is None:
            raise RuntimeError("ProcessCollectives needs launcher.initialize() first")
        self._group = _control_group
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()

    def allgather(self, name: str, value: Any) -> List[Any]:
        import torch.distributed as dist

        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, value, group=self._group)
        return out

    def broadcast(self, name: str, value: Any, root: int = 0) -> Any:
        import torch.distributed as dist

        box = [value]
        dist.broadcast_object_list(box, src=root, group=self._group)
        return box[0]

    def gather(self, name: str, value: Any, root: int = 0):
        vals = self.allgather(name, value)
        return vals if self.rank == root else None

    def barrier(self, name: str) -> None:
        import torch.distributed as dist

        dist.barrier(group=self._group)


@dataclass
class WorkerResult:
    rank: int
    returncode: int
    stdout: str
    stderr: str


def launch(
    target: str,
    n_processes: int,
    n_local_devices: int = 1,
    platform: str = "cuda",
    timeout: float = 600.0,
    extra_env: Optional[Dict[str, str]] = None,
    args: Sequence[str] = (),
    cwd: Optional[str] = None,
    port_attempts: int = 3,
    backend: Optional[str] = None,
) -> List[WorkerResult]:
    """Spawn ``n_processes`` workers each running ``module:function`` (or
    ``/path/file.py:function``) and wait for them.

    The worker entry (this module's ``__main__``) calls :func:`initialize`
    from the ``TDL_*`` env, then the target (no arguments; it reads
    ``sys.argv``/env), then :func:`shutdown`. ``platform`` is the card
    (``cuda``, one card per rank under NCCL) unless the caller asks for the
    CPU; ``backend`` as in :func:`initialize`. A gang whose rank 0 fails to
    bind its store (the ``free_port`` race) is respawned on a fresh port up
    to ``port_attempts`` times."""
    for attempt in range(max(1, port_attempts)):
        procs = spawn(target, n_processes, n_local_devices, platform, extra_env, args, cwd,
                      backend=backend)
        results = wait(procs, timeout=timeout, abort_on_failure=True)
        if not coordinator_bind_failed(results) or attempt == port_attempts - 1:
            return results
        log.warning("store bind failure (port race); respawning gang on a fresh port "
                    "(attempt %d/%d)", attempt + 2, port_attempts)
    return results


def spawn(
    target: str,
    n_processes: int,
    n_local_devices: int = 1,
    platform: str = "cuda",
    extra_env: Optional[Dict[str, str]] = None,
    args: Sequence[str] = (),
    cwd: Optional[str] = None,
    port: Optional[int] = None,
    log_dir: Optional[str] = None,
    backend: Optional[str] = None,
) -> List[subprocess.Popen]:
    """Start the worker processes and return the live Popen handles.

    With ``log_dir`` set, worker stdout/stderr go to ``rank{r}.out/.err``
    files instead of pipes (a long-lived monitor must not have to drain
    pipes)."""
    from ..common.device import resolve_device

    if n_local_devices != 1:
        raise ValueError(f"n_local_devices={n_local_devices}: the port runs one device per "
                         "process")
    resolve_device(platform)  # the card, or an error before any worker starts
    port = port or free_port()
    procs = []
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    for rank in range(n_processes):
        env = dict(os.environ)
        env.update(extra_env or {})
        env[_ENV_COORD] = f"127.0.0.1:{port}"
        env[_ENV_NPROC] = str(n_processes)
        env[_ENV_PID] = str(rank)
        env[_ENV_LOCAL] = str(n_local_devices)
        env[_ENV_PLATFORM] = platform
        if backend:
            env[_ENV_BACKEND] = backend
        else:
            env.pop(_ENV_BACKEND, None)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        if log_dir:
            stdout = open(os.path.join(log_dir, f"rank{rank}.out"), "w")
            stderr = open(os.path.join(log_dir, f"rank{rank}.err"), "w")
        else:
            stdout = stderr = subprocess.PIPE
        proc = subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel.launcher", target, *args],
            env=env, stdout=stdout, stderr=stderr, text=True, cwd=cwd or repo_root)
        if log_dir:
            stdout.close()  # the child holds the fd now
            stderr.close()
            proc.tdl_log_paths = (stdout.name, stderr.name)
        procs.append(proc)
    return procs


def wait(procs: List[subprocess.Popen], timeout: float = 600.0,
         abort_on_failure: bool = False) -> List[WorkerResult]:
    """Wait for the workers, draining every pipe concurrently (a rank
    filling its pipe while another blocks in a collective would otherwise
    deadlock the gang). With ``abort_on_failure``, once a rank exits
    nonzero the others are killed after a short grace: synchronous data
    parallelism cannot survive a lost member."""
    import threading

    results: List[Optional[WorkerResult]] = [None] * len(procs)
    stop = threading.Event()

    def drain(rank: int, p: subprocess.Popen):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            err = (err or "") + "\n[launcher] killed after timeout"
        results[rank] = WorkerResult(rank, p.returncode, out or "", err or "")

    def abort_watch():
        while not stop.wait(0.25):
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                stop.wait(5.0)  # grace: let siblings fail on their own terms
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                return

    threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    if abort_on_failure:
        threads.append(threading.Thread(target=abort_watch, daemon=True))
    for t in threads:
        t.start()
    for t in threads[:len(procs)]:
        t.join(timeout + 30)
    stop.set()
    return [r if r is not None else WorkerResult(i, -1, "", "[launcher] no result")
            for i, r in enumerate(results)]


def _worker_main(argv: Sequence[str]) -> None:
    target = argv[0]
    mod_name, _, fn_name = target.rpartition(":")
    initialize()
    if mod_name.endswith(".py"):  # file target: /path/to/workers.py:fn
        import importlib.util

        spec = importlib.util.spec_from_file_location("_tdl_mp_target", mod_name)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        import importlib

        mod = importlib.import_module(mod_name)
    try:
        getattr(mod, fn_name)()
    finally:
        shutdown()


if __name__ == "__main__":  # worker entry: python -m ...launcher mod:fn [args]
    # through the package's module, not this __main__ copy of it, so that the
    # target's ProcessCollectives sees the control group initialize() made
    from deeplearning4j_tpu_torch.parallel.launcher import _worker_main as main

    main(sys.argv[1:])
