"""Persistent tile table of the flash forward kernel, measured on the card.

Counterpart of ``deeplearning4j_tpu/kernels/autotune.py``. The forward
kernel (``csrc/flash_fwd.cu``) takes its q-tile height at launch: 32, 64 or
128 rows in bfloat16, 16 or 32 in float32 (``FWD_Q_ROWS``). Every kernel's
k-tile is 64 keys (``BLOCK_K``), and the two backward kernels have one tile
(64 rows), so the search times the forward. Three pieces, as in the JAX
package:

- :func:`resolve_blocks`, what ``flash_attention`` asks when the caller
  names no tile: a measured entry for this (op, shape bucket, dtype) wins,
  else the static table (:func:`static_flash_blocks`). It runs on every
  attention call (12 per request, prefill and train step, 24 per remat
  step), so each table memoises its answer per exact shape, and a repeated
  call costs a dict lookup and a counter increment.
- :class:`AutotuneTable`, the JSON file of winners
  (``autotune_cuda.json`` under ``$TDL_AUTOTUNE_DIR``, else the kernels'
  build directory). The JAX package keys its table per backend so that a
  TPU table never reaches a GPU; here the backend is always ``cuda`` and
  the file also records the card's name: a table written on another card
  is ignored on load, with a log line, as a corrupt one is.
- :func:`autotune_flash_attention`, the measured search: every candidate
  height is timed with CUDA events after warm-up, best of N, and a winner
  slower than the static choice is discarded (the regression guard). On
  the CPU it records the static choice unmeasured (``measured: false``),
  as the JAX package does in interpret mode. One deliberate difference:
  the JAX search skips a candidate whose launch raises; here every
  candidate that :func:`candidate_valid` admits must launch, and a launch
  error raises (a failed CUDA launch can poison the context, and a skipped
  tile would hide a kernel fault).

Shape keys keep the JAX format, with one deliberate difference: sequence
lengths bucket from 16, not from 128, so the port's 32- and 64-token
prefill buckets get entries of their own. As in the JAX package, the key
holds no causal flag.

The lookup counters of the JAX package's metrics registry
(``tdl_autotune_lookups_total{op,source}``, ``tdl_autotune_table_entries``,
``tdl_autotune_trials_total{op}``) are plain module counters in
``METRICS``: the port has no metrics registry yet.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..common.bucketing import bucket_size
from ..common.device import DEFAULT_DEVICE, resolve_device
from . import _build

log = logging.getLogger(__name__)

ENV_DIR = "TDL_AUTOTUNE_DIR"
OP = "flash_attention"
BACKEND = "cuda"  # the table's backend key: the port's kernels run on CUDA only

#: keys per k-tile of every kernel (``kBlockK`` in csrc/flash_fwd.cu,
#: ``kBlock`` in csrc/flash_bwd.cu): the only block_k there is
BLOCK_K = 64
#: the forward's q-tile heights, by input dtype (its instantiations)
FWD_Q_ROWS: Dict[str, Tuple[int, ...]] = {"bfloat16": (32, 64, 128), "float32": (16, 32)}
#: the candidate (block_q, block_k) grid of the search, by dtype
FLASH_CANDIDATES: Dict[str, Tuple[Tuple[int, int], ...]] = {
    dt: tuple((rows, BLOCK_K) for rows in heights) for dt, heights in FWD_Q_ROWS.items()}

#: SMs of an H100 SXM: the static rule's answer where no card is asked
H100_SMS = 132
#: dynamic shared memory a block may opt in to on an H100
#: (``cudaDevAttrMaxSharedMemoryPerBlockOptin``, 227 KB), where no card is asked
H100_SMEM_OPTIN_BYTES = 232448

#: counters of the JAX package's registry families, by name
METRICS = {"tdl_autotune_lookups_total": Counter(), "tdl_autotune_table_entries": 0,
           "tdl_autotune_trials_total": Counter()}


_DTYPE_NAMES: Dict[torch.dtype, str] = {}


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the dtype's name in table keys."""
    name = _DTYPE_NAMES.get(dtype)
    if name is None:
        name = _DTYPE_NAMES[dtype] = str(dtype).rsplit(".", 1)[-1]
    return name


# ------------------------------------------------------------ static table


def f32_q_rows(batch_heads: int, Tq: int, sms: int) -> int:
    """The float32 forward's q-tile rows when the launch names none
    (``f32_row_groups`` in csrc/flash_fwd.cu): 32 where 32-row tiles still
    give every SM two blocks, else 16 (more blocks at batch 1)."""
    return 32 if -(-Tq // 32) * batch_heads >= 2 * sms else 16


def static_flash_blocks(Tq: int, Tk: int, dtype: str = "bfloat16", *, batch_heads: int = 1,
                        sms: int = H100_SMS) -> Tuple[int, int]:
    """The static (block_q, block_k) table, measured on an H100 (not the
    TPU's 128 x 128 and (512, 1024) of the JAX package):

    - bfloat16: 64-row q-tiles, the fastest height or within 3% of it at
      the serving, training and causal 512-token prefill shapes (PERF.md
      §6, the q-tile table; 128 and 32 rows lose 24-30% at the training
      shape);
    - float32: the kernel's own rule (:func:`f32_q_rows`; PERF.md §6: 16
      rows win at every causal prefill bucket of one sequence): 32 rows
      where that still gives every SM two blocks, else 16;
    - block_k: 64, the k-tile of every kernel.
    """
    if dtype == "bfloat16":
        return 64, BLOCK_K
    return f32_q_rows(batch_heads, Tq, sms), BLOCK_K


def fwd_smem_bytes(block_q: int, D: int, dtype: str) -> int:
    """Dynamic shared memory of one forward block: the kernel's own formula
    (``bf16_smem_bytes``, ``f32_smem_bytes`` in csrc/flash_fwd.cu)."""
    if dtype == "bfloat16":
        return (block_q + 4 * BLOCK_K) * (D + 8) * 2 + 2 * BLOCK_K * 4
    row_groups = block_q // 16
    q_in_registers = D <= 64 and row_groups == 1
    return (4 * BLOCK_K + (0 if q_in_registers else block_q)) * (D + 4) * 4 + 2 * BLOCK_K * 4


def candidate_valid(block_q: int, block_k: int, Tq: int, Tk: int, D: int,
                    dtype: str = "bfloat16", smem_limit: int = H100_SMEM_OPTIN_BYTES) -> bool:
    """A candidate is searchable when the kernel has it (a q-tile height of
    ``FWD_Q_ROWS``, block_k 64), its q-tile does not exceed the bucketed Tq
    (a taller tile would mostly hold rows past the end), and its dynamic
    shared memory fits the device's opt-in limit (the Hopper budget in place
    of the JAX package's VMEM budget)."""
    if block_k != BLOCK_K or block_q not in FWD_Q_ROWS.get(dtype, ()):
        return False
    if block_q > bucket_size(Tq, min_bucket=16):
        return False
    return fwd_smem_bytes(block_q, D, dtype) <= smem_limit


def shape_key(op: str, *, B: int, H: int, Tq: int, Tk: int, D: int, dtype: str) -> str:
    """Per-(op, shape bucket, dtype) table key: B*H and both lengths bucket
    to powers of two, the lengths from 16 (the JAX package's from 128)."""
    bh = bucket_size(max(1, B * H))
    tq = bucket_size(Tq, min_bucket=16)
    tk = bucket_size(Tk, min_bucket=16)
    return f"{op}|bh{bh}|tq{tq}|tk{tk}|d{D}|{dtype}"


def _usable(entry, dtype: str) -> bool:
    return (isinstance(entry, dict) and entry.get("block_k") == BLOCK_K
            and entry.get("block_q") in FWD_Q_ROWS.get(dtype, ()))


# --------------------------------------------------------------- the table


def current_device_name() -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


def _durable_replace(tmp: str, path: str) -> None:
    """Rename ``tmp`` over ``path`` after flushing its bytes, then flush the
    directory: readers never see a torn file, and the rename survives a
    power loss."""
    os.replace(tmp, path)
    fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class AutotuneTable:
    """Persistent per-card winner table.

    On-disk format (``autotune_cuda.json``, written by tmp + rename)::

        {"version": 1, "backend": "cuda", "device": "NVIDIA H100 80GB HBM3",
         "entries": {"flash_attention|bh16|tq512|tk512|d64|bfloat16":
                     {"block_q": 64, "block_k": 64, "measured": true,
                      "best_us": 22.4, "static_us": 22.4, "trials": 20,
                      "candidates_us": {"32": 23.7, "64": 22.4, "128": 29.6}}}}

    A missing, corrupt or other-card file gives an empty table (the static
    table answers every lookup), never an exception on the hot path.
    """

    VERSION = 1

    def __init__(self, path: Optional[str] = None, device: Optional[str] = None):
        self.device = device if device is not None else current_device_name()
        self.path = path
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = {}
        self._memo: Dict[tuple, Tuple[int, int, str]] = {}
        if path:
            self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return
        except (OSError, ValueError) as e:
            log.warning("autotune table %s unreadable (%s): starting empty", self.path, e)
            return
        if not (isinstance(data, dict) and data.get("version") == self.VERSION
                and isinstance(data.get("entries"), dict)):
            log.warning("autotune table %s has no version-%d entries: starting empty",
                        self.path, self.VERSION)
        elif (data.get("backend"), data.get("device")) != (BACKEND, self.device):
            log.warning("autotune table %s is for %r on %r, not %r on %r: starting empty",
                        self.path, data.get("backend"), data.get("device"), BACKEND,
                        self.device)
        else:
            self._entries = {k: v for k, v in data["entries"].items() if isinstance(v, dict)}

    def save(self) -> None:
        if not self.path:
            return
        with self._lock:
            payload = {"version": self.VERSION, "backend": BACKEND,
                       "device": self.device, "entries": dict(self._entries)}
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".autotune_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            _durable_replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def lookup(self, key: str) -> Optional[dict]:
        with self._lock:
            e = self._entries.get(key)
            return dict(e) if e else None

    def record(self, key: str, entry: dict, persist: bool = True) -> None:
        with self._lock:
            self._entries[key] = dict(entry)
            self._memo.clear()
            n = len(self._entries)
        if self is _DEFAULT_TABLE:
            METRICS["tdl_autotune_table_entries"] = n
        if persist:
            self.save()

    def resolve(self, op: str, B: int, H: int, Tq: int, Tk: int, D: int, dtype: str,
                sms: int) -> Tuple[int, int, str]:
        """(block_q, block_k, source) for one exact shape: a usable entry of
        its bucket (``"table"``) or the static table (``"static"``),
        memoised until the next :meth:`record`."""
        memo_key = (op, B, H, Tq, Tk, D, dtype, sms)
        hit = self._memo.get(memo_key)
        if hit is None:
            entry = self.lookup(shape_key(op, B=B, H=H, Tq=Tq, Tk=Tk, D=D, dtype=dtype))
            if _usable(entry, dtype):
                hit = (int(entry["block_q"]), int(entry["block_k"]), "table")
            else:
                hit = (*static_flash_blocks(Tq, Tk, dtype, batch_heads=B * H, sms=sms),
                       "static")
            with self._lock:
                self._memo[memo_key] = hit
        return hit

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_DEFAULT_TABLE: Optional[AutotuneTable] = None
_TABLE_LOCK = threading.Lock()


def default_table_path() -> str:
    """``$TDL_AUTOTUNE_DIR/autotune_cuda.json``, else the same file in the
    kernels' build directory (``kernels/_build.py`` ``build_dir()``), so the
    tiles are found beside the libraries they were measured with. The JAX
    package's compile-cache directory is its own and is not read."""
    d = os.environ.get(ENV_DIR) or str(_build.build_dir())
    return os.path.join(d, "autotune_cuda.json")


def get_table(refresh: bool = False) -> AutotuneTable:
    """The process-default table, at :func:`default_table_path`.

    The path is read from the environment when the table is made, and again
    only after :func:`reset_table` (or with ``refresh``). The JAX package
    reads it on every lookup; here a lookup comes with every attention call,
    and reading the two variables would cost more than the rest of it."""
    global _DEFAULT_TABLE
    table = _DEFAULT_TABLE
    if table is not None and not refresh:
        return table
    with _TABLE_LOCK:
        if _DEFAULT_TABLE is None or refresh:
            _DEFAULT_TABLE = AutotuneTable(default_table_path())
            METRICS["tdl_autotune_table_entries"] = len(_DEFAULT_TABLE)
        return _DEFAULT_TABLE


def reset_table() -> None:
    """Drop the cached default table: the next lookup loads it again, from
    the path the environment names then."""
    global _DEFAULT_TABLE
    with _TABLE_LOCK:
        _DEFAULT_TABLE = None


# ----------------------------------------------------------------- resolve

_SMS: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once per device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def smem_optin_bytes(device: torch.device) -> int:
    """Dynamic shared memory a block may opt in to on a CUDA device
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``, asked of the kernel
    library)."""
    import ctypes

    fn = _build.library("flash_fwd").tdl_smem_optin_bytes
    fn.argtypes, fn.restype = [], ctypes.c_int
    with torch.cuda.device(device):
        n = fn()
    if n <= 0:
        raise RuntimeError(f"cannot query the shared memory limit of {device}")
    return n


def resolve_blocks(op: str, *, B: int, H: int, Tq: int, Tk: int, D: int, dtype: str,
                   table: Optional[AutotuneTable] = None, sms: int = H100_SMS
                   ) -> Tuple[int, int]:
    """The kernel's front door: the measured winner for this (op, shape
    bucket, dtype) if the table has one, else the static table (whose
    float32 rule counts ``sms`` SMs)."""
    t = table if table is not None else get_table()
    block_q, block_k, source = t.resolve(op, B, H, Tq, Tk, D, dtype, sms)
    METRICS["tdl_autotune_lookups_total"][(op, source)] += 1
    return block_q, block_k


# ------------------------------------------------------------------ search

WARMUP = 3  # untimed runs of each candidate before its timed ones
# spin queued before the timed runs (~25 ms at the H100's clock): the card
# is then still busy while the host queues them, so the events time the work
# on the card and not the host's launch cost
_SPIN_CYCLES = 50_000_000


def _time_best_of(fn, *, trials: int) -> float:
    """Best-of-``trials`` device seconds of ``fn`` (CUDA events), after
    ``WARMUP`` runs that are not timed."""
    for _ in range(WARMUP):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(trials)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(trials)]
    torch.cuda.synchronize()
    torch.cuda._sleep(_SPIN_CYCLES)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return min(s.elapsed_time(e) for s, e in zip(starts, ends)) / 1e3


def _measure(B: int, H: int, T: int, D: int, dtype: torch.dtype, causal: bool, cands,
             static: Tuple[int, int], trials: int, include_backward: bool,
             device: torch.device) -> dict:
    """Time every candidate at one shape; the fastest wins unless it is
    slower than the static choice (the regression guard). A launch error
    raises."""
    from .attention import flash_attention

    rs = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rs.randn(B, H, T, D).astype(np.float32)).to(device, dtype)
                   for _ in range(4))

    def run_for(bq, bk):
        if include_backward:
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            return lambda: torch.autograd.grad(
                flash_attention(qg, kg, vg, causal=causal, block_q=bq, block_k=bk),
                (qg, kg, vg), do)
        return lambda: flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)

    timings: Dict[Tuple[int, int], float] = {}
    for bq, bk in cands:
        timings[(bq, bk)] = _time_best_of(run_for(bq, bk), trials=trials)
        METRICS["tdl_autotune_trials_total"][OP] += trials
    static_s = timings[static]
    best = min(timings, key=timings.get)
    if timings[best] > static_s:
        best = static  # a noisy "winner" slower than the static choice
    return {"block_q": best[0], "block_k": best[1], "measured": True,
            "best_us": round(timings[best] * 1e6, 3), "static_us": round(static_s * 1e6, 3),
            "trials": trials,
            "candidates_us": {str(bq): round(s * 1e6, 3) for (bq, _), s in timings.items()}}


def autotune_flash_attention(B: int, H: int, T: int, D: int, dtype=torch.bfloat16, *,
                             causal: bool = False, trials: int = 20, candidates=None,
                             table: Optional[AutotuneTable] = None, device=DEFAULT_DEVICE,
                             include_backward: bool = False,
                             persist: bool = True) -> dict:
    """Measure the forward kernel's q-tile candidates at one (shape, dtype)
    point, record the winner in ``table`` (the process default if None)
    and return the entry.

    The backward kernels have one tile (64 rows), so by default the search
    times the forward alone; ``include_backward=True`` times forward plus
    backward with each forward candidate (the backward's own cost is then
    the same in every candidate). On the CPU nothing is timed: the static
    choice is recorded with ``measured: false``."""
    dev = resolve_device(device)
    dt = dtype_name(dtype)
    if dt not in FWD_Q_ROWS:
        raise TypeError(f"the flash kernels take float32 or bfloat16, not {dtype}")
    t = table if table is not None else get_table()
    key = shape_key(OP, B=B, H=H, Tq=T, Tk=T, D=D, dtype=dt)
    if dev.type != "cuda":
        bq, bk = static_flash_blocks(T, T, dt, batch_heads=B * H)
        entry = {"block_q": bq, "block_k": bk, "measured": False,
                 "source": "static-fallback", "trials": 0}
    else:
        limit = smem_optin_bytes(dev)
        static = static_flash_blocks(T, T, dt, batch_heads=B * H, sms=sm_count(dev))
        cands = [tuple(c) for c in (candidates or FLASH_CANDIDATES[dt])
                 if candidate_valid(c[0], c[1], T, T, D, dt, limit)]
        if static not in cands:
            cands.append(static)
        entry = _measure(B, H, T, D, dtype, causal, cands, static, trials, include_backward,
                         dev)
    t.record(key, entry, persist=persist)
    return entry
