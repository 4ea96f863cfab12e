"""Multi-process sharded ETL service.

Counterpart of ``deeplearning4j_tpu/data/etl_service.py``: decode and
augmentation on the host in worker processes, past the GIL, with a
zero-copy hand-off to the consumer. The host logic is a copy:

- **Worker processes** (spawned, crash-isolated): each decodes and augments
  its deterministic part of the batch stream and writes finished uint8 NHWC
  batches in place into a ``multiprocessing.shared_memory`` ring. No batch
  is pickled; besides the pixels only a per-slot int64 sequence number, a
  released counter and (on failure) one traceback string cross processes.
  A worker imports numpy, Pillow and this package's host modules, never
  torch (each ``import torch`` costs a process seconds).
- **Shared-memory batch ring**: S slots; batch ``j`` lives in slot
  ``j % S``. A worker overwrites slot ``s`` for batch ``j`` only once the
  consumer has released batch ``j - S``; the consumer accepts the slot only
  when its sequence header equals ``j`` (written last, after the pixels).
  The consumer hands out numpy VIEWS into the ring, which
  ``DevicePrefetchIterator`` copies (through a pinned buffer) to the card
  before it asks for the next batch. Segments are named ``tdlt_etl_<pid>_``
  (``SHM_PREFIX``), outside the JAX package's ``tdl_`` namespace.
- **Per-rank input sharding**: global batch ``b`` belongs to rank
  ``b % world_size``, a pure function of the spec, so a restarted gang
  replays the same stream (``state()``/``set_state()`` resume mid-stream).
- **Persistent decoded-batch cache**: decoded store-size uint8 batches in a
  memory-mapped file keyed by the dataset's fingerprint and the ETL
  configuration. Epoch 2 on, and restarted gangs, skip the decode;
  augmentation (crop and flip, seeded per (seed, epoch, batch)) stays on
  the fly.

Worker lifecycle: clean shutdown (stop flag, join, then terminate and
kill), detection of a dead worker with a bounded respawn at its next
unpublished position (read from the ring headers), a worker's exception
re-raised with its traceback (sticky until ``reset()``), and the segment
unlinked on every exit path (``close()``, ``reset()``, ``__del__``, the
context manager).

Scope, as in the JAX package: batches are full-size only (a tail shorter
than ``batch_size`` is dropped) and the epoch permutation is fixed across
epochs (re-shuffling would invalidate the cache's layout); epochs differ by
their augmentation.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import sys
import time
import traceback
import uuid
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..common.environment import host_cpu_count
from .dataset import DataSet
from .iterators import DataSetIterator

log = logging.getLogger(__name__)

#: env knob (launcher/supervisor pass-through): worker-pool size override
ENV_WORKERS = "TDL_ETL_WORKERS"

#: prefix of every shm segment this module creates: outside the JAX
#: package's ``tdl_`` (whose test-suite audit unlinks every ``tdl_*``
#: segment of the machine); the port tests' per-process audit keys off it
SHM_PREFIX = "tdlt_etl_"

_POLL_S = 0.001  # producer/consumer ring poll cadence

#: unlinked segments whose mmap couldn't close because a zero-copy batch
#: view was still alive — parked here so SharedMemory.__del__ never runs
#: against exported pointers (pages are freed when the process exits)
_DEFERRED_SHM: List[object] = []


class EtlWorkerError(RuntimeError):
    """An ETL worker process failed; carries the worker's original traceback
    text. Sticky on the consumer until ``reset()``."""

    def __init__(self, worker_id: int, traceback_text: str):
        super().__init__(
            f"ETL worker {worker_id} failed:\n{traceback_text}")
        self.worker_id = worker_id
        self.traceback_text = traceback_text


# ------------------------------------------------------------------ sharding


def shard_batches(num_batches: int, rank: int, world_size: int,
                  equalize: bool = True) -> List[int]:
    """Global batch indices owned by ``rank``: ``b % world_size == rank``.

    Deterministic (a pure function of the arguments), disjoint across ranks
    and — with ``equalize=False`` — union-complete. ``equalize=True`` trims
    every rank to the MINIMUM per-rank count (``num_batches // world_size``)
    so a synchronous gang steps in lockstep; at most ``world_size - 1``
    batches per epoch are dropped.
    """
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world of {world_size}")
    mine = list(range(rank, num_batches, world_size))
    if equalize:
        mine = mine[: num_batches // world_size]
    return mine


# ------------------------------------------------------------------ the spec


_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")


@dataclass(frozen=True)
class ImageEtlSpec:
    """Picklable recipe a worker uses to rebuild its half of the pipeline
    in-process (spawn ships the spec ONCE — metadata, never batch payload).

    The decoded stream is a pure function of the spec: files are decoded at
    ``(height + store_pad, width + store_pad)`` (the cacheable part), then
    augmented per (seed, epoch, batch) to ``(height, width)``. One seeded
    permutation fixes the batch composition for ALL epochs (see module
    docstring for why).
    """

    files: Tuple[str, ...]
    label_ids: Tuple[int, ...]
    num_classes: int
    height: int
    width: int
    channels: int = 3
    store_pad: int = 32
    batch_size: int = 32
    seed: int = 123
    shuffle: bool = True
    augment: bool = True
    flip_p: float = 0.5
    rank: int = 0
    world_size: int = 1
    cache_dir: Optional[str] = None

    # -- construction -------------------------------------------------------

    @classmethod
    def from_directory(cls, root: str, height: int, width: int,
                       batch_size: int, channels: int = 3,
                       num_classes: Optional[int] = None,
                       **kw) -> "ImageEtlSpec":
        """Directory-per-class layout (the ImageNet convention the reference's
        ``ParentPathLabelGenerator`` reads). ``num_classes`` may be LARGER
        than the directory count — labels one-hot into the model's class
        count directly, so no padding wrapper is needed downstream."""
        from .records import FileSplit

        files = tuple(sorted(
            p for p in FileSplit(root).locations()
            if p.lower().endswith(_IMG_EXTS)))
        if not files:
            raise ValueError(f"no image files under {root!r}")
        names = sorted({os.path.basename(os.path.dirname(p)) for p in files})
        idx = {n: i for i, n in enumerate(names)}
        labels = tuple(idx[os.path.basename(os.path.dirname(p))]
                       for p in files)
        n_cls = num_classes if num_classes is not None else len(names)
        if n_cls < len(names):
            raise ValueError(f"num_classes={n_cls} < {len(names)} label dirs")
        return cls(files=files, label_ids=labels, num_classes=n_cls,
                   height=height, width=width, channels=channels,
                   batch_size=batch_size, **kw)

    def for_rank(self, rank: int, world_size: int) -> "ImageEtlSpec":
        return dataclasses.replace(self, rank=rank, world_size=world_size)

    # -- derived geometry ---------------------------------------------------

    @property
    def store_hw(self) -> Tuple[int, int]:
        return self.height + self.store_pad, self.width + self.store_pad

    @property
    def num_batches(self) -> int:
        return len(self.files) // self.batch_size

    def my_batches(self) -> List[int]:
        return shard_batches(self.num_batches, self.rank, self.world_size)

    def order(self) -> np.ndarray:
        """The ONE fixed permutation of file indices (all epochs)."""
        o = np.arange(len(self.files))
        if self.shuffle:
            np.random.RandomState(self.seed).shuffle(o)
        return o

    def fingerprint(self) -> str:
        """Dataset fingerprint + ETL config hash — the decoded-batch cache
        key. Covers everything that changes the DECODED store-size batches:
        file list, geometry, batch composition. Augmentation params stay
        out (augment runs after the cache)."""
        sh, sw = self.store_hw
        payload = "\n".join(self.files) + "|" + ",".join(
            str(v) for v in (sh, sw, self.channels, self.batch_size,
                             self.seed, int(self.shuffle), self.num_classes))
        payload += "|" + ",".join(str(l) for l in self.label_ids)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    # -- worker-side production --------------------------------------------

    def open_cache(self) -> Optional["DecodedBatchCache"]:
        if self.cache_dir is None:
            return None
        sh, sw = self.store_hw
        return DecodedBatchCache(
            self.cache_dir, self.fingerprint(), self.num_batches,
            self.batch_size, sh, sw, self.channels)

    def decode_store_batch(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        """Decode batch ``b``'s files at store size → uint8 [B, Sh, Sw, C]
        + int32 labels [B]. The expensive, cacheable half."""
        from .image import _pil

        Image = _pil()
        sh, sw = self.store_hw
        idxs = self.order()[b * self.batch_size:(b + 1) * self.batch_size]
        out = np.empty((len(idxs), sh, sw, self.channels), np.uint8)
        labels = np.empty(len(idxs), np.int32)
        for i, fi in enumerate(idxs):
            with Image.open(self.files[fi]) as im:
                im = im.convert("RGB" if self.channels == 3 else "L")
                if im.size != (sw, sh):
                    im = im.resize((sw, sh), Image.BILINEAR)
                arr = np.asarray(im)
            out[i] = arr[:, :, None] if arr.ndim == 2 else arr
            labels[i] = self.label_ids[fi]
        return out, labels

    def augment_batch(self, store: np.ndarray, epoch: int,
                      b: int) -> np.ndarray:
        """Store-size → (height, width) via per-image random crop + hflip,
        seeded per (seed, epoch, batch): deterministic under any worker
        assignment AND stochastic across epochs. Inference/eval specs
        (``augment=False``) center-crop with no flip."""
        B, sh, sw, _ = store.shape
        H, W = self.height, self.width
        if self.augment:
            rs = np.random.RandomState(
                (self.seed * 1_000_003 + epoch * 7919 + b) % (1 << 31))
            oy = rs.randint(0, sh - H + 1, B)
            ox = rs.randint(0, sw - W + 1, B)
            fl = rs.rand(B) < self.flip_p
        else:
            oy = np.full(B, (sh - H) // 2)
            ox = np.full(B, (sw - W) // 2)
            fl = np.zeros(B, bool)
        out = np.empty((B, H, W, store.shape[3]), np.uint8)
        for i in range(B):  # one slice-copy per image, the flip fused into it
            win = store[i, oy[i]:oy[i] + H, ox[i]:ox[i] + W]
            out[i] = win[:, ::-1] if fl[i] else win
        return out

    def produce(self, b: int, epoch: int,
                cache: Optional["DecodedBatchCache"]
                ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """One finished batch: (uint8 NHWC [B,H,W,C], int32 labels [B],
        cache_hit). Decode-or-cache, then augment."""
        hit = False
        got = cache.get(b) if cache is not None else None
        if got is not None:
            store, labels = got
            hit = True
        else:
            store, labels = self.decode_store_batch(b)
            if cache is not None:
                cache.put(b, store, labels)
        return self.augment_batch(store, epoch, b), labels, hit


# ---------------------------------------------------- decoded-batch cache


class DecodedBatchCache:
    """Memory-mapped persistent cache of decoded store-size uint8 batches.

    Layout under ``cache_dir/<key>/``: ``meta.json``, ``images.u8``
    ([num_batches, B, Sh, Sw, C] memmap), ``labels.i32``, and ``done.u8``
    (per-batch completion flags, written AFTER the payload so a crash mid-
    write re-decodes instead of serving a torn batch). Batch ``b`` is only
    ever written by its owning rank's owning worker, so writers never
    contend; creation races across ranks are serialized with an O_EXCL lock
    file, losers wait for ``meta.json``.
    """

    def __init__(self, cache_dir: str, key: str, num_batches: int,
                 batch: int, store_h: int, store_w: int, channels: int):
        self.dir = os.path.join(cache_dir, key)
        self.key = key
        self.shape = (num_batches, batch, store_h, store_w, channels)
        self._images: Optional[np.memmap] = None
        self._labels: Optional[np.memmap] = None
        self._done: Optional[np.memmap] = None
        self._ensure()

    _STALE_LOCK_S = 30.0  # a winner holding the lock longer than this died

    def _ensure(self) -> None:
        meta = os.path.join(self.dir, "meta.json")
        lock = os.path.join(self.dir, ".lock")
        deadline = time.monotonic() + 120.0
        while not os.path.exists(meta):
            os.makedirs(self.dir, exist_ok=True)
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                # another process is building: wait for its atomic meta
                # rename — but a winner that DIED mid-build (SIGKILL from a
                # gang teardown) leaves the lock forever; reclaim it once
                # stale so restarts never wedge on a poisoned cache dir
                try:
                    # a file mtime is wall clock
                    if time.time() - os.path.getmtime(lock) > self._STALE_LOCK_S:
                        os.unlink(lock)
                except FileNotFoundError as e:
                    log.debug("cache lock vanished while probing: %s", e)
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"decoded-batch cache never initialized: {self.dir}")
                time.sleep(0.02)
                continue
            try:  # creation winner (re-check: a prior winner may have
                # finished between our exists() check and the open)
                if not os.path.exists(meta):
                    np.memmap(os.path.join(self.dir, "images.u8"), np.uint8,
                              "w+", shape=self.shape).flush()
                    np.memmap(os.path.join(self.dir, "labels.i32"), np.int32,
                              "w+", shape=self.shape[:2]).flush()
                    np.memmap(os.path.join(self.dir, "done.u8"), np.uint8,
                              "w+", shape=(self.shape[0],)).flush()
                    tmp = meta + ".tmp"
                    with open(tmp, "w") as f:
                        json.dump({"key": self.key,
                                   "shape": list(self.shape)}, f)
                    # the meta rename is the cache's commit record: a power
                    # loss after a plain rename could leave a zero-length
                    # "ready" meta vouching for never-synced memmaps
                    # (fsync the bytes, rename, fsync the directory: all
                    # owned by durable_replace)
                    from ..common.durability import durable_replace

                    durable_replace(tmp, meta, fsync=True)
            finally:
                os.close(fd)
                try:
                    os.unlink(lock)  # always released — even on a failed
                    # build, so the next comer can retry instead of wedging
                except FileNotFoundError as e:
                    log.debug("cache lock already reclaimed: %s", e)
        with open(meta) as f:
            m = json.load(f)
        if m.get("key") != self.key or tuple(m.get("shape", ())) != self.shape:
            raise RuntimeError(
                f"decoded-batch cache at {self.dir} holds key "
                f"{m.get('key')!r}/{m.get('shape')}, expected "
                f"{self.key!r}/{list(self.shape)}")
        self._images = np.memmap(os.path.join(self.dir, "images.u8"),
                                 np.uint8, "r+", shape=self.shape)
        self._labels = np.memmap(os.path.join(self.dir, "labels.i32"),
                                 np.int32, "r+", shape=self.shape[:2])
        self._done = np.memmap(os.path.join(self.dir, "done.u8"),
                               np.uint8, "r+", shape=(self.shape[0],))

    def get(self, b: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if not self._done[b]:
            return None
        return np.asarray(self._images[b]), np.asarray(self._labels[b])

    def put(self, b: int, imgs: np.ndarray, labels: np.ndarray) -> None:
        self._images[b] = imgs
        self._labels[b] = labels
        self._done[b] = 1  # flag LAST: torn payload ⇒ flag unset ⇒ re-decode

    def done_count(self) -> int:
        return int(np.count_nonzero(self._done))


# ------------------------------------------------------------------ the ring


class _RingLayout:
    """Geometry of one shm segment: per-slot int64 sequence headers, then
    S feature slots, then S label slots. Pure arithmetic — both sides build
    identical views from (slots, batch, H, W, C)."""

    def __init__(self, slots: int, batch: int, h: int, w: int, c: int):
        self.slots, self.batch = slots, batch
        self.feat_shape = (batch, h, w, c)
        self.feat_bytes = batch * h * w * c
        self.lab_bytes = batch * 4
        self.seq_off = 0
        self.feat_off = 8 * slots
        # 8-byte-align the label region (feat_bytes is arbitrary)
        raw = self.feat_off + slots * self.feat_bytes
        self.lab_off = (raw + 7) & ~7
        self.total = self.lab_off + slots * self.lab_bytes

    def views(self, buf):
        seq = np.frombuffer(buf, np.int64, self.slots, self.seq_off)
        feats = np.frombuffer(
            buf, np.uint8, self.slots * self.feat_bytes, self.feat_off
        ).reshape((self.slots,) + self.feat_shape)
        labs = np.frombuffer(
            buf, np.int32, self.slots * self.batch, self.lab_off
        ).reshape(self.slots, self.batch)
        return seq, feats, labs


def _attach_shm(name: str):
    """Attach an existing segment WITHOUT resource-tracker registration.

    3.10's ``SharedMemory`` registers on ATTACH too (bpo-38119); spawn
    children share the parent's tracker process, whose cache is a set — the
    attach registration collapses into the creator's entry and any
    unregister from a worker would strip it, so the creator's own unlink
    later double-unregisters. Suppressing the attach-side registration
    keeps the books exact: only the creating consumer registers/unlinks."""
    from multiprocessing import resource_tracker, shared_memory

    orig = resource_tracker.register
    resource_tracker.register = (
        lambda n, rtype: None if rtype == "shared_memory"
        else orig(n, rtype))
    try:
        return shared_memory.SharedMemory(name=name)  # attach only: the creator unlinks
    finally:
        resource_tracker.register = orig


# ------------------------------------------------------------------ worker


def _etl_worker(spec: ImageEtlSpec, worker_id: int, num_workers: int,
                start_j: int, shm_name: str, slots: int, consumed, stop,
                err_conn, busy, counters) -> None:
    """Worker-process main: produce stream positions ``j ≡ worker_id (mod
    num_workers)`` from ``start_j`` onward, forever (epochs advance
    implicitly: position ``j`` is batch ``my[j % M]`` of epoch ``j // M``),
    until the stop flag. Exceptions ship as one traceback string over the
    error pipe; the payload path never pickles.

    The stop flag and the released counter are lock-free shared words
    (``lock=False``), and a waiting worker sleeps instead of waiting on an
    ``Event``: a worker killed while it held a ``multiprocessing`` lock, or
    slept on an ``Event``'s condition, would leave the consumer's next
    write or ``Event.set()`` blocked forever (the JAX package's service
    uses both, so its ``close()`` hangs when a worker dies there). The
    consumer is the counter's only writer; a worker reads it."""
    seg = None
    seq = feats = labs = None
    parent = os.getppid()

    def orphaned() -> bool:
        # the consumer died HARD (SIGKILL / os._exit — daemon cleanup never
        # ran): we are reparented. Exit, and best-effort unlink the segment
        # the dead consumer can no longer release (FileNotFoundError = a
        # sibling won the race).
        return os.getppid() != parent

    try:
        layout = _RingLayout(slots, spec.batch_size, spec.height, spec.width,
                             spec.channels)
        seg = _attach_shm(shm_name)
        seq, feats, labs = layout.views(seg.buf)
        cache = spec.open_cache()
        my = spec.my_batches()
        M = len(my)
        j = start_j + (worker_id - start_j) % num_workers
        while not stop.value:
            if orphaned():
                try:
                    seg.unlink()
                except FileNotFoundError as e:
                    log.debug("orphan unlink raced: %s", e)
                return
            if consumed.value < j - slots + 1:  # slot still occupied
                time.sleep(_POLL_S)
                continue
            epoch, pos = divmod(j, M)
            t0 = time.perf_counter()
            imgs, labels, hit = spec.produce(my[pos], epoch, cache)
            busy[worker_id] += time.perf_counter() - t0
            counters[2 * worker_id + (0 if hit else 1)] += 1
            s = j % slots
            feats[s] = imgs
            labs[s] = labels
            seq[s] = j  # publish LAST: header equality == complete payload
            j += num_workers
    except Exception:
        try:
            err_conn.send_bytes(traceback.format_exc().encode())
        except (OSError, ValueError) as e:
            log.debug("ETL worker %d could not report error: %s", worker_id, e)
        sys.exit(1)
    finally:
        del seq, feats, labs
        if seg is not None:
            try:
                seg.close()
            except BufferError as e:  # a live view survived the del (e.g.
                # referenced from an exception frame); park the segment so
                # its __del__ stays quiet — the process is exiting anyway
                log.debug("worker shm close deferred: %s", e)
                _DEFERRED_SHM.append(seg)


# ------------------------------------------------------------------ consumer


class _Worker:
    __slots__ = ("proc", "worker_id", "conn")

    def __init__(self, proc, worker_id, conn):
        self.proc, self.worker_id, self.conn = proc, worker_id, conn


class EtlDataSetIterator(DataSetIterator):
    """DataSetIterator over the multi-process shared-memory ETL service.

    ``next()`` returns uint8 NHWC features + one-hot float32 labels. With
    ``zero_copy=True`` (default) the features are a VIEW into the shm ring,
    valid until the FOLLOWING ``next()`` call — exactly the lifetime
    ``DevicePrefetchIterator`` needs (its worker ``device_put``s the batch
    before requesting the next one). Pass ``zero_copy=False`` for consumers
    that hold batches across steps.

    Lazy start: workers spawn on first ``has_next()``/``next()``. ``close()``
    tears everything down (join → terminate → kill, shm unlink) but keeps
    the stream position, so a later call transparently respawns and resumes
    — which is also what makes it safe for fit loops to close iterators in
    a ``finally``. After ``set_state()`` the first ``reset()`` (the
    ``__iter__`` protocol fires one before consumption) preserves the
    restored mid-epoch position instead of rewinding it, so
    ``trainer.fit(restored_iterator)`` replays the exact surviving stream.
    Worker deaths are detected while waiting and respawned
    (bounded by ``max_respawns``) at the dead worker's next unpublished
    position, recovered from the ring headers; a worker that *raised*
    instead surfaces as :class:`EtlWorkerError` with the original traceback,
    sticky until ``reset()``.
    """

    #: fit-loop ``finally`` close is safe: lazy restart resumes the stream
    restartable_close = True

    def __init__(self, spec: ImageEtlSpec, num_workers: Optional[int] = None,
                 ring_slots: Optional[int] = None, registry=None,
                 zero_copy: bool = True, max_respawns: int = 3,
                 stall_timeout: float = 300.0):
        self.spec = spec
        self.num_workers = (num_workers
                            or int(os.environ.get(ENV_WORKERS, "0"))
                            or host_cpu_count())
        self._my = spec.my_batches()
        if not self._my:
            raise ValueError(
                f"rank {spec.rank}/{spec.world_size} owns no batches "
                f"({spec.num_batches} global batches)")
        self.num_workers = min(self.num_workers, max(1, len(self._my)))
        self.slots = max(2, ring_slots or 2 * self.num_workers)
        self.zero_copy = zero_copy
        self.max_respawns = max_respawns
        self.stall_timeout = stall_timeout
        self._layout = _RingLayout(self.slots, spec.batch_size, spec.height,
                                   spec.width, spec.channels)
        self._eye = np.eye(spec.num_classes, dtype=np.float32)
        if registry is None:
            from ..monitoring.registry import get_registry

            registry = get_registry()
        from ..monitoring.etl import etl_metrics

        self._m = etl_metrics(registry)
        self._next_j = 0        # next stream position to hand out
        self._epoch_start = 0   # position where the current epoch window began
        self._resume_pending = False
        self._last_occ = 0
        self._occ_hwm = 0       # ring-occupancy high-watermark (flight event)
        self._started = False
        self._shm = None
        self._seq = self._feats = self._labs = None
        self._ctx = None
        self._consumed = None
        self._stop = None
        self._busy = None
        self._counters = None
        self._workers: List[_Worker] = []
        self._respawns = 0
        self._error: Optional[EtlWorkerError] = None
        self._t_started = 0.0
        # cache counters: *_seen track the CURRENT worker incarnation's
        # shared arrays (they reset on every spawn); *_hist folds completed
        # incarnations in so registry counters stay monotonic across a
        # close()/resume cycle
        self._hits_seen = 0
        self._misses_seen = 0
        self._hits_hist = 0
        self._misses_hist = 0

    # -- lifecycle ----------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._started:
            return
        import multiprocessing as mp
        from multiprocessing import shared_memory

        self._ctx = ctx = mp.get_context("spawn")
        name = f"{SHM_PREFIX}{os.getpid()}_{uuid.uuid4().hex[:8]}"
        self._shm = shared_memory.SharedMemory(
            name=name, create=True, size=self._layout.total)
        self._seq, self._feats, self._labs = self._layout.views(self._shm.buf)
        self._seq[:] = -1
        # lock-free shared words: see _etl_worker
        self._consumed = ctx.Value("q", self._next_j, lock=False)
        self._stop = ctx.Value("b", 0, lock=False)
        self._busy = ctx.Array("d", self.num_workers, lock=False)
        self._counters = ctx.Array("q", 2 * self.num_workers, lock=False)
        self._workers = [self._spawn(w, self._next_j)
                         for w in range(self.num_workers)]
        self._started = True
        self._t_started = time.monotonic()
        self._m.workers.set(self.num_workers)

    def _spawn(self, worker_id: int, start_j: int) -> _Worker:
        parent, child = self._ctx.Pipe(duplex=False)
        proc = self._ctx.Process(
            target=_etl_worker,
            args=(self.spec, worker_id, self.num_workers, start_j,
                  self._shm.name, self.slots, self._consumed, self._stop,
                  child, self._busy, self._counters),
            daemon=True, name=f"tdl-etl-{worker_id}")
        proc.start()
        child.close()  # parent keeps the read end only
        return _Worker(proc, worker_id, parent)

    def _teardown(self) -> None:
        """Stop + reap workers and release the shm segment. Idempotent;
        every exit path (close/reset/set_state/__del__/with) funnels here."""
        if not self._started:
            return
        self._stop.value = 1
        for w in self._workers:
            w.proc.join(timeout=5.0)
        for w in self._workers:
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(timeout=2.0)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=2.0)
            w.conn.close()
        self._workers = []
        # final registry sync for this incarnation, then fold its counters
        # into the historical totals (the arrays die with the incarnation)
        hits = int(sum(self._counters[0::2]))
        misses = int(sum(self._counters[1::2]))
        self._m.cache_hits.inc(max(0, hits - self._hits_seen))
        self._m.cache_misses.inc(max(0, misses - self._misses_seen))
        self._hits_hist += hits
        self._misses_hist += misses
        self._hits_seen = self._misses_seen = 0
        self._seq = self._feats = self._labs = None
        try:
            self._shm.unlink()
        except FileNotFoundError as e:
            log.debug("shm already unlinked: %s", e)
        try:
            self._shm.close()
        except BufferError as e:
            # a handed-out zero-copy view is still live; the name is already
            # unlinked above, and parking the segment keeps its __del__ from
            # re-raising at GC — the OS frees the pages when the last map
            # drops (at the latest, process exit)
            log.debug("shm close deferred to process exit: %s", e)
            _DEFERRED_SHM.append(self._shm)
        self._shm = None
        self._started = False
        self._m.workers.set(0)
        self._m.ring_occupancy.set(0)

    def close(self) -> None:
        """Release workers + shm. The stream position survives: the next
        ``has_next()``/``next()`` respawns and resumes deterministically."""
        self._teardown()

    def __enter__(self) -> "EtlDataSetIterator":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __del__(self):
        try:
            self._teardown()
        except Exception as e:  # interpreter teardown: best effort only
            log.debug("ETL teardown in __del__ failed: %s", e)

    # -- failure handling ---------------------------------------------------

    def _poll_failures(self) -> None:
        """Error pipes first (a raised worker exits nonzero too — the
        traceback must win over the bare death), then liveness + respawn."""
        for w in self._workers:
            tb = None
            try:
                if w.conn.poll():
                    tb = w.conn.recv_bytes().decode(errors="replace")
            except (OSError, EOFError):
                # pipe died WITH the worker (SIGKILL/OOM): no report was
                # ever written — that's the bare-death/respawn path below,
                # not an application error
                tb = None
            if tb is not None:
                self._error = EtlWorkerError(w.worker_id, tb)
                raise self._error
        for i, w in enumerate(self._workers):
            if w.proc.exitcode is None:
                continue
            # died without reporting (OOM-kill, SIGKILL, hard crash)
            if self._respawns >= self.max_respawns:
                self._error = EtlWorkerError(
                    w.worker_id,
                    f"worker exited {w.proc.exitcode} without a report and "
                    f"the respawn budget ({self.max_respawns}) is exhausted")
                raise self._error
            start = self._next_unpublished(w.worker_id)
            log.warning("ETL worker %d died (exit %s); respawning at "
                        "stream position %d", w.worker_id, w.proc.exitcode,
                        start)
            w.conn.close()
            self._respawns += 1
            self._m.respawns.inc()
            self._workers[i] = self._spawn(w.worker_id, start)

    def _next_unpublished(self, worker_id: int) -> int:
        """First stream position owned by ``worker_id`` at/after the
        consumer's cursor whose ring header does NOT already hold it —
        workers publish in order, so this is exactly where the dead worker
        stopped. Deterministic production makes re-decoding safe."""
        j = self._next_j + (worker_id - self._next_j) % self.num_workers
        while self._seq[j % self.slots] == j:
            j += self.num_workers
        return j

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise self._error

    # -- DataSetIterator ----------------------------------------------------

    @property
    def epoch_batches(self) -> int:
        """Batches THIS rank consumes per epoch."""
        return len(self._my)

    def batch(self) -> int:
        return self.spec.batch_size

    @property
    def num_classes(self) -> int:
        return self.spec.num_classes

    def has_next(self) -> bool:
        """True while the current epoch window — positions
        ``[_epoch_start, _epoch_start + epoch_batches)`` — has batches left.
        The underlying stream is unbounded; ``reset()`` opens the next
        window."""
        self._raise_if_failed()
        return self._next_j < self._epoch_start + len(self._my)

    def next(self) -> DataSet:
        self._raise_if_failed()
        if not self.has_next():
            raise StopIteration("epoch exhausted; call reset() first")
        self._ensure_started()
        j = self._next_j
        s = j % self.slots
        # release everything before the CURRENT outstanding batch (j-1 may
        # still be referenced by the consumer in zero-copy mode)
        floor = j if not self.zero_copy else j - 1
        if floor > self._consumed.value:
            self._consumed.value = floor
        deadline = time.monotonic() + self.stall_timeout
        while self._seq[s] != j:
            self._poll_failures()
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"ETL ring stalled: batch {j} not produced within "
                    f"{self.stall_timeout}s (workers alive: "
                    f"{[w.proc.is_alive() for w in self._workers]})")
            time.sleep(_POLL_S)
        feats = self._feats[s]
        labs = self._labs[s]
        if not self.zero_copy:
            feats = feats.copy()
            self._consumed.value = j + 1
        y = self._eye[labs]
        self._next_j = j + 1
        # first consumption invalidates a pending resume: the NEXT reset()
        # is a normal epoch advance again, not the set_state guard
        self._resume_pending = False
        self._publish_metrics()
        return DataSet(feats, y)

    def reset(self) -> None:
        """Clear a sticky error (restarting the CURRENT epoch from 0) and
        advance epoch bookkeeping. At an epoch boundary this is free — the
        stream simply continues into the next epoch, so prefetch never
        bubbles; a MID-epoch reset restarts the epoch (teardown + respawn,
        the deterministic stream makes the replay exact). The first reset
        after ``set_state()`` keeps the restored position — see class
        docstring."""
        if self._resume_pending:
            # only the FIRST reset after set_state (and only while nothing
            # has been consumed yet — next() clears the flag) is a no-op:
            # it keeps the restored position instead of rewinding it
            self._resume_pending = False
            return
        M = len(self._my)
        epoch, pos = divmod(self._next_j, M)
        if self._error is not None or pos != 0:
            self._teardown()
            self._error = None
            self._respawns = 0
            self._next_j = epoch * M  # restart this epoch from batch 0
        self._epoch_start = self._next_j

    # -- replay (the gang supervisor's restart contract) --------------------

    def state(self) -> dict:
        M = len(self._my)
        return {"epoch": self._next_j // M, "pos": self._next_j % M}

    def set_state(self, s: dict) -> None:
        M = len(self._my)
        j = int(s["epoch"]) * M + int(s["pos"])
        if self._started and j != self._next_j:
            self._teardown()
        self._next_j = j
        self._epoch_start = j - (j % M)
        self._resume_pending = True

    # -- telemetry ----------------------------------------------------------

    def _publish_metrics(self) -> None:
        occ = int(sum(1 for k in range(self.slots)
                      if self._seq[(self._next_j + k) % self.slots]
                      == self._next_j + k))
        if occ > self._occ_hwm:
            self._occ_hwm = occ
            from ..monitoring import flight  # lazy: consumer-side only

            flight.record("queue_hwm", queue="etl_ring", depth=occ,
                          slots=self.slots)
        self._m.ring_occupancy.set(occ)
        self._m.batches.inc()
        hits = int(sum(self._counters[0::2]))
        misses = int(sum(self._counters[1::2]))
        self._m.cache_hits.inc(max(0, hits - self._hits_seen))
        self._m.cache_misses.inc(max(0, misses - self._misses_seen))
        self._hits_seen, self._misses_seen = hits, misses
        wall = max(1e-9, time.monotonic() - self._t_started)
        self._m.busy_frac.set(
            min(1.0, sum(self._busy) / (wall * self.num_workers)))
        self._last_occ = occ
        from ..monitoring import aggregate  # lazy: consumer-side only

        aggregate.maybe_spool()  # ETL pool's aggregated-/metrics spool

    def etl_stats(self) -> dict:
        """Ring/cache health for ``DevicePrefetchIterator.stats()`` and
        a benchmark's pipeline report."""
        wall = max(1e-9, time.monotonic() - self._t_started) \
            if self._t_started else 1e-9
        busy = sum(self._busy) if self._busy is not None else 0.0
        return {
            "etl_workers": self.num_workers,
            "ring_slots": self.slots,
            "ring_occupancy": self._last_occ,
            "etl_worker_busy_frac": round(
                min(1.0, busy / (wall * self.num_workers)), 3),
            "cache_hits": self._hits_hist + self._hits_seen,
            "cache_misses": self._misses_hist + self._misses_seen,
            "worker_respawns": self._respawns,
        }

    # -- test hook ----------------------------------------------------------

    def ring_payload_view(self) -> Optional[np.ndarray]:
        """The whole feature region of the shm ring (tests assert zero-copy
        handoff via ``np.shares_memory`` against this)."""
        return self._feats
