"""DataSet iterators and asynchronous prefetch.

Counterpart of ``deeplearning4j_tpu/data/iterators.py`` (nd4j's
``DataSetIterator`` and ``MultiDataSetIterator`` SPIs, deeplearning4j's
``AsyncDataSetIterator``): the list, array and multi-dataset iterators are
copies; ``AsyncDataSetIterator`` keeps the next batches ready on a host
thread; ``DevicePrefetchIterator`` also copies them to the card before the
consumer asks (pinned host buffers, a copy stream of its own, an event per
batch), so a step never waits on ETL or on the host-to-device copy.

This module imports torch only inside ``DevicePrefetchIterator``'s staging:
the ETL service's worker processes import it without loading torch.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .dataset import DataSet, MultiDataSet


class DataSetIterator:
    """Iterator SPI: next() -> DataSet, reset(), batch(), has_next()."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def async_supported(self) -> bool:
        return True

    def reset_supported(self) -> bool:
        return True

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        while self.has_next():
            yield self.next()


class ListDataSetIterator(DataSetIterator):
    """org.deeplearning4j.datasets.iterator.impl.ListDataSetIterator."""

    def __init__(self, datasets: Sequence[DataSet], batch_size: Optional[int] = None):
        if batch_size is not None:
            merged = DataSet.merge(list(datasets)) if len(datasets) > 1 else datasets[0]
            self._list = merged.batch_by(batch_size)
            self._batch = batch_size
        else:
            self._list = list(datasets)
            self._batch = self._list[0].num_examples() if self._list else 0
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._list)

    def next(self) -> DataSet:
        d = self._list[self._pos]
        self._pos += 1
        return d

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        return self._batch

    def state(self) -> dict:
        return {"pos": self._pos}

    def set_state(self, s: dict) -> None:
        self._pos = int(s["pos"])


class ArrayDataSetIterator(DataSetIterator):
    """Batches over in-memory (features, labels) arrays, optional shuffle per
    epoch (the common INDArray fit path)."""

    def __init__(self, features, labels, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.features = features.numpy() if hasattr(features, "numpy") else np.asarray(features)
        self.labels = labels.numpy() if hasattr(labels, "numpy") else np.asarray(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._seed = seed
        self._drop_last = drop_last
        self._order = np.arange(self.features.shape[0])
        self._pos = 0
        self._epoch = 0

    def has_next(self) -> bool:
        remaining = self.features.shape[0] - self._pos
        return remaining >= (self.batch_size if self._drop_last else 1)

    def next(self) -> DataSet:
        ix = self._order[self._pos: self._pos + self.batch_size]
        self._pos += self.batch_size
        return DataSet(self.features[ix], self.labels[ix])

    def reset(self) -> None:
        self._pos = 0
        self._epoch += 1
        if self.shuffle:
            np.random.default_rng(self._seed + self._epoch).shuffle(self._order)

    def batch(self) -> int:
        return self.batch_size

    # (pos, epoch) only: the shuffle order is rebuilt by replaying the
    # seeded per-epoch shuffles
    def state(self) -> dict:
        return {"pos": int(self._pos), "epoch": int(self._epoch)}

    def set_state(self, s: dict) -> None:
        self._pos = int(s["pos"])
        self._epoch = int(s["epoch"])
        self._order = np.arange(self.features.shape[0])
        if self.shuffle:
            for k in range(1, self._epoch + 1):
                np.random.default_rng(self._seed + k).shuffle(self._order)


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch wrapper (DL4J's AsyncDataSetIterator): a
    bounded queue of ready batches, so the training loop overlaps host ETL
    with the card's step (see :class:`DevicePrefetchIterator` for batches
    already on the card).

    An ETL error in the worker is captured and re-raised from the
    consumer's ``next()``/``has_next()`` once the buffered batches drain,
    and every later call raises it again until ``reset()``: never a quietly
    truncated epoch. ``reset()`` signals a stop event instead of draining
    the rest of the epoch, so an early stop costs O(queue_size) batches.
    """

    _END = object()
    _PUT_POLL_S = 0.05  # the worker re-checks the stop event at this cadence

    def __init__(self, base: DataSetIterator, queue_size: int = 4):
        self._base = base
        self._size = queue_size
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._next_item = None
        self._exhausted = False

    def _stage(self, ds: DataSet) -> DataSet:
        """Hook: transform a batch ON THE WORKER THREAD before it is queued
        (DevicePrefetchIterator copies it to the card here)."""
        return ds

    def _on_queued(self, q) -> None:
        """Hook: a staged batch entered ``q`` (not called for a put that a
        reset aborted)."""

    def _start(self):
        """Lazy start: the worker starts on the first has_next()/next(), so
        a reset() before any consumption wastes no ETL."""
        self._exhausted = False
        self._error = None
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._size)
        stop, q = self._stop, self._queue  # bind: reset() swaps the fields

        def put_stoppable(item) -> bool:
            """Bounded put that gives up when reset() signals stop."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=self._PUT_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                while not stop.is_set() and self._base.has_next():
                    if not put_stoppable(self._stage(self._base.next())):
                        return
                    self._on_queued(q)
            except Exception as e:  # captured, re-raised consumer-side
                self._error = e
            finally:
                put_stoppable(self._END)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        self._advance()

    def _ensure_started(self):
        if self._thread is None:
            self._start()

    def _advance(self):
        item = self._queue.get()
        if item is self._END:
            self._exhausted = True
            self._next_item = None
        else:
            self._next_item = item

    def _raise_if_failed(self):
        # sticky: every later call raises again, so no caller mistakes the
        # failed tail of an epoch for its end; only reset() clears it
        if self._exhausted and self._error is not None:
            raise self._error

    def has_next(self) -> bool:
        self._ensure_started()
        self._raise_if_failed()
        return not self._exhausted

    def next(self) -> DataSet:
        self._ensure_started()
        self._raise_if_failed()
        if self._exhausted:
            # the worker is gone: blocking on the queue would hang forever
            raise StopIteration("epoch exhausted; call reset() first")
        item = self._next_item
        self._advance()
        return item

    def _shutdown_worker(self) -> None:
        """Signal stop, then drain what is buffered so a worker blocked in
        put() sees the event: O(queue_size), the rest of the epoch is never
        produced."""
        if self._thread is None:
            return
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                if not self._thread.is_alive():
                    break
                time.sleep(self._PUT_POLL_S / 10)
        self._thread.join(timeout=5.0)
        self._thread = None
        self._next_item = None
        self._exhausted = False

    def close(self) -> None:
        """Stop and join the worker WITHOUT resetting the base (the fit
        loops call this from a ``finally``). Buffered batches are dropped; a
        sticky worker error survives (only ``reset()`` clears it); the
        iterator stays usable and restarts its worker on next use. A base
        that advertises ``restartable_close`` (the multi-process ETL
        service, whose close frees worker processes and shared memory and
        which resumes where it stopped) is closed too; others (a persistent
        decode thread pool) are left alone."""
        self._shutdown_worker()
        base_close = getattr(self._base, "close", None)
        if callable(base_close) and getattr(self._base, "restartable_close", False):
            base_close()

    def reset(self) -> None:
        self._shutdown_worker()
        self._error = None
        self._base.reset()

    def batch(self) -> int:
        return self._base.batch()


class DevicePrefetchIterator(AsyncDataSetIterator):
    """Copy the next ``buffer_size`` batches to the card while the current
    step runs (DL4J's AsyncDataSetIterator with pinned workspaces).

    The worker thread stages each batch: it copies the host arrays into
    pinned buffers, issues their copies to ``device`` on a CUDA stream of
    its own (``non_blocking``), records an event and waits for it, so a
    batch the consumer pops is already resident on the card and the fit
    loop's ``_put`` does nothing. A pinned buffer is refilled only after
    its copy's event has completed (the wait above), and each staged tensor
    is recorded on the device's default stream, so the caching allocator
    does not hand its memory out again while a step still reads it. The
    worker thread selects ``device`` (a thread starts on card 0). Device
    memory holds at most ``buffer_size + 2`` batches (the queue and the
    consumer's current and next ones). On the CPU (``device="cpu"``) a
    batch is copied, not viewed, so a base that reuses its buffers (the ETL
    ring) may refill them.

    ``sharding`` (``ParallelTrainer.batch_sharding()``) stages only this
    rank's rows of a batch the data group divides; a batch it does not
    divide is staged whole, for the trainer's remainder step.

    Telemetry (``monitoring`` registry): ``tdl_h2d_bytes_total`` /
    ``tdl_h2d_seconds`` (the copies alone, timed by CUDA events around them
    on the copy stream), ``tdl_prefetch_queue_depth``,
    ``tdl_input_wait_seconds`` (per-step consumer wait, ~0 when prefetch
    keeps up) and ``tdl_input_starved_steps_total``. ``wait_seconds``
    keeps the recent per-step waits.
    """

    STARVED_S = 1e-3  # a step that waited longer than this was input-bound

    def __init__(self, base: DataSetIterator, buffer_size: int = 2,
                 sharding=None, registry=None, device="cuda"):
        super().__init__(base, queue_size=buffer_size)
        import torch

        from ..common.device import resolve_device

        self._sharding = sharding
        dev = resolve_device(sharding.device if sharding is not None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._copy_stream = None
        self._pinned = {}
        if registry is None:
            from ..monitoring.registry import get_registry

            registry = get_registry()
        self._h2d_bytes = registry.counter(
            "tdl_h2d_bytes_total", "Bytes moved host→device by input staging")
        self._h2d_seconds = registry.counter(
            "tdl_h2d_seconds", "Seconds spent in host→device input transfers")
        self._depth = registry.gauge(
            "tdl_prefetch_queue_depth", "Device-resident batches ready ahead "
            "of the consumer")
        self._wait_hist = registry.histogram(
            "tdl_input_wait_seconds",
            "Per-step consumer wait for the next input batch",
            buckets=(1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0))
        self._starved = registry.counter(
            "tdl_input_starved_steps_total",
            "Steady-state steps that blocked on input longer than 1ms")
        # recent per-step waits (bounded); the full distribution is the
        # registry histogram's
        self.wait_seconds: List[float] = []
        self._wait_cap = 4096
        self._steps = 0  # advances this epoch (reset() zeroes it)

    def _pinned_copy(self, slot: int, a):
        """``a`` copied into this slot's pinned host buffer (reused while
        the shape and dtype stay; its last copy has completed)."""
        import torch

        src = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        key = (slot, tuple(src.shape), src.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            self._pinned = {k: v for k, v in self._pinned.items() if k[0] != slot}
            buf = self._pinned[key] = torch.empty(src.shape, dtype=src.dtype,
                                                  pin_memory=True)
        buf.copy_(src)
        return buf

    def _stage(self, ds: DataSet) -> DataSet:
        """Runs on the worker thread: every array of the batch (this rank's
        rows under a sharding) on the device, the copies complete."""
        import torch

        arrays = [ds.features, ds.labels, ds.features_mask, ds.labels_mask]
        sharding = self._sharding
        local = sharding is not None and ds.features is not None and \
            sharding.divides(int(ds.features.shape[0]))
        if local:
            arrays = [None if a is None else sharding.rows(a) for a in arrays]
        dev = self.device
        if dev.type != "cuda":
            placed = [None if a is None else
                      (a.to(dev).clone() if isinstance(a, torch.Tensor) else np.array(a))
                      for a in arrays]
            return sharding.local(ds, placed) if local else DataSet(*placed)
        with torch.cuda.device(dev):
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(dev)
            host = [None if a is None or (isinstance(a, torch.Tensor) and a.is_cuda)
                    else self._pinned_copy(i, a) for i, a in enumerate(arrays)]
            nbytes = sum(h.numel() * h.element_size() for h in host if h is not None)
            with torch.cuda.stream(self._copy_stream):
                placed = [None if a is None else a.to(dev) if h is None else
                          torch.empty(h.shape, dtype=h.dtype, device=dev)
                          for a, h in zip(arrays, host)]
                # the copies alone, timed on the copy stream: neither the
                # allocations above nor this thread's wait for the GIL
                start, done = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record(self._copy_stream)
                for p, h in zip(placed, host):
                    if h is not None:
                        p.copy_(h, non_blocking=True)
                done.record(self._copy_stream)
            done.synchronize()  # resident before queued; the pinned buffers are free
            self._h2d_bytes.inc(nbytes)
            self._h2d_seconds.inc(start.elapsed_time(done) / 1e3)
            consumer = torch.cuda.default_stream(dev)
            for t in placed:
                if t is not None:
                    t.record_stream(consumer)
        return sharding.local(ds, placed) if local else DataSet(*placed)

    def _on_queued(self, q) -> None:
        # only after the put succeeded: a reset-aborted put must not leave
        # the gauge counting a batch that never entered the queue
        self._depth.set(q.qsize())

    _WARMUP_STEPS = 2  # queue fill and the first step: waits here are not starvation

    def _advance(self):
        t0 = time.perf_counter()
        super()._advance()
        wait = time.perf_counter() - t0
        self._steps += 1
        if len(self.wait_seconds) >= self._wait_cap:
            del self.wait_seconds[:self._wait_cap // 2]
        self.wait_seconds.append(wait)
        self._wait_hist.observe(wait)
        if wait > self.STARVED_S and self._steps > self._WARMUP_STEPS:
            self._starved.inc()
        self._depth.set(self._queue.qsize())

    def reset(self) -> None:
        super().reset()
        # per-epoch wait statistics: a fresh epoch has its own queue fill
        self.wait_seconds = []
        self._steps = 0

    def stats(self) -> dict:
        """Pipeline health: the h2d bytes, seconds and MB/s measured on the
        worker, the consumer's per-step input wait (without the first
        ``_WARMUP_STEPS`` waits: queue fill, not steady state), the starved
        steps and this epoch's advances; a base with ``etl_stats()`` (the
        ETL service) adds its ring and cache counters."""
        warm = max(0, self._WARMUP_STEPS - (self._steps - len(self.wait_seconds)))
        steady = self.wait_seconds[warm:]
        base_etl = getattr(self._base, "etl_stats", None)
        etl = base_etl() if callable(base_etl) else {}
        return {
            **etl,
            "h2d_bytes": int(self._h2d_bytes.value),
            "h2d_seconds": round(self._h2d_seconds.value, 4),
            "h2d_MBps": round(
                self._h2d_bytes.value / 1e6 / self._h2d_seconds.value, 1)
            if self._h2d_seconds.value else 0.0,
            "input_wait_ms_per_step": round(
                float(np.mean(steady)) * 1e3, 3) if steady else 0.0,
            "starved_steps": int(self._starved.value),
            "epoch_steps": self._steps,
        }


class MultiDataSetIterator:
    """api.iterator.MultiDataSetIterator SPI."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> MultiDataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[MultiDataSet]:
        self.reset()
        while self.has_next():
            yield self.next()


class ListMultiDataSetIterator(MultiDataSetIterator):
    def __init__(self, items: Sequence[MultiDataSet]):
        self._items = list(items)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._items)

    def next(self) -> MultiDataSet:
        d = self._items[self._pos]
        self._pos += 1
        return d

    def reset(self) -> None:
        self._pos = 0
