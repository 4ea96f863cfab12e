"""BatchingInferenceExecutor — the micro-batching inference core (copy of the
JAX package's ``serving.executor``, on one device).

Reference: ``org.deeplearning4j.parallelism.ParallelInference`` queues
observations and a worker drains them in batches up to ``batchLimit``. Here
ONE dedicated inference thread drains a bounded admission queue into
``ParallelInference``-bucketed padded batches on the card, so a handful of
batch shapes serve every concurrency level.

What production hardening adds on top of the DL4J shape:

- **bounded admission**: ``submit`` raises :class:`QueueFullError` when the
  queue is at capacity — overload becomes explicit backpressure (HTTP 429 at
  the server layer), never unbounded kernel-socket queueing;
- **deadlines**: every request carries an absolute deadline; requests that
  expire while queued are shed WITHOUT running the model (cheap load
  shedding under overload — the work most worth dropping is work nobody is
  waiting for anymore);
- **graceful drain**: ``stop(drain=True)`` refuses new admissions, finishes
  every accepted request, then stops the thread;
- **warmup**: an optional example input is run before the first real request
  so the first request does not pay the kernel build (``nvcc``), the tile
  lookups and the first allocations of its batch shape;
- **chaos hooks**: ``common.faults.fault_point("infer")`` fires inside the
  batch cycle (``slow_infer@p=`` / ``fail_infer@n=``), so the serving chaos
  tests wedge/fail the REAL inference path;
- **observability**: every queue/batch/shed event lands in the
  ``tdl_inference_*`` families (``monitoring.serving``); SAMPLED requests
  (deterministic by request-id hash, ``span_sample_n``) leave
  ``request_span`` flight events carrying the per-phase
  queue→batch-form→infer timeline keyed by request id — shed requests
  (queue-full, expired-in-queue, abandoned-mid-batch) leave one under the
  same sampling decision, so a sampled 429/504's life is as reconstructable
  as a sampled 200's.

Model calls run under ``torch.inference_mode()`` and their outputs come back
to the host as numpy (``parallel.inference``).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..common.faults import fault_point
from ..monitoring import aggregate, flight
from ..monitoring.serving import serving_metrics
from ..parallel.inference import (check_single_output, host_array,
                                  inference_mode, model_output)

log = logging.getLogger(__name__)

#: span payload keys that are NOT per-phase seconds. Every request_span
#: recorder (the executor's abandoned paths, the HTTP layer's
#: ``_record_span``) must split on this ONE set — a new extra added to
#: only one site would land in ``phases={}`` as fake per-phase seconds.
SPAN_EXTRA_KEYS = ("batch_rows", "steps", "step_ms", "step_tokens")


def span_sampled(request_id: Optional[str], sample_n: int) -> bool:
    """Deterministic request-span sampling: the SAME request id always
    samples the same way at every stage (and across processes), so a
    sampled request's timeline is complete, never half-recorded. Gated on
    flight recording being active — an unsupervised process pays one env
    lookup. ``sample_n=1`` records every request; ``N`` records ~1/N of
    them (raise it on heavy production traffic so spans don't evict the
    rest of the flight ring)."""
    if not flight.active():
        return False
    if sample_n <= 1:
        return True
    if not request_id:
        return False  # no id → no joinable timeline to sample
    import zlib

    return zlib.crc32(request_id.encode()) % sample_n == 0


def _trace_kw(fut) -> dict:
    """The trace-id kwarg for a ``request_span`` record site (empty when the
    request carried no trace id — a span without one still records)."""
    trace_id = getattr(fut, "trace_id", None)
    return {"trace_id": trace_id} if trace_id else {}


class QueueFullError(RuntimeError):
    """Admission queue at capacity — callers map this to HTTP 429."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before inference completed (HTTP 504)."""


class ExecutorClosedError(RuntimeError):
    """The executor is stopped or draining — no new admissions (HTTP 503)."""


class InferenceFuture:
    """One accepted request's completion slot.

    Exactly one of ``result`` / ``error`` is populated when ``wait`` returns
    True. ``deadline`` is an absolute ``time.monotonic()`` instant (None =
    no deadline).
    """

    __slots__ = ("x", "deadline", "enqueued_at", "result", "error", "_done",
                 "abandoned", "_lock", "request_id", "trace_id", "sampled",
                 "span")

    def __init__(self, x: np.ndarray, deadline: Optional[float],
                 request_id: Optional[str] = None, sampled: bool = False,
                 trace_id: Optional[str] = None):
        self.x = x
        self.deadline = deadline
        self.request_id = request_id
        #: trace propagation: the id the HTTP layer adopted from
        #: ``X-Trace-Id`` (or inherited from the request id) — stamped into
        #: every ``request_span`` flight event this future produces, so the
        #: fleet timeline joins this request across process lanes
        self.trace_id = trace_id
        self.enqueued_at = time.monotonic()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.abandoned = False
        #: span sampling: when True the executor fills ``span``
        #: with per-phase seconds (queue / batch_form / infer) before
        #: resolving — the HTTP layer adds serialize and records the
        #: ``request_span`` flight event. Written by the inference thread,
        #: read after ``_done`` is set (the Event is the memory barrier).
        self.sampled = sampled
        self.span: Optional[dict] = None
        self._done = threading.Event()
        self._lock = threading.Lock()  # serializes abandon() vs _expire()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def abandon(self) -> bool:
        """The waiter gave up (its deadline passed). Returns True when the
        request is still unresolved — the caller then owns the shed
        accounting and the executor will not double-count it; False means a
        result/error landed in the race window and should be consumed."""
        with self._lock:
            if self._done.is_set():
                return False
            self.abandoned = True
            return True

    def _expire(self, error: BaseException) -> bool:
        """Executor-side twin of :meth:`abandon`: resolve with ``error`` and
        return True iff the executor owns the shed accounting (the waiter
        had not already claimed it). The shared lock makes exactly one of
        the two sides the owner."""
        with self._lock:
            owns_count = not self.abandoned
            self._resolve(error=error)
            return owns_count

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def _resolve(self, result: Optional[np.ndarray] = None,
                 error: Optional[BaseException] = None) -> None:
        self.result = result
        self.error = error
        self._done.set()


class BatchingInferenceExecutor:
    """Bounded-queue micro-batching executor over a model or ParallelInference.

    With ``parallel_inference`` set, coalesced requests run through
    ``ParallelInference.output_batched`` (padded to a power-of-2 bucket, so
    a few batch shapes serve every concurrency). With a raw ``model``,
    coalesced requests are concatenated into one forward. Requests are
    grouped by (dtype, feature-shape) before concatenation so a mixed
    workload never fails deep inside the forward. A ``ComputationGraph``
    with more than one network output is refused here (``ValueError``): a
    request gets one array.
    """

    def __init__(self, model=None, parallel_inference=None, *,
                 max_queue: int = 64, max_batch_rows: int = 128,
                 default_deadline_ms: Optional[float] = None,
                 warmup_input=None, registry=None, span_sample_n: int = 1,
                 warmup_all_buckets: Optional[bool] = None):
        if model is None and parallel_inference is None:
            raise ValueError("need a model or a ParallelInference")
        if model is not None:
            check_single_output(model)
        self.model = model
        self.parallel_inference = parallel_inference
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if span_sample_n < 1:
            raise ValueError(f"span_sample_n must be >= 1, got {span_sample_n}")
        self.max_queue = max_queue
        self.max_batch_rows = max_batch_rows
        self.default_deadline_ms = default_deadline_ms
        self.span_sample_n = span_sample_n
        #: warm EVERY ParallelInference bucket up to max_batch_rows, not
        #: just the smallest, so the first large-batch request pays no
        #: first-shape cost. None = auto: only when the compile cache is
        #: enabled (a replica built from a shared kernel build is meant to
        #: come up ready for every batch shape); True forces it regardless.
        self.warmup_all_buckets = warmup_all_buckets
        self._warmup_input = warmup_input
        self._m = serving_metrics(registry)
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._accepting = False
        self._stopping = False
        self._drain_on_stop = True
        self._warm = threading.Event()
        self._depth_hwm = 0  # flight-recorded queue-depth high-watermark

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "BatchingInferenceExecutor":
        # honor TDL_COMPILE_CACHE_DIR before the warmup launches a kernel —
        # a warming replica then loads the shared nvcc build from disk
        from ..common import compile_cache

        compile_cache.maybe_enable_from_env()
        with self._cv:
            if self._thread is not None:
                return self
            self._accepting = True
            self._stopping = False
            self._thread = threading.Thread(
                target=self._loop, name="tdl-inference", daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the inference thread. ``drain=True`` completes every accepted
        request first; ``drain=False`` cancels queued requests (their futures
        resolve with :class:`ExecutorClosedError`). Idempotent."""
        with self._cv:
            self._accepting = False
            if self._thread is None:
                return
            self._stopping = True
            self._drain_on_stop = drain  # generative loop cancels ACTIVE slots itself
            if not drain:
                while self._q:
                    req = self._q.popleft()
                    self._m.shed.labels(reason="shutdown").inc()
                    req._resolve(error=ExecutorClosedError(
                        "executor stopped before this request ran"))
                self._m.queue_depth.set(0)
            self._cv.notify_all()
            thread = self._thread
        thread.join(timeout)
        if thread.is_alive():
            log.warning("inference thread did not stop within %.1fs", timeout)
        with self._cv:
            self._thread = None

    # -- readiness ---------------------------------------------------------

    @property
    def warm(self) -> bool:
        """True once the warmup forward (or the first real batch) compiled."""
        return self._warm.is_set()

    def wait_warm(self, timeout: Optional[float] = None) -> bool:
        return self._warm.wait(timeout)

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._q)

    # -- admission ---------------------------------------------------------

    def submit(self, x, deadline_ms: Optional[float] = None,
               request_id: Optional[str] = None,
               trace_id: Optional[str] = None) -> InferenceFuture:
        """Admit one request. Raises :class:`QueueFullError` at capacity,
        :class:`ExecutorClosedError` when stopped/draining, ``ValueError``
        on inputs with no batch dimension. ``request_id`` (the server's
        ``X-Request-Id``) rides the future into every executor log line;
        ``trace_id`` rides into its ``request_span`` events."""
        arr = host_array(x)
        if arr.ndim == 0:
            raise ValueError("inference input must have a batch dimension; "
                             "got a scalar")
        ms = deadline_ms if deadline_ms is not None else self.default_deadline_ms
        deadline = time.monotonic() + ms / 1000.0 if ms is not None else None
        sampled = span_sampled(request_id, self.span_sample_n)
        fut = InferenceFuture(arr, deadline, request_id=request_id,
                              sampled=sampled, trace_id=trace_id)
        return self._admit(fut)

    def _admit(self, fut: InferenceFuture) -> InferenceFuture:
        """Shared bounded-queue admission (the generative executor admits
        :class:`GenerationFuture`\\ s through the same path): queue-full ⇒
        :class:`QueueFullError` + shed accounting + 429 span, closed ⇒
        :class:`ExecutorClosedError`, else enqueue + depth/HWM telemetry."""
        request_id, sampled = fut.request_id, fut.sampled
        with self._cv:
            if not self._accepting:
                raise ExecutorClosedError("executor is not accepting requests")
            queue_full = len(self._q) >= self.max_queue
            if queue_full:
                self._m.shed.labels(reason="queue_full").inc()
                # debug, not warning: queue-full is the EXPECTED overload
                # behavior (thousands/sec under stress), and logging under
                # the admission lock would serialize contended submitters
                log.debug("request %s: admission queue full (%d queued)",
                          request_id, self.max_queue)
            else:
                self._q.append(fut)
                depth = len(self._q)
                self._m.queue_depth.set(depth)
                new_hwm = depth > self._depth_hwm
                if new_hwm:
                    self._depth_hwm = depth
                self._cv.notify()
        if queue_full:
            if sampled:
                # span timeline for the 429: a rejected
                # request's life is reconstructable too — recorded OUTSIDE
                # the admission lock like every breadcrumb here
                flight.record("request_span", request_id=request_id,
                              outcome="shed_queue_full", code=429,
                              queue_depth=self.max_queue, phases={},
                              **_trace_kw(fut))
            raise QueueFullError(
                f"admission queue full ({self.max_queue} queued)")
        if new_hwm:
            # black-box breadcrumb: rising watermarks are the overload
            # precursor a postmortem wants on the timeline (rare by
            # construction — fires only on a NEW maximum)
            flight.record("queue_hwm", queue="inference", depth=depth,
                          max_queue=self.max_queue)
        return fut

    # -- inference thread --------------------------------------------------

    def _loop(self) -> None:
        if self._warmup_input is not None:
            try:
                self._warmup()
            except Exception:
                log.exception("serving warmup failed — the first request "
                              "will pay the first-shape cost instead")
        self._warm.set()
        while True:
            with self._cv:
                while not self._q and not self._stopping:
                    self._cv.wait()
                if not self._q and self._stopping:
                    return
                batch = [self._q.popleft()]
                rows = batch[0].x.shape[0]
                while self._q and rows + self._q[0].x.shape[0] <= self.max_batch_rows:
                    req = self._q.popleft()
                    rows += req.x.shape[0]
                    batch.append(req)
                self._m.queue_depth.set(len(self._q))
            self._serve_batch(batch)
            aggregate.maybe_spool()  # serving replica's aggregated-/metrics spool

    def _warmup(self) -> None:
        """Run the serving path once before the first real request (kernel
        build or load, tile lookups, the batch shape's first allocations).
        With a ParallelInference and bucket warmup on (explicitly, or auto
        when the compile cache is enabled), EVERY bucket of the padding
        ladder up to ``max_batch_rows`` is warmed, so the first large
        coalesced batch pays no first-shape cost mid-traffic."""
        from ..common import compile_cache

        x = np.asarray(self._warmup_input)
        pi = self.parallel_inference
        warm_ladder = (self.warmup_all_buckets
                       if self.warmup_all_buckets is not None
                       else compile_cache.enabled())
        if pi is None or not warm_ladder:
            self._run([x])  # the smallest bucket (historical behavior)
            return
        row = x[:1] if x.ndim and x.shape[0] else x[None]
        for b in pi.bucket_sizes(self.max_batch_rows):
            # exactly b rows => ParallelInference pads to bucket b itself
            self._run([np.broadcast_to(row, (b,) + row.shape[1:]).copy()])
            log.debug("serving warmup: bucket %d ready", b)

    def _serve_batch(self, batch: List[InferenceFuture]) -> None:
        now = time.monotonic()
        live: List[InferenceFuture] = []
        for req in batch:
            self._m.queue_wait.observe(now - req.enqueued_at)
            if req.deadline is not None and now >= req.deadline:
                # expired while queued: shed WITHOUT running the model —
                # nobody is waiting for this answer anymore. An abandoned
                # request was already counted by its waiter (reason=deadline)
                owns_count = req._expire(DeadlineExceededError(
                    "deadline expired while queued"))
                if owns_count:
                    # the abandoned case already logged server-side; and like
                    # queue_full above this is the EXPECTED overload path —
                    # debug, so the single batch-pump thread never stalls on
                    # per-request log IO exactly when it is most loaded
                    self._m.shed.labels(reason="queue_expired").inc()
                    log.debug("request %s: expired in queue after %.3fs "
                              "(deadline passed before inference started)",
                              req.request_id, now - req.enqueued_at)
                if req.sampled:
                    # span timeline for the 504: its
                    # whole life was the queue, and the timeline says so
                    flight.record("request_span",
                                  request_id=req.request_id,
                                  outcome="shed_deadline", code=504,
                                  abandoned=not owns_count,
                                  phases={"queue": now - req.enqueued_at},
                                  **_trace_kw(req))
            else:
                live.append(req)
        if not live:
            return
        self._m.batch_size.observe(sum(r.x.shape[0] for r in live))
        if log.isEnabledFor(logging.DEBUG):
            log.debug("inference batch: %d rows from requests [%s]",
                      sum(r.x.shape[0] for r in live),
                      ", ".join(str(r.request_id) for r in live))
        groups: Dict[Tuple[str, tuple], List[InferenceFuture]] = {}
        for req in live:
            groups.setdefault((str(req.x.dtype), req.x.shape[1:]), []).append(req)
        for reqs in groups.values():
            rows = sum(r.x.shape[0] for r in reqs)
            t_infer = time.monotonic()
            try:
                fault_point("infer")
                outs = self._run([r.x for r in reqs])
            except Exception as e:  # model failure → every rider sees it
                log.warning("inference failed for requests [%s]: %s: %s",
                            ", ".join(str(r.request_id) for r in reqs),
                            type(e).__name__, e)
                self._fill_spans(reqs, now, t_infer, rows)
                for r in reqs:
                    r._resolve(error=e)
                    self._record_abandoned_span(r)
                continue
            self._fill_spans(reqs, now, t_infer, rows)
            for r, out in zip(reqs, outs):
                r._resolve(result=out)
                self._record_abandoned_span(r)

    @staticmethod
    def _record_abandoned_span(r: InferenceFuture) -> None:
        """A request whose waiter gave up (504) while its batch ran still
        gets a span: the timeline shows WHERE its deadline went (a long
        infer, a slow queue) — nobody else will record it, the waiter is
        gone. Non-abandoned requests are recorded by their waiter (the
        HTTP layer adds serialize), so this never double-records. The
        abandoned read takes the future's lock: abandon() holds it across
        its done-check + flag write, so this sees either the complete
        abandon (record here, waiter 504'd) or none (abandon() will return
        False and the waiter records the ok span) — never the in-between
        where the sampled request loses its span on both sides."""
        with r._lock:
            abandoned = r.abandoned
        if abandoned and r.sampled:
            phases = dict(r.span or {})
            extra = {k: phases.pop(k) for k in SPAN_EXTRA_KEYS if k in phases}
            flight.record("request_span", request_id=r.request_id,
                          outcome="shed_deadline", code=504, abandoned=True,
                          phases=phases, **extra, **_trace_kw(r))

    @staticmethod
    def _fill_spans(reqs: List[InferenceFuture], t_pop: float,
                    t_infer: float, rows: int) -> None:
        """Attach per-phase seconds to each SAMPLED rider of this group,
        BEFORE the futures resolve (the done-Event publishes the write):
        queue = admission → batch pop, batch_form = pop → forward dispatch
        (expiry sweep + grouping + concat prep), infer = the forward. The
        waiter adds serialize and records the ``request_span`` event."""
        t_end = time.monotonic()
        for r in reqs:
            if r.sampled:
                r.span = {"queue": t_pop - r.enqueued_at,
                          "batch_form": t_infer - t_pop,
                          "infer": t_end - t_infer,
                          "batch_rows": rows}

    def _run(self, xs: List[np.ndarray]) -> List[np.ndarray]:
        if self.parallel_inference is not None:
            return self.parallel_inference.output_batched(xs)
        big = np.concatenate(xs, axis=0) if len(xs) > 1 else xs[0]
        arr = model_output(self.model, big)
        res, off = [], 0
        for x in xs:
            res.append(arr[off:off + x.shape[0]])
            off += x.shape[0]
        return res


# ------------------------------------------------------- continuous batching


class GenerationFuture(InferenceFuture):
    """One accepted GENERATIVE request: ``x`` holds the 1-D int32 prompt,
    ``result`` the generated token ids (np.int32, EOS inclusive). The
    executor appends into ``tokens`` as decode steps land."""

    __slots__ = ("max_new_tokens", "tokens", "steps")

    def __init__(self, x: np.ndarray, deadline: Optional[float],
                 max_new_tokens: int, request_id: Optional[str] = None,
                 sampled: bool = False, trace_id: Optional[str] = None):
        super().__init__(x, deadline, request_id=request_id, sampled=sampled,
                         trace_id=trace_id)
        self.max_new_tokens = max_new_tokens
        self.tokens: List[int] = []
        self.steps = 0


#: per-request decode-step timeline entries kept on a sampled span — enough
#: to see stalls without letting a 2k-token generation bloat the flight ring
_SPAN_STEP_CAP = 64


class GenerativeInferenceExecutor(BatchingInferenceExecutor):
    """Iteration-level (Orca-style) continuous batching over a decode slot
    pool — the autoregressive counterpart of the micro-batching executor.

    The inference thread runs the decode loop: at every STEP BOUNDARY it
    admits queued requests into free KV slots (prompt prefill) and retires
    finished sequences immediately — no request ever waits for the slowest
    member of its batch, which is the whole p99 story for generative
    traffic. Deadlines shed mid-decode through the existing 504 path
    (the sequence is EVICTED, its slot freed the same step).

    ``session`` is duck-typed (the port's ``models.transformer.DecodeSlotPool``
    and the block-paged ``models.paged_decode.PagedDecodeSlotPool`` are the
    real ones): ``slots``, ``free_slots``, ``admit(prompt, max_new_tokens) ->
    (slot, first_token)``, ``step() -> {slot: token | [tokens...]}``,
    ``release(slot)``, plus optional ``eos_id`` / ``max_len`` attributes.
    Paged sessions additionally expose ``can_admit``/``request_blocks``/
    ``total_blocks`` (block-priced admission control), ``block_stats()``
    (occupancy/CoW/speculation telemetry), ``admit_overhead_tokens``
    (speculative lookahead slack priced at the door), and an admission
    error with ``retry_admission = True`` meaning "no blocks RIGHT NOW" —
    the executor re-queues such a request at the head of the line.

    ``continuous=False`` is the measured strawman: admission only into an
    EMPTY pool, so a batch pads to its slowest member exactly like a
    static padded batcher — ``chip_smoke.py`` phase 8c reports the two
    side by side (never assume the policy, measure it).

    The paged pool captures its decode step as a CUDA graph on its first
    step, and that step runs HERE, on the executor's thread (at warm-up, or
    at the first request's first step). While it captures, no other thread
    of the process may make a CUDA call that is unsafe during capture, so a
    process serving from a paged pool keeps other CUDA work off the card
    until :attr:`warm` (the heartbeat reads only the allocator's counters).
    """

    def __init__(self, session, *, max_queue: int = 64,
                 default_max_new_tokens: int = 32,
                 default_deadline_ms: Optional[float] = None,
                 eos_id: Optional[int] = None, continuous: bool = True,
                 warmup_prompt=None, registry=None, span_sample_n: int = 1):
        if default_max_new_tokens < 1:
            raise ValueError(f"default_max_new_tokens must be >= 1, got "
                             f"{default_max_new_tokens}")
        super().__init__(model=session, max_queue=max_queue,
                         default_deadline_ms=default_deadline_ms,
                         warmup_input=warmup_prompt, registry=registry,
                         span_sample_n=span_sample_n)
        self.session = session
        self.continuous = continuous
        self.default_max_new_tokens = default_max_new_tokens
        self.eos_id = eos_id if eos_id is not None else getattr(
            session, "eos_id", None)
        from ..monitoring.serving import decode_metrics

        self._md = decode_metrics(registry)
        # python-side aggregates for stats()/bench (registry counters are
        # process-global; these are THIS executor's)
        self._steps = 0
        self._occupancy_sum = 0
        self._tokens_out = 0
        self._admitted = 0
        self._evicted = 0
        # last (proposed, accepted) seen from the session's speculative
        # counters — registry counters get the DELTA so restarts of the
        # session (KvCacheLost reset keeps cumulative counters) stay right
        self._spec_seen = (0, 0)

    def _sync_session_metrics(self) -> None:
        """Mirror the paged pool's block/speculation counters into the
        ``tdl_decode_blocks_*`` / ``tdl_decode_cow_*`` / ``tdl_decode_spec_*``
        families (no-op for dense slot-pool sessions)."""
        block_stats = getattr(self.session, "block_stats", None)
        if block_stats is None:
            return
        b = block_stats()
        self._md.blocks_total.set(b.get("blocks_total", 0))
        self._md.blocks_free.set(b.get("blocks_free", 0))
        self._md.cow_shared.set(b.get("cow_shared_blocks", 0))
        proposed = int(b.get("spec_proposed", 0))
        accepted = int(b.get("spec_accepted", 0))
        d_p = proposed - self._spec_seen[0]
        d_a = accepted - self._spec_seen[1]
        if d_p > 0:
            self._md.spec_proposed.inc(d_p)
        if d_a > 0:
            self._md.spec_accepted.inc(d_a)
        self._spec_seen = (proposed, accepted)

    # -- admission ---------------------------------------------------------

    def submit(self, x, deadline_ms: Optional[float] = None,
               request_id: Optional[str] = None,
               max_new_tokens: Optional[int] = None,
               trace_id: Optional[str] = None) -> GenerationFuture:
        """Admit one generation request. ``x`` is a 1-D token sequence (a
        ``[1, T]`` row is accepted and squeezed). Raises ``ValueError`` on
        non-integer tokens, a bad budget, or a prompt that cannot fit the
        KV cache — caller faults answered at admission (HTTP 400), never a
        500 from deep inside the decode loop."""
        arr = host_array(x)
        if arr.ndim == 2 and arr.shape[0] == 1:
            arr = arr[0]
        if arr.ndim != 1 or arr.shape[0] < 1:
            raise ValueError("generative input must be one non-empty 1-D "
                             f"token sequence (or a [1, T] row); got shape "
                             f"{arr.shape}")
        if not np.issubdtype(arr.dtype, np.integer):
            rounded = np.rint(arr)
            if not np.all(np.isfinite(arr)) or np.abs(arr - rounded).max() > 0:
                raise ValueError("generative input must be integer token ids")
            arr = rounded
        # range-check BEFORE the int32 cast: a negative or 2**40 id would
        # otherwise wrap/clamp inside the embedding gather and generate a
        # plausible-looking 200 from the wrong embedding row
        lo, hi = int(arr.min()), int(arr.max())
        vocab = getattr(self.session, "vocab_size", None)
        cap = (vocab - 1) if vocab is not None else np.iinfo(np.int32).max
        if lo < 0 or hi > cap:
            raise ValueError(
                f"token ids must be in [0, {cap}] "
                f"{'(vocab_size)' if vocab is not None else '(int32)'}; "
                f"got [{lo}, {hi}]")
        arr = arr.astype(np.int32)
        mnt = (max_new_tokens if max_new_tokens is not None
               else self.default_max_new_tokens)
        if mnt < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {mnt}")
        max_len = getattr(self.session, "max_len", None)
        # paged pools reserve extra lookahead positions per admission
        # (speculative drafting lookahead) — price it at the door too
        overhead = int(getattr(self.session, "admit_overhead_tokens", 0) or 0)
        if max_len is not None and arr.shape[0] + mnt + overhead > max_len:
            raise ValueError(
                f"prompt of {arr.shape[0]} tokens + max_new_tokens={mnt} "
                f"{f'+ {overhead} speculative slack ' if overhead else ''}"
                f"exceeds the {max_len}-position KV cache")
        # block-priced admission (paged pools): a request whose WORST-CASE
        # block footprint exceeds the whole arena can never be satisfied —
        # 400 now, not a guaranteed mid-decode eviction later
        req_blocks = getattr(self.session, "request_blocks", None)
        total_blocks = getattr(self.session, "total_blocks", None)
        if req_blocks is not None and total_blocks is not None:
            need = int(req_blocks(int(arr.shape[0]), mnt))
            if need > int(total_blocks):
                raise ValueError(
                    f"prompt of {arr.shape[0]} tokens + max_new_tokens={mnt} "
                    f"needs {need} KV blocks but the paged arena only has "
                    f"{int(total_blocks)} — unsatisfiable at any load")
        ms = (deadline_ms if deadline_ms is not None
              else self.default_deadline_ms)
        deadline = time.monotonic() + ms / 1000.0 if ms is not None else None
        fut = GenerationFuture(
            arr, deadline, mnt, request_id=request_id,
            sampled=span_sampled(request_id, self.span_sample_n),
            trace_id=trace_id)
        return self._admit(fut)

    # -- decode loop -------------------------------------------------------

    def _warmup(self) -> None:
        """Run prefill and one decode step (the paged pool's graph capture)
        before the first customer request: admit the warmup prompt, run one
        decode step, release the slot."""
        prompt = np.asarray(self._warmup_input, np.int32).reshape(-1)
        with inference_mode():
            slot, _ = self.session.admit(prompt, 2)
        try:
            with inference_mode():
                self.session.step()
        finally:
            # a failed warmup step must not leak the slot: _loop swallows
            # the exception and serves on, and at slots=1 a leaked slot is
            # a permanent no-admissions busy-spin outage
            try:
                self.session.release(slot)
            except Exception:
                log.debug("warmup slot %d already freed", slot)
        log.debug("generative warmup: prefill + decode step ready")

    def _loop(self) -> None:
        if self._warmup_input is not None:
            try:
                self._warmup()
            except Exception:
                log.exception("generative warmup failed — the first request "
                              "will pay the graph capture instead")
        self._warm.set()
        active: Dict[int, GenerationFuture] = {}
        while True:
            with self._cv:
                while not self._q and not active and not self._stopping:
                    self._cv.wait()
                stopping, drain = self._stopping, self._drain_on_stop
                if stopping and not drain:
                    # queued requests were already cancelled by stop();
                    # active slots belong to this thread — cancel them here
                    for slot, fut in active.items():
                        self.session.release(slot)
                        self._md.evicted.labels(reason="shutdown").inc()
                        self._evicted += 1
                        fut._resolve(error=ExecutorClosedError(
                            "executor stopped mid-decode"))
                    active.clear()
                    self._md.slot_occupancy.set(0)
                    return
                if stopping and not self._q and not active:
                    return
                candidates: List[GenerationFuture] = []
                blocked_head = False
                if self.continuous or not active:
                    free = self.session.free_slots
                    can_admit = getattr(self.session, "can_admit", None)
                    while self._q and len(candidates) < free:
                        if can_admit is not None:
                            # block-priced head-of-line gate (paged pools):
                            # leave a request that cannot be admitted NOW at
                            # the queue head instead of bouncing it through
                            # an admit/requeue cycle every iteration
                            try:
                                fits = can_admit(self._q[0].x,
                                                 self._q[0].max_new_tokens)
                            except Exception:
                                fits = True  # let admit() produce the error
                            if not fits:
                                blocked_head = True
                                break
                        candidates.append(self._q.popleft())
                    self._m.queue_depth.set(len(self._q))
                if blocked_head and not active and not candidates:
                    # nothing live to retire and the head cannot fit: wait a
                    # beat instead of spinning hot (unreachable for valid
                    # requests — submit() 400s anything an EMPTY arena
                    # cannot hold — but a duck-typed session could get here)
                    self._cv.wait(0.01)
            for fut in candidates:
                self._admit_into_slot(fut, active)
            if not active:
                continue
            self._decode_step(active)
            aggregate.maybe_spool()  # replica's aggregated-/metrics spool

    def _admit_into_slot(self, fut: GenerationFuture,
                         active: Dict[int, GenerationFuture]) -> None:
        now = time.monotonic()
        self._m.queue_wait.observe(now - fut.enqueued_at)
        if fut.deadline is not None and now >= fut.deadline:
            # expired while queued: shed WITHOUT prefilling (same contract
            # as the micro-batching executor's queue_expired path)
            owns = fut._expire(DeadlineExceededError(
                "deadline expired while queued"))
            if owns:
                self._m.shed.labels(reason="queue_expired").inc()
                log.debug("request %s: expired in queue after %.3fs",
                          fut.request_id, now - fut.enqueued_at)
            if fut.sampled:
                flight.record("request_span", request_id=fut.request_id,
                              outcome="shed_deadline", code=504,
                              abandoned=not owns,
                              phases={"queue": now - fut.enqueued_at},
                              **_trace_kw(fut))
            return
        try:
            fault_point("infer")
            with inference_mode():
                slot, first = self.session.admit(fut.x, fut.max_new_tokens)
        except Exception as e:
            if getattr(e, "retry_admission", False):
                # the paged arena is out of blocks RIGHT NOW (another
                # candidate admitted this very iteration took them): put
                # the request back at the head of the line — live
                # sequences retiring will free its blocks; its deadline
                # still shields the queue wait
                with self._cv:
                    self._q.appendleft(fut)
                    self._m.queue_depth.set(len(self._q))
                return
            log.warning("prefill failed for request %s: %s: %s",
                        fut.request_id, type(e).__name__, e)
            fut._resolve(error=e)
            if active and getattr(e, "all_sequences_lost", False):
                # the session's KV cache was lost mid-prefill (duck-typed
                # marker, see transformer.KvCacheLostError): every rider's
                # sequence died with it — fail them now rather than let the
                # next decode step hand them tokens from a zeroed cache
                log.warning("KV cache lost: failing %d in-flight "
                            "generations", len(active))
                for rider in active.values():
                    self._md.evicted.labels(reason="cache_lost").inc()
                    self._evicted += 1
                    rider._resolve(error=e)
                    self._record_abandoned_span(rider)
                active.clear()
                self._md.slot_occupancy.set(0)
            return
        prefill_s = time.monotonic() - now
        self._md.admitted.inc()
        self._admitted += 1
        fut.tokens.append(int(first))
        self._md.tokens.inc()
        self._tokens_out += 1
        if fut.sampled:
            fut.span = {"queue": now - fut.enqueued_at,
                        "prefill": prefill_s, "decode": 0.0,
                        "steps": 0, "step_ms": [], "step_tokens": []}
        if (fut.max_new_tokens == 1
                or (self.eos_id is not None and first == self.eos_id)):
            self.session.release(slot)  # done at prefill: slot never held
            self._finish(fut)
        else:
            active[slot] = fut
        self._sync_session_metrics()

    def _decode_step(self, active: Dict[int, GenerationFuture]) -> None:
        t0 = time.monotonic()
        try:
            fault_point("infer")
            with inference_mode():
                out = self.session.step()
        except Exception as e:  # decode failure → every live rider sees it
            log.warning("decode step failed for requests [%s]: %s: %s",
                        ", ".join(str(f.request_id) for f in active.values()),
                        type(e).__name__, e)
            reason = ("cache_lost" if getattr(e, "all_sequences_lost", False)
                      else "step_error")
            for slot, fut in list(active.items()):
                try:
                    self.session.release(slot)
                except Exception:
                    log.debug("slot %d release failed after step error", slot)
                self._md.evicted.labels(reason=reason).inc()
                self._evicted += 1
                fut._resolve(error=e)
                self._record_abandoned_span(fut)
            active.clear()
            self._md.slot_occupancy.set(0)
            return
        dt = time.monotonic() - t0
        self._md.steps.inc()
        self._md.slot_occupancy.set(len(active))
        self._steps += 1
        self._occupancy_sum += len(active)
        now = time.monotonic()
        emitted_total = 0
        for slot in list(active):
            fut = active[slot]
            # dense sessions emit one int per slot; paged sessions a list
            # (1 token plain, up to spec_tokens+1 speculative) — accept
            # both, clamped to the request's budget and truncated at EOS
            step_out = out[slot]
            if not isinstance(step_out, (list, tuple)):
                step_out = (step_out,)
            fut.steps += 1
            chunk = 0
            hit_eos = False
            for tok in step_out:
                if len(fut.tokens) >= fut.max_new_tokens:
                    break
                fut.tokens.append(int(tok))
                chunk += 1
                if self.eos_id is not None and tok == self.eos_id:
                    hit_eos = True
                    break
            emitted_total += chunk
            if fut.sampled and fut.span is not None:
                fut.span["decode"] += dt
                fut.span["steps"] = fut.steps
                if len(fut.span["step_ms"]) < _SPAN_STEP_CAP:
                    fut.span["step_ms"].append(round(dt * 1e3, 3))
                if len(fut.span["step_tokens"]) < _SPAN_STEP_CAP:
                    fut.span["step_tokens"].append(chunk)
            done = (hit_eos or len(fut.tokens) >= fut.max_new_tokens)
            if done:
                self.session.release(slot)
                del active[slot]
                self._finish(fut)
            elif fut.deadline is not None and now >= fut.deadline:
                # mid-decode deadline: EVICT at the step boundary — the
                # slot frees for a queued request this very iteration, and
                # the waiter's existing 504 path answers the client
                self.session.release(slot)
                del active[slot]
                self._md.evicted.labels(reason="deadline").inc()
                self._evicted += 1
                owns = fut._expire(DeadlineExceededError(
                    f"deadline expired mid-decode after {fut.steps} steps "
                    f"({len(fut.tokens)}/{fut.max_new_tokens} tokens)"))
                if owns:
                    self._m.shed.labels(reason="decode_deadline").inc()
                    log.debug("request %s: evicted mid-decode after %d steps",
                              fut.request_id, fut.steps)
                if fut.sampled:
                    phases = self._span_phases(fut)
                    flight.record("request_span", request_id=fut.request_id,
                                  outcome="shed_deadline", code=504,
                                  abandoned=not owns, **phases,
                                  **_trace_kw(fut))
        self._md.tokens.inc(emitted_total)
        self._tokens_out += emitted_total
        self._md.slot_occupancy.set(len(active))
        self._sync_session_metrics()

    def _finish(self, fut: GenerationFuture) -> None:
        fut._resolve(result=np.asarray(fut.tokens, np.int32))
        self._record_abandoned_span(fut)

    @staticmethod
    def _span_phases(fut: GenerationFuture) -> dict:
        span = dict(fut.span or {})
        extra = {k: span.pop(k) for k in SPAN_EXTRA_KEYS if k in span}
        return {"phases": span, **extra}

    @staticmethod
    def _record_abandoned_span(fut) -> None:
        """Generative twin of the base class hook: an abandoned (waiter
        504'd) sampled request still leaves its decode timeline."""
        with fut._lock:
            abandoned = fut.abandoned
        if abandoned and fut.sampled:
            flight.record("request_span", request_id=fut.request_id,
                          outcome="shed_deadline", code=504, abandoned=True,
                          **GenerativeInferenceExecutor._span_phases(fut),
                          **_trace_kw(fut))

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        """This executor's continuous-batching aggregates (bench evidence):
        decode steps, emitted tokens, admissions/evictions, and MEAN slot
        occupancy per step — the measured batching-efficiency number the
        continuous-vs-static comparison reports. Paged sessions add block
        occupancy, CoW savings and the speculative acceptance rate."""
        s = {
            "steps": self._steps,
            "tokens": self._tokens_out,
            "admitted": self._admitted,
            "evicted": self._evicted,
            "mean_slot_occupancy": (round(self._occupancy_sum / self._steps, 3)
                                    if self._steps else 0.0),
        }
        block_stats = getattr(self.session, "block_stats", None)
        if block_stats is not None:
            b = block_stats()
            s["blocks"] = b
            total = int(b.get("blocks_total", 0))
            s["block_occupancy"] = (
                round(1.0 - b.get("blocks_free", 0) / total, 3) if total else 0.0)
            proposed = int(b.get("spec_proposed", 0))
            s["spec_acceptance"] = (
                round(b.get("spec_accepted", 0) / proposed, 3) if proposed
                else None)
        return s
