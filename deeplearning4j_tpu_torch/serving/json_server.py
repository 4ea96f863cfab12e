"""JsonModelServer — production-hardened HTTP JSON inference (copy of the
JAX package's ``serving.json_server``, with the same status-code contract).

Reference: ``org.deeplearning4j.remote.JsonModelServer``: POST /predict with a JSON body → typed deserializer → model → serializer →
JSON response, with ``ParallelInference`` underneath for batching.

The happy-path shim (global lock, raw model, unbounded socket queueing) is
replaced by admission through :class:`BatchingInferenceExecutor`:

- **backpressure**: queue full ⇒ 429 + ``Retry-After`` — overload is shed at
  admission instead of piling into kernel sockets;
- **deadlines**: ``X-Deadline-Ms`` header (or the server default) bounds how
  long a client can wait; expiry ⇒ 504, and requests that expire while still
  queued never run the model;
- **liveness vs readiness**: ``/health`` answers 200 while the process
  serves; ``/ready`` requires the model warm AND the queue below its high
  watermark, and flips 503 the moment shutdown starts so balancers stop
  routing before the socket closes;
- **graceful drain**: ``stop(drain=True)`` completes every accepted request
  before closing the socket; ``stop`` is idempotent;
- **restart robustness**: ``SO_REUSEADDR`` (rebind the same port during
  TIME_WAIT) and a request-body cap (missing ``Content-Length`` or a body
  over the limit ⇒ 413 — a giant JSON can't OOM the host);
- **observability**: every response, shed, queue-wait, and batch lands in the
  ``tdl_inference_*`` metric families.

Status-code contract: 400 = the CALLER's fault (malformed payload — never
retried), 429/503 = back off and retry (``Retry-After``), 504 = deadline
exceeded, 500 = model failure (retryable against a replica).

The model may live on the card: the executor copies each output to the host
(bfloat16 widened to float32) before the serializer sees it, and a
``ComputationGraph`` is served only with one network output (``ValueError``
when the server is built otherwise).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional, Tuple

import numpy as np

from ..monitoring import flight
from ..monitoring.serving import client_metrics, serving_metrics
from ..parallel.inference import check_single_output, host_array
from .executor import (SPAN_EXTRA_KEYS, BatchingInferenceExecutor,
                       DeadlineExceededError, ExecutorClosedError,
                       QueueFullError)

log = logging.getLogger(__name__)

#: default per-request deadline — nothing waits forever
DEFAULT_DEADLINE_MS = 30_000.0
#: default request-body cap (16 MiB of JSON is already absurd for inference)
DEFAULT_MAX_BODY_BYTES = 16 << 20
#: delta-seconds hint sent with 429/503 (RFC 7231 integer seconds)
RETRY_AFTER_S = 1

#: accepted client-supplied X-Request-Id chars/length; anything else is
#: replaced with a server-generated id (a log-injection-safe correlation key)
_REQUEST_ID_MAX = 128


def _request_id(header_value: Optional[str]) -> str:
    """The request's correlation id: the client's ``X-Request-Id`` when it is
    printable/sane, else a fresh one — echoed on EVERY response (including
    error JSON) and attached to executor log lines, so a client-reported
    slow request can be found in server telemetry."""
    import uuid

    rid = (header_value or "").strip()
    if rid and len(rid) <= _REQUEST_ID_MAX and rid.isprintable():
        return rid
    return uuid.uuid4().hex[:16]


def _trace_id(header_value: Optional[str], rid: str) -> str:
    """The request's TRACE id: adopt the client's/router's
    ``X-Trace-Id`` when sane, else inherit the request id — so one id joins
    the router's ``route`` slice and the replica's ``request_span`` into one
    flow on the fleet timeline, whether or not the hop upstream minted
    one."""
    tr = (header_value or "").strip()
    if tr and len(tr) <= _REQUEST_ID_MAX and tr.isprintable():
        return tr
    return rid


class JsonModelServer:
    def __init__(self, model, port: int = 0,
                 deserializer: Optional[Callable[[Any], np.ndarray]] = None,
                 serializer: Optional[Callable[[np.ndarray], Any]] = None,
                 endpoint: str = "/predict",
                 parallel_inference=None, batch_limit: Optional[int] = None,
                 max_queue: int = 64, max_batch_rows: int = 128,
                 default_deadline_ms: float = DEFAULT_DEADLINE_MS,
                 max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
                 warmup_input=None, registry=None, span_sample_n: int = 1,
                 compile_cache_dir: Optional[str] = None,
                 warmup_all_buckets: Optional[bool] = None,
                 generative_session=None, default_max_new_tokens: int = 32):
        # an explicit cache dir wins; else the TDL_COMPILE_CACHE_DIR env
        # contract — enabled before any warmup launch so a warming replica
        # loads the shared kernel build from disk
        from ..common import compile_cache

        if generative_session is None:
            check_single_output(model)

        if compile_cache_dir:
            compile_cache.enable(compile_cache_dir)
        else:
            compile_cache.maybe_enable_from_env()
        self.warmup_all_buckets = warmup_all_buckets
        self.model = model
        #: a decode slot pool (``models.paged_decode.PagedDecodeSlotPool``,
        #: ``models.transformer.DecodeSlotPool`` or duck-equivalent) flips the server into GENERATIVE mode — the
        #: executor underneath becomes a continuous-batching decode loop and
        #: payloads are token sequences, not feature rows
        self.generative_session = generative_session
        self.default_max_new_tokens = default_max_new_tokens
        if deserializer is None:
            # generative payloads keep their JSON dtype: casting to int32
            # here would silently truncate float token ids before the
            # executor's integer validation (its 400) could reject them
            deserializer = ((lambda d: np.asarray(d))
                            if generative_session is not None
                            else (lambda d: np.asarray(d, np.float32)))
        self.deserializer = deserializer
        self.serializer = serializer or (lambda a: np.asarray(a).tolist())
        self.endpoint = endpoint
        self.parallel_inference = parallel_inference
        self.batch_limit = batch_limit
        self.max_queue = max_queue
        self.max_batch_rows = max_batch_rows
        self.default_deadline_ms = default_deadline_ms
        self.max_body_bytes = max_body_bytes
        self.warmup_input = warmup_input
        self.registry = registry
        self.span_sample_n = span_sample_n
        self.port = port
        self._m = serving_metrics(registry)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._executor: Optional[BatchingInferenceExecutor] = None
        self._shutting_down = False
        self._inflight = 0
        self._inflight_cv = threading.Condition()

    # -- builder parity ----------------------------------------------------
    class Builder:
        """DL4J ``JsonModelServer.Builder`` parity; ``parallel_inference`` /
        ``batch_limit`` mirror wiring a ``ParallelInference`` underneath
        (deliberately dropped DL4J knobs, as in the JAX package:
        ``numWorkers`` — one card per process, and a ``ServingPool`` of
        processes for more — and ``inferenceMode``)."""

        def __init__(self, model):
            self._model = model
            self._kw = {}

        def port(self, p: int):
            self._kw["port"] = p
            return self

        def inference_adapter(self, deserializer, serializer):
            self._kw["deserializer"] = deserializer
            self._kw["serializer"] = serializer
            return self

        def endpoint(self, e: str):
            self._kw["endpoint"] = e
            return self

        def parallel_inference(self, pi):
            self._kw["parallel_inference"] = pi
            return self

        def batch_limit(self, n: int):
            self._kw["batch_limit"] = n
            return self

        def queue_size(self, n: int):
            self._kw["max_queue"] = n
            return self

        def deadline_ms(self, ms: float):
            self._kw["default_deadline_ms"] = ms
            return self

        def max_body_bytes(self, n: int):
            self._kw["max_body_bytes"] = n
            return self

        def warmup_input(self, x):
            self._kw["warmup_input"] = x
            return self

        def generative(self, session):
            """Serve autoregressive GENERATION: ``session`` is a decode slot
            pool (the block-paged ``models.paged_decode.PagedDecodeSlotPool``,
            ``models.transformer.DecodeSlotPool``, or
            duck-equivalent) and the executor underneath becomes the
            continuous-batching decode loop. Payloads are 1-D token
            sequences; responses carry the generated token ids; the
            ``X-Max-New-Tokens`` header bounds one request's budget.

            With a PAGED session admission is priced in KV
            blocks: a prompt+budget that could never fit the arena is a 400
            at the door (prompt length and ``X-Max-New-Tokens`` are both
            checked against the block budget, speculative slack included),
            a momentary block shortage re-queues behind live sequences
            (bounded by the same 429/504 shed paths), and ``GET /stats``
            exposes block occupancy, CoW savings and the speculative
            acceptance rate."""
            self._kw["generative_session"] = session
            return self

        def max_new_tokens(self, n: int):
            """Default per-request generation budget (generative mode)."""
            self._kw["default_max_new_tokens"] = n
            return self

        def compile_cache_dir(self, path: str):
            """Keep the kernel build under ``path`` (``common.compile_cache``):
            a restarted or added replica loads the built kernels from disk
            instead of running nvcc at warmup. Same contract as exporting
            ``TDL_COMPILE_CACHE_DIR``."""
            self._kw["compile_cache_dir"] = path
            return self

        def warmup_all_buckets(self, flag: bool = True):
            """Warm EVERY ParallelInference bucket up to max_batch_rows at
            startup (default: auto — on iff the compile cache is enabled),
            so the first large coalesced batch pays no first-shape cost."""
            self._kw["warmup_all_buckets"] = flag
            return self

        def span_sample(self, n: int):
            """Record a ``request_span`` flight event for ~1/n of requests,
            deterministically by request-id hash (1 = all requests; the
            SAME decision covers ok and shed outcomes, so a sampled
            request's timeline is always complete and an unsampled one
            leaves nothing). Needs flight recording active."""
            self._kw["span_sample_n"] = n
            return self

        def registry(self, r):
            self._kw["registry"] = r
            return self

        def build(self) -> "JsonModelServer":
            return JsonModelServer(self._model, **self._kw)

    def _deserialize(self, payload: Any) -> np.ndarray:
        return self.deserializer(payload)

    # -- request handling --------------------------------------------------

    def _readiness(self) -> Tuple[bool, str]:
        if self._shutting_down or self._executor is None:
            return False, "shutting down"
        if not self._executor.warm:
            return False, "warming up"
        high_watermark = max(1, int(round(0.8 * self.max_queue)))
        depth = self._executor.queue_depth
        if depth >= high_watermark:
            return False, (f"queue depth {depth} at/over "
                           f"high watermark {high_watermark}")
        return True, ""

    def wait_ready(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._readiness()[0]:
                return True
            time.sleep(0.01)
        return False

    @staticmethod
    def _discard_body(handler, length: int) -> None:
        """Drain an unread request body (bounded, chunked) before an early
        error response: closing the socket with unread data pending makes
        the kernel RST the connection, the error response never reaches the
        client, and a retrying client re-uploads the whole body. Bodies past
        the drain cap are abandoned — RST is then the lesser evil."""
        remaining = min(length, 64 << 20)
        try:
            while remaining > 0:
                chunk = handler.rfile.read(min(remaining, 65536))
                if not chunk:
                    return
                remaining -= len(chunk)
        except OSError:
            log.debug("client stalled while its oversized body was drained")

    def _handle_predict(self, handler, rid: Optional[str] = None,
                        trace_id: Optional[str] = None,
                        ) -> Tuple[int, dict, Optional[int]]:
        """Returns (status, json body, Retry-After seconds or None)."""
        rid = rid if rid is not None else _request_id(
            handler.headers.get("X-Request-Id"))
        trace_id = trace_id if trace_id is not None else _trace_id(
            handler.headers.get("X-Trace-Id"), rid)
        content_length = handler.headers.get("Content-Length")
        try:
            length = int(content_length)
        except (TypeError, ValueError):
            length = -1
        if handler.path != self.endpoint:
            self._discard_body(handler, max(0, length))
            return 404, {"error": "unknown endpoint"}, None
        executor = self._executor
        if self._shutting_down or executor is None:
            self._discard_body(handler, max(0, length))
            return 503, {"error": "server shutting down"}, RETRY_AFTER_S
        if content_length is None:
            return 413, {"error": "Content-Length header required"}, None
        if length < 0:
            return 400, {"error": f"bad Content-Length {content_length!r}"}, None
        if length > self.max_body_bytes:
            self._discard_body(handler, length)
            return 413, {"error": f"request body {length}B exceeds "
                                  f"{self.max_body_bytes}B limit"}, None
        try:
            body = handler.rfile.read(length)
        except OSError:
            # socket read timed out (slowloris: Content-Length promised more
            # bytes than the client ever sends) — the handler thread must not
            # wedge holding an _inflight slot
            return 408, {"error": "timed out reading request body"}, None
        deadline_ms: Optional[float] = None
        header = handler.headers.get("X-Deadline-Ms")
        if header is not None:
            try:
                deadline_ms = float(header)
                if deadline_ms <= 0:
                    raise ValueError
            except ValueError:
                return 400, {"error": f"bad X-Deadline-Ms {header!r}"}, None
        submit_kw = {}
        if self.generative_session is not None:
            # per-request token budget (generative mode): the header bounds
            # this request's decode steps; absent → the server default
            mnt = handler.headers.get("X-Max-New-Tokens")
            if mnt is not None:
                try:
                    submit_kw["max_new_tokens"] = int(mnt)
                    if submit_kw["max_new_tokens"] <= 0:
                        raise ValueError
                except ValueError:
                    return 400, {"error": f"bad X-Max-New-Tokens {mnt!r}"}, None
        # 400 = the CALLER's fault (malformed JSON / undecodable payload);
        # clients retry 5xx against a replica but must not retry a bad payload
        try:
            x = self._deserialize(json.loads(body))
        except Exception as e:
            return 400, {"error": f"{type(e).__name__}: {e}"}, None
        try:
            fut = executor.submit(x, deadline_ms=deadline_ms, request_id=rid,
                                  trace_id=trace_id, **submit_kw)
        except QueueFullError as e:
            return 429, {"error": str(e)}, RETRY_AFTER_S
        except ExecutorClosedError as e:
            return 503, {"error": str(e)}, RETRY_AFTER_S
        except (ValueError, TypeError) as e:
            return 400, {"error": f"{type(e).__name__}: {e}"}, None
        remaining = (None if fut.deadline is None
                     else fut.deadline - time.monotonic())
        if not fut.wait(remaining) and fut.abandon():
            # the executor is still busy; the client's budget is spent —
            # answer 504 now rather than hang the connection. abandon()
            # claims the shed accounting so the executor won't also count
            # this request when it later pops it expired
            self._m.shed.labels(reason="deadline").inc()
            log.warning("request %s: deadline exceeded while inference "
                        "still pending", rid)
            return 504, {"error": "deadline exceeded before inference "
                                  "completed"}, None
        if fut.error is not None:
            e = fut.error
            if isinstance(e, DeadlineExceededError):
                # the executor recorded the shed_deadline span when it
                # popped the expired request — don't double-record
                return 504, {"error": str(e)}, None
            if isinstance(e, ExecutorClosedError):
                return 503, {"error": str(e)}, RETRY_AFTER_S
            self._record_span(fut, rid, "error", 500)
            return 500, {"error": f"{type(e).__name__}: {e}"}, None
        t_ser = time.monotonic()
        try:
            body = {"output": self.serializer(fut.result)}
        except Exception as e:
            self._record_span(fut, rid, "error", 500,
                              serialize=time.monotonic() - t_ser)
            return 500, {"error": f"serializer failed: "
                                  f"{type(e).__name__}: {e}"}, None
        self._record_span(fut, rid, "ok", 200,
                          serialize=time.monotonic() - t_ser)
        return 200, body, None

    @staticmethod
    def _record_span(fut, rid: str, outcome: str, code: int,
                     serialize: Optional[float] = None) -> None:
        """Complete a sampled request's ``request_span`` flight event: the
        executor filled queue/batch_form/infer, the HTTP
        layer owns serialize and the outcome. One event per request, keyed
        by the same ``X-Request-Id`` that rides every response — a
        timeline reconstructs with one grep."""
        if not fut.sampled:
            return
        phases = dict(fut.span or {})
        # non-phase span payload: micro-batch rows, and (generative mode)
        # the per-step decode timeline + step count
        extra = {k: phases.pop(k) for k in SPAN_EXTRA_KEYS if k in phases}
        if serialize is not None:
            phases["serialize"] = serialize
        trace_id = getattr(fut, "trace_id", None)
        if trace_id is not None:
            extra["trace_id"] = trace_id
        flight.record("request_span", request_id=rid, outcome=outcome,
                      code=code, phases=phases, **extra)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "JsonModelServer":
        if self._httpd is not None:
            return self
        self._shutting_down = False
        if self.generative_session is not None:
            from .executor import GenerativeInferenceExecutor

            self._executor = GenerativeInferenceExecutor(
                self.generative_session, max_queue=self.max_queue,
                default_max_new_tokens=self.default_max_new_tokens,
                default_deadline_ms=self.default_deadline_ms,
                warmup_prompt=self.warmup_input, registry=self.registry,
                span_sample_n=self.span_sample_n).start()
        else:
            pi = self.parallel_inference
            if pi is None and self.batch_limit is not None:
                from ..parallel.inference import ParallelInference
                pi = ParallelInference(self.model, batch_limit=self.batch_limit)
                self.parallel_inference = pi
            self._executor = BatchingInferenceExecutor(
                model=self.model, parallel_inference=pi,
                max_queue=self.max_queue, max_batch_rows=self.max_batch_rows,
                default_deadline_ms=self.default_deadline_ms,
                warmup_input=self.warmup_input, registry=self.registry,
                span_sample_n=self.span_sample_n,
                warmup_all_buckets=self.warmup_all_buckets).start()
        server = self

        class Handler(BaseHTTPRequestHandler):
            # socket read timeout: a client that stalls mid-request cannot
            # wedge a handler thread forever (socketserver applies this via
            # connection.settimeout)
            timeout = 30.0

            def log_message(self, *args):
                pass

            def _json(self, obj, code=200, retry_after=None, request_id=None,
                      trace_id=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                if request_id is not None:
                    self.send_header("X-Request-Id", request_id)
                if trace_id is not None:
                    self.send_header("X-Trace-Id", trace_id)
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    log.debug("client went away before the response landed")

            def do_POST(self):
                with server._inflight_cv:
                    server._inflight += 1
                try:
                    t0 = time.perf_counter()
                    # the correlation id rides every response — header AND
                    # body (incl. 429/504/413 error JSON), so a client-
                    # reported slow request is greppable in server telemetry
                    rid = _request_id(self.headers.get("X-Request-Id"))
                    tid = _trace_id(self.headers.get("X-Trace-Id"), rid)
                    code, obj, retry_after = server._handle_predict(
                        self, rid, trace_id=tid)
                    obj.setdefault("request_id", rid)
                    self._json(obj, code, retry_after, request_id=rid,
                               trace_id=tid)
                    server._m.requests.labels(code=str(code)).inc()
                    server._m.latency.observe(time.perf_counter() - t0)
                finally:
                    with server._inflight_cv:
                        server._inflight -= 1
                        server._inflight_cv.notify_all()

            def do_GET(self):
                if self.path == "/health":
                    # liveness: the process is up and serving HTTP
                    self._json({"status": "ok"})
                elif self.path == "/ready":
                    ready, reason = server._readiness()
                    if ready:
                        self._json({"ready": True})
                    else:
                        self._json({"ready": False, "reason": reason}, 503,
                                   retry_after=RETRY_AFTER_S)
                elif self.path == "/stats":
                    # executor aggregates (generative mode adds block
                    # occupancy / CoW savings / speculative acceptance from
                    # the paged pool), reachable without a debugger
                    ex = server._executor
                    stats = ex.stats() if hasattr(ex, "stats") else {}
                    self._json({"stats": stats})
                else:
                    self._json({"error": "POST " + server.endpoint}, 404)

        class _Httpd(ThreadingHTTPServer):
            # rebind the same port during TIME_WAIT after a restart
            allow_reuse_address = True
            daemon_threads = True
            # http.server's default listen backlog is 5: a 32-client
            # connect burst overflows it and the kernel RSTs the excess —
            # clients then see resets mid-request under load that the
            # admission queue was supposed to absorb as clean 429s
            request_queue_size = 128

        self._httpd = _Httpd(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         name="tdl-json-server", daemon=True).start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop serving. ``drain=True`` completes every accepted in-flight
        request before the socket closes. Idempotent."""
        httpd = self._httpd
        if httpd is None:
            return
        # readiness flips 503 first so balancers stop routing while we drain
        self._shutting_down = True
        if self._executor is not None:
            self._executor.stop(drain=drain, timeout=timeout)
        deadline = time.monotonic() + timeout
        with self._inflight_cv:
            while self._inflight and time.monotonic() < deadline:
                self._inflight_cv.wait(0.05)
        self._httpd = None
        httpd.shutdown()
        httpd.server_close()


class JsonModelClient:
    """JSON inference client (nd4j-json-client parity) with retry hardening.

    - capped exponential backoff + full jitter on 429/5xx and on connection
      errors (refused/reset while a server restarts), honoring the server's
      ``Retry-After`` hint (capped at ``backoff_max``); other 4xx — a bad
      payload is the caller's fault — are NEVER retried;
    - connection errors are normalized to the same ``RuntimeError`` contract
      as HTTP errors, with the target URL in the message;
    - a consecutive-failure circuit breaker: after ``breaker_threshold``
      consecutive 5xx/429/connection failures the client fails fast for
      ``breaker_cooldown`` seconds, then lets one probe through (half-open);
    - client-side telemetry: every ``predict()``
      observes ``tdl_client_request_seconds{outcome}`` — the wall time the
      CALLER experienced, retries and backoff included — and each retry
      increments ``tdl_client_retries_total{reason}``, so SLO math can be
      grounded where users live, not only at the server.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 9090,
                 endpoint: str = "/predict", timeout: float = 30.0,
                 retries: int = 3, backoff_base: float = 0.05,
                 backoff_max: float = 2.0, breaker_threshold: int = 8,
                 breaker_cooldown: float = 5.0,
                 deadline_ms: Optional[float] = None, registry=None):
        self.url = f"http://{host}:{port}{endpoint}"
        self.timeout = timeout
        self.retries = retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self.deadline_ms = deadline_ms
        self._m = client_metrics(registry)
        self._consecutive_failures = 0
        self._open_until = 0.0
        self._breaker_lock = threading.Lock()

    # -- circuit breaker ---------------------------------------------------

    def _check_breaker(self) -> None:
        with self._breaker_lock:
            if self._consecutive_failures >= self.breaker_threshold:
                now = time.monotonic()
                if now < self._open_until:
                    raise RuntimeError(
                        f"circuit breaker open for {self.url} after "
                        f"{self._consecutive_failures} consecutive failures; "
                        f"retrying after cooldown")
                # half-open: admit THIS call as the single probe and re-arm
                # the window so concurrent callers keep failing fast until
                # the probe resolves (no thundering herd on a down server)
                self._open_until = now + self.breaker_cooldown

    def _record_failure(self) -> None:
        with self._breaker_lock:
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.breaker_threshold:
                self._open_until = time.monotonic() + self.breaker_cooldown

    def _record_success(self) -> None:
        with self._breaker_lock:
            self._consecutive_failures = 0
            self._open_until = 0.0

    def _sleep_backoff(self, attempt: int, retry_after: Optional[str]) -> None:
        import random

        delay = self.backoff_base * (2 ** attempt) * (0.5 + random.random())
        if retry_after is not None:
            try:
                delay = max(delay, float(retry_after))
            except ValueError:
                log.debug("unparseable Retry-After %r ignored", retry_after)
        time.sleep(min(delay, self.backoff_max))

    # -- request -----------------------------------------------------------

    @staticmethod
    def _code_outcome(code: int) -> str:
        if code in (429, 503):
            return "shed"
        if code == 504:
            return "deadline"
        if code >= 500:
            return "server_error"
        return "bad_request"

    def predict(self, data, deadline_ms: Optional[float] = None,
                request_id: Optional[str] = None,
                trace_id: Optional[str] = None) -> Any:
        import http.client
        import urllib.error
        import urllib.request

        t0 = time.perf_counter()
        outcome = "connection"
        try:
            self._check_breaker()
        except RuntimeError:
            self._m.request_seconds.labels("breaker_open").observe(
                time.perf_counter() - t0)
            raise
        body = json.dumps(host_array(data).tolist()).encode()
        headers = {"Content-Type": "application/json"}
        ms = deadline_ms if deadline_ms is not None else self.deadline_ms
        if ms is not None:
            headers["X-Deadline-Ms"] = str(ms)
        if request_id is not None:
            # correlation key: the server echoes it and the
            # executor's request_span timeline joins on it
            headers["X-Request-Id"] = str(request_id)
        if trace_id is not None:
            # fleet-timeline flow key: every hop adopts it, so
            # router + replica lanes join on one id in the merged trace
            headers["X-Trace-Id"] = str(trace_id)
        last_msg = f"no response from {self.url}"
        try:
            for attempt in range(self.retries + 1):
                retry_after = None
                count_failure = True
                req = urllib.request.Request(self.url, data=body,
                                             headers=headers)
                try:
                    with urllib.request.urlopen(req,
                                                timeout=self.timeout) as resp:
                        out = json.loads(resp.read())
                    if "error" in out:
                        outcome = "server_error"
                        raise RuntimeError(out["error"])
                    self._record_success()
                    outcome = "ok"
                    return out["output"]
                except urllib.error.HTTPError as e:
                    # non-2xx raises BEFORE the structured error body is
                    # read — surface the server's JSON error, not a bare
                    # "HTTP Error 400"
                    try:
                        detail = json.loads(e.read()).get("error", "")
                    except (ValueError, KeyError, AttributeError):
                        detail = ""
                    last_msg = (f"server returned HTTP {e.code}: "
                                f"{detail or e.reason}")
                    outcome = self._code_outcome(e.code)
                    if e.code != 429 and e.code < 500:
                        # the payload is wrong; retrying cannot fix it
                        raise RuntimeError(last_msg) from None
                    retry_reason = f"http_{e.code}"
                    retry_after = (e.headers.get("Retry-After")
                                   if e.headers else None)
                    if e.code == 503 and "pool not ready" in (detail or ""):
                        # a router 503 during a rolling restart is the
                        # pool's 429: back off per its
                        # Retry-After, count the retry under its own label,
                        # and NEVER let a single not-ready probe march the
                        # circuit breaker toward open — replicas restarting
                        # is normal operation, not a failing endpoint
                        retry_reason = "pool_unready"
                        count_failure = False
                except urllib.error.URLError as e:
                    last_msg = f"cannot reach {self.url}: {e.reason}"
                    outcome = "connection"
                    retry_reason = "connection"
                except (OSError, http.client.HTTPException, ValueError) as e:
                    # a reset/truncation MID-RESPONSE (connection reset while
                    # reading the body, RemoteDisconnected, torn JSON) is a
                    # connection error like any other: the documented contract
                    # retries it, it must not escape as a raw
                    # ConnectionResetError
                    last_msg = (f"connection error to {self.url}: "
                                f"{type(e).__name__}: {e}")
                    outcome = "connection"
                    retry_reason = "connection"
                if count_failure:
                    self._record_failure()
                if attempt >= self.retries:
                    break
                with self._breaker_lock:
                    breaker_open = (self._consecutive_failures
                                    >= self.breaker_threshold)
                if breaker_open:
                    break
                self._m.retries.labels(retry_reason).inc()
                self._sleep_backoff(attempt, retry_after)
            raise RuntimeError(last_msg) from None
        finally:
            self._m.request_seconds.labels(outcome).observe(
                time.perf_counter() - t0)
