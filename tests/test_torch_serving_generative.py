"""Port continuous-batching generative serving:
``deeplearning4j_tpu_torch.serving.GenerativeInferenceExecutor`` behind
``JsonModelServer``, mirroring the JAX package's
``tests/test_serving_generative.py`` scenarios on the CPU.

The executor contract under test: requests admit into free KV slots AT STEP
BOUNDARIES and retire the moment they finish, deadlines evict mid-decode
through the 504 path, and the decode loop's truth lands in the
``tdl_decode_*`` families. A pure-python FakeSession keeps the semantics
tests fast; the end-to-end tests run the port's paged slot pool through the
HTTP server, held token for token to the JAX package's pool behind the JAX
package's server (a tiny causal float32 config, ``params_from_jax``).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import paged_decode as JP
from deeplearning4j_tpu.models import transformer as J
from deeplearning4j_tpu_torch.models import paged_decode as P
from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models.weights import params_from_jax
from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
from deeplearning4j_tpu_torch.serving import (DeadlineExceededError,
                                              ExecutorClosedError,
                                              GenerativeInferenceExecutor,
                                              JsonModelClient, JsonModelServer,
                                              QueueFullError)
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401


class FakeSession:
    """Deterministic slot-pool stand-in: every sequence emits
    ``prompt[-1] + 1, +2, ...``; ``step_delay`` simulates decode-step cost."""

    def __init__(self, slots=4, max_len=64, step_delay=0.0, eos_id=None):
        self.slots = slots
        self.max_len = max_len
        self.step_delay = step_delay
        self.eos_id = eos_id
        self._next = {}
        self.admit_log = []
        self.steps_run = 0

    @property
    def free_slots(self):
        return self.slots - len(self._next)

    def admit(self, prompt, max_new_tokens):
        prompt = np.asarray(prompt)
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError("prompt too long for the cache")
        if len(self._next) >= self.slots:
            raise RuntimeError("no free decode slot")
        slot = min(set(range(self.slots)) - set(self._next))
        first = int(prompt[-1]) + 1
        self._next[slot] = first + 1
        self.admit_log.append((slot, int(prompt[-1]), max_new_tokens))
        return slot, first

    def step(self):
        if self.step_delay:
            time.sleep(self.step_delay)
        self.steps_run += 1
        out = {s: t for s, t in self._next.items()}
        self._next = {s: t + 1 for s, t in self._next.items()}
        return out

    def release(self, slot):
        del self._next[slot]


def _counter_values(reg, name):
    m = reg.get(name)
    if m is None:
        return {}
    return {tuple(s["labels"].values()): s["value"]
            for s in m.snapshot()["series"]}


# ---------------------------------------------------------------- executor


def test_generation_completes_and_tokens_are_sequential():
    reg = MetricsRegistry()
    ex = GenerativeInferenceExecutor(FakeSession(), registry=reg).start()
    try:
        fut = ex.submit([3, 7], max_new_tokens=5)
        assert fut.wait(10.0) and fut.error is None
        np.testing.assert_array_equal(fut.result, [8, 9, 10, 11, 12])
        assert _counter_values(reg, "tdl_decode_admitted_total")[()] == 1
        assert _counter_values(reg, "tdl_decode_steps_total")[()] >= 4
        assert _counter_values(reg, "tdl_decode_tokens_total")[()] >= 5
    finally:
        ex.stop(drain=True)


def test_continuous_batching_short_request_overtakes_long():
    """The p99 claim itself: a short request admitted while a long decode is
    mid-flight finishes FIRST — nobody waits for the slowest batch member."""
    session = FakeSession(slots=2, step_delay=0.01)
    ex = GenerativeInferenceExecutor(session, continuous=True).start()
    try:
        long_fut = ex.submit([1], max_new_tokens=60)
        time.sleep(0.08)  # the long decode is well underway
        short_fut = ex.submit([1], max_new_tokens=3)
        assert short_fut.wait(10.0) and short_fut.error is None
        assert not long_fut.done  # the long request is STILL decoding
        assert long_fut.wait(10.0) and long_fut.error is None
        assert len(long_fut.result) == 60 and len(short_fut.result) == 3
        stats = ex.stats()
        assert stats["mean_slot_occupancy"] > 1.0  # they genuinely shared steps
    finally:
        ex.stop(drain=True)


def test_static_batching_mode_waits_for_slowest_member():
    """continuous=False is the measured strawman: admission only into an
    EMPTY pool, so a late short request waits for the running batch."""
    session = FakeSession(slots=2, step_delay=0.01)
    ex = GenerativeInferenceExecutor(session, continuous=False).start()
    try:
        long_fut = ex.submit([1], max_new_tokens=40)
        time.sleep(0.05)
        short_fut = ex.submit([1], max_new_tokens=2)
        assert long_fut.wait(10.0) and long_fut.error is None
        # the short request could not share the pool: it was admitted only
        # after the long batch drained
        assert short_fut.wait(10.0) and short_fut.error is None
        long_admit = session.admit_log[0]
        short_admit = session.admit_log[1]
        assert long_admit[2] == 40 and short_admit[2] == 2
        assert ex.stats()["mean_slot_occupancy"] <= 1.0
    finally:
        ex.stop(drain=True)


def test_deadline_evicts_mid_decode_and_frees_the_slot():
    reg = MetricsRegistry()
    session = FakeSession(slots=1, max_len=100_000, step_delay=0.02)
    ex = GenerativeInferenceExecutor(session, registry=reg).start()
    try:
        doomed = ex.submit([1], max_new_tokens=10_000, deadline_ms=120)
        assert doomed.wait(10.0)
        assert isinstance(doomed.error, DeadlineExceededError)
        assert "mid-decode" in str(doomed.error)
        # the slot freed at the eviction boundary: a new request completes
        nxt = ex.submit([5], max_new_tokens=2)
        assert nxt.wait(10.0) and nxt.error is None
        np.testing.assert_array_equal(nxt.result, [6, 7])
        evicted = _counter_values(reg, "tdl_decode_evicted_total")
        assert evicted[("deadline",)] == 1
        shed = _counter_values(reg, "tdl_inference_shed_total")
        assert shed[("decode_deadline",)] == 1
    finally:
        ex.stop(drain=True)


def test_eos_retires_immediately():
    session = FakeSession(slots=2, eos_id=10)
    ex = GenerativeInferenceExecutor(session).start()
    try:
        fut = ex.submit([7], max_new_tokens=50)  # emits 8, 9, 10=eos
        assert fut.wait(10.0) and fut.error is None
        np.testing.assert_array_equal(fut.result, [8, 9, 10])
    finally:
        ex.stop(drain=True)


def test_queue_full_and_submit_validation():
    session = FakeSession(slots=1, step_delay=0.05)
    ex = GenerativeInferenceExecutor(session, max_queue=1).start()
    try:
        running = ex.submit([1], max_new_tokens=50)
        time.sleep(0.05)  # it is decoding; the queue slot is free
        queued = ex.submit([2], max_new_tokens=2)
        with pytest.raises(QueueFullError):
            ex.submit([3], max_new_tokens=2)
        with pytest.raises(ValueError, match="token ids"):
            ex.submit([1.5], max_new_tokens=2)
        with pytest.raises(ValueError, match="1-D"):
            ex.submit(np.zeros((2, 3), np.int32), max_new_tokens=2)
        with pytest.raises(ValueError, match="max_new_tokens"):
            ex.submit([1], max_new_tokens=0)
        with pytest.raises(ValueError, match="KV cache"):
            ex.submit(list(range(60)), max_new_tokens=10)
        ex.stop(drain=True)  # drain completes both accepted requests
        assert running.done and running.error is None
        assert queued.done and queued.error is None
    finally:
        ex.stop(drain=True)


def test_submit_rejects_out_of_range_token_ids():
    """An id past the session's vocab (or negative / past int32) must be a
    400-class ValueError at admission — the embedding gather would clamp
    or wrap it into a plausible-looking 200 from the wrong row."""
    session = FakeSession(slots=1)
    session.vocab_size = 100
    ex = GenerativeInferenceExecutor(session).start()
    try:
        with pytest.raises(ValueError, match=r"token ids must be in \[0, 99\]"):
            ex.submit([150], max_new_tokens=1)
        with pytest.raises(ValueError, match="token ids must be in"):
            ex.submit([-5], max_new_tokens=1)
        fut = ex.submit([42], max_new_tokens=2)  # in range: serves fine
        assert fut.wait(10.0) and fut.error is None
    finally:
        ex.stop(drain=True)


def test_decode_step_failure_counts_evictions_and_serves_on():
    """A step() failure kills every rider: each one counts under
    tdl_decode_evicted_total (cache_lost when the session lost its KV
    cache, step_error otherwise) so stats()['evicted'] agrees with the
    number of killed generations whichever call faulted."""
    class FailingStep(FakeSession):
        fail_next = False

        def step(self):
            if self.fail_next:
                self.fail_next = False
                self._next = {}  # the pool's reset frees every slot
                err = RuntimeError("device fault mid-step; cache reset")
                err.all_sequences_lost = True
                raise err
            return super().step()

    reg = MetricsRegistry()
    session = FailingStep(slots=2, max_len=100_000, step_delay=0.01)
    ex = GenerativeInferenceExecutor(session, registry=reg).start()
    try:
        fut = ex.submit([1], max_new_tokens=10_000)
        time.sleep(0.05)  # decoding
        session.fail_next = True
        assert fut.wait(10.0)
        assert getattr(fut.error, "all_sequences_lost", False)
        evicted = _counter_values(reg, "tdl_decode_evicted_total")
        assert evicted[("cache_lost",)] == 1
        assert ex.stats()["evicted"] == 1
        nxt = ex.submit([7], max_new_tokens=2)  # not poisoned
        assert nxt.wait(10.0) and nxt.error is None
    finally:
        ex.stop(drain=True)


def test_warmup_step_failure_does_not_leak_the_slot():
    """A warmup whose decode step raises must still release its slot: _loop
    swallows the warmup error and serves on, and at slots=1 a leaked
    warmup slot would be a permanent no-admissions outage."""
    class FailFirstStep(FakeSession):
        def step(self):
            if self.steps_run == 0:
                self.steps_run += 1
                raise RuntimeError("injected warmup step failure")
            return super().step()

    session = FailFirstStep(slots=1)
    ex = GenerativeInferenceExecutor(session, registry=MetricsRegistry(),
                                     warmup_prompt=[1]).start()
    try:
        assert ex.wait_warm(10.0)
        assert session.free_slots == 1  # released despite the failed step
        fut = ex.submit([4], max_new_tokens=3)
        assert fut.wait(10.0) and fut.error is None
        assert fut.tokens == [5, 6, 7]
    finally:
        ex.stop(drain=True)


def test_cache_lost_fails_riders_and_executor_serves_on():
    """A session admit that fails with the ``all_sequences_lost`` marker
    (transformer.KvCacheLostError's duck-typed contract: the KV cache was
    reset, every in-flight sequence died with it) must fail the ACTIVE
    riders too — not leave them waiting for tokens from a zeroed cache —
    and the executor keeps serving afterwards."""
    class CacheLossy(FakeSession):
        lose_on_admit = None

        def admit(self, prompt, max_new_tokens):
            if self.lose_on_admit and len(self.admit_log) + 1 == self.lose_on_admit:
                self._next = {}  # the pool's reset frees every slot
                err = RuntimeError("device fault mid-prefill; cache reset")
                err.all_sequences_lost = True
                raise err
            return super().admit(prompt, max_new_tokens)

    reg = MetricsRegistry()
    session = CacheLossy(slots=2, max_len=100_000, step_delay=0.01)
    ex = GenerativeInferenceExecutor(session, registry=reg).start()
    try:
        rider = ex.submit([1], max_new_tokens=10_000)  # long-lived
        time.sleep(0.05)  # it is decoding in a slot
        session.lose_on_admit = 2
        victim = ex.submit([2], max_new_tokens=5)
        assert victim.wait(10.0) and victim.error is not None
        assert rider.wait(10.0) and rider.error is not None
        assert getattr(rider.error, "all_sequences_lost", False)
        evicted = _counter_values(reg, "tdl_decode_evicted_total")
        assert evicted[("cache_lost",)] == 1
        # the executor is not poisoned: the next request completes
        session.lose_on_admit = None
        fut = ex.submit([7], max_new_tokens=2)
        assert fut.wait(10.0) and fut.error is None
        assert fut.tokens == [8, 9]
    finally:
        ex.stop(drain=True)


def test_stop_without_drain_cancels_active_and_queued():
    session = FakeSession(slots=1, max_len=100_000, step_delay=0.02)
    ex = GenerativeInferenceExecutor(session, max_queue=4).start()
    active = ex.submit([1], max_new_tokens=10_000)
    time.sleep(0.05)
    queued = ex.submit([2], max_new_tokens=5)
    ex.stop(drain=False, timeout=10.0)
    assert active.wait(5.0) and isinstance(active.error, ExecutorClosedError)
    assert queued.wait(5.0) and isinstance(queued.error, ExecutorClosedError)


# ------------------------------------------------------------------- server


def _post_tokens(port, tokens, headers=None, timeout=15):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps(tokens).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_server_generative_mode_end_to_end():
    reg = MetricsRegistry()
    server = JsonModelServer(None, generative_session=FakeSession(),
                             default_max_new_tokens=4, registry=reg,
                             warmup_input=[1]).start()
    try:
        assert server.wait_ready(30.0)
        status, out = _post_tokens(server.port, [4, 9])
        assert status == 200
        assert out["output"] == [10, 11, 12, 13]
        # per-request budget via header
        status, out = _post_tokens(server.port, [4, 9],
                                   headers={"X-Max-New-Tokens": "2"})
        assert out["output"] == [10, 11]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_tokens(server.port, [4, 9],
                         headers={"X-Max-New-Tokens": "zero"})
        assert ei.value.code == 400
        # non-integer payload is the caller's fault
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_tokens(server.port, [["no"]])
        assert ei.value.code == 400
        # float token ids 400 too — the wire deserializer must not silently
        # truncate them to int32 before the executor's validation
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_tokens(server.port, [4.5, 9.2])
        assert ei.value.code == 400
        codes = _counter_values(reg, "tdl_inference_requests_total")
        assert codes[("200",)] == 2
    finally:
        server.stop()


def test_server_generative_deadline_504():
    server = JsonModelServer(
        None, generative_session=FakeSession(max_len=100_000, step_delay=0.02),
        default_max_new_tokens=10_000, registry=MetricsRegistry()).start()
    try:
        assert server.wait_ready(30.0)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_tokens(server.port, [1],
                         headers={"X-Deadline-Ms": "150"})
        assert ei.value.code == 504
    finally:
        server.stop()


def _tiny_pools(slots=2, **kw):
    """(JAX paged pool, port paged pool, JAX params, JAX config) of one tiny
    causal float32 model, the port's with the JAX weights."""
    shape = dict(causal=True, dropout=0.0, vocab_size=64, max_len=32,
                 d_model=32, n_heads=2, n_layers=2, d_ff=64)
    jc = J.TransformerConfig(param_dtype=jnp.float32, compute_dtype=jnp.float32,
                             attn_impl="xla", **shape)
    tc = T.TransformerConfig(param_dtype=torch.float32, compute_dtype=torch.float32,
                             attn_impl="xla", **shape)
    jp = J.init_params(jax.random.key(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return (JP.PagedDecodeSlotPool(jp, jc, slots=slots, block_T=8, **kw),
            P.PagedDecodeSlotPool(tp, tc, slots=slots, block_T=8, device="cpu", **kw),
            jp, jc)


def test_server_generative_with_real_paged_pool():
    """End to end against the port's paged KV-cache pool: HTTP tokens in,
    greedy continuation out, identical to the JAX package's offline
    generate() on the same weights."""
    _, pool, jp, jc = _tiny_pools()
    prompt = [3, 11, 7]
    expected = J.generate(jp, [prompt], 5, jc)[0]
    server = JsonModelServer(None, generative_session=pool,
                             default_max_new_tokens=5, warmup_input=[1],
                             registry=MetricsRegistry()).start()
    try:
        assert server.wait_ready(60.0)
        assert JsonModelClient(port=server.port).predict(prompt) == expected
        assert pool.free_slots == pool.slots
    finally:
        server.stop()


def test_port_and_jax_generative_servers_agree():
    """The JAX package's PagedDecodeSlotPool behind its server and the
    port's (its weights) behind the port's give identical tokens for the
    same concurrent prompts, and the same 400 for a prompt the KV cache
    cannot hold."""
    from deeplearning4j_tpu.monitoring import MetricsRegistry as JRegistry
    from deeplearning4j_tpu.serving import JsonModelClient as JClient
    from deeplearning4j_tpu.serving import JsonModelServer as JServer

    jpool, tpool, _, _ = _tiny_pools(slots=3)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(1, 64, n).tolist() for n in (3, 9, 17, 5, 12, 2)]
    jserver = JServer(None, generative_session=jpool, default_max_new_tokens=6,
                      registry=JRegistry()).start()
    tserver = JsonModelServer(None, generative_session=tpool,
                              default_max_new_tokens=6,
                              registry=MetricsRegistry()).start()
    try:
        results = {}

        def run(name, client, i, p):
            results[(name, i)] = client.predict(p)

        threads = [threading.Thread(target=run, args=(name, cls(port=port), i, p))
                   for name, cls, port in (("jax", JClient, jserver.port),
                                           ("port", JsonModelClient, tserver.port))
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        for i in range(len(prompts)):
            assert results[("port", i)] == results[("jax", i)]
            assert all(isinstance(tok, int) for tok in results[("port", i)])
        codes = []
        for port in (jserver.port, tserver.port):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post_tokens(port, list(range(1, 31)))
            codes.append((ei.value.code, "KV" in json.loads(ei.value.read())["error"]))
        assert codes == [(400, True), (400, True)]
    finally:
        jserver.stop()
        tserver.stop()


def test_generative_request_span_carries_decode_timeline():
    """A sampled generative 200's span reconstructs queue → prefill →
    decode with the per-step timeline and step count."""
    from deeplearning4j_tpu_torch.monitoring import flight
    from deeplearning4j_tpu_torch.monitoring.flight import FlightRecorder

    rec = FlightRecorder(proc="gen-span-test", capacity=1024)
    flight.set_flight_recorder(rec)
    server = JsonModelServer(None, generative_session=FakeSession(),
                             default_max_new_tokens=4,
                             registry=MetricsRegistry()).start()
    try:
        assert server.wait_ready(30.0)
        _post_tokens(server.port, [2],
                     headers={"X-Request-Id": "gen-span-1"})
        spans = [e for e in rec.events() if e["kind"] == "request_span"
                 and e.get("request_id") == "gen-span-1"]
        assert len(spans) == 1
        ev = spans[0]
        assert ev["outcome"] == "ok" and ev["code"] == 200
        assert set(ev["phases"]) == {"queue", "prefill", "decode",
                                     "serialize"}
        assert ev["steps"] == 3  # 4 tokens = 1 prefill + 3 decode steps
        assert len(ev["step_ms"]) == 3
    finally:
        server.stop()
        flight.set_flight_recorder(None)
