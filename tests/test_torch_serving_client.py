"""Port serving: ``JsonModelClient`` (retries, circuit breaker, client
metrics), request ids and request spans, mirroring the JAX package's
``tests/test_serving.py`` scenarios; and the status codes of the port's
server held to the JAX package's server on the same malformed, oversized,
overloaded and late requests.
"""

import json
import logging
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch.monitoring import MetricsRegistry, flight
from deeplearning4j_tpu_torch.monitoring.flight import FlightRecorder
from deeplearning4j_tpu_torch.serving import JsonModelClient, JsonModelServer
from deeplearning4j_tpu_torch.serving.executor import span_sampled
from deeplearning4j_tpu_torch.serving.json_server import _request_id
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401
from torch_serving_helpers import FlakyModel, SlowModel, counter_values


def _dead_port():
    with socket.socket() as s:  # grab a port that is certainly closed
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------------- client


def test_client_normalizes_connection_refused():
    client = JsonModelClient(port=_dead_port(), retries=0)
    with pytest.raises(RuntimeError) as ei:
        client.predict([[1.0]])
    assert client.url in str(ei.value)  # not a raw URLError escaping


def test_client_retries_converge_on_success():
    model = FlakyModel(fail_first=2)
    server = JsonModelServer(model).start()
    try:
        client = JsonModelClient(port=server.port, retries=4,
                                 backoff_base=0.01, backoff_max=0.05)
        got = client.predict([[1.0, 2.0, 3.0, 4.0]])
        np.testing.assert_allclose(got, [[2.0, 4.0, 6.0, 8.0]])
        assert model.calls == 3  # two 500s retried, third attempt lands
    finally:
        server.stop()


def test_client_never_retries_400():
    server = JsonModelServer(SlowModel()).start()
    try:
        client = JsonModelClient(port=server.port, retries=5, backoff_base=0.01)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="400"):
            client.predict(["not", "numbers"])
        assert time.perf_counter() - t0 < 1.0  # no backoff loop happened
    finally:
        server.stop()


def test_client_circuit_breaker_opens_and_half_opens():
    class Boom:
        def __init__(self):
            self.calls = 0

        def output(self, x):
            self.calls += 1
            raise RuntimeError("replica wedged")

    model = Boom()
    server = JsonModelServer(model).start()
    try:
        client = JsonModelClient(port=server.port, retries=0, backoff_base=0.01,
                                 breaker_threshold=2, breaker_cooldown=0.2)
        for _ in range(2):
            with pytest.raises(RuntimeError, match="500"):
                client.predict([[1.0, 2.0, 3.0, 4.0]])
        assert model.calls == 2
        with pytest.raises(RuntimeError, match="circuit breaker open"):
            client.predict([[1.0, 2.0, 3.0, 4.0]])
        assert model.calls == 2  # failed fast without touching the server
        time.sleep(0.25)  # cooldown elapses → half-open probe goes through
        with pytest.raises(RuntimeError, match="500"):
            client.predict([[1.0, 2.0, 3.0, 4.0]])
        assert model.calls == 3
    finally:
        server.stop()


def test_client_metrics_record_outcomes_and_retries():
    reg = MetricsRegistry()
    model = FlakyModel(fail_first=2)
    server = JsonModelServer(model).start()
    try:
        client = JsonModelClient(port=server.port, retries=4, backoff_base=0.01,
                                 backoff_max=0.05, registry=reg)
        client.predict([[1.0, 2.0, 3.0, 4.0]])  # two 500s then success
        hist = reg.get("tdl_client_request_seconds").snapshot()["series"]
        assert {s["labels"]["outcome"]: s["count"] for s in hist} == {"ok": 1}
        assert counter_values(reg, "tdl_client_retries_total")[("http_500",)] == 2
        with pytest.raises(RuntimeError, match="400"):
            client.predict(["not", "numbers"])
        by_outcome = {s["labels"]["outcome"]: s["count"] for s in
                      reg.get("tdl_client_request_seconds").snapshot()["series"]}
        assert by_outcome == {"ok": 1, "bad_request": 1}
    finally:
        server.stop()


def test_client_metrics_connection_and_breaker_outcomes():
    reg = MetricsRegistry()
    client = JsonModelClient(port=_dead_port(), retries=0, breaker_threshold=1,
                             breaker_cooldown=30.0, registry=reg)
    with pytest.raises(RuntimeError):
        client.predict([[1.0]])
    with pytest.raises(RuntimeError, match="circuit breaker open"):
        client.predict([[1.0]])
    by_outcome = {s["labels"]["outcome"]: s["count"] for s in
                  reg.get("tdl_client_request_seconds").snapshot()["series"]}
    assert by_outcome == {"connection": 1, "breaker_open": 1}


# ------------------------------------------------------------ request ids


def test_request_id_echoed_on_success_and_generated_when_absent():
    server = JsonModelServer(SlowModel(), registry=MetricsRegistry()).start()
    try:
        body = json.dumps([[1.0, 2.0, 3.0, 4.0]]).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/predict", data=body,
            headers={"Content-Type": "application/json",
                     "X-Request-Id": "client-abc-123"})
        with urllib.request.urlopen(req, timeout=15) as resp:
            assert resp.headers["X-Request-Id"] == "client-abc-123"
            assert json.loads(resp.read())["request_id"] == "client-abc-123"
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/predict", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=15) as resp:
            rid = resp.headers["X-Request-Id"]
            assert rid and json.loads(resp.read())["request_id"] == rid
    finally:
        server.stop()


def test_request_id_rides_error_responses_and_logs(caplog):
    model = SlowModel(delay=0.6)
    server = JsonModelServer(model, max_queue=1, max_body_bytes=256,
                             registry=MetricsRegistry()).start()
    try:
        big = json.dumps([[0.0] * 2000]).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/predict", data=big,
            headers={"Content-Type": "application/json", "X-Request-Id": "too-big-1"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=15)
        assert ei.value.code == 413
        assert ei.value.headers["X-Request-Id"] == "too-big-1"
        assert json.loads(ei.value.read())["request_id"] == "too-big-1"
        ok = json.dumps([[1.0, 2.0, 3.0, 4.0]]).encode()
        results = []

        def fire(rid):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/predict", data=ok,
                headers={"Content-Type": "application/json", "X-Request-Id": rid})
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    results.append((200, json.loads(resp.read())))
            except urllib.error.HTTPError as e:
                results.append((e.code, json.loads(e.read()),
                                e.headers.get("X-Request-Id")))

        with caplog.at_level(logging.DEBUG, logger="deeplearning4j_tpu_torch.serving"):
            threads = [threading.Thread(target=fire, args=(f"rid-{i}",))
                       for i in range(6)]
            for t in threads:
                t.start()
                time.sleep(0.02)
            for t in threads:
                t.join(30.0)
        shed = [r for r in results if r[0] == 429]
        assert shed, f"no 429 among {[r[0] for r in results]}"
        _, body429, hdr = shed[0]
        assert body429["request_id"].startswith("rid-")
        assert hdr == body429["request_id"]
        assert any("admission queue full" in r.message and "rid-" in r.message
                   for r in caplog.records)
    finally:
        server.stop()


def test_request_id_sanitizes_garbage_header():
    assert _request_id("ok-id") == "ok-id"
    generated = _request_id("bad\nid")
    assert "\n" not in generated and len(generated) == 16
    assert len(_request_id("x" * 500)) == 16  # over-long → replaced
    assert len(_request_id(None)) == 16


# ---------------------------------------------------------- request spans


def _spans(rec, rid=None):
    return [e for e in rec.events() if e["kind"] == "request_span"
            and (rid is None or e.get("request_id") == rid)]


@pytest.fixture
def recorder():
    rec = FlightRecorder(proc="span-test", capacity=4096)
    flight.set_flight_recorder(rec)
    yield rec
    flight.set_flight_recorder(None)


def test_request_span_for_200_carries_full_phase_timeline(recorder):
    server = JsonModelServer(SlowModel(), registry=MetricsRegistry()).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/predict",
            data=json.dumps([[1.0, 2.0, 3.0, 4.0]]).encode(),
            headers={"Content-Type": "application/json", "X-Request-Id": "span-ok-1"})
        with urllib.request.urlopen(req, timeout=15) as resp:
            assert resp.status == 200
        spans = _spans(recorder, "span-ok-1")
        assert len(spans) == 1
        ev = spans[0]
        assert ev["outcome"] == "ok" and ev["code"] == 200
        assert set(ev["phases"]) == {"queue", "batch_form", "infer", "serialize"}
        assert all(v >= 0 for v in ev["phases"].values())
        assert ev["batch_rows"] >= 1
    finally:
        server.stop()


def test_request_span_for_shed_queue_full_and_expired_deadline(recorder):
    model = SlowModel(delay=0.4)
    server = JsonModelServer(model, max_queue=1, registry=MetricsRegistry()).start()
    try:
        ok = json.dumps([[1.0, 2.0, 3.0, 4.0]]).encode()

        def fire(rid, deadline_ms=None):
            headers = {"Content-Type": "application/json", "X-Request-Id": rid}
            if deadline_ms:
                headers["X-Deadline-Ms"] = str(deadline_ms)
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/predict", data=ok, headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    return resp.status
            except urllib.error.HTTPError as e:
                e.read()
                return e.code

        t1 = threading.Thread(target=fire, args=("span-first",))
        t1.start()
        assert model.started.wait(5.0)
        t2 = threading.Thread(target=fire, args=("span-expired", 100))
        t2.start()
        time.sleep(0.1)
        assert fire("span-full") == 429
        t1.join(30.0)
        t2.join(30.0)
        server.stop(drain=True)
        full = _spans(recorder, "span-full")
        assert len(full) == 1 and full[0]["outcome"] == "shed_queue_full"
        expired = _spans(recorder, "span-expired")
        assert len(expired) == 1 and expired[0]["outcome"] == "shed_deadline"
        assert expired[0]["phases"]["queue"] >= 0.1  # its life WAS the queue
        first = _spans(recorder, "span-first")
        assert len(first) == 1 and first[0]["outcome"] == "ok"
    finally:
        server.stop()


def test_span_sampling_is_deterministic_by_request_id():
    assert not span_sampled("abc", 1)  # no recorder: never sampled
    flight.set_flight_recorder(FlightRecorder(proc="sample-test"))
    try:
        assert span_sampled("abc", 1)
        assert span_sampled(None, 1)
        verdicts = {rid: span_sampled(rid, 4) for rid in (f"r{i}" for i in range(64))}
        assert verdicts == {rid: span_sampled(rid, 4) for rid in verdicts}
        assert 0 < sum(verdicts.values()) < 64  # ~1/4 sampled
        assert not span_sampled(None, 4)
    finally:
        flight.set_flight_recorder(None)


# ------------------------------------------------- against the JAX package


def _status(port, body, headers):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=body,
        headers={"Content-Type": "application/json", **headers})
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        e.read()
        return e.code


def _overload(port, model):
    """Fill the one-slot queue behind a slow forward; the third request."""
    body = b"[[1.0, 2.0, 3.0, 4.0]]"
    threads = [threading.Thread(target=_status, args=(port, body, {}))]
    threads[0].start()
    assert model.started.wait(5.0)
    threads.append(threading.Thread(target=_status, args=(port, body, {})))
    threads[1].start()
    time.sleep(0.1)
    code = _status(port, body, {})
    for t in threads:
        t.join(15.0)
    return code


@pytest.mark.parametrize("case,want", [
    ("malformed", 400), ("oversized", 413), ("queue_full", 429), ("late", 504)])
def test_status_codes_match_the_jax_server(case, want):
    """The port's server and the JAX package's give the same status code for
    the same bad request: a non-numeric payload, a body over the cap, a
    request behind a full queue, a deadline shorter than the forward."""
    from deeplearning4j_tpu.monitoring import MetricsRegistry as JRegistry
    from deeplearning4j_tpu.serving import JsonModelServer as JServer

    codes = []
    for Server, Registry in ((JServer, JRegistry), (JsonModelServer, MetricsRegistry)):
        model = SlowModel(delay=0.4 if case in ("queue_full", "late") else 0.0)
        server = Server(model, max_queue=1, max_body_bytes=256,
                        registry=Registry()).start()
        try:
            if case == "malformed":
                code = _status(server.port, b'["not", "numbers"]', {})
            elif case == "oversized":
                code = _status(server.port, json.dumps([[0.0] * 200]).encode(), {})
            elif case == "queue_full":
                code = _overload(server.port, model)
            else:
                code = _status(server.port, b"[[1.0, 2.0, 3.0, 4.0]]",
                               {"X-Deadline-Ms": "100"})
        finally:
            server.stop()
        codes.append(code)
    assert codes == [want, want]
