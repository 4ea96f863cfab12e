"""Port serving: ``deeplearning4j_tpu_torch.serving`` (the micro-batching
executor, ``JsonModelServer``, ``ParallelInference``) on the CPU, mirroring
the JAX package's ``tests/test_serving.py`` scenarios, and held to the JAX
package's server on the same requests.

The served networks are port networks on the CPU with the JAX network's
weights (``tests/torch_serving_helpers.py``). Tolerances: a coalesced batch
against the same rows alone 1e-6; the port's server against the JAX
package's 1e-5 (float32 forwards of two libraries).
"""

import json
import socket
import threading
import time
import urllib.error

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.serving import executor as jax_executor
from deeplearning4j_tpu_torch.common import compile_cache
from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.serving import (BatchingInferenceExecutor,
                                              DeadlineExceededError,
                                              JsonModelClient, JsonModelServer,
                                              QueueFullError)
from torch_mln_helpers import port_graph
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401
from torch_serving_helpers import (SlowModel, counter_values, get, net, nets,
                                   out, post)


# ------------------------------------------------------- ParallelInference


def test_output_batched_empty_returns_empty():
    pi = ParallelInference(net(), batch_limit=8)
    assert pi.output_batched([]) == []


def test_output_batched_validates_mixed_requests():
    pi = ParallelInference(net(), batch_limit=8)
    ok = np.zeros((2, 4), np.float32)
    with pytest.raises(ValueError, match="request 1.*feature shape"):
        pi.output_batched([ok, np.zeros((2, 5), np.float32)])
    with pytest.raises(ValueError, match="request 2.*dtype"):
        pi.output_batched([ok, ok, np.zeros((2, 4), np.float64)])
    with pytest.raises(ValueError, match="request 0.*batch dimension"):
        pi.output_batched([np.float32(1.0)])


# --------------------------------------------------------------- executor


def test_executor_micro_batching_parity_and_coalescing(monkeypatch):
    """Coalesced-batch outputs == per-request outputs to 1e-6, and
    concurrent requests actually coalesce (fewer executor cycles than
    requests while a slow_infer fault holds the first cycle open)."""
    monkeypatch.setenv("TDL_FAULT_SPEC", "slow_infer@p=0.15")
    reg = MetricsRegistry()
    model = net()
    pi = ParallelInference(model, batch_limit=8)
    ex = BatchingInferenceExecutor(parallel_inference=pi, max_queue=64,
                                   registry=reg).start()
    try:
        rs = np.random.RandomState(3)
        xs = [rs.randn(1 + i % 3, 4).astype(np.float32) for i in range(10)]
        expected = [out(model, x) for x in xs]
        futs = [ex.submit(x) for x in xs]
        for f in futs:
            assert f.wait(30.0)
            assert f.error is None
        for f, exp in zip(futs, expected):
            np.testing.assert_allclose(f.result, exp, atol=1e-6)
        cycles = reg.get("tdl_inference_batch_size").snapshot()["series"][0]
        assert 0 < cycles["count"] < 10  # coalesced, not one cycle per request
    finally:
        ex.stop(drain=True)


def test_executor_sheds_expired_requests_without_running_model():
    reg = MetricsRegistry()
    model = SlowModel(delay=0.3)
    ex = BatchingInferenceExecutor(model=model, max_queue=16,
                                   registry=reg).start()
    try:
        x = np.ones((1, 4), np.float32)
        f1 = ex.submit(x, deadline_ms=5000)
        assert model.started.wait(5.0)  # f1 is in the model now
        stale = [ex.submit(x, deadline_ms=50) for _ in range(4)]
        assert f1.wait(5.0) and f1.error is None
        for f in stale:
            assert f.wait(5.0)
            assert isinstance(f.error, DeadlineExceededError)
        assert model.calls == 1  # the expired requests never reached it
        shed = counter_values(reg, "tdl_inference_shed_total")
        assert shed[("queue_expired",)] == 4
    finally:
        ex.stop(drain=True)


def test_executor_queue_full_and_graceful_drain():
    reg = MetricsRegistry()
    model = SlowModel(delay=0.3)
    ex = BatchingInferenceExecutor(model=model, max_queue=2,
                                   registry=reg).start()
    x = np.ones((1, 4), np.float32)
    f1 = ex.submit(x)
    assert model.started.wait(5.0)
    queued = [ex.submit(x), ex.submit(x)]
    with pytest.raises(QueueFullError):
        ex.submit(x)
    assert counter_values(reg, "tdl_inference_shed_total")[("queue_full",)] == 1
    ex.stop(drain=True)  # graceful drain completes every accepted request
    for f in [f1] + queued:
        assert f.done and f.error is None
        np.testing.assert_allclose(f.result, 2.0 * np.ones((1, 4)))


def test_executor_mixed_shape_requests_grouped_not_failed():
    ex = BatchingInferenceExecutor(model=SlowModel(), max_queue=16).start()
    try:
        fa = ex.submit(np.ones((2, 4), np.float32))
        fb = ex.submit(np.ones((1, 6), np.float32))
        assert fa.wait(5.0) and fb.wait(5.0)
        assert fa.error is None and fb.error is None
        assert fa.result.shape == (2, 4) and fb.result.shape == (1, 6)
    finally:
        ex.stop(drain=True)


def test_executor_returns_host_arrays_under_inference_mode():
    """A model answering with a torch tensor (bfloat16 here) gets its result
    copied to the host and widened to float32; the model runs under
    inference mode on the executor's thread, whose grad mode starts on."""
    seen = {}

    class TorchModel:
        def output(self, x):
            seen["inference"] = torch.is_inference_mode_enabled()
            return torch.as_tensor(x).to(torch.bfloat16) * 2

    ex = BatchingInferenceExecutor(model=TorchModel(), max_queue=4).start()
    try:
        f = ex.submit(torch.tensor([[1.5, 3.0]]))
        assert f.wait(5.0) and f.error is None
        assert f.result.dtype == np.float32
        np.testing.assert_array_equal(f.result, [[3.0, 6.0]])
        assert seen["inference"]
    finally:
        ex.stop(drain=True)


# ----------------------------------------------------------------- server


def test_builder_parallel_inference_wiring_roundtrip():
    """DL4J builder parity — parallel_inference(pi) / batch_limit(n) route
    requests through the bucketed forward."""
    model = net()
    pi = ParallelInference(model, batch_limit=8)
    server = (JsonModelServer.Builder(model).port(0).parallel_inference(pi)
              .warmup_input(np.zeros((1, 4), np.float32)).build().start())
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    try:
        assert server.wait_ready(30.0)
        got = np.asarray(JsonModelClient(port=server.port).predict(x))
        np.testing.assert_allclose(got, out(model, x), atol=1e-5)
    finally:
        server.stop()
    server2 = JsonModelServer.Builder(model).port(0).batch_limit(8).build().start()
    try:
        assert server2.parallel_inference is not None
        got = np.asarray(JsonModelClient(port=server2.port).predict(x))
        np.testing.assert_allclose(got, out(model, x), atol=1e-5)
    finally:
        server2.stop()


def test_server_deadline_header_yields_504_not_hang():
    reg = MetricsRegistry()
    server = JsonModelServer(SlowModel(delay=0.5), registry=reg).start()
    try:
        t0 = time.perf_counter()
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(server.port, b"[[1.0, 2.0, 3.0, 4.0]]",
                 headers={"X-Deadline-Ms": "100"})
        elapsed = time.perf_counter() - t0
        assert ei.value.code == 504
        assert elapsed < 0.45  # answered at the deadline, not after the model
        assert "deadline" in json.loads(ei.value.read())["error"]
        assert counter_values(reg, "tdl_inference_requests_total")[("504",)] == 1
    finally:
        server.stop()


def test_server_queue_full_429_with_retry_after():
    reg = MetricsRegistry()
    model = SlowModel(delay=0.5)
    server = JsonModelServer(model, max_queue=1, registry=reg).start()
    try:
        body = b"[[1.0, 2.0, 3.0, 4.0]]"
        results = []

        def fire():
            try:
                results.append(post(server.port, body)[0])
            except urllib.error.HTTPError as e:
                results.append(e.code)

        t1 = threading.Thread(target=fire)
        t1.start()
        assert model.started.wait(5.0)  # first request is inside the model
        t2 = threading.Thread(target=fire)
        t2.start()
        time.sleep(0.1)  # second request now occupies the only queue slot
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(server.port, body)
        assert ei.value.code == 429
        assert ei.value.headers.get("Retry-After") is not None
        t1.join(10.0)
        t2.join(10.0)
        assert results == [200, 200]
        assert counter_values(reg, "tdl_inference_shed_total")[("queue_full",)] == 1
    finally:
        server.stop()


def test_health_ready_split_and_graceful_drain():
    model = SlowModel(delay=0.4)
    server = JsonModelServer(
        model, warmup_input=np.zeros((1, 4), np.float32)).start()
    try:
        assert get(server.port, "/health")[0] == 200  # live while warming
        assert server.wait_ready(30.0)
        assert get(server.port, "/ready")[0] == 200
        outcome = []

        def slow_request():
            outcome.append(post(server.port, b"[[1.0, 2.0, 3.0, 4.0]]"))

        t = threading.Thread(target=slow_request)
        t.start()
        model.started.clear()
        assert model.started.wait(5.0)
        stopper = threading.Thread(target=lambda: server.stop(drain=True))
        stopper.start()
        saw_not_ready = False
        for _ in range(100):
            try:
                get(server.port, "/ready", timeout=2)
            except urllib.error.HTTPError as e:
                assert e.code == 503
                assert e.headers.get("Retry-After") is not None
                saw_not_ready = True
                break
            except (urllib.error.URLError, ConnectionError, OSError):
                break  # socket already closed — drain finished
            time.sleep(0.01)
        stopper.join(30.0)
        t.join(30.0)
        assert saw_not_ready
        assert outcome and outcome[0][0] == 200  # accepted request completed
        np.testing.assert_allclose(outcome[0][1]["output"], [[2.0, 4.0, 6.0, 8.0]])
    finally:
        server.stop()  # idempotent


def test_body_cap_413_and_missing_content_length():
    server = JsonModelServer(SlowModel(), max_body_bytes=1024).start()
    try:
        # ~7MB: past loopback socket buffers, so this also proves the server
        # DRAINS the oversized body before answering
        big = json.dumps([[0.0] * 4] * 300_000).encode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(server.port, big)
        assert ei.value.code == 413
        with socket.create_connection(("127.0.0.1", server.port), timeout=10) as s:
            s.sendall(b"POST /predict HTTP/1.1\r\nHost: localhost\r\n\r\n")
            chunks = []
            while True:
                chunk = s.recv(4096)
                if not chunk:
                    break
                chunks.append(chunk)
            reply = b"".join(chunks).decode()
        assert "413" in reply.split("\r\n")[0]
        assert "Content-Length header required" in reply
        with socket.create_connection(("127.0.0.1", server.port), timeout=10) as s:
            s.sendall(b"POST /predict HTTP/1.1\r\nHost: localhost\r\n"
                      b"Content-Length: -1\r\n\r\n")
            reply = s.recv(4096).decode()
        assert "400" in reply.split("\r\n")[0]
    finally:
        server.stop()


def test_server_restart_same_port_and_idempotent_stop():
    model = net()
    server = JsonModelServer(model).start()
    port = server.port
    x = np.random.RandomState(2).randn(2, 4).astype(np.float32)
    ref = out(model, x)
    np.testing.assert_allclose(
        np.asarray(JsonModelClient(port=port).predict(x)), ref, atol=1e-5)
    server.stop()
    server.stop()  # idempotent
    server.start()  # SO_REUSEADDR: rebinds the SAME port during TIME_WAIT
    try:
        assert server.port == port
        np.testing.assert_allclose(
            np.asarray(JsonModelClient(port=port).predict(x)), ref, atol=1e-5)
    finally:
        server.stop()


def test_fail_infer_fault_maps_to_500_then_recovers(monkeypatch):
    monkeypatch.setenv("TDL_FAULT_SPEC", "fail_infer@n=1")
    server = JsonModelServer(SlowModel()).start()
    try:
        client = JsonModelClient(port=server.port, retries=1,
                                 backoff_base=0.01, backoff_max=0.02)
        with pytest.raises(RuntimeError, match="500.*InjectedFault"):
            client.predict([[1.0, 2.0, 3.0, 4.0]])
        monkeypatch.setenv("TDL_FAULT_SPEC", "")  # fault cleared → recovery
        got = client.predict([[1.0, 2.0, 3.0, 4.0]])
        np.testing.assert_allclose(got, [[2.0, 4.0, 6.0, 8.0]])
    finally:
        server.stop()


def test_serving_chaos_32_clients(monkeypatch):
    """slow_infer fault + 32 concurrent clients against a bounded queue —
    the server only ever answers 200/429/504, queue depth stays bounded, no
    client hangs, client retries converge on eventual 200s."""
    monkeypatch.setenv("TDL_FAULT_SPEC", "slow_infer@p=0.02")
    reg = MetricsRegistry()
    server = (JsonModelServer.Builder(net()).port(0).batch_limit(8)
              .queue_size(8).registry(reg)
              .warmup_input(np.zeros((1, 4), np.float32)).build().start())
    try:
        assert server.wait_ready(60.0)
        clients, per_client = 32, 3
        successes = [0] * clients
        depth_gauge = reg.get("tdl_inference_queue_depth")
        depth_samples = []
        stop_sampling = threading.Event()

        def sample_depth():
            while not stop_sampling.is_set():
                depth_samples.append(depth_gauge.value)
                time.sleep(0.005)

        def worker(idx):
            client = JsonModelClient(
                port=server.port, timeout=15, retries=12,
                backoff_base=0.01, backoff_max=0.1,
                breaker_threshold=10 ** 6, deadline_ms=10_000)
            x = np.random.RandomState(idx).randn(1, 4).astype(np.float32)
            for _ in range(per_client):
                client.predict(x)  # raises if retries don't converge
                successes[idx] += 1

        sampler = threading.Thread(target=sample_depth, daemon=True)
        sampler.start()
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        stop_sampling.set()
        sampler.join(5.0)
        assert not any(t.is_alive() for t in threads)
        assert sum(successes) == clients * per_client
        assert max(depth_samples) <= 8
        codes = counter_values(reg, "tdl_inference_requests_total")
        assert set(codes) <= {("200",), ("429",), ("504",)}
        assert codes[("200",)] == clients * per_client
        snap = reg.snapshot()
        assert snap["tdl_inference_queue_wait_seconds"]["series"][0]["count"] > 0
        assert snap["tdl_inference_batch_size"]["series"][0]["count"] > 0
    finally:
        server.stop()


# ------------------------------------------------- against the JAX package


def test_port_server_matches_jax_server_on_the_same_requests():
    """A JAX MLN behind the JAX package's server and the port's MLN (its
    weights, ``mln_params_from_jax``) behind the port's, given the same
    requests, answer within 1e-5."""
    from deeplearning4j_tpu.monitoring import MetricsRegistry as JRegistry
    from deeplearning4j_tpu.serving import JsonModelClient as JClient
    from deeplearning4j_tpu.serving import JsonModelServer as JServer

    jnet, tnet = nets()
    jserver = JServer.Builder(jnet).port(0).batch_limit(4).registry(JRegistry()).build().start()
    tserver = JsonModelServer.Builder(tnet).port(0).batch_limit(4).registry(
        MetricsRegistry()).build().start()
    try:
        rs = np.random.RandomState(11)
        for n in (1, 3, 5):
            x = rs.randn(n, 4).astype(np.float32)
            want = np.asarray(JClient(port=jserver.port).predict(x))
            got = np.asarray(JsonModelClient(port=tserver.port).predict(x))
            assert got.shape == want.shape == (n, 3)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    finally:
        jserver.stop()
        tserver.stop()


def test_port_and_jax_servers_expose_the_same_metric_families():
    from deeplearning4j_tpu.monitoring import MetricsRegistry as JRegistry
    from deeplearning4j_tpu.serving import JsonModelClient as JClient
    from deeplearning4j_tpu.serving import JsonModelServer as JServer

    jnet, tnet = nets()
    jreg, treg = JRegistry(), MetricsRegistry()
    jserver = JServer(jnet, registry=jreg).start()
    tserver = JsonModelServer(tnet, registry=treg).start()
    try:
        x = np.zeros((1, 4), np.float32)
        JClient(port=jserver.port, registry=jreg).predict(x)
        JsonModelClient(port=tserver.port, registry=treg).predict(x)
        assert jreg.names() == treg.names()
        families = lambda text: sorted(l for l in text.splitlines()  # noqa: E731
                                       if l.startswith("# TYPE"))
        assert families(jreg.to_prometheus()) == families(treg.to_prometheus())
    finally:
        jserver.stop()
        tserver.stop()


def _jax_two_layer_graph():
    g = (JC.NeuralNetConfiguration.Builder().seed(5).graph_builder()
         .add_inputs("x").set_input_types(JC.InputType.feed_forward(4)))
    g.add_layer("h", JC.DenseLayer(n_out=6, activation="tanh"), "x")
    g.add_layer("out", JC.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "h")
    return JGraph(g.set_outputs("out").build()).init()


def test_served_computation_graph_answers_each_request_with_its_rows():
    """The JAX executor stacks the list a ComputationGraph returns and cuts
    the stack along the list axis: two 1-row requests coalesced into one
    batch get shapes (1, 2, 3) and (0, 2, 3). The port cuts the graph's one
    output along its rows: (1, 3) and (1, 3), each equal to that row's
    ``output_single``."""
    jgraph = _jax_two_layer_graph()
    tgraph = port_graph(jgraph)
    rows = [np.random.RandomState(s).randn(1, 4).astype(np.float32) for s in (1, 2)]

    jex = jax_executor.BatchingInferenceExecutor(model=jgraph)
    assert [r.shape for r in jex._run(rows)] == [(1, 2, 3), (0, 2, 3)]

    tex = BatchingInferenceExecutor(model=tgraph)
    got = tex._run(rows)
    assert [r.shape for r in got] == [(1, 3), (1, 3)]
    for r, x in zip(got, rows):
        np.testing.assert_allclose(r, tgraph.output_single(x).numpy(), atol=1e-6)

    server = JsonModelServer(tgraph, registry=MetricsRegistry()).start()
    try:
        for x in rows:
            got = np.asarray(JsonModelClient(port=server.port).predict(x))
            np.testing.assert_allclose(got, tgraph.output_single(x).numpy(), atol=1e-6)
    finally:
        server.stop()


def test_graph_with_two_outputs_is_refused_when_the_server_is_built():
    from deeplearning4j_tpu_torch.nn import conf as TC
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    g = (TC.NeuralNetConfiguration.Builder().seed(5).graph_builder()
         .add_inputs("x").set_input_types(TC.InputType.feed_forward(4)))
    g.add_layer("a", TC.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "x")
    g.add_layer("b", TC.OutputLayer(n_out=2, activation="identity", loss="mse"), "x")
    graph = ComputationGraph(g.set_outputs("a", "b").build(), device="cpu").init()
    with pytest.raises(ValueError, match="2 network outputs"):
        JsonModelServer.Builder(graph).build()
    with pytest.raises(ValueError, match="2 network outputs"):
        ParallelInference(graph)


def test_compile_cache_holds_the_kernel_build_and_warms_every_bucket(tmp_path, monkeypatch):
    """The port's compile cache is its nvcc build: enabling it points
    ``kernels._build.build_dir()`` under the cache directory (a pool's
    replicas share one build), the env contract enables it at the serving
    entry points, an explicit enable wins over the env, and with it on the
    executor warms every ParallelInference bucket (the JAX package's auto
    rule)."""
    monkeypatch.delenv(compile_cache.ENV_DIR, raising=False)
    compile_cache.disable()
    default = _build.build_dir()
    try:
        monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path / "env"))
        calls = []

        class Recorder(SlowModel):
            def output(self, x):
                calls.append(np.asarray(x).shape[0])
                return super().output(x)

        model = Recorder()
        server = JsonModelServer(model, batch_limit=4, max_batch_rows=16,
                                 warmup_input=np.zeros((1, 4), np.float32)).start()
        try:
            assert server.wait_ready(30.0)
        finally:
            server.stop()
        assert compile_cache.cache_dir() == str(tmp_path / "env")
        assert _build.build_dir() == tmp_path / "env" / "kernels"
        assert calls == [4, 8, 16]  # the whole ladder, not just bucket 4
        compile_cache.enable(str(tmp_path / "explicit"))
        assert compile_cache.maybe_enable_from_env() == str(tmp_path / "explicit")
        (tmp_path / "explicit" / "kernels").mkdir()
        (tmp_path / "explicit" / "kernels" / "libx.so").write_bytes(b"12345")
        assert compile_cache.cache_size_bytes() == 5
    finally:
        compile_cache.disable()
    assert _build.build_dir() == default
    calls.clear()
    monkeypatch.delenv(compile_cache.ENV_DIR)
    server = JsonModelServer(Recorder(), batch_limit=4, max_batch_rows=16,
                             warmup_input=np.zeros((1, 4), np.float32)).start()
    try:
        assert server.wait_ready(30.0)
    finally:
        server.stop()
    assert calls == [4]  # cache off: the smallest bucket only
