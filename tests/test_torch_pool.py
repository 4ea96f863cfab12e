"""Port elastic replica-pool serving (``deeplearning4j_tpu_torch.serving.pool``),
mirroring the JAX package's ``tests/test_pool.py`` with the port's replica
targets (``tests/torch_pool_workers.py``).

Covers: router dispatch + readiness aggregation (ready iff >= min_replicas
warm, /health live throughout — the satellite readiness fix), transparent
failover + respawn after a SIGKILL, the client's pool-unready retry contract
(503 treated like 429, distinct retry label, breaker untouched), the
autoscaler's act-don't-flap state machine, the zero-downtime swap, the
slow replica-kill + 10x-burst chaos acceptance; and what is the port's own:
a replica imports neither jax nor the JAX package, and a port
MultiLayerNetwork serves through the router. The swap's checkpoint
preflight is in ``tests/test_torch_pool_swap.py``.
"""

import json
import pathlib
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
from deeplearning4j_tpu_torch.monitoring.alerts import AlertEngine, AlertRule
from deeplearning4j_tpu_torch.serving import (JsonModelClient, PoolAutoscaler,
                                              ServingPool)
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401

_WORKERS = str(pathlib.Path(__file__).resolve().parent / "torch_pool_workers.py")


def _pool(tmp_path, target="stub_server", **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("registry", MetricsRegistry())
    return ServingPool(f"{_WORKERS}:{target}", workdir=str(tmp_path / "pool"),
                       **kw)


def _get(port, path, timeout=10):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def _post(port, payload, headers=None, timeout=15):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def _counter_values(reg, name):
    m = reg.get(name)
    if m is None:
        return {}
    return {tuple(s["labels"].values()): s["value"]
            for s in m.snapshot()["series"]}


def _kill_one_replica(pool):
    with pool._lock:
        handle = next(h for h in pool._replicas.values() if h.alive)
    handle.proc.kill()  # SIGKILL: no drain, no goodbye
    return handle.id


# --------------------------------------------------------------- readiness


def test_pool_ready_flips_below_min_replicas_health_stays_live(tmp_path):
    """/ready on the front door is the POOL's readiness — 503
    the moment fewer than min_replicas replicas are warm — while /health
    stays 200 through the whole replica restart."""
    reg = MetricsRegistry()
    pool = _pool(tmp_path, replicas=2, min_replicas=2, registry=reg).start()
    try:
        assert pool.wait_ready(60.0)
        assert _get(pool.port, "/ready")[0] == 200
        status, body, _ = _post(pool.port, [[1.0, 2.0, 3.0, 4.0]])
        assert status == 200
        np.testing.assert_allclose(body["output"], [[2.0, 4.0, 6.0, 8.0]])

        killed = _kill_one_replica(pool)
        # the monitor notices within a poll or two; /ready must flip 503
        saw_unready = False
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            assert _get(pool.port, "/health")[0] == 200  # ALWAYS live
            try:
                _get(pool.port, "/ready", timeout=5)
            except urllib.error.HTTPError as e:
                assert e.code == 503
                body = json.loads(e.read())
                assert "pool not ready" in body["error"]
                assert e.headers.get("Retry-After") is not None
                saw_unready = True
                break
            time.sleep(0.05)
        assert saw_unready, "pool /ready never flipped 503 after the kill"
        # the monitor respawns the dead replica; readiness recovers
        assert pool.wait_ready(60.0)
        assert _get(pool.port, "/ready")[0] == 200
        deaths = _counter_values(reg, "tdl_worker_deaths_total")
        assert deaths[("replica_crash",)] >= 1
        with pool._lock:
            assert pool._replicas[killed].restarts >= 1
        # pool gauges exist and agree
        assert reg.get("tdl_pool_size").value >= 2
        # the state gauge emits 0 for a replica's OTHER states (its help
        # text contract): {state="dead"} reads 0 when healthy, not missing
        states = {(s["labels"]["replica"], s["labels"]["state"]): s["value"]
                  for s in reg.get("tdl_pool_replica_state")
                  .snapshot()["series"]}
        ready_replica = next(r for (r, st), v in states.items()
                             if st == "ready" and v == 1.0)
        assert states[(ready_replica, "dead")] == 0.0
    finally:
        pool.stop()


def test_router_failover_hides_a_dead_replica(tmp_path):
    """A request hitting a just-killed replica fails over to a sibling
    transparently — the client sees 200, never a connection error."""
    pool = _pool(tmp_path, replicas=2, min_replicas=1).start()
    try:
        assert pool.wait_ready(60.0)
        # both replicas must be ready so the router will route to either
        deadline = time.monotonic() + 30.0
        while pool.ready_count < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert pool.ready_count == 2
        _kill_one_replica(pool)
        # immediately: no monitor poll has necessarily run yet
        oks = 0
        for _ in range(8):
            status, body, _ = _post(pool.port, [[1.0, 1.0, 1.0, 1.0]])
            assert status == 200
            np.testing.assert_allclose(body["output"], [[2.0] * 4])
            oks += 1
        assert oks == 8
    finally:
        pool.stop()


def test_client_treats_pool_unready_like_429(tmp_path):
    """A router 503 (pool not ready) is retried honoring
    Retry-After, counted under tdl_client_retries_total{reason=
    "pool_unready"}, and never marches the circuit breaker toward open."""
    reg = MetricsRegistry()
    pool = _pool(tmp_path, replicas=1, min_replicas=1,
                 extra_env={"TDL_STUB_START_DELAY": "2.0"}).start()
    try:
        # the lone replica sleeps 2s before serving: the pool answers 503
        # "pool not ready" meanwhile — a rolling-restart window in miniature
        client = JsonModelClient(port=pool.port, retries=30,
                                 backoff_base=0.05, backoff_max=0.3,
                                 breaker_threshold=2,  # would trip on TWO
                                 registry=reg)
        out = client.predict([[3.0, 0.0, 0.0, 0.0]])
        np.testing.assert_allclose(out, [[6.0, 0.0, 0.0, 0.0]])
        retries = _counter_values(reg, "tdl_client_retries_total")
        assert retries[("pool_unready",)] >= 1
        # the breaker never opened despite >= breaker_threshold 503s: the
        # next call goes straight through
        assert client._consecutive_failures == 0
        np.testing.assert_allclose(client.predict([[1.0, 0, 0, 0]]),
                                   [[2.0, 0, 0, 0]])
    finally:
        pool.stop()


def test_respawn_heartbeat_is_per_incarnation(tmp_path):
    """A respawned replica must NOT inherit the dead incarnation's heartbeat
    file: consuming the stale beat would downgrade the new process's startup
    budget from startup_grace to hang_timeout and kill any replica that
    spends longer than that importing torch + building its model."""
    from deeplearning4j_tpu_torch.monitoring.heartbeat import (ENV_DIR,
                                                         HeartbeatWriter)

    pool = _pool(tmp_path, replicas=1)
    try:
        with pool._lock:
            h = pool._spawn_replica()
        assert h.hb_dir.endswith("i0")
        assert pool._child_env(h)[ENV_DIR] == h.hb_dir
        # incarnation 0 beats, then dies; the pool respawns in place
        HeartbeatWriter(h.hb_dir, h.id, 0.0).beat(7)
        h.proc.kill()
        h.proc.wait(10)
        h.restarts += 1
        with pool._lock:
            pool._spawn_replica(h)
        assert h.hb_dir.endswith("i1")
        assert pool._child_env(h)[ENV_DIR] == h.hb_dir
        # the stale i0 beat is INVISIBLE to incarnation 1's staleness check:
        # last_hb stays None, so the budget stays startup_grace
        pool._check_heartbeat(h, time.monotonic())
        assert h.last_hb is None
        # a beat in the incarnation's own dir IS seen
        HeartbeatWriter(h.hb_dir, h.id, 0.0).beat(1)
        pool._check_heartbeat(h, time.monotonic())
        assert h.last_hb is not None
    finally:
        with pool._lock:
            handles = list(pool._replicas.values())
        for hh in handles:
            if hh.alive:
                hh.proc.kill()
                hh.proc.wait(10)


def test_exhausted_restart_budget_frees_the_seat(tmp_path):
    """A replica out of restart budget is RETIRED, not left dead in the
    serving set: the poll loop reaps it so _reconcile can backfill a fresh
    replica — a transient failure burst can never permanently pin the pool
    below min_replicas."""
    from deeplearning4j_tpu_torch.serving.pool import ReplicaHandle

    pool = _pool(tmp_path, replicas=1, max_restarts_per_replica=0)
    h = ReplicaHandle(id=0)
    pool._replicas[0] = h
    pool._on_death(h, "replica_crash", time.monotonic())
    assert h.state == "dead" and h.retiring
    pool._poll_replicas()  # dead + retiring => reaped
    assert 0 not in pool._replicas
    with pool._lock:  # the seat is free for _reconcile to backfill
        assert not [x for x in pool._replicas.values() if not x.retiring]


class _FakeProc:
    """poll()-able stand-in so a ReplicaHandle counts as alive without a
    real subprocess."""

    pid = 0

    def __init__(self):
        self._dead = False

    def poll(self):
        return 0 if self._dead else None

    def send_signal(self, sig):
        self._dead = True

    def kill(self):
        self._dead = True

    def wait(self, timeout=None):
        return 0


def _stub_replica_http(code, body):
    """In-thread HTTP stub answering every POST with one canned response."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            payload = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_pool_restart_after_stop_is_clean(tmp_path):
    """start() after stop() spawns a FRESH replica set: stale dead handles
    must not be death-counted, respawned, and re-retired on top of it."""
    reg = MetricsRegistry()
    pool = _pool(tmp_path, replicas=1, registry=reg)
    pool.start()
    try:
        assert pool.wait_ready(60.0)
        pool.stop()
        assert not pool._replicas
        pool.start()
        assert pool.wait_ready(60.0)
        deaths = _counter_values(reg, "tdl_worker_deaths_total")
        assert deaths.get(("replica_crash",), 0) == 0
        with pool._lock:
            assert len(pool._replicas) == 1
    finally:
        pool.stop()


def test_router_fails_over_on_replica_503(tmp_path):
    """A replica 503 (draining/warming: the request was NOT processed) must
    fail over to a sibling like a connection error — returning the
    replica's own 503 (no "pool not ready" marker) would march the client
    breaker during a rolling restart a sibling could have absorbed."""
    from deeplearning4j_tpu_torch.serving.pool import ReplicaHandle

    draining = _stub_replica_http(503, {"error": "server shutting down"})
    serving = _stub_replica_http(200, {"output": [[2.0]]})
    pool = _pool(tmp_path, replicas=2)
    try:
        with pool._lock:
            pool._replicas[0] = ReplicaHandle(
                id=0, proc=_FakeProc(), port=draining.server_address[1],
                state="ready")
            pool._replicas[1] = ReplicaHandle(
                id=1, proc=_FakeProc(), port=serving.server_address[1],
                state="ready")
        pool._start_router()
        # least-loaded tie breaks to id 0 (the draining one) first
        status, body, headers = _post(pool.port, [[1.0]])
        assert status == 200 and headers["X-Replica"] == "1"
        assert body["output"] == [[2.0]]
        h0 = pool._replicas[0]
        assert h0.state == "unready"  # stop routing to it until a probe
        assert h0.fails == 0          # but NOT a breaker signal
    finally:
        pool.stop(drain=False)
        draining.shutdown()
        serving.shutdown()


def test_router_forward_timeout_covers_the_deadline(tmp_path):
    """The per-request forward timeout must exceed both the replica's 30s
    default deadline and an explicit X-Deadline-Ms (plus margin): a slow
    but within-deadline generation misclassified as a connection failure
    would be breaker-counted and re-dispatched in duplicate."""
    pool = _pool(tmp_path)
    assert pool._forward_timeout({}) == 40.0
    assert pool._forward_timeout({"X-Deadline-Ms": "2000"}) == 40.0
    assert pool._forward_timeout({"X-Deadline-Ms": "60000"}) == 65.0
    assert pool._forward_timeout({"X-Deadline-Ms": "nope"}) == 40.0


def test_child_env_identity_keys_resist_parent_pollution(tmp_path, monkeypatch):
    """Per-replica identity keys are pool-owned: a pool launched inside an
    already-supervised process (TDL_PROC_NAME / TDL_HEARTBEAT_DIR set in
    the parent env) must not leak the parent's identity into replicas —
    that would merge every replica's metrics under one proc and point
    heartbeats where the monitor never looks."""
    from deeplearning4j_tpu_torch.monitoring.flight import ENV_PROC
    from deeplearning4j_tpu_torch.monitoring.heartbeat import (ENV_DIR,
                                                         ENV_INTERVAL)
    from deeplearning4j_tpu_torch.serving.pool import ReplicaHandle

    monkeypatch.setenv(ENV_PROC, "rank0")
    monkeypatch.setenv(ENV_DIR, "/somewhere/else")
    monkeypatch.setenv(ENV_INTERVAL, "60.0")
    pool = _pool(tmp_path, heartbeat_interval=0.25)
    h = ReplicaHandle(id=3, hb_dir=str(tmp_path / "pool" / "hb" / "i0"))
    env = pool._child_env(h)
    assert env[ENV_PROC] == "replica3"
    assert env[ENV_DIR] == h.hb_dir
    assert env[ENV_INTERVAL] == "0.25"


def test_router_error_paths_deliver_json(tmp_path):
    """Router early 4xxs mirror the replica server's contract: the unread
    body is drained so the error JSON arrives (no RST mid-upload), and a
    malformed Content-Length is a 400 naming the bad value — not a 413
    claiming the header is missing."""
    import http.client

    pool = _pool(tmp_path, replicas=1, max_body_bytes=1024).start()
    try:
        assert pool.wait_ready(60.0)
        big = [[1.0] * 200_000]  # ~1MB encoded: past any socket buffer
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(pool.port, big)
        assert ei.value.code == 413
        assert "exceeds" in json.loads(ei.value.read())["error"]
        # unknown endpoint with a body pending: drained, 404 delivered
        req = urllib.request.Request(
            f"http://127.0.0.1:{pool.port}/nope", data=b"x" * 512,
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 404
        conn = http.client.HTTPConnection("127.0.0.1", pool.port, timeout=10)
        try:
            conn.putrequest("POST", "/predict")
            conn.putheader("Content-Length", "abc")
            conn.putheader("Content-Type", "application/json")
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == 400
            assert b"bad Content-Length" in resp.read()
        finally:
            conn.close()
    finally:
        pool.stop()


# -------------------------------------------------------------- autoscaler


class _FakeEngine:
    """Engine stand-in: evaluate() reports whatever the test scripted."""

    def __init__(self):
        self.firing = set()
        self.rules = (AlertRule("queue_hot", "tdl_inference_queue_depth",
                                ">=", 1),)

    def evaluate(self):
        return [{"rule": "queue_hot", "firing": "queue_hot" in self.firing}]


def test_autoscaler_scales_up_down_without_flapping(tmp_path):
    reg = MetricsRegistry()
    pool = _pool(tmp_path, replicas=2, min_replicas=1, max_replicas=4,
                 registry=reg)  # never started: scale_to needs no processes
    engine = _FakeEngine()
    scaler = PoolAutoscaler(pool, engine, scale_up_rules=("queue_hot",),
                            cooldown_s=0.2, scale_down_idle_evals=3)
    engine.firing = {"queue_hot"}
    assert scaler.tick() == "up" and pool.desired == 3
    # cooldown: an immediately-following firing tick does NOT scale again
    assert scaler.tick() is None and pool.desired == 3
    time.sleep(0.25)
    assert scaler.tick() == "up" and pool.desired == 4
    time.sleep(0.25)
    assert scaler.tick() is None and pool.desired == 4  # at max_replicas
    # clearing: needs scale_down_idle_evals consecutive all-clear ticks
    engine.firing = set()
    time.sleep(0.25)
    assert scaler.tick() is None
    assert scaler.tick() is None
    assert scaler.tick() == "down" and pool.desired == 3
    # streak resets after an action: not an immediate cascade to min
    assert scaler.tick() is None
    events = _counter_values(reg, "tdl_pool_scale_events_total")
    assert events[("up",)] == 2 and events[("down",)] == 1
    assert [a["action"] for a in scaler.actions] == ["up", "up", "down"]
    assert scaler.actions[0]["rules"] == ["queue_hot"]


def test_autoscaler_rejects_unknown_rules():
    engine = _FakeEngine()
    with pytest.raises(ValueError, match="nonexistent_rule"):
        PoolAutoscaler(object(), engine, scale_up_rules=("nonexistent_rule",))


def test_scale_to_clamps_and_counts(tmp_path):
    reg = MetricsRegistry()
    pool = _pool(tmp_path, replicas=2, min_replicas=1, max_replicas=3,
                 registry=reg)
    assert pool.scale_to(99) == 3
    assert pool.scale_to(0) == 1
    assert pool.scale_to(1) == 1  # no-op: no event counted
    events = _counter_values(reg, "tdl_pool_scale_events_total")
    assert events[("up",)] == 1 and events[("down",)] == 1


# ---------------------------------------------------- chaos (slow tier)


# ------------------------------------------------ zero-downtime model swap


def _versions(tmp_path):
    v2 = tmp_path / "v2.json"
    v2.write_text(json.dumps({"scale": 2}))
    v3 = tmp_path / "v3.json"
    v3.write_text(json.dumps({"scale": 3}))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"fail": True}))
    return str(v2), str(v3), str(bad)


def test_swap_model_rolls_replicas_zero_downtime(tmp_path):
    """swap_model rolls every replica onto the new checkpoint surge-first:
    ready never dips below the desired count, every post-swap response is
    the new model's, later scale-ups inherit the new version, and the swap
    is counted."""
    _, v3, _ = _versions(tmp_path)
    reg = MetricsRegistry()
    pool = _pool(tmp_path, target="swappable_server", replicas=2,
                 min_replicas=2, registry=reg).start()
    try:
        assert pool.wait_ready(60.0)
        assert _post(pool.port, [[1.0, 1.0, 1.0, 1.0]])[1]["output"][0][0] == 2.0
        old_ids = set(pool.replica_states())

        res = pool.swap_model(v3)
        assert res["ok"] and res["swapped"] == 2 and not res["rolled_back"]
        assert pool.ready_count >= 2  # never below desired, let alone min
        assert set(pool.replica_states()).isdisjoint(old_ids)
        for _ in range(4):
            assert _post(pool.port, [[1.0, 1.0, 1.0, 1.0]])[1]["output"][0][0] == 3.0
        for row in pool.describe()["replicas"]:
            assert row["model"] == v3

        # a post-swap scale-up spawns the NEW version (default overrides)
        pool.scale_to(3)
        deadline = time.monotonic() + 60.0
        while pool.ready_count < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert pool.ready_count == 3
        assert all(row["model"] == v3
                   for row in pool.describe()["replicas"])
        assert _counter_values(reg, "tdl_pool_swap_events_total") == {(): 1}
        assert _counter_values(reg, "tdl_pool_swap_rollbacks_total") == {}
    finally:
        pool.stop()


def test_swap_validation_failure_rolls_back(tmp_path):
    """A new version that cannot become ready is killed BEFORE any old
    replica is touched: the swap reports rollback, the rollback counter
    moves, and the old version keeps serving at full strength."""
    _, _, bad = _versions(tmp_path)
    reg = MetricsRegistry()
    pool = _pool(tmp_path, target="swappable_server", replicas=2,
                 min_replicas=2, registry=reg).start()
    try:
        assert pool.wait_ready(60.0)
        old_ids = set(pool.replica_states())
        res = pool.swap_model(bad, ready_timeout=12.0)
        assert not res["ok"] and res["rolled_back"] and res["swapped"] == 0
        assert set(pool.replica_states()) == old_ids  # old fleet untouched
        assert pool.ready_count >= 2
        assert _post(pool.port, [[1.0, 1.0, 1.0, 1.0]])[1]["output"][0][0] == 2.0
        assert _counter_values(reg, "tdl_pool_swap_rollbacks_total") == {(): 1}
        assert _counter_values(reg, "tdl_pool_swap_events_total") == {}
    finally:
        pool.stop()


def test_scale_down_drains_before_signal(tmp_path):
    """The drain fix: on scale-down the ROUTER stops
    dispatching first — the replica enters the explicit `draining` state —
    and the supervisor only signals it once its in-flight count hits zero,
    so no request can race into a dying replica and burn a breaker count."""
    pool = _pool(tmp_path, target="stub_server", replicas=2,
                 min_replicas=1).start()
    try:
        assert pool.wait_ready(60.0)
        with pool._lock:
            victim = max(pool._replicas.values(), key=lambda h: h.id)
            victim.inflight = 1  # pin an in-flight request on the victim
        pool.scale_to(1)
        deadline = time.monotonic() + 5.0
        while victim.state != "draining" and time.monotonic() < deadline:
            time.sleep(0.02)
        assert victim.state == "draining" and victim.retiring
        assert pool.replica_states()[victim.id] == "draining"
        time.sleep(0.6)  # several monitor iterations
        # drained-but-busy: router excludes it, supervisor has NOT signaled
        assert victim.alive and not victim.signaled
        # _pick_replica counts the pick in-flight (it is the dispatch path,
        # not a query) — undo it so the probe doesn't pin the survivor
        picked = pool._pick_replica(set())
        assert picked is not victim
        if picked is not None:
            with pool._lock:
                picked.inflight -= 1
        with pool._lock:
            victim.inflight = 0  # the in-flight request completes
        deadline = time.monotonic() + 15.0
        while victim.id in pool.replica_states() and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert victim.signaled
        assert victim.id not in pool.replica_states()
        assert not victim.alive
    finally:
        pool.stop()


# ------------------------------------------------------- the port's own


def test_replicas_import_neither_jax_nor_the_jax_package(tmp_path):
    """A replica process of the port's pool runs no JAX: neither ``jax``
    nor ``deeplearning4j_tpu`` is in its ``sys.modules`` while it serves."""
    pool = _pool(tmp_path, target="isolation_server", replicas=1).start()
    try:
        assert pool.wait_ready(60.0)
        status, body, _ = _post(pool.port, [[0.0, 0.0, 0.0, 0.0]])
        assert status == 200 and body["output"] == [[0.0, 0.0]]
    finally:
        pool.stop()


def test_router_and_host_side_modules_import_no_torch():
    """The pool's router, the telemetry and a replica that serves a numpy
    model import neither jax nor torch: a fresh interpreter that imports
    ``monitoring`` and ``serving.pool`` has neither in ``sys.modules`` (a
    stub replica spawns in well under a second)."""
    import subprocess
    import sys

    code = ("import sys; import deeplearning4j_tpu_torch.monitoring, "
            "deeplearning4j_tpu_torch.serving.pool; "
            "print('torch' in sys.modules, 'jax' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(pathlib.Path(_WORKERS).parents[1]))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]


def test_port_network_serves_through_the_pool(tmp_path):
    """Two replicas each build the port MultiLayerNetwork from its seed on
    the CPU; requests through the router equal the same network's
    ``output`` in this process (1e-6), on whichever replica served them."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_torch_pool_workers", _WORKERS)
    workers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(workers)
    local = workers.mln_net()
    pool = _pool(tmp_path, target="mln_server", replicas=2).start()
    try:
        assert pool.wait_ready(90.0)
        rs = np.random.RandomState(6)
        served_by = set()
        for n in (1, 2, 3, 1, 2, 3):
            x = rs.randn(n, 4).astype(np.float32)
            status, body, headers = _post(pool.port, x.tolist())
            assert status == 200
            served_by.add(headers["X-Replica"])
            np.testing.assert_allclose(body["output"], local.output(x).numpy(),
                                       rtol=0, atol=1e-6)
        assert served_by <= {"0", "1"}
    finally:
        pool.stop()


@pytest.mark.slow
def test_pool_chaos_swap_under_load(tmp_path):
    """A mid-traffic swap_model under the loadgen
    replay finishes with ONLY 200/429 escaping (zero 5xx/connection
    outcomes), /ready answering 200 throughout, the pool never below
    min_replicas ready — and after the window every response is the new
    model's."""
    from deeplearning4j_tpu_torch.serving import LoadGenerator, TraceSpec

    _, v3, _ = _versions(tmp_path)
    reg = MetricsRegistry()
    pool = _pool(tmp_path, target="swappable_server", replicas=3,
                 min_replicas=2, registry=reg).start()
    try:
        assert pool.wait_ready(60.0)
        ready_codes = []
        min_ready = [99]
        stop = threading.Event()

        def ready_poller():
            while not stop.is_set():
                try:
                    status, _, _ = _get(pool.port, "/ready", timeout=5)
                except urllib.error.HTTPError as e:
                    status = e.code
                ready_codes.append(status)
                min_ready[0] = min(min_ready[0], pool.ready_count)
                time.sleep(0.05)

        poller = threading.Thread(target=ready_poller, daemon=True)
        poller.start()
        spec = TraceSpec(duration_s=8.0, base_rate=30.0, seed=3,
                         diurnal_amplitude=0.3)
        gen = LoadGenerator(spec, pool.port, n_clients=8,
                            payload=[[1.0, 2.0, 3.0, 4.0]])
        swap_result = {}

        def swap_mid_replay():
            time.sleep(1.5)  # let the replay reach steady state first
            swap_result.update(pool.swap_model(v3))

        swapper = threading.Thread(target=swap_mid_replay, daemon=True)
        swapper.start()
        report = gen.run()
        swapper.join(120.0)
        assert not swapper.is_alive()
        stop.set()
        poller.join(10.0)

        assert swap_result.get("ok"), swap_result
        assert swap_result["swapped"] == 3
        # 0 non-2xx beyond the usual 429 budget — no 5xx, no connection
        # errors, no pool-unready 503s leaked mid-roll
        assert set(report["outcomes"]) <= {"200", "429"}, report["outcomes"]
        assert report["outcomes"].get("200", 0) > 0
        # /ready stayed 200 for every poll across the whole swap window
        assert ready_codes and set(ready_codes) == {200}
        assert min_ready[0] >= 2  # never below min_replicas ready
        assert _post(pool.port, [[1.0, 1.0, 1.0, 1.0]])[1]["output"][0][0] == 3.0
        assert _counter_values(reg, "tdl_pool_swap_events_total") == {(): 1}
    finally:
        pool.stop()


@pytest.mark.slow
def test_pool_chaos_replica_kill_and_10x_burst(tmp_path):
    """32 clients replaying a
    SHARED-PREFIX generative mix (N tenants x a common system prompt, the
    TraceSpec prefix mix that exercises CoW sharing on a paged session)
    with a 10x burst while a replica is SIGKILLed mid-flight — only
    200/429/504 ever escape (the router's failover + the client's
    pool_unready retry absorb the restart window), p99 stays bounded, and
    the pool size FOLLOWS the alert signal: up during the burst, back down
    after, with the alert interval paired (fired AND cleared) and no
    flap."""
    from deeplearning4j_tpu_torch.serving import TraceSpec

    prompt_fn = TraceSpec(duration_s=1.0, base_rate=1.0, seed=7,
                          prefix_tenants=4, prefix_len=24, suffix_len=4,
                          prompt_vocab=256).prompt_fn()
    reg = MetricsRegistry()
    pool = _pool(
        tmp_path, target="generative_stub_server",
        replicas=2, min_replicas=1, max_replicas=4, registry=reg,
        extra_env={"TDL_STUB_STEP_DELAY": "0.004", "TDL_STUB_MAX_NEW": "8",
                   "TDL_STUB_QUEUE": "16"},
        heartbeat_interval=0.1).start()
    engine = AlertEngine(
        (AlertRule("inference_queue_depth_hwm", "tdl_inference_queue_depth",
                   ">=", 6, for_duration=2, clear_hysteresis=3,
                   description="pool admission queues filling"),),
        registry=MetricsRegistry(), spool_dir=pool.spool_dir)
    scaler = PoolAutoscaler(pool, engine,
                            scale_up_rules=("inference_queue_depth_hwm",),
                            cooldown_s=1.0, scale_down_idle_evals=6)
    try:
        assert pool.wait_ready(60.0)
        scaler.start(interval=0.25)

        outcomes = []
        latencies = []
        lock = threading.Lock()
        stop_burst = threading.Event()

        def client_worker(idx, requests, deadline_ms):
            client = JsonModelClient(port=pool.port, timeout=20, retries=10,
                                     backoff_base=0.02, backoff_max=0.2,
                                     breaker_threshold=10 ** 6)
            for r in range(requests):
                t0 = time.perf_counter()
                try:
                    client.predict(prompt_fn(idx * 100 + r),
                                   deadline_ms=deadline_ms,
                                   request_id=f"chaos-{idx}-{r}")
                    out = "200"
                except RuntimeError as e:
                    msg = str(e)
                    out = next((c for c in ("429", "504", "503", "500", "400")
                                if f"HTTP {c}" in msg), "error")
                with lock:
                    outcomes.append(out)
                    latencies.append(time.perf_counter() - t0)

        # phase 1: steady trickle (8 clients)
        steady = [threading.Thread(target=client_worker, args=(i, 6, 10_000))
                  for i in range(8)]
        for t in steady:
            t.start()
        time.sleep(1.0)
        # phase 2: the 10x burst (32 clients) + SIGKILL one replica mid-burst
        burst = [threading.Thread(target=client_worker, args=(100 + i, 8, 8_000))
                 for i in range(32)]
        for t in burst:
            t.start()
        time.sleep(0.5)
        _kill_one_replica(pool)
        for t in steady + burst:
            t.join(120.0)
        assert not any(t.is_alive() for t in steady + burst)
        stop_burst.set()
        # phase 3: recovery — let the alert clear and the scaler back off
        deadline = time.monotonic() + 20.0
        peak_desired = pool.desired
        while time.monotonic() < deadline and pool.desired > 2:
            time.sleep(0.25)

        with lock:
            outs = set(outcomes)
            lat = sorted(latencies)
        # ONLY 200/429/504 escape (503s are retried client-side as
        # pool_unready; connection errors are hidden by router failover)
        assert outs <= {"200", "429", "504"}, f"unexpected outcomes: {outs}"
        assert outcomes.count("200") > 0
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        assert p99 < 15.0  # bounded while the replacement warms
        # the pool FOLLOWED the alert: scaled up under the burst...
        events = _counter_values(reg, "tdl_pool_scale_events_total")
        assert events.get(("up",), 0) >= 1, f"no scale-up: {events}"
        assert peak_desired >= 3
        # ...and back down after, without flapping
        assert events.get(("down",), 0) >= 1, f"no scale-down: {events}"
        assert sum(events.values()) <= 6, f"autoscaler flapped: {events}"
        assert pool.desired <= peak_desired - 1
        # the alert interval is PAIRED: a rising edge and a falling edge
        eng_reg = engine.registry
        fired = _counter_values(eng_reg, "tdl_alerts_fired_total")
        cleared = _counter_values(eng_reg, "tdl_alerts_cleared_total")
        assert fired.get(("inference_queue_depth_hwm",), 0) >= 1
        assert cleared.get(("inference_queue_depth_hwm",), 0) >= 1
        # a killed replica died AND was respawned from the shared cache dir
        deaths = _counter_values(reg, "tdl_worker_deaths_total")
        assert deaths[("replica_crash",)] >= 1
    finally:
        scaler.stop()
        pool.stop()
