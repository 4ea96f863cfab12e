"""Port trace-replay load generator (``deeplearning4j_tpu_torch.serving.loadgen``),
mirroring the JAX package's ``tests/test_loadgen.py``.

Fast tier: deterministic arrival schedules (identical to the JAX package's
for the same spec), diurnal/burst rate shaping, deadline mix, spec JSON
round-trip, shared-prefix prompts, and short live replays against the port's
server. Slow tier: a seeded diurnal + 10x-burst replay with a history ring
and the alert engine evaluating during the replay — the windowed p99 rule
fires under the burst and clears after recovery, and a sampled 200 and a
shed 504 each reconstruct their span timeline by request id. (The JAX
test's burn-rate rules read ``tdl_slo_burn_rate`` from an SLO tracker, which
the port does not have yet: ROADMAP item 8.)
"""

import json
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.serving import loadgen as jax_loadgen
from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
from deeplearning4j_tpu_torch.serving import (Burst, JsonModelServer, LoadGenerator,
                                              TraceSpec, replay)
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401
from torch_serving_helpers import net


class EchoModel:
    """2x the input, optionally with a per-ROW cost so overload builds real
    queues: capacity is ~1/row_cost rows/sec, which a burst can exceed."""

    def __init__(self, row_cost_s: float = 0.0):
        self.row_cost_s = row_cost_s

    def output(self, x):
        x = np.asarray(x, np.float32)
        if self.row_cost_s:
            time.sleep(self.row_cost_s * x.shape[0])
        return x * 2.0


# ------------------------------------------------------------------- spec


def test_spec_validation():
    with pytest.raises(ValueError, match="must be > 0"):
        TraceSpec(duration_s=0)
    with pytest.raises(ValueError, match="amplitude"):
        TraceSpec(diurnal_amplitude=1.0)
    with pytest.raises(ValueError, match="positive weights"):
        TraceSpec(deadline_mix=((0.0, None),))
    with pytest.raises(ValueError, match="prefix_tenants"):
        TraceSpec(prefix_tenants=-1)


def test_arrivals_deterministic_and_json_roundtrip():
    spec = TraceSpec(duration_s=5.0, base_rate=80, seed=42,
                     diurnal_amplitude=0.5, bursts=(Burst(2.0, 1.0, 8.0),),
                     deadline_mix=((0.8, None), (0.2, 100.0)))
    a, b = spec.arrivals(), spec.arrivals()
    assert a == b  # same seed → byte-identical schedule
    assert TraceSpec(duration_s=5.0, base_rate=80, seed=43,
                     diurnal_amplitude=0.5, bursts=(Burst(2.0, 1.0, 8.0),),
                     deadline_mix=((0.8, None), (0.2, 100.0))).arrivals() != a
    rt = TraceSpec.from_dict(json.loads(json.dumps(spec.to_dict())))
    assert rt == spec and rt.arrivals() == a
    assert all(0 <= t < 5.0 for t, _ in a)
    assert {d for _, d in a} <= {None, 100.0}
    with_deadline = sum(1 for _, d in a if d is not None)
    assert 0.1 < with_deadline / len(a) < 0.35  # ~20% by weight


def test_rate_curve_diurnal_and_burst_shape():
    spec = TraceSpec(duration_s=10.0, base_rate=100, seed=1,
                     diurnal_amplitude=0.5, bursts=(Burst(6.0, 2.0, 10.0),))
    assert spec.rate_at(0.0) == pytest.approx(50.0)  # starts at the trough
    assert spec.rate_at(5.0) == pytest.approx(150.0)  # peak mid-trace
    assert spec.rate_at(6.5) / spec.rate_at(5.9) > 8  # 10x burst edge
    assert spec.peak_rate == pytest.approx(1500.0)
    arrivals = spec.arrivals()
    in_burst = sum(1 for t, _ in arrivals if 6.0 <= t < 8.0)
    pre_burst = sum(1 for t, _ in arrivals if 3.0 <= t < 5.0)
    assert in_burst / max(1, pre_burst) > 4


@pytest.mark.parametrize("kw", [
    dict(duration_s=6.0, base_rate=30, seed=5, diurnal_amplitude=0.4,
         bursts=((3.0, 0.9, 10.0),)),
    dict(duration_s=3.0, base_rate=50, seed=9, deadline_mix=((0.5, None), (0.5, 80.0)),
         prefix_tenants=3, prefix_len=16, suffix_len=4, prompt_vocab=97),
])
def test_schedule_and_prompts_match_the_jax_package(kw):
    """The same spec gives the same arrival schedule, the same JSON and the
    same shared-prefix prompts in both packages: a replay recorded against
    one package's server is replayable against the other's."""
    spec, jspec = TraceSpec(**kw), jax_loadgen.TraceSpec(**kw)
    assert spec.arrivals() == jspec.arrivals()
    assert spec.to_dict() == jspec.to_dict()
    if spec.prefix_tenants:
        fn, jfn = spec.prompt_fn(), jspec.prompt_fn()
        assert [fn(i) for i in range(12)] == [jfn(i) for i in range(12)]
        assert fn(0)[:16] == fn(3)[:16] != fn(1)[:16]  # tenants share prefixes


def test_live_replay_report_shape():
    server = JsonModelServer(EchoModel(),
                             warmup_input=np.zeros((1, 2), np.float32)).start()
    try:
        assert server.wait_ready(30.0)
        spec = TraceSpec(duration_s=1.5, base_rate=40, seed=3)
        rep = LoadGenerator(spec, server.port, n_clients=4,
                            payload=[[1.0, 2.0]], slo_threshold_ms=500,
                            slo_target=0.99, record_requests=True).run()
        assert rep["offered"] == len(spec.arrivals())
        assert rep["outcomes"].get("200", 0) == rep["offered"]
        assert rep["slo"]["attainment"] == 1.0
        assert rep["slo"]["error_budget_remaining"] == 1.0
        assert rep["slo"]["burn_rate_overall"] == 0.0
        assert rep["latency_ms"]["p99"] is not None
        assert len(rep["requests"]) == rep["offered"]
        assert rep["requests"][0]["request_id"].startswith("replay-3-")
        assert rep["lateness_ms"]["p99"] < 500
    finally:
        server.stop()


def test_replay_of_a_port_network_counts_every_request():
    """``replay`` against the port's server over a port MLN: every
    scheduled arrival is one 200, and the client-side histogram (the
    clients' registry) holds one observation per request."""
    reg = MetricsRegistry()
    server = (JsonModelServer.Builder(net()).port(0).batch_limit(4)
              .warmup_input(np.zeros((1, 4), np.float32)).build().start())
    try:
        assert server.wait_ready(30.0)
        spec = TraceSpec(duration_s=1.0, base_rate=30, seed=8)
        rep = replay(spec, server.port, n_clients=4,
                     payload_fn=lambda i: [[float(i), 0.0, 1.0, 2.0]], registry=reg)
        assert rep["outcomes"] == {"200": len(spec.arrivals())}
        hist = reg.get("tdl_client_request_seconds").snapshot()["series"]
        assert {s["labels"]["outcome"]: s["count"] for s in hist} == {
            "ok": len(spec.arrivals())}
    finally:
        server.stop()


# ------------------------------------------------------------- slow tier


def _intervals(events):
    """(rule, fired_t, cleared_t or None) from alert/alert_clear events."""
    open_, out = {}, []
    for e in sorted(events, key=lambda e: e["t"]):
        if e["kind"] == "alert":
            open_[e["rule"]] = e["t"]
        elif e["rule"] in open_:
            out.append((e["rule"], open_.pop(e["rule"]), e["t"]))
    out.extend((rule, t, None) for rule, t in open_.items())
    return out


@pytest.mark.slow
def test_replay_acceptance_burst_fires_and_clears_windowed_alerts():
    """A seeded diurnal+burst replay against a live server → SLO report
    with attainment / budget / burn; the windowed p99 rule fires during the
    10x burst and records a matching alert/alert_clear interval; a sampled
    200 and a shed 504 reconstruct full span timelines by request id;
    nothing fires in the steady pre-burst phase."""
    from deeplearning4j_tpu_torch.monitoring import (AlertEngine, HistoryRing,
                                                     default_rules, flight)
    from deeplearning4j_tpu_torch.monitoring.flight import FlightRecorder

    rec = FlightRecorder(proc="replay-test", capacity=16384)
    flight.set_flight_recorder(rec)
    reg = MetricsRegistry()
    # per-row cost 10ms → capacity ~100 rows/s; the 10x burst is not
    server = JsonModelServer(EchoModel(row_cost_s=0.01), max_queue=256,
                             registry=reg,
                             warmup_input=np.zeros((1, 2), np.float32)).start()
    try:
        assert server.wait_ready(60.0)
        burst = Burst(5.0, 3.0, 10.0)
        spec = TraceSpec(duration_s=12.0, base_rate=40.0, seed=11,
                         diurnal_amplitude=0.3, bursts=(burst,),
                         deadline_mix=((0.8, None), (0.2, 150.0)))
        threshold_s = 0.1
        ring = HistoryRing(registry=reg, interval=0.0, capacity=1024)
        engine = AlertEngine(default_rules(p99_latency_s=threshold_s,
                                           latency_window_s=2.0, shed_window_s=2.0),
                             registry=reg, history_view=ring)
        t0 = time.monotonic()
        stop_eval = threading.Event()

        def evaluate_loop():
            while not stop_eval.is_set():
                ring.sample(force=True)
                engine.evaluate()
                stop_eval.wait(0.2)

        evaluator = threading.Thread(target=evaluate_loop, daemon=True)
        evaluator.start()
        report = LoadGenerator(
            spec, server.port, n_clients=32, payload=[[1.0, 2.0]],
            slo_threshold_ms=threshold_s * 1e3, slo_target=0.95,
            record_requests=True).run()
        recovery_deadline = time.monotonic() + 20.0
        while time.monotonic() < recovery_deadline:
            ring.sample(force=True)
            if not any(a["firing"] for a in engine.evaluate()):
                break
            time.sleep(0.2)
        stop_eval.set()
        evaluator.join(10.0)
        server.stop(drain=True)

        slo = report["slo"]
        assert slo["attainment"] is not None and slo["attainment"] < 1.0
        assert slo["burn_rate_worst_window"] > 1.0
        assert set(report["outcomes"]) <= {"200", "429", "504"}
        alert_events = [e for e in rec.events() if e["kind"] in ("alert", "alert_clear")]
        assert "p99_latency_rising" in {e["rule"] for e in alert_events
                                        if e["kind"] == "alert"}
        assert min(e["t"] - t0 for e in alert_events
                   if e["kind"] == "alert") >= burst.start_s - 0.5
        p99 = [r for r in _intervals(alert_events) if r[0] == "p99_latency_rising"]
        assert any(cleared is not None and cleared > fired for _, fired, cleared in p99)
        spans = {e["request_id"]: e for e in rec.events() if e["kind"] == "request_span"}
        ok_rows = [r for r in report["requests"]
                   if r["outcome"] == "200" and r["request_id"] in spans]
        assert ok_rows
        assert set(spans[ok_rows[0]["request_id"]]["phases"]) == {
            "queue", "batch_form", "infer", "serialize"}
        shed_rows = [r for r in report["requests"]
                     if r["outcome"] == "504" and r["request_id"] in spans]
        assert shed_rows
        assert spans[shed_rows[0]["request_id"]]["outcome"] == "shed_deadline"
    finally:
        server.stop()
        flight.set_flight_recorder(None)
