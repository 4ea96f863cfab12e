"""Port telemetry (``deeplearning4j_tpu_torch.monitoring`` and
``common.faults``) held to the JAX package's on the same operations.

The port keeps its own process-global registry; the same operations on the
JAX package's registry and the port's print identical Prometheus text. Spools,
flight logs, history rings and heartbeats written by either package read the
same through the other's readers (the fleet tools serve a mixed fleet).
"""

import math
import os
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common import faults as jfaults
from deeplearning4j_tpu.monitoring import aggregate as jaggregate
from deeplearning4j_tpu.monitoring import alerts as jalerts
from deeplearning4j_tpu.monitoring import flight as jflight
from deeplearning4j_tpu.monitoring import heartbeat as jheartbeat
from deeplearning4j_tpu.monitoring import history as jhistory
from deeplearning4j_tpu.monitoring import registry as jregistry
from deeplearning4j_tpu.monitoring import timeline as jtimeline
from deeplearning4j_tpu_torch.common import faults
from deeplearning4j_tpu_torch.monitoring import (aggregate, alerts, flight, heartbeat,
                                                 history, registry, timeline)
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401

PACKAGES = {
    "jax": dict(registry=jregistry, aggregate=jaggregate, flight=jflight,
                history=jhistory, timeline=jtimeline, heartbeat=jheartbeat,
                alerts=jalerts),
    "port": dict(registry=registry, aggregate=aggregate, flight=flight,
                 history=history, timeline=timeline, heartbeat=heartbeat,
                 alerts=alerts),
}


def _exercise(reg):
    """One fixed sequence of registry operations."""
    c = reg.counter("tdl_requests_total", "requests by code", labels=("code",))
    c.labels("200").inc()
    c.labels(code="429").inc(3)
    reg.counter("tdl_plain_total", 'help with "quotes" and \\ and\nnewline').inc(2.5)
    g = reg.gauge("tdl_depth", "queue depth")
    g.set(7)
    g.dec(2)
    g.set_to_max(4)
    reg.gauge("tdl_inf", "an infinite gauge", labels=("k",)).labels('a"b\n').set(math.inf)
    h = reg.histogram("tdl_latency_seconds", "latency", labels=("route",),
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.1):
        h.labels("predict").observe(v)
    reg.histogram("tdl_batch_size", "rows", buckets=(1, 2, 4, 8)).observe(3)
    return reg


# ------------------------------------------------------------------ registry


def test_same_operations_print_identical_prometheus_text():
    jreg, treg = _exercise(jregistry.MetricsRegistry()), _exercise(registry.MetricsRegistry())
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert treg.snapshot() == jreg.snapshot()
    assert treg.names() == jreg.names()


def test_the_port_has_its_own_process_registry():
    assert registry.get_registry() is not jregistry.get_registry()
    name = "tdl_port_only_probe_total"
    registry.get_registry().counter(name).inc()
    assert jregistry.get_registry().get(name) is None


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_registry_refuses_mismatches_alike(pkg):
    reg = PACKAGES[pkg]["registry"].MetricsRegistry()
    reg.counter("tdl_x_total", labels=("a",))
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("tdl_x_total")
    with pytest.raises(ValueError, match="counters only go up"):
        reg.counter("tdl_x_total", labels=("a",)).labels("1").inc(-1)
    with pytest.raises(ValueError, match="invalid metric name"):
        reg.counter("bad-name")
    with pytest.raises(ValueError, match="expected labels"):
        reg.counter("tdl_x_total", labels=("a",)).labels("1", "2")


# --------------------------------------------------- spools across packages


def _spool_dir(tmp_path, writer, procs=("replica0", "replica1")):
    """Metrics spools of two procs (rank 0 and 1, with step-time
    histograms so the straggler gauges derive), written by ``writer``."""
    d = tmp_path / "spool"
    mods = PACKAGES[writer]
    for rank, proc in enumerate(procs):
        reg = _exercise(mods["registry"].MetricsRegistry())
        h = reg.histogram("tdl_step_wall_seconds", "step wall")
        for _ in range(3):
            h.observe(0.1 * (rank + 1))
        mods["aggregate"].MetricsSpooler(str(d), proc=proc, registry=reg, rank=rank).spool()
    return str(d)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_metrics_spools_merge_alike_through_both_packages(tmp_path, writer):
    d = _spool_dir(tmp_path, writer)
    jreg, treg = jregistry.MetricsRegistry(), registry.MetricsRegistry()
    want = jaggregate.merged_prometheus(d, local_registry=_exercise(jreg))
    got = aggregate.merged_prometheus(d, local_registry=_exercise(treg))
    assert got == want
    assert 'proc="replica1",rank="1"' in got and "tdl_step_time_skew_ratio 2" in got
    assert aggregate.derive_straggler(aggregate.read_spools(d)) == \
        jaggregate.derive_straggler(jaggregate.read_spools(d))


def test_torn_spools_are_skipped_and_counted_alike(tmp_path):
    d = _spool_dir(tmp_path, "port")
    with open(os.path.join(d, "tdl_metrics_replica9.123.json"), "w") as f:
        f.write("{torn")
    counts = []
    for mod, reg_mod in ((jaggregate, jregistry), (aggregate, registry)):
        reg = reg_mod.MetricsRegistry()
        assert len(mod.read_spools(d, registry=reg)) == 2
        counts.append(reg.get("tdl_spool_read_errors_total").snapshot())
    assert counts[0] == counts[1]
    assert counts[1]["series"][0]["labels"] == {"reader": "metrics", "proc": "replica9"}


def _flight_spools(d, writer):
    """A router lane and a replica lane sharing one trace id, written by
    ``writer``'s recorders."""
    fl = PACKAGES[writer]["flight"]
    router = fl.FlightRecorder(proc="router", directory=str(d), interval=0.0, run="run1")
    replica = fl.FlightRecorder(proc="replica0", directory=str(d), interval=0.0, run="run1")
    router.record("route", request_id="r1", trace_id="t1", replica=0, code=200,
                  seconds=0.02)
    replica.record("request_span", request_id="r1", trace_id="t1", outcome="ok",
                   code=200, phases={"queue": 0.001, "infer": 0.01})
    replica.record("replica_spawn", replica=0, restarts=0)
    router.flush()
    replica.flush()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_flight_spools_build_the_same_timeline_in_both_packages(tmp_path, writer):
    _flight_spools(tmp_path, writer)
    want = jtimeline.build_timeline(flight_dirs=[str(tmp_path)],
                                    registry=jregistry.MetricsRegistry())
    got = timeline.build_timeline(flight_dirs=[str(tmp_path)],
                                  registry=registry.MetricsRegistry())
    assert got == want
    assert got["otherData"]["flows"] == 1
    assert got["otherData"]["run_ids"] == ["run1"]
    assert set(got["otherData"]["procs"]) == {"router", "replica0"}
    assert {e["ph"] for e in got["traceEvents"]} <= {"X", "i", "M", "s", "t", "f"}


def test_flight_recorder_vocabulary_and_env_contract_match(tmp_path, monkeypatch):
    assert flight.EVENT_KINDS == jflight.EVENT_KINDS
    assert flight.SPOOL_PREFIX == jflight.SPOOL_PREFIX
    monkeypatch.setenv(flight.ENV_DIR, str(tmp_path))
    monkeypatch.setenv(flight.ENV_INTERVAL, "0")
    monkeypatch.setenv(flight.ENV_PROC, "replica4")
    assert flight.active()
    flight.record("queue_hwm", queue="inference", depth=3, max_queue=8)
    flight.flush()
    spools = jflight.read_spools(str(tmp_path))
    assert [s["proc"] for s in spools] == ["replica4"]
    assert spools[0]["events"][-1]["kind"] == "queue_hwm"
    assert spools[0]["anchors"]


# ---------------------------------------------------------------- history


def test_window_math_matches_the_jax_package():
    rs = np.random.RandomState(0)
    buckets = {str(ub): int(c) for ub, c in zip((0.01, 0.1, 1.0, 10.0), rs.randint(0, 20, 4))}
    for q in (0.5, 0.9, 0.99):
        assert (history.quantile_from_buckets(buckets, 3, q)
                == jhistory.quantile_from_buckets(buckets, 3, q))
    first = {"buckets": {"0.1": 2, "1": 3}, "inf": 1, "sum": 2.0, "count": 6}
    last = {"buckets": {"0.1": 5, "1": 4}, "inf": 2, "sum": 4.5, "count": 11}
    for a, b in ((first, last), (last, first)):
        assert history.histogram_delta(a, b) == jhistory.histogram_delta(a, b)
    assert history.counter_increase(5, 3) == jhistory.counter_increase(5, 3) == 3


def test_history_rings_spooled_by_either_package_merge_alike(tmp_path):
    d = str(tmp_path)
    for pkg, proc in (("jax", "replica0"), ("port", "replica1")):
        mods = PACKAGES[pkg]
        reg = mods["registry"].MetricsRegistry()
        c = reg.counter("tdl_inference_requests_total", "responses", labels=("code",))
        ring = mods["history"].HistoryRing(reg, interval=0.0, proc=proc, directory=d)
        for _ in range(3):
            c.labels("200").inc(2)
            ring.sample(force=True)
    strip = lambda ss: [(s["proc"], s["snapshot"]) for s in ss]  # noqa: E731
    got, want = history.merged_samples(d), jhistory.merged_samples(d)
    assert strip(got) == strip(want) and len(got) == 6
    pts = history.window_points(got, "tdl_inference_requests_total")
    assert pts == jhistory.window_points(want, "tdl_inference_requests_total")
    assert sorted(p[0] for p in pts) == ["replica0", "replica1"]


# -------------------------------------------------------------- heartbeat


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_heartbeat_files_read_alike(tmp_path, writer, reader):
    PACKAGES[writer]["heartbeat"].HeartbeatWriter(str(tmp_path), 2, interval=0.0).beat(17)
    it, mtime = PACKAGES[reader]["heartbeat"].read_heartbeat(str(tmp_path), 2)
    assert it == 17 and mtime <= time.time() + 1
    assert heartbeat.heartbeat_path("d", 2) == jheartbeat.heartbeat_path("d", 2)


def test_sample_memory_reads_host_rss_and_never_initialises_cuda():
    reg = registry.MetricsRegistry()
    assert not torch.cuda.is_initialized()
    out = heartbeat.sample_memory(reg)
    assert set(out) == {"host_rss"} and out["host_rss"] > 0
    assert reg.get("tdl_mem_host_rss_bytes").value == out["host_rss"]
    assert reg.get("tdl_mem_device_bytes_in_use") is None
    assert not torch.cuda.is_initialized()


def test_sample_memory_reads_only_the_allocator_counters_on_the_card(monkeypatch):
    """With CUDA initialised the gauges take the caching allocator's
    counters, labelled cuda:<index>; ``mem_get_info`` (a CUDA API call not
    allowed while another thread captures a CUDA graph) is never called."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 1234, "allocated_bytes.all.peak": 5678})

    def forbidden(*a, **k):
        raise AssertionError("mem_get_info called")

    monkeypatch.setattr(torch.cuda, "mem_get_info", forbidden)
    reg = registry.MetricsRegistry()
    out = heartbeat.sample_memory(reg)
    assert out["cuda:0"] == 1234
    assert reg.get("tdl_mem_device_bytes_in_use").labels("cuda:0").value == 1234
    assert reg.get("tdl_mem_device_peak_bytes").labels("cuda:0").value == 5678


# ----------------------------------------------------------------- faults


def test_fault_specs_parse_alike_and_fire_at_the_same_inference_calls(monkeypatch):
    spec = ("crash@iter=7,rank=1;slow_ckpt_io=2.0;fail_infer@n=3;"
            "torn_ckpt@iter=4,stage=shard;slow_infer@p=0")
    assert ([(f.kind, f.params) for f in faults.parse_fault_spec(spec)]
            == [(f.kind, f.params) for f in jfaults.parse_fault_spec(spec)])
    for bad in ("explode@n=1", "torn_ckpt@stage=nowhere", "fail_infer@n"):
        with pytest.raises(ValueError) as want:
            jfaults.parse_fault_spec(bad)
        with pytest.raises(ValueError) as got:
            faults.parse_fault_spec(bad)
        assert str(got.value) == str(want.value)
    monkeypatch.setenv(faults.ENV_SPEC, "fail_infer@n=3")
    fired = []
    for mod in (jfaults, faults):
        calls = []
        for i in range(1, 8):
            try:
                mod.fault_point("infer")
            except mod.InjectedFault:
                calls.append(i)
        fired.append(calls)
    assert fired[0] == fired[1] == [3, 6]
    monkeypatch.setenv(faults.ENV_SPEC, "fail_infer@n=1,rank=2")
    faults.fault_point("infer")  # rank 0: not this process's clause


def test_latency_inject_targets_one_model_version(monkeypatch):
    monkeypatch.setenv(faults.ENV_SPEC, "latency_inject@value=0.2,model=gen-8")
    monkeypatch.setenv("TDL_MODEL_CKPT", "/ck/gen-7")
    t0 = time.perf_counter()
    faults.fault_point("infer")
    assert time.perf_counter() - t0 < 0.1
    monkeypatch.setenv("TDL_MODEL_CKPT", "/ck/gen-8")
    t0 = time.perf_counter()
    faults.fault_point("infer")
    assert time.perf_counter() - t0 >= 0.2
    faults.fault_point("ckpt_write")  # sites the port does not have: no-op


# ----------------------------------------------------------------- alerts


def _loaded_registry(mods, depth, latencies, shed):
    reg = mods["registry"].MetricsRegistry()
    reg.gauge("tdl_inference_queue_depth", "queue depth").set(depth)
    h = reg.histogram("tdl_inference_latency_seconds", "latency")
    for v in latencies:
        h.observe(v)
    reg.counter("tdl_inference_shed_total", "shed", labels=("reason",)).labels(
        "queue_full").inc(shed)
    return reg


def test_alert_engines_judge_the_same_registry_alike():
    assert alerts.default_rules() == tuple(
        alerts.AlertRule(**r.__dict__) for r in jalerts.default_rules())
    rules = lambda m: (  # noqa: E731
        m.AlertRule("queue", "tdl_inference_queue_depth", ">=", 48),
        m.AlertRule("p99", "tdl_inference_latency_seconds", ">", 0.5, agg="p99"),
        m.AlertRule("mean", "tdl_inference_latency_seconds", ">", 0.5, agg="mean"),
        m.AlertRule("shed", "tdl_inference_shed_total", ">", 0, agg="sum",
                    after_warmup=True))
    for depth, lat, shed in ((50, [0.9, 0.8, 0.1], 2), (3, [0.01] * 5, 0)):
        results = []
        for pkg in ("jax", "port"):
            mods = PACKAGES[pkg]
            reg = _loaded_registry(mods, depth, lat, shed)
            engine = mods["alerts"].AlertEngine(rules(mods["alerts"]), registry=reg)
            first = engine.evaluate()
            engine.mark_warmup_done()
            reg.counter("tdl_inference_shed_total", labels=("reason",)).labels(
                "queue_full").inc(1)
            results.append((first, engine.evaluate(), reg.to_prometheus()))
        assert results[0] == results[1]
        assert results[1][1][3]["firing"] and results[1][1][3]["value"] == 1


def test_windowed_rules_fire_and_clear_on_a_history_ring():
    reg = registry.MetricsRegistry()
    ring = history.HistoryRing(reg, interval=0.0)
    engine = alerts.AlertEngine(
        (alerts.AlertRule("shed_rate", "tdl_inference_shed_total", ">", 5.0, agg="sum",
                          window=10.0, rate=True, for_duration=2),), registry=reg,
        history_view=ring)
    shed = reg.counter("tdl_inference_shed_total", "shed", labels=("reason",))
    now = time.monotonic()
    states = []
    for k in range(6):  # 10 sheds a second for 6 samples, then silence
        shed.labels("queue_full").inc(10)
        ring._ring.append({"t": now + k, "wall": 0.0, "snapshot": reg.snapshot()})
        states.append(engine._evaluate_locked([reg.snapshot()], now + k)[0]["state"])
    assert states[:3] == ["no_data", "pending", "firing"]
    for k in range(6, 20):
        ring._ring.append({"t": now + k, "wall": 0.0, "snapshot": reg.snapshot()})
        states.append(engine._evaluate_locked([reg.snapshot()], now + k)[0]["state"])
    assert states[-1] == "ok"
    fired = reg.get("tdl_alerts_fired_total").labels("shed_rate").value
    cleared = reg.get("tdl_alerts_cleared_total").labels("shed_rate").value
    assert fired == cleared == 1
