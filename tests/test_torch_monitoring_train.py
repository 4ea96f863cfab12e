"""The monitoring that instruments the port's training path, against the JAX
package's: trace spans and the op profiler, the recompile and
device-memory watchdogs, what the port counts as a compile, the compile
cache's hits and misses, the MetricsListener, the debug helpers, the
utilities, and the lint that every stock alert rule reads a family some
port module declares.

Tolerances: counts, names, JSON and tables are equal; the listener's score
within 1e-5 of the JAX network's (float32 steps of a small MLN); what
differs from the JAX package by design is pinned and named in each test.
"""

import ast
import json
import logging
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import monitoring as JM
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.monitoring import timeline as JTimeline
from deeplearning4j_tpu.monitoring import trace as JTrace
from deeplearning4j_tpu.monitoring import watchdogs as JWatch
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.ops import profiler as JProf
from deeplearning4j_tpu_torch import monitoring as TM
from deeplearning4j_tpu_torch.common import compile_cache, debug
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.monitoring import aggregate as TAgg
from deeplearning4j_tpu_torch.monitoring import compilecache
from deeplearning4j_tpu_torch.monitoring import timeline as TTimeline
from deeplearning4j_tpu_torch.monitoring import trace as TTrace
from deeplearning4j_tpu_torch.monitoring import watchdogs as TWatch
from deeplearning4j_tpu_torch.ops import profiler as TProf
from deeplearning4j_tpu_torch import utils as TUtils
from deeplearning4j_tpu import utils as JUtils
from torch_mln_helpers import port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deeplearning4j_tpu_torch"
SCORE_ATOL = 1e-5  # a small float32 MLN's score, port against JAX, after a few steps


def _jnet(n_in=5, hidden=7, classes=3, seed=3):
    conf = (JConf.Builder().seed(seed).updater(JU.Adam(1e-2)).list()
            .layer(JC.DenseLayer(n_in=n_in, n_out=hidden, activation="tanh"))
            .layer(JC.OutputLayer(n_out=classes, activation="softmax", loss="mcxent"))
            .set_input_type(JC.InputType.feed_forward(n_in)).build())
    return JNet(conf).init()


def _batch(n, n_in=5, classes=3, seed=0):
    rs = np.random.RandomState(seed + n)
    return (rs.randn(n, n_in).astype(np.float32),
            np.eye(classes, dtype=np.float32)[rs.randint(0, classes, n)])


def _series(reg, name):
    m = reg.get(name)
    if m is None:
        return {}
    return {tuple(sorted(s["labels"].items())): s["value"]
            for s in m.snapshot()["series"]}


# --------------------------------------------------------------- spans


def _span_program(mod, prof):
    """The same nesting through either package's trace module."""
    paths = []
    mod.set_trace_profiler(prof)
    try:
        with mod.span("fit"):
            paths.append(mod.current_span_path())
            for step in range(3):
                with mod.step_span(step):
                    with mod.span("h2d"):
                        paths.append(mod.current_span_path())
                    with mod.span("compute") as s:
                        paths.append(s.qualified_name)
        paths.append(mod.current_span_path())
    finally:
        mod.set_trace_profiler(None)
    return paths


def test_span_paths_nesting_and_profiler_events_equal_jax():
    jp = JProf.OpProfiler(JProf.ProfilerConfig(trace_events=True))
    tp = TProf.OpProfiler(TProf.ProfilerConfig(trace_events=True))
    assert _span_program(TTrace, tp) == _span_program(JTrace, jp)
    assert [e["name"] for e in tp._events] == [e["name"] for e in jp._events]
    assert {k: v["count"] for k, v in tp.stats().items()} == \
        {k: v["count"] for k, v in jp.stats().items()}
    assert "fit/train/compute" in tp.stats() and tp.stats()["fit/train"]["count"] == 3
    assert all(e["ph"] == "X" and e["dur"] > 0 for e in tp._events)
    assert TTrace.get_trace_profiler() is None and TTrace.current_span_path() == ""


def test_spans_are_record_function_ranges_in_a_profiler_capture():
    """Where the JAX package enters a TraceAnnotation, the port enters a
    ``torch.profiler.record_function`` of the span's name; a step span
    carries its step number."""
    from torch.profiler import ProfilerActivity, profile

    prof = TProf.OpProfiler(TProf.ProfilerConfig(trace_events=True))
    TTrace.set_trace_profiler(prof)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as cap:
            for step in range(4):
                with TTrace.step_span(step):
                    with TTrace.span("inner"):
                        torch.ones(8).sum()
    finally:
        TTrace.set_trace_profiler(None)
    names = [e.name for e in cap.events()]
    assert names.count("train") == 4 and names.count("inner") == 4
    assert prof.stats()["train"]["count"] == 4


def test_phase_recorder_spans_ride_along_with_a_trace_profiler():
    reg = TM.MetricsRegistry()
    prof = TProf.OpProfiler(TProf.ProfilerConfig(trace_events=True))
    rec = TTrace.StepPhaseRecorder(registry=reg)
    TTrace.set_trace_profiler(prof)
    try:
        with rec.phase("compute"):
            with rec.phase("collective"):
                pass
        rec.step_done()
    finally:
        TTrace.set_trace_profiler(None)
    assert set(prof.stats()) == {"compute", "compute/collective"}
    with rec.phase("input"):  # detached: host timing only
        pass
    assert set(prof.stats()) == {"compute", "compute/collective"}


def test_op_profiler_trace_spool_and_analyzer_equal_jax(tmp_path):
    for mod, tag in ((TProf, "t"), (JProf, "j")):
        p = mod.OpProfiler(mod.ProfilerConfig(trace_events=True))
        for i, name in enumerate(("mm", "conv", "mm", "relu")):
            p.record(name, 1000 * (i + 1))
        with p.timed("block"):
            pass
        p.to_chrome_trace(str(tmp_path / f"{tag}.json"))
    a, b = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    got = TProf.ProfileAnalyzer.compare(a, b)
    want = JProf.ProfileAnalyzer.compare(a, b)
    def strip(rows):  # the timed block's durations differ from run to run
        return [{k: v for k, v in r.items() if "ns" not in k or r["op"] != "block"}
                for r in rows]

    assert strip(got) == strip(want)
    assert [r["op"] for r in got] == ["block", "conv", "mm", "relu"]
    assert TProf.SPOOL_PREFIX == TTimeline.OPTRACE_PREFIX == JProf.SPOOL_PREFIX
    p = TProf.OpProfiler(TProf.ProfilerConfig(trace_events=True), proc="torchproc")
    assert p.spool_path is None and p.flush() is None  # no directory: no spool
    p.reset()
    assert p.stats() == {}


def test_scan_optrace_dir_reads_both_packages_spools(tmp_path):
    d = str(tmp_path / "optrace")
    for mod, proc in ((TProf, "torchproc"), (JProf, "jaxproc")):
        p = mod.OpProfiler(mod.ProfilerConfig(trace_events=True), proc=proc, directory=d)
        p.record("step", 2000)
        p.record("step", 3000)
        assert p.flush() == os.path.join(d, f"tdl_optrace_{proc}.json") == p.spool_path
    (tmp_path / "optrace" / "tdl_optrace_torn.json").write_text("{not json")
    key = lambda s: s["proc"]  # noqa: E731
    treg, jreg = TM.MetricsRegistry(), JM.MetricsRegistry()
    got = sorted(TTimeline.scan_optrace_dir(d, treg), key=key)
    want = sorted(JTimeline.scan_optrace_dir(d, jreg), key=key)
    assert got == want and [s["proc"] for s in got] == ["jaxproc", "torchproc"]
    assert _series(treg, "tdl_spool_read_errors_total") == \
        _series(jreg, "tdl_spool_read_errors_total") != {}
    tl = TTimeline.build_timeline(optrace_dirs=[d], registry=TM.MetricsRegistry())
    jl = JTimeline.build_timeline(optrace_dirs=[d], registry=JM.MetricsRegistry())
    assert tl == jl
    assert sum(e.get("name") == "step" for e in tl["traceEvents"]) == 4


# -------------------------------------------------------------- watchdogs


def test_signature_of_matches_jax_leaf_order():
    x = np.zeros((2, 3), np.float32)
    tree = {"b": x, "a": [np.zeros(4, np.int32), None], "c": None}
    assert TWatch.signature_of(tree) == JWatch.signature_of(tree)
    assert TWatch.signature_of(torch.zeros(2, 3)) == JWatch.signature_of(x)
    assert TWatch.signature_of(torch.zeros(2, 3)) != TWatch.signature_of(torch.zeros(3, 2))
    assert TWatch.signature_of(torch.zeros(2, 3)) != \
        TWatch.signature_of(torch.zeros(2, 3, dtype=torch.int32))


def _fit_sequence(net, DS, sizes, scan_sizes):
    for n in sizes:
        net._fit_batch(DS(*_batch(n)))
    for n in scan_sizes:
        net.fit_scan([DS(*_batch(n, seed=k)) for k in range(2)])


def test_recompile_watchdog_counts_equal_jax(caplog):
    """The same batch shapes through the JAX MLN and the port MLN: equal new
    signatures per function, churn warnings and LRU evictions."""
    sizes = (6, 7, 8, 6, 9, 10, 6)
    scan_sizes = (4, 4, 5)
    jnet = _jnet()
    tnet = port_net(jnet)
    regs = {}
    for tag, net, DS, W in (("jax", jnet, JDataSet, JWatch), ("torch", tnet, DataSet, TWatch)):
        reg = regs[tag] = (JM.MetricsRegistry() if tag == "jax" else TM.MetricsRegistry())
        with W.RecompileWatchdog(registry=reg, window_steps=4, churn_threshold=3,
                                 max_signatures_per_fn=3) as wd:
            assert W.active()
            with caplog.at_level(logging.WARNING):
                _fit_sequence(net, DS, sizes, scan_sizes)
            stats = wd.stats()
        assert not W.active()
        regs[tag + "_steps"] = stats["steps"]
        regs[tag + "_sigs"] = stats["signatures"]
    for fam in ("tdl_jit_new_signatures_total", "tdl_shape_churn_warnings_total",
                "tdl_jit_signature_evictions_total"):
        assert _series(regs["torch"], fam) == _series(regs["jax"], fam), fam
    fn = (("fn", "MultiLayerNetwork.train_step"),)
    assert _series(regs["torch"], "tdl_jit_new_signatures_total")[fn] == 5
    assert _series(regs["torch"], "tdl_jit_signature_evictions_total")[fn] == 2
    assert _series(regs["torch"], "tdl_shape_churn_warnings_total")[()] >= 1
    assert regs["torch_steps"] == regs["jax_steps"] == len(sizes) + len(scan_sizes)
    assert regs["torch_sigs"] == regs["jax_sigs"]
    assert any("recompile watchdog" in r.message and "deeplearning4j_tpu_torch" in r.name
               for r in caplog.records)


def test_recompile_watchdog_tbptt_signatures_equal_jax():
    def conf(M, L):
        return (M["conf"].Builder().seed(4).updater(M["upd"].Sgd(0.1)).list()
                .layer(M["c"].GravesLSTM(n_in=3, n_out=4, activation="tanh"))
                .layer(M["c"].RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(M["c"].InputType.recurrent(3))
                .t_bptt_length(L).build())
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork as TNet
    from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration as TConf
    from deeplearning4j_tpu_torch.nn import conf as TC
    from deeplearning4j_tpu_torch.nn import updaters as TU

    jnet = JNet(conf({"conf": JConf, "upd": JU, "c": JC}, 4)).init()
    tnet = TNet(conf({"conf": TConf, "upd": TU, "c": TC}, 4), device="cpu").init()
    rs = np.random.RandomState(5)
    counts = {}
    for tag, net, DS, W, reg in (("jax", jnet, JDataSet, JWatch, JM.MetricsRegistry()),
                                 ("torch", tnet, DataSet, TWatch, TM.MetricsRegistry())):
        with W.RecompileWatchdog(registry=reg, window_steps=10, churn_threshold=3):
            for T in (8, 8, 6, 12):
                x = rs.randn(2, 3, T).astype(np.float32)
                y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (2, T))].transpose(0, 2, 1)
                net.fit(DS(x, y))
        counts[tag] = (_series(reg, "tdl_jit_new_signatures_total"),
                       _series(reg, "tdl_shape_churn_warnings_total"))
    assert counts["torch"] == counts["jax"]
    # T = 8, 8, 6, 12 pad to whole segments of 4: two signatures (8 and 12 steps)
    assert counts["torch"][0] == {(("fn", "MultiLayerNetwork.tbptt_step"),): 2}


def test_inactive_watchdogs_cost_nothing(monkeypatch):
    """No watchdog and no cache monitor: the fit loop computes no
    signature."""
    assert not TWatch.active()
    monkeypatch.setattr(TWatch, "signature_of",
                        lambda *a: (_ for _ in ()).throw(AssertionError("signature computed")))
    net = port_net(_jnet())
    net.fit(DataSet(*_batch(5)))
    net.fit_scan([DataSet(*_batch(5))])
    assert net.iteration == 2


def test_memory_watchdog_reads_rss_and_never_initialises_cuda():
    script = (
        "import sys\n"
        "from deeplearning4j_tpu_torch.monitoring import MetricsRegistry\n"
        "from deeplearning4j_tpu_torch.monitoring.watchdogs import DeviceMemoryWatchdog\n"
        "reg = MetricsRegistry()\n"
        "wd = DeviceMemoryWatchdog(reg, threshold_bytes=1, dump_live_buffers=True)\n"
        "a = wd.sample()\n"
        "assert list(a) == ['host'] and a['host'] > 0 and 'torch' not in sys.modules\n"
        "import torch\n"
        "x = torch.zeros(1 << 20)\n"
        "b = wd.sample()\n"
        "assert list(b) == ['host'] and not torch.cuda.is_initialized()\n"
        "rows = wd.live_buffer_summary(3)\n"
        "assert any('(1048576,) float32' in r for r in rows), rows\n"
        "snap = {m: reg.get(m).snapshot()['series'] for m in ('tdl_device_memory_bytes_in_use',\n"
        "        'tdl_device_memory_high_water_bytes',\n"
        "        'tdl_device_memory_threshold_exceeded_total')}\n"
        "assert snap['tdl_device_memory_bytes_in_use'][0]['labels'] == {'device': 'host'}\n"
        "assert snap['tdl_device_memory_high_water_bytes'][0]['value'] >= b['host']\n"
        "assert snap['tdl_device_memory_threshold_exceeded_total'][0]['value'] == 2\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip().endswith("ok"), out.stderr


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """An ``nvcc`` on this host that writes its ``-o`` target: the kernel
    build runs end to end without a CUDA toolkit (nothing is loaded)."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ \"$1\" = \"-o\" ]; then "
                    "shift; echo built > \"$1\"; fi\n  shift\ndone\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("TDL_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_reported", set())
    return tmp_path


def test_nvcc_builds_are_the_compiles_attributed_like_jax(fake_nvcc):
    """What the port counts as a compile: one per kernel library nvcc builds,
    claimed by the thread's announced signature (the second library of the
    same build has none left: ``_unattributed``, as a second XLA compile
    after one announcement is in the JAX package)."""
    reg = TM.MetricsRegistry()
    n_src = len(_build.sources())
    assert n_src == 2
    with TWatch.RecompileWatchdog(registry=reg) as wd:
        TWatch.note_signature("MultiLayerNetwork.train_step", ("sig",))
        _build.build_all()
        assert wd.stats()["compiles"] == n_src
        _build.build_all()  # found built: no compile
        assert wd.stats()["compiles"] == n_src
    compiles = _series(reg, "tdl_xla_compiles_total")
    assert compiles == {(("fn", "MultiLayerNetwork.train_step"),): 1,
                        (("fn", "_unattributed"),): 1}
    assert sum(_series(reg, "tdl_xla_compile_seconds_total").values()) > 0


def test_compile_cache_hits_and_misses_of_the_kernel_build(fake_nvcc, monkeypatch):
    """A library nvcc builds into the cache is a miss; the same library found
    built by a later process (here: the report set cleared) is a hit."""
    before = compilecache.stats()
    try:
        compile_cache.enable(str(fake_nvcc / "cache"))
        assert TWatch.active()
        TWatch.note_signature("ServingPool.replica", ("sig",))
        _build.build_all()
        first = compilecache.stats()
        monkeypatch.setattr(_build, "_reported", set())  # a second process
        TWatch.note_signature("ServingPool.replica", ("sig",))
        _build.build_all()
        second = compilecache.stats()
    finally:
        compile_cache.disable()
    assert not TWatch.active()
    delta = lambda a, b, f: {k: v - b[f].get(k, 0) for k, v in a[f].items()  # noqa: E731
                             if v - b[f].get(k, 0)}
    assert delta(first, before, "misses") == {"ServingPool.replica": 1, "_unattributed": 1}
    assert delta(second, first, "hits") == {"ServingPool.replica": 1, "_unattributed": 1}
    assert delta(second, first, "misses") == {}
    assert second["dir"] == str(fake_nvcc / "cache") and second["bytes"] > 0


def test_an_export_trace_is_a_compile(tmp_path):
    reg = TM.MetricsRegistry()
    net = port_net(_jnet())
    with TWatch.RecompileWatchdog(registry=reg) as wd:
        net.export(str(tmp_path / "m.zip"), np.zeros((2, 5), np.float32))
        assert wd.stats()["compiles"] == 1
    assert _series(reg, "tdl_xla_compiles_total") == {(("fn", "_unattributed"),): 1}


# --------------------------------------------------------------- listener


def test_metrics_listener_equals_jax():
    jnet = _jnet()
    tnet = port_net(jnet)
    regs = {"jax": JM.MetricsRegistry(), "torch": TM.MetricsRegistry()}
    jnet.add_listeners(JM.MetricsListener(regs["jax"], score_every=1))
    tnet.add_listeners(TM.MetricsListener(regs["torch"], score_every=1))
    from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator as TList

    data = [_batch(6, seed=k) for k in range(3)]
    jnet.fit(JList([JDataSet(*d) for d in data]), epochs=2)
    tnet.fit(TList([DataSet(*d) for d in data]), epochs=2)
    for fam in ("tdl_iterations_total", "tdl_epochs_total"):
        assert _series(regs["torch"], fam) == _series(regs["jax"], fam) != {}
    assert _series(regs["torch"], "tdl_iterations_total")[(("model", "MultiLayerNetwork"),)] == 6
    hist = {t: r.get("tdl_step_duration_seconds").snapshot()["series"][0]["count"]
            for t, r in regs.items()}
    assert hist["torch"] == hist["jax"] == 4  # one epoch boundary reset each
    score = lambda r: _series(r, "tdl_score")[(("model", "MultiLayerNetwork"),)]  # noqa: E731
    assert abs(score(regs["torch"]) - score(regs["jax"])) <= SCORE_ATOL


def test_listener_samples_per_sec_counts_true_examples_under_bucketing(monkeypatch):
    from deeplearning4j_tpu_torch.monitoring import listener as L

    clock = iter(range(100))
    monkeypatch.setattr(L.time, "perf_counter", lambda: float(next(clock)))
    reg = TM.MetricsRegistry()
    net = port_net(_jnet())
    from deeplearning4j_tpu_torch.common.bucketing import BucketSpec

    net.set_bucketing(BucketSpec(min_batch=8))
    net.add_listeners(TM.MetricsListener(reg))
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator

    net.fit(ListDataSetIterator([DataSet(*_batch(5)), DataSet(*_batch(3))]))
    assert net.last_batch_size == 3
    # one second between the two callbacks: 3 true examples, not 8 padded
    assert _series(reg, "tdl_samples_per_sec")[(("model", "MultiLayerNetwork"),)] == 3.0


# ------------------------------------------------------ trace hook in fit


def test_fit_records_one_step_span_per_step_only_with_a_profiler():
    net = port_net(_jnet())
    prof = TProf.OpProfiler(TProf.ProfilerConfig(trace_events=True))
    net.fit(DataSet(*_batch(4)))
    assert prof.stats() == {}
    TTrace.set_trace_profiler(prof)
    try:
        for k in range(3):
            net.fit(DataSet(*_batch(4, seed=k)))
    finally:
        TTrace.set_trace_profiler(None)
    assert prof.stats()["train"]["count"] == 3 and len(prof._events) == 3


def test_graph_hooks_note_the_jax_function_names():
    from deeplearning4j_tpu.nn import ComputationGraph as JCG
    from deeplearning4j_tpu_torch.nn import ComputationGraph as TCG

    def build(C, U):
        return (C.NeuralNetConfiguration.Builder().seed(2).updater(U.Sgd(0.1)).graph_builder()
                .add_inputs("in")
                .add_layer("d", C.DenseLayer(n_in=5, n_out=4, activation="tanh"), "in")
                .add_layer("out", C.OutputLayer(n_out=3, activation="softmax",
                                                loss="mcxent"), "d")
                .set_outputs("out").set_input_types(C.InputType.feed_forward(5)).build())
    from deeplearning4j_tpu_torch.nn import conf as TC
    from deeplearning4j_tpu_torch.nn import updaters as TU

    counts = {}
    for tag, cg, DS, W, reg in (
            ("jax", JCG(build(JC, JU)).init(), JDataSet, JWatch, JM.MetricsRegistry()),
            ("torch", TCG(build(TC, TU), device="cpu").init(), DataSet, TWatch,
             TM.MetricsRegistry())):
        with W.RecompileWatchdog(registry=reg, window_steps=5, churn_threshold=2):
            for n in (3, 4, 3):
                cg.fit(DS(*_batch(n)))
            cg.fit_scan([DS(*_batch(2, seed=k)) for k in range(2)])
        counts[tag] = (_series(reg, "tdl_jit_new_signatures_total"),
                       _series(reg, "tdl_shape_churn_warnings_total"))
    assert counts["torch"] == counts["jax"]
    assert set(counts["torch"][0]) == {(("fn", "ComputationGraph.train_step"),),
                                       (("fn", "ComputationGraph.train_scan"),)}


# ------------------------------------------------------------------ debug


def test_live_buffer_monitor_counts_live_tensors_on_the_cpu():
    """Pinned difference: the JAX package counts ``jax.live_arrays()``; the
    port reads the caching allocator on the card and, here on the CPU
    (CUDA not initialised), live tensors through the garbage collector."""
    mon = debug.LiveBufferMonitor(warn_after=4)
    x = torch.zeros(64)
    for _ in range(6):
        x = x * 2.0 + 1.0
        mon.tick()
    mon.assert_no_leak()
    hoard = []
    with pytest.warns(UserWarning, match="buffer count grew"):
        for i in range(6):
            hoard.append(torch.full((128,), float(i)))
            mon.tick()
    assert mon.leak_detected
    with pytest.raises(AssertionError, match="leak"):
        mon.assert_no_leak()
    assert mon.history[-1]["bytes"] - mon.history[-6]["bytes"] >= 5 * 128 * 4


def test_donation_guard_checks_the_in_place_promise(monkeypatch):
    """Pinned difference: JAX's guard asserts the donated buffers died; the
    port has no donation, so its guard asserts the step updated every state
    tensor in place (same tensor, same storage). The network's real step
    passes; a step that replaces its updater state fails."""
    monkeypatch.setenv("TDL_DEBUG_BUFFERS", "1")
    assert debug.buffers_debug_enabled()
    net = port_net(_jnet())
    assert net._train_step_fn() is not net._step  # the guard wraps the step
    before = {k: v.clone() for k, v in net.state_dict().items()}
    net.fit(DataSet(*_batch(4)))
    net.fit(DataSet(*_batch(4)))
    assert any(not torch.equal(before[k], v) for k, v in net.state_dict().items())

    state = {"w": torch.ones(3)}

    def good(s):
        s["w"].sub_(1.0)

    def bad(s):
        s["w"] = s["w"] - 1.0

    debug.donation_guard(good, (0,))(state)
    with pytest.raises(AssertionError, match=r"arg0\['w'\]"):
        debug.donation_guard(bad, (0,))(state)
    monkeypatch.setenv("TDL_DEBUG_BUFFERS", "0")
    plain = port_net(_jnet())
    assert plain._train_step_fn() == plain._step


def test_guarded_step_catches_a_replaced_updater_state(monkeypatch):
    monkeypatch.setenv("TDL_DEBUG_BUFFERS", "1")
    net = port_net(_jnet())
    real = net.conf.updater.apply

    def copying_apply(grads, state, params, it, ep):
        updates, new = real(grads, state, params, it, ep)
        return updates, {k: {n: t.clone() for n, t in v.items()} for k, v in new.items()}

    monkeypatch.setattr(net.conf.updater, "apply", copying_apply)
    with pytest.raises(AssertionError, match="updater_state"):
        net.fit(DataSet(*_batch(4)))


# ------------------------------------------------------------------ utils


def test_utils_equal_jax_and_crash_dump_names_torch(tmp_path):
    jnet = _jnet()
    tnet = port_net(jnet)
    got, want = TUtils.model_memory_report(tnet), JUtils.model_memory_report(jnet)
    assert got == want and got["params__bytes"] > 0
    try:
        raise RuntimeError("out of memory")
    except RuntimeError as e:
        path = TUtils.write_crash_dump(tnet, e, str(tmp_path / "crash.txt"))
    text = Path(path).read_text()
    assert text.startswith("deeplearning4j_tpu_torch crash report")
    assert f"torch: {torch.__version__}" in text and "device: cpu" in text
    assert "RuntimeError: out of memory" in text and f"total_bytes: {got['total_bytes']}" in text
    assert "jax" not in "\n".join(text.splitlines()[:4])
    assert TUtils.get_learning_rate(tnet) == JUtils.get_learning_rate(jnet) == 1e-2
    TUtils.set_learning_rate(tnet, 0.5)
    JUtils.set_learning_rate(jnet, 0.5)
    x, y = _batch(4)
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert TUtils.get_learning_rate(tnet) == 0.5
    want_p = jax.tree.map(np.asarray, jnet.params_)
    for si, k, p in tnet._param_entries():
        np.testing.assert_allclose(p.detach().numpy(), want_p[si][k], rtol=0, atol=SCORE_ATOL)


# ------------------------------------------------------------ family lint


def _declared_families() -> set:
    decl = re.compile(r'\.(?:counter|gauge|histogram)\(\s*["\'](tdl_[a-z0-9_]+)["\']')
    declared = set(TAgg.DERIVED_FAMILIES)
    for path in sorted(PORT.rglob("*.py")):
        declared.update(decl.findall(path.read_text()))
    return declared


def test_alert_rules_reference_declared_families():
    """Every ``AlertRule(...)`` in the port names, as a literal, a metric
    family that some port module declares (or a merge-time derived family):
    renaming a metric cannot silently rot the rule that watches it."""
    declared = _declared_families()
    assert len(declared) > 30
    offenders, found = [], 0
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).as_posix()
        for node in ast.walk(ast.parse(path.read_text(), filename=rel)):
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, "id", getattr(node.func, "attr", None))
                    == "AlertRule"):
                continue
            found += 1
            refs = {}
            if len(node.args) >= 2:
                refs["family"] = node.args[1]
            for kw in node.keywords:
                if kw.arg in ("family", "ratio_of"):
                    refs[kw.arg] = kw.value
            if "family" not in refs:
                offenders.append(f"{rel}:{node.lineno} (no family argument)")
                continue
            for role, val in refs.items():
                if isinstance(val, ast.Constant) and val.value is None and role == "ratio_of":
                    continue
                if not (isinstance(val, ast.Constant) and isinstance(val.value, str)):
                    offenders.append(f"{rel}:{node.lineno} ({role} is not a string literal)")
                elif val.value not in declared:
                    offenders.append(f"{rel}:{node.lineno} ({role}={val.value!r} undeclared)")
    assert found >= 5
    assert not offenders, offenders
    for fam in ("tdl_xla_compiles_total", "tdl_device_memory_bytes_in_use",
                "tdl_device_memory_limit_bytes", "tdl_slo_burn_rate"):
        assert fam in declared
