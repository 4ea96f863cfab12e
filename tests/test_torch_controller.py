"""The port's deploy controller, held to the JAX package's.

Mirror of ``tests/test_controller.py``: the :class:`FleetController` watches
a checkpoint lineage and drives every newly committed generation through
integrity → eval → canary gates, promoting on sustained-clear and rolling
back on any failure. Covers the poisoned-candidate matrix (bit-flipped →
integrity, loss-spiked → eval, latency-injected → canary SLO gate, each
rejected at the EARLIEST gate that can catch it with the old fleet
untouched), the clean canary promoting through the swap, durable SIGKILL
resume to the same verdict, bounded gate timeouts, transient-error retry,
quarantine evidence, the ``to_metrics`` hook and the decision-event AST lint
(with a planted-offender self-test).

Two parity tests run both packages on the same inputs: their controllers'
integrity and eval gates on one lineage (one on-disk format) give the same
verdicts and reasons, and their paired canary windows and judgement on the
same replay rows agree. The pool's replicas are the port's numpy stubs
(``tests/torch_pool_workers.py:stub_server``).
"""

import ast
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from deeplearning4j_tpu.deploy import FleetController as JFleetController
from deeplearning4j_tpu.eval import Evaluation as JEvaluation
from deeplearning4j_tpu.eval import RegressionEvaluation as JRegressionEvaluation
from deeplearning4j_tpu.monitoring import deploy as jdeploy
from deeplearning4j_tpu.monitoring.registry import MetricsRegistry as JRegistry
from deeplearning4j_tpu_torch.deploy import GATE_CHAIN, FleetController
from deeplearning4j_tpu_torch.eval import Evaluation, RegressionEvaluation
from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
from deeplearning4j_tpu_torch.monitoring import deploy as tdeploy
from deeplearning4j_tpu_torch.monitoring.flight import EVENT_KINDS
from deeplearning4j_tpu_torch.serde.checkpoint import _array_crc, _gen_name, _self_checksummed
from deeplearning4j_tpu_torch.serving import ServingPool
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

ROOT = pathlib.Path(__file__).resolve().parent.parent
_POOL_WORKERS = str(ROOT / "tests" / "torch_pool_workers.py")
_CTRL_WORKERS = str(ROOT / "tests" / "torch_controller_workers.py")


# ------------------------------------------------------------- helpers


def _make_gen(lineage, it, corrupt=False, scale=1.0):
    """Hand-roll one COMMITTED generation in the format both packages
    write. ``scale`` multiplies the weights — a structurally perfect
    artifact with ruined numbers, the loss-spike poison's signature.
    ``corrupt`` flips a byte in the shard AFTER the commit — latent
    bit-rot."""
    gen = _gen_name(it)
    gendir = os.path.join(str(lineage), gen)
    os.makedirs(gendir)
    w = (np.linspace(-0.5, 0.5, 64).astype(np.float32) * scale)
    blob = {"__save_id__": np.asarray(it, np.int64),
            "params/0/W|0": w,
            "params/0/W|0|idx": np.asarray([[0, 64]], np.int64),
            "params/0/W|0|shape": np.asarray([64], np.int64)}
    with open(os.path.join(gendir, "shard_0.npz"), "wb") as f:
        np.savez(f, **blob)
    manifest = _self_checksummed({
        "save_id": it, "proc": 0, "shard": "shard_0.npz",
        "process_count": 1, "layout": None,
        "entries": {k: _array_crc(v) for k, v in blob.items()},
        "nbytes": 0})
    with open(os.path.join(gendir, "manifest_0.json"), "w") as f:
        f.write(json.dumps(manifest))
    with open(os.path.join(gendir, "train_state.json"), "w") as f:
        f.write(json.dumps(_self_checksummed(
            {"iteration": it, "epoch": 0, "score": None,
             "process_count": 1, "generation": gen})))
    with open(os.path.join(gendir, "COMMIT"), "w") as f:
        f.write("{}")
    with open(os.path.join(str(lineage), "LATEST"), "w") as f:
        f.write(gen + "\n")
    if corrupt:
        shard = os.path.join(gendir, "shard_0.npz")
        raw = open(shard, "rb").read()
        off = raw.index(w.tobytes()) + 8
        with open(shard, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
    return gendir


def _weight_eval(gendir):
    """Weight-reading eval stub: a loss-spiked generation's blown-up
    parameters score near zero, a healthy one near 0.9."""
    with np.load(os.path.join(gendir, "shard_0.npz")) as z:
        w = z["params/0/W|0"]
    return {"accuracy": 0.9 if float(np.abs(w).mean()) < 1.0 else 0.1}


def _counter_values(reg, name):
    m = reg.get(name)
    if m is None:
        return {}
    return {tuple(s["labels"].values()): s["value"]
            for s in m.snapshot()["series"]}


def _controller(tmp_path, cls=FleetController, **kw):
    kw.setdefault("workdir", str(tmp_path / "deploy"))
    kw.setdefault("eval_fn", _weight_eval)
    kw.setdefault("eval_thresholds", {"accuracy": 0.8})
    kw.setdefault("retries", 0)
    kw.setdefault("retry_backoff_s", 0.05)
    kw.setdefault("registry", MetricsRegistry() if cls is FleetController else JRegistry())
    return cls(str(tmp_path / "ck"), **kw)


@pytest.fixture
def lineage(tmp_path):
    d = tmp_path / "ck" / "latest"
    d.mkdir(parents=True)
    return d


# ------------------------------------------- gate chain without a pool


def test_healthy_candidate_promotes_and_survives_restart(tmp_path, lineage):
    """A committed healthy generation walks integrity → eval and promotes
    (no pool: promotion moves the durable baseline); a second controller on
    the same workdir re-derives nothing — terminal verdicts are durable."""
    _make_gen(lineage, 2)
    c = _controller(tmp_path)
    try:
        out = c.run_once()
        assert [e["status"] for e in out] == ["promoted"]
        assert c.state["promoted"]["generation"] == _gen_name(2)
        assert c.state["promoted"]["metrics"]["accuracy"] == 0.9
        kinds = [e["kind"] for e in c._own_recorder.events()]
        assert kinds == ["deploy_candidate", "deploy_gate", "deploy_gate",
                         "deploy_promote"]
        reg = c.registry
        assert _counter_values(reg, "tdl_deploy_promotions_total") == {(): 1}
        assert reg.get("tdl_deploy_promoted_generation").value == 2.0
        audit = json.load(open(c.audit_path))
        assert audit["promoted"]["generation"] == _gen_name(2)
        gates = [v["gate"] for v in audit["candidates"][0]["verdicts"]]
        assert gates == ["integrity", "eval"]
        assert audit["timeline"] and os.path.exists(audit["timeline"])
    finally:
        c.close()

    c2 = _controller(tmp_path, registry=MetricsRegistry())
    try:
        assert c2.run_once() == []  # nothing new, nothing re-judged
        assert c2.state["promoted"]["generation"] == _gen_name(2)
    finally:
        c2.close()


def test_bit_flipped_candidate_rejected_at_integrity_gate(tmp_path, lineage):
    """Poison matrix 1: a bit-flipped generation dies at the FIRST gate —
    integrity — for the price of a read. The eval gate never runs on it,
    the promoted baseline is untouched, and the audit names the evidence."""
    _make_gen(lineage, 2)
    _make_gen(lineage, 4, corrupt=True)
    seen = []
    c = _controller(tmp_path, eval_fn=lambda d: seen.append(d) or _weight_eval(d))
    try:
        c.run_once()
        cand = c.state["candidates"][_gen_name(4)]
        assert cand["status"] == "rejected"
        assert cand["rejected_by"] == {"gate": "integrity", "reason": "shard_crc"}
        assert [v["gate"] for v in cand["verdicts"]] == ["integrity"]
        assert seen == [c.state["candidates"][_gen_name(2)]["dir"]]
        assert c.state["promoted"]["generation"] == _gen_name(2)
        rb = [e for e in c._own_recorder.events() if e["kind"] == "deploy_rollback"]
        assert len(rb) == 1 and rb[0]["gate"] == "integrity"
        assert rb[0]["reason"] == "shard_crc"
        assert _counter_values(c.registry, "tdl_deploy_rollbacks_total") == {("integrity",): 1}
        audit = json.load(open(c.audit_path))
        bad = [x for x in audit["candidates"] if x["generation"] == _gen_name(4)][0]
        assert bad["verdicts"][0]["evidence"]["verify"]["reason"] == "shard_crc"
    finally:
        c.close()


def test_loss_spiked_candidate_rejected_at_eval_gate(tmp_path, lineage):
    """Poison matrix 2: a loss-spiked generation is structurally PERFECT —
    integrity passes — and only the offline eval gate can reject it
    (threshold floor AND regression band vs the promoted baseline). The
    judged numbers land on /metrics under the model label."""
    _make_gen(lineage, 2)
    _make_gen(lineage, 4, scale=40.0)
    c = _controller(tmp_path, regression_band=0.05)
    try:
        c.run_once()
        cand = c.state["candidates"][_gen_name(4)]
        assert cand["status"] == "rejected"
        assert cand["rejected_by"]["gate"] == "eval"
        assert "accuracy" in cand["rejected_by"]["reason"]
        assert [(v["gate"], v["ok"]) for v in cand["verdicts"]] == \
            [("integrity", True), ("eval", False)]
        assert c.state["promoted"]["generation"] == _gen_name(2)
        ev = cand["verdicts"][1]["evidence"]
        assert ev["metrics"]["accuracy"] == 0.1
        assert ev["baseline"]["accuracy"] == 0.9
        acc = _counter_values(c.registry, "tdl_eval_accuracy")
        assert acc == {(_gen_name(2),): 0.9, (_gen_name(4),): 0.1}
    finally:
        c.close()


def test_quarantined_candidate_honors_the_evidence(tmp_path, lineage):
    """A generation the restore side already quarantined (renamed
    ``*.corrupt``) fails integrity with reason=quarantined."""
    gendir = _make_gen(lineage, 4)
    c = _controller(tmp_path)
    try:
        os.rename(gendir, gendir + ".corrupt-shard_crc")
        entry = {"generation": _gen_name(4), "iteration": 4, "dir": gendir, "verdicts": []}
        v = c._gate_integrity(entry, {"dir": str(lineage),
                                      "quarantined": [_gen_name(4) + ".corrupt-shard_crc"]})
        assert not v["ok"] and v["reason"] == "quarantined"
        assert v["evidence"]["quarantined"] == [_gen_name(4) + ".corrupt-shard_crc"]
    finally:
        c.close()


def test_wedged_gate_times_out_into_rollback(tmp_path, lineage):
    """A gate that never returns hits ``gate_timeout_s`` and becomes a
    failing verdict (reason=timeout): the controller never hangs."""
    _make_gen(lineage, 2)
    c = _controller(tmp_path, eval_fn=lambda d: time.sleep(60), gate_timeout_s=0.4)
    try:
        c.run_once()
        cand = c.state["candidates"][_gen_name(2)]
        assert cand["status"] == "rejected"
        assert cand["rejected_by"] == {"gate": "eval", "reason": "timeout"}
    finally:
        c.close()


def test_transient_gate_errors_retry_before_counting(tmp_path, lineage):
    """Exceptions escaping a gate fn are retried with backoff: two flaky
    failures then success promotes; with retries exhausted the error
    becomes the verdict."""
    _make_gen(lineage, 2)
    calls = []

    def flaky(gendir):
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient fs hiccup")
        return _weight_eval(gendir)

    c = _controller(tmp_path, eval_fn=flaky, retries=2)
    try:
        c.run_once()
        cand = c.state["candidates"][_gen_name(2)]
        assert cand["status"] == "promoted" and len(calls) == 3
        ev = [v for v in cand["verdicts"] if v["gate"] == "eval"][0]
        assert ev["evidence"]["retries"] == 2
    finally:
        c.close()

    def always(gendir):
        raise OSError("disk on fire")

    _make_gen(lineage, 4)
    c2 = _controller(tmp_path, workdir=str(tmp_path / "deploy2"), eval_fn=always, retries=1)
    try:
        c2.run_once()
        cand = c2.state["candidates"][_gen_name(4)]
        assert cand["status"] == "rejected"
        assert cand["rejected_by"] == {"gate": "eval", "reason": "error:OSError"}
        assert cand["verdicts"][-1]["evidence"]["attempts"] == 2
    finally:
        c2.close()


def test_both_packages_gate_the_same_lineage_alike(tmp_path, lineage):
    """The port's and the JAX package's controllers, integrity and eval
    gates, on one lineage: a healthy, a bit-flipped, a loss-spiked and a
    second healthy generation get the same verdicts, reasons and metrics,
    and the same one is promoted."""
    _make_gen(lineage, 2)
    _make_gen(lineage, 4, corrupt=True)
    _make_gen(lineage, 6, scale=40.0)
    _make_gen(lineage, 8)
    runs = {}
    for name, cls in (("port", FleetController), ("jax", JFleetController)):
        c = _controller(tmp_path, cls=cls, workdir=str(tmp_path / name),
                        regression_band=0.05)
        try:
            c.run_once()
            runs[name] = c.state
        finally:
            c.close()

    def verdicts(state):
        return {g: (e["status"], e.get("rejected_by"),
                    [(v["gate"], v["ok"], v["reason"],
                      v["evidence"].get("metrics"),
                      (v["evidence"].get("verify") or {}).get("reason"))
                     for v in e["verdicts"]])
                for g, e in state["candidates"].items()}

    assert verdicts(runs["port"]) == verdicts(runs["jax"])
    assert runs["port"]["promoted"]["generation"] == runs["jax"]["promoted"]["generation"] \
        == _gen_name(8)
    assert {g: e["status"] for g, e in runs["port"]["candidates"].items()} == {
        _gen_name(2): "promoted", _gen_name(4): "rejected", _gen_name(6): "rejected",
        _gen_name(8): "promoted"}


# --------------------------------------------------- SIGKILL → resume


def test_sigkilled_controller_resumes_to_same_verdict(tmp_path, lineage):
    """A controller SIGKILLed mid-gate restarts on the same workdir and
    reaches the same terminal verdict: the integrity PASS recorded before
    the kill is durable and NOT re-run; the candidate resumes at the gate
    it died in."""
    _make_gen(lineage, 4)
    cfg = {"ckpt_dir": str(tmp_path / "ck"),
           "workdir": str(tmp_path / "deploy"),
           "gates": ["integrity", "eval"],
           "eval_target": f"{_CTRL_WORKERS}:eval_sleepy",
           "eval_thresholds": {"accuracy": 0.8},
           "retries": 0}
    cfg_path = tmp_path / "controller.json"
    cfg_path.write_text(json.dumps(cfg))
    env = dict(os.environ, TDL_EVAL_SLEEP="120", TDL_EVAL_ACC="0.9",
               PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.deploy.controller",
           str(cfg_path), "--once"]
    p1 = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    state_path = tmp_path / "deploy" / "controller_state.json"
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                st = json.loads(state_path.read_text())
                cand = st["candidates"][_gen_name(4)]
                if cand["status"] == "in_gate" and cand["gate"] == "eval":
                    break  # integrity verdict durable, eval gate entered
            except (OSError, ValueError, KeyError):
                pass
            time.sleep(0.05)
        else:
            pytest.fail("controller never reached the eval gate")
        assert [v["gate"] for v in cand["verdicts"]] == ["integrity"]
    finally:
        p1.send_signal(signal.SIGKILL)
        p1.communicate(timeout=30)

    env2 = dict(os.environ, TDL_EVAL_ACC="0.9", PYTHONPATH=str(ROOT))
    p2 = subprocess.run(cmd, env=env2, capture_output=True, text=True, timeout=120)
    assert p2.returncode == 0, p2.stderr[-3000:]
    summary = json.loads(p2.stdout.strip().splitlines()[-1])
    assert summary["candidates"] == {_gen_name(4): "promoted"}
    st = json.loads(state_path.read_text())
    cand = st["candidates"][_gen_name(4)]
    assert cand["resumed"] is True  # the audit says this verdict survived a death
    assert [v["gate"] for v in cand["verdicts"]] == ["integrity", "eval"]
    audit = json.loads((tmp_path / "deploy" / "audit.json").read_text())
    assert audit["promoted"]["generation"] == _gen_name(4)


# ------------------------------------------------------- canary gates


def _stub_pool(tmp_path, reg, **kw):
    kw.setdefault("replicas", 1)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    return ServingPool(f"{_POOL_WORKERS}:stub_server", workdir=str(tmp_path / "pool"),
                       registry=reg, **kw)


def test_canary_gate_rejects_latency_injected_candidate(tmp_path, lineage):
    """Poison matrix 3: a candidate that only misbehaves under LIVE traffic
    (latency injected into inference whenever TDL_MODEL_CKPT names it)
    passes integrity and eval, and is caught by the canary SLO gate. The
    canary was router-invisible throughout and the old fleet still
    serves."""
    from deeplearning4j_tpu_torch.serving.loadgen import TraceSpec

    gendir = _make_gen(lineage, 4)
    reg = MetricsRegistry()
    pool = _stub_pool(tmp_path, reg, extra_env={
        "TDL_FAULT_SPEC": f"latency_inject@value=0.25,model={_gen_name(4)}"}).start()
    c = None
    try:
        assert pool.wait_ready(60.0)
        c = _controller(tmp_path, pool=pool, registry=reg,
                        trace=TraceSpec(duration_s=1.5, base_rate=24.0, seed=18),
                        slo_threshold_ms=120.0, burn_window_s=0.5,
                        canary_ready_timeout=60.0)
        assert c.gates == GATE_CHAIN
        c.run_once()
        cand = c.state["candidates"][_gen_name(4)]
        assert cand["status"] == "rejected", cand
        assert cand["rejected_by"]["gate"] == "canary"
        assert cand["rejected_by"]["reason"].startswith("slo:")
        assert [(v["gate"], v["ok"]) for v in cand["verdicts"]] == \
            [("integrity", True), ("eval", True), ("canary", False)]
        fired = [v for v in cand["verdicts"]
                 if v["gate"] == "canary"][0]["evidence"]["fired"]
        assert fired and all(f["rule"].startswith("canary_") for f in fired)
        rows = pool.describe()["replicas"]
        assert all(not r["canary"] for r in rows)
        assert all(r["model"] is None for r in rows)  # never swapped
        assert pool.wait_ready(30.0)
        assert _counter_values(reg, "tdl_deploy_rollbacks_total") == {("canary",): 1}
        assert gendir in json.load(open(c.audit_path))["candidates"][0]["dir"]
    finally:
        if c is not None:
            c.close()
        pool.stop()


def test_clean_canary_promotes_and_completes_the_swap(tmp_path, lineage):
    """The promote leg: a healthy candidate clears the canary window — the
    router never sent the canary live traffic — and the controller
    completes the rolling swap: every replica (and the pool's default
    overrides, so future scale-ups too) carries the promoted generation."""
    from deeplearning4j_tpu_torch.serving.loadgen import TraceSpec

    gendir = _make_gen(lineage, 6)
    reg = MetricsRegistry()
    pool = _stub_pool(tmp_path, reg).start()
    c = None
    try:
        assert pool.wait_ready(60.0)
        seen = []
        start = pool.start_canary

        def spy(*a, **k):
            h = start(*a, **k)
            seen.append([r for r in pool.describe()["replicas"] if r["canary"]])
            picked = pool._pick_replica(exclude=())  # the router's choice
            assert picked is not None and picked is not h and not picked.canary
            with pool._lock:
                picked.inflight -= 1
            return h

        pool.start_canary = spy
        c = _controller(tmp_path, pool=pool, registry=reg,
                        trace=TraceSpec(duration_s=1.5, base_rate=30.0, seed=18),
                        slo_threshold_ms=1000.0, burn_window_s=0.5)
        c.run_once()
        cand = c.state["candidates"][_gen_name(6)]
        assert cand["status"] == "promoted", cand
        assert [(v["gate"], v["ok"]) for v in cand["verdicts"]] == [
            ("integrity", True), ("eval", True), ("canary", True), ("promote", True)]
        assert len(seen) == 1 and len(seen[0]) == 1 and seen[0][0]["model"] == gendir
        assert c.state["promoted"]["generation"] == _gen_name(6)
        rows = pool.describe()["replicas"]
        assert rows and all(r["model"] == gendir for r in rows)
        assert all(not r["canary"] for r in rows)
        assert reg.get("tdl_deploy_promoted_generation").value == 6.0
        assert reg.get("tdl_deploy_canary_availability") is not None
    finally:
        if c is not None:
            c.close()
        pool.stop()


def test_paired_canary_judgement_matches_jax():
    """``paired_canary_windows`` and ``judge_canary_windows`` of both
    packages on the same replay rows: a baseline arm, and a candidate arm
    slow and shedding from the second second on."""
    rs = np.random.RandomState(3)
    base, cand = [], []
    for i in range(120):
        t = i * 0.025
        base.append({"t": t, "outcome": "200", "latency_ms": float(20 + rs.rand() * 10)})
        slow = t >= 1.0
        cand.append({"t": t, "outcome": "503" if slow and i % 5 == 0 else "200",
                     "latency_ms": float((400 if slow else 20) + rs.rand() * 10)})
    kw = dict(duration_s=3.0, window_s=0.5, threshold_ms=120.0, target=0.99)
    tw = tdeploy.paired_canary_windows(base, cand, **kw)
    assert tw == jdeploy.paired_canary_windows(base, cand, **kw)
    rules = tdeploy.canary_rules()
    assert [r.name for r in rules] == [r.name for r in jdeploy.canary_rules()]
    got = tdeploy.judge_canary_windows(tw, rules, registry=MetricsRegistry())
    want = jdeploy.judge_canary_windows(tw, jdeploy.canary_rules(), registry=JRegistry())
    assert got == want
    assert not got["ok"] and got["judged"] == 6
    assert {f["rule"] for f in got["fired"]} == {
        "canary_latency_regression", "canary_availability_low", "canary_burn_excess"}
    assert tdeploy.judge_canary_windows(tdeploy.paired_canary_windows(
        base, base, **kw), rules, registry=MetricsRegistry())["ok"]
    assert sorted(vars(tdeploy.deploy_metrics(MetricsRegistry()))) == sorted(
        vars(jdeploy.deploy_metrics(JRegistry())))


# ------------------------------------------- satellites: eval metrics


def test_evaluation_to_metrics_sets_model_gauges_as_jax_does():
    """``Evaluation.to_metrics`` returns the judged numbers AND lands them
    on the registry under the model label, the same numbers as the JAX
    package's."""
    reg = MetricsRegistry()
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    p = np.eye(3, dtype=np.float32)[[0, 1, 2, 1]]  # 3/4 right
    ev, jev = Evaluation(), JEvaluation()
    ev.eval(y, p)
    jev.eval(y, p)
    m = ev.to_metrics(reg, model="gen-x")
    assert m == jev.to_metrics(JRegistry(), model="gen-x")
    assert m["accuracy"] == pytest.approx(0.75) and m["score"] == pytest.approx(0.75)
    assert 0.0 < m["f1"] <= 1.0
    assert _counter_values(reg, "tdl_eval_accuracy") == {("gen-x",): pytest.approx(0.75)}
    assert ("gen-x",) in _counter_values(reg, "tdl_eval_f1")

    yr, pr = np.asarray([[1.0], [2.0], [3.0]]), np.asarray([[1.1], [1.9], [3.2]])
    rev, jrev = RegressionEvaluation(), JRegressionEvaluation()
    rev.eval(yr, pr)
    jrev.eval(yr, pr)
    rm = rev.to_metrics(reg, model="gen-r")
    assert rm == jrev.to_metrics(JRegistry(), model="gen-r")
    assert rm["score"] == pytest.approx(rev.r_squared(0))
    assert ("gen-r",) in _counter_values(reg, "tdl_eval_score")
    assert ("gen-r",) not in _counter_values(reg, "tdl_eval_accuracy")


# ---------------------------------------------------- decision lint


#: every decision method and the flight event it must record before any
#: non-delegated return path
_DECISION_EVENTS = {"_announce_candidate": "deploy_candidate",
                    "_record_verdict": "deploy_gate",
                    "_promote": "deploy_promote",
                    "_rollback": "deploy_rollback"}


def _record_kind_literals(node):
    out = []
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "record"
                and sub.args
                and isinstance(sub.args[0], ast.Constant)
                and isinstance(sub.args[0].value, str)):
            out.append((sub.args[0].value, sub.lineno))
    return out


def _unflighted_decision_paths(tree):
    """Paths in controller decision methods that could complete without the
    decision's flight event: [(method, lineno, why)]. A return that
    DELEGATES to another decision method is flighted transitively."""
    offenders = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.FunctionDef) and node.name in _DECISION_EVENTS):
            continue
        want = _DECISION_EVENTS[node.name]
        record_lines = [ln for kind, ln in _record_kind_literals(node) if kind == want]
        if not record_lines:
            offenders.append((node.name, node.lineno, f"never records {want!r}"))
            continue
        first = min(record_lines)
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Return) or sub.lineno >= first:
                continue
            v = sub.value
            if (isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
                    and v.func.attr in _DECISION_EVENTS):
                continue
            offenders.append((node.name, sub.lineno, f"returns before recording {want!r}"))
    return offenders


def test_controller_decisions_are_flighted():
    """Every promote / rollback / gate-verdict / candidate decision path in
    the port's controller records its flight event (from the declared kind
    set) before returning."""
    src = ROOT / "deeplearning4j_tpu_torch" / "deploy" / "controller.py"
    tree = ast.parse(src.read_text(), filename=str(src))
    assert _unflighted_decision_paths(tree) == []
    for kind, _ in _record_kind_literals(tree):
        assert kind in EVENT_KINDS, kind
    found = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    assert set(_DECISION_EVENTS) <= found  # the lint actually saw them


def test_decision_lint_catches_a_planted_offender():
    """The lint must bite: a decision method with an early bare return (or
    no record at all) is flagged; the delegated-return idiom passes."""
    planted = ast.parse(
        "class X:\n"
        "    def _promote(self, entry):\n"
        "        if entry is None:\n"
        "            return None\n"
        "        flight.record('deploy_promote', generation='g')\n"
        "        return entry\n"
        "    def _rollback(self, entry, verdict):\n"
        "        return None\n"
        "    def _record_verdict(self, entry, verdict):\n"
        "        if verdict is None:\n"
        "            return self._rollback(entry, verdict)\n"
        "        flight.record('deploy_gate', gate='eval')\n"
        "        return verdict\n")
    bad = _unflighted_decision_paths(planted)
    assert [(m, why.split(" ")[0]) for m, _, why in bad] == [
        ("_promote", "returns"), ("_rollback", "never")]
