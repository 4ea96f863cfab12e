"""The port's gang supervisor, held to the JAX package's.

Mirror of ``tests/test_supervisor.py``. Two groups:

- *parity on the same inputs in both packages* (no processes): the
  postmortem helpers ``_compile_churn`` and ``_alert_intervals`` and
  ``flight.merge_events`` on the same events and spools, the ``_try_resize``
  decision table on the same ``GangEvent`` histories (JAX ``:374-:424``),
  bind-failure classification, the child env contract, the
  ``elastic_metrics`` families and the pipe preference;
- *real gloo gangs on the CPU* (workers in
  ``tests/torch_supervisor_workers.py``, started from the JAX network's
  weights): a crash restart and an elastic resize 2 → 1 whose final
  parameters equal the JAX package's one-process fit of the same toy net on
  the same global batches within ``REL``, and a repeated crash at one
  iteration classified fatal. The JAX package marks its gang runs slow (a
  JAX gang takes ~20 s); the port's take a few seconds each and run in
  tier 1, ``sup.run(timeout=120)``.

One deliberate difference, pinned here: the port runs one device per
process, so ``n_local_devices`` stays 1 (the JAX parity cases give the JAX
supervisor ``n_local_devices=1`` too) and the platform is the card unless
the caller asks for the CPU.
"""

import json
import os

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.monitoring import flight as jflight
from deeplearning4j_tpu.monitoring.flight import FlightRecorder as JFlightRecorder
from deeplearning4j_tpu.monitoring.partition import elastic_metrics as jelastic_metrics
from deeplearning4j_tpu.monitoring.registry import MetricsRegistry as JRegistry
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn.updaters import Adam
from deeplearning4j_tpu.parallel import supervisor as jsup
from deeplearning4j_tpu.parallel import launcher as jlauncher
from deeplearning4j_tpu_torch.monitoring import flight
from deeplearning4j_tpu_torch.monitoring.flight import FlightRecorder
from deeplearning4j_tpu_torch.monitoring.partition import elastic_metrics
from deeplearning4j_tpu_torch.monitoring.registry import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import GangEvent, GangFailedError, GangSupervisor
from deeplearning4j_tpu_torch.parallel import launcher
from deeplearning4j_tpu_torch.parallel import supervisor as tsup
from deeplearning4j_tpu_torch.serde.checkpoint import verify_checkpoint
from deeplearning4j_tpu_torch.serde.compiled import _flatten
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)
from torch_supervisor_workers import global_batch

WORKERS = os.path.join(os.path.dirname(__file__), "torch_supervisor_workers.py")
ENV = {"TDL_MATMUL_PRECISION": "float32", "OMP_NUM_THREADS": "1"}
# the gang's final parameters against the JAX one-process fit: float32 sums
# over two ranks in another order, through up to ten Adam steps
REL = 1e-5


# ------------------------------------------------------ postmortem helpers

def _events():
    """Flight events of several procs: compiles, alert edges (one closed by
    a clear with its duration, one by a clear without, one duplicate rise,
    one still firing) and noise."""
    return [
        {"kind": "compile", "proc": "rank0", "fn": "step", "seconds": 0.5, "t": 1.0},
        {"kind": "compile", "proc": "rank0", "fn": "step", "seconds": 0.25, "t": 2.0},
        {"kind": "compile", "proc": "rank1", "fn": "eval", "seconds": None, "t": 2.5},
        {"kind": "alert", "proc": "rank0", "rule": "p99", "severity": "warning", "t": 3.0},
        {"kind": "step_end", "proc": "rank0", "iteration": 4, "t": 3.5},
        {"kind": "alert_clear", "proc": "rank0", "rule": "p99", "duration": 1.5, "t": 4.5},
        {"kind": "alert", "proc": "rank1", "rule": "burn", "severity": "critical", "t": 5.0},
        {"kind": "alert", "proc": "rank1", "rule": "burn", "severity": "critical", "t": 6.0},
        {"kind": "alert", "proc": "rank0", "rule": "queue", "severity": "warning", "t": 6.5},
        {"kind": "alert_clear", "proc": "rank0", "rule": "queue", "t": 9.0},
        {"kind": "alert_clear", "proc": "rank1", "rule": "lonely", "t": 9.5},
        {"kind": "compile", "proc": "rank1", "fn": "eval", "seconds": 1.0, "t": 10.0},
    ]


def test_compile_churn_and_alert_intervals_match_jax():
    ev = _events()
    assert tsup._compile_churn(ev) == jsup._compile_churn(ev)
    assert tsup._compile_churn(ev)[0] == {"proc": "rank0", "fn": "step", "compiles": 2,
                                          "seconds": 0.75}
    got = tsup._alert_intervals(ev)
    assert got == jsup._alert_intervals(ev)
    assert sum(r["still_firing"] for r in got) == 2  # burn's second rise and its first
    assert {r["rule"]: r["duration"] for r in got if not r["still_firing"]} == {
        "p99": 1.5, "queue": 2.5, "lonely": None}


def test_merge_events_matches_jax_on_both_packages_spools(tmp_path):
    """Spools written by either package's recorder merge into one timeline,
    the same in both packages, with the supervisor's ring."""
    d = str(tmp_path)
    port = FlightRecorder(proc="rank0", directory=d, interval=0.0, run="r1")
    jaxr = JFlightRecorder(proc="rank1", directory=d, interval=0.0, run="r1")
    for i in range(3):
        port.record("step_begin", iteration=i)
        jaxr.record("step_begin", iteration=i)
        jaxr.record("step_end", iteration=i, loss=0.5)
    port.flush()
    jaxr.flush()
    ring = [{"kind": "gang_failure", "proc": "supervisor", "t": 0.0, "seq": 0}]
    spools = flight.read_spools(d)
    assert len(spools) == 2
    got = flight.merge_events(spools, ring)
    assert got == jflight.merge_events(jflight.read_spools(d), ring)
    assert got[0]["kind"] == "gang_failure" and len(got) == 10
    ts = [e["t"] for e in got]
    assert ts == sorted(ts)


# ------------------------------------------------------ the resize decision

def _pair(tmp_path, n, **kw):
    """The port's and the JAX package's supervisors with the same knobs."""
    kw.setdefault("elastic", True)
    kw.setdefault("max_restarts", 2)
    t = GangSupervisor("mod:fn", n_processes=n, platform="cpu",
                       workdir=str(tmp_path / "port"), registry=MetricsRegistry(), **kw)
    j = jsup.GangSupervisor("mod:fn", n_processes=n, n_local_devices=1, platform="cpu",
                            workdir=str(tmp_path / "jax"), registry=JRegistry(), **kw)
    return t, j


# (gang size, knobs, restarts at this size, [(t, reason, attempt, ranks,
# iteration)], resized, new size, suspects)
RESIZE_TABLE = {
    "consistent_culprit": (4, {}, 2, [(1.0, "crash", 0, (1, 3), 5),
                                      (2.0, "crash", 1, (3,), None),
                                      (3.0, "crash", 2, (3,), None)], True, 3, [3]),
    "bind_events_ignored": (2, {}, 2, [(0.5, "bind", 0, (0,), None),
                                       (1.0, "crash", 1, (1,), 3),
                                       (1.5, "bind", 1, (0,), None),
                                       (2.0, "crash", 2, (1,), None),
                                       (3.0, "crash", 3, (1,), None)], True, 1, [1]),
    "wandering_ranks": (2, {}, 0, [(1.0, "crash", 0, (0,), 3),
                                   (2.0, "crash", 1, (1,), 3)], False, 2, None),
    "min_processes_floor": (2, {"min_processes": 2}, 0,
                            [(1.0, "crash", 0, (1,), None)] * 3, False, 2, None),
    "not_elastic": (2, {"elastic": False}, 0, [(1.0, "crash", 0, (1,), None)] * 3,
                    False, 2, None),
    "hang_culprit_pipe": (4, {"pipe_stages": 2}, 2, [(1.0, "hang", 0, (2,), 7),
                                                     (2.0, "hang", 1, (2,), 7),
                                                     (3.0, "crash", 2, (2,), None)],
                          True, 3, [2]),
}


@pytest.mark.parametrize("case", sorted(RESIZE_TABLE))
def test_try_resize_decision_table_matches_jax(tmp_path, case):
    n, knobs, spent, history, resized, new_n, suspects = RESIZE_TABLE[case]
    t, j = _pair(tmp_path, n, **knobs)
    for sup, Event in ((t, GangEvent), (j, jsup.GangEvent)):
        sup._restarts_this_size = spent
        sup.events = [Event(*e) for e in history]
    got = t._try_resize(t.events[-1])
    assert got == j._try_resize(j.events[-1]) == resized
    assert t.n_processes == j.n_processes == new_n
    assert t.resizes == j.resizes
    assert t._events_mark == j._events_mark
    assert t._restarts_this_size == j._restarts_this_size
    if resized:
        assert t.resizes[0]["suspect_ranks"] == suspects
        snap = t.registry.get("tdl_gang_resizes_total").snapshot()
        assert [(s["labels"], s["value"]) for s in snap["series"]] == [
            ({"direction": "down"}, 1.0)]
        with open(t.postmortem_path) as f:
            pm = json.load(f)
        assert pm["classification"] == "elastic_resize" and pm["gang_size"] == new_n
        assert [e["kind"] for e in pm["events"]] == ["gang_resize"]
    else:
        assert t.resizes == []


def test_bind_failure_classification_matches_jax(tmp_path):
    """Only rank 0's stderr with a bind signature makes a ``bind``; both
    packages' supervisors and launchers agree on a signature both know."""
    class Proc:
        made = 0

        def __init__(self, rank, err):
            Proc.made += 1
            out, errp = (tmp_path / f"p{Proc.made}.rank{rank}.{x}" for x in ("out", "err"))
            out.write_text("")
            errp.write_text(err)
            self.tdl_log_paths = (str(out), str(errp))

    bind = "RuntimeError: Failed to bind address 127.0.0.1:12345"
    cases = [([Proc(0, bind), Proc(1, "")], [0], True),
             ([Proc(0, bind), Proc(1, "")], [1], False),
             ([Proc(0, "ValueError: bad batch"), Proc(1, bind)], [0, 1], False),
             ([object(), object()], [0], False)]
    t, j = _pair(tmp_path, 2)
    for procs, dead, want in cases:
        assert t._bind_failure(procs, dead) == j._bind_failure(procs, dead) == want
    for rc, rank, err in ((1, 0, bind), (0, 0, bind), (1, 1, bind), (1, 0, "boom")):
        assert (launcher.coordinator_bind_failed([launcher.WorkerResult(rank, rc, "", err)])
                == jlauncher.coordinator_bind_failed(
                    [jlauncher.WorkerResult(rank, rc, "", err)]))
    # the port's own store (torch's TCPStore) reports a lost race so
    store = "The server socket has failed to listen on any local network address"
    assert t._bind_failure([Proc(0, store), Proc(1, "")], [0])


def test_child_env_contract_matches_jax(tmp_path):
    """The same env names, and the same directories under each workdir."""
    t, j = _pair(tmp_path, 2, proc_prefix="trial3-")
    te = t._child_env(1, str(tmp_path / "port" / "hb_1"))
    je = j._child_env(1, str(tmp_path / "jax" / "hb_1"))
    assert sorted(te) == sorted(je)
    for k in te:
        if k == flight.ENV_RUN_ID:
            assert te[k] == t.run_id and je[k] == j.run_id
        else:
            assert te[k].replace("port", "@") == je[k].replace("jax", "@"), k
    assert te["TDL_GANG_RESTART_COUNT"] == "0"  # no budgeted restart yet


def test_elastic_metrics_families_match_jax():
    t, j = elastic_metrics(MetricsRegistry()), jelastic_metrics(JRegistry())
    assert sorted(vars(t)) == sorted(vars(j))
    for k in vars(t):
        a, b = getattr(t, k), getattr(j, k)
        assert (a.name, a.kind, a.label_names) == (b.name, b.kind, b.label_names)
    assert t.gang_resizes.name == "tdl_gang_resizes_total"
    assert t.gang_resizes.label_names == ("direction",)


def test_supervisor_carries_pipe_preference(tmp_path):
    sup = GangSupervisor("mod:fn", n_processes=2, pipe_stages=2, workdir=str(tmp_path))
    assert sup.pipe_stages == 2


def test_supervisor_states_one_device_per_process_and_the_card(tmp_path):
    sup = GangSupervisor("mod:fn", n_processes=2, workdir=str(tmp_path))
    assert (sup.platform, sup.n_local_devices, sup.backend) == ("cuda", 1, None)
    with pytest.raises(ValueError, match="one device per process"):
        GangSupervisor("mod:fn", n_processes=2, n_local_devices=2, workdir=str(tmp_path))


# ------------------------------------------------------------- real gangs

def _jax_toy():
    conf = (JC.NeuralNetConfiguration.Builder().seed(7).updater(Adam(1e-2)).list()
            .layer(JC.DenseLayer(n_in=6, n_out=16, activation="tanh"))
            .layer(JC.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JC.InputType.feed_forward(6)).build())
    return JMLN(conf).init()


def _jax_reference(steps):
    """The JAX package's one-process fit of the toy net on the global
    batches: {``params/<layer>/<name>``: array}."""
    net = _jax_toy()
    for step in range(steps):
        net.fit(JDataSet(*global_batch(step)))
    return {f"params/{k}/{n}": np.asarray(v) for k, d in net.params_.items()
            for n, v in d.items()}


def _supervisor(tmp_path, target, steps, every, fault_spec=None, **kw):
    d = tmp_path / "mp"
    d.mkdir()
    jnet = _jax_toy()
    state = {"params": jnet.params_, "bn": jnet.bn_state, "updater": jnet.updater_state}
    np.savez(d / "toy.npz", **{f"state/{k}": v for k, v in
                               _flatten(jax.tree.map(np.asarray, state)).items()})
    (d / "toy.json").write_text(json.dumps({"kind": "mln", "conf": jnet.conf.to_json()}))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    env = {**ENV, "TDL_MP_DIR": str(d), "TDL_MP_CKPT": str(ckpt),
           "TDL_MP_STEPS": str(steps), "TDL_MP_CKPT_EVERY": str(every)}
    if fault_spec:
        env["TDL_FAULT_SPEC"] = fault_spec
    env.update(kw.pop("env", {}))
    kw.setdefault("hang_timeout", 60.0)
    kw.setdefault("startup_grace", 120.0)
    sup = GangSupervisor(f"{WORKERS}:{target}", n_processes=2, platform="cpu",
                         extra_env=env, workdir=str(tmp_path / "gang"),
                         heartbeat_interval=0.0, backoff_base=0.1, kill_grace=1.0,
                         ckpt_dir=str(ckpt), registry=MetricsRegistry(), **kw)
    return sup, d


def _params_close(got, want):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=REL, atol=REL * np.abs(w).max(),
                                   err_msg=k)


def test_crash_restart_recovers_to_the_jax_one_process_fit(tmp_path):
    """``crash@iter=7,rank=1``: one restart classified ``crash``, the
    respawned gang restores gen-6 and finishes at the parameters of JAX's
    fault-free one-process fit."""
    steps = 10
    sup, d = _supervisor(tmp_path, "supervised_train", steps, 2, "crash@iter=7,rank=1",
                         max_restarts=3)
    results = sup.run(timeout=120.0)
    for r in results:
        assert r.returncode == 0, f"rank {r.rank} failed:\n{r.stderr[-3000:]}"
    assert sup.restarts == 1
    assert [(e.reason, e.iteration) for e in sup.events] == [("crash", 7)]
    assert 1 in sup.events[0].ranks
    reg = sup.registry
    assert reg.get("tdl_gang_restarts_total").value == 1
    assert reg.get("tdl_worker_deaths_total").labels("crash").value >= 1
    assert reg.get("tdl_gang_recovery_seconds").snapshot()["series"][0]["count"] == 1
    ranks = [dict(np.load(d / f"out.rank{r}.npz")) for r in range(2)]
    np.testing.assert_array_equal(ranks[0]["params"], ranks[1]["params"])
    assert int(ranks[0]["start"]) == 6 and int(ranks[0]["incarnation"]) == 1
    ref = _jax_toy()
    for step in range(steps):
        ref.fit(JDataSet(*global_batch(step)))
    np.testing.assert_allclose(ranks[0]["params"], np.asarray(ref.params().numpy()),
                               rtol=REL, atol=REL)
    with open(sup.postmortem_path) as f:
        pm = json.load(f)
    assert pm["classification"] == "crash" and pm["iteration"] == 7
    kinds = [e["kind"] for e in pm["events"]]
    assert "gang_failure" in kinds and "step_begin" in kinds
    assert pm["checkpoint"]["newest_committed"] == "gen-00000006"
    # a replicated network's gang save: rank 0 writes the arrays, rank 1 an
    # empty shard, and the generation verifies and restores in one process
    gen = os.path.join(sup.ckpt_dir, "latest", "gen-00000010")
    with open(os.path.join(gen, "COMMIT")) as f:
        assert json.load(f)["process_count"] == 2
    with np.load(os.path.join(gen, "shard_1.npz")) as z:
        assert z.files == ["__save_id__"]
    assert verify_checkpoint(sup.ckpt_dir)["ok"]
    assert pm["timeline"] and os.path.exists(pm["timeline"])


def test_elastic_resize_two_to_one_restores_resharded_and_finishes(tmp_path):
    """Rank 1 crashes at iteration 3, then dies at boot in every later
    incarnation: the budget of one restart runs out, the supervisor resizes
    2 → 1, and the survivor restores the fsdp=2 generation 2 with
    ``reshard=True`` and finishes at JAX's one-process parameters."""
    steps = 8
    sup, d = _supervisor(tmp_path, "elastic_train", steps, 2, "crash@iter=3,rank=1",
                         max_restarts=1, elastic=True, min_processes=1,
                         env={"TDL_MP_DEAD_RANK": "1", "TDL_MP_SURVIVORS": "1"})
    results = sup.run(timeout=120.0)
    assert len(results) == 1  # the final gang is the survivor gang
    assert results[0].returncode == 0, results[0].stderr[-3000:]
    assert sup.n_processes == 1 and len(sup.resizes) == 1
    rz = sup.resizes[0]
    assert (rz["from_processes"], rz["to_processes"], rz["suspect_ranks"]) == (2, 1, [1])
    assert rz["survivor_layout"]["axes"] == {"data": 1, "fsdp": 1, "tp": 1}
    snap = sup.registry.get("tdl_gang_resizes_total").snapshot()
    assert [(s["labels"], s["value"]) for s in snap["series"]] == [
        ({"direction": "down"}, 1.0)]
    with open(sup.postmortem_path) as f:
        pm = json.load(f)
    assert pm["classification"] == "elastic_resize"
    assert pm["resizes"] == sup.resizes and pm["gang_size"] == 1
    out = dict(np.load(d / "out.rank0.npz"))
    assert int(out["world"]) == 1 and int(out["fsdp"]) == 1
    assert int(out["start"]) == 2 and int(out["iteration"]) == steps
    _params_close(out, _jax_reference(steps))


def test_repeated_crash_at_one_iteration_is_fatal(tmp_path):
    """A deterministic fault (a crash at the same iteration in every
    incarnation) is classified fatal and raised, not retried until the
    budget is gone."""
    sup, _ = _supervisor(tmp_path, "supervised_train", 6, 2, "crash@iter=3,rank=1,every=1",
                         max_restarts=5, same_iteration_fatal=2)
    with pytest.raises(GangFailedError) as ei:
        sup.run(timeout=120.0)
    assert ei.value.classification == "repeated_crash_same_iteration"
    assert sup.restarts == 1 < sup.max_restarts  # classified, budget not exhausted
    crashes = [e for e in ei.value.events if e.reason == "crash"]
    assert len(crashes) == 2 and all(1 in e.ranks and e.iteration == 3 for e in crashes)
    assert sup.registry.get("tdl_worker_deaths_total").labels("crash").value >= 2
    with open(sup.postmortem_path) as f:
        pm = json.load(f)
    assert pm["classification"] == "repeated_crash_same_iteration"
    decisions = [e["decision"] for e in pm["events"] if e["kind"] == "restart_decision"]
    assert decisions == ["restart", "fatal"]
