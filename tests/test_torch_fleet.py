"""The port's trial fleet (``deeplearning4j_tpu_torch.arbiter.fleet``,
``trial_worker``, ``monitoring.trial``, the ``trial_clone`` fault site) on
the CPU: the JAX package's in-process fleet tests run on the port, the port
held to the JAX package's fleet, and real trial gangs.

- The scheduler, resume, clone paths, spool reader, trial metrics, the
  decision lint (over the port's ``fleet.py``) and the event kinds, as
  ``tests/test_fleet.py`` drives them, with in-process runners.
- Parity: the JAX package's ``TrialFleet`` and the port's, driven by the same
  pure runner on lineages each seeded by its own package's checkpointer, give
  equal journals with timestamps dropped (in order at ``max_concurrent=1``,
  per rung as sets at 3): populations, verdicts, perturbed hyperparameters,
  clone outcomes, statuses and the winner. A lineage the JAX package wrote,
  cloned by the port's fleet, restores bit for bit.
- ``SynthClassifyTask``: its batches and evaluation split are the JAX
  package's bit for bit, and 4 steps from carried weights agree within 1e-5
  (absolute, parameters and losses; float32 on both sides).
- One real-gang sweep on the CPU through ``GangTrialRunner(platform="cpu")``;
  the chaos sweep and the SIGKILLed CLI are marked slow, as the JAX
  package's are.
"""

import json
import math
import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import arbiter as J
from deeplearning4j_tpu.arbiter import trial_worker as JW
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.monitoring.registry import MetricsRegistry as JRegistry
from deeplearning4j_tpu.serde.checkpoint import TrainingCheckpointer as JCheckpointer
from deeplearning4j_tpu_torch.arbiter import (ContinuousParameterSpace, DiscreteParameterSpace,
                                              GangTrialRunner, GridSearchCandidateGenerator,
                                              IntegerParameterSpace, RandomSearchGenerator,
                                              TrialFleet, TrialStraggler, spooled_scores)
from deeplearning4j_tpu_torch.arbiter import fleet as fleet_mod
from deeplearning4j_tpu_torch.arbiter import trial_worker as TW
from deeplearning4j_tpu_torch.common import faults
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.monitoring import flight
from deeplearning4j_tpu_torch.monitoring.registry import MetricsRegistry
from deeplearning4j_tpu_torch.monitoring.trial import (TRIAL_STATES, set_trial_state,
                                                       trial_metrics)
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import DenseLayer, InputType, OutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.serde.checkpoint import (CheckpointVerifyError,
                                                       TrainingCheckpointer, clone_generation,
                                                       lineage_state)
from test_fleet import _DECISION_EVENTS, _unflighted_decision_paths
from torch_mln_helpers import port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

ROOT = pathlib.Path(__file__).resolve().parent.parent

SPACES = {"lr": ContinuousParameterSpace(1e-4, 1e-1, log_scale=True),
          "hidden": IntegerParameterSpace(4, 32)}

TASK_ATOL = 1e-5  # SynthClassifyTask: parameters and losses after 4 steps, absolute


def _score_runner(fn):
    def runner(slot, target_iter, timeout_s):
        return fn(slot.hparams, target_iter)

    return runner


def _lr_score(hp, target):
    base = 1.0 - abs(math.log10(hp["lr"]) + 2.0) / 4.0
    return base * (1.0 - 1.0 / (2.0 + target))


def _fleet(tmp_path, runner, *, name="f", reg=None, **kw):
    kw.setdefault("n_trials", 6)
    kw.setdefault("rungs", (2, 4, 8))
    kw.setdefault("seed", 5)
    kw.setdefault("rung_timeout_s", 30.0)
    kw.setdefault("max_concurrent", 3)
    gen = kw.pop("generator", None) or RandomSearchGenerator(SPACES, seed=3)
    return TrialFleet(gen, runner, workdir=str(tmp_path / name),
                      registry=reg or MetricsRegistry(), **kw)


def _fleet_events(fleet):
    return [e for s in flight.read_spools(fleet.flight_dir) for e in s.get("events", [])]


class TestFleetScheduler:
    def test_sweep_promotes_a_winner_with_audited_rungs(self, tmp_path):
        reg = MetricsRegistry()
        fleet = _fleet(tmp_path, _score_runner(_lr_score), reg=reg)
        try:
            winner = fleet.run()
        finally:
            fleet.close()
        assert fleet.trials[winner["trial"]].status == "winner"
        verdicts = fleet.state["verdicts"]
        assert set(verdicts) == {"0", "1", "2"}
        assert len(verdicts["0"]["promoted"]) == 3
        assert len(verdicts["1"]["promoted"]) == 2
        kinds = {e["kind"] for e in _fleet_events(fleet)}
        assert {"trial_spawn", "trial_demote", "trial_rung_promote", "trial_promote"} <= kinds
        snap = reg.snapshot()
        winners = [s for s in snap["tdl_trial_state"]["series"]
                   if s["labels"]["state"] == "winner" and s["value"] == 1.0]
        assert len(winners) == 1
        assert snap["tdl_trial_rung_promotions_total"]["series"][0]["value"] >= 3
        assert snap["tdl_fleet_disk_bytes"]["series"][0]["value"] > 0

    def test_run_is_reentrant_after_completion(self, tmp_path):
        fleet = _fleet(tmp_path, _score_runner(_lr_score))
        try:
            first = fleet.run()
            assert fleet.run() == first
        finally:
            fleet.close()

    def test_crashing_trial_is_quarantined_and_sweep_survives(self, tmp_path):
        reg = MetricsRegistry()
        calls = {}

        def runner(slot, target, timeout_s):
            calls[slot.trial_id] = calls.get(slot.trial_id, 0) + 1
            if slot.trial_id == "t00":
                raise RuntimeError("boom (injected)")
            return _lr_score(slot.hparams, target)

        fleet = _fleet(tmp_path, runner, reg=reg, trial_max_restarts=2,
                       backoff_base_s=0.01, backoff_max_s=0.02)
        try:
            winner = fleet.run()
        finally:
            fleet.close()
        assert winner["trial"] != "t00"
        t0 = fleet.trials["t00"]
        assert (t0.status, t0.quarantine_reason) == ("quarantined", "crash_budget")
        assert calls["t00"] == 3
        ev = [e for e in _fleet_events(fleet) if e["kind"] == "trial_quarantine"]
        assert ev and ev[0]["trial"] == "t00" and ev[0]["reason"] == "crash_budget"
        series = reg.snapshot()["tdl_trial_quarantined_total"]["series"]
        assert {(s["labels"]["reason"], s["value"]) for s in series} == {("crash_budget", 1.0)}

    @pytest.mark.parametrize("kind", ["hang", "timeout", "straggler"])
    def test_classified_failures(self, tmp_path, kind):
        """A gang that died hanging quarantines as ``wedged``; a timeout or a
        straggler demotes without burning a restart."""
        class Failure(RuntimeError):
            classification = kind

        def runner(slot, target, timeout_s):
            if slot.trial_id == "t01":
                raise TrialStraggler("over rung deadline") if kind == "straggler" \
                    else Failure(kind)
            return _lr_score(slot.hparams, target)

        fleet = _fleet(tmp_path, runner, trial_max_restarts=1, backoff_base_s=0.01,
                       backoff_max_s=0.02)
        try:
            winner = fleet.run()
        finally:
            fleet.close()
        t1 = fleet.trials["t01"]
        assert winner["trial"] != "t01"
        if kind == "hang":
            assert (t1.status, t1.quarantine_reason) == ("quarantined", "wedged")
        else:
            assert (t1.status, t1.restarts) == ("demoted", 0)
            demotes = [r for r in fleet.state["journal"]
                       if r["kind"] == "demote" and r["trial"] == "t01"]
            assert demotes[0]["reason"] == "straggler"

    def test_rung_deadline_demotes_inline_sleeper(self, tmp_path):
        def runner(slot, target, timeout_s):
            if slot.trial_id == "t00":
                time.sleep(0.4)
                raise RuntimeError("crashed after eating the rung budget")
            return _lr_score(slot.hparams, target)

        fleet = _fleet(tmp_path, runner, rung_timeout_s=0.2, trial_max_restarts=5,
                       backoff_base_s=0.01)
        try:
            fleet.run()
        finally:
            fleet.close()
        assert fleet.trials["t00"].status == "demoted"

    def test_all_trials_dead_raises_not_invents_winner(self, tmp_path):
        def runner(slot, target, timeout_s):
            raise RuntimeError("everything burns")

        fleet = _fleet(tmp_path, runner, n_trials=3, trial_max_restarts=0, backoff_base_s=0.01)
        try:
            with pytest.raises(RuntimeError, match="no surviving"):
                fleet.run()
        finally:
            fleet.close()

    def test_generator_exhaustion_shrinks_sweep(self, tmp_path):
        gen = GridSearchCandidateGenerator({"lr": DiscreteParameterSpace(1e-3, 1e-2),
                                            "hidden": DiscreteParameterSpace(8, 16)})
        fleet = _fleet(tmp_path, _score_runner(_lr_score), generator=gen, n_trials=16)
        try:
            fleet.run()
        finally:
            fleet.close()
        assert len(fleet.trials) == 4

    def test_rungs_must_increase(self, tmp_path):
        with pytest.raises(ValueError, match="strictly increasing"):
            _fleet(tmp_path, _score_runner(_lr_score), rungs=(4, 2))


class TestFleetResume:
    def test_killed_mid_rung_resumes_to_identical_verdicts(self, tmp_path):
        class KilledMidRung(BaseException):
            """Out-of-band death: not an Exception, so no retry path."""

        run_counts = {}

        def make_runner(kill_at=None):
            def runner(slot, target, timeout_s):
                key = (slot.trial_id, target)
                run_counts[key] = run_counts.get(key, 0) + 1
                if kill_at == key:
                    raise KilledMidRung()
                return _lr_score(slot.hparams, target)

            return runner

        ref = _fleet(tmp_path, make_runner(), name="ref")
        try:
            ref.run()
        finally:
            ref.close()
        ref_scored = dict(run_counts)
        run_counts.clear()
        fleet = _fleet(tmp_path, make_runner(kill_at=("t01", 4)), name="killed",
                       max_concurrent=1)
        with pytest.raises(KilledMidRung):
            fleet.run()
        fleet.close()
        pre_crash = {k for k, v in run_counts.items() if v}
        run_counts.clear()
        resumed = _fleet(tmp_path, make_runner(), name="killed")
        assert resumed.state["resumed"]
        try:
            winner = resumed.run()
        finally:
            resumed.close()
        assert resumed.state["verdicts"] == ref.state["verdicts"]
        assert winner["trial"] == ref.state["winner"]["trial"]
        assert winner["score"] == ref.state["winner"]["score"]
        for tid, ref_slot in ref.trials.items():
            assert resumed.trials[tid].scores == ref_slot.scores
        rerun = [k for k, v in run_counts.items() if k in pre_crash and k != ("t01", 4)]
        assert not rerun, f"resume re-ran journaled trials: {rerun}"
        assert pre_crash | set(run_counts) == set(ref_scored)

    def test_resume_skips_completed_rungs_entirely(self, tmp_path):
        fleet = _fleet(tmp_path, _score_runner(_lr_score), name="done")
        try:
            fleet.run()
        finally:
            fleet.close()

        def exploding(slot, target, timeout_s):
            raise AssertionError("a finished sweep must not run trials")

        again = _fleet(tmp_path, exploding, name="done")
        try:
            assert again.run()["trial"] == fleet.state["winner"]["trial"]
        finally:
            again.close()


# ------------------------------------------------------- checkpoint cloning


def _net(seed=5):
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(1e-2)).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _lineage_batch():
    rs = np.random.RandomState(0)
    return (rs.randn(32, 4).astype(np.float32),
            np.eye(3, dtype=np.float32)[rs.randint(0, 3, 32)])


def _trained_lineage(directory, steps=3, seed=5, keep_last=8):
    net = _net(seed)
    x, y = _lineage_batch()
    ck = TrainingCheckpointer(directory, async_write=False, keep_last=keep_last)
    for _ in range(steps):
        net._fit_batch(DataSet(x, y))
        ck.save(net)
    return net


def _jax_net(seed=5):
    from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf import DenseLayer as JDense
    from deeplearning4j_tpu.nn.conf import InputType as JIT
    from deeplearning4j_tpu.nn.conf import OutputLayer as JOut
    from deeplearning4j_tpu.nn.updaters import Adam as JAdam

    conf = (JNNC.Builder().seed(seed).updater(JAdam(1e-2)).list()
            .layer(JDense(n_in=4, n_out=8, activation="tanh"))
            .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    return JMLN(conf).init()


def _jax_trained_lineage(directory, steps=3, seed=5, keep_last=8):
    net = _jax_net(seed)
    x, y = _lineage_batch()
    ck = JCheckpointer(directory, async_write=False, keep_last=keep_last)
    for _ in range(steps):
        net._fit_batch(JDataSet(x, y))
        ck.save(net)
    return net


class TestCloneGeneration:
    def test_clone_lands_as_restorable_suffixed_sibling(self, tmp_path):
        src_net = _trained_lineage(str(tmp_path / "win"))
        _trained_lineage(str(tmp_path / "lose"), seed=77)
        src_gen = lineage_state(str(tmp_path / "win"))["newest_committed"]
        got = clone_generation(os.path.join(str(tmp_path / "win"), "latest", src_gen),
                               str(tmp_path / "lose"))
        assert got["generation"] != src_gen and got["generation"].startswith(src_gen)
        assert got["iteration"] == int(src_net.iteration)
        restored = _net(seed=1)
        assert TrainingCheckpointer(str(tmp_path / "lose"), async_write=False).restore(restored)
        for (_, _, a), (_, _, b) in zip(src_net._param_entries(), restored._param_entries()):
            assert torch.equal(a, b)
        commit = json.load(open(os.path.join(got["path"], "COMMIT")))
        assert commit["cloned_from"] == src_gen

    def test_corrupt_source_raises_typed_verify_error(self, tmp_path):
        _trained_lineage(str(tmp_path / "win"), steps=1)
        lineage = os.path.join(str(tmp_path / "win"), "latest")
        gen = lineage_state(str(tmp_path / "win"))["newest_committed"]
        faults._flip_bit_in_shard(os.path.join(lineage, gen))
        with pytest.raises(CheckpointVerifyError) as ei:
            clone_generation(os.path.join(lineage, gen), str(tmp_path / "lose"))
        assert ei.value.reason
        assert not lineage_state(str(tmp_path / "lose"))["committed"]


class TestFleetClonePaths:
    def _two_trial_fleet(self, tmp_path, reg=None):
        fleet = _fleet(tmp_path, _score_runner(_lr_score), n_trials=4, reg=reg,
                       pbt_quantile=0.25)
        for tid in ("t00", "t01"):
            _trained_lineage(fleet.trials[tid].ckpt_dir, steps=2, seed=5 if tid == "t00" else 7)
        return fleet

    def test_clone_into_slot_ok_perturbs_loser(self, tmp_path):
        reg = MetricsRegistry()
        fleet = self._two_trial_fleet(tmp_path, reg)
        try:
            loser, winner = fleet.trials["t01"], fleet.trials["t00"]
            before = dict(loser.hparams)
            outcome = fleet._clone_into_slot(loser, winner, rung=1)
        finally:
            fleet.close()
        assert outcome == "ok"
        assert loser.cloned_from.startswith("t00/")
        assert loser.hparams != before
        assert 1e-4 <= loser.hparams["lr"] <= 1e-1
        assert loser.hparams["hidden"] == winner.hparams["hidden"]
        inv = lineage_state(loser.ckpt_dir)
        assert [g["generation"] for g in inv["committed"]] == [loser.cloned_from.split("/", 1)[1]]
        series = reg.snapshot()["tdl_trial_clones_total"]["series"]
        assert {(s["labels"]["outcome"], s["value"]) for s in series} == {("ok", 1.0)}
        clones = [r for r in fleet.state["journal"] if r["kind"] == "clone"]
        assert clones[0]["new_hparams"] == {k: v for k, v in loser.hparams.items()
                                            if k != "__id__"}

    def test_perturbation_is_resume_deterministic(self, tmp_path):
        fleet = self._two_trial_fleet(tmp_path)
        try:
            winner = fleet.trials["t00"]
            a = fleet._perturb(winner.hparams, fleet._rs("pbt", 1, "t01"))
            b = fleet._perturb(winner.hparams, fleet._rs("pbt", 1, "t01"))
            spread = {json.dumps(fleet._perturb(winner.hparams, fleet._rs("pbt", r, "t01")),
                                 sort_keys=True) for r in range(16)}
        finally:
            fleet.close()
        assert a == b
        assert len(spread) > 1
        assert all(json.loads(s)["hidden"] == winner.hparams["hidden"] for s in spread)

    def test_corrupt_newest_falls_back_to_older_generation(self, tmp_path):
        reg = MetricsRegistry()
        fleet = self._two_trial_fleet(tmp_path, reg)
        try:
            winner = fleet.trials["t00"]
            newest = lineage_state(winner.ckpt_dir)["newest_committed"]
            faults._flip_bit_in_shard(os.path.join(winner.ckpt_dir, "latest", newest))
            outcome = fleet._clone_into_slot(fleet.trials["t01"], winner, 1)
        finally:
            fleet.close()
        assert outcome == "fallback"
        inv = lineage_state(winner.ckpt_dir)
        assert newest not in [g["generation"] for g in inv["committed"]]
        assert inv["quarantined"]
        assert lineage_state(fleet.trials["t01"].ckpt_dir)["newest_committed"]
        ev = [e for e in _fleet_events(fleet) if e["kind"] == "trial_clone"]
        assert ev and ev[0]["outcome"] == "fallback" and ev[0]["quarantined"]
        series = reg.snapshot()["tdl_trial_clones_total"]["series"]
        assert {(s["labels"]["outcome"], s["value"]) for s in series} == {("fallback", 1.0)}
        assert winner.status != "quarantined"

    def test_fully_corrupt_winner_is_quarantined_loser_keeps_weights(self, tmp_path):
        reg = MetricsRegistry()
        fleet = self._two_trial_fleet(tmp_path, reg)
        try:
            winner = fleet.trials["t00"]
            for g in lineage_state(winner.ckpt_dir)["committed"]:
                faults._flip_bit_in_shard(os.path.join(winner.ckpt_dir, "latest",
                                                       g["generation"]))
            loser = fleet.trials["t01"]
            before_inv = lineage_state(loser.ckpt_dir)["newest_committed"]
            before_hp = dict(loser.hparams)
            outcome = fleet._clone_into_slot(loser, winner, 1)
        finally:
            fleet.close()
        assert outcome == "failed"
        assert (winner.status, winner.quarantine_reason) == ("quarantined", "clone_source")
        assert lineage_state(loser.ckpt_dir)["newest_committed"] == before_inv
        assert loser.hparams == before_hp
        series = reg.snapshot()["tdl_trial_clones_total"]["series"]
        assert {(s["labels"]["outcome"], s["value"]) for s in series} == {("failed", 1.0)}
        reasons = reg.snapshot()["tdl_trial_quarantined_total"]["series"]
        assert {s["labels"]["reason"] for s in reasons} == {"clone_source"}

    @pytest.mark.parametrize("spec,want,flips", [("corrupt_clone", ["fallback", "ok"], 1),
                                                 ("corrupt_clone@every=1", ["failed", "failed"],
                                                  3)])
    def test_injected_corrupt_clone_fault(self, tmp_path, monkeypatch, spec, want, flips):
        """``corrupt_clone`` bit-flips the clone source about to be read and
        writes a flight note. It is one-shot, so the fallback and the next
        clone read healthy bytes; with ``every=1`` it flips each of the
        winner's three generations, so nothing verifies and the winner is
        quarantined as a clone source."""
        monkeypatch.setenv(faults.ENV_SPEC, spec)
        fleet = _fleet(tmp_path, _score_runner(_lr_score), n_trials=4)
        for tid in ("t00", "t01", "t02"):
            _trained_lineage(fleet.trials[tid].ckpt_dir, steps=3, seed=5)
        try:
            got = [fleet._clone_into_slot(fleet.trials["t01"], fleet.trials["t00"], 0),
                   fleet._clone_into_slot(fleet.trials["t02"], fleet.trials["t00"], 0)]
        finally:
            fleet.close()
        assert got == want
        notes = [e for e in _fleet_events(fleet) if e["kind"] == "fault_injected"]
        assert [e["fault"] for e in notes] == ["corrupt_clone"] * flips
        assert (fleet.trials["t00"].status == "quarantined") == (flips == 3)


# ------------------------------------------------------------- spool reader


class TestSpooledScores:
    def _spool(self, d, proc, wall, trial, score, iteration):
        payload = {"proc": proc, "wall": wall, "snapshot": {
            "tdl_trial_score": {"type": "gauge", "series": [
                {"labels": {"trial": trial}, "value": score}]},
            "tdl_trial_iteration": {"type": "gauge", "series": [
                {"labels": {"trial": trial}, "value": iteration}]}}}
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"tdl_metrics_{proc}.1.json"), "w") as f:
            json.dump(payload, f)

    def test_newest_iteration_wins_across_procs(self, tmp_path):
        d = str(tmp_path)
        self._spool(d, "t00-rank0", 1.0, "t00", 0.5, 4)
        self._spool(d, "t01-rank0", 2.0, "t01", 0.7, 8)
        assert spooled_scores(d, registry=MetricsRegistry()) == {"t00": (4, 0.5),
                                                                 "t01": (8, 0.7)}

    def test_torn_spool_degrades_not_raises(self, tmp_path):
        d = str(tmp_path)
        self._spool(d, "t00-rank0", 1.0, "t00", 0.5, 4)
        with open(os.path.join(d, "tdl_metrics_t01-rank0.1.json"), "w") as f:
            f.write('{"torn')
        reg = MetricsRegistry()
        assert spooled_scores(d, registry=reg) == {"t00": (4, 0.5)}
        errs = reg.snapshot()["tdl_spool_read_errors_total"]["series"]
        assert sum(s["value"] for s in errs) == 1.0


# ------------------------------------------------------------------ metrics


class TestTrialMetrics:
    def test_state_gauge_is_exclusive_per_trial(self):
        reg = MetricsRegistry()
        m = trial_metrics(reg)
        set_trial_state(m, "t00", "running")
        set_trial_state(m, "t00", "quarantined")
        set_trial_state(m, "t01", "running")
        series = {(s["labels"]["trial"], s["labels"]["state"]): s["value"]
                  for s in reg.snapshot()["tdl_trial_state"]["series"]}
        assert series[("t00", "quarantined")] == 1.0
        assert series[("t00", "running")] == 0.0
        assert series[("t01", "running")] == 1.0
        assert sum(v for (t, _), v in series.items() if t == "t00") == 1.0

    def test_unknown_state_is_a_bug_not_a_label(self):
        with pytest.raises(ValueError):
            set_trial_state(trial_metrics(MetricsRegistry()), "t00", "confused")

    def test_families_and_states_match_jax(self):
        from deeplearning4j_tpu.monitoring import trial as JT

        assert TRIAL_STATES == JT.TRIAL_STATES
        treg, jreg = MetricsRegistry(), JRegistry()
        trial_metrics(treg)
        JT.trial_metrics(jreg)
        tsnap, jsnap = treg.snapshot(), jreg.snapshot()
        assert set(tsnap) == set(jsnap) >= {
            "tdl_trial_state", "tdl_trial_rung_promotions_total", "tdl_trial_quarantined_total",
            "tdl_trial_clones_total", "tdl_fleet_disk_bytes", "tdl_trial_score",
            "tdl_trial_iteration"}
        for name in tsnap:
            assert tsnap[name]["type"] == jsnap[name]["type"], name


def test_every_trial_terminal_decision_records_a_flight_event():
    import ast

    tree = ast.parse((ROOT / "deeplearning4j_tpu_torch" / "arbiter" / "fleet.py").read_text())
    found = {node.name for node in ast.walk(tree) if isinstance(node, ast.FunctionDef)}
    assert not set(_DECISION_EVENTS) - found
    assert not _unflighted_decision_paths(tree)


def test_fleet_trial_kinds_are_registered_event_kinds():
    for kind in ("trial_spawn", "trial_score", "trial_rung_promote", *_DECISION_EVENTS.values()):
        assert kind in flight.EVENT_KINDS


def test_deliberate_differences_from_jax():
    """The port's gangs run its own worker, on the card unless asked for the
    CPU; ``from_config`` passes ``platform`` through unchanged."""
    from deeplearning4j_tpu.arbiter import fleet as JF

    assert fleet_mod.WORKER_TARGET == "deeplearning4j_tpu_torch.arbiter.trial_worker:trial_train"
    assert JF.WORKER_TARGET == "deeplearning4j_tpu.arbiter.trial_worker:trial_train"
    assert GangTrialRunner("/nonexistent").platform == "cuda"
    assert JF.GangTrialRunner("/nonexistent").platform == "cpu"


# ------------------------------------------------------------------ parity


def _parity_fleets(tmp_path, max_concurrent):
    """The JAX package's fleet and the port's on the same generator seed and
    runner, each trial's lineage seeded by its own package's checkpointer
    (so the clones have committed generations to copy)."""
    out = []
    for mod, reg, seed_lineage, name in (
            (J, JRegistry(), _jax_trained_lineage, "jax"),
            (sys.modules["deeplearning4j_tpu_torch.arbiter"], MetricsRegistry(),
             _trained_lineage, "port")):
        spaces = {"lr": mod.ContinuousParameterSpace(1e-4, 1e-1, log_scale=True),
                  "hidden": mod.IntegerParameterSpace(4, 32)}
        fleet = mod.TrialFleet(mod.RandomSearchGenerator(spaces, seed=3),
                               _score_runner(_lr_score), workdir=str(tmp_path / name),
                               n_trials=8, rungs=(2, 4, 8), seed=5, pbt=True,
                               pbt_quantile=0.34, rung_timeout_s=60.0,
                               max_concurrent=max_concurrent, registry=reg)
        for i, slot in enumerate(sorted(fleet.trials.values(), key=lambda s: s.trial_id)):
            seed_lineage(slot.ckpt_dir, steps=2 + i % 2, seed=5 + i)
        try:
            fleet.run()
        finally:
            fleet.close()
        out.append(fleet)
    return out


def _rows(fleet):
    """Journal rows with the timestamps dropped and the workdir named."""
    text = json.dumps(fleet.state["journal"]).replace(fleet.workdir, "<wd>")
    return [{k: v for k, v in r.items() if k != "wall"} for r in json.loads(text)]


@pytest.mark.parametrize("max_concurrent", [1, 3])
def test_port_fleet_journal_equals_jax(tmp_path, max_concurrent):
    jf, tf = _parity_fleets(tmp_path, max_concurrent)
    jrows, trows = _rows(jf), _rows(tf)
    assert any(r["kind"] == "clone" for r in trows)
    if max_concurrent == 1:
        assert trows == jrows
    else:
        def by_rung(rows):
            out = {}
            for r in rows:
                out.setdefault(r.get("rung"), set()).add(json.dumps(r, sort_keys=True))
            return out

        assert by_rung(trows) == by_rung(jrows)
    assert tf.state["verdicts"] == jf.state["verdicts"]
    assert {t: s.to_json() for t, s in tf.trials.items()} == \
        {t: s.to_json() for t, s in jf.trials.items()}
    assert tf.state["winner"]["trial"] == jf.state["winner"]["trial"]
    assert tf.state["winner"]["score"] == jf.state["winner"]["score"]


def test_jax_lineage_cloned_by_the_port_fleet_restores_bitwise(tmp_path):
    fleet = _fleet(tmp_path, _score_runner(_lr_score), n_trials=2)
    jnet = _jax_trained_lineage(fleet.trials["t00"].ckpt_dir, steps=2, seed=5)
    _trained_lineage(fleet.trials["t01"].ckpt_dir, steps=1, seed=9)
    try:
        assert fleet._clone_into_slot(fleet.trials["t01"], fleet.trials["t00"], 0) == "ok"
    finally:
        fleet.close()
    restored = _net(seed=1)
    assert TrainingCheckpointer(fleet.trials["t01"].ckpt_dir, async_write=False).restore(restored)
    assert restored.iteration == int(jnet.iteration)
    want = jax.tree.map(np.asarray, jnet.params_)
    for si, k, p in restored._param_entries():
        np.testing.assert_array_equal(p.detach().numpy(), want[si][k])


def test_clone_carries_the_perturbed_learning_rate_and_the_clones_state(tmp_path):
    """What a PBT loser's next incarnation builds and restores: the network
    from its perturbed hyperparameters (the new learning rate in its Adam),
    the parameters, Adam moments and iteration from the winner's clone."""
    spec = {"kind": "synth_classify", "seed": 11}
    task = TW.build_task(spec)
    spaces = {"learning_rate": ContinuousParameterSpace(1e-3, 1e-1, log_scale=True),
              "hidden": IntegerParameterSpace(4, 32)}
    fleet = TrialFleet(RandomSearchGenerator(spaces, seed=7), _score_runner(_lr_score),
                       workdir=str(tmp_path / "f"), n_trials=2, rungs=(3,), seed=7,
                       registry=MetricsRegistry())
    winner, loser = fleet.trials["t00"], fleet.trials["t01"]
    wnet = task.build_net(winner.hparams, device="cpu")
    ck = TrainingCheckpointer(winner.ckpt_dir, async_write=False)
    for it in range(3):
        wnet.fit(DataSet(*task.batch(it)))
    ck.save(wnet)
    try:
        assert fleet._clone_into_slot(loser, winner, 0) == "ok"
    finally:
        fleet.close()
    assert loser.hparams["hidden"] == winner.hparams["hidden"]
    assert loser.hparams["learning_rate"] != winner.hparams["learning_rate"]
    net = task.build_net(loser.hparams, device="cpu")
    assert TrainingCheckpointer(loser.ckpt_dir, async_write=False).restore(net)
    assert net.conf.updater.learning_rate == loser.hparams["learning_rate"]
    assert net.iteration == wnet.iteration == 3
    for (_, _, a), (_, _, b) in zip(net._param_entries(), wnet._param_entries()):
        assert torch.equal(a, b)
    for slot in ("m", "v"):
        for k, t in wnet.updater_state[slot].items():
            assert torch.equal(net.updater_state[slot][k], t), (slot, k)


# ------------------------------------------------------------ trial worker


def test_synth_classify_task_is_jax_bitwise_and_trains_alike():
    spec = {"kind": "synth_classify", "seed": 11}
    hp = {"learning_rate": 0.02, "hidden": 12}
    jt, tt = JW.build_task(spec), TW.build_task(spec)
    for it in (0, 1, 7, 123):
        for a, b in zip(jt.batch(it), tt.batch(it)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jt._draw(np.random.RandomState(jt.seed + 999_331), 512),
                    tt._draw(np.random.RandomState(tt.seed + 999_331), 512)):
        np.testing.assert_array_equal(a, b)  # the evaluation split
    jnet = jt.build_net(hp)
    tnet = port_net(jnet)
    assert tnet.conf.to_json() == tt.build_net(hp, device="cpu").conf.to_json()
    for it in range(4):
        x, y = jt.batch(it)
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
        assert abs(tnet.score_ - jnet.score_) <= TASK_ATOL
    want = jax.tree.map(np.asarray, jnet.params_)
    for si, k, p in tnet._param_entries():
        np.testing.assert_allclose(p.detach().numpy(), want[si][k], rtol=0, atol=TASK_ATOL)
    assert tt.evaluate(tnet) == jt.evaluate(jnet)


def test_lenet_images_task_waits_for_the_etl_service(tmp_path):
    """The registry holds the JAX package's kinds; ``lenet_images`` builds
    over the ETL service (the JAX task's spec, geometry and network); an
    unknown kind raises."""
    assert set(TW.TASKS) == set(JW.TASKS)
    from PIL import Image

    rs = np.random.RandomState(0)
    for i in range(16):
        d = tmp_path / "imgs" / f"c{i % 4}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 255, (16, 16), dtype=np.uint8),
                        mode="L").save(d / f"i{i:03d}.png")
    spec = {"kind": "lenet_images", "data_dir": str(tmp_path / "imgs"), "height": 12,
            "width": 12, "channels": 1, "batch": 8, "store_pad": 2, "seed": 5}
    task, jtask = TW.build_task(spec), JW.build_task(spec)
    assert isinstance(task, TW.LenetImagesTask)
    assert (task.num_batches, task.spec.num_classes) == (jtask.num_batches, 4)
    assert task.build_net({"learning_rate": 3e-3}, device="cpu").conf.to_json() == \
        jtask.build_net({"learning_rate": 3e-3}).conf.to_json()
    with pytest.raises(ValueError, match="unknown trial task"):
        TW.build_task({"kind": "nope"})


# -------------------------------------------------------- real trial gangs


def _gang_spaces():
    return {"learning_rate": ContinuousParameterSpace(1e-3, 1e-1, log_scale=True),
            "hidden": IntegerParameterSpace(4, 32)}


def test_real_gang_sweep_on_the_cpu_promotes_a_winner(tmp_path):
    """Three trials, rungs (1, 2), two gangs at a time, each a process of
    ``trial_train`` under ``GangSupervisor(platform="cpu")``: every score
    comes back through the shared spool and the winner's lineage restores to
    its journaled score."""
    wd = str(tmp_path / "sweep")
    runner = GangTrialRunner(wd, {"kind": "synth_classify", "seed": 11}, platform="cpu",
                             hang_timeout=60.0)
    reg = MetricsRegistry()
    fleet = TrialFleet(RandomSearchGenerator(_gang_spaces(), seed=7), runner, workdir=wd,
                       n_trials=3, rungs=(1, 2), max_concurrent=2, seed=7, registry=reg,
                       rung_timeout_s=240.0)
    try:
        winner = fleet.run()
    finally:
        fleet.close()
    assert fleet.trials[winner["trial"]].status == "winner"
    scores = spooled_scores(runner.spool_dir, registry=reg)
    assert {t.trial_id for t in fleet.trials.values() if t.scores} <= set(scores)
    assert scores[winner["trial"]] == (2, winner["score"])
    task = TW.build_task({"kind": "synth_classify", "seed": 11})
    net = task.build_net(winner["hparams"], device="cpu")
    assert TrainingCheckpointer(winner["ckpt_dir"], async_write=False).restore(net)
    assert (int(net.iteration), task.evaluate(net)) == (2, winner["score"])


def _write_fleet_config(tmp_path, workdir, *, n_trials=6, rungs=(2, 4), extra=None):
    cfg = {"workdir": workdir, "generator": "random", "seed": 7, "n_trials": n_trials,
           "rungs": list(rungs), "reduction": 2, "max_concurrent": 2,
           "rung_timeout_s": 240.0, "trial_max_restarts": 2, "backoff_base_s": 0.1,
           "backoff_max_s": 0.5, "hang_timeout": 20.0, "platform": "cpu",
           "task": {"kind": "synth_classify", "seed": 11},
           "spaces": {"learning_rate": {"kind": "continuous", "lo": 1e-3, "hi": 1e-1,
                                        "log_scale": True},
                      "hidden": {"kind": "integer", "lo": 4, "hi": 32}}}
    cfg.update(extra or {})
    path = tmp_path / "fleet_config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_from_config_builds_the_gang_fleet(tmp_path):
    cfg = _write_fleet_config(tmp_path, str(tmp_path / "wd"), extra={"generator": "grid",
                                                                     "discretization": 2})
    fleet = fleet_mod.from_config(cfg)
    try:
        assert isinstance(fleet.runner, GangTrialRunner)
        assert fleet.runner.platform == "cpu" and fleet.runner.hang_timeout == 20.0
        assert (len(fleet.trials), fleet.rungs, fleet.max_concurrent) == (4, (2, 4), 2)
        assert sorted(fleet.spaces) == ["hidden", "learning_rate"]
    finally:
        fleet.close()
    raw = json.loads(pathlib.Path(cfg).read_text())
    del raw["platform"]
    pathlib.Path(cfg).write_text(json.dumps(dict(raw, workdir=str(tmp_path / "wd2"))))
    fleet = fleet_mod.from_config(cfg)
    try:
        assert fleet.runner.platform == "cuda"
    finally:
        fleet.close()


@pytest.mark.slow
class TestFleetGangChaos:
    def test_gang_sweep_survives_crashes_and_corrupt_clone(self, tmp_path, monkeypatch):
        wd = str(tmp_path / "sweep")

        def fault_spec_for(slot):
            if slot.trial_id == "t01":
                return "crash@iteration=1,restart=0"
            if slot.trial_id == "t03":
                return "crash@iteration=1,every=1"
            return ""

        monkeypatch.setenv(faults.ENV_SPEC, "corrupt_clone")
        runner = GangTrialRunner(wd, {"kind": "synth_classify", "seed": 11}, platform="cpu",
                                 gang_max_restarts=2, hang_timeout=30.0,
                                 fault_spec_for=fault_spec_for)
        reg = MetricsRegistry()
        fleet = TrialFleet(RandomSearchGenerator(_gang_spaces(), seed=7), runner, workdir=wd,
                           n_trials=6, rungs=(2, 4), reduction=2, pbt=True, pbt_quantile=0.34,
                           seed=7, registry=reg, rung_timeout_s=420.0, trial_max_restarts=1,
                           backoff_base_s=0.1, max_concurrent=2)
        try:
            winner = fleet.run()
        finally:
            fleet.close()
        assert winner["trial"] != "t03"
        assert fleet.trials["t03"].status == "quarantined"
        assert fleet.trials["t01"].status != "quarantined"
        scores = spooled_scores(runner.spool_dir, registry=reg)
        assert {t.trial_id for t in fleet.trials.values() if t.scores} <= set(scores)
        clones = [r for r in fleet.state["journal"] if r["kind"] == "clone"]
        if clones:
            assert clones[0]["outcome"] in ("fallback", "ok")
        for t in fleet.trials.values():
            if t.status in ("demoted", "quarantined"):
                assert len(lineage_state(t.ckpt_dir)["committed"]) <= 1

    def test_sigkilled_fleet_cli_resumes_mid_rung(self, tmp_path):
        wd = str(tmp_path / "sweep")
        cfg = _write_fleet_config(tmp_path, wd, n_trials=4, rungs=(2, 4))
        cli = [sys.executable, "-m", "deeplearning4j_tpu_torch.arbiter.fleet", cfg]
        proc = subprocess.Popen(cli, cwd=str(ROOT), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, start_new_session=True)
        state_path = os.path.join(wd, "fleet_state.json")
        deadline = time.monotonic() + 300.0
        try:
            while time.monotonic() < deadline and proc.poll() is None:
                try:
                    journaled = len(json.load(open(state_path))["journal"])
                except (OSError, ValueError, KeyError):
                    journaled = 0
                if journaled >= 2:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait(timeout=30)
                    break
                time.sleep(0.5)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
        pre = json.load(open(state_path))
        pre_scores = {(r["trial"], r["rung"]): r["score"] for r in pre["journal"]
                      if r["kind"] == "score"}
        out = subprocess.run(cli, cwd=str(ROOT), capture_output=True, text=True, timeout=540)
        assert out.returncode == 0, out.stdout + out.stderr
        winner = json.loads(out.stdout.strip().splitlines()[-1])
        post = json.load(open(state_path))
        assert post["winner"]["trial"] == winner["trial"]
        post_scores = {(r["trial"], r["rung"]): r["score"] for r in post["journal"]
                       if r["kind"] == "score"}
        for key, score in pre_scores.items():
            assert post_scores[key] == score
