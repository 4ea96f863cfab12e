"""Port checkpoints (``deeplearning4j_tpu_torch.serde.checkpoint``) against the
JAX package's ``TrainingCheckpointer``, on the CPU: one on-disk format.

Both directions, for LeNet (Adam), the GravesLSTM char-RNN (with the
iterator position) and a BatchNormalization graph with Merge and
ElementWise vertices: one package saves, the other restores, and the
parameters, updater state and BN statistics are equal bit for bit, as are
``iteration``, ``epoch`` and the iterator state; the next fit step's score
then agrees within 1e-5 relative and every update within 1e-4 of its norm
(the MultiLayerNetwork and ComputationGraph parity bounds). A JAX bfloat16
checkpoint restores into the port bit for bit, while the JAX package's own
restore of it raises (the reference's ``|V2`` fault, ROADMAP queue 3).

The port's own lineage: a kill at each commit boundary (``torn_ckpt``) and a
full disk (``enospc``) leave the previous generation restorable, keep-last-K
GC, a re-save at the same iteration, an async failure re-raised,
transactional restore, a layout-stamped JAX gang checkpoint assembled on the
host, ``PreemptionHandler`` resuming a dropout network bit for bit, and the
distribution options refused.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serde import checkpoint as J
from deeplearning4j_tpu_torch.common import faults
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator
from deeplearning4j_tpu_torch.monitoring import get_registry
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serde import checkpoint as T
from deeplearning4j_tpu_torch.serde.net_state import snapshot
from torch_ckpt_helpers import (KINDS, LOSS_REL, assert_same_state, assert_states_equal, batch,
                                iterators, jax_net, port_net)
from torch_mln_helpers import params_close
from torch_mln_helpers import snapshot as jax_snapshot
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _fit(net, kind, i, jax_side):
    jds, tds = batch(kind, i)
    net.fit(jds if jax_side else tds)


def _next_step_agrees(tnet, jnet, kind, i):
    before = jax_snapshot(jnet)
    _fit(jnet, kind, i, True)
    _fit(tnet, kind, i, False)
    assert _rel(tnet.score_, jnet.score_) <= LOSS_REL, (tnet.score_, jnet.score_)
    params_close(tnet, jnet, before)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_lineage_restores_into_the_port(kind, tmp_path):
    jnet = jax_net(kind)
    jit, tit = iterators(kind)
    if jit is not None:
        jit.reset()
        for _ in range(2):
            jnet.fit(jit.next())
    else:
        for i in range(2):
            _fit(jnet, kind, i, True)
    J.TrainingCheckpointer(str(tmp_path), async_write=False).save(jnet, jit)
    tnet = port_net(kind)
    assert T.TrainingCheckpointer(str(tmp_path)).restore(tnet, tit)
    assert_same_state(tnet, jnet)
    assert (tnet.iteration, tnet.epoch) == (jnet.iteration, jnet.epoch) == (2, 2)
    if tit is not None:
        assert tit.state() == jit.state() == {"pos": 2 * jit.batch(), "epoch": 1}
    _next_step_agrees(tnet, jnet, kind, 2)


@pytest.mark.parametrize("kind", KINDS)
def test_port_lineage_restores_into_jax(kind, tmp_path):
    tnet = port_net(kind)
    jit, tit = iterators(kind)
    if tit is not None:
        tit.reset()
        for _ in range(2):
            tnet.fit(tit.next())
    else:
        for i in range(2):
            _fit(tnet, kind, i, False)
    ck = T.TrainingCheckpointer(str(tmp_path))  # async: the writer thread
    gendir = ck.save(tnet, tit)
    ck.wait()
    assert os.path.basename(gendir) == "gen-00000002"
    jnet = jax_net(kind)
    assert J.TrainingCheckpointer(str(tmp_path)).restore(jnet, jit)
    assert_same_state(tnet, jnet)
    assert (jnet.iteration, jnet.epoch) == (2, 2)
    if jit is not None:
        assert jit.state() == tit.state()
    assert J.verify_checkpoint(str(tmp_path))["ok"]
    _next_step_agrees(tnet, jnet, kind, 2)


def test_jax_bf16_checkpoint_restores_bitwise_in_the_port(tmp_path):
    """The JAX package writes a bfloat16 array as two raw bytes (``|V2``);
    the port reads them back as bfloat16 by reinterpretation and writes its
    own the same way (equal CRCs). The JAX package cannot restore its own
    file: ``_restore_assembled`` hands the raw voids to ``jnp.asarray``."""
    jnet = jax_net("bf16_mln")
    J.TrainingCheckpointer(str(tmp_path / "jax"), async_write=False).save(jnet)
    tnet = port_net("bf16_mln")
    assert T.TrainingCheckpointer(str(tmp_path / "jax")).restore(tnet)
    assert all(p.dtype == torch.bfloat16 for _, _, p in tnet._param_entries())
    assert_same_state(tnet, jnet)
    T.TrainingCheckpointer(str(tmp_path / "port"), async_write=False).save(tnet)
    gen = "latest/gen-00000000/manifest_0.json"
    jman = json.loads((tmp_path / "jax" / gen).read_text())
    tman = json.loads((tmp_path / "port" / gen).read_text())
    assert jman["entries"] == tman["entries"]
    with pytest.raises(TypeError, match="V2"):
        J.TrainingCheckpointer(str(tmp_path / "jax")).restore(jax_net("bf16_mln"))


class _Killed(BaseException):
    """What ``os._exit`` does to the process, raised instead."""


@pytest.mark.parametrize("fault", ["torn_ckpt@stage=shard", "torn_ckpt@stage=manifest",
                                   "torn_ckpt@stage=commit", "torn_ckpt@stage=pointer",
                                   "enospc"])
def test_kill_matrix_leaves_a_restorable_generation(fault, tmp_path, monkeypatch):
    """A kill at each two-phase-commit boundary (and a full disk) during the
    save of iteration 2: restore comes back with the generation of iteration
    1, quarantining the torn one — except past the COMMIT marker (stage
    pointer), where iteration 2 is committed and restore finds it although
    LATEST still names iteration 1."""
    def killed(code):
        raise _Killed(code)

    monkeypatch.setattr(faults.os, "_exit", killed)
    net = port_net("bn_graph")
    _fit(net, "bn_graph", 0, False)
    ck = T.TrainingCheckpointer(str(tmp_path), async_write=False)
    ck.save(net)
    first = snapshot(net)
    _fit(net, "bn_graph", 1, False)
    second = snapshot(net)
    monkeypatch.setenv(faults.ENV_SPEC, f"{fault},iter=2" if "@" in fault else f"{fault}@iter=2")
    with pytest.raises(_Killed if fault.startswith("torn") else OSError):
        ck.save(net)
    monkeypatch.delenv(faults.ENV_SPEC)
    assert T._read_pointer(str(tmp_path / "latest")) == "gen-00000001"
    fresh = port_net("bn_graph")
    assert T.TrainingCheckpointer(str(tmp_path)).restore(fresh)
    want = second if fault.endswith("pointer") else first
    assert fresh.iteration == (2 if fault.endswith("pointer") else 1)
    got = snapshot(fresh)
    assert all(np.array_equal(got[p], want[p]) for p in want)
    state = T.lineage_state(str(tmp_path))
    if fault.endswith("pointer"):
        assert state["quarantined"] == []
    else:
        assert state["quarantined"] == ["gen-00000002.corrupt"]
        assert [c["generation"] for c in state["committed"]] == ["gen-00000001"]


def test_gc_keeps_last_k_and_a_resave_never_mutates_a_commit(tmp_path):
    net = port_net("char_rnn")
    ck = T.TrainingCheckpointer(str(tmp_path), async_write=False, keep_last=2)
    retired = get_registry().counter("tdl_ckpt_gc_retired_total", labels=("kind",))
    before = retired.labels("committed").value
    for i in range(4):
        _fit(net, "char_rnn", i, False)
        ck.save(net)
    assert [c["generation"] for c in T.lineage_state(str(tmp_path))["committed"]] == \
        ["gen-00000003", "gen-00000004"]
    assert retired.labels("committed").value - before == 2
    again = ck.save(net)  # same iteration: a suffixed sibling
    assert os.path.basename(again) == "gen-00000004a"
    assert ck.committed_generation() == again
    assert T._read_pointer(str(tmp_path / "latest")) == "gen-00000004a"
    assert T.verify_checkpoint(str(tmp_path))["generation"] == "gen-00000004a"


def test_async_write_failure_is_reraised(tmp_path, monkeypatch):
    net = port_net("lenet")
    ck = T.TrainingCheckpointer(str(tmp_path), async_write=True)
    failures = get_registry().counter("tdl_checkpoint_failures_total")
    before = failures.value
    monkeypatch.setenv(faults.ENV_SPEC, "enospc")
    ck.save(net)  # returns: the failure is on the writer thread
    with pytest.raises(OSError, match="No space left"):
        ck.wait()
    ck.save(net)
    monkeypatch.delenv(faults.ENV_SPEC)
    with pytest.raises(OSError, match="No space left"):
        ck.save(net)  # the next save re-raises the pending failure first
    assert failures.value - before == 2
    ck.save(net)
    ck.wait()
    assert T.verify_checkpoint(str(tmp_path))["ok"]


def test_restore_is_transactional(tmp_path):
    """Every generation corrupt: CheckpointVerifyError, and the network's
    state, counters and iterator position are bit-identical. A checkpoint
    of another configuration: ValueError before any tensor is written."""
    net = port_net("char_rnn")
    _, it = iterators("char_rnn")
    it.reset()
    net.fit(it.next())
    ck = T.TrainingCheckpointer(str(tmp_path / "a"), async_write=False)
    gendir = ck.save(net, it)
    shard = os.path.join(gendir, "shard_0.npz")
    raw = bytearray(open(shard, "rb").read())
    w = snapshot(net)["params/0/W"]
    off = bytes(raw).index(w.tobytes()) + 8
    raw[off] ^= 0xFF
    open(shard, "wb").write(bytes(raw))
    other = port_net("char_rnn")
    it2 = ArrayDataSetIterator(np.zeros((6, 16, 23), np.float32),
                               np.zeros((6, 16, 23), np.float32), 3)
    before, state = snapshot(other), it2.state()
    with pytest.raises(T.CheckpointVerifyError):
        ck.restore(other, it2)
    assert all(np.array_equal(snapshot(other)[p], a) for p, a in before.items())
    assert (other.iteration, it2.state()) == (0, state)
    assert T.lineage_state(str(tmp_path / "a"))["quarantined"] == ["gen-00000001.corrupt"]
    with pytest.raises(T.CheckpointVerifyError):  # sticky across restarts
        T.TrainingCheckpointer(str(tmp_path / "a")).restore(other)

    T.TrainingCheckpointer(str(tmp_path / "b"), async_write=False).save(port_net("lenet"))
    with pytest.raises(ValueError, match="does not match the network's params"):
        T.TrainingCheckpointer(str(tmp_path / "b")).restore(other)
    assert all(np.array_equal(snapshot(other)[p], a) for p, a in before.items())


def test_a_layout_stamped_gang_checkpoint_assembles_on_the_host(tmp_path):
    """A JAX gang's generation (two shard files, each holding half of every
    array's rows, stamped with a mesh layout) restores into the port's
    single-process network by assembling the chunks, as the JAX package
    restores one onto a replicated target."""
    src = port_net("lenet")
    _fit(src, "lenet", 0, False)
    full = snapshot(src)
    gendir = tmp_path / "latest" / J._gen_name(1)
    gendir.mkdir(parents=True)
    layout = {"axes": {"data": 2, "fsdp": 1, "tp": 1}}
    for p in range(2):
        blob = {"__save_id__": np.asarray(1, np.int64)}
        for path, a in full.items():
            n = a.shape[0]
            lo, hi = (0, n // 2) if p == 0 else (n // 2, n)
            idx = [[lo, hi]] + [[0, d] for d in a.shape[1:]]
            blob[f"{path}|0"] = a[lo:hi]
            blob[f"{path}|0|idx"] = np.asarray(idx, np.int64)
            blob[f"{path}|0|shape"] = np.asarray(a.shape, np.int64)
        with open(gendir / f"shard_{p}.npz", "wb") as f:
            np.savez(f, **blob)
        (gendir / f"manifest_{p}.json").write_text(json.dumps(J._self_checksummed({
            "save_id": 1, "proc": p, "process_count": 2, "layout": layout,
            "shard": f"shard_{p}.npz",
            "entries": {k: J._array_crc(v) for k, v in blob.items()}, "nbytes": 0})))
    (gendir / "train_state.json").write_text(json.dumps(J._self_checksummed({
        "iteration": 1, "epoch": 1, "score": None, "process_count": 2,
        "generation": gendir.name, "mesh_layout": layout})))
    (gendir / "COMMIT").write_text("{}")
    jv, tv = J.verify_checkpoint(str(tmp_path)), T.verify_checkpoint(str(tmp_path))
    jv.pop("seconds"), tv.pop("seconds")
    assert jv == tv and tv["ok"]
    dst = port_net("lenet")
    assert T.TrainingCheckpointer(str(tmp_path)).restore(dst)
    assert_states_equal(dst, src)


def _dropout_net():
    conf = (TC.NeuralNetConfiguration.Builder().seed(11).updater(TU.Adam(1e-2)).list()
            .layer(TC.DenseLayer(n_in=6, n_out=16, activation="relu", dropout=0.6))
            .layer(TC.OutputLayer(n_out=3, activation="softmax", loss="mcxent", dropout=0.8))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _run(net, it, scores):
    while it.has_next():
        net._fit_batch(it.next())
        scores.append(net.score_)


def test_preemption_handler_resumes_a_dropout_fit_bitwise(tmp_path):
    """SIGTERM after step 3 of 6 (``swallow=True``): a ``preempt``
    generation with the iterator position; a fresh network restored from it
    finishes the epoch with the uninterrupted run's scores and state, bit
    for bit — the dropout masks replay because their key is (seed,
    iteration)."""
    rs = np.random.RandomState(4)
    x = rs.randn(24, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 24)]
    ref, ref_scores = _dropout_net(), []
    it = ArrayDataSetIterator(x, y, 4)
    it.reset()
    _run(ref, it, ref_scores)

    net, it, scores = _dropout_net(), ArrayDataSetIterator(x, y, 4), []
    ck = T.TrainingCheckpointer(str(tmp_path))
    handler = T.PreemptionHandler(ck, net, it, swallow=True).install()
    try:
        it.reset()
        for _ in range(3):
            net._fit_batch(it.next())
            scores.append(net.score_)
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        handler.uninstall()
    assert handler.fired and ck.async_write  # restored after the sync save
    assert T.lineage_state(str(tmp_path), tag="preempt")["newest_committed"] == "gen-00000003"

    resumed, it2 = _dropout_net(), ArrayDataSetIterator(x, y, 4)
    assert T.TrainingCheckpointer(str(tmp_path)).restore(resumed, it2, tag="preempt")
    assert (resumed.iteration, it2.state()) == (3, {"pos": 12, "epoch": 1})
    _run(resumed, it2, scores)
    assert scores == ref_scores
    assert_states_equal(resumed, ref)


def test_distribution_options_raise(tmp_path):
    """A partitioner must be the port's ``Partitioner``; ``reshard=True``
    with no layout on either side (a replicated checkpoint, no partitioner)
    has nothing to reshard between and raises. Sharded lineages are held in
    ``test_torch_sharded_checkpoint.py``."""
    with pytest.raises(TypeError, match="parallel.partition.Partitioner"):
        T.TrainingCheckpointer(str(tmp_path), partitioner=object())
    src = port_net("lenet")
    T.TrainingCheckpointer(str(tmp_path), async_write=False).save(src)
    for ck, kw in ((T.TrainingCheckpointer(str(tmp_path), reshard=True), {}),
                   (T.TrainingCheckpointer(str(tmp_path)), {"reshard": True})):
        with pytest.raises(ValueError, match="nothing to reshard between"):
            ck.restore(port_net("lenet"), **kw)
    assert T.TrainingCheckpointer(str(tmp_path / "empty")).restore(port_net("lenet")) is False
