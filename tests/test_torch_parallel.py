"""The port's data-parallel layer in one process, held to the JAX package.

Mirror of ``tests/test_parallel.py`` for ``deeplearning4j_tpu_torch.parallel``:
the trainers over a data mesh of one process (the port runs one device per
process; the multi-process cases are ``test_torch_multiprocess.py``), the
wrapper, the parameter-averaging master, the codecs, the fake collectives,
the ``train_step`` fault sites, the mesh's axis rules and the trainers'
metric families. JAX runs on the CPU with its 8-device mesh, as its own
tests run it. Limits are the port's MLN limits (loss within 1e-5 relative,
each update within 1e-4 of its norm) unless a case says otherwise.
"""

import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JListIterator
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import DenseLayer, InputType, OutputLayer
from deeplearning4j_tpu.nn.updaters import Sgd
from deeplearning4j_tpu.parallel import ParallelTrainer as JParallelTrainer
from deeplearning4j_tpu.parallel import ParameterAveragingTrainingMaster as JMaster
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu.parallel import compression as JZ
from deeplearning4j_tpu.parallel.mesh import MeshSpec as JMeshSpec
from deeplearning4j_tpu_torch.common import faults
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.monitoring import get_registry
from deeplearning4j_tpu_torch.parallel import (MeshSpec, MultiProcessTrainer, ParallelTrainer,
                                               ParallelWrapper, ParameterAveragingTrainingMaster,
                                               build_mesh, compression, launcher)
from deeplearning4j_tpu_torch.parallel.collectives import FakeCollectives, TransportError
from torch_mln_helpers import params_close, port_net, snapshot
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

LOSS_REL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jmlp(seed=7, lr=0.05):
    conf = (JNNC.Builder().seed(seed).updater(Sgd(lr)).list()
            .layer(DenseLayer(n_in=6, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    return JMLN(conf).init()


def _data(n=64, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 6).astype(np.float32)
    y = np.argmax(X[:, :3], axis=1)
    return X, np.eye(3, dtype=np.float32)[y]


def _batches(X, Y, size):
    return [(X[i:i + size], Y[i:i + size]) for i in range(0, len(X), size)]


def test_world_one_trainer_equals_fit_batch_and_jax_parallel_trainer():
    """A data mesh of one process: the same step as the network's own
    ``_fit_batch`` bit for bit, and the JAX trainer over 8 devices within
    1e-5 (its own test's limit against one device)."""
    X, Y = _data(32)
    jnet = _jmlp()
    a, b = port_net(jnet), port_net(jnet)
    a._fit_batch(DataSet(X, Y))
    trainer = ParallelTrainer(b)
    assert trainer.mesh.size == 1 and trainer.mesh.shape == {"data": 1}
    trainer._fit_batch(DataSet(X, Y))
    assert torch.equal(a.params(), b.params()) and a.score_ == b.score_
    assert b.iteration == 1 and b.last_batch_size == 32
    JParallelTrainer(jnet, mesh=jbuild_mesh(data=8))._fit_batch(JDataSet(X, Y))
    np.testing.assert_allclose(b.params().numpy(), jnet.params().numpy(), atol=1e-5)
    assert abs(b.score_ - float(jnet.score_)) <= LOSS_REL * abs(float(jnet.score_))


def test_parallel_wrapper_trains_and_refuses_more_workers_than_ranks():
    X, Y = _data(64)
    net = port_net(_jmlp())
    w = ParallelWrapper.Builder(net).prefetch_buffer(2).build()
    assert w.workers == 1
    it = ListDataSetIterator([DataSet(x, y) for x, y in _batches(X, Y, 16)])
    s0 = None
    for _ in range(10):
        w.fit(it)
        s0 = s0 or net.score_
    assert net.score_ < s0
    with pytest.raises(ValueError, match="launcher.launch"):
        ParallelWrapper.Builder(net).workers(8).build()


def test_parallel_wrapper_averaging_goes_to_the_master(monkeypatch):
    seen = []
    monkeypatch.setattr(ParameterAveragingTrainingMaster, "fit",
                        lambda self, net, it, epochs=1: seen.append(
                            (self.workers, self.averaging_frequency)) or net)
    net = port_net(_jmlp())
    w = (ParallelWrapper.Builder(net).workers(4).averaging_frequency(3)
         .training_mode("AVERAGING").build())
    w.fit(ListDataSetIterator([DataSet(*_data(8))]))
    assert seen == [(4, 3)]


def test_parameter_averaging_master_matches_jax():
    """4 in-process replicas averaging every 2 batches, 3 epochs of 8
    batches: the port's master against the JAX master on the same weights."""
    X, Y = _data(64)
    jnet = _jmlp()
    net = port_net(jnet)
    before = snapshot(jnet)
    batches = _batches(X, Y, 8)
    JMaster(workers=4, averaging_frequency=2).fit(
        jnet, JListIterator([JDataSet(x, y) for x, y in batches]), epochs=3)
    ParameterAveragingTrainingMaster(workers=4, averaging_frequency=2).fit(
        net, ListDataSetIterator([DataSet(x, y) for x, y in batches]), epochs=3)
    assert net.epoch == 3 and net.iteration == jnet.iteration
    assert abs(net.score_ - float(jnet.score_)) <= LOSS_REL * abs(float(jnet.score_))
    params_close(net, jnet, before)


@pytest.mark.parametrize("seed,scale,thr", [(3, 1e-3, 1e-3), (5, 0.3, 0.2)])
def test_threshold_codec_bit_equal_to_jax(seed, scale, thr):
    g = (np.random.RandomState(seed).randn(1000) * scale).astype(np.float32)
    enc, residual = compression.threshold_residual(g, thr)
    jenc, jres = JZ.threshold_residual(g, thr)
    np.testing.assert_array_equal(enc, jenc)
    np.testing.assert_array_equal(residual, jres)
    assert enc.dtype == jenc.dtype == np.int64
    np.testing.assert_array_equal(compression.threshold_encode(g, thr), JZ.threshold_encode(g, thr))
    dec = compression.threshold_decode(enc, thr)
    np.testing.assert_array_equal(dec, JZ.threshold_decode(jenc, thr))
    np.testing.assert_allclose(dec + residual, g, atol=1e-7)


def test_bitmap_codec_bit_equal_to_jax():
    g = (np.random.RandomState(4).randn(257) * 2e-3).astype(np.float32)
    packed, size = compression.bitmap_encode(g, 1e-3)
    jpacked, jsize = JZ.bitmap_encode(g, 1e-3)
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(size, jsize)
    dec = compression.bitmap_decode(packed, size, 1e-3)
    np.testing.assert_array_equal(dec, JZ.bitmap_decode(jpacked, jsize, 1e-3))
    exp = np.where(g >= 1e-3, 1e-3, np.where(g <= -1e-3, -1e-3, 0.0)).astype(np.float32)
    np.testing.assert_allclose(dec, exp, atol=1e-8)


def test_adaptive_threshold_follows_jax():
    rs = np.random.RandomState(1)
    ours, theirs = compression.AdaptiveThresholdAlgorithm(), JZ.AdaptiveThresholdAlgorithm()
    for _ in range(6):
        g = rs.randn(500).astype(np.float32) * 1e-3
        assert ours.update(g) == theirs.update(g)


def test_fake_collectives_barrier_broadcast_and_failure():
    """The DummyTransport descendant: normal ops, then an injected failure
    aborts the collective on every live rank."""
    router = FakeCollectives(world_size=3, timeout=5.0)
    results, errors = {}, {}

    def run(rank):
        w = router.worker(rank)
        try:
            w.barrier("start")
            results[rank] = w.broadcast("conf", {"lr": 0.1} if rank == 0 else None)
            g = w.gather("scores", rank * 1.0)
            if rank == 0:
                results["gathered"] = g
            if rank == 1:
                router.inject_failure(2)
            w.barrier("end")  # rank 2 is failed: everyone gets TransportError
        except TransportError as e:
            errors[rank] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results[1] == {"lr": 0.1} and results[2] == {"lr": 0.1}
    assert results["gathered"] == [0.0, 1.0, 2.0]
    assert 0 in errors and 1 in errors


def test_encoded_gradient_exchange_two_workers():
    """Encode, ship, decode and accumulate with residuals over the fake
    transport: both workers apply the same sparse update each round, the
    one the JAX accumulator computes."""
    from deeplearning4j_tpu.parallel.collectives import FakeCollectives as JFake
    from deeplearning4j_tpu.parallel.compression import EncodedGradientsAccumulator as JAcc
    from deeplearning4j_tpu_torch.parallel.compression import EncodedGradientsAccumulator

    rs = np.random.RandomState(0)
    grads = [rs.randn(64).astype(np.float32) * 1e-3 for _ in range(2)]
    out = {}

    def run(router, acc_cls, tag, rank):
        acc = acc_cls(router.worker(rank), threshold=1.5e-3)
        out[(tag, rank)] = (acc.exchange(grads[rank]), acc.exchange(grads[rank]), acc.residual)

    for tag, router, acc_cls in (("port", FakeCollectives(2, 5.0), EncodedGradientsAccumulator),
                                 ("jax", JFake(2, 5.0), JAcc)):
        threads = [threading.Thread(target=run, args=(router, acc_cls, tag, r))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for i in range(2):
        np.testing.assert_array_equal(out[("port", 0)][i], out[("port", 1)][i])
        np.testing.assert_array_equal(out[("port", 0)][i], out[("jax", 0)][i])
    for r in range(2):
        np.testing.assert_array_equal(out[("port", r)][2], out[("jax", r)][2])


def test_loss_spike_scales_the_parameters(monkeypatch):
    """``loss_spike@iter=1`` multiplies every parameter by ``scale`` before
    step 1, once; the run goes on training."""
    X, Y = _data(16)
    net = port_net(_jmlp())
    trainer = ParallelTrainer(net)
    trainer._fit_batch(DataSet(X, Y))
    before = net.params().clone()
    monkeypatch.setenv(faults.ENV_SPEC, "loss_spike@iter=1,scale=40")
    spiked = []
    fit_batch = type(net)._fit_batch
    monkeypatch.setattr(type(net), "_fit_batch",
                        lambda self, ds: spiked.append(self.params().clone()) or
                        fit_batch(self, ds))
    trainer._fit_batch(DataSet(X, Y))
    trainer._fit_batch(DataSet(X, Y))
    assert torch.equal(spiked[0], before * 40)
    assert not torch.equal(spiked[1], spiked[0] * 40) and net.iteration == 3


def test_crash_exits_with_the_spec_code_in_a_subprocess():
    script = (
        "import numpy as np\n"
        "from deeplearning4j_tpu_torch.data import DataSet\n"
        "from deeplearning4j_tpu_torch.nn import conf as C, MultiLayerNetwork\n"
        "from deeplearning4j_tpu_torch.nn.updaters import Sgd\n"
        "from deeplearning4j_tpu_torch.parallel import ParallelTrainer\n"
        "conf = (C.NeuralNetConfiguration.Builder().seed(1).updater(Sgd(0.1)).list()\n"
        "        .layer(C.DenseLayer(n_in=4, n_out=4)).layer(C.OutputLayer(n_out=2))\n"
        "        .set_input_type(C.InputType.feed_forward(4)).build())\n"
        "t = ParallelTrainer(MultiLayerNetwork(conf, device='cpu').init())\n"
        "x = np.ones((4, 4), np.float32); y = np.eye(2, dtype=np.float32)[[0, 1, 0, 1]]\n"
        "for i in range(3):\n"
        "    print('step', i, flush=True)\n"
        "    t._fit_batch(DataSet(x, y))\n")
    env = dict(os.environ, TDL_FAULT_SPEC="crash@iter=1", PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True,
                       timeout=120, cwd=ROOT)
    assert p.returncode == faults.CRASH_EXIT_CODE, p.stderr[-2000:]
    assert p.stdout.split() == ["step", "0", "step", "1"]


def test_mesh_resolves_as_jax_and_refuses_other_axes():
    for axes, n in (({"data": -1}, 8), ({"data": 2, "model": -1}, 8), ({"data": 4}, 4)):
        assert MeshSpec(dict(axes)).resolve(n) == JMeshSpec(dict(axes)).resolve(n)
    with pytest.raises(ValueError):
        MeshSpec({"data": -1, "model": -1}).resolve(4)
    mesh = build_mesh()
    assert mesh.shape == {"data": 1} and mesh.size == 1 and mesh.group() is None
    assert build_mesh(data=1, model=1).size == 1  # a size-1 axis names nothing
    assert build_mesh(data=1, pipe=1).shape == {"data": 1, "pipe": 1}  # a pipe axis is an axis
    # an expert axis resolves as in JAX and joins the mesh (models.moe)
    assert MeshSpec({"data": -1, "expert": 2}).resolve(8) == \
        JMeshSpec({"data": -1, "expert": 2}).resolve(8) == {"data": 4, "expert": 2}
    assert build_mesh(data=1, expert=1).shape == {"data": 1, "expert": 1}
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh

    assert Mesh.virtual({"data": 2, "expert": 2}, 3).coords == {"data": 1, "expert": 1}
    with pytest.raises(NotImplementedError, match="launch"):
        build_mesh(data=2, devices=[0, 1])


def test_sharded_options_raise_naming_the_next_slice():
    """Sharded training is ported (``test_torch_sharded.py``); a plain
    trainer given a ``pipe`` axis refuses it, naming the trainer that runs
    the pipeline schedule (``test_torch_pipeline_parallel.py``), as the JAX
    trainers do; both options at once are refused, as in the JAX package."""
    from deeplearning4j_tpu_torch.parallel.partition import SpecLayout
    from deeplearning4j_tpu_torch.parallel.sharding import alternating_dense_rules

    net = port_net(_jmlp())
    for trainer in (ParallelTrainer, MultiProcessTrainer):
        with pytest.raises(ValueError, match="PipelineParallelTrainer"):
            trainer(net, mesh_layout=SpecLayout(data=1, fsdp=1, tp=1, pipe=2))
    with pytest.raises(ValueError, match="OR"):
        ParallelTrainer(net, mesh_layout=SpecLayout(1, 1, 1),
                        sharding_rules=alternating_dense_rules())


def test_trainer_metric_families_and_step_phases():
    X, Y = _data(32)
    trainer = ParallelTrainer(port_net(_jmlp()))
    trainer.fit(ListDataSetIterator([DataSet(x, y) for x, y in _batches(X, Y, 8)]))
    reg = get_registry()
    for family in ("tdl_parallel_step_seconds", "tdl_collective_bytes_total",
                   "tdl_parallel_devices", "tdl_step_wall_seconds", "tdl_step_phase_seconds"):
        assert family in reg.names(), family
    assert trainer._phases.summary()["steps"] == 4
    assert all(trainer._phases._totals[p] > 0 for p in ("input", "h2d", "compute"))


def test_launcher_contract():
    """One device per process (``n_local_devices`` > 1 raises), the card by
    default, and rank 0's store bind failure recognised in torch's words."""
    with pytest.raises(ValueError, match="one device per process"):
        launcher.spawn("x:y", 2, n_local_devices=2, platform="cpu")
    res = [launcher.WorkerResult(0, 1, "", "RuntimeError: The server socket has failed to "
                                 "listen on any local network address. port: 1, useIpv6: 0, "
                                 "code: -98, name: EADDRINUSE, message: address already in use"),
           launcher.WorkerResult(1, 1, "", "")]
    assert launcher.coordinator_bind_failed(res)
    assert not launcher.coordinator_bind_failed([res[1], launcher.WorkerResult(0, 1, "", "x")])


def test_bf16_network_parameters_after_a_step_differ_from_jax():
    """A deliberate difference: after one step of a ``data_type("bfloat16")``
    MLN the JAX step's parameters are float32
    (``deeplearning4j_tpu/nn/multilayer.py:360``, ``p - u`` with float32
    updates) while its Adam state stays bfloat16; the port's parameters and
    state stay bfloat16."""
    from deeplearning4j_tpu.nn import conf as JC
    from deeplearning4j_tpu.nn import updaters as JU
    from deeplearning4j_tpu_torch.nn import conf as TC
    from deeplearning4j_tpu_torch.nn import updaters as TU
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from torch_ckpt_helpers import bf16_conf

    jnet = JMLN(bf16_conf(JC, JU)).init()
    net = MultiLayerNetwork(bf16_conf(TC, TU), device="cpu").init()
    rs = np.random.RandomState(0)
    x = rs.randn(4, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 4)]
    assert {str(a.dtype) for a in jax.tree.leaves(jnet.params_)} == {"bfloat16"}
    jnet.fit(JDataSet(x, y))
    net.fit(DataSet(x, y))
    assert {str(a.dtype) for a in jax.tree.leaves(jnet.params_)} == {"float32"}
    assert {str(a.dtype) for a in jax.tree.leaves(jnet.updater_state)} == {"bfloat16"}
    assert {w.dtype for _, _, w in net._param_entries()} == {torch.bfloat16}
    assert {t.dtype for slot in net.updater_state.values() for t in slot.values()} == \
        {torch.bfloat16}
