"""The port's data-parallel training across real process boundaries, held to
the JAX package.

Mirror of ``tests/test_multiprocess.py``: two gloo ranks on the CPU, started
through the port's ``parallel.launcher.launch`` (workers in
``tests/torch_parallel_workers.py``), train on the same global batches as
the JAX ``ParallelTrainer`` over ``build_mesh(data=2)`` in this process,
from the same initial weights. The port makes GSPMD's one logical step by
hand (``common.data_parallel``); these cases pin each part of it:

- an MLN with BatchNormalization (the moments of the global batch);
- a recurrent MLN with a ragged label mask whose live counts differ between
  the ranks (each rank's loss weighted by its live count);
- a Dense ComputationGraph;
- ``ParallelTrainer`` on odd global batches (the remainder step);
- dropout: the two-rank fit equals the port's one-process fit on the global
  batches (each rank takes its rows of the global mask);
- ``ProcessCollectives`` and the encoded gradient exchange.

Limits are the port's MLN limits: loss within 1e-5 relative, each
parameter's update within 1e-4 of its norm. Two process groups in all.

One deliberate difference from the JAX package, pinned here by running
with ``n_local_devices=1``: the port runs one device per process
(``launcher`` raises for more), and the backend is stated (``gloo`` on the
CPU, ``nccl`` on the card), never chosen by the launcher from the devices.
"""

import json
import os

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.updaters import Adam, Sgd
from deeplearning4j_tpu.parallel import ParallelTrainer as JParallelTrainer
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu_torch.parallel import launcher
from deeplearning4j_tpu_torch.serde.compiled import _flatten
from torch_mln_helpers import port_graph, port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

WORKERS = os.path.join(os.path.dirname(__file__), "torch_parallel_workers.py")
LOSS_REL = 1e-5
UPDATE_REL = 1e-4
ENV = {"TDL_MATMUL_PRECISION": "float32", "OMP_NUM_THREADS": "1"}


def _mln(layers, updater, input_type, seed=7, dropout=None):
    b = JC.NeuralNetConfiguration.Builder().seed(seed).updater(updater)
    if dropout is not None:
        b = b.dropout(dropout)
    lb = b.list()
    for layer in layers:
        lb = lb.layer(layer)
    return JMLN(lb.set_input_type(input_type).build()).init()


def _graph():
    g = (JC.NeuralNetConfiguration.Builder().seed(2).updater(Sgd(0.5)).graph_builder()
         .add_inputs("x").set_input_types(JC.InputType.feed_forward(6)))
    g.add_layer("h", JC.DenseLayer(n_out=8, activation="relu"), "x")
    g.add_layer("out", JC.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "h")
    return JCG(g.set_outputs("out").build()).init()


def _ff_batches(steps, n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        x = rs.randn(n, 6).astype(np.float32)
        out.append({"x": x, "y": np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]})
    return out


def _masked_batches(steps):
    """[8, 4, 6] sequences; rank 0's four rows are long, rank 1's short."""
    rs = np.random.RandomState(5)
    lengths = np.array([6, 6, 5, 6, 1, 2, 1, 3])
    out = []
    for _ in range(steps):
        x = rs.randn(8, 4, 6).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, (8, 6))].transpose(0, 2, 1)
        lm = (np.arange(6)[None] < lengths[:, None]).astype(np.float32)
        out.append({"x": x, "y": np.ascontiguousarray(y), "lm": lm})
    return out


def _cases():
    ff = JC.InputType.feed_forward(6)
    dense = lambda: JC.DenseLayer(n_in=6, n_out=16, activation="tanh")  # noqa: E731
    head = lambda: JC.OutputLayer(n_out=3, activation="softmax", loss="mcxent")  # noqa: E731
    return {
        "bn": ("mln", "multiprocess",
               _mln([dense(), JC.BatchNormalization(), head()], Adam(1e-2), ff),
               _ff_batches(4, 16, 1)),
        "masked": ("mln", "multiprocess",
                   _mln([JC.LSTM(n_in=4, n_out=8),
                         JC.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent")],
                        Sgd(0.1), JC.InputType.recurrent(4, 6)),
                   _masked_batches(3)),
        "graph": ("graph", "multiprocess", _graph(), _ff_batches(3, 16, 2)),
        "remainder": ("mln", "parallel", _mln([dense(), head()], Sgd(0.05), ff),
                      _ff_batches(2, 15, 3)),
        "dropout": ("mln", "multiprocess",
                    _mln([dense(), head()], Adam(1e-2), ff, dropout=0.8),
                    _ff_batches(3, 16, 4)),
    }


def _jax_fit(kind, jnet, batches):
    """The JAX ParallelTrainer over a 2-device data mesh on the global
    batches: (losses, flat params, {bn path: array})."""
    trainer = JParallelTrainer(jnet, mesh=jbuild_mesh(data=2, devices=jax.devices()[:2]))
    losses = []
    for b in batches:
        trainer._fit_batch(JDataSet(b["x"], b["y"], labels_mask=b.get("lm")))
        losses.append(float(jnet.score_))
    bn = {f"bn/{k}/{s}": np.asarray(v[s]) for k, v in jnet.bn_state.items()
          for s in ("mean", "var")}
    return np.asarray(losses), np.asarray(jnet.params().numpy()), bn


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Launch the two-rank gang over every case, then fit the references;
    returns {case: (rank results, reference, initial flat params, sizes)}."""
    d = tmp_path_factory.mktemp("torch_mp")
    cases = _cases()
    specs, ports = [], {}
    for name, (kind, trainer, jnet, batches) in cases.items():
        state = {"params": jnet.params_, "bn": jnet.bn_state, "updater": jnet.updater_state}
        flat = {f"state/{k}": v for k, v in _flatten(jax.tree.map(np.asarray, state)).items()}
        for i, b in enumerate(batches):
            flat.update({f"{key}{i}": a for key, a in b.items()})
        np.savez(d / f"{name}.npz", **flat)
        specs.append({"name": name, "kind": kind, "trainer": trainer,
                      "conf": jnet.conf.to_json(), "steps": len(batches)})
        ports[name] = port_graph(jnet) if kind == "graph" else port_net(jnet)
    (d / "cases.json").write_text(json.dumps(specs))
    results = launcher.launch(f"{WORKERS}:run_cases", n_processes=2, platform="cpu",
                              extra_env={**ENV, "TDL_MP_DIR": str(d)}, timeout=300)
    for r in results:
        assert r.returncode == 0, f"rank {r.rank} failed:\n{r.stderr[-3000:]}"
    out = {}
    for name, (kind, _, jnet, batches) in cases.items():
        before = np.asarray(jnet.params().numpy(), np.float64)
        sizes = [(f"{i}.{k}", w.numel()) for i, k, w in ports[name]._param_entries()]
        ranks = [dict(np.load(d / f"{name}.rank{r}.npz")) for r in range(2)]
        ref = None if name == "dropout" else _jax_fit(kind, jnet, batches)
        out[name] = (ranks, ref, before, sizes, ports[name], batches)
    return out


def _updates_close(got, want, before, sizes, rel=UPDATE_REL):
    off = 0
    for name, n in sizes:
        g = got[off:off + n].astype(np.float64) - before[off:off + n]
        w = want[off:off + n].astype(np.float64) - before[off:off + n]
        nrm = np.linalg.norm(w)
        err = np.linalg.norm(g - w) / (nrm if nrm > 0 else 1.0)
        assert err <= rel, f"{name}: update error {err:.2e} of its norm"
        off += n
    assert off == len(got)


def _check_against_jax(gang, name):
    ranks, (losses, params, bn), before, sizes, _, _ = gang[name]
    for k in ranks[0]:  # the replicas stay equal, bit for bit
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=LOSS_REL, atol=0)
    _updates_close(ranks[0]["params"], params, before, sizes)
    for k, v in bn.items():
        np.testing.assert_allclose(ranks[0][k], v, rtol=LOSS_REL, atol=1e-7, err_msg=k)
    return ranks


def test_batchnorm_mln_matches_jax_parallel_trainer(gang):
    """Each rank feeds 8 of 16 rows; the running mean and variance are the
    global batch's, as GSPMD makes them."""
    _check_against_jax(gang, "bn")


def test_ragged_label_mask_with_unequal_live_counts_matches_jax(gang):
    """Rank 0 holds 23 live steps of 39, rank 1 holds 7: the mean of the
    two ranks' means would be off; the live-count weighting is not."""
    _check_against_jax(gang, "masked")


def test_dense_computation_graph_matches_jax(gang):
    _check_against_jax(gang, "graph")


def test_parallel_trainer_remainder_batch_matches_jax(gang):
    """ParallelTrainer: every rank feeds the global batch of 15; 14 rows go
    data-parallel and the last through one ordinary step on each rank."""
    ranks = _check_against_jax(gang, "remainder")
    assert int(ranks[0]["iteration"]) == 4  # two batches, each main + remainder


def test_dropout_two_ranks_equal_one_process_fit(gang):
    """Each rank takes its rows of the mask drawn at the global shape: the
    two-rank fit is the port's one-process fit on the global batches."""
    from deeplearning4j_tpu_torch.data import DataSet

    ranks, _, before, sizes, net, batches = gang["dropout"]
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    losses = []
    for b in batches:
        net._fit_batch(DataSet(b["x"], b["y"]))
        losses.append(net.score_)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=LOSS_REL, atol=0)
    _updates_close(ranks[0]["params"], net.params().detach().numpy(), before, sizes)
    assert abs(losses[0] - losses[1]) > 0  # the masks did something


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mp_col")
    results = launcher.launch(f"{WORKERS}:collectives_and_exchange", n_processes=2,
                              platform="cpu", extra_env={**ENV, "TDL_MP_DIR": str(d)},
                              timeout=180)
    for r in results:
        assert r.returncode == 0, f"rank {r.rank} failed:\n{r.stderr[-3000:]}"
    return [dict(np.load(d / f"collectives.rank{r}.npz")) for r in range(2)]


def test_process_collectives_allgather(collectives):
    for r in collectives:
        assert int(r["world"]) == 2
        assert list(r["ranks"]) == [0, 1]
        assert list(r["lens"]) == [10, 110]  # rank-dependent payloads crossed
        assert float(r["lr"]) == 0.1
    assert list(collectives[0]["gathered"]) == [0.0, 1.0]
    assert len(collectives[1]["gathered"]) == 0


def test_encoded_gradient_exchange_across_processes(collectives):
    """Both ranks decode the same summed sparse update, equal to the JAX
    accumulator's over the same two gradients; residuals stay per rank."""
    from deeplearning4j_tpu.parallel.collectives import FakeCollectives
    from deeplearning4j_tpu.parallel.compression import EncodedGradientsAccumulator
    import threading

    r0, r1 = collectives
    np.testing.assert_array_equal(r0["upd1"], r1["upd1"])
    np.testing.assert_array_equal(r0["upd2"], r1["upd2"])
    g_all = np.random.RandomState(42).randn(2, 257).astype(np.float32) * 0.3
    router = FakeCollectives(world_size=2, timeout=10.0)
    want = {}

    def run(rank):
        acc = EncodedGradientsAccumulator(router.worker(rank), threshold=0.2)
        want[rank] = (acc.exchange(g_all[rank]), acc.exchange(g_all[rank]), acc.residual)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for rank, r in enumerate(collectives):
        np.testing.assert_array_equal(r["upd1"], want[rank][0])
        np.testing.assert_array_equal(r["upd2"], want[rank][1])
        np.testing.assert_array_equal(r["residual"], want[rank][2])
