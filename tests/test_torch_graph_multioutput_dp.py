"""A data-parallel ComputationGraph fit with label masks on several outputs,
held to the JAX package's one-process fit on the global batches.

Each output's masked loss is a mean over that output's own live count, and
the outputs' losses are added (``deeplearning4j_tpu/nn/graph.py``'s
``_forward``); the JAX package's GSPMD step over a data mesh makes that the
global step. Two gloo ranks on the CPU (workers in
``tests/torch_parallel_workers.py:run_graph_cases``) each feed half of every
global batch as a MultiDataSet (a DataSet for one output), with ragged masks whose live counts differ
between the ranks and between the outputs: the port's
``common.data_parallel`` weighs each output's loss by the rank's share of
that output's count (the L2 term by 1/W), so the two ranks' objectives sum to
the global loss.

A one-output graph with a ragged mask takes the single-weight path of
before: its gang fit must give the same bits as it did before the
several-output weighting existed (``ONE_OUTPUT_DIGEST``).

Limits: loss and parameters within 1e-5 relative (each parameter's update
within 1e-5 of its norm), from the same weights carried across
(``tests/torch_mln_helpers.py:port_graph``'s ``cg_params_from_jax``).
"""

import hashlib
import json
import os

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.updaters import Adam
from deeplearning4j_tpu_torch.parallel import launcher
from deeplearning4j_tpu_torch.serde.compiled import _flatten
from torch_mln_helpers import port_graph
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

WORKERS = os.path.join(os.path.dirname(__file__), "torch_parallel_workers.py")
REL = 1e-5
ENV = {"TDL_MATMUL_PRECISION": "float32", "OMP_NUM_THREADS": "1"}
B, T, STEPS = 8, 6, 3
# live steps per row: rank 0 holds rows 0-3, rank 1 rows 4-7; the two
# outputs' counts are skewed in opposite directions (a: 23 vs 7, b: 5 vs 23)
LENGTHS = {"a": [6, 6, 5, 6, 1, 2, 1, 3], "b": [1, 2, 1, 1, 6, 5, 6, 6]}
# SHA-256 of the one-output case's final parameters and per-step losses
# (float32 and float64 bytes) from the gang fit of the single-weight path
# before the several-output weighting was added
ONE_OUTPUT_DIGEST = "fcc43e7418dc148db2f2f48a1bd9185902271b61d876bba3a8643fa46c23511d"


def _graph(outputs):
    g = (JC.NeuralNetConfiguration.Builder().seed(11).updater(Adam(1e-2)).graph_builder()
         .add_inputs("x").set_input_types(JC.InputType.recurrent(4, T)))
    g.add_layer("h", JC.LSTM(n_out=8, l2=1e-2), "x")
    g.add_layer("a", JC.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"), "h")
    if "b" in outputs:
        g.add_layer("b", JC.RnnOutputLayer(n_out=2, activation="identity", loss="mse",
                                           l2=1e-2), "h")
    return JCG(g.set_outputs(*outputs).build()).init()


def _batches(outputs, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        b = {"x": rs.randn(B, 4, T).astype(np.float32)}
        for j, o in enumerate(outputs):
            n = 3 if o == "a" else 2
            y = (np.eye(n, dtype=np.float32)[rs.randint(0, n, (B, T))].transpose(0, 2, 1)
                 if o == "a" else rs.randn(B, n, T).astype(np.float32))
            b[f"y{j}"] = np.ascontiguousarray(y)
            b[f"m{j}"] = (np.arange(T)[None] < np.array(LENGTHS[o])[:, None]).astype(np.float32)
        out.append(b)
    return out


def _digest(rank):
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(rank["params"]).tobytes())
    h.update(np.ascontiguousarray(rank["losses"]).tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """One two-rank gang over both cases; returns {case: (rank results, JAX
    network, batches, initial flat parameters, parameter sizes)}."""
    d = tmp_path_factory.mktemp("torch_mo_dp")
    cases = {"two_outputs": ("a", "b"), "one_output": ("a",)}
    specs, out = [], {}
    for name, outputs in cases.items():
        jnet, batches = _graph(outputs), _batches(outputs, seed=len(outputs))
        state = {"params": jnet.params_, "bn": jnet.bn_state, "updater": jnet.updater_state}
        flat = {f"state/{k}": v for k, v in _flatten(jax.tree.map(np.asarray, state)).items()}
        for i, b in enumerate(batches):
            flat.update({f"x{i}" if k == "x" else f"{k}_{i}": a for k, a in b.items()})
        np.savez(d / f"{name}.npz", **flat)
        specs.append({"name": name, "conf": jnet.conf.to_json(), "steps": STEPS,
                      "outputs": len(outputs)})
        sizes = [(f"{n}.{k}", w.numel()) for n, k, w in port_graph(jnet)._param_entries()]
        out[name] = (jnet, batches, np.asarray(jnet.params().numpy(), np.float64), sizes)
    (d / "graph_cases.json").write_text(json.dumps(specs))
    results = launcher.launch(f"{WORKERS}:run_graph_cases", n_processes=2, platform="cpu",
                              extra_env={**ENV, "TDL_MP_DIR": str(d)}, timeout=300)
    for r in results:
        assert r.returncode == 0, f"rank {r.rank} failed:\n{r.stderr[-3000:]}"
    return {name: ([dict(np.load(d / f"{name}.rank{r}.npz")) for r in range(2)], *rest)
            for name, rest in out.items()}


def _jax_fit(jnet, batches, n_out):
    """The JAX graph's one-process fit on the global batches."""
    losses = []
    for b in batches:
        jnet.fit(JMultiDataSet([b["x"]], [b[f"y{j}"] for j in range(n_out)],
                               labels_masks=[b[f"m{j}"] for j in range(n_out)]))
        losses.append(float(jnet.score_))
    return np.asarray(losses), np.asarray(jnet.params().numpy(), np.float64)


def _updates_close(got, want, before, sizes):
    off = 0
    for name, n in sizes:
        g = got[off:off + n].astype(np.float64) - before[off:off + n]
        w = want[off:off + n] - before[off:off + n]
        nrm = np.linalg.norm(w)
        err = np.linalg.norm(g - w) / (nrm if nrm > 0 else 1.0)
        assert err <= REL, f"{name}: update error {err:.2e} of its norm"
        off += n
    assert off == len(got)


def test_two_output_masked_graph_gang_matches_jax_one_process_fit(gang):
    ranks, jnet, batches, before, sizes = gang["two_outputs"]
    # the batches need the per-output weighting: one count for the whole
    # loss would give each rank another share of each output's loss
    counts = np.array([[batches[0][f"m{j}"][r * 4:(r + 1) * 4].sum() for j in range(2)]
                       for r in range(2)])
    assert np.abs(counts / counts.sum(0) - (counts.sum(1) / counts.sum())[:, None]).max() > 0.2
    for k in ranks[0]:  # the replicas stay equal, bit for bit
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    losses, params = _jax_fit(jnet, batches, 2)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=REL, atol=0)
    np.testing.assert_allclose(ranks[0]["params"], params, rtol=REL, atol=REL)
    _updates_close(ranks[0]["params"], params, before, sizes)


def test_one_output_masked_graph_gang_matches_jax(gang):
    ranks, jnet, batches, before, sizes = gang["one_output"]
    np.testing.assert_array_equal(ranks[0]["params"], ranks[1]["params"])
    losses, params = _jax_fit(jnet, batches, 1)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=REL, atol=0)
    _updates_close(ranks[0]["params"], params, before, sizes)


def test_one_output_masked_graph_gang_is_unchanged_bit_for_bit(gang):
    ranks = gang["one_output"][0]
    assert _digest(ranks[0]) == ONE_OUTPUT_DIGEST
