"""The port's sharded-parameter training across real process boundaries, held
to the JAX package.

Four gloo ranks on the CPU, started through the port's
``parallel.launcher.launch`` (workers in ``tests/torch_sharded_workers.py``),
train under ``MultiProcessTrainer(mesh_layout=SpecLayout(...))`` (each rank
keeps its blocks of the parameters and the updater state) or
``ParallelTrainer(sharding_rules=alternating_dense_rules())``, from the JAX
network's initial weights and on the same global batches as:

- the JAX ``ParallelTrainer`` with the same layout over the CPU mesh's first
  four devices (dropout 0), and
- the port's one-process fit on the global batches (every case, dropout
  0.5 included: the JAX package draws other random bits; and a
  MaxNormConstraint, which the two packages' JSON cannot carry).

Limits are those of the data-parallel phase on the card: loss within 1e-5
relative, each parameter's update within 1e-3 of its norm. Each rank's
resident bytes at rest equal JAX's ``PartitionReport`` per device. One gang
for every case.
"""

import json
import os

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn.attention_layers import SelfAttentionLayer as JSelfAttention
from deeplearning4j_tpu.nn.updaters import Adam, Sgd
from deeplearning4j_tpu.parallel import ParallelTrainer as JParallelTrainer
from deeplearning4j_tpu.parallel.mesh import mesh_from_shape as jmesh_from_shape
from deeplearning4j_tpu.parallel.partition import Partitioner as JPartitioner
from deeplearning4j_tpu.parallel.partition import SpecLayout as JSpecLayout
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.parallel import launcher
from deeplearning4j_tpu_torch.serde.compiled import _flatten
from deeplearning4j_tpu_torch.serde.net_state import snapshot
from torch_mln_helpers import port_net
from torch_sharded_workers import _constrain
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

WORKERS = os.path.join(os.path.dirname(__file__), "torch_sharded_workers.py")
LOSS_REL = 1e-5
UPDATE_REL = 1e-3
ENV = {"TDL_MATMUL_PRECISION": "float32", "OMP_NUM_THREADS": "1"}
B, C, T = 8, 16, 12


def _mln(layers, updater, input_type, seed=7, dropout=None, clip=None):
    b = JC.NeuralNetConfiguration.Builder().seed(seed).updater(updater)
    if dropout is not None:
        b = b.dropout(dropout)
    if clip is not None:
        b = b.gradient_normalization("ClipL2PerLayer", clip)
    lb = b.list()
    for layer in layers:
        lb = lb.layer(layer)
    return JMLN(lb.set_input_type(input_type).build()).init()


def _attention(dropout=None, clip=None):
    return _mln([JSelfAttention(n_out=C, n_heads=2, head_size=8),
                 JC.GlobalPoolingLayer(pooling_type="avg"),
                 JC.OutputLayer(n_out=4, activation="softmax", loss="mcxent")],
                Adam(1e-2), JC.InputType.recurrent(C, T), dropout=dropout, clip=clip)


def _seq_batches(steps, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        lengths = np.concatenate([[T], rs.randint(4, T + 1, B - 1)])
        out.append({"x": rs.randn(B, C, T).astype(np.float32),
                    "y": np.eye(4, dtype=np.float32)[rs.randint(0, 4, B)],
                    "fm": (np.arange(T)[None] < lengths[:, None]).astype(np.float32)})
    return out


def _img_batches(steps, seed):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(B, 2, 6, 6).astype(np.float32),
             "y": np.eye(4, dtype=np.float32)[rs.randint(0, 4, B)]} for _ in range(steps)]


def _ff_batches(steps, seed):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(B, 6).astype(np.float32),
             "y": np.eye(4, dtype=np.float32)[rs.randint(0, 4, B)]} for _ in range(steps)]


def _cases():
    bn = _mln([JC.ConvolutionLayer(n_out=4, kernel_size=(3, 3), has_bias=False),
               JC.BatchNormalization(activation="relu"),
               JC.DenseLayer(n_out=8, activation="relu"),
               JC.OutputLayer(n_out=4, activation="softmax", loss="mcxent")],
              Sgd(0.1), JC.InputType.convolutional(6, 6, 2))
    dense = _mln([JC.DenseLayer(n_in=6, n_out=8, activation="tanh"),
                  JC.DenseLayer(n_out=8, activation="tanh"),
                  JC.OutputLayer(n_out=4, activation="softmax", loss="mcxent")],
                 Adam(1e-2), JC.InputType.feed_forward(6))
    # name: (spec, JAX network, batches, held to JAX)
    return {
        "attn_122": ({"layout": [1, 2, 2]}, _attention(), _seq_batches(3, 1), True),
        "attn_221": ({"layout": [2, 2, 1]}, _attention(), _seq_batches(3, 2), True),
        "attn_122_dropout": ({"layout": [1, 2, 2]}, _attention(dropout=0.5),
                             _seq_batches(3, 3), False),
        "attn_221_dropout": ({"layout": [2, 2, 1]}, _attention(dropout=0.5),
                             _seq_batches(3, 4), False),
        "bn_fsdp4": ({"layout": [1, 4, 1]}, bn, _img_batches(3, 5), True),
        "clip_l2": ({"layout": [1, 2, 2]},
                    _attention(clip=0.05),
                    _seq_batches(3, 6), True),
        "rules_model2": ({"rules": 2}, dense, _ff_batches(3, 7), False),
        "max_norm": ({"layout": [1, 2, 2], "max_norm": 0.3}, _dense(), _ff_batches(3, 8),
                     False),
    }


def _dense():
    return _mln([JC.DenseLayer(n_in=6, n_out=8, activation="tanh"),
                 JC.OutputLayer(n_out=4, activation="softmax", loss="mcxent")],
                Adam(1e-1), JC.InputType.feed_forward(6))


def _jds(b):
    return JDataSet(b["x"], b["y"], features_mask=b.get("fm"))


def _jax_fit(spec, jnet, batches):
    """The JAX ParallelTrainer with the case's layout over 4 CPU devices:
    (losses, {path: array} of the final state, per-device bytes)."""
    d, f, t = spec["layout"]
    mesh = jmesh_from_shape({"data": d, "fsdp": f, "tp": t}, devices=jax.devices()[:4])
    trainer = JParallelTrainer(jnet, mesh_layout=JPartitioner(JSpecLayout(d, f, t), mesh=mesh))
    losses = []
    for b in batches:
        trainer._fit_batch(_jds(b))
        losses.append(float(jnet.score_))
    dev0 = mesh.devices.flat[0]
    held = sum(int(sh.data.nbytes) for leaf in jax.tree.leaves(jnet.params_)
               for sh in leaf.addressable_shards if sh.device == dev0)
    held_opt = sum(int(sh.data.nbytes) for leaf in jax.tree.leaves(jnet.updater_state)
                   for sh in leaf.addressable_shards if sh.device == dev0)
    rep = trainer.partition_report
    return np.asarray(losses), _state(jnet), (held, held_opt, rep)


def _state(jnet, markers=False):
    """{path: array} of a JAX network's state (``markers``: with the
    flattening's empty-dict entries, which the workers' unflatten needs)."""
    tree = {"params": jnet.params_, "updater": jnet.updater_state, "bn": jnet.bn_state}
    return {k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, tree)).items()
            if markers or "__EMPTY" not in k}


def _port_fit(tnet, batches):
    losses = []
    for b in batches:
        tnet.fit(DataSet(b["x"], b["y"], features_mask=b.get("fm")))
        losses.append(tnet.score_)
    return np.asarray(losses), snapshot(tnet)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sharded")
    cases = _cases()
    specs, out = [], {}
    for name, (spec, jnet, batches, _) in cases.items():
        before = _state(jnet)
        flat = {f"state/{k}": v for k, v in _state(jnet, markers=True).items()}
        for i, b in enumerate(batches):
            flat.update({f"{key}{i}": a for key, a in b.items()})
        np.savez(d / f"{name}.npz", **flat)
        specs.append({"name": name, "kind": "mln", "conf": jnet.conf.to_json(),
                      "steps": len(batches), **spec})
        tnet = port_net(jnet)
        if "max_norm" in spec:
            _constrain(tnet, spec["max_norm"])
        out[name] = {"before": before, "port": _port_fit(tnet, batches)}
    (d / "cases.json").write_text(json.dumps(specs))
    results = launcher.launch(f"{WORKERS}:run_cases", n_processes=4, platform="cpu",
                              extra_env={**ENV, "TDL_MP_DIR": str(d)}, timeout=300)
    for r in results:
        assert r.returncode == 0, f"rank {r.rank} failed:\n{r.stderr[-3000:]}"
    for name, (spec, jnet, batches, to_jax) in cases.items():
        out[name]["ranks"] = [dict(np.load(d / f"{name}.rank{r}.npz")) for r in range(4)]
        out[name]["jax"] = _jax_fit(spec, jnet, batches) if to_jax else None
    return out


def _updates_close(got, want, before, rel=UPDATE_REL):
    for k in want:
        if not k.startswith("params/"):
            continue
        g = got[f"state/{k}"].astype(np.float64) - before[k]
        w = want[k].astype(np.float64) - before[k]
        nrm = np.linalg.norm(w)
        err = np.linalg.norm(g - w) / (nrm if nrm > 0 else 1.0)
        assert err <= rel, f"{k}: update error {err:.2e} of its norm"


def _check(gang, name, against_jax=True):
    case = gang[name]
    ranks = case["ranks"]
    for r in ranks[1:]:  # every rank gathers the same whole state
        for k in ranks[0]:
            if k.startswith("state/") or k == "losses":
                np.testing.assert_array_equal(ranks[0][k], r[k], err_msg=k)
    losses, state = case["port"]
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=LOSS_REL, atol=0)
    _updates_close(ranks[0], state, case["before"])
    for k in state:
        if k.startswith("bn/"):
            np.testing.assert_allclose(ranks[0][f"state/{k}"], state[k], rtol=LOSS_REL,
                                       atol=1e-7, err_msg=k)
    if against_jax:
        jlosses, jstate, _ = case["jax"]
        np.testing.assert_allclose(ranks[0]["losses"], jlosses, rtol=LOSS_REL, atol=0)
        _updates_close(ranks[0], jstate, case["before"])
        for k in jstate:
            if k.startswith("bn/"):
                np.testing.assert_allclose(ranks[0][f"state/{k}"], jstate[k], rtol=LOSS_REL,
                                           atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["attn_122", "attn_221"])
def test_attention_mln_under_a_layout_matches_jax_and_one_process(gang, name):
    """(data, fsdp, tp) = (1, 2, 2) and (2, 2, 1): 3 Adam steps with a ragged
    features mask, each rank holding its blocks of the weights and of m, v."""
    _check(gang, name)


@pytest.mark.parametrize("name", ["attn_122_dropout", "attn_221_dropout"])
def test_dropout_under_a_layout_matches_the_one_process_fit(gang, name):
    """Dropout 0.5 draws at the global shape, each rank taking the rows it
    computes: the one-process fit's masks."""
    _check(gang, name, against_jax=False)


def test_batchnorm_net_under_fsdp4_keeps_global_running_statistics(gang):
    """Conv -> BN -> Dense -> Output, fsdp=4: rows split four ways, the BN
    moments (and running statistics) of the global batch."""
    _check(gang, "bn_fsdp4")


def test_clip_l2_per_layer_reads_the_whole_layer_norm(gang):
    """ClipL2PerLayer (threshold 0.05, so every layer clips) under (1, 2, 2):
    each layer's norm is the whole gradient's, not a block's."""
    _check(gang, "clip_l2")


def test_alternating_dense_rules_on_a_model_axis(gang):
    """ParallelTrainer(sharding_rules=alternating_dense_rules()) on a data=2 x
    model=2 mesh: even dense layers split by columns, odd by rows."""
    _check(gang, "rules_model2", against_jax=False)
    rank0 = gang["rules_model2"]["ranks"][0]
    whole = sum(v.nbytes for k, v in gang["rules_model2"]["before"].items()
                if k.startswith("params/"))
    assert rank0["held"] < whole


def test_max_norm_constraint_reads_the_whole_kernel(gang):
    """MaxNormConstraint(0.3) on a Dense kernel split over fsdp and tp: each
    output unit's norm is the whole column's (the step constrains the
    gathered kernel and keeps its block)."""
    _check(gang, "max_norm", against_jax=False)
    before = gang["max_norm"]["before"]["params/0/W"]
    got = gang["max_norm"]["ranks"][0]["state/params/0/W"]
    assert np.linalg.norm(before, axis=0).max() > 0.3
    assert np.linalg.norm(got, axis=0).max() <= 0.3 + 1e-6


@pytest.mark.parametrize("name", ["attn_122", "attn_221", "bn_fsdp4"])
def test_bytes_per_rank_equal_jax_partition_report(gang, name):
    """Each rank's parameter and updater bytes at rest equal what JAX's
    partitioned arrays hold on one device, and the port's report equals
    JAX's totals."""
    held, held_opt, rep = gang[name]["jax"][2]
    for r in gang[name]["ranks"]:
        assert int(r["held"]) == held
        assert int(r["held_opt"]) == held_opt
        total, per_rank, opt = (int(v) for v in r["report"])
        assert (total, per_rank, opt) == (rep.params_bytes_total, held, held_opt)
        assert per_rank == rep.per_device_params_bytes
