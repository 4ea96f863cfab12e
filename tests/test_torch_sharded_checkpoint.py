"""Layout-stamped sharded checkpoints, held to the JAX package.

Counterpart of ``tests/test_partition.py``'s checkpoint cases and
``tests/test_reshard.py``. One on-disk format: each port rank writes its
blocks into ``shard_<rank>.npz``, a JAX process writes its devices' chunks
into one file, and the chunk indices make the two interchangeable.

- A 4-rank port gang (workers in ``tests/torch_sharded_workers.py``) trains
  the attention MLN under (data, fsdp, tp) = (1, 2, 2) and saves through
  ``trainer.checkpointer``; a 2-rank gang restores it under (1, 2, 1):
  without ``reshard=True`` the restore raises naming both layouts, with it
  parameters and updater state equal the saved ones bit for bit and the
  reshard metrics are recorded.
- JAX lineages (4 devices under (1, 2, 2); 8 devices under (2, 2, 2))
  restore into the 4-rank gang bit for bit (the second with
  ``reshard=True``), and the port's lineage restores into JAX
  ``Partitioner`` s under (1, 2, 2) and, resharded, (2, 2, 2) bit for bit.
- Torn or missing chunks are refused: a shard file short of one leaf's
  chunk (its manifest rewritten to match) fails the coverage check, and a
  missing shard file fails verification.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn.attention_layers import SelfAttentionLayer as JSelfAttention
from deeplearning4j_tpu.nn.updaters import Adam
from deeplearning4j_tpu.parallel import ParallelTrainer as JParallelTrainer
from deeplearning4j_tpu.parallel.mesh import mesh_from_shape as jmesh_from_shape
from deeplearning4j_tpu.parallel.partition import Partitioner as JPartitioner
from deeplearning4j_tpu.parallel.partition import SpecLayout as JSpecLayout
from deeplearning4j_tpu.serde.checkpoint import TrainingCheckpointer as JCheckpointer
from deeplearning4j_tpu_torch.parallel import launcher
from deeplearning4j_tpu_torch.parallel.mesh import Mesh
from deeplearning4j_tpu_torch.parallel.partition import Partitioner, SpecLayout
from deeplearning4j_tpu_torch.serde import checkpoint as TCK
from deeplearning4j_tpu_torch.serde.compiled import _flatten
from deeplearning4j_tpu_torch.serde.net_state import snapshot
from torch_mln_helpers import port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

WORKERS = os.path.join(os.path.dirname(__file__), "torch_sharded_workers.py")
ENV = {"TDL_MATMUL_PRECISION": "float32", "OMP_NUM_THREADS": "1"}
B, C, T = 8, 16, 12


def _jnet():
    conf = (JC.NeuralNetConfiguration.Builder().seed(9).updater(Adam(1e-2)).list()
            .layer(JSelfAttention(n_out=C, n_heads=2, head_size=8))
            .layer(JC.GlobalPoolingLayer(pooling_type="avg"))
            .layer(JC.OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JC.InputType.recurrent(C, T)).build())
    return JMLN(conf).init()


def _batches(steps=2, seed=3):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(B, C, T).astype(np.float32),
             "y": np.eye(4, dtype=np.float32)[rs.randint(0, 4, B)]} for _ in range(steps)]


def _state(jnet, markers=False):
    tree = {"params": jnet.params_, "updater": jnet.updater_state, "bn": jnet.bn_state}
    return {k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, tree)).items()
            if markers or "__EMPTY" not in k}


def _jax_mesh(layout):
    d, f, t = layout
    return jmesh_from_shape({"data": d, "fsdp": f, "tp": t}, devices=jax.devices()[:d * f * t])


def _jax_lineage(path, layout, batches):
    """A JAX ParallelTrainer fit under ``layout`` saved to ``path``: the
    whole state it saved."""
    jnet = _jnet()
    trainer = JParallelTrainer(jnet, mesh_layout=JPartitioner(JSpecLayout(*layout),
                                                              mesh=_jax_mesh(layout)))
    for b in batches:
        trainer._fit_batch(JDataSet(b["x"], b["y"]))
    trainer.checkpointer(str(path), async_write=False).save(jnet)
    return _state(jnet)


def _launch(d, target, n):
    results = launcher.launch(f"{WORKERS}:{target}", n_processes=n, platform="cpu",
                              extra_env={**ENV, "TDL_MP_DIR": str(d)}, timeout=300)
    for r in results:
        assert r.returncode == 0, f"rank {r.rank} failed:\n{r.stderr[-3000:]}"
    return [dict(np.load(d / f"{target.split('_')[1]}.rank{r}.npz")) for r in range(n)]


@pytest.fixture(scope="module")
def lineages(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_ckpt")
    jnet = _jnet()
    batches = _batches()
    flat = {f"state/{k}": v for k, v in _state(jnet, markers=True).items()}
    for i, b in enumerate(batches):
        flat.update({f"{key}{i}": a for key, a in b.items()})
    np.savez(d / "case.npz", **flat)
    (d / "cases.json").write_text(json.dumps([{"name": "case", "kind": "mln",
                                               "conf": jnet.conf.to_json(),
                                               "steps": len(batches)}]))
    jax_states = {"jax122": _jax_lineage(d / "jax122", (1, 2, 2), batches),
                  "jax222": _jax_lineage(d / "jax222", (2, 2, 2), batches)}
    saved = _launch(d, "checkpoint_save", 4)
    resharded = _launch(d, "checkpoint_reshard", 2)
    return d, jax_states, saved, resharded


def _whole(rank_npz, prefix):
    return {k[len(prefix) + 1:]: v for k, v in rank_npz.items() if k.startswith(prefix + "/")}


def _bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_port_lineage_reshards_onto_two_ranks_bit_for_bit(lineages):
    d, _, saved, resharded = lineages
    want = _whole(saved[0], "saved")
    for r in resharded:
        _bitwise(_whole(r, "restored"), want)
        assert int(r["iteration"]) == 2
        assert float(r["reshard_bytes"]) > 0 and int(r["reshard_count"]) == 1
    assert os.listdir(d / "port" / "latest" / TCK._gen_name(2)).count("shard_3.npz") == 1


def test_restore_under_another_layout_without_reshard_names_both(lineages):
    _, _, _, resharded = lineages
    msg = str(resharded[0]["refused"])
    assert "data=1 x fsdp=2 x tp=2" in msg and "data=1 x fsdp=2 x tp=1" in msg
    assert "reshard=True" in msg


@pytest.mark.parametrize("name", ["jax122", "jax222"])
def test_jax_lineage_restores_into_the_port_gang_bit_for_bit(lineages, name):
    _, jax_states, saved, _ = lineages
    for r in saved:
        _bitwise(_whole(r, name), jax_states[name])


@pytest.mark.parametrize("layout,reshard", [((1, 2, 2), False), ((2, 2, 2), True)])
def test_port_lineage_restores_into_a_jax_partitioner_bit_for_bit(lineages, layout, reshard):
    d, _, saved, _ = lineages
    jnet = _jnet()
    part = JPartitioner(JSpecLayout(*layout), mesh=_jax_mesh(layout))
    assert JCheckpointer(str(d / "port"), partitioner=part, reshard=reshard).restore(jnet)
    assert jnet.iteration == 2
    _bitwise(_state(jnet), _whole(saved[0], "saved"))


def _virtual_restore(lineage, layout, rank, reshard=False):
    net = port_net(_jnet())
    part = Partitioner(SpecLayout(*layout),
                       mesh=Mesh.virtual(dict(zip(("data", "fsdp", "tp"), layout)), rank))
    TCK.TrainingCheckpointer(str(lineage), partitioner=part).restore(net, reshard=reshard)
    return net


def test_torn_or_missing_chunks_are_refused(lineages, tmp_path):
    d, _, saved, _ = lineages
    # one rank's blocks of the same layout, restored in this process (a
    # virtual mesh runs no collective): equal to its part of the saved state
    net = _virtual_restore(d / "port", (1, 2, 2), 3)
    blocks = TCK._chunks(net, snapshot(net))[0]
    whole = _whole(saved[0], "saved")
    for path, (idx, _, a) in blocks.items():
        np.testing.assert_array_equal(a, whole[path][tuple(slice(*r) for r in idx)])
    # a shard file short of one leaf's chunk, its manifest rewritten to match
    torn = tmp_path / "torn"
    shutil.copytree(d / "port", torn)
    gendir = torn / "latest" / TCK._gen_name(2)
    with np.load(gendir / "shard_3.npz") as z:
        blob = {k: z[k] for k in z.files if not k.startswith("params/0/Wq|")}
    with open(gendir / "shard_3.npz", "wb") as f:
        np.savez(f, **blob)
    man = json.loads((gendir / "manifest_3.json").read_text())
    man.pop("crc")
    man["entries"] = {k: TCK._array_crc(v) for k, v in blob.items()}
    (gendir / "manifest_3.json").write_text(json.dumps(TCK._self_checksummed(man)))
    assert TCK.verify_checkpoint(str(torn))["ok"]
    with pytest.raises(ValueError, match="does not tile"):
        _virtual_restore(torn, (1, 2, 2), 3)
    # a missing shard file: the generation fails verification
    gone = tmp_path / "gone"
    shutil.copytree(d / "port", gone)
    os.unlink(gone / "latest" / TCK._gen_name(2) / "shard_1.npz")
    assert TCK.verify_checkpoint(str(gone))["reason"] == "shard_missing"
    with pytest.raises(TCK.CheckpointVerifyError):
        _virtual_restore(gone, (1, 2, 2), 0)
