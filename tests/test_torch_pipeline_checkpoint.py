"""The pipeline train state through the checkpoint lineage, held bit for bit.

One gang of four gloo ranks on the CPU (``tests/torch_pipeline_workers.py``
``run_cases``, case ``checkpoint``):

- ``PipelineParallelTrainer`` under ``SpecLayout(data=2, pipe=2)`` trains
  one step and saves through ``trainer.checkpointer``;
- the restore onto ``PipelinePartitioner(SpecLayout(data=2, fsdp=2))`` is
  refused without ``reshard=True`` (naming it), and with it restores the
  parameters and Adam's moments bit for bit (both layouts chunk the same
  leading layer dim); that state, saved under fsdp=2, restores back onto
  pipe=2 bit for bit;
- a lineage of the JAX package's ``PipelineParallelTrainer`` (same layout,
  four CPU devices, written here) restores into the gang bit for bit, and
  the gang's lineage restores into the JAX trainer bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.models import transformer as J
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.parallel import pipeline as JPP
from deeplearning4j_tpu.parallel.mesh import mesh_from_shape as jmesh_from_shape
from deeplearning4j_tpu.parallel.partition import PipelinePartitioner as JPipelinePartitioner
from deeplearning4j_tpu.parallel.partition import SpecLayout as JSpecLayout
from deeplearning4j_tpu_torch.parallel import launcher
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

WORKERS = os.path.join(os.path.dirname(__file__), "torch_pipeline_workers.py")
ENV = {"TDL_MATMUL_PRECISION": "float32", "OMP_NUM_THREADS": "1"}
LR = 1e-2


def _jcfg():
    return J.TransformerConfig(vocab_size=64, max_len=32, d_model=16, n_heads=2, n_layers=6,
                               d_ff=32, dropout=0.0, param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {"tokens": rs.randint(0, 64, (16, 16)).astype(np.int32),
            "labels": rs.randint(0, 64, (16, 16)).astype(np.int32)}


def _jtrainer(seed):
    mesh = jmesh_from_shape({"pipe": 2, "data": 2, "fsdp": 1, "tp": 1}, devices=jax.devices()[:4])
    return JPP.PipelineParallelTrainer(
        J.init_params(jax.random.key(seed), _jcfg()), _jcfg(), JAdam(LR),
        JPipelinePartitioner(JSpecLayout(data=2, pipe=2), mesh=mesh), n_microbatches=4)


def _jstate(net):
    """{checkpoint path: array} of a JAX pipeline net's state."""
    out = {f"params/{top}/{k}": np.asarray(v) for top, d in net.params_.items()
           for k, v in d.items()}
    out.update({f"updater/{slot}/{top}/{k}": np.asarray(v)
                for slot, tree in net.updater_state.items() for top, d in tree.items()
                for k, v in d.items()})
    return out


def _canonical(seed):
    tree = JPP.canonical_pp_params(J.init_params(jax.random.key(seed), _jcfg()))
    return {f"{top}/{k}": np.asarray(v) for top, d in tree.items() for k, v in d.items()}


@pytest.fixture(scope="module")
def lineages(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pipeline_ckpt")
    dirs = {k: str(d / k) for k in ("port", "fsdp", "jax")}
    ta = _jtrainer(3)
    ta._fit_batch({k: jnp.asarray(v) for k, v in _batch(5).items()})
    assert ta.checkpointer(dirs["jax"], async_write=False).save(ta.net)
    spec = {"name": "checkpoint", "kind": "checkpoint", "ranks": 4, "M": 4, "lr": LR,
            "dirs": dirs}
    arrays = {**{f"p/{k}": v for k, v in _canonical(0).items()},
              **{f"q/{k}": v for k, v in _canonical(7).items()},
              **{f"b/{k}": v for k, v in _batch(1).items()}}
    np.savez(d / "checkpoint.npz", **arrays)
    (d / "cases.json").write_text(json.dumps([spec]))
    results = launcher.launch(f"{WORKERS}:run_cases", n_processes=4, platform="cpu",
                              extra_env={**ENV, "TDL_MP_DIR": str(d)}, timeout=240)
    for r in results:
        assert r.returncode == 0, f"rank {r.rank} failed:\n{r.stderr[-3000:]}"
    ranks = [dict(np.load(d / f"checkpoint.rank{r}.npz")) for r in range(4)]
    return {"dirs": dirs, "ranks": ranks, "jax": _jstate(ta.net),
            "jax_iteration": ta.net.iteration}


def _part(rank, prefix):
    return {k[len(prefix) + 1:]: v for k, v in rank.items() if k.startswith(prefix + "/")}


def _bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_pipe_lineage_refuses_fsdp_restore_without_reshard(lineages):
    for r in lineages["ranks"]:
        msg = str(r["refused"])
        assert "reshard=True" in msg and "pipe=2" in msg, msg


def test_pipe_to_fsdp_and_back_bit_for_bit(lineages):
    """Parameters and both Adam moments, pipe=2 -> fsdp=2 -> pipe=2."""
    for r in lineages["ranks"]:
        saved = _part(r, "saved")
        assert any(k.startswith("updater/m/blocks/") for k in saved)
        _bitwise(_part(r, "fsdp"), saved)
        _bitwise(_part(r, "back"), saved)
        assert int(r["fsdp_rows"]) == 3  # each fsdp rank holds half of the 6 layers


def test_jax_lineage_restores_into_the_port_bit_for_bit(lineages):
    for r in lineages["ranks"]:
        _bitwise(_part(r, "jax"), lineages["jax"])
        assert int(r["jax_iteration"]) == lineages["jax_iteration"] == 1


def test_port_lineage_restores_into_the_jax_trainer_bit_for_bit(lineages):
    tb = _jtrainer(11)
    assert tb.checkpointer(lineages["dirs"]["port"], async_write=False).restore(tb.net)
    _bitwise(_jstate(tb.net), _part(lineages["ranks"][0], "saved"))
    assert tb.net.iteration == 1
