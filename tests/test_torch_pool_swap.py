"""``ServingPool.swap_model``'s checkpoint preflight on the port (the JAX
package's ``tests/test_pool.py::test_swap_model_preflight_rejects_corrupt_checkpoint``
on the port's own checkpoints).

The pool deep-verifies ``ckpt`` with ``serde.checkpoint.verify_checkpoint``
before it spawns anything: a corrupt lineage is refused with the verifier's
reason (``tdl_pool_swap_rejected_total`` +1, no replica spawned, no
rollback); a healthy lineage rolls, and the replicas then serve the
restored network (``tests/torch_pool_workers.py:mln_server`` restores
``TDL_MODEL_CKPT``); a path that holds no checkpoint passes through to the
surge-replica validation.
"""

import json
import os
import pathlib
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
from deeplearning4j_tpu_torch.serde import TrainingCheckpointer, verify_checkpoint
from deeplearning4j_tpu_torch.serving import ServingPool
from torch_pool_workers import mln_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

_WORKERS = str(pathlib.Path(__file__).resolve().parent / "torch_pool_workers.py")


def _pool(tmp_path, target, registry, **kw):
    return ServingPool(f"{_WORKERS}:{target}", workdir=str(tmp_path / "pool"),
                       registry=registry, **kw)


def _counter(reg, name):
    m = reg.get(name)
    return 0.0 if m is None else m.value


def _trained_lineage(root):
    """A checkpoint of ``mln_net`` after three Adam steps; returns the net."""
    net = mln_net()
    rs = np.random.RandomState(1)
    for _ in range(3):
        net.fit(rs.randn(8, 4).astype(np.float32),
                np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)])
    TrainingCheckpointer(root, async_write=False).save(net)
    return net


def test_swap_onto_a_corrupt_lineage_is_refused_before_any_spawn(tmp_path):
    root = str(tmp_path / "ck")
    net = _trained_lineage(root)
    gendir = os.path.join(root, "latest", "gen-00000003")
    shard = os.path.join(gendir, "shard_0.npz")
    raw = bytearray(open(shard, "rb").read())
    raw[bytes(raw).index(net.params_["0"]["W"].detach().numpy().tobytes()) + 8] ^= 0xFF
    open(shard, "wb").write(bytes(raw))
    reg = MetricsRegistry()
    pool = _pool(tmp_path, "mln_server", reg, replicas=1, min_replicas=1)  # NOT started
    for path in (root, os.path.join(root, "latest"), gendir):
        with pytest.raises(ValueError, match="rejected checkpoint.*reason=shard_crc"):
            pool.swap_model(path)
    assert pool.replica_states() == {}
    assert _counter(reg, "tdl_pool_swap_rejected_total") == 3
    assert _counter(reg, "tdl_pool_swap_rollbacks_total") == 0
    assert _counter(reg, "tdl_pool_swap_events_total") == 0


def test_swap_onto_a_healthy_lineage_rolls_and_serves_it(tmp_path):
    root = str(tmp_path / "ck")
    trained = _trained_lineage(root)
    assert verify_checkpoint(root)["ok"]
    reg = MetricsRegistry()
    pool = _pool(tmp_path, "mln_server", reg, replicas=1, min_replicas=1).start()
    try:
        assert pool.wait_ready(90.0)
        res = pool.swap_model(root, ready_timeout=90.0)
        assert res["ok"] and res["swapped"] == 1 and not res["rolled_back"]
        x = np.random.RandomState(6).randn(3, 4).astype(np.float32)
        req = urllib.request.Request(
            f"http://127.0.0.1:{pool.port}/predict", data=json.dumps(x.tolist()).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = json.loads(resp.read())
        np.testing.assert_allclose(body["output"], trained.output(x).numpy(), rtol=0, atol=1e-6)
        assert _counter(reg, "tdl_pool_swap_events_total") == 1
        assert _counter(reg, "tdl_pool_swap_rejected_total") == 0
    finally:
        pool.stop()


def test_a_path_that_is_no_checkpoint_passes_the_preflight(tmp_path):
    """A model-version file (or an empty dir) is not judged: the swap goes
    on to the surge validation (here, an empty pool: nothing to roll)."""
    reg = MetricsRegistry()
    pool = _pool(tmp_path, "swappable_server", reg, replicas=1, min_replicas=1)
    version = tmp_path / "v3.json"
    version.write_text(json.dumps({"scale": 3}))
    (tmp_path / "empty").mkdir()
    for path in (version, tmp_path / "empty"):
        assert verify_checkpoint(str(path))["reason"] == "no_checkpoint"
        assert pool.swap_model(str(path))["ok"]
    assert _counter(reg, "tdl_pool_swap_rejected_total") == 0
