"""``verify_checkpoint`` and ``lineage_state`` of the port against the JAX
package's on the same directories: every key of the verdict but ``seconds``
is equal, deep and shallow, for each path shape an operator may hold (the
checkpointer root, the lineage dir, a generation dir).

The directories are written by the port's ``TrainingCheckpointer`` (a small
MultiLayerNetwork on the CPU) and then damaged as a crash or a disk would:
a committed lineage, a kill at each commit boundary, a bit-flipped shard, a
tampered manifest, a tampered ``train_state.json``, a legacy flat
checkpoint, a quarantined generation, an empty and a missing directory.
"""

import json
import os

import numpy as np
import pytest

from deeplearning4j_tpu.serde import checkpoint as J
from deeplearning4j_tpu_torch.common import faults
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serde import checkpoint as T
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

CASES = ("committed", "torn_shard", "torn_manifest", "torn_commit", "torn_pointer", "bitflip",
         "tampered_manifest", "tampered_meta", "legacy_flat", "quarantined", "empty", "missing")


class _Killed(BaseException):
    """What ``os._exit`` does to the process, raised instead."""


def _killed(code):
    raise _Killed(code)


def _net():
    conf = (TC.NeuralNetConfiguration.Builder().seed(2).updater(TU.Adam(1e-2)).list()
            .layer(TC.DenseLayer(n_in=4, n_out=64, activation="tanh"))
            .layer(TC.OutputLayer(n_out=3, activation="softmax", loss="mcxent")).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _fit(net):
    rs = np.random.RandomState(net.iteration)
    net.fit(rs.randn(8, 4).astype(np.float32), np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)])


def _build(case, root, monkeypatch):
    """Write the case's directory under ``root``; returns the generation dir
    a caller would hold (None when there is none)."""
    if case == "missing":
        return None
    os.makedirs(root)
    if case == "empty":
        return None
    net = _net()
    _fit(net)
    if case == "legacy_flat":
        lineage = os.path.join(root, "latest")
        os.makedirs(lineage)
        arrays = {"params/0/W": np.arange(8, dtype=np.float32)}
        blob = {"__save_id__": np.asarray(3, np.int64)}
        for path, a in arrays.items():
            blob[f"{path}|0"] = a
            blob[f"{path}|0|idx"] = np.asarray([[0, a.size]], np.int64)
            blob[f"{path}|0|shape"] = np.asarray(a.shape, np.int64)
        with open(os.path.join(lineage, "shard_0.npz"), "wb") as f:
            np.savez(f, **blob)
        with open(os.path.join(lineage, "train_state.json"), "w") as f:
            json.dump({"iteration": 3, "epoch": 0, "process_count": 1}, f)
        return None
    ck = T.TrainingCheckpointer(root, async_write=False)
    ck.save(net)
    _fit(net)
    if case.startswith("torn_"):
        monkeypatch.setattr(faults.os, "_exit", _killed)
        monkeypatch.setenv(faults.ENV_SPEC, f"torn_ckpt@stage={case[5:]}")
        with pytest.raises(_Killed):
            ck.save(net)
        monkeypatch.delenv(faults.ENV_SPEC)
        return os.path.join(root, "latest", "gen-00000002")
    gendir = ck.save(net)
    if case == "bitflip":
        shard = os.path.join(gendir, "shard_0.npz")
        raw = bytearray(open(shard, "rb").read())
        w = net.params_["0"]["W"].detach().numpy()
        raw[bytes(raw).index(w.tobytes()) + 100] ^= 0x10
        open(shard, "wb").write(bytes(raw))
    elif case in ("tampered_manifest", "tampered_meta"):
        path = os.path.join(gendir, "manifest_0.json" if case == "tampered_manifest"
                            else "train_state.json")
        doc = json.load(open(path))
        if case == "tampered_manifest":
            doc["entries"]["params/0/W|0"] += 1
        else:
            doc["epoch"] += 1
        json.dump(doc, open(path, "w"))
    elif case == "quarantined":
        return T.quarantine_generation(gendir, "shard_crc")
    return gendir


def _verdicts(mod, path):
    out = []
    for deep in (True, False):
        v = mod.verify_checkpoint(path, deep=deep)
        v.pop("seconds")
        out.append(v)
    return out


@pytest.mark.parametrize("case", CASES)
def test_port_and_jax_verdicts_agree(case, tmp_path, monkeypatch):
    root = str(tmp_path / "ck")
    gendir = _build(case, root, monkeypatch)
    shapes = [root, os.path.join(root, "latest")] + ([gendir] if gendir else [])
    for path in shapes:
        assert _verdicts(T, path) == _verdicts(J, path), (case, path)
    assert T.lineage_state(root) == J.lineage_state(root)
    reasons = {path: T.verify_checkpoint(path)["reason"] for path in shapes}
    expect = {"committed": None, "torn_pointer": None, "torn_shard": None,
              "torn_manifest": None, "torn_commit": None, "bitflip": "shard_crc",
              "tampered_manifest": "manifest_crc", "tampered_meta": "meta_crc",
              "legacy_flat": None, "quarantined": None, "empty": "no_checkpoint",
              "missing": "no_checkpoint"}[case]
    assert reasons[root] == expect
    if case.startswith("torn_") and case != "torn_pointer":
        assert reasons[gendir] == "uncommitted"  # the torn generation itself
    if case == "quarantined":
        assert reasons[gendir] == "quarantined"
