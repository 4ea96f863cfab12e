"""Worker targets of the port's multi-process tests (``test_torch_multiprocess.py``).

Each function runs in a worker process that ``deeplearning4j_tpu_torch.
parallel.launcher`` started and initialised (gloo, on the CPU). The test
process writes the cases into ``TDL_MP_DIR``: ``cases.json`` (for each case
its network's JSON configuration, trainer and steps) and ``<case>.npz``
(the JAX network's initial state, flattened to ``/``-joined paths, and the
global batches ``x<i>``, ``y<i>``, ``lm<i>``). Each rank writes
``<case>.rank<r>.npz``: the losses, the final parameters in ``params()``
order and the BN statistics. Only the port and numpy are imported here.
"""

import json
import os

import numpy as np


def _dir():
    return os.environ["TDL_MP_DIR"]


def _load(case):
    with np.load(os.path.join(_dir(), f"{case}.npz")) as z:
        return {k: z[k] for k in z.files}


def _build(spec, arrays):
    import torch

    from deeplearning4j_tpu_torch.models.weights import cg_params_from_jax, mln_params_from_jax
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.parallel.launcher import local_device
    from deeplearning4j_tpu_torch.serde.compiled import _unflatten

    torch.set_num_threads(1)
    state = _unflatten({k[len("state/"):]: v for k, v in arrays.items()
                        if k.startswith("state/")})
    if spec["kind"] == "graph":
        conf = ComputationGraphConfiguration.from_json(spec["conf"])
        net = ComputationGraph(conf, device=local_device()).init()
        return cg_params_from_jax(net, state["params"], state["bn"], state["updater"])
    conf = MultiLayerConfiguration.from_json(spec["conf"])
    net = MultiLayerNetwork(conf, device=local_device()).init()
    return mln_params_from_jax(net, state["params"], state["bn"], state["updater"])


def _batch(arrays, step, rows=slice(None)):
    from deeplearning4j_tpu_torch.data import DataSet

    def get(name):
        a = arrays.get(f"{name}{step}")
        return None if a is None else a[rows]

    return DataSet(get("x"), get("y"), labels_mask=get("lm"))


def _state(net):
    bn = {f"bn/{k}/{s}": getattr(m, s).detach().cpu().numpy()
          for k, m in net.bn_state.items() for s in ("mean", "var")}
    return {"params": net.params().detach().cpu().numpy(), **bn}


def run_cases():
    """Every case of ``cases.json``: a fit over the global batches with
    ``MultiProcessTrainer`` (each rank feeds its half) or ``ParallelTrainer``
    (each rank feeds the whole global batch)."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.trainer import MultiProcessTrainer, ParallelTrainer

    rank, world = dist.get_rank(), dist.get_world_size()
    with open(os.path.join(_dir(), "cases.json")) as f:
        cases = json.load(f)
    for spec in cases:
        arrays = _load(spec["name"])
        net = _build(spec, arrays)
        losses = []
        if spec["trainer"] == "multiprocess":
            trainer = MultiProcessTrainer(net)
        else:
            trainer = ParallelTrainer(net)
        for step in range(spec["steps"]):
            if spec["trainer"] == "multiprocess":
                b = arrays[f"x{step}"].shape[0] // world
                ds = _batch(arrays, step, slice(rank * b, (rank + 1) * b))
            else:
                ds = _batch(arrays, step)
            trainer.fit([ds])
            losses.append(net.score_)
        np.savez(os.path.join(_dir(), f"{spec['name']}.rank{rank}.npz"),
                 losses=np.asarray(losses, np.float64), iteration=net.iteration,
                 **_state(net))


def collectives_and_exchange():
    """``ProcessCollectives`` (allgather, broadcast, gather, barrier) and two
    rounds of ``EncodedGradientsAccumulator.exchange`` between the ranks."""
    from deeplearning4j_tpu_torch.parallel.compression import EncodedGradientsAccumulator
    from deeplearning4j_tpu_torch.parallel.launcher import ProcessCollectives

    col = ProcessCollectives()
    rank = col.rank
    blobs = col.allgather("smoke", {"rank": rank, "payload": "x" * (10 + rank * 100)})
    conf = col.broadcast("conf", {"lr": 0.1} if rank == 0 else None)
    gathered = col.gather("scores", rank * 1.0)
    col.barrier("done")
    rs = np.random.RandomState(42)
    g_all = rs.randn(2, 257).astype(np.float32) * 0.3
    acc = EncodedGradientsAccumulator(col, threshold=0.2)
    u1 = acc.exchange(g_all[rank])
    u2 = acc.exchange(g_all[rank])
    np.savez(os.path.join(_dir(), f"collectives.rank{rank}.npz"),
             world=col.world, ranks=[b["rank"] for b in blobs],
             lens=[len(b["payload"]) for b in blobs], lr=conf["lr"],
             gathered=np.asarray(gathered if gathered is not None else [], np.float64),
             upd1=u1, upd2=u2, residual=acc.residual)
