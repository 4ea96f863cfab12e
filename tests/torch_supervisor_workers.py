"""Worker targets of the port's gang-supervisor tests (``test_torch_supervisor.py``).

Each function runs in a worker process that the port's ``GangSupervisor``
spawned through ``parallel.launcher`` (gloo, on the CPU). The test process
writes the network into ``TDL_MP_DIR``: ``<case>.json`` (its JSON
configuration) and ``<case>.npz`` (the JAX network's initial state), so the
port's gang starts from the JAX network's weights. Each rank writes
``out.rank<r>.npz`` under ``TDL_MP_DIR``: the final parameters in
``params()`` order, the iteration it started from, its incarnation and the
world size. Only the port and numpy are imported here.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parallel_workers import _build, _load  # noqa: E402


def _dir():
    return os.environ["TDL_MP_DIR"]


def _net(case):
    with open(os.path.join(_dir(), f"{case}.json")) as f:
        spec = json.load(f)
    return _build(spec, _load(case))


def global_batch(step, n=16, d=6, k=3, seed=1000):
    """The deterministic global batch of ``step`` — identical on every rank
    and in the test's one-process reference."""
    rs = np.random.RandomState(seed + step)
    x = rs.rand(n, d).astype(np.float32)
    y = np.eye(k, dtype=np.float32)[rs.randint(0, k, n)]
    return x, y


def _write(rank, net, start, world):
    np.savez(os.path.join(_dir(), f"out.rank{rank}.npz"),
             params=net.params().detach().cpu().numpy(), start=start,
             iteration=int(net.iteration), world=world,
             incarnation=int(os.environ.get("TDL_GANG_RESTART_COUNT", "0")))


def supervised_train():
    """Data-parallel training of ``toy`` with a lineage checkpoint every
    ``TDL_MP_CKPT_EVERY`` steps and an unconditional restore of the latest
    one at start (the supervisor's restart contract). Heartbeats and fault
    injection ride the trainer's own hooks."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.parallel.launcher import ProcessCollectives
    from deeplearning4j_tpu_torch.parallel.trainer import MultiProcessTrainer
    from deeplearning4j_tpu_torch.serde.checkpoint import TrainingCheckpointer

    col = ProcessCollectives()
    rank, world = dist.get_rank(), dist.get_world_size()
    steps = int(os.environ.get("TDL_MP_STEPS", "10"))
    every = int(os.environ.get("TDL_MP_CKPT_EVERY", "2"))
    net = _net("toy")
    ck = TrainingCheckpointer(os.environ["TDL_MP_CKPT"], async_write=False)
    start = int(net.iteration) if ck.restore(net) else 0
    trainer = MultiProcessTrainer(net)
    for step in range(start, steps):
        x, y = global_batch(step)
        b = len(x) // world
        trainer.fit([DataSet(x[rank * b:(rank + 1) * b], y[rank * b:(rank + 1) * b])])
        if (step + 1) % every == 0:
            col.barrier(f"ck-{step}")  # every rank at this iteration before a save
            ck.save(net)
            col.barrier(f"ck-done-{step}")
    _write(rank, net, start, world)


def elastic_train():
    """A sharded gang that adapts to whatever world size the supervisor
    spawned: the layout is ``largest_layout(world)`` (fsdp takes every
    rank), and the restore is unconditional with ``reshard=True``, so the
    survivors of a resize restore the bigger gang's lineage. A host that
    never comes back is ``TDL_MP_DEAD_RANK``: that rank exits at boot in
    every incarnation after the first while the world is larger than
    ``TDL_MP_SURVIVORS``."""
    incarnation = int(os.environ.get("TDL_GANG_RESTART_COUNT", "0"))
    env_rank = int(os.environ.get("TDL_PROCESS_ID", "0"))
    env_world = int(os.environ.get("TDL_NUM_PROCESSES", "1"))
    dead = os.environ.get("TDL_MP_DEAD_RANK")
    survivors = int(os.environ.get("TDL_MP_SURVIVORS", "1"))
    if (dead is not None and env_rank == int(dead) and incarnation >= 1
            and env_world > survivors):
        os._exit(43)  # the "host" is gone: no boot, no heartbeat, ever

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.parallel.launcher import ProcessCollectives
    from deeplearning4j_tpu_torch.parallel.partition import Partitioner, largest_layout
    from deeplearning4j_tpu_torch.parallel.trainer import MultiProcessTrainer

    col = ProcessCollectives()
    rank, world = dist.get_rank(), dist.get_world_size()
    steps = int(os.environ.get("TDL_MP_STEPS", "8"))
    every = int(os.environ.get("TDL_MP_CKPT_EVERY", "2"))
    net = _net("toy")
    partitioner = Partitioner(largest_layout(world))
    trainer = MultiProcessTrainer(net, mesh_layout=partitioner)
    ck = trainer.checkpointer(os.environ["TDL_MP_CKPT"], async_write=False, reshard=True)
    start = int(net.iteration) if ck.restore(net) else 0
    for step in range(start, steps):
        x, y = global_batch(step)
        trainer.fit([DataSet(x, y)])  # data axis 1: every rank feeds the global batch
        if (step + 1) % every == 0:
            col.barrier(f"el-ck-{step}")
            ck.save(net)
            col.barrier(f"el-ck-done-{step}")
    whole = net._partition.gather_state(net)  # a collective: every rank takes part
    if rank == 0:
        np.savez(os.path.join(_dir(), "out.rank0.npz"),
                 start=start, iteration=int(net.iteration), world=world,
                 incarnation=incarnation, fsdp=partitioner.layout.fsdp,
                 **{k: v for k, v in whole.items() if k.startswith("params/")})
