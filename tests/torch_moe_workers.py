"""Worker target of ``test_torch_moe.py``'s expert-parallel cases.

Runs in a process that ``deeplearning4j_tpu_torch.parallel.launcher``
started and initialised (gloo, on the CPU). The test writes ``cases.json``
(each case's MoE config) and ``<case>.npz`` (the whole parameters and the
global batch ``x``) into ``TDL_MP_DIR``; on a ``{"data": 2, "expert": 2}``
mesh each rank runs the expert-parallel ``moe_ffn`` on its data rows and
its expert blocks, takes the gradients of ``sum(y**2) + 0.01 * aux``,
sums the shares and gathers the expert blocks, and writes
``<case>.rank<r>.npz`` (its rows of y, aux, the whole gradients). Only the
port and numpy are imported here.
"""

import json
import os

import numpy as np


def run_cases():
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.models import moe
    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.parallel.mesh import mesh_from_shape, use_mesh

    d = os.environ["TDL_MP_DIR"]
    with open(os.path.join(d, "cases.json")) as f:
        cases = json.load(f)
    rank = dist.get_rank()
    mesh = mesh_from_shape({"data": 2, "expert": 2})
    for name, spec in cases.items():
        cfg = moe.MoEConfig(**spec)
        arrays = dict(np.load(os.path.join(d, f"{name}.npz")))
        whole = {k: torch.from_numpy(arrays[k]) for k in ("wg", "w1", "b1", "w2", "b2")}
        params = moe.shard_moe_params(whole, cfg, mesh)
        x = torch.from_numpy(arrays["x"])
        rows = x.shape[0] // mesh.axis_size("data")
        i = mesh.axis_index("data")
        y, aux = moe.moe_ffn(params, x[i * rows:(i + 1) * rows], cfg, mesh=mesh)
        loss = torch.sum(y * y) + 0.01 * aux
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        grads = moe.reduce_expert_parallel_grads(grads, cfg, mesh)
        with use_mesh(mesh):
            for k in ("w1", "b1", "w2", "b2"):
                grads[k] = collectives.all_gather(grads[k], "expert", axis=0)
        np.savez(os.path.join(d, f"{name}.rank{rank}.npz"), y=y.detach().numpy(),
                 aux=aux.detach().numpy(), **{f"g_{k}": g.numpy() for k, g in grads.items()})
