"""Worker targets of the port's pipeline tests (``test_torch_pipeline_parallel.py``,
``test_torch_pipeline_checkpoint.py``).

Each function runs in a worker process that ``deeplearning4j_tpu_torch.
parallel.launcher`` started and initialised (gloo on the CPU; the generic
case also under NCCL, one card per rank, ``test_torch_pipeline_nccl.py``). The test
process writes ``cases.json`` and one ``<case>.npz`` per case into
``TDL_MP_DIR``: the JAX package's canonical pipeline tree (``p/embed/tok``,
``p/blocks/qkv_w`` stacked ``[L, ...]``, ...) and the global batch
(``b/tokens``, ``b/labels``, ...). Each rank writes ``<case>.rank<r>.npz``.
Only the port and numpy are imported here.
"""

import json
import os

import numpy as np

TOPS = ("embed", "blocks", "mlm")


def _dir():
    return os.environ["TDL_MP_DIR"]


def _load(case):
    with np.load(os.path.join(_dir(), f"{case}.npz")) as z:
        return {k: z[k] for k in z.files}


def _save(case, rank, **arrays):
    np.savez(os.path.join(_dir(), f"{case}.rank{rank}.npz"), **arrays)


def _tree(arrays, prefix):
    out = {}
    for k, v in arrays.items():
        if k.startswith(prefix + "/"):
            top, name = k[len(prefix) + 1:].split("/")
            out.setdefault(top, {})[name] = v
    return out


def _batch(arrays):
    return {k[2:]: v for k, v in arrays.items() if k.startswith("b/")}


def cfg_of(spec):
    import torch

    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=64, max_len=32, d_model=16, n_heads=2,
                             n_layers=spec.get("layers", 6), d_ff=32, dropout=0.0,
                             compute_dtype=torch.float32, remat=spec.get("remat", False))


def _chunk(tree, mesh, spec):
    """This rank's pipeline tensors of a canonical numpy tree: ``embed``
    and ``mlm`` whole; ``blocks`` its [1, L/S, ...] staged block, or its
    ``PipelinePartitioner`` chunk of the canonical [L, ...] (whole where S
    does not divide L)."""
    import torch

    S, s = mesh.axis_size("pipe"), mesh.axis_index("pipe")
    out = {top: {k: torch.tensor(v) for k, v in tree[top].items()} for top in ("embed", "mlm")}
    L = next(iter(tree["blocks"].values())).shape[0]
    if spec.get("boundaries") is None:
        c = L // S
        out["blocks"] = {k: torch.tensor(v[s * c:(s + 1) * c][None])
                         for k, v in tree["blocks"].items()}
    elif L % S:
        out["blocks"] = {k: torch.tensor(v) for k, v in tree["blocks"].items()}
    else:
        c = L // S
        out["blocks"] = {k: torch.tensor(v[s * c:(s + 1) * c]) for k, v in tree["blocks"].items()}
    return out


def _whole_blocks(blocks, mesh, L, staged):
    """Every block leaf gathered over ``pipe`` into its whole [L, ...]:
    from the staged [1, L/S, ...] blocks, or from canonical chunks (blocks
    stored whole are whole already)."""
    from deeplearning4j_tpu_torch.parallel.collectives import all_gather
    from deeplearning4j_tpu_torch.parallel.mesh import use_mesh

    out = {}
    with use_mesh(mesh):
        for k, t in blocks.items():
            if staged or t.shape[0] != L:
                t = all_gather(t.contiguous(), "pipe", axis=0)
            out[k] = t.reshape((L,) + tuple(t.shape[2:])) if staged else t
    return out


def _flat(prefix, tree):
    return {f"{prefix}/{top}/{k}": v.detach().cpu().numpy() for top in tree
            for k, v in tree[top].items()}


def _run_generic(spec, arrays, rank):
    """The residual stage over ``spec["mesh"]`` (default ``pipe=S``), on
    this rank's device: a ``data`` axis takes its rows of each microbatch.
    ``ref/*`` is the sequential composition of the whole batch on the same
    device, in float32."""
    import torch

    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.parallel import pipeline as PP
    from deeplearning4j_tpu_torch.parallel.launcher import local_device
    from deeplearning4j_tpu_torch.parallel.mesh import mesh_from_shape

    mesh = mesh_from_shape(spec.get("mesh") or {"pipe": spec["S"]})
    dev = local_device()
    s = mesh.axis_index("pipe")
    n_data = mesh.shape.get("data", 1)
    rows = arrays["xs"].shape[1] // n_data
    d = mesh.axis_index("data") if n_data > 1 else 0
    out = {}

    def stage(p, x):
        return x + torch.tanh(x * p["w"] + p["b"])

    for sched in ("gpipe", "1f1b"):
        p = {k: torch.tensor(arrays[k][s:s + 1], device=dev).requires_grad_()
             for k in ("w", "b")}
        xs = torch.tensor(arrays["xs"][:, d * rows:(d + 1) * rows], device=dev).requires_grad_()
        ys = PP.spmd_pipeline(stage, p, xs, mesh, data_axis="data" if n_data > 1 else None,
                              schedule=sched)
        (ys.square().sum()).backward()
        out.update({f"{sched}/ys": ys.detach().cpu().numpy(),
                    f"{sched}/dw": p["w"].grad.cpu().numpy(),
                    f"{sched}/db": p["b"].grad.cpu().numpy(),
                    f"{sched}/dxs": xs.grad.cpu().numpy(),
                    f"{sched}/run": np.asarray(json.dumps(PP.last_run))})
    w, b, xs = (torch.tensor(arrays[k], device=dev).requires_grad_() for k in ("w", "b", "xs"))
    h = xs
    for i in range(mesh.shape["pipe"]):
        h = h + torch.tanh(h * w[i] + b[i])
    h.square().sum().backward()
    out.update({"ref/ys": h.detach().cpu().numpy(), "ref/dw": w.grad.cpu().numpy(),
                "ref/db": b.grad.cpu().numpy(), "ref/dxs": xs.grad.cpu().numpy(),
                "staged": np.asarray(json.dumps(collectives.staged_counts)),
                "backend": np.asarray(torch.distributed.get_backend())})
    return out


def _loss_and_grads(spec, arrays, mesh, schedule):
    import torch

    from deeplearning4j_tpu_torch.parallel import pipeline as PP

    cfg = cfg_of(spec)
    params = _chunk(_tree(arrays, "p"), mesh, spec)
    leaves = [t.requires_grad_() for top in params for t in params[top].values()]
    f = PP.transformer_pp_loss_fn(cfg, spec["M"], mesh, schedule=schedule,
                                  boundaries=spec.get("boundaries"))
    loss = f(params, _batch(arrays))
    names = [f"{top}.{k}" for top in params for k in params[top]]
    flat = PP.reduce_replicated_grads(dict(zip(names, torch.autograd.grad(loss, leaves))),
                                      mesh, PP.resolve_data_axis(mesh, "auto"))
    g = {top: {k: flat[f"{top}.{k}"] for k in params[top]} for top in params}
    run = dict(PP.last_run)
    g["blocks"] = _whole_blocks(g["blocks"], mesh, cfg.n_layers, spec.get("boundaries") is None)
    return float(loss), g, run


def _run_loss(spec, arrays, rank):
    from deeplearning4j_tpu_torch.parallel.mesh import mesh_from_shape

    mesh = mesh_from_shape(spec["mesh"])
    out = {}
    for sched in spec["schedules"]:
        loss, g, run = _loss_and_grads(spec, arrays, mesh, sched)
        out[f"{sched}/loss"] = np.float64(loss)
        out.update({f"{sched}/{k}": v for k, v in _flat("g", g).items()})
        out[f"{sched}/run"] = np.asarray(json.dumps(run))
    return out


def _run_step(spec, arrays, rank):
    import torch

    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.parallel import pipeline as PP
    from deeplearning4j_tpu_torch.parallel.mesh import mesh_from_shape

    mesh = mesh_from_shape(spec["mesh"])
    cfg = cfg_of(spec)
    upd = Adam(spec["lr"])
    params = _chunk(_tree(arrays, "p"), mesh, spec)
    opt = upd.init(PP._flat_state(params))
    step = PP.make_pp_train_step(cfg, upd, spec["M"], mesh, schedule=spec["schedules"][0],
                                 boundaries=spec.get("boundaries"))
    params, opt, loss = step(params, opt, _batch(arrays), 0)
    L, staged = cfg.n_layers, spec.get("boundaries") is None
    params["blocks"] = _whole_blocks(params["blocks"], mesh, L, staged)
    out = {"loss": np.float64(float(loss)), **_flat("p", params)}
    for slot, flat in opt.items():
        tree = {top: {} for top in TOPS}
        for key, t in flat.items():
            top, k = key.split(".", 1)
            tree[top][k] = t
        tree["blocks"] = _whole_blocks(tree["blocks"], mesh, L, staged)
        out.update(_flat(slot, tree))
    return out


def _run_trainer(spec, arrays, rank):
    from deeplearning4j_tpu_torch.monitoring import flight
    from deeplearning4j_tpu_torch.monitoring.flight import FlightRecorder
    from deeplearning4j_tpu_torch.monitoring.registry import get_registry
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.parallel.launcher import local_device
    from deeplearning4j_tpu_torch.parallel.partition import SpecLayout
    from deeplearning4j_tpu_torch.parallel import pipeline as PP
    from deeplearning4j_tpu_torch.parallel.pipeline import PipelineParallelTrainer

    def counter():
        snap = get_registry().snapshot().get("tdl_pipe_rebalances_total") or {}
        return sum(s["value"] for s in snap.get("series") or [])

    cfg = cfg_of(spec)
    jtree = _tree(arrays, "p")
    trainer = PipelineParallelTrainer(jtree, cfg, Adam(spec["lr"]),
                                      SpecLayout(data=2, pipe=2), n_microbatches=spec["M"],
                                      schedule="1f1b", device=local_device())
    batch = _batch(arrays)
    out = {"bounds0": np.asarray(trainer.boundaries)}
    losses = []
    for _ in range(2):
        trainer._fit_batch(batch)
        losses.append(trainer.net.score_)
    times = trainer.profile_stages(seq=32, batch_size=16, repeats=9)
    out["times"] = np.asarray(times)
    out["predicted"] = np.asarray(trainer.predicted_stage_costs())
    out["balanced"] = np.asarray(trainer.maybe_rebalance([1.0, 1.0]) is None)
    rec = FlightRecorder(proc=f"pp-rank{rank}")
    flight.set_flight_recorder(rec)
    try:
        before = counter()
        new = trainer.maybe_rebalance([2.0, 1.0])
        out["bounds1"] = np.asarray(new)
        out["counter"] = np.asarray(counter() - before)
        out["events"] = np.asarray(json.dumps([e for e in rec.events()
                                               if e["kind"] == "pipe_rebalance"]))
    finally:
        flight.set_flight_recorder(None)
    trainer._fit_batch(batch)
    losses.append(trainer.net.score_)
    out["fetched"] = np.asarray(PP.last_run.get("fetched_bytes", 0))
    out["losses"] = np.asarray(losses)
    out["iteration"] = np.asarray(trainer.net.iteration)
    out.update({f"s/{k}": v for k, v in trainer.gather_state().items()})
    return out


def _run_checkpoint(spec, arrays, rank):
    """Train one step under (data=2, pipe=2) and save; the restore onto
    (data=2, fsdp=2) refused without reshard=True and bit for bit with it;
    the (data=2, fsdp=2) state saved and restored back onto pipe=2; the JAX
    package's lineage restored under (data=2, pipe=2)."""
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.parallel.launcher import local_device
    from deeplearning4j_tpu_torch.parallel.partition import PipelinePartitioner, SpecLayout
    from deeplearning4j_tpu_torch.parallel.pipeline import PipelineParallelTrainer, pipeline_net
    from deeplearning4j_tpu_torch.serde.checkpoint import TrainingCheckpointer

    cfg = cfg_of(spec)
    d = spec["dirs"]
    dev = local_device()
    jtree = _tree(arrays, "p")
    trainer = PipelineParallelTrainer(jtree, cfg, Adam(spec["lr"]), SpecLayout(data=2, pipe=2),
                                      n_microbatches=spec["M"], device=dev)
    trainer._fit_batch(_batch(arrays))
    trainer.checkpointer(d["port"], async_write=False).save(trainer.net)
    out = {f"saved/{k}": v for k, v in trainer.gather_state().items()}

    def fresh():
        return pipeline_net(_tree(arrays, "q"), Adam(spec["lr"]), device=dev)

    fsdp = PipelinePartitioner(SpecLayout(data=2, fsdp=2))
    nb = fresh()
    try:
        TrainingCheckpointer(d["port"], partitioner=fsdp, async_write=False).restore(nb)
        out["refused"] = np.asarray("")
    except ValueError as e:
        out["refused"] = np.asarray(str(e))
    assert TrainingCheckpointer(d["port"], partitioner=fsdp, async_write=False,
                                reshard=True).restore(nb)
    out.update({f"fsdp/{k}": v for k, v in nb._partition.gather_state(nb).items()})
    out["fsdp_rows"] = np.asarray(nb.params_["blocks"]["qkv_w"].shape[0])
    TrainingCheckpointer(d["fsdp"], partitioner=fsdp, async_write=False).save(nb)
    nc = fresh()
    pipe = PipelinePartitioner(SpecLayout(data=2, pipe=2))
    assert TrainingCheckpointer(d["fsdp"], partitioner=pipe, async_write=False,
                                reshard=True).restore(nc)
    out.update({f"back/{k}": v for k, v in nc._partition.gather_state(nc).items()})
    # the JAX package's lineage, under the layout it was written with
    nj = fresh()
    assert TrainingCheckpointer(d["jax"], partitioner=pipe, async_write=False).restore(nj)
    out.update({f"jax/{k}": v for k, v in nj._partition.gather_state(nj).items()})
    out["jax_iteration"] = np.asarray(nj.iteration)
    return out


RUNNERS = {"generic": _run_generic, "loss": _run_loss, "step": _run_step,
           "trainer": _run_trainer, "checkpoint": _run_checkpoint}


def run_cases():
    """Every case of ``cases.json`` whose ``ranks`` is this gang's size."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(os.path.join(_dir(), "cases.json")) as f:
        cases = json.load(f)
    for spec in cases:
        if spec["ranks"] != world:
            continue
        _save(spec["name"], rank, **RUNNERS[spec["kind"]](spec, _load(spec["name"]), rank))
