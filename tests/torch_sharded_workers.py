"""Worker targets of the port's sharded-training tests
(``test_torch_sharded.py``, ``test_torch_sharded_checkpoint.py``,
``test_torch_sequence_parallel.py``).

Each function runs in a worker process that ``deeplearning4j_tpu_torch.
parallel.launcher`` started and initialised (gloo, on the CPU). The test
process writes its cases into ``TDL_MP_DIR`` (``cases.json`` and one
``<case>.npz`` each: the JAX network's initial state flattened to
``/``-joined paths, and the global batches ``x<i>``, ``y<i>``, ``fm<i>``);
each rank writes ``<case>.rank<r>.npz``. Only the port and numpy are
imported here.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parallel_workers import _build, _load  # noqa: E402


def _dir():
    return os.environ["TDL_MP_DIR"]


def _cases():
    with open(os.path.join(_dir(), "cases.json")) as f:
        return json.load(f)


def _dataset(arrays, step, rows=slice(None)):
    from deeplearning4j_tpu_torch.data import DataSet

    def get(name):
        a = arrays.get(f"{name}{step}")
        return None if a is None else a[rows]

    return DataSet(get("x"), get("y"), features_mask=get("fm"), labels_mask=get("lm"))


def _trainer(spec, net):
    """The trainer of a case: ``layout`` [data, fsdp, tp] through
    ``MultiProcessTrainer(mesh_layout=)``, or ``rules`` (the model axis
    size) through ``ParallelTrainer(sharding_rules=)`` on a data x model
    mesh."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh
    from deeplearning4j_tpu_torch.parallel.partition import SpecLayout
    from deeplearning4j_tpu_torch.parallel.sharding import alternating_dense_rules
    from deeplearning4j_tpu_torch.parallel.trainer import MultiProcessTrainer, ParallelTrainer

    if "rules" in spec:
        m = spec["rules"]
        mesh = build_mesh(data=dist.get_world_size() // m, model=m)
        return ParallelTrainer(net, mesh=mesh, sharding_rules=alternating_dense_rules())
    d, f, t = spec["layout"]
    return MultiProcessTrainer(net, mesh_layout=SpecLayout(data=d, fsdp=f, tp=t))


def _constrain(net, max_norm):
    """A MaxNormConstraint on the first layer (each output unit's norm
    spans the input dim, which fsdp splits)."""
    from deeplearning4j_tpu_torch.nn.constraints import MaxNormConstraint

    net.conf.layers[0].constraints = (MaxNormConstraint(max_norm=max_norm),)


def run_cases():
    """Every case of ``cases.json``: ``steps`` fits over the global batches,
    each rank feeding the rows of its data coordinate (``MultiProcessTrainer``)
    or the whole batch (``ParallelTrainer``); then the losses, the whole state
    gathered from the blocks (``NetPartition.gather_state``), this rank's
    resident bytes and the partition report."""
    for spec in _cases():
        arrays = _load(spec["name"])
        net = _build(spec, arrays)
        if "max_norm" in spec:
            _constrain(net, spec["max_norm"])
        trainer = _trainer(spec, net)
        losses = []
        for step in range(spec["steps"]):
            if "rules" in spec:
                ds = _dataset(arrays, step)
            else:
                d = spec["layout"][0]
                b = arrays[f"x{step}"].shape[0] // d
                i = trainer.mesh.axis_index(trainer.data_axis)
                ds = _dataset(arrays, step, slice(i * b, (i + 1) * b))
            trainer.fit([ds])
            losses.append(net.score_)
        state = net._partition.gather_state(net)
        held = sum(p.numel() * p.element_size() for _, _, p in net._param_entries())
        held_opt = sum(t.numel() * t.element_size() for slot in net.updater_state.values()
                       for t in slot.values())
        rep = trainer.partition_report
        np.savez(os.path.join(_dir(), f"{spec['name']}.rank{trainer.mesh.rank}.npz"),
                 losses=np.asarray(losses, np.float64), held=held, held_opt=held_opt,
                 report=np.asarray([rep.params_bytes_total, rep.params_bytes_per_rank,
                                    rep.opt_bytes_per_rank] if rep is not None else [-1] * 3),
                 **{f"state/{k}": v for k, v in state.items()})


def sequence_parallel():
    """The attention cases of ``cases.json`` for this gang's size (``ring``
    or ``ulysses`` on this rank's sequence shard; the output and the
    gradients of q, k, v under the case's cotangent), then its flagship
    cases (one train step of a placed Transformer on the global batch:
    loss, gradients and updated parameters gathered whole)."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.kernels.attention import ring_attention, ulysses_attention
    from deeplearning4j_tpu_torch.parallel.mesh import mesh_from_shape, use_mesh

    torch.set_num_threads(1)
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    sp = mesh_from_shape({"sp": world})
    for spec in _cases():
        a = _load(spec["name"])
        if spec["kind"] == "flagship":
            out.update(_flagship(spec, a))
            continue
        if spec["world"] != world:
            continue
        t = a["q"].shape[2] // world
        rows = slice(rank * t, (rank + 1) * t)
        q, k, v = (torch.tensor(a[n][:, :, rows], requires_grad=True) for n in "qkv")
        mask = torch.tensor(a["mask"][:, rows]) if "mask" in a else None
        fn = ring_attention if spec["impl"] == "ring" else ulysses_attention
        with use_mesh(sp):
            o = fn(q, k, v, axis_name="sp", causal=spec["causal"], key_mask=mask)
        grads = torch.autograd.grad(o, (q, k, v), grad_outputs=torch.tensor(a["cot"][:, :, rows]))
        out[spec["name"]] = {"out": o.detach().numpy(),
                             **{f"d{n}": g.numpy() for n, g in zip("qkv", grads)}}
    for name, arrays in out.items():
        np.savez(os.path.join(_dir(), f"{name}.rank{rank}.npz"), **arrays)


def _flagship(spec, a):
    import torch

    from deeplearning4j_tpu_torch.models import transformer as T
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.parallel.mesh import mesh_from_shape

    dp, tp, sp = spec["mesh"]
    mesh = mesh_from_shape({"dp": dp, "tp": tp, "sp": sp})
    cfg = T.TransformerConfig(compute_dtype=torch.float32, **spec["cfg"])
    tree = {"embed": {}, "blocks": [{} for _ in range(cfg.n_layers)], "mlm": {}}
    for key, v in a.items():
        if key.startswith("p/"):
            parts = key.split("/")[1:]
            node = tree["blocks"][int(parts[1])] if parts[0] == "blocks" else tree[parts[0]]
            node[parts[-1]] = v
    batch = {k[2:]: v for k, v in a.items() if k.startswith("b/")}
    masks = [a[f"mask{i}"] for i in range(2 * cfg.n_layers) if f"mask{i}" in a]
    if masks:
        # the test's masks, in call order, at the global shape: each step
        # draws them again
        feed = iter(masks + masks)
        T.dropout_mask = lambda generator, keep, shape, device: (
            torch.from_numpy(next(feed)).to(device))
    model = T.place_params(tree, cfg, mesh, device="cpu")
    updater = Adam(1e-3)
    state = updater.init(model)
    loss, grads = T.loss_and_grads(model, batch, cfg, torch.Generator())
    gathered = _flat_tree(T.gather_params(model, grads), "g")
    _, state, step_loss = T.make_train_step(cfg, updater)(model, state, batch, 0,
                                                          torch.Generator())
    gathered.update(_flat_tree(T.gather_params(model), "p"))
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    held += sum(t.numel() * t.element_size() for slot in state.values() for t in slot.values())
    return {spec["name"]: {"loss": loss.numpy(), "step_loss": step_loss.numpy(),
                           "held": held, **gathered}}


def _flat_tree(tree, prefix):
    out = {}
    for top, sub in tree.items():
        if top == "blocks":
            for i, blk in enumerate(sub):
                out.update({f"{prefix}/blocks/{i}/{k}": v for k, v in blk.items()})
        else:
            out.update({f"{prefix}/{top}/{k}": v for k, v in sub.items()})
    return out


def _gathered(net, prefix):
    return {f"{prefix}/{k}": v for k, v in net._partition.gather_state(net).items()}


def _restore(spec, arrays, lineage, layout, reshard):
    """A fresh network of the case restored from ``lineage`` under
    ``layout`` (a rank's blocks): the network, or the error's text."""
    from deeplearning4j_tpu_torch.parallel.partition import Partitioner, SpecLayout
    from deeplearning4j_tpu_torch.serde.checkpoint import TrainingCheckpointer

    net = _build(spec, arrays)
    part = Partitioner(SpecLayout(*layout))
    try:
        assert TrainingCheckpointer(lineage, partitioner=part).restore(net, reshard=reshard)
    except ValueError as e:
        return str(e)
    return net


def checkpoint_save():
    """4 ranks: two fits of the case under (1, 2, 2), a save through the
    trainer's checkpointer into ``port/`` and the whole state it saved;
    then the JAX package's lineages ``jax122/`` (same layout) and
    ``jax222/`` (8 devices, reshard=True) restored into fresh networks,
    gathered whole."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.partition import SpecLayout
    from deeplearning4j_tpu_torch.parallel.trainer import MultiProcessTrainer

    (spec,) = _cases()
    arrays = _load(spec["name"])
    net = _build(spec, arrays)
    trainer = MultiProcessTrainer(net, mesh_layout=SpecLayout(1, 2, 2))
    for step in range(spec["steps"]):
        trainer.fit([_dataset(arrays, step)])
    trainer.checkpointer(os.path.join(_dir(), "port"), async_write=False).save(net)
    out = _gathered(net, "saved")
    for name, reshard in (("jax122", False), ("jax222", True)):
        got = _restore(spec, arrays, os.path.join(_dir(), name), (1, 2, 2), reshard)
        out.update(_gathered(got, name))
    np.savez(os.path.join(_dir(), f"save.rank{dist.get_rank()}.npz"), **out)


def checkpoint_reshard():
    """2 ranks: the 4-rank lineage ``port/`` restored under (1, 2, 1),
    first without reshard=True (the error's text), then with it (the whole
    state, and the reshard metrics)."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.monitoring.partition import elastic_metrics

    (spec,) = _cases()
    arrays = _load(spec["name"])
    lineage = os.path.join(_dir(), "port")
    refused = _restore(spec, arrays, lineage, (1, 2, 1), False)
    net = _restore(spec, arrays, lineage, (1, 2, 1), True)
    m = elastic_metrics()
    seconds = m.reshard_seconds.snapshot()["series"][0]
    np.savez(os.path.join(_dir(), f"reshard.rank{dist.get_rank()}.npz"),
             refused=np.asarray(refused), reshard_bytes=m.reshard_bytes.value,
             reshard_count=seconds["count"], iteration=net.iteration,
             **_gathered(net, "restored"))
