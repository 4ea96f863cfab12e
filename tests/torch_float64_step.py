"""How far a float32 training step of a graph model lies from a float64 step
of the same network on the same batch: the measurement behind the
tolerances of ``tests/test_torch_resnet.py``, ``tests/test_torch_facenet.py``
and ``chip_smoke.py`` phase 7.

    python3 tests/torch_float64_step.py                   # the port on the CPU
    python3 tests/torch_float64_step.py --device cuda     # the port on the card, and the CPU
    python3 tests/torch_float64_step.py --jax             # also the JAX package, CPU

For each configuration it prints one JSON line: the float32 score's
relative distance from the float64 score, and each parameter's update
(its change in the step) as a share of the norm of the float64 update, as
one vector over all parameters (``all``), for the median tensor and for
the worst; and the worst BN running statistic's. On the card it also
prints the same float32 step on the CPU against the float64 step, and the
card's against the CPU's. The float64 step runs the
port's graph in float64 with BatchNormalization's moments in float64 as
well: the layer computes them in float32 by design (the JAX package does
too), so the reference step replaces its ``forward_bn``. With ``--jax``
(on the CPU) the test configurations start from the JAX network's initial
weights, as the parity tests do, and the same is printed for the JAX
package's float32 step, with the drift of the inference outputs that the
tests compare.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deeplearning4j_tpu_torch import set_fp32_numerics  # noqa: E402
from deeplearning4j_tpu_torch.common.environment import env  # noqa: E402
from deeplearning4j_tpu_torch.data import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.models import (InceptionResNetV1, ResNet50,  # noqa: E402
                                             cg_params_from_jax)
from deeplearning4j_tpu_torch.nn import conf as C  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, module_key  # noqa: E402


def _bn_in_float64(self, params, state, x, it, *, training):
    """BatchNormalization.forward_bn with the moments in x's dtype (float64
    here): the same one-pass biased moments and running-statistic update."""
    axes = (0, 2, 3) if x.dim() == 4 else (0, 2) if x.dim() == 3 else (0,)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    n = int(np.prod([x.shape[a] for a in axes]))
    mean = x.sum(dim=axes) / n
    var = torch.clamp((x * x).sum(dim=axes) / n - mean * mean, min=0.0)
    with torch.no_grad():
        new = {k: self.decay * state[k] + (1 - self.decay) * v
               for k, v in (("mean", mean), ("var", var))}
    inv = torch.rsqrt(var + self.eps)
    off = -mean * inv
    if "gamma" in params:
        inv = inv * params["gamma"]
        off = params["beta"] - mean * inv
    return C.act.get(self.activation)(x * inv.reshape(bshape) + off.reshape(bshape)), new


def _batch(shape, classes, batch, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(batch, *shape).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rs.randint(0, classes, batch)]


def distances(before, after, ref_after, bn=None, ref_bn=None):
    """{all, median, worst[, bn]}: each update (after - before) against the
    reference's (ref_after - before), as a share of the reference's norm;
    arguments are {(node, name): float64 numpy array}."""
    num = den = 0.0
    errs = []
    for key, b in before.items():
        want, got = ref_after[key] - b, after[key] - b
        num += float(np.sum((got - want) ** 2))
        den += float(np.sum(want ** 2))
        errs.append(float(np.linalg.norm(got - want) / np.linalg.norm(want)))
    out = {"all": (num / den) ** 0.5, "median": float(np.median(errs)), "worst": max(errs)}
    if bn is not None:
        out["bn"] = max(float(np.linalg.norm(bn[k] - ref_bn[k]) / np.linalg.norm(ref_bn[k]))
                        for k in ref_bn)
    return out


def _entries(net):
    """Copies (the tensors change in place in the step)."""
    return {(n, k): p.detach().double().cpu().numpy().copy() for n, k, p in net._param_entries()}


def _bn_state(net):
    return {(k, s): getattr(st, s).double().cpu().numpy().copy()
            for k, st in net.bn_state.items() for s in ("mean", "var")}


def measure(conf_fn, shape, classes, batch, device, weights=None):
    """One float32 step and one float64 step of the graph ``conf_fn()`` on
    ``device`` from the same weights (the port's initial ones, or the JAX
    network's ``weights``: its params and BN state as numpy trees) and
    batch; returns the distances and what the JAX comparison needs."""
    x, y = _batch(shape, classes, batch)
    f32 = ComputationGraph(conf_fn(), device=device).init()
    if weights is not None:
        cg_params_from_jax(f32, *weights)
    conf64 = conf_fn()
    conf64.dtype = "float64"
    f64 = ComputationGraph(conf64, device=device).init()
    f64.set_params(f32.params().double())
    before = _entries(f64)
    f32.fit(DataSet(x, y))
    original = C.BatchNormalization.forward_bn
    C.BatchNormalization.forward_bn = _bn_in_float64
    try:
        f64.fit(DataSet(x.astype(np.float64), y.astype(np.float64)))
    finally:
        C.BatchNormalization.forward_bn = original
    out = distances(before, _entries(f32), _entries(f64), _bn_state(f32), _bn_state(f64))
    out["score"] = abs(f32.score_ - f64.score_) / abs(f64.score_)
    return out, (f32, f64, before, x, y)


def against_cpu(f32, f64, before, x, y):
    """The same float32 step on the CPU from the same weights: its distances
    from the float64 step, and the card's from it (as chip_smoke.py's
    ``check_fit_on_cpu`` measures them)."""
    cpu = ComputationGraph(f32.conf, device="cpu").init()
    cpu.set_params(torch.as_tensor(np.concatenate([b.reshape(-1) for b in before.values()]),
                                   dtype=torch.float32))
    cpu.fit(DataSet(x, y))
    cpu_out = distances(before, _entries(cpu), _entries(f64), _bn_state(cpu), _bn_state(f64))
    cpu_out["score"] = abs(cpu.score_ - f64.score_) / abs(f64.score_)
    card_out = distances(before, _entries(f32), _entries(cpu), _bn_state(f32), _bn_state(cpu))
    card_out["score"] = abs(f32.score_ - cpu.score_) / abs(cpu.score_)
    return cpu_out, card_out


def _no_dropout(conf):
    conf.nodes["drop"].layer.dropout = 0.0
    return conf


# (name, conf, input shape, classes, batch, JAX counterpart for --jax)
CONFIGS = [
    ("resnet50_224_b4", lambda: ResNet50().conf(), (3, 224, 224), 1000, 4, None),
    ("inception_160_b4", lambda: _no_dropout(InceptionResNetV1().conf()), (3, 160, 160), 1001, 4,
     None),
    ("resnet50_64_c10_b2", lambda: ResNet50(num_classes=10, input_shape=(3, 64, 64)).conf(),
     (3, 64, 64), 10, 2, ("ResNet50", dict(num_classes=10, input_shape=(3, 64, 64)))),
    ("inception_96_c7_b2", lambda: _no_dropout(InceptionResNetV1(
        num_classes=7, input_shape=(3, 96, 96), blocks=(1, 1, 1), embedding_size=32).conf()),
     (3, 96, 96), 7, 2, ("InceptionResNetV1", dict(num_classes=7, input_shape=(3, 96, 96),
                                                   blocks=(1, 1, 1), embedding_size=32))),
]


def _jax_net(jax_model):
    """The JAX package's network of the configuration, initialised (its
    weights are the ones the parity tests use)."""
    from deeplearning4j_tpu import models as J
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

    name, kw = jax_model
    conf = getattr(J, name)(**kw).conf()
    if "drop" in conf.nodes:
        conf.nodes["drop"].layer.dropout = 0.0
    jnet = JGraph(conf)
    jnet.init()
    return jnet


def _jax_distances(jnet, f64, before, x, y):
    """The JAX network's float32 step against the port's float64 step from
    the same weights."""
    import jax

    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet

    jnet.fit(JDataSet(x, y))
    params = jax.tree.map(np.asarray, jnet.params_)
    after = {(n, k): w.astype(np.float64) for n, d in params.items() for k, w in d.items()}
    bn = {(module_key(n), s): np.asarray(st[s], np.float64)
          for n, st in jax.tree.map(np.asarray, jnet.bn_state).items() for s in ("mean", "var")}
    out = distances(before, after, _entries(f64), bn, _bn_state(f64))
    out["score"] = abs(float(jnet.score_) - f64.score_) / abs(f64.score_)
    return out


def output_drift(conf_fn, weights, jnet, shape, classes, batch):
    """Inference as the parity tests run it, from the initial weights: the
    BN running statistics set to the batch's own moments (from one
    training-mode forward of the port in float32), the same in the port in
    float32 and float64 and in the JAX network; the largest absolute
    difference of each float32 output (softmax probabilities) from the
    float64 one."""
    import jax.numpy as jnp

    x, _ = _batch(shape, classes, batch)
    f32 = cg_params_from_jax(ComputationGraph(conf_fn(), device="cpu").init(), *weights)
    conf64 = conf_fn()
    conf64.dtype = "float64"
    f64 = ComputationGraph(conf64, device="cpu").init()
    f64.set_params(f32.params().double())
    _, moved = f32._forward(f32._params(), f32._bn(), {"input": torch.from_numpy(x)},
                            training=True, rng=None)
    decay = 0.9  # new = decay * old + (1 - decay) * batch; old: mean 0, var 1
    stats = {n: {"mean": moved[n]["mean"].double() / (1 - decay),
                 "var": (moved[n]["var"].double() - decay) / (1 - decay)} for n in moved}
    with torch.no_grad():
        for n, st in stats.items():
            for net in (f32, f64):
                for k in ("mean", "var"):
                    getattr(net.bn_state[module_key(n)], k).copy_(st[k])
    jnet.bn_state = {n: {k: jnp.asarray(v.float().numpy()) for k, v in st.items()}
                     for n, st in stats.items()}
    ref = f64.output(x.astype(np.float64))[0].numpy()
    return {"port_float32": float(np.abs(f32.output(x)[0].double().numpy() - ref).max()),
            "jax_float32": float(np.abs(np.asarray(jnet.output(x)[0].numpy(), np.float64)
                                        - ref).max()),
            "largest_probability": float(ref.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args(argv)
    # float32 products and convolutions in full float32, also on the card
    env().set("matmul_precision", "float32")
    set_fp32_numerics()
    for name, conf_fn, shape, classes, batch, jax_model in CONFIGS:
        jnet = weights = None
        if args.jax and jax_model is not None:
            import jax

            jnet = _jax_net(jax_model)
            weights = [jax.tree.map(np.asarray, t) for t in (jnet.params_, jnet.bn_state)]
            outputs = output_drift(conf_fn, weights, _jax_net(jax_model), shape, classes, batch)
        out, (f32, f64, before, x, y) = measure(conf_fn, shape, classes, batch, args.device,
                                                weights)
        line = {"config": name, "device": args.device, "port_float32": out}
        if args.device != "cpu":
            line["cpu_float32"], line["device_vs_cpu"] = against_cpu(f32, f64, before, x, y)
        if jnet is not None:
            line["weights"] = "the JAX network's"
            line["jax_float32"] = _jax_distances(jnet, f64, before, x, y)
            line["inference_output_abs"] = outputs
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
