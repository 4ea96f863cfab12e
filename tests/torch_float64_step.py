"""How far a float32 training step of a zoo model lies from a float64 step
of the same network on the same batch: the measurement behind the
tolerances of ``tests/test_torch_resnet.py``, ``tests/test_torch_facenet.py``,
``tests/test_torch_zoo_ext.py`` and ``chip_smoke.py`` phases 7, 17, 18 and 20d.

    python3 tests/torch_float64_step.py                   # the port on the CPU
    python3 tests/torch_float64_step.py --device cuda     # the port on the card, and the CPU
    python3 tests/torch_float64_step.py --jax             # also the JAX package, CPU
    python3 tests/torch_float64_step.py --only vgg16_224,nasnet  # by name prefix
    python3 tests/torch_float64_step.py --jax --threads 1  # torch on one CPU thread

The configurations are the graph models (ResNet-50, InceptionResNetV1) and
the image zoo (VGG16/19, AlexNet, Darknet19, SqueezeNet, UNet, Xception,
NASNet; MultiLayerNetworks and graphs alike), TinyYOLO: each at its published
defaults with the batch ``chip_smoke.py`` checks on the card, and at the
size its parity test runs (with ``--jax``, from the JAX network's weights).
Dropout is off in every one.

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
from deeplearning4j_tpu_torch import models as M  # noqa: E402
from deeplearning4j_tpu_torch.models import cg_params_from_jax, mln_params_from_jax  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as C  # noqa: E402
from deeplearning4j_tpu_torch.nn import updaters as U  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, module_key  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from chip_smoke import (CAPSNET_PARAMS, CONVLSTM_PARAMS, capsnet_conf,  # noqa: E402,F401
                        convlstm_conf, digit_batch, frame_batch, yolo_batch)


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
    """Uniform images and one-hot labels; ``classes`` None: a binary
    [B, 1, H, W] mask (UNet's per-pixel labels); ``classes`` a function:
    its ``(x, y)`` for the batch size and seed."""
    if callable(classes):
        return classes(batch, seed)
    rs = np.random.RandomState(seed)
    x = rs.rand(batch, *shape).astype(np.float32)
    if classes is None:
        return x, (rs.rand(batch, 1, *shape[1:]) > 0.5).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rs.randint(0, classes, batch)]


def _net(conf, device):
    """The configuration's network: a MultiLayerNetwork or a graph."""
    if isinstance(conf, C.MultiLayerConfiguration):
        return MultiLayerNetwork(conf, device=device).init()
    return ComputationGraph(conf, device=device).init()


def _bridge(net, weights):
    """The JAX network's params and BN state (numpy trees) into ``net``."""
    if isinstance(net, ComputationGraph):
        return cg_params_from_jax(net, *weights)
    return mln_params_from_jax(net, *weights)


def gradient_norms(net, x, y):
    """{(node, name): norm of the float32 loss gradient} of ``net`` on the
    batch (x, y) (tensors on the net's device), without updating it; a
    null update's gradient is ~1e-8 of the largest, a real one's above
    1e-3."""
    params = net._params()
    with torch.enable_grad():
        if isinstance(net, ComputationGraph):
            loss, _ = net._forward(params, net._bn(), {net.conf.network_inputs[0]: x},
                                   training=True, rng=None,
                                   labels={net.conf.network_outputs[0]: y})
        else:
            loss, _ = net._loss_fn(params, net._bn(), x, y, None, None, None, True)
        flat = [(k, n, p) for k, d in params.items() for n, p in d.items()]
        grads = torch.autograd.grad(loss, [p for *_, p in flat], allow_unused=True)
    return {(k, n): 0.0 if g is None else float(g.norm()) for (k, n, _), g in zip(flat, grads)}


def _bn_key(net, name):
    """A BN layer's key in ``net.bn_state`` from its key in the JAX tree."""
    return module_key(name) if isinstance(net, ComputationGraph) else name


# A reference update or BN statistic below this share of the largest is
# zero in exact arithmetic (a per-channel shift that a later
# BatchNormalization removes: NASNet's BN betas ahead of a 1x1 convolution
# and BN; the mean of a zero-mean input); float32 gives it rounding noise
# (which Adam scales up to ~0.1 of a real update), so a share of its norm
# means nothing: it counts in "all" and as "null", not in "median"/"worst"
NULL_REL = 1e-9


def distances(before, after, ref_after, bn=None, ref_bn=None):
    """{all, median, worst, null[, bn, bn_null]}: each update (after -
    before) against the reference's (ref_after - before), as a share of the
    reference's norm; arguments are {(node, name): float64 numpy array}."""
    wants = {key: ref_after[key] - b for key, b in before.items()}
    largest = max(np.linalg.norm(w) for w in wants.values())
    num = den = 0.0
    errs, null = [], 0
    for key, b in before.items():
        want, got = wants[key], after[key] - b
        num += float(np.sum((got - want) ** 2))
        den += float(np.sum(want ** 2))
        if np.linalg.norm(want) <= NULL_REL * largest:
            null += 1
            continue
        errs.append(float(np.linalg.norm(got - want) / np.linalg.norm(want)))
    out = {"all": (num / den) ** 0.5, "median": float(np.median(errs)), "worst": max(errs),
           "null": null}
    if bn is not None and ref_bn:
        top = max(np.linalg.norm(v) for v in ref_bn.values())
        live = [k for k in ref_bn if np.linalg.norm(ref_bn[k]) > NULL_REL * top]
        out["bn"] = max(float(np.linalg.norm(bn[k] - ref_bn[k]) / np.linalg.norm(ref_bn[k]))
                        for k in live)
        out["bn_null"] = len(ref_bn) - len(live)
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
    f32 = _net(conf_fn(), device)
    if weights is not None:
        _bridge(f32, weights)
    conf64 = conf_fn()
    conf64.dtype = "float64"
    f64 = _net(conf64, device)
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
    cpu = _net(f32.conf, "cpu")
    cpu.set_params(torch.as_tensor(np.concatenate([b.reshape(-1) for b in before.values()]),
                                   dtype=torch.float32))
    cpu.fit(DataSet(x, y))
    cpu_out = distances(before, _entries(cpu), _entries(f64), _bn_state(cpu), _bn_state(f64))
    cpu_out["score"] = abs(cpu.score_ - f64.score_) / abs(f64.score_)
    card_out = distances(before, _entries(f32), _entries(cpu), _bn_state(f32), _bn_state(cpu))
    card_out["score"] = abs(f32.score_ - cpu.score_) / abs(cpu.score_)
    return cpu_out, card_out


def no_dropout(conf):
    """``conf`` with every layer's dropout off (either package's
    MultiLayerConfiguration or graph configuration)."""
    layers = (conf.layers if hasattr(conf, "layers")
              else [n.layer for n in conf.nodes.values() if n.layer is not None])
    for layer in layers:
        layer.dropout = 0.0
    return conf


def _zoo(name, **kw):
    return lambda: no_dropout(getattr(M, name)(**kw).conf())


# The zoo's published defaults (chip_smoke.py phase 17's float32 checks:
# batch 4 for the BN models, 2 for the others) and the parity tests' sizes
# (tests/test_torch_zoo_ext.py, batch 2), with the JAX counterparts
ZOO_SMALL = {
    "VGG16": dict(num_classes=5, input_shape=(3, 32, 32)),
    "VGG19": dict(num_classes=5, input_shape=(3, 32, 32)),
    "AlexNet": dict(num_classes=7, input_shape=(3, 67, 67)),
    "Darknet19": dict(num_classes=7, input_shape=(3, 64, 64)),
    "SqueezeNet": dict(num_classes=7, input_shape=(3, 64, 64)),
    "UNet": dict(n_channels_out=1, input_shape=(3, 32, 32), base_filters=4, depth=2),
    "Xception": dict(num_classes=7, input_shape=(3, 32, 32), middle_blocks=1),
    "NASNet": dict(num_classes=6, input_shape=(3, 64, 64), penultimate_filters=96, num_cells=1,
                   stem_filters=8),
}
ZOO_BN = ("Darknet19", "Xception", "NASNet")


def _classes(name, kw):
    return None if name == "UNet" else kw.get("num_classes", 1000)


def lrn_stack(C, U):
    """ZeroPadding → Depthwise → Separable (stride 2, SAME) → LRN (alpha
    0.1) → Upsampling2D → Deconvolution2D (SAME, stride 2) → max pool →
    softmax, Adam, on [2, 9, 8] images: the new layers in one network, in
    the package ``C`` (its ``nn.conf``) with its updaters ``U``
    (``tests/test_torch_nn_layers_ext.py``)."""
    return (C.NeuralNetConfiguration.Builder().seed(7).updater(U.Adam(1e-2)).list()
            .layer(C.ZeroPaddingLayer(padding=(1, 0, 0, 1)))
            .layer(C.DepthwiseConvolution2D(depth_multiplier=2, kernel_size=(3, 3),
                                            activation="relu"))
            .layer(C.SeparableConvolution2D(n_out=6, kernel_size=(3, 3), stride=(2, 2),
                                            convolution_mode="same", activation="tanh"))
            .layer(C.LocalResponseNormalization(alpha=0.1))
            .layer(C.Upsampling2D(size=(2, 2)))
            .layer(C.Deconvolution2D(n_out=4, kernel_size=(3, 3), stride=(2, 2),
                                     convolution_mode="same", activation="relu"))
            .layer(C.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(C.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(C.InputType.convolutional(9, 8, 2)).build())


def _jax_lrn_stack():
    from deeplearning4j_tpu.nn import conf as JC
    from deeplearning4j_tpu.nn import updaters as JU

    return lrn_stack(JC, JU)


# CapsNet and the ConvLSTM frame predictor (chip_smoke.py phase 18): at the
# published widths with phase 18's batches and data, and at the sizes of
# their parity tests (tests/test_torch_capsules.py, the 12x12 configuration
# of the JAX package's test_capsules.py with its bar images, and
# tests/test_torch_layers_nets.py: 4 patch channels of 8x8, 4 frames, two
# ConvLSTM layers of 8)
SMALL_CAPSNET = dict(conv=16, capsules=4, capsule_dim=4, kernel=5, primary_kernel=3, classes=2,
                     digit_dim=8, hw=12, lr=3e-3)
SMALL_CONVLSTM = dict(channels=4, widths=(8, 8), kernel=3, frames=4, hw=8)


def small_capsnet(C, U):
    """The 12x12 CapsNet of the JAX package's test in the package ``C``/``U``."""
    return capsnet_conf(C, U, **SMALL_CAPSNET)


def bars_batch(batch, seed=0):
    """The JAX package's CapsNet test data: 12x12 noise with a horizontal
    bar (class 0) or a vertical one (class 1)."""
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 2, batch)
    x = rs.randn(batch, 1, 12, 12).astype(np.float32) * 0.1
    for i, c in enumerate(y):
        if c == 0:
            x[i, 0, 3, :] += 2.0
        else:
            x[i, 0, :, 3] += 2.0
    return x, np.eye(2, dtype=np.float32)[y]


def small_frames(batch, seed=0):
    """4 frames of 16x16 moving blobs cut into 2x2 patches: [B, 4, 4, 8, 8]."""
    return frame_batch(batch, frames=4, size=16, block=2, seed=seed)


def mask_zero_stack(C, U):
    """MaskZeroLayer(LSTM 5) → TimeDistributed(Dense 4, tanh) → per-step
    softmax, Adam, on 3 features x 6 steps (tests/test_torch_layers_nets.py)."""
    L = C.LAYER_REGISTRY
    return (C.NeuralNetConfiguration.Builder().seed(3).updater(U.Adam(1e-2)).list()
            .layer(L["MaskZeroLayer"](underlying=C.LSTM(n_in=3, n_out=5)))
            .layer(L["TimeDistributed"](underlying=C.DenseLayer(n_out=4, activation="tanh")))
            .layer(C.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(C.InputType.recurrent(3, 6)).build())


def padded_sequences(batch, seed=0):
    """[B, 3, 6] normal sequences, the first one's last two steps zero
    (MaskZeroLayer's padding), and one-hot [B, 3, 6] labels."""
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, 3, 6).astype(np.float32)
    x[0, :, 4:] = 0.0
    return x, np.eye(3, dtype=np.float32)[rs.randint(0, 3, (batch, 6))].transpose(0, 2, 1)


def _jax_conf(build):
    def conf():
        import deeplearning4j_tpu.nn  # noqa: F401  (registers the whole layer set)
        from deeplearning4j_tpu.nn import conf as JC
        from deeplearning4j_tpu.nn import updaters as JU

        return build(JC, JU)

    return conf


# (name, conf, input shape, classes, batch, JAX counterpart for --jax: a
# zoo model's (name, kwargs), or a function that builds the JAX configuration)
CONFIGS = [
    ("resnet50_224_b4", lambda: M.ResNet50().conf(), (3, 224, 224), 1000, 4, None),
    ("inception_160_b4", lambda: no_dropout(M.InceptionResNetV1().conf()), (3, 160, 160), 1001,
     4, None),
    ("resnet50_64_c10_b2", lambda: M.ResNet50(num_classes=10, input_shape=(3, 64, 64)).conf(),
     (3, 64, 64), 10, 2, ("ResNet50", dict(num_classes=10, input_shape=(3, 64, 64)))),
    ("inception_96_c7_b2", lambda: no_dropout(M.InceptionResNetV1(
        num_classes=7, input_shape=(3, 96, 96), blocks=(1, 1, 1), embedding_size=32).conf()),
     (3, 96, 96), 7, 2, ("InceptionResNetV1", dict(num_classes=7, input_shape=(3, 96, 96),
                                                   blocks=(1, 1, 1), embedding_size=32))),
] + [
    (f"{name.lower()}_{getattr(M, name)().input_shape[1]}_b{4 if name in ZOO_BN else 2}",
     _zoo(name), getattr(M, name)().input_shape, _classes(name, {}), 4 if name in ZOO_BN else 2,
     None) for name in ZOO_SMALL
] + [
    (f"{name.lower()}_{kw['input_shape'][1]}_b2", _zoo(name, **kw), kw["input_shape"],
     _classes(name, kw), 2, (name, kw)) for name, kw in ZOO_SMALL.items()
] + [
    ("lrn_stack_9x8_b4", lambda: lrn_stack(C, U), (2, 9, 8), 3, 4, _jax_lrn_stack),
    ("capsnet_28_b4", lambda: capsnet_conf(C, U), (1, 28, 28), digit_batch, 4, None),
    ("convlstm_16_b2", lambda: convlstm_conf(C, U), (16, 10, 16, 16), frame_batch, 2, None),
    ("capsnet_12_b4", lambda: small_capsnet(C, U), (1, 12, 12), bars_batch, 4,
     _jax_conf(small_capsnet)),
    ("convlstm_8_b2", lambda: convlstm_conf(C, U, **SMALL_CONVLSTM), (4, 4, 8, 8), small_frames,
     2, _jax_conf(lambda JC, JU: convlstm_conf(JC, JU, **SMALL_CONVLSTM))),
    ("mask_zero_stack_b3", lambda: mask_zero_stack(C, U), (3, 6), padded_sequences, 3,
     _jax_conf(mask_zero_stack)),
    ("tinyyolo_416_b2", lambda: M.TinyYOLO().conf(), (3, 416, 416), yolo_batch, 2, None),
]


def _jax_net(jax_model):
    """The JAX package's network of the configuration, initialised (its
    weights are the ones the parity tests use), dropout off."""
    from deeplearning4j_tpu import models as J
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    if callable(jax_model):
        conf = jax_model()
    else:
        name, kw = jax_model
        conf = no_dropout(getattr(J, name)(**kw).conf())
    if hasattr(conf, "layers"):
        return JNet(conf).init()
    jnet = JGraph(conf)
    jnet.init()
    return jnet


def _jax_distances(jnet, f64, before, x, y, eager=False):
    """The JAX network's float32 step (compiled, or with ``eager`` run op by
    op under ``jax.disable_jit``) against the port's float64 step from the
    same weights."""
    import contextlib

    import jax

    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet

    with jax.disable_jit() if eager else contextlib.nullcontext():
        jnet.fit(JDataSet(x, y))
    params = jax.tree.map(np.asarray, jnet.params_)
    after = {(n, k): w.astype(np.float64) for n, d in params.items() for k, w in d.items()}
    bn = {(_bn_key(f64, n), s): np.asarray(st[s], np.float64)
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
    f32 = _bridge(_net(conf_fn(), "cpu"), weights)
    conf64 = conf_fn()
    conf64.dtype = "float64"
    f64 = _net(conf64, "cpu")
    f64.set_params(f32.params().double())
    xt = torch.from_numpy(x)
    if isinstance(f32, ComputationGraph):
        _, moved = f32._forward(f32._params(), f32._bn(), {"input": xt}, training=True, rng=None)
    else:
        _, moved, _ = f32._forward(f32._params(), f32._bn(), xt, training=True, rng=None)
    decay = 0.9  # new = decay * old + (1 - decay) * batch; old: mean 0, var 1
    stats = {n: {"mean": moved[n]["mean"].double() / (1 - decay),
                 "var": (moved[n]["var"].double() - decay) / (1 - decay)} for n in moved}
    with torch.no_grad():
        for n, st in stats.items():
            for net in (f32, f64):
                for k in ("mean", "var"):
                    getattr(net.bn_state[_bn_key(net, n)], k).copy_(st[k])
    jnet.bn_state = {n: {k: jnp.asarray(v.float().numpy()) for k, v in st.items()}
                     for n, st in stats.items()}

    def first(out):
        return out[0] if isinstance(out, list) else out

    ref = first(f64.output(x.astype(np.float64))).numpy()
    return {"port_float32": float(np.abs(first(f32.output(x)).double().numpy() - ref).max()),
            "jax_float32": float(np.abs(np.asarray(first(jnet.output(x)).numpy(), np.float64)
                                        - ref).max()),
            "largest_probability": float(ref.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch's CPU threads (0: its default; the parity tests run on 1)")
    ap.add_argument("--only", default="", help="run the configurations whose names start "
                                               "with one of these comma-separated prefixes")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    # float32 products and convolutions in full float32, also on the card
    env().set("matmul_precision", "float32")
    set_fp32_numerics()
    for name, conf_fn, shape, classes, batch, jax_model in CONFIGS:
        if not name.startswith(tuple(args.only.split(","))):
            continue
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
            line["jax_float32_eager"] = _jax_distances(_jax_net(jax_model), f64, before, x, y,
                                                       eager=True)
            line["inference_output_abs"] = outputs
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
