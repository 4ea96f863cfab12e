"""The port's YOLOv2 head and TinyYOLO (``deeplearning4j_tpu_torch.models.yolo``)
against the JAX package's ``models/yolo.py`` on the same numpy inputs, and
the TinyYOLO network's steps from carried weights.

Tolerances: activations, the loss and its gradient within 1e-5 (relative
to the largest magnitude; float32 elementwise math and sums over a few
hundred terms); detections equal field by field within 1e-6 (host floats of
float32 activations); the network's steps within the MultiLayerNetwork
limits of ``torch_mln_helpers`` (score 1e-5 relative, each update 1e-4 of
its norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import yolo as J
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models import yolo as T
from deeplearning4j_tpu_torch.nn import conf as TC
from torch_mln_helpers import GRAD_REL, LOSS_REL, port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

REL = 1e-5
ANCHORS = np.array([[1.0, 1.0], [3.0, 3.0]], np.float32)
# TinyYOLO at the JAX package's defaults (416x416, 20 classes, the five VOC
# anchors, base 16, 5 downsamples): chip_smoke.py's TINYYOLO_PARAMS
TINYYOLO_PARAMS = 1_637_389


def _label(B=2, C=2, H=4, W=4):
    """One object per image: class 0 box at cell (1,2), class 1 at (3,0)
    (``tests/test_yolo.py``'s labels)."""
    lab = np.zeros((B, 4 + C, H, W), np.float32)
    lab[:, 0:4, 2, 1] = [1.0, 1.8, 2.2, 2.9]   # x1,y1,x2,y2 (grid units)
    lab[:, 4, 2, 1] = 1.0
    lab[:, 0:4, 0, 3] = [2.6, 0.1, 3.9, 1.2]
    lab[:, 5, 0, 3] = 1.0
    return lab


def _pred(seed, scale=1.0, B=2):
    p = (np.random.RandomState(seed).randn(B, 2 * 7, 4, 4) * scale).astype(np.float32)
    p[0, 2, 0, 0], p[0, 3, 1, 1], p[1, 9, 2, 2] = 8.0, -8.0, 8.0  # on the wh clip's bounds
    return p


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def test_activate_equals_jax():
    pred = _pred(0, 3.0)
    got = T.yolo2_activate(torch.from_numpy(pred), torch.from_numpy(ANCHORS))
    want = J.yolo2_activate(jnp.asarray(pred), jnp.asarray(ANCHORS))
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g.numpy(), w) <= REL


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 3.0), (2, 0.1)])
def test_loss_and_its_gradient_equal_jax(seed, scale):
    pred, lab = _pred(seed, scale), _label()
    jl, jg = jax.jit(jax.value_and_grad(lambda p, y: J.yolo2_loss(p, y, ANCHORS)))(
        jnp.asarray(pred), jnp.asarray(lab))
    tp = torch.from_numpy(pred).requires_grad_()
    tl = T.yolo2_loss(tp, torch.from_numpy(lab), ANCHORS)
    (tg,) = torch.autograd.grad(tl, tp)
    assert abs(float(tl) - float(jl)) <= REL * abs(float(jl))
    assert _rel(tg.numpy(), jg) <= REL
    # the clip's bounds pass half the gradient, as jnp.clip's do
    np.testing.assert_allclose(tg.numpy()[0, 2, 0, 0], np.asarray(jg)[0, 2, 0, 0],
                               rtol=1e-5, atol=1e-8)


def test_iou_and_nms_equal_jax():
    boxes = [(2.0, 2.0, 2.0, 2.0, 0, 0.9), (2.2, 2.1, 2.0, 2.0, 0, 0.7),
             (6.0, 6.0, 2.0, 2.0, 0, 0.8), (2.1, 2.0, 2.0, 2.0, 1, 0.6),
             (2.05, 2.0, 1.8, 2.1, 1, 0.65), (0.0, 0.0, 0.0, 0.0, 2, 0.5)]
    tj = [J.DetectedObject(*b) for b in boxes]
    tt = [T.DetectedObject(*b) for b in boxes]
    for i in range(len(boxes)):
        for j in range(len(boxes)):
            assert T.iou(tt[i], tt[j]) == J.iou(tj[i], tj[j])
    for thr in (0.2, 0.4, 0.9):
        got = [tuple(vars(o).values()) for o in T.nms(tt, thr)]
        assert got == [tuple(vars(o).values()) for o in J.nms(tj, thr)]


def _same_objects(got, want):
    assert len(got) == len(want)
    for g_img, w_img in zip(got, want):
        assert len(g_img) == len(w_img)
        for g, w in zip(g_img, w_img):
            assert g.predicted_class == w.predicted_class
            for f in ("center_x", "center_y", "width", "height", "confidence"):
                assert abs(getattr(g, f) - getattr(w, f)) <= 1e-6 * max(1.0, abs(getattr(w, f)))


@pytest.mark.parametrize("apply_nms", [True, False])
def test_predicted_objects_equal_jax(apply_nms):
    pred = _pred(3, 2.0, B=3)
    for thr in (0.3, 0.6):
        want = J.get_predicted_objects(pred, ANCHORS, threshold=thr, apply_nms=apply_nms)
        _same_objects(T.get_predicted_objects(pred, ANCHORS, threshold=thr,
                                              apply_nms=apply_nms), want)
        _same_objects(T.get_predicted_objects(torch.from_numpy(pred), ANCHORS, threshold=thr,
                                              apply_nms=apply_nms), want)
    assert sum(map(len, want)) > 0


SMALL = dict(n_classes=2, input_shape=(3, 16, 16), anchors=((1.0, 1.0), (2.0, 2.0)),
             base_filters=4, downsamples=2)


def test_small_tinyyolo_five_steps_from_carried_weights():
    jnet = J.TinyYOLO(**SMALL).init()
    tnet = port_net(jnet, T.TinyYOLO(**SMALL).conf())
    assert tnet.num_params() == jnet.num_params()
    rs = np.random.RandomState(0)
    x = rs.rand(2, 3, 16, 16).astype(np.float32)
    lab = _label(B=2, C=2, H=4, W=4)
    jscores, tscores = [], []
    for _ in range(5):
        jnet._fit_batch(JDataSet(x, lab))
        tnet._fit_batch(DataSet(x, lab))
        jscores.append(float(jnet.score_))
        tscores.append(float(tnet.score_))
    for js, ts in zip(jscores, tscores):
        assert abs(ts - js) <= LOSS_REL * abs(js)
    assert tscores[-1] < tscores[0]
    jp = jax.tree.map(np.asarray, jnet.params_)
    for si, pd in tnet.params_.items():
        for k, p in pd.items():
            want = jp[si][k]
            err = np.linalg.norm(p.detach().numpy() - want) / np.linalg.norm(want)
            assert err <= GRAD_REL, (si, k, err)
    for si, st in tnet.bn_state.items():
        np.testing.assert_allclose(st.mean.numpy(), np.asarray(jnet.bn_state[si]["mean"]),
                                   rtol=1e-4, atol=1e-6)


def test_full_width_parameter_count_and_the_registry():
    """The JAX package's defaults (counted from ``jax.eval_shape`` of its
    init: the eager init takes ~14 s) give the count chip_smoke.py holds the
    card's network to; the head is not a registered layer in either
    package."""
    jconf = J.TinyYOLO().conf()
    shapes = jax.eval_shape(lambda: JNet(jconf).init().params_)
    jcount = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert jcount == TINYYOLO_PARAMS
    assert T.TinyYOLO().init(device="cpu").num_params() == TINYYOLO_PARAMS
    assert "Yolo2OutputLayer" not in TC.LAYER_REGISTRY
    with pytest.raises(RuntimeError, match="cuda"):
        T.TinyYOLO(**SMALL).init()
