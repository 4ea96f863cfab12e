"""YOLOv2 object-detection head and TinyYOLO (counterpart of
``deeplearning4j_tpu/models/yolo.py``).

Reference: ``org.deeplearning4j.nn.layers.objdetect.Yolo2OutputLayer`` +
``YoloUtils`` (NMS, predicted-object extraction) and the zoo's ``TinyYOLO``.
Label format follows the reference: [B, 4+C, H, W] — for each grid cell
holding an object center, channels 0..3 are the box corners (x1,y1,x2,y2 in
GRID units) and 4.. the one-hot class.

The loss (responsible-anchor assignment by IoU, coord / confidence / class
terms) is dense tensor code in at least float32, as in the JAX package; NMS and object
extraction are host-side numpy. ``Yolo2OutputLayer`` is not in
``LAYER_REGISTRY`` (nor is it in the JAX package's), so a TinyYOLO
configuration does not round-trip through JSON.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.conf import InputType, Layer
from .vae import _clip


def yolo2_activate(pred_raw, anchors):
    """[B, A*(5+C), H, W] raw conv output → (xy [B,A,2,H,W] cell-relative,
    wh [B,A,2,H,W] grid units, conf [B,A,H,W], class probs [B,A,C,H,W])."""
    A = anchors.shape[0]
    B, ch, H, W = pred_raw.shape
    C = ch // A - 5
    p = pred_raw.reshape(B, A, 5 + C, H, W)
    xy = torch.sigmoid(p[:, :, 0:2])
    wh = torch.exp(_clip(p[:, :, 2:4], -8.0, 8.0)) * anchors[None, :, :, None, None]
    conf = torch.sigmoid(p[:, :, 4])
    cls = torch.softmax(p[:, :, 5:], dim=2)
    return xy, wh, conf, cls


def _iou_wh(wh1, wh2):
    """IoU of boxes sharing a center, by (w, h). wh1 [...,2], wh2 [...,2]."""
    inter = torch.minimum(wh1[..., 0], wh2[..., 0]) * torch.minimum(wh1[..., 1], wh2[..., 1])
    union = wh1[..., 0] * wh1[..., 1] + wh2[..., 0] * wh2[..., 1] - inter
    return inter / torch.maximum(union, union.new_tensor(1e-9))


def yolo2_loss(pred_raw, labels, anchors, *, lambda_coord: float = 5.0,
               lambda_noobj: float = 0.5):
    """YOLOv2 loss (Yolo2OutputLayer.computeScore): squared-error terms on
    coords (responsible anchor only), confidence (object=1/noobj), and class
    distribution. labels [B, 4+C, H, W] per the reference layout. Computed in
    float32, or float64 for float64 maps (the float32 anchors promote the
    maps as jnp promotes them)."""
    dt = torch.promote_types(pred_raw.dtype, torch.float32)
    pred_raw = pred_raw.to(dt)
    labels = labels.to(dt)
    anchors = torch.as_tensor(np.asarray(anchors, np.float32), device=pred_raw.device).to(dt)
    xy, wh, conf, cls = yolo2_activate(pred_raw, anchors)
    B, A, _, H, W = xy.shape

    x1, y1, x2, y2 = (labels[:, i] for i in range(4))       # [B, H, W] grid units
    obj_mask = ((x2 - x1) > 0).float()                      # cell has an object
    gt_wh = torch.stack([x2 - x1, y2 - y1], dim=1)          # [B, 2, H, W]
    gt_cxy = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2], dim=1)
    # center offset within the cell
    cell_x = torch.arange(W, device=labels.device)[None, None, :]
    cell_y = torch.arange(H, device=labels.device)[None, :, None]
    gt_off = torch.stack([gt_cxy[:, 0] - cell_x, gt_cxy[:, 1] - cell_y], dim=1)
    gt_off = _clip(gt_off, 0.0, 1.0)

    # responsible anchor per labeled cell: best shape-IoU with the gt box
    # (argmax takes the first of equal values, as jnp.argmax does)
    gt_last = gt_wh.movedim(1, -1)                           # [B, H, W, 2]
    iou_a = _iou_wh(gt_last[:, None], anchors[None, :, None, None, :])  # [B,A,H,W]
    resp = F.one_hot(torch.argmax(iou_a, dim=1), A).movedim(-1, 1).float()
    resp = resp * obj_mask[:, None]

    # predicted-box IoU with gt (shared center approximation for conf target)
    iou_pred = _iou_wh(wh.movedim(2, -1), gt_last[:, None])  # [B,A,H,W]

    gt_root = torch.sqrt(torch.maximum(gt_wh, gt_wh.new_tensor(1e-9)))
    coord = lambda_coord * torch.sum(resp[:, :, None] * (
        torch.square(xy - gt_off[:, None])
        + torch.square(torch.sqrt(wh) - gt_root[:, None])))
    obj = torch.sum(resp * torch.square(conf - iou_pred.detach()))
    noobj = lambda_noobj * torch.sum((1.0 - resp) * torch.square(conf))
    gt_cls = labels[:, 4:]                                   # [B, C, H, W]
    clsl = torch.sum(resp[:, :, None] * torch.square(cls - gt_cls[:, None]))
    return (coord + obj + noobj + clsl) / B


@dataclass
class Yolo2OutputLayer(Layer):
    """conf.layers.objdetect.Yolo2OutputLayer: loss head over the raw conv
    feature map; anchors in grid units [(w, h), ...]."""

    anchors: Tuple = ((1.0, 1.0), (2.0, 2.0))
    lambda_coord: float = 5.0
    lambda_noobj: float = 0.5

    def has_params(self):
        return False

    def output_type(self, it: InputType) -> InputType:
        return it

    def forward(self, params, x, it, *, training, rng=None):
        return x  # raw maps out; activation/NMS happen in YoloUtils

    def compute_loss(self, params, x, labels, it, *, training, rng=None, mask=None):
        return yolo2_loss(x, labels, np.asarray(self.anchors, np.float32),
                          lambda_coord=self.lambda_coord,
                          lambda_noobj=self.lambda_noobj)


@dataclasses.dataclass
class DetectedObject:
    """org.deeplearning4j.nn.layers.objdetect.DetectedObject."""

    center_x: float
    center_y: float
    width: float
    height: float
    predicted_class: int
    confidence: float

    def top_left(self):
        return (self.center_x - self.width / 2, self.center_y - self.height / 2)

    def bottom_right(self):
        return (self.center_x + self.width / 2, self.center_y + self.height / 2)


def iou(a: DetectedObject, b: DetectedObject) -> float:
    ax1, ay1 = a.top_left(); ax2, ay2 = a.bottom_right()  # noqa: E702
    bx1, by1 = b.top_left(); bx2, by2 = b.bottom_right()  # noqa: E702
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = a.width * a.height + b.width * b.height - inter
    return inter / union if union > 0 else 0.0


def nms(objs: List[DetectedObject], iou_threshold: float = 0.5) -> List[DetectedObject]:
    """YoloUtils.nms: greedy per-class suppression by confidence."""
    out: List[DetectedObject] = []
    for cls in {o.predicted_class for o in objs}:
        group = sorted([o for o in objs if o.predicted_class == cls],
                       key=lambda o: -o.confidence)
        keep: List[DetectedObject] = []
        for o in group:
            if all(iou(o, k) <= iou_threshold for k in keep):
                keep.append(o)
        out.extend(keep)
    return sorted(out, key=lambda o: -o.confidence)


@torch.no_grad()
def get_predicted_objects(pred_raw, anchors, threshold: float = 0.5,
                          apply_nms: bool = True,
                          iou_threshold: float = 0.5) -> List[List[DetectedObject]]:
    """YoloUtils.getPredictedObjects: threshold confidences, build grid-unit
    boxes, optional NMS; returns one list per batch element. ``pred_raw`` is
    a tensor (activated on its device, in at least float32) or an array (on
    the CPU)."""
    raw = torch.as_tensor(pred_raw)
    raw = raw.to(torch.promote_types(raw.dtype, torch.float32))
    xy, wh, conf, cls = yolo2_activate(
        raw, torch.as_tensor(np.asarray(anchors, np.float32), device=raw.device).to(raw.dtype))
    xy, wh, conf, cls = (t.cpu().numpy() for t in (xy, wh, conf, cls))
    B, A, _, H, W = xy.shape
    results = []
    for b in range(B):
        objs = []
        for a in range(A):
            ys, xs = np.nonzero(conf[b, a] > threshold)
            for y, x in zip(ys, xs):
                objs.append(DetectedObject(
                    center_x=float(x + xy[b, a, 0, y, x]),
                    center_y=float(y + xy[b, a, 1, y, x]),
                    width=float(wh[b, a, 0, y, x]),
                    height=float(wh[b, a, 1, y, x]),
                    predicted_class=int(cls[b, a, :, y, x].argmax()),
                    confidence=float(conf[b, a, y, x])))
        results.append(nms(objs, iou_threshold) if apply_nms else objs)
    return results


class TinyYOLO:
    """org.deeplearning4j.zoo.model.TinyYOLO: darknet-tiny conv backbone +
    Yolo2OutputLayer head (anchors in grid units)."""

    def __init__(self, n_classes: int = 20, seed: int = 123,
                 input_shape: Tuple[int, int, int] = (3, 416, 416),
                 anchors: Sequence[Tuple[float, float]] = (
                     (1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                     (9.42, 5.11), (16.62, 10.52)),
                 base_filters: int = 16, downsamples: int = 5):
        self.n_classes = n_classes
        self.seed = seed
        self.input_shape = input_shape
        self.anchors = tuple(anchors)
        self.base = base_filters
        self.downsamples = downsamples

    def conf(self):
        from ..nn.conf import (
            ActivationLayer,
            BatchNormalization,
            ConvolutionLayer,
            NeuralNetConfiguration,
            SubsamplingLayer,
        )
        from ..nn.updaters import Adam

        c, h, w = self.input_shape
        A = len(self.anchors)
        b = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).list())
        f = self.base
        for _ in range(self.downsamples):
            b.layer(ConvolutionLayer(n_out=f, kernel_size=(3, 3),
                                     convolution_mode="same",
                                     activation="identity", has_bias=False))
            b.layer(BatchNormalization())
            b.layer(ActivationLayer(activation="leakyrelu"))
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            f = min(f * 2, 512)
        b.layer(ConvolutionLayer(n_out=f, kernel_size=(3, 3),
                                 convolution_mode="same", activation="leakyrelu"))
        b.layer(ConvolutionLayer(n_out=A * (5 + self.n_classes),
                                 kernel_size=(1, 1), activation="identity"))
        b.layer(Yolo2OutputLayer(anchors=self.anchors))
        b.set_input_type(InputType.convolutional(h, w, c))
        return b.build()

    def init(self, *, device="cuda"):
        from ..nn.multilayer import MultiLayerNetwork

        return MultiLayerNetwork(self.conf(), device=device).init()
