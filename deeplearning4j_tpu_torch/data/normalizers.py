"""Data normalizers with fit/transform/revert and serialization.

Counterpart of ``deeplearning4j_tpu/data/normalizers.py`` (nd4j's
``NormalizerStandardize``, ``NormalizerMinMaxScaler`` and
``ImagePreProcessingScaler``): fit over an iterator (streaming statistics),
transform DataSets in place on the host, revert predictions, save and
restore as JSON. The host half is a copy of the JAX package's.

Every normalizer also has ``device_transform``: the same arithmetic as
``transform`` as a torch function of a tensor, so normalization can run
inside the network's step on the card. The host then ships raw uint8
pixels (a quarter of float32's bytes over the host-to-device link) and the
cast, scale and mean subtraction run on the card. ``make_device_ingest``
packages the layout change (NHWC wire to the NCHW the convolutions take),
the cast and the normalization into one function for
``MultiLayerNetwork.set_device_ingest`` and
``ComputationGraph.set_device_ingest``.

This module imports torch only inside the device functions: a process that
normalizes on the host (an ETL worker) never loads it.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np


def _stat(a, x):
    """A host statistic as a tensor on ``x``'s device."""
    import torch

    return torch.as_tensor(a, device=x.device)


class Normalizer:
    def fit(self, data) -> "Normalizer":
        raise NotImplementedError

    def transform(self, ds) -> None:
        raise NotImplementedError

    def device_transform(self, x):
        """``transform`` as a torch function of a tensor: ``x`` is the raw
        wire batch (any dtype, on any device); returns float32 there."""
        raise NotImplementedError

    def pre_process(self, ds) -> None:
        self.transform(ds)

    preProcess = pre_process

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self._state(), f)

    @classmethod
    def restore(cls, path: str):
        with open(path) as f:
            state = json.load(f)
        obj = cls.__new__(cls)
        obj._load(state)
        return obj


class NormalizerStandardize(Normalizer):
    """Zero-mean unit-variance per feature; streaming fit over an iterator."""

    def __init__(self, fit_labels: bool = False):
        self.fit_labels = fit_labels
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None
        self.label_mean = None
        self.label_std = None

    @staticmethod
    def _feature_axes(x):
        # statistics per feature: reduce batch (+time for [B,C,T], +spatial)
        return (0,) if x.ndim == 2 else (0,) + tuple(range(2, x.ndim))

    def fit(self, data) -> "NormalizerStandardize":
        # accepts a DataSet or an iterator (streaming sums in float64)
        n, s, s2 = 0, 0.0, 0.0
        ln, ls, ls2 = 0, 0.0, 0.0
        for ds in self._iter(data):
            x = _host(ds.features).astype(np.float64)
            ax = self._feature_axes(x)
            n += int(np.prod([x.shape[a] for a in ax]))
            s = s + x.sum(axis=ax)
            s2 = s2 + np.square(x).sum(axis=ax)
            if self.fit_labels:
                y = _host(ds.labels).astype(np.float64)
                lax = self._feature_axes(y)
                ln += int(np.prod([y.shape[a] for a in lax]))
                ls = ls + y.sum(axis=lax)
                ls2 = ls2 + np.square(y).sum(axis=lax)
        self.mean = (s / n).astype(np.float32)
        self.std = np.sqrt(np.maximum(s2 / n - np.square(s / n), 1e-12)).astype(np.float32)
        if self.fit_labels and ln:
            self.label_mean = (ls / ln).astype(np.float32)
            self.label_std = np.sqrt(np.maximum(ls2 / ln - np.square(ls / ln),
                                                1e-12)).astype(np.float32)
        return self

    @staticmethod
    def _iter(data):
        if hasattr(data, "features"):
            return [data]
        data.reset() if hasattr(data, "reset") else None
        return data

    def _shape_for(self, x):
        extra = x.ndim - 2
        return self.mean.reshape((1, -1) + (1,) * extra)

    def transform(self, ds) -> None:
        x = np.asarray(ds.features, np.float32)
        m = self._shape_for(x)
        sd = self.std.reshape(m.shape)
        ds.features = (x - m) / sd
        if self.fit_labels and self.label_mean is not None and ds.labels is not None:
            y = np.asarray(ds.labels, np.float32)
            lm = self.label_mean.reshape((1, -1) + (1,) * (y.ndim - 2))
            lsd = self.label_std.reshape(lm.shape)
            ds.labels = (y - lm) / lsd

    def device_transform(self, x):
        import torch

        x = x.to(torch.float32)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        m = _stat(self.mean, x).reshape(shape)
        sd = _stat(self.std, x).reshape(shape)
        return (x - m) / sd

    def revert_features(self, x: np.ndarray) -> np.ndarray:
        m = self._shape_for(x)
        return x * self.std.reshape(m.shape) + m

    def revert_labels(self, y: np.ndarray) -> np.ndarray:
        if self.label_mean is None:
            return y
        lm = self.label_mean.reshape((1, -1) + (1,) * (y.ndim - 2))
        return y * self.label_std.reshape(lm.shape) + lm

    revertFeatures = revert_features
    revertLabels = revert_labels

    def _state(self):
        return {"kind": "standardize", "fit_labels": self.fit_labels,
                "mean": self.mean.tolist(), "std": self.std.tolist(),
                "label_mean": None if self.label_mean is None else self.label_mean.tolist(),
                "label_std": None if self.label_std is None else self.label_std.tolist()}

    def _load(self, d):
        self.fit_labels = d["fit_labels"]
        self.mean = np.asarray(d["mean"], np.float32)
        self.std = np.asarray(d["std"], np.float32)
        self.label_mean = (None if d["label_mean"] is None
                           else np.asarray(d["label_mean"], np.float32))
        self.label_std = (None if d["label_std"] is None
                          else np.asarray(d["label_std"], np.float32))


class NormalizerMinMaxScaler(Normalizer):
    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None

    def fit(self, data) -> "NormalizerMinMaxScaler":
        mn, mx = None, None
        for ds in NormalizerStandardize._iter(data):
            x = _host(ds.features).astype(np.float64)
            ax = NormalizerStandardize._feature_axes(x)
            bmn, bmx = x.min(axis=ax), x.max(axis=ax)
            mn = bmn if mn is None else np.minimum(mn, bmn)
            mx = bmx if mx is None else np.maximum(mx, bmx)
        self.data_min = mn.astype(np.float32)
        self.data_max = mx.astype(np.float32)
        return self

    def transform(self, ds) -> None:
        x = np.asarray(ds.features, np.float32)
        extra = x.ndim - 2
        mn = self.data_min.reshape((1, -1) + (1,) * extra)
        mx = self.data_max.reshape(mn.shape)
        scale = np.maximum(mx - mn, 1e-12)
        ds.features = (x - mn) / scale * (self.max_range - self.min_range) + self.min_range

    def device_transform(self, x):
        import torch

        x = x.to(torch.float32)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mn = _stat(self.data_min, x).reshape(shape)
        mx = _stat(self.data_max, x).reshape(shape)
        scale = torch.clamp(mx - mn, min=1e-12)
        return (x - mn) / scale * (self.max_range - self.min_range) + self.min_range

    def revert_features(self, x: np.ndarray) -> np.ndarray:
        extra = x.ndim - 2
        mn = self.data_min.reshape((1, -1) + (1,) * extra)
        mx = self.data_max.reshape(mn.shape)
        return (x - self.min_range) / (self.max_range - self.min_range) * (mx - mn) + mn

    def _state(self):
        return {"kind": "minmax", "min_range": self.min_range, "max_range": self.max_range,
                "data_min": self.data_min.tolist(), "data_max": self.data_max.tolist()}

    def _load(self, d):
        self.min_range, self.max_range = d["min_range"], d["max_range"]
        self.data_min = np.asarray(d["data_min"], np.float32)
        self.data_max = np.asarray(d["data_max"], np.float32)


class ImagePreProcessingScaler(Normalizer):
    """Scale pixel values [0,255] → [min,max] (no fit statistics needed)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_pixel: float = 255.0):
        self.min_range = min_range
        self.max_range = max_range
        self.max_pixel = max_pixel

    def fit(self, data):
        return self

    def transform(self, ds) -> None:
        x = np.asarray(ds.features, np.float32)
        ds.features = x / self.max_pixel * (self.max_range - self.min_range) + self.min_range

    def device_transform(self, x):
        import torch

        x = x.to(torch.float32)
        # divide by a tensor, not a Python number: CUDA divides by a host
        # scalar as a multiplication by its reciprocal, one rounding off the
        # host's IEEE division
        pixel = torch.full((), self.max_pixel, dtype=torch.float32, device=x.device)
        return x / pixel * (self.max_range - self.min_range) + self.min_range

    def revert_features(self, x: np.ndarray) -> np.ndarray:
        return (x - self.min_range) / (self.max_range - self.min_range) * self.max_pixel

    def _state(self):
        return {"kind": "image", "min_range": self.min_range, "max_range": self.max_range,
                "max_pixel": self.max_pixel}

    def _load(self, d):
        self.min_range, self.max_range = d["min_range"], d["max_range"]
        self.max_pixel = d["max_pixel"]


def _host(a) -> np.ndarray:
    """A batch array as host numpy (a staged tensor is copied back)."""
    if isinstance(a, np.ndarray):
        return a
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def make_device_ingest(normalizer: Optional[Normalizer] = None,
                       source_layout: str = "NCHW"):
    """The on-device ingest function of a narrow-wire input pipeline: raw
    wire batch → float32 NCHW, normalized, run inside the network's step
    (``net.set_device_ingest(...)``).

    ``source_layout="NHWC"`` permutes decode-layout uint8 batches to the
    NCHW the convolutions take, on the card, after the (4x smaller) uint8
    copy. The permuted batch is a view whose strides are channels-last:
    it is not made contiguous, so the first convolution reads the wire
    layout through cuDNN's NHWC path and no transposing copy of the batch
    is made. Normalization runs after the permute, so per-channel
    statistics line up with the host ``Normalizer.transform`` of NCHW float
    batches.
    """
    if source_layout not in ("NCHW", "NHWC"):
        raise ValueError(f"source_layout must be NCHW or NHWC, got {source_layout!r}")

    def ingest(x):
        import torch

        x = x.to(torch.float32)
        if source_layout == "NHWC" and x.dim() == 4:
            x = x.permute(0, 3, 1, 2)
        if normalizer is not None:
            x = normalizer.device_transform(x)
        return x

    return ingest
