"""DataSet and MultiDataSet containers.

Copies of ``DataSet`` and ``MultiDataSet`` from
``deeplearning4j_tpu/data/dataset.py`` (nd4j's
``org.nd4j.linalg.dataset.DataSet``: features, labels, featuresMask,
labelsMask; ``MultiDataSet``: lists of each, for a ComputationGraph with
several inputs or outputs). Arrays are host numpy until the network moves them to its
device; a tensor already on a CUDA card passes through as it is (a batch
staged on the device is not copied back to the host).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import numpy as np


def _to_np(x):
    if x is None or isinstance(x, np.ndarray):
        return x
    # a tensor exists only where torch is imported: this module imports
    # nothing of torch, so the ETL service's worker processes never load it
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor):
        return x if x.device.type != "cpu" else x.numpy()
    if hasattr(x, "numpy"):
        return x.numpy()
    return np.asarray(x)


class DataSet:
    def __init__(self, features=None, labels=None, features_mask=None, labels_mask=None):
        self.features = _to_np(features)
        self.labels = _to_np(labels)
        self.features_mask = _to_np(features_mask)
        self.labels_mask = _to_np(labels_mask)

    def num_examples(self) -> int:
        return 0 if self.features is None else self.features.shape[0]

    def get_features(self):
        return self.features

    def get_labels(self):
        return self.labels

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.num_examples())
        self.features = self.features[perm]
        if self.labels is not None:
            self.labels = self.labels[perm]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[perm]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[perm]
        return self

    def _slice(self, s) -> "DataSet":
        return DataSet(
            self.features[s],
            None if self.labels is None else self.labels[s],
            None if self.features_mask is None else self.features_mask[s],
            None if self.labels_mask is None else self.labels_mask[s],
        )

    def split_test_and_train(self, n_train: int):
        return self._slice(slice(None, n_train)), self._slice(slice(n_train, None))

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [self._slice(slice(i, i + batch_size))
                for i in range(0, self.num_examples(), batch_size)]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        def cat(name):
            first = getattr(datasets[0], name)
            return None if first is None else np.concatenate([getattr(d, name) for d in datasets])

        return DataSet(cat("features"), cat("labels"), cat("features_mask"), cat("labels_mask"))

    def __repr__(self):
        f = None if self.features is None else tuple(self.features.shape)
        l = None if self.labels is None else tuple(self.labels.shape)
        return f"DataSet(features={f}, labels={l})"


class MultiDataSet:
    """org.nd4j.linalg.dataset.MultiDataSet: N features, M labels + masks."""

    def __init__(self, features=None, labels=None, features_masks=None, labels_masks=None):
        def as_list(x):
            if x is None:
                return None
            return [_to_np(a) for a in (x if isinstance(x, (list, tuple)) else [x])]

        self.features = as_list(features) or []
        self.labels = as_list(labels) or []
        self.features_masks = as_list(features_masks)
        self.labels_masks = as_list(labels_masks)

    def num_examples(self) -> int:
        return 0 if not self.features else self.features[0].shape[0]
