"""MNIST: IDX parsing and the deterministic synthetic fallback.

Copy of ``MnistDataSetIterator`` and its helpers from
``deeplearning4j_tpu/data/datasets.py`` (DL4J's ``MnistDataSetIterator``).
The IDX files are read from ``TDL_DATA_DIR`` or ``~/.deeplearning4j_tpu/mnist``
when present; otherwise a deterministic synthetic digit-like set (class
templates, jitter and noise) is generated, byte for byte the JAX package's
on the same seed.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from .dataset import DataSet
from .iterators import DataSetIterator


def _read_idx(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = tuple(struct.unpack(">I", f.read(4))[0] for _ in range(ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def _find_mnist_dir() -> Optional[str]:
    cands = [os.environ.get("TDL_DATA_DIR"),
             os.path.expanduser("~/.deeplearning4j_tpu/mnist"),
             os.path.expanduser("~/.cache/mnist")]
    for d in cands:
        if d and os.path.isdir(d):
            for name in ("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"):
                if os.path.exists(os.path.join(d, name)):
                    return d
    return None


def _synthetic_images(n: int, seed: int, train: bool, classes: int, hw: int, channels: int,
                      template_seed: int = 4321) -> Tuple[np.ndarray, np.ndarray]:
    """Class-template images: per-class low-frequency template + jitter +
    noise, uint8 [n, channels, hw, hw] and int labels [n]."""
    rs = np.random.RandomState(template_seed)  # fixed across train/test
    base = hw // 4
    templates = rs.rand(classes, channels, base, base).astype(np.float32)
    rs2 = np.random.RandomState(seed + (0 if train else 10_000))
    labels = rs2.randint(0, classes, n)
    up = np.ones((hw // base, hw // base), np.float32)
    # upsample once per (class, channel), not once per example
    big = np.stack([[np.kron(templates[c, ch], up) for ch in range(channels)]
                    for c in range(classes)])
    imgs = np.empty((n, channels, hw, hw), np.float32)
    for i, c in enumerate(labels):
        shift = rs2.randint(-2, 3, 2)
        t = np.roll(big[c], tuple(shift), axis=(1, 2))
        imgs[i] = np.clip(t + 0.15 * rs2.randn(channels, hw, hw), 0, 1)
    return (imgs * 255).astype(np.uint8), labels


def _synthetic_mnist(n: int, seed: int, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic digit-like 28x28 data (template_seed=1234 keeps the
    reference's MNIST stream)."""
    imgs, labels = _synthetic_images(n, seed, train, classes=10, hw=28, channels=1,
                                     template_seed=1234)
    return imgs[:, 0], labels


class MnistDataSetIterator(DataSetIterator):
    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None, binarize: bool = False):
        self.batch_size = batch_size
        d = _find_mnist_dir()
        if d is not None:
            prefix = "train" if train else "t10k"

            def p(stem):
                for suff in ("", ".gz"):
                    path = os.path.join(d, stem + suff)
                    if os.path.exists(path):
                        return path
                raise FileNotFoundError(stem)

            imgs = _read_idx(p(f"{prefix}-images-idx3-ubyte"))
            labels = _read_idx(p(f"{prefix}-labels-idx1-ubyte"))
            self.synthetic = False
        else:
            n = num_examples or (10_000 if train else 2_000)
            imgs, labels = _synthetic_mnist(n, seed, train)
            self.synthetic = True
        if num_examples:
            imgs, labels = imgs[:num_examples], labels[:num_examples]
        x = imgs.astype(np.float32) / 255.0
        if binarize:
            x = (x > 0.5).astype(np.float32)
        self._x = x.reshape(-1, 1, 28, 28)
        self._y = np.eye(10, dtype=np.float32)[labels]
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._x)

    def batch(self) -> int:
        return self.batch_size

    def next(self) -> DataSet:
        b = slice(self._pos, self._pos + self.batch_size)
        self._pos += self.batch_size
        return DataSet(self._x[b], self._y[b])

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if not self.has_next():
            raise StopIteration
        return self.next()

    def total_examples(self) -> int:
        return len(self._x)
