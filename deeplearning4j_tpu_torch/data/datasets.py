"""Built-in datasets: MNIST (IDX parsing and the deterministic synthetic
fallback), Iris, and the CIFAR-10, EMNIST and TinyImageNet iterators.

Copy of ``deeplearning4j_tpu/data/datasets.py`` (DL4J's
``MnistDataSetIterator``, ``IrisDataSetIterator``,
``Cifar10DataSetIterator``, ``EmnistDataSetIterator`` and
``TinyImageNetDataSetIterator``). Nothing is downloaded. The MNIST IDX
files are read from ``TDL_DATA_DIR`` or ``~/.deeplearning4j_tpu/mnist``
when present; otherwise, and always for CIFAR-10, EMNIST and TinyImageNet,
a deterministic synthetic set (class templates, jitter and noise) is
generated, byte for byte the JAX package's on the same seed. Iris is
Fisher's data, shipped inline.
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


_IRIS_DATA = None


def _iris_arrays():
    """Fisher's Iris (public domain, 150 rows), shipped inline: features
    [150, 4] float32 and one-hot labels [150, 3]."""
    global _IRIS_DATA
    if _IRIS_DATA is None:
        # 50 rows per class: (sl, sw, pl, pw)
        raw = """5.1,3.5,1.4,0.2;4.9,3.0,1.4,0.2;4.7,3.2,1.3,0.2;4.6,3.1,1.5,0.2;5.0,3.6,1.4,0.2;5.4,3.9,1.7,0.4;4.6,3.4,1.4,0.3;5.0,3.4,1.5,0.2;4.4,2.9,1.4,0.2;4.9,3.1,1.5,0.1;5.4,3.7,1.5,0.2;4.8,3.4,1.6,0.2;4.8,3.0,1.4,0.1;4.3,3.0,1.1,0.1;5.8,4.0,1.2,0.2;5.7,4.4,1.5,0.4;5.4,3.9,1.3,0.4;5.1,3.5,1.4,0.3;5.7,3.8,1.7,0.3;5.1,3.8,1.5,0.3;5.4,3.4,1.7,0.2;5.1,3.7,1.5,0.4;4.6,3.6,1.0,0.2;5.1,3.3,1.7,0.5;4.8,3.4,1.9,0.2;5.0,3.0,1.6,0.2;5.0,3.4,1.6,0.4;5.2,3.5,1.5,0.2;5.2,3.4,1.4,0.2;4.7,3.2,1.6,0.2;4.8,3.1,1.6,0.2;5.4,3.4,1.5,0.4;5.2,4.1,1.5,0.1;5.5,4.2,1.4,0.2;4.9,3.1,1.5,0.2;5.0,3.2,1.2,0.2;5.5,3.5,1.3,0.2;4.9,3.6,1.4,0.1;4.4,3.0,1.3,0.2;5.1,3.4,1.5,0.2;5.0,3.5,1.3,0.3;4.5,2.3,1.3,0.3;4.4,3.2,1.3,0.2;5.0,3.5,1.6,0.6;5.1,3.8,1.9,0.4;4.8,3.0,1.4,0.3;5.1,3.8,1.6,0.2;4.6,3.2,1.4,0.2;5.3,3.7,1.5,0.2;5.0,3.3,1.4,0.2;7.0,3.2,4.7,1.4;6.4,3.2,4.5,1.5;6.9,3.1,4.9,1.5;5.5,2.3,4.0,1.3;6.5,2.8,4.6,1.5;5.7,2.8,4.5,1.3;6.3,3.3,4.7,1.6;4.9,2.4,3.3,1.0;6.6,2.9,4.6,1.3;5.2,2.7,3.9,1.4;5.0,2.0,3.5,1.0;5.9,3.0,4.2,1.5;6.0,2.2,4.0,1.0;6.1,2.9,4.7,1.4;5.6,2.9,3.6,1.3;6.7,3.1,4.4,1.4;5.6,3.0,4.5,1.5;5.8,2.7,4.1,1.0;6.2,2.2,4.5,1.5;5.6,2.5,3.9,1.1;5.9,3.2,4.8,1.8;6.1,2.8,4.0,1.3;6.3,2.5,4.9,1.5;6.1,2.8,4.7,1.2;6.4,2.9,4.3,1.3;6.6,3.0,4.4,1.4;6.8,2.8,4.8,1.4;6.7,3.0,5.0,1.7;6.0,2.9,4.5,1.5;5.7,2.6,3.5,1.0;5.5,2.4,3.8,1.1;5.5,2.4,3.7,1.0;5.8,2.7,3.9,1.2;6.0,2.7,5.1,1.6;5.4,3.0,4.5,1.5;6.0,3.4,4.5,1.6;6.7,3.1,4.7,1.5;6.3,2.3,4.4,1.3;5.6,3.0,4.1,1.3;5.5,2.5,4.0,1.3;5.5,2.6,4.4,1.2;6.1,3.0,4.6,1.4;5.8,2.6,4.0,1.2;5.0,2.3,3.3,1.0;5.6,2.7,4.2,1.3;5.7,3.0,4.2,1.2;5.7,2.9,4.2,1.3;6.2,2.9,4.3,1.3;5.1,2.5,3.0,1.1;5.7,2.8,4.1,1.3;6.3,3.3,6.0,2.5;5.8,2.7,5.1,1.9;7.1,3.0,5.9,2.1;6.3,2.9,5.6,1.8;6.5,3.0,5.8,2.2;7.6,3.0,6.6,2.1;4.9,2.5,4.5,1.7;7.3,2.9,6.3,1.8;6.7,2.5,5.8,1.8;7.2,3.6,6.1,2.5;6.5,3.2,5.1,2.0;6.4,2.7,5.3,1.9;6.8,3.0,5.5,2.1;5.7,2.5,5.0,2.0;5.8,2.8,5.1,2.4;6.4,3.2,5.3,2.3;6.5,3.0,5.5,1.8;7.7,3.8,6.7,2.2;7.7,2.6,6.9,2.3;6.0,2.2,5.0,1.5;6.9,3.2,5.7,2.3;5.6,2.8,4.9,2.0;7.7,2.8,6.7,2.0;6.3,2.7,4.9,1.8;6.7,3.3,5.7,2.1;7.2,3.2,6.0,1.8;6.2,2.8,4.8,1.8;6.1,3.0,4.9,1.8;6.4,2.8,5.6,2.1;7.2,3.0,5.8,1.6;7.4,2.8,6.1,1.9;7.9,3.8,6.4,2.0;6.4,2.8,5.6,2.2;6.3,2.8,5.1,1.5;6.1,2.6,5.6,1.4;7.7,3.0,6.1,2.3;6.3,3.4,5.6,2.4;6.4,3.1,5.5,1.8;6.0,3.0,4.8,1.8;6.9,3.1,5.4,2.1;6.7,3.1,5.6,2.4;6.9,3.1,5.1,2.3;5.8,2.7,5.1,1.9;6.8,3.2,5.9,2.3;6.7,3.3,5.7,2.5;6.7,3.0,5.2,2.3;6.3,2.5,5.0,1.9;6.5,3.0,5.2,2.0;6.2,3.4,5.4,2.3;5.9,3.0,5.1,1.8"""
        X = np.asarray([[float(v) for v in row.split(",")] for row in raw.split(";")],
                       np.float32)
        y = np.repeat(np.arange(3), 50)
        _IRIS_DATA = (X, np.eye(3, dtype=np.float32)[y])
    return _IRIS_DATA


class IrisDataSetIterator(DataSetIterator):
    """org.deeplearning4j.datasets.iterator.impl.IrisDataSetIterator."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 shuffle_seed: Optional[int] = 42):
        X, Y = _iris_arrays()
        if shuffle_seed is not None:
            rs = np.random.RandomState(shuffle_seed)
            perm = rs.permutation(len(X))
            X, Y = X[perm], Y[perm]
        self._x, self._y = X[:num_examples], Y[:num_examples]
        self.batch_size = batch_size
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._x)

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


class _SyntheticImageIterator(DataSetIterator):
    """Shared base of the Cifar10/EMNIST/TinyImageNet-style iterators: their
    files are not read yet, so these serve the DETERMINISTIC synthetic
    fallback, as the JAX package does (the MNIST iterator's IDX-file path
    shows the file-loading shape these would take)."""

    synthetic = True

    def __init__(self, batch_size: int, train: bool, seed: int,
                 num_examples: int, classes: int, hw: int, channels: int):
        self.batch_size = batch_size
        self.classes = classes
        imgs, labels = _synthetic_images(num_examples, seed, train, classes,
                                         hw, channels)
        self._x = imgs.astype(np.float32) / 255.0
        self._y = np.eye(classes, dtype=np.float32)[labels]
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._x)

    def batch(self) -> int:
        return self.batch_size

    def next(self) -> DataSet:
        s = slice(self._pos, self._pos + self.batch_size)
        self._pos += self.batch_size
        return DataSet(self._x[s], self._y[s])

    def state(self) -> dict:
        return {"pos": int(self._pos)}

    def set_state(self, st: dict) -> None:
        self._pos = int(st["pos"])


class Cifar10DataSetIterator(_SyntheticImageIterator):
    """org.deeplearning4j.datasets.iterator.impl.Cifar10DataSetIterator
    (synthetic fallback: 10 classes, 32x32x3 NCHW)."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: int = 5120):
        super().__init__(batch_size, train, seed, num_examples,
                         classes=10, hw=32, channels=3)


class EmnistDataSetIterator(_SyntheticImageIterator):
    """EMNIST letters split (26 classes, 28x28 grayscale; synthetic fallback)."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: int = 5120, dataset: str = "LETTERS"):
        splits = {"LETTERS": 26, "DIGITS": 10, "BALANCED": 47,
                  "BYCLASS": 62, "BYMERGE": 47, "COMPLETE": 62, "MNIST": 10}
        if dataset.upper() not in splits:
            raise ValueError(f"unknown EMNIST split {dataset!r}; "
                             f"known: {sorted(splits)}")
        classes = splits[dataset.upper()]
        super().__init__(batch_size, train, seed, num_examples,
                         classes=classes, hw=28, channels=1)


class TinyImageNetDataSetIterator(_SyntheticImageIterator):
    """TinyImageNet (200 classes, 64x64x3; synthetic fallback)."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: int = 2000):
        super().__init__(batch_size, train, seed, num_examples,
                         classes=200, hw=64, channels=3)
