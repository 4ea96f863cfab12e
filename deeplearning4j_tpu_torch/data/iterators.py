"""DataSet iterators.

Copy of ``DataSetIterator``, ``ListDataSetIterator``,
``ArrayDataSetIterator``, ``MultiDataSetIterator`` and
``ListMultiDataSetIterator`` from ``deeplearning4j_tpu/data/iterators.py``
(nd4j's ``DataSetIterator`` and ``MultiDataSetIterator`` SPIs). The prefetching iterators
(``AsyncDataSetIterator``, ``DevicePrefetchIterator``) are not ported yet
(ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from .dataset import DataSet, MultiDataSet


class DataSetIterator:
    """Iterator SPI: next() -> DataSet, reset(), batch(), has_next()."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def async_supported(self) -> bool:
        return True

    def reset_supported(self) -> bool:
        return True

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        while self.has_next():
            yield self.next()


class ListDataSetIterator(DataSetIterator):
    """org.deeplearning4j.datasets.iterator.impl.ListDataSetIterator."""

    def __init__(self, datasets: Sequence[DataSet], batch_size: Optional[int] = None):
        if batch_size is not None:
            merged = DataSet.merge(list(datasets)) if len(datasets) > 1 else datasets[0]
            self._list = merged.batch_by(batch_size)
            self._batch = batch_size
        else:
            self._list = list(datasets)
            self._batch = self._list[0].num_examples() if self._list else 0
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._list)

    def next(self) -> DataSet:
        d = self._list[self._pos]
        self._pos += 1
        return d

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        return self._batch

    def state(self) -> dict:
        return {"pos": self._pos}

    def set_state(self, s: dict) -> None:
        self._pos = int(s["pos"])


class ArrayDataSetIterator(DataSetIterator):
    """Batches over in-memory (features, labels) arrays, optional shuffle per
    epoch (the common INDArray fit path)."""

    def __init__(self, features, labels, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.features = features.numpy() if hasattr(features, "numpy") else np.asarray(features)
        self.labels = labels.numpy() if hasattr(labels, "numpy") else np.asarray(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._seed = seed
        self._drop_last = drop_last
        self._order = np.arange(self.features.shape[0])
        self._pos = 0
        self._epoch = 0

    def has_next(self) -> bool:
        remaining = self.features.shape[0] - self._pos
        return remaining >= (self.batch_size if self._drop_last else 1)

    def next(self) -> DataSet:
        ix = self._order[self._pos: self._pos + self.batch_size]
        self._pos += self.batch_size
        return DataSet(self.features[ix], self.labels[ix])

    def reset(self) -> None:
        self._pos = 0
        self._epoch += 1
        if self.shuffle:
            np.random.default_rng(self._seed + self._epoch).shuffle(self._order)

    def batch(self) -> int:
        return self.batch_size

    # (pos, epoch) only: the shuffle order is rebuilt by replaying the
    # seeded per-epoch shuffles
    def state(self) -> dict:
        return {"pos": int(self._pos), "epoch": int(self._epoch)}

    def set_state(self, s: dict) -> None:
        self._pos = int(s["pos"])
        self._epoch = int(s["epoch"])
        self._order = np.arange(self.features.shape[0])
        if self.shuffle:
            for k in range(1, self._epoch + 1):
                np.random.default_rng(self._seed + k).shuffle(self._order)


class MultiDataSetIterator:
    """api.iterator.MultiDataSetIterator SPI."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> MultiDataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[MultiDataSet]:
        self.reset()
        while self.has_next():
            yield self.next()


class ListMultiDataSetIterator(MultiDataSetIterator):
    def __init__(self, items: Sequence[MultiDataSet]):
        self._items = list(items)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._items)

    def next(self) -> MultiDataSet:
        d = self._items[self._pos]
        self._pos += 1
        return d

    def reset(self) -> None:
        self._pos = 0
