"""RecordReader → DataSet bridge.

Counterpart (a copy) of ``deeplearning4j_tpu/data/record_reader_iterator.py``
(``org.deeplearning4j.datasets.datavec.RecordReaderDataSetIterator``): wraps
a RecordReader, maps a label column to one-hot (or regression targets) and
batches into DataSets.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .dataset import DataSet
from .iterators import DataSetIterator
from .records import RecordReader


class RecordReaderDataSetIterator(DataSetIterator):
    def __init__(self, record_reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None, num_classes: Optional[int] = None,
                 regression: bool = False):
        self.reader = record_reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression

    def reset(self):
        self.reader.reset()

    def has_next(self) -> bool:
        return self.reader.has_next()

    def batch(self) -> int:
        return self.batch_size

    def next(self) -> DataSet:
        feats, labels = [], []
        for _ in range(self.batch_size):
            if not self.reader.has_next():
                break
            row = self.reader.next()
            if self.label_index is None:
                feats.append([float(v) for v in row])
                continue
            li = self.label_index if self.label_index >= 0 else len(row) + self.label_index
            f = [float(v) for i, v in enumerate(row) if i != li]
            feats.append(f)
            if self.regression:
                labels.append([float(row[li])])
            else:
                labels.append(int(float(row[li])))
        x = np.asarray(feats, np.float32)
        if self.label_index is None:
            return DataSet(x, None)
        if self.regression:
            return DataSet(x, np.asarray(labels, np.float32))
        y = np.eye(self.num_classes, dtype=np.float32)[np.asarray(labels)]
        return DataSet(x, y)
