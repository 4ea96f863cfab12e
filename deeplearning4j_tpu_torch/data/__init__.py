"""Host-side data containers and iterators of the port (copies of the JAX
package's ``data/dataset.py``, ``data/iterators.py`` and the MNIST part of
``data/datasets.py``)."""

from .dataset import DataSet, MultiDataSet
from .datasets import MnistDataSetIterator
from .iterators import (ArrayDataSetIterator, DataSetIterator, ListDataSetIterator,
                        ListMultiDataSetIterator, MultiDataSetIterator)

__all__ = ["ArrayDataSetIterator", "DataSet", "DataSetIterator", "ListDataSetIterator",
           "ListMultiDataSetIterator", "MnistDataSetIterator", "MultiDataSet",
           "MultiDataSetIterator"]
