"""Host-side data containers and iterators of the port (copies of the JAX
package's ``data/dataset.py``, ``data/iterators.py`` and
``data/datasets.py``)."""

from .dataset import DataSet, MultiDataSet
from .datasets import (Cifar10DataSetIterator, EmnistDataSetIterator, IrisDataSetIterator,
                       MnistDataSetIterator, TinyImageNetDataSetIterator)
from .iterators import (ArrayDataSetIterator, DataSetIterator, ListDataSetIterator,
                        ListMultiDataSetIterator, MultiDataSetIterator)

__all__ = ["ArrayDataSetIterator", "Cifar10DataSetIterator", "DataSet", "DataSetIterator",
           "EmnistDataSetIterator", "IrisDataSetIterator", "ListDataSetIterator",
           "ListMultiDataSetIterator", "MnistDataSetIterator", "MultiDataSet",
           "MultiDataSetIterator", "TinyImageNetDataSetIterator"]
