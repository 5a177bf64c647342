"""Data pipeline of the port: counterpart of ``deeplearning4j_tpu.data``
(``DataSet``, ``MultiDataSet`` and the iterators the fit loops take)."""
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (
    ArrayDataSetIterator, DataSetIterator, DevicePrefetchIterator,
    ListDataSetIterator)

__all__ = ["DataSet", "MultiDataSet", "DataSetIterator",
           "ListDataSetIterator", "ArrayDataSetIterator",
           "DevicePrefetchIterator"]
