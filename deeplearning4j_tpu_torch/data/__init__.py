"""Data pipeline of the port: counterpart of ``deeplearning4j_tpu.data``
(``DataSet``, ``MultiDataSet``, the iterators the fit loops take and the
normalizers; ``mnist`` and ``vision`` hold the dataset iterators)."""
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (
    ArrayDataSetIterator, AsyncDataSetIterator, DataSetIterator,
    DevicePrefetchIterator, ListDataSetIterator, MultipleEpochsIterator)
from deeplearning4j_tpu_torch.data.normalizers import (
    DataNormalization, ImagePreProcessingScaler, NormalizerMinMaxScaler,
    NormalizerStandardize, VGG16ImagePreProcessor)
from deeplearning4j_tpu_torch.data.mnist import MnistDataSetIterator
from deeplearning4j_tpu_torch.data.vision import (
    Cifar10DataSetIterator, CifarDataSetIterator, EmnistDataSetIterator,
    TinyImageNetDataSetIterator)

__all__ = ["DataSet", "MultiDataSet", "DataSetIterator",
           "ListDataSetIterator", "ArrayDataSetIterator",
           "DevicePrefetchIterator", "AsyncDataSetIterator",
           "MultipleEpochsIterator", "DataNormalization",
           "NormalizerStandardize", "NormalizerMinMaxScaler",
           "ImagePreProcessingScaler", "VGG16ImagePreProcessor",
           "MnistDataSetIterator", "Cifar10DataSetIterator",
           "CifarDataSetIterator", "EmnistDataSetIterator",
           "TinyImageNetDataSetIterator"]
