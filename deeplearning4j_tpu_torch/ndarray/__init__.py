"""ND4J on the port: ``NDArray`` + the ``nd`` factory (ref: INDArray /
Nd4j), counterpart of ``deeplearning4j_tpu/ndarray``. The surface modules
load in the reference's order."""
from deeplearning4j_tpu_torch.ndarray.ndarray import NDArray
from deeplearning4j_tpu_torch.ndarray import surface as _surface  # noqa: F401 — tranche-3 methods
from deeplearning4j_tpu_torch.ndarray import surface4 as _surface4  # noqa: F401 — tranche-4 methods
from deeplearning4j_tpu_torch.ndarray import surface5 as _surface5  # noqa: F401 — tranche-5 methods
from deeplearning4j_tpu_torch.ndarray import factory as nd
from deeplearning4j_tpu_torch.ndarray.factory import Nd4j
from deeplearning4j_tpu_torch.ndarray import dtypes

from deeplearning4j_tpu_torch.ndarray.indexing import (BooleanIndexing,
                                                       NDArrayIndex)

__all__ = ["NDArrayIndex", "BooleanIndexing", "NDArray", "nd", "Nd4j",
           "dtypes"]
