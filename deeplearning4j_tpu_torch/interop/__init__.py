"""Interop: run live TensorFlow / ONNX-Runtime sessions on the port's
NDArrays, counterpart of ``deeplearning4j_tpu/interop`` (ref:
nd4j-tensorflow / nd4j-onnxruntime ``GraphRunner``). Interop, not import:
the external runtime executes the graph; arrays cross the boundary as
numpy.
"""
from deeplearning4j_tpu_torch.interop.runners import (GraphRunner,
                                                      OnnxRuntimeRunner)

__all__ = ["GraphRunner", "OnnxRuntimeRunner"]
