"""Model import of the port: counterpart of ``deeplearning4j_tpu.modelimport``
(``dl4j_zip``; the TF GraphDef importer ``tfimport`` over the port's own
wire codec ``tf_proto`` and graph skeletons ``tf_skeleton``; the ONNX
importer ``onnximport`` over its own codec ``onnx_proto``; the Keras H5
importer ``keras`` over its own HDF5 reader ``hdf5``)."""
from deeplearning4j_tpu_torch.modelimport.keras import KerasModelImport

__all__ = ["KerasModelImport"]
