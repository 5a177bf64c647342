"""Model import of the port: counterpart of ``deeplearning4j_tpu.modelimport``
(``dl4j_zip``; the TF GraphDef importer ``tfimport`` over the port's own
wire codec ``tf_proto`` and graph skeletons ``tf_skeleton``; the ONNX and
Keras importers wait in ROADMAP queue 1 item 9)."""
