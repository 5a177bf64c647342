"""Model import of the port: counterpart of ``deeplearning4j_tpu.modelimport``
(``dl4j_zip``; the TF, ONNX and Keras importers wait in ROADMAP queue 1
item 9)."""
