"""Network configuration of the port: counterparts of ``deeplearning4j_tpu.nn.conf``."""
