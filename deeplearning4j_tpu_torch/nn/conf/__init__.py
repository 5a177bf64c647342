"""Network configuration of the port: counterparts of ``deeplearning4j_tpu.nn.conf``."""
# register VariationalAutoencoder and Yolo2OutputLayer in the layer registry
from deeplearning4j_tpu_torch.nn.conf import objdetect as _objdetect  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf import variational as _variational  # noqa: F401
