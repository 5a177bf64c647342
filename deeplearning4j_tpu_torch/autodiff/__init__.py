"""Graph engine and validation: counterpart of
``deeplearning4j_tpu.autodiff`` (ref: org.nd4j.autodiff)."""
from deeplearning4j_tpu_torch.autodiff import validation  # noqa: F401
from deeplearning4j_tpu_torch.autodiff.samediff import (  # noqa: F401
    SameDiff, SDVariable, TrainingConfig, VariableType)
