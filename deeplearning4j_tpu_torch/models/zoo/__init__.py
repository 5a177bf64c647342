"""Model zoo of the port: counterpart of ``deeplearning4j_tpu.models.zoo``
(``ResNet50``, ``LeNet``, ``SimpleCNN``, ``TextGenerationLSTM``; the other
architectures wait, ROADMAP queue 1 item 8)."""
from deeplearning4j_tpu_torch.models.zoo.base import PretrainedType, ZooModel
from deeplearning4j_tpu_torch.models.zoo.cnn_small import (
    LeNet, SimpleCNN, TextGenerationLSTM)
from deeplearning4j_tpu_torch.models.zoo.resnet import ResNet50

__all__ = ["ZooModel", "PretrainedType", "LeNet", "SimpleCNN",
           "TextGenerationLSTM", "ResNet50"]
