"""Model zoo of the port: counterpart of ``deeplearning4j_tpu.models.zoo``
(``ResNet50``, ``VGG16``, ``VGG19``, ``Darknet19``, ``AlexNet``, ``LeNet``,
``SimpleCNN``, ``TextGenerationLSTM``; the other architectures wait for
their layers, ROADMAP queue 1 item 8.6)."""
from deeplearning4j_tpu_torch.models.zoo.base import PretrainedType, ZooModel
from deeplearning4j_tpu_torch.models.zoo.cnn_small import (
    AlexNet, LeNet, SimpleCNN, TextGenerationLSTM)
from deeplearning4j_tpu_torch.models.zoo.darknet import Darknet19
from deeplearning4j_tpu_torch.models.zoo.resnet import ResNet50
from deeplearning4j_tpu_torch.models.zoo.vgg import VGG16, VGG19

__all__ = ["ZooModel", "PretrainedType", "LeNet", "SimpleCNN", "AlexNet",
           "TextGenerationLSTM", "ResNet50", "VGG16", "VGG19", "Darknet19"]
