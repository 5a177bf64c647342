"""Model zoo of the port: counterpart of ``deeplearning4j_tpu.models.zoo``,
every architecture of it: ``LeNet``, ``SimpleCNN``, ``AlexNet``,
``TextGenerationLSTM``, ``VGG16``, ``VGG19``, ``ResNet50``, ``SqueezeNet``,
``Darknet19``, ``TinyYOLO``, ``YOLO2``, ``UNet``, ``Xception``,
``InceptionResNetV1``, ``NASNet`` and ``FaceNetNN4Small2``."""
from deeplearning4j_tpu_torch.models.zoo.base import PretrainedType, ZooModel
from deeplearning4j_tpu_torch.models.zoo.cnn_small import (
    AlexNet, LeNet, SimpleCNN, TextGenerationLSTM)
from deeplearning4j_tpu_torch.models.zoo.vgg import VGG16, VGG19
from deeplearning4j_tpu_torch.models.zoo.resnet import ResNet50
from deeplearning4j_tpu_torch.models.zoo.squeezenet import SqueezeNet
from deeplearning4j_tpu_torch.models.zoo.darknet import (Darknet19, TinyYOLO,
                                                         YOLO2)
from deeplearning4j_tpu_torch.models.zoo.unet import UNet
from deeplearning4j_tpu_torch.models.zoo.xception import Xception
from deeplearning4j_tpu_torch.models.zoo.inception import (InceptionResNetV1,
                                                           NASNet)
from deeplearning4j_tpu_torch.models.zoo.facenet import FaceNetNN4Small2

__all__ = [
    "ZooModel", "PretrainedType", "LeNet", "SimpleCNN", "AlexNet",
    "TextGenerationLSTM", "VGG16", "VGG19", "ResNet50", "SqueezeNet",
    "Darknet19", "TinyYOLO", "YOLO2", "UNet", "Xception",
    "InceptionResNetV1", "NASNet", "FaceNetNN4Small2",
]
