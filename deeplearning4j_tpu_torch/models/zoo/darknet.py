"""Darknet19, TinyYOLO and YOLO2: counterpart of
``deeplearning4j_tpu/models/zoo/darknet.py`` (ref:
``org.deeplearning4j.zoo.model.{Darknet19,TinyYOLO,YOLO2}``; BASELINE.json's
configs[1] names Darknet19). Its conv unit is a bias-free convolution,
BatchNormalization and leakyrelu(0.1) (the reference's
``Darknet19#addLayers``); its 2x2 max pools are stride 2, or stride 1 with
"same" padding. TinyYOLO and YOLO2 end in a 1x1 convolution to B·(5 + C)
channels and a ``Yolo2OutputLayer`` over the VOC anchor priors.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, GlobalPoolingLayer,
    OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.optim.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.models.zoo.base import ZooModel

# YOLOv2's VOC anchor priors (grid units), the reference's constants
_TINY_YOLO_PRIORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                     (9.42, 5.11), (16.62, 10.52))
_YOLO2_PRIORS = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
                 (7.88282, 3.52778), (9.77052, 9.16828))


def _dark_conv(g, name, inp, n_out, kernel=(3, 3)):
    """conv (no bias) + BN + leakyrelu(0.1)."""
    g.add_layer(name, ConvolutionLayer(kernel_size=kernel, padding="same",
                                       n_out=n_out, has_bias=False,
                                       activation="identity"), inp)
    g.add_layer(name + "_bn", BatchNormalization(), name)
    g.add_layer(name + "_act", ActivationLayer(activation="leakyrelu:0.1"),
                name + "_bn")
    return name + "_act"


def _maxpool(g, name, inp, stride=2):
    g.add_layer(name, SubsamplingLayer(kernel_size=(2, 2),
                                       stride=(stride, stride),
                                       padding="same" if stride == 1 else 0),
                inp)
    return name


def _darknet19_trunk(g, inp):
    """The 18 conv layers Darknet19 and YOLO2 share."""
    x = _dark_conv(g, "cnn1", inp, 32)
    x = _maxpool(g, "pool1", x)
    x = _dark_conv(g, "cnn2", x, 64)
    x = _maxpool(g, "pool2", x)
    x = _dark_conv(g, "cnn3", x, 128)
    x = _dark_conv(g, "cnn4", x, 64, (1, 1))
    x = _dark_conv(g, "cnn5", x, 128)
    x = _maxpool(g, "pool3", x)
    x = _dark_conv(g, "cnn6", x, 256)
    x = _dark_conv(g, "cnn7", x, 128, (1, 1))
    x = _dark_conv(g, "cnn8", x, 256)
    x = _maxpool(g, "pool4", x)
    x = _dark_conv(g, "cnn9", x, 512)
    x = _dark_conv(g, "cnn10", x, 256, (1, 1))
    x = _dark_conv(g, "cnn11", x, 512)
    x = _dark_conv(g, "cnn12", x, 256, (1, 1))
    x = _dark_conv(g, "cnn13", x, 512)
    x = _maxpool(g, "pool5", x)
    x = _dark_conv(g, "cnn14", x, 1024)
    x = _dark_conv(g, "cnn15", x, 512, (1, 1))
    x = _dark_conv(g, "cnn16", x, 1024)
    x = _dark_conv(g, "cnn17", x, 512, (1, 1))
    x = _dark_conv(g, "cnn18", x, 1024)
    return x


class Darknet19(ZooModel):
    """Classification Darknet-19: the trunk, a 1x1 convolution to the
    classes, global average pooling and a softmax output."""
    input_shape = (224, 224, 3)

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape=(224, 224, 3), updater=None,
                 data_type: str = "float32"):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = tuple(input_shape)
        self.updater = updater
        self.data_type = data_type

    def conf(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(1e-3, 0.9))
             .data_type(self.data_type)
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        x = _darknet19_trunk(g, "input")
        g.add_layer("cnn19", ConvolutionLayer(kernel_size=(1, 1),
                                              n_out=self.num_classes,
                                              activation="identity"), x)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), "cnn19")
        g.add_layer("output", OutputLayer(n_in=self.num_classes,
                                          n_out=self.num_classes,
                                          activation="softmax",
                                          loss_function="mcxent"), "avgpool")
        return g.set_outputs("output").build()


class TinyYOLO(ZooModel):
    """A 9-convolution trunk and the YOLOv2 head (ref: zoo.model.TinyYOLO)."""
    input_shape = (416, 416, 3)

    def __init__(self, num_classes: int = 20, seed: int = 123,
                 input_shape=(416, 416, 3), priors=_TINY_YOLO_PRIORS,
                 updater=None, data_type: str = "float32"):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = tuple(input_shape)
        self.priors = priors
        self.updater = updater
        self.data_type = data_type

    def conf(self):
        h, w, c = self.input_shape
        nb = len(self.priors)
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .data_type(self.data_type)
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        x = "input"
        for i, n_out in enumerate((16, 32, 64, 128, 256), start=1):
            x = _dark_conv(g, f"cnn{i}", x, n_out)
            x = _maxpool(g, f"pool{i}", x)
        x = _dark_conv(g, "cnn6", x, 512)
        x = _maxpool(g, "pool6", x, stride=1)
        x = _dark_conv(g, "cnn7", x, 1024)
        x = _dark_conv(g, "cnn8", x, 1024)
        g.add_layer("detect_conv",
                    ConvolutionLayer(kernel_size=(1, 1),
                                     n_out=nb * (5 + self.num_classes),
                                     activation="identity"), x)
        g.add_layer("yolo", Yolo2OutputLayer(boxes=self.priors), "detect_conv")
        return g.set_outputs("yolo").build()


class YOLO2(ZooModel):
    """The Darknet19 trunk, two more conv units and the YOLOv2 head, no
    passthrough (ref: zoo.model.YOLO2)."""
    input_shape = (416, 416, 3)

    def __init__(self, num_classes: int = 20, seed: int = 123,
                 input_shape=(416, 416, 3), priors=_YOLO2_PRIORS,
                 updater=None, data_type: str = "float32"):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = tuple(input_shape)
        self.priors = priors
        self.updater = updater
        self.data_type = data_type

    def conf(self):
        h, w, c = self.input_shape
        nb = len(self.priors)
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .data_type(self.data_type)
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        x = _darknet19_trunk(g, "input")
        x = _dark_conv(g, "cnn19", x, 1024)
        x = _dark_conv(g, "cnn20", x, 1024)
        g.add_layer("detect_conv",
                    ConvolutionLayer(kernel_size=(1, 1),
                                     n_out=nb * (5 + self.num_classes),
                                     activation="identity"), x)
        g.add_layer("yolo", Yolo2OutputLayer(boxes=self.priors), "detect_conv")
        return g.set_outputs("yolo").build()
