"""Xception: counterpart of ``deeplearning4j_tpu/models/zoo/xception.py``
(ref: ``org.deeplearning4j.zoo.model.Xception``). Stacks of
depthwise-separable convolutions (``SeparableConvolution2D``: cuDNN's
grouped convolution, then a 1x1 one) with residual ElementWise adds.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    GlobalPoolingLayer, OutputLayer, SeparableConvolution2D, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.graph_conf import ElementWiseVertex
from deeplearning4j_tpu_torch.optim.updaters import Nesterovs
from deeplearning4j_tpu_torch.models.zoo.base import ZooModel


class Xception(ZooModel):
    input_shape = (299, 299, 3)

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape=(299, 299, 3), updater=None,
                 data_type: str = "float32"):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = tuple(input_shape)
        self.updater = updater
        self.data_type = data_type

    def _conv_bn(self, g, name, inp, n_out, kernel, stride=(1, 1), act=True):
        g.add_layer(name, ConvolutionLayer(kernel_size=kernel, stride=stride,
                                           n_out=n_out, has_bias=False,
                                           activation="identity"), inp)
        g.add_layer(name + "_bn", BatchNormalization(), name)
        if act:
            g.add_layer(name + "_relu", ActivationLayer(activation="relu"),
                        name + "_bn")
            return name + "_relu"
        return name + "_bn"

    def _sep_bn(self, g, name, inp, n_out, pre_act=False, post_act=False):
        x = inp
        if pre_act:
            g.add_layer(name + "_prerelu", ActivationLayer(activation="relu"), x)
            x = name + "_prerelu"
        g.add_layer(name, SeparableConvolution2D(kernel_size=(3, 3),
                                                 padding="same", n_out=n_out,
                                                 has_bias=False,
                                                 activation="identity"), x)
        g.add_layer(name + "_bn", BatchNormalization(), name)
        if post_act:
            g.add_layer(name + "_relu", ActivationLayer(activation="relu"),
                        name + "_bn")
            return name + "_relu"
        return name + "_bn"

    def conf(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(1e-2, 0.9))
             .data_type(self.data_type)
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        # entry flow
        x = self._conv_bn(g, "block1_conv1", "input", 32, (3, 3), stride=(2, 2))
        x = self._conv_bn(g, "block1_conv2", x, 64, (3, 3))
        for i, n_out in ((2, 128), (3, 256), (4, 728)):
            pre = i > 2
            a = self._sep_bn(g, f"block{i}_sep1", x, n_out, pre_act=pre,
                             post_act=True)
            a = self._sep_bn(g, f"block{i}_sep2", a, n_out)
            g.add_layer(f"block{i}_pool",
                        SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                         padding="same"), a)
            res = self._conv_bn(g, f"block{i}_res", x, n_out, (1, 1),
                                stride=(2, 2), act=False)
            g.add_vertex(f"block{i}_add", ElementWiseVertex(op="add"),
                         f"block{i}_pool", res)
            x = f"block{i}_add"
        # middle flow: 8 identity blocks of 3 separable convs
        for i in range(5, 13):
            a = x
            for j in (1, 2, 3):
                a = self._sep_bn(g, f"block{i}_sep{j}", a, 728, pre_act=True)
            g.add_vertex(f"block{i}_add", ElementWiseVertex(op="add"), a, x)
            x = f"block{i}_add"
        # exit flow
        a = self._sep_bn(g, "block13_sep1", x, 728, pre_act=True, post_act=True)
        a = self._sep_bn(g, "block13_sep2", a, 1024)
        g.add_layer("block13_pool", SubsamplingLayer(kernel_size=(3, 3),
                                                     stride=(2, 2),
                                                     padding="same"), a)
        res = self._conv_bn(g, "block13_res", x, 1024, (1, 1), stride=(2, 2),
                            act=False)
        g.add_vertex("block13_add", ElementWiseVertex(op="add"),
                     "block13_pool", res)
        x = self._sep_bn(g, "block14_sep1", "block13_add", 1536, post_act=True)
        x = self._sep_bn(g, "block14_sep2", x, 2048, post_act=True)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation="softmax",
                                          loss_function="mcxent"), "avgpool")
        return g.set_outputs("output").build()
