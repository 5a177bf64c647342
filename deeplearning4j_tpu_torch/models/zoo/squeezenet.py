"""SqueezeNet v1.1: counterpart of
``deeplearning4j_tpu/models/zoo/squeezenet.py`` (ref:
``org.deeplearning4j.zoo.model.SqueezeNet``). Fire modules: a 1x1
squeeze, then parallel 1x1 and 3x3 expands joined by a MergeVertex.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ConvolutionLayer, DropoutLayer, GlobalPoolingLayer, LossLayer,
    SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.graph_conf import MergeVertex
from deeplearning4j_tpu_torch.optim.updaters import Nesterovs
from deeplearning4j_tpu_torch.models.zoo.base import ZooModel


class SqueezeNet(ZooModel):
    input_shape = (227, 227, 3)

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape=(227, 227, 3), updater=None,
                 data_type: str = "float32"):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = tuple(input_shape)
        self.updater = updater
        self.data_type = data_type

    def _fire(self, g, name, inp, squeeze, expand):
        g.add_layer(name + "_sq", ConvolutionLayer(kernel_size=(1, 1),
                                                   n_out=squeeze), inp)
        g.add_layer(name + "_e1", ConvolutionLayer(kernel_size=(1, 1),
                                                   n_out=expand), name + "_sq")
        g.add_layer(name + "_e3", ConvolutionLayer(kernel_size=(3, 3),
                                                   padding="same",
                                                   n_out=expand), name + "_sq")
        g.add_vertex(name, MergeVertex(), name + "_e1", name + "_e3")
        return name

    def conf(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(1e-2, 0.9))
             .data_type(self.data_type)
             .weight_init("relu")
             .activation("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        g.add_layer("conv1", ConvolutionLayer(kernel_size=(3, 3), stride=(2, 2),
                                              n_out=64), "input")
        g.add_layer("pool1", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)),
                    "conv1")
        x = self._fire(g, "fire2", "pool1", 16, 64)
        x = self._fire(g, "fire3", x, 16, 64)
        g.add_layer("pool3", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)), x)
        x = self._fire(g, "fire4", "pool3", 32, 128)
        x = self._fire(g, "fire5", x, 32, 128)
        g.add_layer("pool5", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)), x)
        x = self._fire(g, "fire6", "pool5", 48, 192)
        x = self._fire(g, "fire7", x, 48, 192)
        x = self._fire(g, "fire8", x, 64, 256)
        x = self._fire(g, "fire9", x, 64, 256)
        g.add_layer("drop9", DropoutLayer(dropout=0.5), x)
        g.add_layer("conv10", ConvolutionLayer(kernel_size=(1, 1),
                                               n_out=self.num_classes), "drop9")
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), "conv10")
        g.add_layer("output", LossLayer(loss_function="mcxent",
                                        activation="softmax"), "avgpool")
        return g.set_outputs("output").build()
