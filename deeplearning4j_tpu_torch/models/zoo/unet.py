"""UNet: counterpart of ``deeplearning4j_tpu/models/zoo/unet.py`` (ref:
``org.deeplearning4j.zoo.model.UNet#graphBuilder``). An encoder-decoder
with skip MergeVertex concatenations, nearest Upsampling2D, and a sigmoid
one-channel pixelwise output under XENT loss.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ConvolutionLayer, DropoutLayer, LossLayer, SubsamplingLayer, Upsampling2D)
from deeplearning4j_tpu_torch.nn.graph_conf import MergeVertex
from deeplearning4j_tpu_torch.optim.updaters import Adam
from deeplearning4j_tpu_torch.models.zoo.base import ZooModel


class UNet(ZooModel):
    input_shape = (512, 512, 3)

    def __init__(self, num_classes: int = 1, seed: int = 123,
                 input_shape=(512, 512, 3), updater=None,
                 data_type: str = "float32"):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = tuple(input_shape)
        self.updater = updater
        self.data_type = data_type

    def _conv2(self, g, name, inp, n_out, dropout=None):
        g.add_layer(name + "_1", ConvolutionLayer(kernel_size=(3, 3),
                                                  padding="same", n_out=n_out),
                    inp)
        last = name + "_1"
        if dropout is not None:
            g.add_layer(name + "_do", DropoutLayer(dropout=dropout), last)
            last = name + "_do"
        g.add_layer(name + "_2", ConvolutionLayer(kernel_size=(3, 3),
                                                  padding="same", n_out=n_out),
                    last)
        return name + "_2"

    def conf(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-4))
             .data_type(self.data_type)
             .weight_init("relu")
             .activation("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        # encoder
        c1 = self._conv2(g, "conv1", "input", 64)
        g.add_layer("pool1", SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)), c1)
        c2 = self._conv2(g, "conv2", "pool1", 128)
        g.add_layer("pool2", SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)), c2)
        c3 = self._conv2(g, "conv3", "pool2", 256)
        g.add_layer("pool3", SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)), c3)
        c4 = self._conv2(g, "conv4", "pool3", 512, dropout=0.5)
        g.add_layer("pool4", SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)), c4)
        c5 = self._conv2(g, "conv5", "pool4", 1024, dropout=0.5)
        # decoder
        def up_block(idx, inp, skip, n_out):
            g.add_layer(f"up{idx}", Upsampling2D(size=(2, 2)), inp)
            g.add_layer(f"up{idx}_conv", ConvolutionLayer(kernel_size=(2, 2),
                                                          padding="same",
                                                          n_out=n_out),
                        f"up{idx}")
            g.add_vertex(f"merge{idx}", MergeVertex(), skip, f"up{idx}_conv")
            return self._conv2(g, f"conv{idx}", f"merge{idx}", n_out)
        x = up_block(6, c5, c4, 512)
        x = up_block(7, x, c3, 256)
        x = up_block(8, x, c2, 128)
        x = up_block(9, x, c1, 64)
        g.add_layer("conv10", ConvolutionLayer(kernel_size=(1, 1),
                                               n_out=self.num_classes,
                                               activation="sigmoid"), x)
        g.add_layer("output", LossLayer(loss_function="xent",
                                        activation="identity"), "conv10")
        return g.set_outputs("output").build()
