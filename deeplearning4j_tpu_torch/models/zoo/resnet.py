"""ResNet50: counterpart of ``deeplearning4j_tpu/models/zoo/resnet.py``
(ref: org.deeplearning4j.zoo.model.ResNet50#graphBuilder — the BASELINE
ComputationGraph config; SURVEY D11).

Identity and bottleneck conv blocks as a ComputationGraph DAG with
ElementWiseVertex(add) skip connections. Layer and vertex names, inputs
and param shapes are the reference's.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer,
    GlobalPoolingLayer, OutputLayer, SubsamplingLayer, ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.graph_conf import ElementWiseVertex
from deeplearning4j_tpu_torch.optim.updaters import Nesterovs
from deeplearning4j_tpu_torch.models.zoo.base import ZooModel


class ResNet50(ZooModel):
    input_shape = (224, 224, 3)

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape=(224, 224, 3), updater=None,
                 data_type: str = "float32"):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = tuple(input_shape)
        # ref parity: ZooModel builders accept an updater override
        # (ResNet50.builder().updater(...)); default matches the reference
        self.updater = updater
        # mixed-precision policy (nn/_precision)
        self.data_type = data_type

    # ----- blocks (ref: ResNet50#convBlock / #identityBlock)
    def _conv_bn_act(self, g, name, inp, n_out, kernel, stride=(1, 1),
                     padding=(0, 0), act=True):
        # hasBias=false on every conv that feeds a BatchNormalization: BN
        # re-centers, so the bias is redundant, and its gradient would be
        # a full-activation reduction per conv (53 of them)
        g.add_layer(name, ConvolutionLayer(kernel_size=kernel, stride=stride,
                                           padding=padding, n_out=n_out,
                                           has_bias=False,
                                           activation="identity"), inp)
        g.add_layer(name + "_bn", BatchNormalization(), name)
        if act:
            g.add_layer(name + "_relu", ActivationLayer(activation="relu"),
                        name + "_bn")
            return name + "_relu"
        return name + "_bn"

    def _identity_block(self, g, stage, block, inp, filters):
        f1, f2, f3 = filters
        p = f"res{stage}{block}"
        x = self._conv_bn_act(g, p + "_2a", inp, f1, (1, 1))
        x = self._conv_bn_act(g, p + "_2b", x, f2, (3, 3), padding="same")
        x = self._conv_bn_act(g, p + "_2c", x, f3, (1, 1), act=False)
        g.add_vertex(p + "_add", ElementWiseVertex(op="add"), x, inp)
        g.add_layer(p + "_out", ActivationLayer(activation="relu"), p + "_add")
        return p + "_out"

    def _conv_block(self, g, stage, block, inp, filters, stride=(2, 2)):
        f1, f2, f3 = filters
        p = f"res{stage}{block}"
        x = self._conv_bn_act(g, p + "_2a", inp, f1, (1, 1), stride=stride)
        x = self._conv_bn_act(g, p + "_2b", x, f2, (3, 3), padding="same")
        x = self._conv_bn_act(g, p + "_2c", x, f3, (1, 1), act=False)
        sc = self._conv_bn_act(g, p + "_1", inp, f3, (1, 1), stride=stride,
                               act=False)
        g.add_vertex(p + "_add", ElementWiseVertex(op="add"), x, sc)
        g.add_layer(p + "_out", ActivationLayer(activation="relu"), p + "_add")
        return p + "_out"

    def conf(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(1e-1, 0.9))
             .weight_init("relu")
             .data_type(self.data_type)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        # stem
        g.add_layer("pad1", ZeroPaddingLayer(padding=(3, 3, 3, 3)), "input")
        x = self._conv_bn_act(g, "conv1", "pad1", 64, (7, 7), stride=(2, 2))
        g.add_layer("pool1", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                              padding=1), x)
        x = "pool1"
        # stage 2
        x = self._conv_block(g, 2, "a", x, (64, 64, 256), stride=(1, 1))
        x = self._identity_block(g, 2, "b", x, (64, 64, 256))
        x = self._identity_block(g, 2, "c", x, (64, 64, 256))
        # stage 3
        x = self._conv_block(g, 3, "a", x, (128, 128, 512))
        for blk in "bcd":
            x = self._identity_block(g, 3, blk, x, (128, 128, 512))
        # stage 4
        x = self._conv_block(g, 4, "a", x, (256, 256, 1024))
        for blk in "bcdef":
            x = self._identity_block(g, 4, blk, x, (256, 256, 1024))
        # stage 5
        x = self._conv_block(g, 5, "a", x, (512, 512, 2048))
        x = self._identity_block(g, 5, "b", x, (512, 512, 2048))
        x = self._identity_block(g, 5, "c", x, (512, 512, 2048))
        # head
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation="softmax",
                                          loss_function="mcxent"), "avgpool")
        return g.set_outputs("output").build()
