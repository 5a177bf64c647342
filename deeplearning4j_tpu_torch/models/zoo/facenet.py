"""FaceNetNN4Small2: counterpart of
``deeplearning4j_tpu/models/zoo/facenet.py`` (ref:
``org.deeplearning4j.zoo.model.FaceNetNN4Small2``, the OpenFace
nn4.small2 inception variant).

A 7x7/2 stem, a pool and a conv block, inception 3a/3b, the stride-2
reduction 3c, 4a, the reduction 4e, 5a/5b, global average pooling, a
128-d bottleneck, an L2-normalised embedding and a CenterLossOutputLayer.
``width_mult`` scales the channel counts down for small test nets.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, CenterLossOutputLayer,
    ConvolutionLayer, DenseLayer, GlobalPoolingLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.graph_conf import L2NormalizeVertex, MergeVertex
from deeplearning4j_tpu_torch.optim.updaters import Adam
from deeplearning4j_tpu_torch.models.zoo.base import ZooModel


class FaceNetNN4Small2(ZooModel):
    """ref: FaceNetNN4Small2#init / #graphBuilder (alpha=0.05, lambda=2e-4
    center loss; 96x96x3 input; 128-d L2-normalised embedding)."""

    input_shape = (96, 96, 3)

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape=(96, 96, 3), embedding_size: int = 128,
                 width_mult: float = 1.0, updater=None,
                 alpha: float = 0.05, lambda_: float = 2e-4,
                 data_type: str = "float32"):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = tuple(input_shape)
        self.embedding_size = embedding_size
        self.width_mult = width_mult
        self.updater = updater
        self.alpha = alpha
        self.lambda_ = lambda_
        self.data_type = data_type

    def _w(self, n):
        return max(4, int(n * self.width_mult))

    def _cba(self, g, name, inp, n_out, kernel, stride=(1, 1)):
        g.add_layer(name, ConvolutionLayer(kernel_size=kernel, stride=stride,
                                           padding="same", n_out=n_out,
                                           has_bias=False,
                                           activation="identity"), inp)
        g.add_layer(name + "_bn", BatchNormalization(), name)
        g.add_layer(name + "_relu", ActivationLayer(activation="relu"),
                    name + "_bn")
        return name + "_relu"

    def _reduction(self, g, name, inp, c3r, c3, c5r, c5):
        """NN4 stride-2 inception reduction (modules 3c/4e): [1x1→3x3/2] +
        [1x1→5x5/2] + [maxpool/2] merged."""
        a = self._cba(g, f"{name}_3x3r", inp, self._w(c3r), (1, 1))
        a = self._cba(g, f"{name}_3x3", a, self._w(c3), (3, 3),
                      stride=(2, 2))
        b = self._cba(g, f"{name}_5x5r", inp, self._w(c5r), (1, 1))
        b = self._cba(g, f"{name}_5x5", b, self._w(c5), (5, 5),
                      stride=(2, 2))
        g.add_layer(f"{name}_pool",
                    SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                     stride=(2, 2), padding="same"), inp)
        g.add_vertex(name, MergeVertex(), a, b, f"{name}_pool")
        return name

    def _inception(self, g, name, inp, c1, c3r, c3, c5r, c5, pp):
        """NN4 inception module: [1x1] + [1x1→3x3] + [1x1→5x5] + [pool→1x1];
        a zero channel count drops that branch (the reference's 3c/4e/5x
        modules omit 1x1 or 5x5 branches the same way)."""
        outs = []
        if c1:
            outs.append(self._cba(g, f"{name}_1x1", inp, self._w(c1), (1, 1)))
        if c3:
            x = self._cba(g, f"{name}_3x3r", inp, self._w(c3r), (1, 1))
            outs.append(self._cba(g, f"{name}_3x3", x, self._w(c3), (3, 3)))
        if c5:
            x = self._cba(g, f"{name}_5x5r", inp, self._w(c5r), (1, 1))
            outs.append(self._cba(g, f"{name}_5x5", x, self._w(c5), (5, 5)))
        if pp:
            g.add_layer(f"{name}_pool",
                        SubsamplingLayer(pooling_type="max",
                                         kernel_size=(3, 3), stride=(1, 1),
                                         padding="same"), inp)
            outs.append(self._cba(g, f"{name}_poolproj", f"{name}_pool",
                                  self._w(pp), (1, 1)))
        g.add_vertex(name, MergeVertex(), *outs)
        return name

    def conf(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .data_type(self.data_type)
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        # stem: 7x7/2 conv → 3x3/2 pool → 1x1 → 3x3 → 3x3/2 pool
        x = self._cba(g, "conv1", "input", self._w(64), (7, 7),
                      stride=(2, 2))
        g.add_layer("pool1", SubsamplingLayer(kernel_size=(3, 3),
                                              stride=(2, 2),
                                              padding="same"), x)
        x = self._cba(g, "conv2", "pool1", self._w(64), (1, 1))
        x = self._cba(g, "conv3", x, self._w(192), (3, 3))
        g.add_layer("pool3", SubsamplingLayer(kernel_size=(3, 3),
                                              stride=(2, 2),
                                              padding="same"), x)
        # inception stack (channel table per nn4.small2); 3c and 4e are the
        # stride-2 inception reductions of the reference
        x = self._inception(g, "inc3a", "pool3", 64, 96, 128, 16, 32, 32)
        x = self._inception(g, "inc3b", x, 64, 96, 128, 32, 64, 64)
        x = self._reduction(g, "inc3c", x, 128, 256, 32, 64)
        x = self._inception(g, "inc4a", x, 256, 96, 192, 32, 64, 128)
        x = self._reduction(g, "inc4e", x, 160, 256, 64, 128)
        x = self._inception(g, "inc5a", x, 256, 96, 384, 0, 0, 96)
        x = self._inception(g, "inc5b", x, 256, 96, 384, 0, 0, 96)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("bottleneck",
                    DenseLayer(n_out=self.embedding_size,
                               activation="identity"), "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("out",
                    CenterLossOutputLayer(n_out=self.num_classes,
                                          activation="softmax",
                                          loss_function="mcxent",
                                          alpha=self.alpha,
                                          lambda_=self.lambda_),
                    "embeddings")
        g.set_outputs("out")
        return g.build()
