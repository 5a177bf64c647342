"""InceptionResNetV1 and NASNet: counterpart of
``deeplearning4j_tpu/models/zoo/inception.py`` (ref:
``org.deeplearning4j.zoo.model.InceptionResNetV1``, the FaceNet embedding
network, and ``NASNet``, its mobile variant).

Both are ComputationGraph DAGs of the reference's cells: Inception-ResNet
A/B/C blocks with scaled residual adds, NASNet's separable-convolution
normal and reduction cells with branch adds and a concat; ``blocks`` /
``num_blocks`` size them, so tests can build small nets of the same
structure.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    DropoutLayer, GlobalPoolingLayer, OutputLayer, SeparableConvolution2D,
    SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.graph_conf import (ElementWiseVertex,
                                              L2NormalizeVertex, MergeVertex,
                                              ScaleVertex)
from deeplearning4j_tpu_torch.optim.updaters import Adam, RmsProp
from deeplearning4j_tpu_torch.models.zoo.base import ZooModel


class InceptionResNetV1(ZooModel):
    """FaceNet-style Inception-ResNet: stem → A×a → reduction-A → B×b →
    reduction-B → C×c → pool → dropout → 128-d embedding (L2-normalised) →
    softmax head (ref: InceptionResNetV1#graphBuilder + #appendGraph)."""

    input_shape = (160, 160, 3)

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape=(160, 160, 3), blocks=(5, 10, 5),
                 embedding_size: int = 128, updater=None,
                 data_type: str = "float32"):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = tuple(input_shape)
        self.blocks = tuple(blocks)
        self.embedding_size = embedding_size
        self.updater = updater
        self.data_type = data_type

    def _cba(self, g, name, inp, n_out, kernel, stride=(1, 1), pad="same"):
        g.add_layer(name, ConvolutionLayer(kernel_size=kernel, stride=stride,
                                           padding=pad, n_out=n_out,
                                           has_bias=False,
                                           activation="identity"), inp)
        g.add_layer(name + "_bn", BatchNormalization(), name)
        g.add_layer(name + "_relu", ActivationLayer(activation="relu"),
                    name + "_bn")
        return name + "_relu"

    def _resnet_block(self, g, name, inp, branches, n_channels, scale):
        """Inception-ResNet cell: branches → concat → 1x1 up → scaled add."""
        outs = []
        for bi, branch in enumerate(branches):
            x = inp
            for li, (n_out, kernel) in enumerate(branch):
                x = self._cba(g, f"{name}_b{bi}_{li}", x, n_out, kernel)
            outs.append(x)
        g.add_vertex(name + "_cat", MergeVertex(), *outs)
        g.add_layer(name + "_up", ConvolutionLayer(kernel_size=(1, 1),
                                                   n_out=n_channels,
                                                   activation="identity"),
                    name + "_cat")
        g.add_vertex(name + "_scale", ScaleVertex(scale), name + "_up")
        g.add_vertex(name + "_add", ElementWiseVertex(op="add"), inp,
                     name + "_scale")
        g.add_layer(name + "_out", ActivationLayer(activation="relu"),
                    name + "_add")
        return name + "_out"

    def _reduction(self, g, name, inp, branches):
        """Stride-2 multi-branch reduction + stride-2 maxpool, concat."""
        outs = []
        for bi, branch in enumerate(branches):
            x = inp
            for li, (n_out, kernel, stride) in enumerate(branch):
                x = self._cba(g, f"{name}_b{bi}_{li}", x, n_out, kernel,
                              stride=stride,
                              pad="same" if stride == (1, 1) else 0)
            outs.append(x)
        g.add_layer(name + "_pool", SubsamplingLayer(kernel_size=(3, 3),
                                                     stride=(2, 2)), inp)
        g.add_vertex(name + "_cat", MergeVertex(), *(outs + [name + "_pool"]))
        return name + "_cat"

    def conf(self):
        h, w, c = self.input_shape
        a, b, cc = self.blocks
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or RmsProp(0.1))
             .data_type(self.data_type)
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        # stem (ref stem is deeper; same downsampling profile)
        x = self._cba(g, "stem1", "input", 32, (3, 3), stride=(2, 2))
        x = self._cba(g, "stem2", x, 64, (3, 3))
        g.add_layer("stem_pool", SubsamplingLayer(kernel_size=(3, 3),
                                                  stride=(2, 2)), x)
        x = self._cba(g, "stem3", "stem_pool", 128, (1, 1))
        x = self._cba(g, "stem4", x, 256, (3, 3), stride=(2, 2))
        ch = 256
        for i in range(a):      # Inception-ResNet-A ×a, scale 0.17
            x = self._resnet_block(
                g, f"iresA{i}", x,
                [[(32, (1, 1))],
                 [(32, (1, 1)), (32, (3, 3))],
                 [(32, (1, 1)), (32, (3, 3)), (32, (3, 3))]], ch, 0.17)
        x = self._reduction(
            g, "redA", x,
            [[(192, (3, 3), (2, 2))],
             [(96, (1, 1), (1, 1)), (96, (3, 3), (1, 1)),
              (128, (3, 3), (2, 2))]])
        ch = ch + 192 + 128
        for i in range(b):      # Inception-ResNet-B ×b, scale 0.10
            x = self._resnet_block(
                g, f"iresB{i}", x,
                [[(64, (1, 1))],
                 [(64, (1, 1)), (64, (1, 7)), (64, (7, 1))]], ch, 0.10)
        x = self._reduction(
            g, "redB", x,
            [[(128, (1, 1), (1, 1)), (192, (3, 3), (2, 2))],
             [(128, (1, 1), (1, 1)), (128, (3, 3), (2, 2))],
             [(128, (1, 1), (1, 1)), (128, (3, 3), (1, 1)),
              (128, (3, 3), (2, 2))]])
        ch = ch + 192 + 128 + 128
        for i in range(cc):     # Inception-ResNet-C ×c, scale 0.20
            x = self._resnet_block(
                g, f"iresC{i}", x,
                [[(96, (1, 1))],
                 [(96, (1, 1)), (96, (1, 3)), (96, (3, 1))]], ch, 0.20)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("drop", DropoutLayer(dropout=0.8), "avgpool")
        g.add_layer("bottleneck", DenseLayer(n_out=self.embedding_size,
                                             activation="identity"), "drop")
        # FaceNet embedding: L2-normalised bottleneck
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                       activation="softmax",
                                       loss_function="mcxent"), "embeddings")
        g.set_outputs("out")
        return g.build()


class NASNet(ZooModel):
    """NASNet-mobile-style cell stack (ref: zoo.model.NASNet): stem conv →
    [normal×n, reduction]×2 → normal×n → pool → softmax. Cells use the
    NASNet branch vocabulary (sep3x3, sep5x5, avgpool3x3, identity) with
    elementwise adds and a final concat."""

    input_shape = (224, 224, 3)

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape=(224, 224, 3), penultimate_filters: int = 1056,
                 num_blocks: int = 4, updater=None,
                 data_type: str = "float32"):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = tuple(input_shape)
        self.penultimate_filters = penultimate_filters
        self.num_blocks = num_blocks
        self.updater = updater
        self.data_type = data_type

    def _sep(self, g, name, inp, n_out, kernel, stride=(1, 1)):
        g.add_layer(name + "_relu", ActivationLayer(activation="relu"), inp)
        g.add_layer(name, SeparableConvolution2D(
            kernel_size=kernel, stride=stride, padding="same", n_out=n_out,
            has_bias=False, activation="identity"), name + "_relu")
        g.add_layer(name + "_bn", BatchNormalization(), name)
        return name + "_bn"

    def _fit(self, g, name, inp, n_out, stride=(1, 1)):
        """1x1 projection so branch adds see matching channels/strides."""
        g.add_layer(name, ConvolutionLayer(kernel_size=(1, 1), stride=stride,
                                           n_out=n_out, has_bias=False,
                                           activation="identity"), inp)
        g.add_layer(name + "_bn", BatchNormalization(), name)
        return name + "_bn"

    def _normal_cell(self, g, name, inp, filters):
        h = self._fit(g, name + "_h", inp, filters)
        b1 = self._sep(g, name + "_s3a", h, filters, (3, 3))
        g.add_vertex(name + "_add1", ElementWiseVertex(op="add"), b1, h)
        b2 = self._sep(g, name + "_s5", h, filters, (5, 5))
        b3 = self._sep(g, name + "_s3b", h, filters, (3, 3))
        g.add_vertex(name + "_add2", ElementWiseVertex(op="add"), b2, b3)
        g.add_layer(name + "_ap", SubsamplingLayer(
            pooling_type="avg", kernel_size=(3, 3), stride=(1, 1),
            padding=1), h)
        g.add_vertex(name + "_add3", ElementWiseVertex(op="add"),
                     name + "_ap", h)
        g.add_vertex(name + "_cat", MergeVertex(), name + "_add1",
                     name + "_add2", name + "_add3")
        return name + "_cat"

    def _reduction_cell(self, g, name, inp, filters):
        b1 = self._sep(g, name + "_s5", inp, filters, (5, 5), stride=(2, 2))
        b2 = self._sep(g, name + "_s3", inp, filters, (3, 3), stride=(2, 2))
        g.add_vertex(name + "_add1", ElementWiseVertex(op="add"), b1, b2)
        g.add_layer(name + "_mp", SubsamplingLayer(
            pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
            padding=1), inp)
        p = self._fit(g, name + "_pfit", name + "_mp", filters)
        g.add_vertex(name + "_cat", MergeVertex(), name + "_add1", p)
        return name + "_cat"

    def conf(self):
        h, w, c = self.input_shape
        filters = self.penultimate_filters // 24
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .data_type(self.data_type)
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        g.add_layer("stem", ConvolutionLayer(kernel_size=(3, 3),
                                             stride=(2, 2), n_out=filters,
                                             has_bias=False,
                                             activation="identity"), "input")
        g.add_layer("stem_bn", BatchNormalization(), "stem")
        x = "stem_bn"
        f = filters
        for stage in range(3):
            for i in range(self.num_blocks):
                x = self._normal_cell(g, f"n{stage}_{i}", x, f)
            if stage < 2:
                f *= 2
                x = self._reduction_cell(g, f"r{stage}", x, f)
        g.add_layer("relu_out", ActivationLayer(activation="relu"), x)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"),
                    "relu_out")
        g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                       activation="softmax",
                                       loss_function="mcxent"), "avgpool")
        g.set_outputs("out")
        return g.build()
