"""Small sequential zoo models: counterpart of
``deeplearning4j_tpu/models/zoo/cnn_small.py`` (ref:
``org.deeplearning4j.zoo.model.{LeNet,SimpleCNN,AlexNet,
TextGenerationLSTM}``).
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import (
    BackpropType, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LSTM, BatchNormalization, ConvolutionLayer, DenseLayer, DropoutLayer,
    LocalResponseNormalization, OutputLayer, RnnOutputLayer,
    SubsamplingLayer)
from deeplearning4j_tpu_torch.optim.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.models.zoo.base import ZooModel


class LeNet(ZooModel):
    """ref: zoo.model.LeNet — the BASELINE configs[0] MNIST architecture."""
    input_shape = (28, 28, 1)
    num_classes = 10

    def __init__(self, num_classes: int = 10, seed: int = 123,
                 input_shape=(28, 28, 1), updater=None,
                 data_type: str = "float32"):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = tuple(input_shape)
        self.updater = updater
        self.data_type = data_type

    def conf(self):
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater or Adam(1e-3))
                .data_type(self.data_type)
                .weight_init("xavier")
                .list()
                .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(1, 1),
                                        n_out=20, activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(1, 1),
                                        n_out=50, activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                   loss_function="mcxent"))
                # convolutional_flat, matching the reference LeNetMNIST
                # example contract: MnistDataSetIterator feeds (N, 784) rows
                # (4-D NHWC input still passes through untouched)
                .set_input_type(InputType.convolutional_flat(h, w, c))
                .build())


class SimpleCNN(ZooModel):
    """ref: zoo.model.SimpleCNN."""
    input_shape = (48, 48, 3)

    def __init__(self, num_classes: int = 10, seed: int = 123,
                 input_shape=(48, 48, 3), updater=None,
                 data_type: str = "float32"):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = tuple(input_shape)
        self.updater = updater
        self.data_type = data_type

    def conf(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .data_type(self.data_type)
             .weight_init("relu")
             .activation("relu")
             .list())
        # block1: conv 7x7x16 + BN, block2-4: double conv + pool
        b.layer(ConvolutionLayer(kernel_size=(7, 7), padding="same", n_out=16))
        b.layer(BatchNormalization())
        for n_out in (32, 64, 128):
            b.layer(ConvolutionLayer(kernel_size=(3, 3), padding="same", n_out=n_out))
            b.layer(BatchNormalization())
            b.layer(ConvolutionLayer(kernel_size=(3, 3), padding="same", n_out=n_out))
            b.layer(BatchNormalization())
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            b.layer(DropoutLayer(dropout=0.7))
        b.layer(DenseLayer(n_out=256, dropout=0.5))
        b.layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                            loss_function="mcxent"))
        return b.set_input_type(InputType.convolutional(h, w, c)).build()


class AlexNet(ZooModel):
    """ref: zoo.model.AlexNet — the one-tower variant with LRN as in the
    original: N(0, 1) weight init ("normal"), relu, the 11x11/4 stem with
    integer padding 2, biases 1.0 on conv 2, 4, 5 and the dense layers,
    LRN at its defaults (k 2, n 5, alpha 1e-4, beta 0.75)."""
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
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater or Nesterovs(1e-2, 0.9))
                .data_type(self.data_type)
                .weight_init("normal")
                .activation("relu")
                .list()
                .layer(ConvolutionLayer(kernel_size=(11, 11), stride=(4, 4),
                                        padding=2, n_out=96))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(kernel_size=(5, 5), padding=2,
                                        n_out=256, bias_init=1.0))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(kernel_size=(3, 3), padding=1,
                                        n_out=384))
                .layer(ConvolutionLayer(kernel_size=(3, 3), padding=1,
                                        n_out=384, bias_init=1.0))
                .layer(ConvolutionLayer(kernel_size=(3, 3), padding=1,
                                        n_out=256, bias_init=1.0))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(n_out=4096, bias_init=1.0, dropout=0.5))
                .layer(DenseLayer(n_out=4096, bias_init=1.0, dropout=0.5))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax",
                                   loss_function="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class TextGenerationLSTM(ZooModel):
    """ref: zoo.model.TextGenerationLSTM — the char-level 2 × LSTM(256)
    language model, trained by truncated BPTT."""

    def __init__(self, total_unique_characters: int = 47, seed: int = 123,
                 tbptt_length: int = 50, updater=None,
                 data_type: str = "float32"):
        self.n_chars = total_unique_characters
        self.seed = seed
        self.tbptt_length = tbptt_length
        self.updater = updater
        self.data_type = data_type

    def conf(self):
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater or Adam(1e-3))
                .data_type(self.data_type)
                .weight_init("xavier")
                .list()
                .layer(LSTM(n_in=self.n_chars, n_out=256, activation="tanh"))
                .layer(LSTM(n_out=256, activation="tanh"))
                .layer(RnnOutputLayer(n_out=self.n_chars, activation="softmax",
                                      loss_function="mcxent"))
                .backprop_type(BackpropType.TruncatedBPTT)
                .t_bptt_length(self.tbptt_length)
                .set_input_type(InputType.recurrent(self.n_chars))
                .build())
