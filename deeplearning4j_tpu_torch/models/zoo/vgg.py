"""VGG16 and VGG19: counterpart of ``deeplearning4j_tpu/models/zoo/vgg.py``
(ref: ``org.deeplearning4j.zoo.model.{VGG16,VGG19}``; BASELINE.json's
configs[1] names VGG16). Five blocks of 3x3 "same" convolutions (relu,
He init) each closed by a 2x2/2 max pool, then two dense layers of 4096
with dropout (retain 0.5) and a softmax output.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.optim.updaters import Nesterovs
from deeplearning4j_tpu_torch.models.zoo.base import ZooModel

# channel plan per block: (n_convs, n_out)
_VGG16_BLOCKS = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
_VGG19_BLOCKS = [(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]


class VGG16(ZooModel):
    input_shape = (224, 224, 3)
    _blocks = _VGG16_BLOCKS

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
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(1e-2, 0.9))
             .data_type(self.data_type)
             .weight_init("relu")
             .activation("relu")
             .list())
        for n_convs, n_out in self._blocks:
            for _ in range(n_convs):
                b.layer(ConvolutionLayer(kernel_size=(3, 3), padding="same",
                                         n_out=n_out))
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        b.layer(DenseLayer(n_out=4096, dropout=0.5))
        b.layer(DenseLayer(n_out=4096, dropout=0.5))
        b.layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                            loss_function="mcxent"))
        return b.set_input_type(InputType.convolutional(h, w, c)).build()


class VGG19(VGG16):
    _blocks = _VGG19_BLOCKS
