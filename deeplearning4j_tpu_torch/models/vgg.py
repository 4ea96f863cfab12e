"""VGG-16 and VGG-19 at their published widths.

Counterpart of ``deeplearning4j_tpu/models/vgg.py`` (DL4J's
``org.deeplearning4j.zoo.model.VGG16`` / ``VGG19``), with the same
configuration: 13 (16) 3x3 "same" ReLU convolutions in five blocks, each
block closed by a 2x2/2 max pool, then two dense layers of 4096 with
dropout 0.5 and a softmax over 1000 classes; He ("relu") init, Nesterovs(1e-2,
0.9). No BatchNormalization: the step is convolutions (cuDNN through
``F.conv2d``) and three large GEMMs.
"""

from __future__ import annotations

from typing import Tuple

from ..nn.conf import (
    ConvolutionLayer,
    DenseLayer,
    DropoutLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    SubsamplingLayer,
)
from ..nn.updaters import Nesterovs
from .zoo import ZooModel


class VGG16(ZooModel):
    BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape: Tuple[int, int, int] = (3, 224, 224)):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = input_shape

    def conf(self):
        c, h, w = self.input_shape
        b = (
            NeuralNetConfiguration.Builder()
            .seed(self.seed)
            .updater(Nesterovs(1e-2, 0.9))
            .weight_init("relu")
            .list()
        )
        for n_convs, n_out in self.BLOCKS:
            for _ in range(n_convs):
                b = b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                             convolution_mode="same", activation="relu"))
            b = b.layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
        return (
            b.layer(DenseLayer(n_out=4096, activation="relu"))
            .layer(DropoutLayer(dropout=0.5))
            .layer(DenseLayer(n_out=4096, activation="relu"))
            .layer(DropoutLayer(dropout=0.5))
            .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                               loss="negativeloglikelihood"))
            .set_input_type(InputType.convolutional(h, w, c))
            .build()
        )


class VGG19(VGG16):
    """org.deeplearning4j.zoo.model.VGG19: the last three blocks grow to 4
    convolutions; everything else is VGG16's."""

    BLOCKS = ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512))
