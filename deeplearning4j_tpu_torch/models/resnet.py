"""ResNet-50 — the ComputationGraph zoo model at its published widths.

Counterpart of ``deeplearning4j_tpu/models/resnet.py`` (DL4J's
``org.deeplearning4j.zoo.model.ResNet50``), with the same node names and
block structure: a 7x7/2 stem convolution, BN, ReLU and a 3x3/2 "same" max
pool, then bottleneck blocks (1x1, 3x3, 1x1 convolutions, each with BN; the
stride on the 1x1 "a" convolution; a projection shortcut in each stage's
first block), global average pooling and a softmax output; Nesterovs(0.1,
0.9). The convolutions are cuDNN's through ``F.conv2d``, as the reference's
are XLA's.
"""

from __future__ import annotations

from typing import Tuple

from ..nn.conf import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    GlobalPoolingLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    SubsamplingLayer,
)
from ..nn.graph import ComputationGraph
from ..nn.graph_conf import ElementWiseVertex
from ..nn.updaters import Nesterovs
from .zoo import ZooModel


class ResNet50(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape: Tuple[int, int, int] = (3, 224, 224)):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = input_shape

    def _net_class(self):
        return ComputationGraph

    # -- block builders (ResNet50.graphBuilder conv/identity blocks) --------

    def _conv_bn(self, g, name, inp, n_out, kernel, stride, activation="relu", pad_same=True):
        g.add_layer(f"{name}_conv", ConvolutionLayer(
            n_out=n_out, kernel_size=kernel, stride=stride,
            convolution_mode="same" if pad_same else "truncate",
            activation="identity", has_bias=False), inp)
        g.add_layer(f"{name}_bn", BatchNormalization(activation=activation), f"{name}_conv")
        return f"{name}_bn"

    def _bottleneck(self, g, name, inp, filters, stride, project):
        f1, f2, f3 = filters
        x = self._conv_bn(g, f"{name}_a", inp, f1, (1, 1), stride)
        x = self._conv_bn(g, f"{name}_b", x, f2, (3, 3), (1, 1))
        x = self._conv_bn(g, f"{name}_c", x, f3, (1, 1), (1, 1), activation="identity")
        if project:
            sc = self._conv_bn(g, f"{name}_sc", inp, f3, (1, 1), stride, activation="identity")
        else:
            sc = inp
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
        g.add_layer(f"{name}_relu", ActivationLayer(activation="relu"), f"{name}_add")
        return f"{name}_relu"

    def conf(self):
        c, h, w = self.input_shape
        g = (
            NeuralNetConfiguration.Builder()
            .seed(self.seed)
            .updater(Nesterovs(0.1, 0.9))
            .weight_init("relu")
            .graph_builder()
            .add_inputs("input")
            .set_input_types(InputType.convolutional(h, w, c))
        )
        # stem: 7x7/2 conv + BN + relu + 3x3/2 maxpool
        x = self._conv_bn(g, "stem", "input", 64, (7, 7), (2, 2))
        g.add_layer("stem_pool", SubsamplingLayer(
            pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
            convolution_mode="same"), x)
        x = "stem_pool"
        stages = [
            ("res2", (64, 64, 256), 3, (1, 1)),
            ("res3", (128, 128, 512), 4, (2, 2)),
            ("res4", (256, 256, 1024), 6, (2, 2)),
            ("res5", (512, 512, 2048), 3, (2, 2)),
        ]
        for sname, filters, blocks, stride in stages:
            x = self._bottleneck(g, f"{sname}a", x, filters, stride, project=True)
            for b in range(1, blocks):
                x = self._bottleneck(g, f"{sname}{chr(ord('a') + b)}", x, filters, (1, 1),
                                     project=False)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("output", OutputLayer(
            n_out=self.num_classes, activation="softmax",
            loss="negativeloglikelihood"), "avgpool")
        g.set_outputs("output")
        return g.build()
