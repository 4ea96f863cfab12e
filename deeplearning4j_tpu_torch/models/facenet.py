"""InceptionResNetV1 (the FaceNet backbone) zoo model at its published
defaults.

Counterpart of ``deeplearning4j_tpu/models/facenet.py`` (DL4J's
``org.deeplearning4j.zoo.model.InceptionResNetV1``), with the same node
names and wiring: stem → 5×inception-resnet-A (block35) → reduction-A →
10×block17 → reduction-B → 5×block8 → average pool → dropout → 128-d
bottleneck, then two network outputs: a softmax loss head ``"output"`` and
the L2-normalised ``"embeddings"`` vertex that FaceNet serving reads (it
takes no label). Residual branches merge by concat → 1×1 linear conv →
ScaleVertex → elementwise add; Adam(1e-3).
"""

from __future__ import annotations

from typing import Tuple

from ..nn.conf import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    DropoutLayer,
    GlobalPoolingLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    SubsamplingLayer,
)
from ..nn.graph import ComputationGraph
from ..nn.graph_conf import ElementWiseVertex, L2NormalizeVertex, MergeVertex, ScaleVertex
from ..nn.updaters import Adam
from .zoo import ZooModel


class InceptionResNetV1(ZooModel):
    def __init__(self, num_classes: int = 1001, seed: int = 123,
                 embedding_size: int = 128,
                 input_shape: Tuple[int, int, int] = (3, 160, 160),
                 blocks: Tuple[int, int, int] = (5, 10, 5)):
        self.num_classes = num_classes
        self.seed = seed
        self.embedding_size = embedding_size
        self.input_shape = input_shape
        self.blocks = blocks  # (A, B, C) repeat counts; reference (5,10,5)

    def _net_class(self):
        return ComputationGraph

    # -- building blocks ----------------------------------------------------

    def _conv_bn(self, g, name, inp, n_out, kernel, stride=(1, 1), pad="same",
                 activation="relu"):
        g.add_layer(f"{name}_c", ConvolutionLayer(
            n_out=n_out, kernel_size=kernel, stride=stride,
            convolution_mode=pad, activation="identity", has_bias=False), inp)
        g.add_layer(f"{name}_bn", BatchNormalization(activation=activation,
                                                     eps=1e-3), f"{name}_c")
        return f"{name}_bn"

    def _block35(self, g, name, inp, scale=0.17):
        """Inception-resnet-A over 256ch maps (reference block35)."""
        b0 = self._conv_bn(g, f"{name}_b0", inp, 32, (1, 1))
        b1 = self._conv_bn(g, f"{name}_b1a", inp, 32, (1, 1))
        b1 = self._conv_bn(g, f"{name}_b1b", b1, 32, (3, 3))
        b2 = self._conv_bn(g, f"{name}_b2a", inp, 32, (1, 1))
        b2 = self._conv_bn(g, f"{name}_b2b", b2, 32, (3, 3))
        b2 = self._conv_bn(g, f"{name}_b2c", b2, 32, (3, 3))
        g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1, b2)
        g.add_layer(f"{name}_up", ConvolutionLayer(
            n_out=256, kernel_size=(1, 1), convolution_mode="same",
            activation="identity"), f"{name}_cat")
        g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), f"{name}_up")
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp, f"{name}_scale")
        g.add_layer(f"{name}_relu", ActivationLayer(activation="relu"), f"{name}_add")
        return f"{name}_relu"

    def _block17(self, g, name, inp, scale=0.10):
        """Inception-resnet-B over 896ch maps (reference block17)."""
        b0 = self._conv_bn(g, f"{name}_b0", inp, 128, (1, 1))
        b1 = self._conv_bn(g, f"{name}_b1a", inp, 128, (1, 1))
        b1 = self._conv_bn(g, f"{name}_b1b", b1, 128, (1, 7))
        b1 = self._conv_bn(g, f"{name}_b1c", b1, 128, (7, 1))
        g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1)
        g.add_layer(f"{name}_up", ConvolutionLayer(
            n_out=896, kernel_size=(1, 1), convolution_mode="same",
            activation="identity"), f"{name}_cat")
        g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), f"{name}_up")
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp, f"{name}_scale")
        g.add_layer(f"{name}_relu", ActivationLayer(activation="relu"), f"{name}_add")
        return f"{name}_relu"

    def _block8(self, g, name, inp, scale=0.20, relu=True):
        """Inception-resnet-C over 1792ch maps (reference block8)."""
        b0 = self._conv_bn(g, f"{name}_b0", inp, 192, (1, 1))
        b1 = self._conv_bn(g, f"{name}_b1a", inp, 192, (1, 1))
        b1 = self._conv_bn(g, f"{name}_b1b", b1, 192, (1, 3))
        b1 = self._conv_bn(g, f"{name}_b1c", b1, 192, (3, 1))
        g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1)
        g.add_layer(f"{name}_up", ConvolutionLayer(
            n_out=1792, kernel_size=(1, 1), convolution_mode="same",
            activation="identity"), f"{name}_cat")
        g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), f"{name}_up")
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp, f"{name}_scale")
        if relu:
            g.add_layer(f"{name}_relu", ActivationLayer(activation="relu"), f"{name}_add")
            return f"{name}_relu"
        return f"{name}_add"

    def _reduction_a(self, g, name, inp):
        """35×35×256 → 17×17×896."""
        b0 = self._conv_bn(g, f"{name}_b0", inp, 384, (3, 3), (2, 2), pad="truncate")
        b1 = self._conv_bn(g, f"{name}_b1a", inp, 192, (1, 1))
        b1 = self._conv_bn(g, f"{name}_b1b", b1, 192, (3, 3))
        b1 = self._conv_bn(g, f"{name}_b1c", b1, 256, (3, 3), (2, 2), pad="truncate")
        g.add_layer(f"{name}_pool", SubsamplingLayer(
            pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
            convolution_mode="truncate"), inp)
        g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1, f"{name}_pool")
        return f"{name}_cat"

    def _reduction_b(self, g, name, inp):
        """17×17×896 → 8×8×1792."""
        b0 = self._conv_bn(g, f"{name}_b0a", inp, 256, (1, 1))
        b0 = self._conv_bn(g, f"{name}_b0b", b0, 384, (3, 3), (2, 2), pad="truncate")
        b1 = self._conv_bn(g, f"{name}_b1a", inp, 256, (1, 1))
        b1 = self._conv_bn(g, f"{name}_b1b", b1, 256, (3, 3), (2, 2), pad="truncate")
        b2 = self._conv_bn(g, f"{name}_b2a", inp, 256, (1, 1))
        b2 = self._conv_bn(g, f"{name}_b2b", b2, 256, (3, 3))
        b2 = self._conv_bn(g, f"{name}_b2c", b2, 256, (3, 3), (2, 2), pad="truncate")
        g.add_layer(f"{name}_pool", SubsamplingLayer(
            pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
            convolution_mode="truncate"), inp)
        g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1, b2, f"{name}_pool")
        return f"{name}_cat"

    # -- full graph ---------------------------------------------------------

    def conf(self):
        c, h, w = self.input_shape
        nA, nB, nC = self.blocks
        g = (
            NeuralNetConfiguration.Builder()
            .seed(self.seed)
            .updater(Adam(1e-3))
            .weight_init("relu")
            .graph_builder()
            .add_inputs("input")
            .set_input_types(InputType.convolutional(h, w, c))
        )
        # stem: 149×149×32 → 147×147×32 → 147×147×64 → pool → 1×1/3×3 → 256
        x = self._conv_bn(g, "stem1", "input", 32, (3, 3), (2, 2), pad="truncate")
        x = self._conv_bn(g, "stem2", x, 32, (3, 3), pad="truncate")
        x = self._conv_bn(g, "stem3", x, 64, (3, 3))
        g.add_layer("stem_pool", SubsamplingLayer(
            pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
            convolution_mode="truncate"), x)
        x = self._conv_bn(g, "stem4", "stem_pool", 80, (1, 1))
        x = self._conv_bn(g, "stem5", x, 192, (3, 3), pad="truncate")
        x = self._conv_bn(g, "stem6", x, 256, (3, 3), (2, 2), pad="truncate")
        for i in range(nA):
            x = self._block35(g, f"a{i}", x)
        x = self._reduction_a(g, "redA", x)
        for i in range(nB):
            x = self._block17(g, f"b{i}", x)
        x = self._reduction_b(g, "redB", x)
        for i in range(nC - 1):
            x = self._block8(g, f"c{i}", x)
        x = self._block8(g, "c_last", x, scale=1.0, relu=False)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("drop", DropoutLayer(dropout=0.2), "avgpool")
        g.add_layer("bottleneck", DenseLayer(n_out=self.embedding_size,
                                             activation="identity"), "drop")
        # the FaceNet serving output: unit-norm embeddings
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("output", OutputLayer(
            n_out=self.num_classes, activation="softmax",
            loss="negativeloglikelihood"), "bottleneck")
        # both heads are network outputs: training reads "output" (the only
        # loss head), FaceNet serving reads the second return of output()
        g.set_outputs("output", "embeddings")
        return g.build()
