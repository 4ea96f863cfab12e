"""AlexNet, Darknet19, SqueezeNet, UNet and Xception at their published
widths.

Counterpart of ``deeplearning4j_tpu/models/zoo_ext.py`` (DL4J's
``org.deeplearning4j.zoo.model.{AlexNet, Darknet19, SqueezeNet, UNet,
Xception}``), with the same configurations and node names: MultiLayerNetwork
stacks where the topology is linear (AlexNet, Darknet19), ComputationGraphs
where it branches. ``input_shape`` is a parameter so that tests run small;
the defaults are the reference's ImageNet configurations. A graph model's
``_net_class`` is ``ComputationGraph``, so ``ZooModel.init(device=)``
builds it on the card unless the caller asks for the CPU.
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
    LocalResponseNormalization,
    LossLayer,
    NeuralNetConfiguration,
    OutputLayer,
    SeparableConvolution2D,
    SubsamplingLayer,
    Upsampling2D,
)
from ..nn.graph import ComputationGraph
from ..nn.graph_conf import ElementWiseVertex, MergeVertex
from ..nn.updaters import Adam, Nesterovs
from .zoo import ZooModel


class AlexNet(ZooModel):
    """org.deeplearning4j.zoo.model.AlexNet (one tower): five convolutions,
    LRN after the first two, three 3x3/2 max pools, two dense layers of
    4096 with dropout 0.5 on their inputs."""

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape: Tuple[int, int, int] = (3, 227, 227)):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = input_shape

    def conf(self):
        c, h, w = self.input_shape
        return (
            NeuralNetConfiguration.Builder()
            .seed(self.seed)
            .updater(Nesterovs(1e-2, 0.9))
            .list()
            .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11), stride=(4, 4),
                                    activation="relu"))
            .layer(LocalResponseNormalization())
            .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                    convolution_mode="same", activation="relu"))
            .layer(LocalResponseNormalization())
            .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                    convolution_mode="same", activation="relu"))
            .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                    convolution_mode="same", activation="relu"))
            .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                    convolution_mode="same", activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
            .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
            .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
            .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional(h, w, c))
            .build()
        )


class Darknet19(ZooModel):
    """org.deeplearning4j.zoo.model.Darknet19 (the YOLO9000 backbone): 18
    convolution + BatchNormalization + leaky ReLU blocks, five 2x2/2 max
    pools, a 1x1 convolution to the classes, global average pooling."""

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape: Tuple[int, int, int] = (3, 224, 224)):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = input_shape

    def conf(self):
        c, h, w = self.input_shape

        def cbl(b, n_out, k):  # conv + BN + leaky relu (darknet block)
            b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(k, k),
                                     convolution_mode="same",
                                     activation="identity", has_bias=False))
            b.layer(BatchNormalization())
            b.layer(ActivationLayer(activation="leakyrelu"))
            return b

        b = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Nesterovs(1e-3, 0.9)).list())
        cbl(b, 32, 3)
        b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        cbl(b, 64, 3)
        b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        # 3x3 and 1x1 blocks in turns, each stage but the last pooled
        for widths, pool in (((128, 64, 128), True), ((256, 128, 256), True),
                             ((512, 256, 512, 256, 512), True),
                             ((1024, 512, 1024, 512, 1024), False)):
            for i, n_out in enumerate(widths):
                cbl(b, n_out, 1 if i % 2 else 3)
            if pool:
                b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        b.layer(ConvolutionLayer(n_out=self.num_classes, kernel_size=(1, 1),
                                 convolution_mode="same", activation="identity"))
        b.layer(GlobalPoolingLayer(pooling_type="avg"))
        b.layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                            loss="mcxent"))
        b.set_input_type(InputType.convolutional(h, w, c))
        return b.build()


class SqueezeNet(ZooModel):
    """org.deeplearning4j.zoo.model.SqueezeNet (fire modules, a graph)."""

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape: Tuple[int, int, int] = (3, 227, 227)):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = input_shape

    def _net_class(self):
        return ComputationGraph

    def _fire(self, g, name, inp, squeeze, expand):
        g.add_layer(f"{name}_sq", ConvolutionLayer(
            n_out=squeeze, kernel_size=(1, 1), activation="relu"), inp)
        g.add_layer(f"{name}_e1", ConvolutionLayer(
            n_out=expand, kernel_size=(1, 1), activation="relu"), f"{name}_sq")
        g.add_layer(f"{name}_e3", ConvolutionLayer(
            n_out=expand, kernel_size=(3, 3), convolution_mode="same",
            activation="relu"), f"{name}_sq")
        g.add_vertex(name, MergeVertex(), f"{name}_e1", f"{name}_e3")
        return name

    def conf(self):
        c, h, w = self.input_shape
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).graph_builder())
        g.add_inputs("input")
        g.add_layer("conv1", ConvolutionLayer(n_out=64, kernel_size=(3, 3),
                                              stride=(2, 2), activation="relu"),
                    "input")
        g.add_layer("pool1", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)),
                    "conv1")
        f = self._fire(g, "fire2", "pool1", 16, 64)
        f = self._fire(g, "fire3", f, 16, 64)
        g.add_layer("pool3", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)), f)
        f = self._fire(g, "fire4", "pool3", 32, 128)
        f = self._fire(g, "fire5", f, 32, 128)
        g.add_layer("pool5", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)), f)
        f = self._fire(g, "fire6", "pool5", 48, 192)
        f = self._fire(g, "fire7", f, 48, 192)
        g.add_layer("drop", DropoutLayer(dropout=0.5), f)
        g.add_layer("conv10", ConvolutionLayer(n_out=self.num_classes,
                                               kernel_size=(1, 1),
                                               activation="relu"), "drop")
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), "conv10")
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation="softmax", loss="mcxent"),
                    "gap")
        g.set_outputs("output")
        g.set_input_types(InputType.convolutional(h, w, c))
        return g.build()


class UNet(ZooModel):
    """org.deeplearning4j.zoo.model.UNet: an encoder and decoder with skip
    merges (the resize-conv decoder: nearest upsampling, then a 1x1
    convolution); the output is a per-pixel sigmoid map scored by binary
    cross-entropy (a ``LossLayer`` on [B, n_channels_out, H, W])."""

    def __init__(self, n_channels_out: int = 1, seed: int = 123,
                 input_shape: Tuple[int, int, int] = (3, 128, 128),
                 base_filters: int = 16, depth: int = 3):
        self.n_channels_out = n_channels_out
        self.seed = seed
        self.input_shape = input_shape
        self.base = base_filters
        self.depth = depth

    def _net_class(self):
        return ComputationGraph

    def _double_conv(self, g, name, inp, n_out):
        g.add_layer(f"{name}_c1", ConvolutionLayer(
            n_out=n_out, kernel_size=(3, 3), convolution_mode="same",
            activation="relu"), inp)
        g.add_layer(f"{name}_c2", ConvolutionLayer(
            n_out=n_out, kernel_size=(3, 3), convolution_mode="same",
            activation="relu"), f"{name}_c1")
        return f"{name}_c2"

    def conf(self):
        c, h, w = self.input_shape
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).graph_builder())
        g.add_inputs("input")
        skips = []
        cur = "input"
        f = self.base
        for d in range(self.depth):
            cur = self._double_conv(g, f"enc{d}", cur, f * (2 ** d))
            skips.append(cur)
            g.add_layer(f"down{d}", SubsamplingLayer(kernel_size=(2, 2),
                                                     stride=(2, 2)), cur)
            cur = f"down{d}"
        cur = self._double_conv(g, "bottom", cur, f * (2 ** self.depth))
        for d in reversed(range(self.depth)):
            g.add_layer(f"up{d}_us", Upsampling2D(size=(2, 2)), cur)
            g.add_layer(f"up{d}", ConvolutionLayer(
                n_out=f * (2 ** d), kernel_size=(1, 1), activation="relu"),
                f"up{d}_us")
            g.add_vertex(f"cat{d}", MergeVertex(), f"up{d}", skips[d])
            cur = self._double_conv(g, f"dec{d}", f"cat{d}", f * (2 ** d))
        g.add_layer("head", ConvolutionLayer(
            n_out=self.n_channels_out, kernel_size=(1, 1),
            activation="sigmoid"), cur)
        g.add_layer("output", LossLayer(loss="xent", activation="identity"), "head")
        g.set_outputs("output")
        g.set_input_types(InputType.convolutional(h, w, c))
        return g.build()


class Xception(ZooModel):
    """org.deeplearning4j.zoo.model.Xception: depthwise-separable stacks
    with residual shortcuts (entry, ``middle_blocks`` middle blocks, exit),
    each separable convolution followed by BatchNormalization."""

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape: Tuple[int, int, int] = (3, 299, 299),
                 middle_blocks: int = 4):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = input_shape
        self.middle_blocks = middle_blocks

    def _net_class(self):
        return ComputationGraph

    def _sep_bn(self, g, name, inp, n_out):
        g.add_layer(f"{name}_sep", SeparableConvolution2D(
            n_out=n_out, kernel_size=(3, 3), convolution_mode="same",
            activation="identity", has_bias=False), inp)
        g.add_layer(name, BatchNormalization(), f"{name}_sep")
        return name

    def conf(self):
        c, h, w = self.input_shape
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).graph_builder())
        g.add_inputs("input")
        g.add_layer("stem1", ConvolutionLayer(n_out=32, kernel_size=(3, 3),
                                              stride=(2, 2), activation="relu",
                                              convolution_mode="same"), "input")
        g.add_layer("stem2", ConvolutionLayer(n_out=64, kernel_size=(3, 3),
                                              activation="relu",
                                              convolution_mode="same"), "stem1")
        # entry flow residual block
        s1 = self._sep_bn(g, "e1a", "stem2", 128)
        g.add_layer("e1a_act", ActivationLayer(activation="relu"), s1)
        s2 = self._sep_bn(g, "e1b", "e1a_act", 128)
        g.add_layer("e1_pool", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                                convolution_mode="same"), s2)
        g.add_layer("e1_res", ConvolutionLayer(n_out=128, kernel_size=(1, 1),
                                               stride=(2, 2),
                                               activation="identity"), "stem2")
        g.add_vertex("e1", ElementWiseVertex(op="add"), "e1_pool", "e1_res")
        cur = "e1"
        # middle flow: residual separable pairs
        for m in range(self.middle_blocks):
            g.add_layer(f"m{m}_act0", ActivationLayer(activation="relu"), cur)
            a = self._sep_bn(g, f"m{m}_a", f"m{m}_act0", 128)
            g.add_layer(f"m{m}_act1", ActivationLayer(activation="relu"), a)
            b = self._sep_bn(g, f"m{m}_b", f"m{m}_act1", 128)
            g.add_vertex(f"m{m}", ElementWiseVertex(op="add"), b, cur)
            cur = f"m{m}"
        # exit
        g.add_layer("exit_act", ActivationLayer(activation="relu"), cur)
        x = self._sep_bn(g, "exit_sep", "exit_act", 256)
        g.add_layer("exit_act2", ActivationLayer(activation="relu"), x)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), "exit_act2")
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation="softmax", loss="mcxent"),
                    "gap")
        g.set_outputs("output")
        g.set_input_types(InputType.convolutional(h, w, c))
        return g.build()
