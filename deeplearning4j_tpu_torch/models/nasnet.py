"""NASNet-A (Mobile) at its published defaults.

Counterpart of ``deeplearning4j_tpu/models/nasnet.py`` (DL4J's
``org.deeplearning4j.zoo.model.NASNet``; Zoph et al. 2018), with the same
graph and node names: a 3x3/2 convolution stem with BatchNormalization,
three stacks of ``num_cells`` normal cells with a reduction cell before the
second and third (the filters doubling at each), ReLU, global average
pooling, softmax. Each cell has the NASNet-A wiring (five blocks of the
published pairwise operations, the previous-previous cell as a second
input). The JAX package's two compactions are kept: each separable
operation is ReLU → SeparableConvolution2D → BatchNormalization once, not
twice, and the previous cell's "adjust" is a strided 1x1 convolution with
BatchNormalization instead of the factorized reduction. At its defaults the
graph has 399 nodes.
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
    SeparableConvolution2D,
    SubsamplingLayer,
)
from ..nn.graph import ComputationGraph
from ..nn.graph_conf import ElementWiseVertex, MergeVertex
from ..nn.updaters import Adam
from .zoo import ZooModel


class NASNet(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape: Tuple[int, int, int] = (3, 224, 224),
                 penultimate_filters: int = 1056, num_cells: int = 4,
                 stem_filters: int = 32):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = input_shape
        # NASNet-A (N @ penultimate): filters per cell = penultimate / 24
        self.filters = penultimate_filters // 24
        self.num_cells = num_cells          # N normal cells per stack
        self.stem_filters = stem_filters

    def _net_class(self):
        return ComputationGraph

    # -- primitive ops ------------------------------------------------------

    def _sep(self, g, name, inp, n_out, kernel, stride=(1, 1)):
        """relu → separable conv → BN (applied once; see the module doc)."""
        g.add_layer(f"{name}_r", ActivationLayer(activation="relu"), inp)
        g.add_layer(f"{name}_s", SeparableConvolution2D(
            n_out=n_out, kernel_size=kernel, stride=stride,
            convolution_mode="same", activation="identity", has_bias=False),
            f"{name}_r")
        g.add_layer(f"{name}_bn", BatchNormalization(eps=1e-3), f"{name}_s")
        return f"{name}_bn"

    def _pool(self, g, name, inp, kind, stride=(1, 1)):
        g.add_layer(name, SubsamplingLayer(
            pooling_type=kind, kernel_size=(3, 3), stride=stride,
            convolution_mode="same"), inp)
        return name

    def _fit(self, g, name, inp, n_out, stride=(1, 1)):
        """1×1 conv+BN 'adjust': channel squeeze and/or spatial match."""
        g.add_layer(f"{name}_c", ConvolutionLayer(
            n_out=n_out, kernel_size=(1, 1), stride=stride,
            convolution_mode="same", activation="identity", has_bias=False), inp)
        g.add_layer(f"{name}_bn", BatchNormalization(eps=1e-3), f"{name}_c")
        return f"{name}_bn"

    def _add(self, g, name, a, b):
        g.add_vertex(name, ElementWiseVertex(op="add"), a, b)
        return name

    # -- cells --------------------------------------------------------------

    def _normal_cell(self, g, name, h, h_prev, filters, hp_stride=(1, 1)):
        """``hp_stride=(2,2)`` right after a reduction cell: h_prev is the
        pre-reduction tensor, one spatial level up (the role factorized
        reduction plays in the reference)."""
        h = self._fit(g, f"{name}_hs", h, filters)
        hp = self._fit(g, f"{name}_ps", h_prev, filters, stride=hp_stride)
        b1 = self._add(g, f"{name}_b1",
                       self._sep(g, f"{name}_b1a", h, filters, (3, 3)), h)
        b2 = self._add(g, f"{name}_b2",
                       self._sep(g, f"{name}_b2a", hp, filters, (3, 3)),
                       self._sep(g, f"{name}_b2b", h, filters, (5, 5)))
        b3 = self._add(g, f"{name}_b3",
                       self._pool(g, f"{name}_b3a", h, "avg"), hp)
        b4 = self._add(g, f"{name}_b4",
                       self._pool(g, f"{name}_b4a", hp, "avg"),
                       self._pool(g, f"{name}_b4b", hp, "avg"))
        b5 = self._add(g, f"{name}_b5",
                       self._sep(g, f"{name}_b5a", hp, filters, (5, 5)),
                       self._sep(g, f"{name}_b5b", hp, filters, (3, 3)))
        g.add_vertex(f"{name}_out", MergeVertex(), b1, b2, b3, b4, b5)
        return f"{name}_out"

    def _reduction_cell(self, g, name, h, h_prev, filters):
        h = self._fit(g, f"{name}_hs", h, filters)
        hp = self._fit(g, f"{name}_ps", h_prev, filters)
        s2 = (2, 2)
        b1 = self._add(g, f"{name}_b1",
                       self._sep(g, f"{name}_b1a", h, filters, (5, 5), s2),
                       self._sep(g, f"{name}_b1b", hp, filters, (7, 7), s2))
        b2 = self._add(g, f"{name}_b2",
                       self._pool(g, f"{name}_b2a", h, "max", s2),
                       self._sep(g, f"{name}_b2b", hp, filters, (7, 7), s2))
        b3 = self._add(g, f"{name}_b3",
                       self._pool(g, f"{name}_b3a", h, "avg", s2),
                       self._sep(g, f"{name}_b3b", hp, filters, (5, 5), s2))
        b4 = self._add(g, f"{name}_b4",
                       self._pool(g, f"{name}_b4a", h, "max", s2),
                       self._sep(g, f"{name}_b4b", b1, filters, (3, 3)))
        b5 = self._add(g, f"{name}_b5",
                       self._pool(g, f"{name}_b5a", b1, "avg"), b2)
        g.add_vertex(f"{name}_out", MergeVertex(), b2, b3, b4, b5)
        return f"{name}_out"

    # -- full graph ---------------------------------------------------------

    def conf(self):
        c, h, w = self.input_shape
        g = (
            NeuralNetConfiguration.Builder()
            .seed(self.seed)
            .updater(Adam(1e-3))
            .weight_init("relu")
            .graph_builder()
            .add_inputs("input")
            .set_input_types(InputType.convolutional(h, w, c))
        )
        g.add_layer("stem_c", ConvolutionLayer(
            n_out=self.stem_filters, kernel_size=(3, 3), stride=(2, 2),
            convolution_mode="same", activation="identity", has_bias=False),
            "input")
        g.add_layer("stem_bn", BatchNormalization(eps=1e-3), "stem_c")
        prev, cur = "stem_bn", "stem_bn"
        for stack in range(3):
            filters_stack = self.filters * (2 ** stack)
            if stack > 0:
                # the reduction runs at the NEW stack's (doubled) width
                cur2 = self._reduction_cell(g, f"red{stack}", cur, prev, filters_stack)
                prev, cur = cur, cur2
            for i in range(self.num_cells):
                hp_stride = (2, 2) if (stack > 0 and i == 0) else (1, 1)
                nxt = self._normal_cell(g, f"s{stack}c{i}", cur, prev, filters_stack,
                                        hp_stride=hp_stride)
                prev, cur = cur, nxt
        g.add_layer("head_relu", ActivationLayer(activation="relu"), cur)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), "head_relu")
        g.add_layer("output", OutputLayer(
            n_out=self.num_classes, activation="softmax",
            loss="negativeloglikelihood"), "avgpool")
        g.set_outputs("output")
        return g.build()
