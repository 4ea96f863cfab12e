"""ComputationGraph configuration: GraphBuilder and the graph vertices.

Counterpart of ``deeplearning4j_tpu/nn/graph_conf.py`` (DL4J's
``ComputationGraphConfiguration`` with its ``GraphBuilder``, and the
``conf.graph.*`` vertices). A vertex is a function of its input
activations; ``nn.attention_layers.AttentionVertex`` adds the one vertex
with parameters. A configuration's JSON is the JAX package's, field for
field.

One difference: ``PreprocessorVertex`` writes its preprocessor as a nested
``@class`` dict and ``VERTEX_REGISTRY`` holds it (and ``AttentionVertex``),
so every graph reads back from its own JSON. The JAX package's
``VERTEX_REGISTRY`` lists neither, and its ``from_json`` raises ``KeyError``
on a graph that holds one.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from .conf import InputPreProcessor, InputType, Layer, PREPROCESSOR_REGISTRY, infer_preprocessor


@dataclass
class GraphVertex:
    """Base vertex (org.deeplearning4j.nn.conf.graph.GraphVertex)."""

    def apply(self, inputs: List[torch.Tensor]):
        raise NotImplementedError

    def output_type(self, input_types: List[InputType]) -> InputType:
        return input_types[0]

    def to_json(self):
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d


@dataclass
class MergeVertex(GraphVertex):
    """Concat along the feature axis (axis 1 for FF/CNN-channels/RNN-size)."""

    def apply(self, inputs):
        return torch.cat(inputs, dim=1)

    def output_type(self, its):
        first = its[0]
        if first.kind == "ff":
            return InputType.feed_forward(sum(t.size for t in its))
        if first.kind == "rnn":
            return InputType.recurrent(sum(t.size for t in its), first.timeseries_length)
        return InputType.convolutional(first.height, first.width, sum(t.channels for t in its))


@dataclass
class ElementWiseVertex(GraphVertex):
    op: str = "add"  # add | subtract | product | average | max

    def apply(self, inputs):
        if self.op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if self.op == "subtract":
            return inputs[0] - inputs[1]
        if self.op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if self.op == "average":
            return sum(inputs) / len(inputs)
        if self.op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(self.op)


@dataclass
class SubsetVertex(GraphVertex):
    frm: int = 0
    to: int = 0  # inclusive, per DL4J SubsetVertex

    def apply(self, inputs):
        return inputs[0][:, self.frm:self.to + 1]

    def output_type(self, its):
        n = self.to - self.frm + 1
        it = its[0]
        if it.kind == "rnn":
            return InputType.recurrent(n, it.timeseries_length)
        return InputType.feed_forward(n)


@dataclass
class StackVertex(GraphVertex):
    """Stack along dim 0 (minibatch concat)."""

    def apply(self, inputs):
        return torch.cat(inputs, dim=0)


@dataclass
class UnstackVertex(GraphVertex):
    from_index: int = 0
    stack_size: int = 1

    def apply(self, inputs):
        x = inputs[0]
        n = x.shape[0] // self.stack_size
        return x[self.from_index * n:(self.from_index + 1) * n]


@dataclass
class L2NormalizeVertex(GraphVertex):
    eps: float = 1e-8

    def apply(self, inputs):
        x = inputs[0]
        axes = tuple(range(1, x.dim()))
        return x / (torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True)) + self.eps)


@dataclass
class ScaleVertex(GraphVertex):
    scale: float = 1.0

    def apply(self, inputs):
        return inputs[0] * self.scale


@dataclass
class ShiftVertex(GraphVertex):
    shift: float = 0.0

    def apply(self, inputs):
        return inputs[0] + self.shift


@dataclass
class ReshapeVertex(GraphVertex):
    shape: Tuple[int, ...] = ()

    def apply(self, inputs):
        return inputs[0].reshape((inputs[0].shape[0],) + tuple(self.shape))


def _preprocessor_json(pre: InputPreProcessor) -> dict:
    return {"@class": type(pre).__name__, **dataclasses.asdict(pre)}


def _preprocessor_from_json(d: dict) -> InputPreProcessor:
    d = dict(d)
    return PREPROCESSOR_REGISTRY[d.pop("@class")](**d)


@dataclass
class PreprocessorVertex(GraphVertex):
    pre: Optional[InputPreProcessor] = None

    def apply(self, inputs):
        return self.pre.pre_process(inputs[0], None)

    def output_type(self, its):
        return self.pre.output_type(its[0])

    def to_json(self):
        return {"pre": None if self.pre is None else _preprocessor_json(self.pre),
                "@class": type(self).__name__}


@dataclass
class FlattenVertex(GraphVertex):
    """[B, ...] → [B, prod(...)] (used by Keras-import Flatten nodes; the
    framework's own stacks flatten via CnnToFeedForward preprocessors)."""

    def apply(self, inputs):
        x = inputs[0]
        return x.reshape(x.shape[0], -1)

    def output_type(self, its):
        return InputType.feed_forward(its[0].flat_size())


# ``nn.attention_layers`` adds AttentionVertex when the package is imported
VERTEX_REGISTRY = {
    c.__name__: c
    for c in (
        MergeVertex,
        ElementWiseVertex,
        SubsetVertex,
        StackVertex,
        UnstackVertex,
        L2NormalizeVertex,
        ScaleVertex,
        ShiftVertex,
        ReshapeVertex,
        PreprocessorVertex,
        FlattenVertex,
    )
}


def _vertex_from_json(d: dict) -> GraphVertex:
    d = dict(d)
    cls = VERTEX_REGISTRY[d.pop("@class")]
    if cls is PreprocessorVertex and d.get("pre") is not None:
        d["pre"] = _preprocessor_from_json(d["pre"])
    return cls(**d)


@dataclass
class GraphNode:
    name: str
    inputs: List[str]
    layer: Optional[Layer] = None
    vertex: Optional[GraphVertex] = None
    preprocessor: Optional[InputPreProcessor] = None


@dataclass
class ComputationGraphConfiguration:
    """Topology: named inputs → DAG of layer/vertex nodes → named outputs."""

    network_inputs: List[str] = field(default_factory=list)
    nodes: Dict[str, GraphNode] = field(default_factory=dict)
    network_outputs: List[str] = field(default_factory=list)
    input_types: Dict[str, InputType] = field(default_factory=dict)
    seed: int = 0
    updater: Optional[object] = None
    dtype: str = "float32"
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0

    def topo_order(self) -> List[str]:
        """Topological sort (ComputationGraph GraphIndices cache): a depth-first
        walk over ``nodes`` in insertion order, each node after its inputs."""
        order, seen = [], set()
        temp = set()

        def visit(n):
            if n in seen or n in self.network_inputs:
                return
            if n in temp:
                raise ValueError(f"cycle at {n}")
            temp.add(n)
            for dep in self.nodes[n].inputs:
                visit(dep)
            temp.discard(n)
            seen.add(n)
            order.append(n)

        for name in self.nodes:
            visit(name)
        return order

    def infer_types(self) -> Dict[str, InputType]:
        """Per-node OUTPUT InputType, walking topo order."""
        types: Dict[str, InputType] = dict(self.input_types)
        for name in self.topo_order():
            node = self.nodes[name]
            in_types = [types[i] for i in node.inputs]
            it = in_types[0] if in_types else None
            if node.preprocessor is not None:
                it = node.preprocessor.output_type(it)
                in_types = [it] + in_types[1:]
            if node.layer is not None:
                types[name] = node.layer.output_type(in_types[0])
            else:
                types[name] = node.vertex.output_type(in_types)
        return types

    def to_json(self) -> str:
        d = {
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "seed": self.seed,
            "dtype": self.dtype,
            "updater": self.updater.to_json() if self.updater else None,
            "input_types": {k: v.to_json() for k, v in self.input_types.items()},
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold": self.gradient_normalization_threshold,
            "nodes": [
                {
                    "name": n.name,
                    "inputs": n.inputs,
                    "layer": n.layer.to_json() if n.layer else None,
                    "vertex": n.vertex.to_json() if n.vertex else None,
                    "preprocessor": _preprocessor_json(n.preprocessor) if n.preprocessor else None,
                }
                for n in self.nodes.values()
            ],
        }
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        from .updaters import IUpdater

        d = json.loads(s)
        conf = ComputationGraphConfiguration(
            network_inputs=d["network_inputs"],
            network_outputs=d["network_outputs"],
            seed=d.get("seed", 0),
            dtype=d.get("dtype", "float32"),
            updater=IUpdater.from_json(d["updater"]) if d.get("updater") else None,
            input_types={k: InputType(**v) for k, v in d.get("input_types", {}).items()},
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get("gradient_normalization_threshold", 1.0),
        )
        for nd in d["nodes"]:
            layer = Layer.from_json(nd["layer"]) if nd.get("layer") else None
            vertex = _vertex_from_json(nd["vertex"]) if nd.get("vertex") else None
            pre = _preprocessor_from_json(nd["preprocessor"]) if nd.get("preprocessor") else None
            conf.nodes[nd["name"]] = GraphNode(nd["name"], nd["inputs"], layer, vertex, pre)
        return conf


class GraphBuilder:
    """NeuralNetConfiguration...graphBuilder() fluent API."""

    def __init__(self, base):
        self._base = base
        self._conf = ComputationGraphConfiguration(seed=base.seed_, updater=base.updater_,
                                                   dtype=base.dtype_)
        self._conf.gradient_normalization = base.grad_norm_
        self._conf.gradient_normalization_threshold = base.grad_norm_threshold_

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_inputs.extend(names)
        return self

    addInputs = add_inputs

    def set_input_types(self, *its: InputType) -> "GraphBuilder":
        for name, it in zip(self._conf.network_inputs, its):
            self._conf.input_types[name] = it
        return self

    setInputTypes = set_input_types

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "GraphBuilder":
        """Cascades the builder's updater, weight init, l1 and l2 into the
        layer (not its dropout or activation, unlike ``ListBuilder``)."""
        b = self._base
        if layer.updater is None:
            layer.updater = b.updater_
        if layer.weight_init == "xavier" and b.weight_init_ != "xavier":
            layer.weight_init = b.weight_init_
        if layer.l1 == 0.0:
            layer.l1 = b.l1_
        if layer.l2 == 0.0:
            layer.l2 = b.l2_
        layer.name = name
        self._conf.nodes[name] = GraphNode(name, list(inputs), layer=layer)
        return self

    addLayer = add_layer

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str) -> "GraphBuilder":
        self._conf.nodes[name] = GraphNode(name, list(inputs), vertex=vertex)
        return self

    addVertex = add_vertex

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_outputs = list(names)
        return self

    setOutputs = set_outputs

    def build(self) -> ComputationGraphConfiguration:
        """The configuration, with a preprocessor inferred for each layer
        node whose first input's type the layer does not take."""
        if self._conf.input_types:
            types = dict(self._conf.input_types)
            for name in self._conf.topo_order():
                node = self._conf.nodes[name]
                in_types = [types[i] for i in node.inputs]
                if node.layer is not None and node.preprocessor is None and in_types:
                    pre = infer_preprocessor(in_types[0], node.layer)
                    if pre is not None:
                        node.preprocessor = pre
                if node.preprocessor is not None:
                    in_types = [node.preprocessor.output_type(in_types[0])] + in_types[1:]
                types[name] = (node.layer.output_type(in_types[0]) if node.layer
                               else node.vertex.output_type(in_types))
        return self._conf
