"""MultiLayerSpace — network-config search space.

Counterpart of the JAX package's ``arbiter/spaces.py`` (DL4J's
``org.deeplearning4j.arbiter.MultiLayerSpace`` and ``layers.DenseLayerSpace``
etc.): the NeuralNetConfiguration builders with ParameterSpaces at every
hyperparameter, materializing a concrete port ``MultiLayerConfiguration``
per candidate. A candidate gives the same configuration JSON as the JAX
package's space gives for it.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..nn.conf import Layer, MultiLayerConfiguration
from ..nn.updaters import Adam
from .optimize import ParameterSpace


class LayerSpace:
    """A layer config whose fields may be ParameterSpaces. ``param_spaces``
    collects them under 'layer{i}.{field}' names."""

    def __init__(self, layer_cls, **fields):
        self.layer_cls = layer_cls
        self.fields = fields

    def spaces(self, idx: int) -> Dict[str, ParameterSpace]:
        return {f"layer{idx}.{k}": v for k, v in self.fields.items()
                if isinstance(v, ParameterSpace)}

    def materialize(self, idx: int, candidate: Dict[str, Any]) -> Layer:
        kw = {}
        for k, v in self.fields.items():
            kw[k] = candidate[f"layer{idx}.{k}"] if isinstance(v, ParameterSpace) else v
        return self.layer_cls(**kw)


class MultiLayerSpace:
    class Builder:
        def __init__(self):
            self._layers: List[LayerSpace] = []
            self._lr: Any = 0.01
            self._updater_cls = Adam
            self._seed = 42
            self._input_type = None

        def seed(self, s: int):
            self._seed = s
            return self

        def learning_rate(self, lr):
            self._lr = lr
            return self

        learningRate = learning_rate

        def updater_class(self, cls):
            self._updater_cls = cls
            return self

        def add_layer(self, space: LayerSpace):
            self._layers.append(space)
            return self

        addLayer = add_layer

        def set_input_type(self, it):
            self._input_type = it
            return self

        setInputType = set_input_type

        def build(self) -> "MultiLayerSpace":
            return MultiLayerSpace(self._layers, self._lr, self._updater_cls,
                                   self._seed, self._input_type)

    def __init__(self, layers, lr, updater_cls, seed, input_type):
        self.layers = layers
        self.lr = lr
        self.updater_cls = updater_cls
        self.seed = seed
        self.input_type = input_type

    def param_spaces(self) -> Dict[str, ParameterSpace]:
        spaces: Dict[str, ParameterSpace] = {}
        if isinstance(self.lr, ParameterSpace):
            spaces["learning_rate"] = self.lr
        for i, ls in enumerate(self.layers):
            spaces.update(ls.spaces(i))
        return spaces

    def materialize(self, candidate: Dict[str, Any]) -> MultiLayerConfiguration:
        lr = candidate.get("learning_rate", self.lr)
        if isinstance(lr, ParameterSpace):
            lr = 0.01
        layers = [ls.materialize(i, candidate) for i, ls in enumerate(self.layers)]
        return MultiLayerConfiguration(
            layers=layers,
            input_type=self.input_type,
            seed=self.seed,
            updater=self.updater_cls(lr),
        )
