"""Transfer learning.

Counterpart of the JAX package's ``nn/transfer.py`` (DL4J's
``org.deeplearning4j.nn.transferlearning``): ``TransferLearning.Builder``
(fineTuneConfiguration / setFeatureExtractor / removeOutputLayer /
nOutReplace / addLayer), ``FineTuneConfiguration`` and
``TransferLearningHelper`` (featurize once, train the head). Freezing is
the train step's: the gradients of layers marked ``frozen`` are zeroed
(``nn.multilayer._mask_frozen``) before the updater runs, so under Adam a
frozen layer comes out of every step bit for bit unchanged.

The builder snapshots the source network's parameters and BN statistics
(tensor copies), so fine-tuning the new network never moves the source.
The new network lives on the source's device; retained layers take the
source's weights where the shapes match, replaced layers (and the layer
after each) and appended layers keep the port's own initialisation, which
draws from the port's generator and not JAX's.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional

import torch

from .conf import Layer
from .multilayer import MultiLayerNetwork
from .updaters import IUpdater


@dataclasses.dataclass
class FineTuneConfiguration:
    """org.deeplearning4j.nn.transferlearning.FineTuneConfiguration. Its
    dropout, L1 and L2 apply to every layer of the new network, frozen ones
    included, as in the JAX package."""

    updater: Optional[IUpdater] = None
    seed: Optional[int] = None
    dropout: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None

    class Builder:
        def __init__(self):
            self._kw = {}

        def updater(self, u):
            self._kw["updater"] = u
            return self

        def seed(self, s):
            self._kw["seed"] = s
            return self

        def dropout(self, d):
            self._kw["dropout"] = d
            return self

        def l1(self, v):
            self._kw["l1"] = v
            return self

        def l2(self, v):
            self._kw["l2"] = v
            return self

        def build(self):
            return FineTuneConfiguration(**self._kw)


class TransferLearning:
    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            self._net = net
            self._conf = copy.deepcopy(net.conf)
            with torch.no_grad():
                self._params = {k: {n: p.detach().clone() for n, p in pd.items()}
                                for k, pd in net.params_.items()}
                self._bn = {k: {"mean": st.mean.clone(), "var": st.var.clone()}
                            for k, st in net.bn_state.items()}
            self._freeze_until: Optional[int] = None
            self._ftc: Optional[FineTuneConfiguration] = None
            self._replaced: dict = {}
            self._appended: List[Layer] = []
            self._removed_tail = 0

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        fineTuneConfiguration = fine_tune_configuration

        def set_feature_extractor(self, layer_index: int):
            """Freeze layers [0..layer_index] (setFeatureExtractor)."""
            self._freeze_until = layer_index
            return self

        setFeatureExtractor = set_feature_extractor

        def remove_output_layer(self):
            self._removed_tail += 1
            return self

        removeOutputLayer = remove_output_layer

        def remove_layers_from_output(self, n: int):
            self._removed_tail += n
            return self

        removeLayersFromOutput = remove_layers_from_output

        def n_out_replace(self, layer_index: int, n_out: int, weight_init: str = "xavier"):
            """Replace layer's nOut (re-initializes that layer + the next
            layer's nIn-dependent params)."""
            self._replaced[layer_index] = (n_out, weight_init)
            return self

        nOutReplace = n_out_replace

        def add_layer(self, layer: Layer):
            self._appended.append(layer)
            return self

        addLayer = add_layer

        def build(self) -> MultiLayerNetwork:
            conf = self._conf
            n_original = len(conf.layers)
            if self._removed_tail:
                conf.layers = conf.layers[: -self._removed_tail]
            n_retained = n_original - self._removed_tail
            for idx, (n_out, wi) in self._replaced.items():
                layer = conf.layers[idx]
                layer.n_out = n_out
                layer.weight_init = wi
                # downstream layer's explicit nIn must follow (DL4J
                # nOutReplace updates the next layer too)
                if idx + 1 < len(conf.layers) and getattr(conf.layers[idx + 1], "n_in", 0):
                    conf.layers[idx + 1].n_in = n_out
            conf.layers.extend(self._appended)
            if self._ftc:
                if self._ftc.updater is not None:
                    conf.updater = self._ftc.updater
                if self._ftc.seed is not None:
                    conf.seed = self._ftc.seed
                for l in conf.layers:
                    if self._ftc.dropout is not None:
                        l.dropout = self._ftc.dropout
                    if self._ftc.l1 is not None:
                        l.l1 = self._ftc.l1
                    if self._ftc.l2 is not None:
                        l.l2 = self._ftc.l2
            if self._freeze_until is not None:
                for i, l in enumerate(conf.layers):
                    if i <= self._freeze_until:
                        l.frozen = True
            new = MultiLayerNetwork(conf, device=self._net.device)
            new.init()
            # copy weights for retained, un-replaced layers (shape-matched).
            # Indices >= n_retained belonged to REMOVED layers — never copy
            # them onto appended layers that happen to share an index/shape.
            # A replaced layer invalidates the NEXT layer's nIn too.
            invalid = set(self._replaced) | {i + 1 for i in self._replaced}
            with torch.no_grad():
                for key, lp in self._params.items():
                    i = int(key)
                    if i >= n_retained or i in invalid or key not in new.params_:
                        continue
                    tgt = new.params_[key]
                    if len(tgt) and all(k in tgt and tgt[k].shape == v.shape
                                        for k, v in lp.items()):
                        for k, v in lp.items():
                            tgt[k].copy_(v)
                for key, st in self._bn.items():
                    if int(key) < n_retained and key in new.bn_state and all(
                            getattr(new.bn_state[key], k).shape == v.shape
                            for k, v in st.items()):
                        for k, v in st.items():
                            getattr(new.bn_state[key], k).copy_(v)
            return new


class TransferLearningHelper:
    """Featurize-once helper: run frozen layers ONCE over a dataset, then
    train only the unfrozen head on the cached features
    (org.deeplearning4j.nn.transferlearning.TransferLearningHelper)."""

    def __init__(self, net: MultiLayerNetwork, frozen_until: int):
        self.net = net
        self.frozen_until = frozen_until

    @torch.no_grad()
    def featurize(self, ds):
        """The frozen layers' output for ``ds``, computed on the network's
        device and returned as a host ``DataSet`` (as the JAX package's)."""
        from ..data.dataset import DataSet

        net = self.net
        params, bn = net._whole_params("featurize()"), net._bn()
        h = net._put(ds.features, net._dtype)
        for i, layer in enumerate(net.conf.layers[: self.frozen_until + 1]):
            h = net._apply_layer(i, layer, params, dict(bn), h, net._input_types[i], False,
                                 None, None, None, {})
        return DataSet(h.cpu().numpy(), ds.labels, ds.features_mask, ds.labels_mask)

    def unfrozen_mln(self) -> MultiLayerNetwork:
        """Head-only network over the featurized inputs, on the network's
        device, with copies of the head's parameters."""
        conf = copy.deepcopy(self.net.conf)
        conf.layers = conf.layers[self.frozen_until + 1:]
        conf.input_type = self.net.conf.layers[self.frozen_until].output_type(
            self.net._input_types[self.frozen_until])
        # re-key head-region preprocessors to the head's layer indices
        conf.preprocessors = {
            i - self.frozen_until - 1: p
            for i, p in self.net.conf.preprocessors.items()
            if i > self.frozen_until
        }
        head = MultiLayerNetwork(conf, device=self.net.device)
        head.init()
        with torch.no_grad():
            for key, lp in self.net.params_.items():
                i = int(key)
                if i > self.frozen_until:
                    for k, v in lp.items():
                        head.params_[str(i - self.frozen_until - 1)][k].copy_(v)
        return head
