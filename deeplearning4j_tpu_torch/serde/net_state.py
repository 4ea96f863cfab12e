"""A port network's state as the JAX package's state trees, and back.

The checkpoint format (``serde.checkpoint``, ``serde.model_serializer``) is
the JAX package's: three trees of arrays, ``params`` (``{layer: {name:
array}}``), ``updater`` (``{slot: params-shaped tree}``, ``{}`` for a
stateless updater) and ``bn`` (``{layer: {"mean", "var"}}``), flattened to
paths such as ``params/0/W`` and ``updater/m/0/W``. A MultiLayerNetwork's
layer key is its index, with gaps where a layer has no parameters; a
ComputationGraph's is the node name (its ``nn.ModuleDict`` key unescaped,
``nn.graph.module_key``). Both kinds keep the port's layout otherwise: an
``nn.ParameterDict`` per layer, BN statistics as buffers and the updater
state keyed ``"<module key>.<name>"`` — so one pair of functions,
:func:`snapshot` and :func:`load`, serves both, each kind by its map from
module keys to layer keys (:func:`_layer_names`).

Arrays keep their dtype. numpy has no bfloat16, so a bfloat16 tensor
becomes its two raw bytes per element (dtype ``|V2``, the bytes and the
dtype that ``np.savez`` writes for the JAX package's bfloat16 arrays) and a
``|V2`` array is read back into a bfloat16 tensor by reinterpreting the
bytes; nothing is converted by value.

This module is not the weight bridge (``models.weights``): that one casts
to float32 and makes lists of ModuleLists, which a checkpoint must not.
"""

from __future__ import annotations

from typing import Dict
from urllib.parse import unquote

import numpy as np
import torch

from .checkpoint import _leaf_paths

#: numpy's dtype for the raw bytes of a bfloat16 array
BF16_BYTES = np.dtype("V2")


def _layer_names(net) -> Dict[str, str]:
    """{module key: layer key in the state trees} of ``net``: the layer
    index for a MultiLayerNetwork, the node name for a ComputationGraph."""
    keys = getattr(net, "_keys", None)
    if keys is None:
        return {k: k for k in list(net.params_) + list(net.bn_state)}
    return {key: name for name, key in keys.items()}


def _tree(net) -> Dict[str, dict]:
    """The net's tensors as the JAX package's three trees."""
    names = _layer_names(net)
    tree: Dict[str, dict] = {"params": {}, "updater": {}, "bn": {}}
    for key, pd in net.params_.items():
        tree["params"][names[key]] = dict(pd.items())
    for slot, tensors in net.updater_state.items():
        node = tree["updater"].setdefault(slot, {})
        for flat, t in tensors.items():
            key, pname = flat.rsplit(".", 1)
            node.setdefault(names.get(key, unquote(key)), {})[pname] = t
    for key, st in net.bn_state.items():
        tree["bn"][names[key]] = {"mean": st.mean, "var": st.var}
    return tree


def _targets(net) -> Dict[str, torch.Tensor]:
    """{path: tensor} of every array of the net's state."""
    return dict(_leaf_paths(_tree(net)))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, bfloat16 as its raw bytes (``|V2``)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BYTES)
    return t.numpy()


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a host tensor; ``|V2`` is read as bfloat16 bytes. A
    0-d array stays 0-d (``np.ascontiguousarray`` makes it [1])."""
    a = np.ascontiguousarray(a).reshape(np.shape(a))
    if a.dtype == BF16_BYTES:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def snapshot(net) -> Dict[str, np.ndarray]:
    """{path: host array} of the net's parameters, updater state and BN
    statistics, copied off the card before this returns: the copies go
    into pinned host memory and the card is synchronised, so the caller
    (and a writer thread) may keep them while training goes on."""
    tensors = _targets(net)
    host = {}
    for path, t in tensors.items():
        if t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t.detach(), non_blocking=True)
        else:
            h = t.detach().clone()
        host[path] = h
    if any(t.is_cuda for t in tensors.values()):
        torch.cuda.synchronize(net.device)
    return {path: to_numpy(h) for path, h in host.items()}


@torch.no_grad()
def load(net, arrays: Dict[str, np.ndarray], source: str = "checkpoint",
         tops=("params", "updater", "bn")) -> None:
    """Copy ``arrays`` ({path: array}) into the net's tensors in place.

    Every array is matched to its tensor and checked (shape, dtype) before
    the first copy, so a failure leaves the net as it was. The parameters
    must match the net's one for one; the updater state and the BN
    statistics too where ``arrays`` has any (a checkpoint of a stateless
    updater leaves the net's updater state as it is, as in the JAX
    package). Only the ``tops`` trees are read."""
    targets = _targets(net)
    plan = []
    for top in tops:
        want = {p for p in targets if p.split("/", 1)[0] == top}
        have = {p for p in arrays if p.split("/", 1)[0] == top}
        if top == "params" or have:
            missing, extra = sorted(want - have), sorted(have - want)
            if missing or extra:
                raise ValueError(
                    f"{source} does not match the network's {top}: missing "
                    f"{missing[:8]}, not declared by the network {extra[:8]} — "
                    "model drift between save and restore")
        for path in sorted(have):
            src, dst = from_numpy(arrays[path]), targets[path]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{source}: {path!r} was saved as {tuple(src.shape)} but "
                                 f"the network declares {tuple(dst.shape)}")
            if src.dtype != dst.dtype:
                raise ValueError(f"{source}: {path!r} was saved as {src.dtype} but the "
                                 f"network holds {dst.dtype}; a checkpoint is restored "
                                 "into a network of its own dtype, never converted")
            plan.append((dst, src))
    for dst, src in plan:
        dst.copy_(src)
