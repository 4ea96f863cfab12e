"""Bridge between the JAX package's parameter (and updater-state) pytrees
and the port's modules.

The JAX transformer keeps its parameters as nested dicts and lists
(``params["blocks"][3]["qkv_w"]``); the port keeps the same arrays in an
``nn.Module`` whose ``state_dict`` key is the same path joined with dots
(``blocks.3.qkv_w``). Both store dense weights as [in, out] and compute
``x @ W``, so the bridge is a name table and no array is transposed.

A MultiLayerNetwork keeps the JAX package's per-layer dicts
(``params_["0"]["W"]``) as ``params_["0"]["W"]`` of its ``nn.ModuleDict``
(:func:`mln_params_from_jax`); its OIHW convolution and [in, out] dense
weights are the JAX package's layouts too. A ComputationGraph's per-node
dicts load the same way (:func:`cg_params_from_jax`).

The tree is given as numpy arrays (``jax.tree.map(np.asarray, params)``), so
this module needs nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from .transformer import QaHead, Transformer, TransformerConfig


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: widen exactly first
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True))


@torch.no_grad()
def _load(module: nn.Module, tree) -> None:
    flat = dict(_flatten(tree))
    params = dict(module.named_parameters())
    missing, extra = sorted(set(params) - set(flat)), sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, unexpected {extra}")
    for name, p in params.items():
        t = _to_tensor(flat[name])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(p.shape)}")
        p.copy_(t.to(p.dtype))


def params_from_jax(tree, cfg: TransformerConfig, *, device="cuda") -> Transformer:
    """The JAX ``init_params`` pytree (numpy leaves) as a :class:`Transformer`
    on ``device``, in ``cfg.param_dtype``."""
    model = Transformer(cfg, device=device)
    _load(model, tree)
    return model


def qa_params_from_jax(tree, cfg: TransformerConfig, *, device="cuda") -> QaHead:
    """The JAX ``init_qa_head`` dict ``{'w': [D,2], 'b': [2]}`` as a :class:`QaHead`."""
    head = QaHead(cfg, device=device)
    _load(head, tree)
    return head


def mln_params_from_jax(net, params_, bn_state=None, updater_state=None):
    """Load a JAX ``MultiLayerNetwork``'s ``params_`` (and, if given, its
    ``bn_state`` and updater state) as numpy trees into ``net``, a port
    network of the same configuration after ``init()``; returns ``net``."""
    _load(net.params_, params_)
    with torch.no_grad():
        for si, st in (bn_state or {}).items():
            for name in ("mean", "var"):
                buf = getattr(net.bn_state[si], name)
                buf.copy_(_to_tensor(st[name]).to(buf.dtype))
    if updater_state is not None:
        net.updater_state = updater_state_from_jax(updater_state, net.params_)
    return net


def cg_params_from_jax(net, params_, bn_state=None, updater_state=None):
    """Load a JAX ``ComputationGraph``'s ``params_`` (and, if given, its
    ``bn_state`` and updater state) as numpy trees into ``net``, a port
    graph of the same configuration after ``init()``; returns ``net``.
    The trees are keyed by node name, layers' and vertices' alike; the
    port's module keys escape them (``nn.graph.module_key``)."""
    from ..nn.graph import module_key

    def rekey(tree):
        return {module_key(name): sub for name, sub in tree.items()}

    _load(net.params_, rekey(params_))
    with torch.no_grad():
        for name, st in (bn_state or {}).items():
            for stat in ("mean", "var"):
                buf = getattr(net.bn_state[module_key(name)], stat)
                buf.copy_(_to_tensor(st[stat]).to(buf.dtype))
    if updater_state is not None:
        net.updater_state = updater_state_from_jax(
            {slot: rekey(tree) for slot, tree in updater_state.items()}, net.params_)
    return net


def params_to_numpy(module: nn.Module) -> Dict[str, Any]:
    """The module's parameters as the JAX pytree shape (nested dicts, a list
    for ``blocks``) of float32 numpy arrays on the host."""
    return _tree(module.named_parameters())


def updater_state_from_jax(state, module: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX updater state as the port's: ``{"m": tree, "v": tree}`` (numpy
    leaves, each tree shaped like the parameter pytree; ``{}`` for a
    stateless updater) becomes ``{"m": {name: tensor}, ...}`` keyed like
    ``module.named_parameters()``, each tensor on its parameter's device and
    in its dtype."""
    params = dict(module.named_parameters())
    out = {}
    for slot, tree in state.items():
        flat = dict(_flatten(tree))
        if set(flat) != set(params):
            raise KeyError(f"state {slot!r}: names differ from the parameters: missing "
                           f"{sorted(set(params) - set(flat))}, unexpected "
                           f"{sorted(set(flat) - set(params))}")
        out[slot] = {}
        for name, p in params.items():
            t = _to_tensor(flat[name])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"state {slot!r} {name}: shape {tuple(t.shape)} != "
                                 f"{tuple(p.shape)}")
            out[slot][name] = t.to(device=p.device, dtype=p.dtype)
    return out


def updater_state_to_numpy(state) -> Dict[str, Any]:
    """The port's updater state as the JAX state pytree of float32 numpy
    arrays (``{"m": tree, "v": tree}``)."""
    return {slot: _tree(tensors.items()) for slot, tensors in state.items()}


def _tree(named) -> Dict[str, Any]:
    """(dotted name, tensor) pairs as nested dicts, with a list wherever the
    keys are "0".."n-1" (a ModuleList), as in the JAX pytree."""
    tree: Dict[str, Any] = {}
    for name, t in named:
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return _as_lists(tree)


def _as_lists(node):
    """Dicts keyed "0".."n-1" (a ModuleList) become lists, as in the pytree."""
    if not isinstance(node, dict):
        return node
    out = {k: _as_lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out
