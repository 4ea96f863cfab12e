"""Compiled-artifact export: a ``torch.export`` program + weights zip.

Counterpart of ``deeplearning4j_tpu/serde/compiled.py`` (the deployment half
of DL4J's graph executor: run a stored graph without the framework's model
classes). A model exported here reloads and runs with ``torch``, numpy and
the port's operator registrations (``kernels.attention``, whose flash
kernels are the ``tdl::flash_fwd``/``tdl::flash_bwd_*`` operators) only: no
configuration class and no layer code.

Artifact layout (zip), the JAX package's with ``model.pt2`` in place of its
``model.stablehlo``:

- ``model.pt2``     — ``torch.export.save`` of the program. Its ``forward``
  takes the weight tree as an INPUT, ``forward(weights, *runtime_args)``, as
  the JAX ``fn(weights, *runtime_args)`` does: the weights live only in
  ``weights.npz`` and the program holds no copy of them;
- ``weights.npz``   — the weight tree flattened to ``/``-joined paths
  (:func:`_flatten`), the keys and arrays the JAX artifact has for the same
  weights; bfloat16 as its raw bytes (``|V2``), as ``np.savez`` writes the
  JAX package's bfloat16 arrays;
- ``metadata.json`` — the JAX artifact's keys (format version, producer,
  runtime argument specs, model type), plus the device the program was
  traced on, the card's name, and the precision policy's compute dtype at
  trace time. A flash call's q-tile (``block_q``) is chosen at trace time
  and is part of the program, so ``device_name`` says which card chose it.

:class:`CompiledModel` runs the program on the device the caller names,
the card by default, like every entry point of the port.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..monitoring import watchdogs

# the operators a program may call must be registered before it loads
from ..kernels import attention as _operators  # noqa: F401

_FORMAT_VERSION = 1
BF16_BYTES = np.dtype("V2")

_EMPTY_DICT = "__EMPTY_DICT__"
_EMPTY_LIST = "__EMPTY_LIST__"
_TUPLE = "__TUPLE__"


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array, bfloat16 as its raw bytes (``|V2``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_BYTES)
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """An npz array as a tensor on ``device``; ``|V2`` is bfloat16's bytes
    (a 0-d array stays 0-d)."""
    a = np.ascontiguousarray(a).reshape(np.shape(a))
    if a.dtype == BF16_BYTES:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    """Path-keyed leaves. Empty containers get explicit markers: dropping
    them would change the tree's structure, and the exported program's
    calling convention rejects the reloaded weights (a net without
    BatchNormalization has ``bn == {}``)."""
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[prefix + _EMPTY_DICT] = np.zeros(0)
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if isinstance(tree, tuple):
            # the calling convention distinguishes tuple from list
            out[prefix + _TUPLE] = np.zeros(0)
        if not tree:
            out[prefix + _EMPTY_LIST] = np.zeros(0)
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}#/"))
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        if parts[-1] == _EMPTY_DICT:
            continue  # the setdefault chain already created the empty dict
        if parts[-1] in (_EMPTY_LIST, _TUPLE):
            cur[parts[-1]] = True
            continue
        cur[parts[-1]] = arr

    def fix(node):
        if not isinstance(node, dict):
            return node
        is_tuple = bool(node.pop(_TUPLE, None))
        if node.pop(_EMPTY_LIST, None):
            return () if is_tuple else []
        if node and all(k.endswith("#") for k in node):
            seq = [fix(node[f"{i}#"]) for i in range(len(node))]
            return tuple(seq) if is_tuple else seq
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _spec(a):
    return [list(a.shape), str(a.dtype).replace("torch.", "")]


class _Program(torch.nn.Module):
    """``forward(weights, *args) = fn(weights, *args)``: the module that is
    exported. It owns no parameters or buffers, so every weight is an input
    of the program."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, weights, *args):
        return self.fn(weights, *args)


def export_compiled(fn, example_args: Sequence[Any], weights, path: str,
                    metadata: Optional[dict] = None) -> Dict[str, float]:
    """Export ``fn(weights, *runtime_args)`` traced at ``weights`` and
    ``example_args`` (tensors on the device the program is for) into the
    artifact zip; the loader binds the stored weights, so callers pass only
    the runtime arguments. Returns the seconds of the trace (``export``)
    and of writing the zip (``save``). The trace counts as one compile in
    ``tdl_xla_compiles_total`` (``monitoring.watchdogs``)."""
    import time

    from ..common.precision import compute_dtype

    t0 = time.perf_counter()

    # dicts with sorted keys at every level: the tree the loader rebuilds
    # from the npz has this order, and the calling convention checks it
    weights = _map_leaves(lambda t: t.detach() if isinstance(t, torch.Tensor) else t, weights)
    args = tuple(example_args)
    device = next((a.device for a in args if isinstance(a, torch.Tensor)), torch.device("cpu"))
    t_trace = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(_Program(fn), (weights, *args))
    # the trace is a compile of the port to the recompile watchdog
    watchdogs.note_compile(time.perf_counter() - t_trace)
    if program.state_dict or program.constants:
        raise ValueError("export_compiled: the traced function captured tensors that are not "
                         f"inputs ({sorted(program.state_dict) + sorted(program.constants)}); "
                         "pass every weight through the weights tree")
    t1 = time.perf_counter()
    blob = io.BytesIO()
    torch.export.save(program, blob)
    buf = io.BytesIO()
    np.savez(buf, **_flatten(weights))
    meta = {
        "format_version": _FORMAT_VERSION,
        "producer": "deeplearning4j_tpu_torch",
        "n_runtime_args": len(args),
        "runtime_arg_specs": [_map_leaves(_spec, a) for a in args],
        "device": device.type,
        "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "compute_dtype": str(compute_dtype(device)).replace("torch.", ""),
        **(metadata or {}),
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.pt2", blob.getvalue())
        z.writestr("weights.npz", buf.getvalue())
        z.writestr("metadata.json", json.dumps(meta, indent=2))
    return {"export": t1 - t0, "save": time.perf_counter() - t1}


class CompiledModel:
    """A reloaded artifact: callable without any of the port's model
    classes (the graph executor's "run the stored graph" role). Arguments
    go to the model's device, a floating argument in the dtype the program
    was traced with (``runtime_arg_specs``); the results stay there."""

    def __init__(self, program, weights, metadata: dict, device: torch.device):
        self._program = program
        self._module = program.module()
        self._weights = weights
        self.metadata = metadata
        self.device = device
        self._dtypes = [getattr(torch, spec[1]) if isinstance(spec, list) and len(spec) == 2
                        and isinstance(spec[1], str) else None
                        for spec in metadata.get("runtime_arg_specs", [])]

    def __call__(self, *runtime_args):
        args = []
        for i, a in enumerate(runtime_args):
            t = torch.as_tensor(a).to(self.device)
            dt = self._dtypes[i] if i < len(self._dtypes) else None
            if dt is not None and dt.is_floating_point and t.is_floating_point():
                t = t.to(dt)
            args.append(t)
        with torch.no_grad():
            return self._module(self._weights, *args)

    output = __call__


def load_compiled(path: str, device="cuda") -> CompiledModel:
    """Load an artifact of :func:`export_compiled` onto ``device`` (the
    card unless the caller asks for the CPU). A program traced on another
    device type is moved to ``device`` first."""
    from ..common.device import resolve_device

    device = resolve_device(device)
    with zipfile.ZipFile(path, "r") as z:
        program = torch.export.load(io.BytesIO(z.read("model.pt2")))
        with np.load(io.BytesIO(z.read("weights.npz"))) as npz:
            flat = {k: npz[k] for k in npz.files}
        metadata = json.loads(z.read("metadata.json"))
    if metadata.get("device") != device.type:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    weights = _map_leaves(lambda a: _from_numpy(a, device), _unflatten(flat))
    return CompiledModel(program, weights, metadata, device)


# --------------------------------------------------------- framework fronts


def _nested(pd: dict) -> dict:
    """A layer's parameters with "/"-joined keys (a Bidirectional's
    ``"fwd/W"``) as a nested tree (``{"fwd": {"W": ...}}``)."""
    out: Dict[str, Any] = {}
    for k, v in pd.items():
        *path, leaf = k.split("/")
        cur = out
        for p in path:
            cur = cur.setdefault(p, {})
        cur[leaf] = v
    return out


def _joined(tree, prefix="") -> dict:
    """The inverse of :func:`_nested`."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_joined(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def export_multilayer(net, path: str, example_input) -> Dict[str, float]:
    """``MultiLayerNetwork.export()``: the inference forward (``output()``)
    as a compiled artifact; weights = ``{"params", "bn"}`` under the JAX
    package's keys (layer index, parameter name; ``mean``/``var``)."""

    def fwd(weights, x):
        params = {si: _joined(pd) for si, pd in weights["params"].items()}
        h, _, _ = net._forward(params, weights["bn"], net._ingest(x), training=False,
                               rng=None)
        return net._head_forward(params, h)

    # the example at the wire dtype: an on-device ingest (set_device_ingest)
    # is part of the exported forward, as it is of output()
    x = net._put(example_input, net._features_dtype())
    # a wrapped layer's flat "fwd/W" keys go in as the nested tree JAX's
    # artifact holds: weights.npz's "/"-joined paths reload into that tree
    weights = {"params": {si: _nested(pd) for si, pd in net._params().items()},
               "bn": net._bn()}
    return export_compiled(fwd, (x,), weights, path,
                           metadata={"model_type": "MultiLayerNetwork"})


def export_samediff(sd, path: str, placeholders: Dict[str, Any],
                    outputs: Sequence[str]) -> None:
    """``SameDiff.save_compiled()`` of the JAX package."""
    raise NotImplementedError("export_samediff: SameDiff is not ported (ROADMAP.md queue 1 "
                              "item 8)")
