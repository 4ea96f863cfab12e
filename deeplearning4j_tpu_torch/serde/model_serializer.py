"""Model serialization — the zip format (copy of the JAX package's
``serde.model_serializer``; one format for both packages).

DL4J's ``org.deeplearning4j.util.ModelSerializer`` writes a zip of the
configuration, the flat parameters and the updater state;
``restoreMultiLayerNetwork(file, loadUpdater)`` resumes a fit. The zip here
holds ``configuration.json`` (``{"@model": "MultiLayerNetwork" |
"ComputationGraph", "configuration": <the configuration's JSON>}``),
``coefficients.npz`` (the parameter tree), ``updaterState.npz``,
``bnState.npz`` and ``meta.json`` (iteration, epoch, score). An npz key is
the tree path with ``\\x1f`` between keys (``0\\x1fW``); the JAX package
writes ``__list<i>`` / ``__tuple<i>`` for a position in a sequence, which
the state trees of either package never hold. bfloat16 arrays are their raw
bytes (``|V2``), as ``serde.net_state`` says.

Not ported: normalizers (ROADMAP item 8.5), so ``write_model(normalizer=)``
raises and a ``normalizer.json`` in a zip is ignored on restore, as the JAX
package ignores it; Keras HDF5 and TF GraphDef import (item 8.8), which
``ModelGuesser`` recognises and refuses.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np


def _npz_bytes(arrays: dict, top: str) -> bytes:
    """One npz member of the zip: the ``<top>/...`` arrays of a snapshot,
    keyed by the rest of their path."""
    buf = io.BytesIO()
    np.savez(buf, **{p.split("/", 1)[1].replace("/", "\x1f"): a
                     for p, a in arrays.items() if p.split("/", 1)[0] == top})
    return buf.getvalue()


def _npz_paths(data: bytes, top: str) -> dict:
    """{"<top>/<path>": array} of one npz member of the zip."""
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {f"{top}/" + k.replace("\x1f", "/"): z[k] for k in z.files}


class ModelSerializer:
    @staticmethod
    def write_model(model, path: str, save_updater: bool = True, normalizer=None) -> None:
        """Write ``model`` (a port MultiLayerNetwork or ComputationGraph) as
        a zip the JAX package's ``ModelSerializer`` restores too."""
        from ..nn.graph import ComputationGraph
        from .net_state import snapshot

        if normalizer is not None:
            raise NotImplementedError("write_model(normalizer=): normalizers are not ported "
                                      "yet (ROADMAP.md queue 1 item 8.5)")
        kind = "ComputationGraph" if isinstance(model, ComputationGraph) else "MultiLayerNetwork"
        payload = {"@model": kind, "configuration": json.loads(model.conf.to_json())}
        arrays = snapshot(model)
        tops = {p.split("/", 1)[0] for p in arrays}
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("configuration.json", json.dumps(payload, indent=2))
            z.writestr("coefficients.npz", _npz_bytes(arrays, "params"))
            if save_updater and "updater" in tops:
                z.writestr("updaterState.npz", _npz_bytes(arrays, "updater"))
            if "bn" in tops:
                z.writestr("bnState.npz", _npz_bytes(arrays, "bn"))
            z.writestr("meta.json", json.dumps(
                {"iteration": model.iteration, "epoch": model.epoch, "score": model.score_}))

    writeModel = write_model

    @staticmethod
    def _restore(path: str, load_updater: bool, device):
        from ..nn.conf import MultiLayerConfiguration
        from ..nn.graph import ComputationGraph
        from ..nn.graph_conf import ComputationGraphConfiguration
        from ..nn.multilayer import MultiLayerNetwork
        from .net_state import load

        with zipfile.ZipFile(path) as z:
            payload = json.loads(z.read("configuration.json"))
            conf_json = json.dumps(payload["configuration"])
            if payload["@model"] == "ComputationGraph":
                model = ComputationGraph(ComputationGraphConfiguration.from_json(conf_json),
                                         device=device).init()
            else:
                model = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json),
                                          device=device).init()
            names = z.namelist()
            arrays = _npz_paths(z.read("coefficients.npz"), "params")
            tops = ["params"]
            if load_updater and "updaterState.npz" in names:
                arrays.update(_npz_paths(z.read("updaterState.npz"), "updater"))
                tops.append("updater")
            if "bnState.npz" in names:
                arrays.update(_npz_paths(z.read("bnState.npz"), "bn"))
                tops.append("bn")
            load(model, arrays, source=path, tops=tops)
            if "meta.json" in names:
                meta = json.loads(z.read("meta.json"))
                model.iteration = meta.get("iteration", 0)
                model.epoch = meta.get("epoch", 0)
                score = meta.get("score")
                model.score_ = float("nan") if score is None else score
        return model

    @staticmethod
    def restore_multi_layer_network(path: str, load_updater: bool = True, *, device="cuda"):
        return ModelSerializer._restore(path, load_updater, device)

    restoreMultiLayerNetwork = restore_multi_layer_network

    @staticmethod
    def restore_computation_graph(path: str, load_updater: bool = True, *, device="cuda"):
        return ModelSerializer._restore(path, load_updater, device)

    restoreComputationGraph = restore_computation_graph

    @staticmethod
    def restore(path: str, load_updater: bool = True, *, device="cuda"):
        """ModelGuesser equivalent: restore whichever model kind the zip
        holds, on ``device``."""
        return ModelSerializer._restore(path, load_updater, device)


class ModelGuesser:
    """``org.deeplearning4j.util.ModelGuesser``: load a model file of
    unknown provenance by sniffing the container format, not the
    extension. The port reads ModelSerializer zips; a Keras HDF5 or a
    frozen TF GraphDef is recognised and refused (ROADMAP item 8.8)."""

    @staticmethod
    def load_model_guess(path: str, *, device="cuda"):
        if zipfile.is_zipfile(path):
            with zipfile.ZipFile(path) as z:
                ours = "configuration.json" in z.namelist()
            if not ours:  # e.g. a Keras v3 .keras zip — not our container
                raise ValueError(
                    f"cannot guess model format of {path}: a zip without "
                    "ModelSerializer's configuration.json (.keras v3 zips "
                    "are unsupported — re-save as legacy HDF5)")
            return ModelSerializer.restore(path, device=device)
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic.startswith(b"\x89HDF") or magic.startswith(b"\x0e\x03\x13\x01"):
            raise NotImplementedError(f"{path} is a Keras HDF5 file: Keras import is not "
                                      "ported yet (ROADMAP.md queue 1 item 8.8, modelimport)")
        if magic[:1] == b"\x0a":
            raise NotImplementedError(f"{path} may be a frozen TF GraphDef: TF import is not "
                                      "ported yet (ROADMAP.md queue 1 item 8.8, modelimport)")
        raise ValueError(
            f"cannot guess model format of {path}: not a ModelSerializer "
            "zip, Keras HDF5, or frozen TF GraphDef")

    loadModelGuess = load_model_guess
