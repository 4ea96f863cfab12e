"""HF BERT checkpoint import → the port's transformer (counterpart of
``deeplearning4j_tpu/models/bert_import.py``).

The architecture is already native (``models.transformer`` with
``norm_position="post"``), so import is a name-mapping table from
HF-transformers BERT names onto the parameter tree that
``models.weights.params_from_jax`` loads: HF linear weights [out, in] are
transposed to [in, out] and Q/K/V fused into one [D, 3D] projection.

Accepted sources (:func:`import_hf_bert`):

- a ``transformers`` ``BertModel``/``BertForMaskedLM`` instance;
- a state dict (any mapping name → tensor or array), with its config;
- a directory holding an HF checkpoint: ``config.json`` and
  ``model.safetensors`` (read where the ``safetensors`` package imports) or
  ``pytorch_model.bin`` (read with ``torch.load(..., weights_only=True)``).
  The directory is read as it is; nothing is downloaded, and
  ``transformers`` is not needed.

Where the JAX package differs: it loads a directory through
``transformers``' ``from_pretrained``, so a headless ``BertModel`` directory
gets the MLM head that ``transformers`` initialises at random; the port reads
the tensors on disk, and a checkpoint without a head gets the same identity
head as a headless state dict in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .transformer import Transformer, TransformerConfig
from .weights import params_from_jax


def _np(t) -> np.ndarray:
    """torch tensor / array-like → numpy (half and bf16 widened to float32)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def config_from_hf(hf_config) -> TransformerConfig:
    """``transformers.BertConfig``, or a dict of ``config.json``'s keys →
    TransformerConfig (post-LN, exact gelu, float32 compute)."""
    get = (hf_config.get if isinstance(hf_config, Mapping)
           else lambda k, d=None: getattr(hf_config, k, d))
    return TransformerConfig(
        vocab_size=get("vocab_size"),
        max_len=get("max_position_embeddings"),
        d_model=get("hidden_size"),
        n_heads=get("num_attention_heads"),
        n_layers=get("num_hidden_layers"),
        d_ff=get("intermediate_size"),
        type_vocab=get("type_vocab_size", 2),
        dropout=get("hidden_dropout_prob", 0.1),
        causal=False,
        norm_position="post",
        gelu_approximate=False,  # HF BERT uses erf gelu
        # float32 compute so imported weights reproduce the checkpoint's
        # outputs; dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
        # for fine-tune speed
        compute_dtype=torch.float32,
    )


def _strip_prefix(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Normalize HF name variants: drop the leading 'bert.' / 'model.'."""
    out = {}
    for k, v in sd.items():
        for pref in ("bert.", "model."):
            if k.startswith(pref):
                k = k[len(pref):]
        out[k] = _np(v)
    return out


def _tree_from_state_dict(sd: Mapping[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    """The JAX package's parameter tree (numpy leaves) of an HF state dict."""
    sd = _strip_prefix(sd)
    D = cfg.d_model

    def get(name):
        if name not in sd:
            raise KeyError(
                f"missing checkpoint tensor {name!r}; have e.g. {sorted(sd)[:8]}")
        return sd[name]

    def lin_w(name):  # [out, in] → [in, out]
        return get(name).T

    tree: Dict[str, Any] = {
        "embed": {
            "tok": get("embeddings.word_embeddings.weight"),
            "pos": get("embeddings.position_embeddings.weight")[: cfg.max_len],
            "seg": get("embeddings.token_type_embeddings.weight"),
            "ln_scale": get("embeddings.LayerNorm.weight"),
            "ln_bias": get("embeddings.LayerNorm.bias"),
        },
        "blocks": [],
    }
    for i in range(cfg.n_layers):
        pre = f"encoder.layer.{i}."
        qkv = [lin_w(pre + f"attention.self.{n}.weight") for n in ("query", "key", "value")]
        qkv_b = [get(pre + f"attention.self.{n}.bias") for n in ("query", "key", "value")]
        tree["blocks"].append({
            "qkv_w": np.concatenate(qkv, axis=1),              # [D, 3D]
            "qkv_b": np.concatenate(qkv_b),
            "out_w": lin_w(pre + "attention.output.dense.weight"),
            "out_b": get(pre + "attention.output.dense.bias"),
            # post-LN: ln1 = after-attention LN, ln2 = after-FFN LN
            "ln1_scale": get(pre + "attention.output.LayerNorm.weight"),
            "ln1_bias": get(pre + "attention.output.LayerNorm.bias"),
            "ffn_w1": lin_w(pre + "intermediate.dense.weight"),
            "ffn_b1": get(pre + "intermediate.dense.bias"),
            "ffn_w2": lin_w(pre + "output.dense.weight"),
            "ffn_b2": get(pre + "output.dense.bias"),
            "ln2_scale": get(pre + "output.LayerNorm.weight"),
            "ln2_bias": get(pre + "output.LayerNorm.bias"),
        })
    # MLM head (cls.predictions.*); the decoder weight is tied to embed.tok.
    # A plain BertModel checkpoint has no head: identity transform, unit LN.
    if "cls.predictions.transform.dense.weight" in sd:
        tree["mlm"] = {
            "w": lin_w("cls.predictions.transform.dense.weight"),
            "b": get("cls.predictions.transform.dense.bias"),
            "ln_scale": get("cls.predictions.transform.LayerNorm.weight"),
            "ln_bias": get("cls.predictions.transform.LayerNorm.bias"),
            "out_bias": get("cls.predictions.bias"),
        }
    else:
        tree["mlm"] = {
            "w": np.eye(D, dtype=np.float32),
            "b": np.zeros((D,), np.float32),
            "ln_scale": np.ones((D,), np.float32),
            "ln_bias": np.zeros((D,), np.float32),
            "out_bias": np.zeros((cfg.vocab_size,), np.float32),
        }
    return tree


def params_from_state_dict(sd: Mapping[str, Any], cfg: TransformerConfig,
                           dtype=torch.float32, *, device="cuda") -> Transformer:
    """Name-mapping table HF BertForMaskedLM → a :class:`Transformer` on
    ``device`` with parameters in ``dtype``."""
    if dtype != cfg.param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    return params_from_jax(_tree_from_state_dict(sd, cfg), cfg, device=device)


def _read_directory(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(config.json as a dict, the state dict) of an HF checkpoint
    directory on disk."""
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    safe = os.path.join(path, "model.safetensors")
    binary = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(safe):
        try:
            from safetensors.torch import load_file
        except ImportError:
            if not os.path.exists(binary):
                raise ImportError(f"{safe} needs the safetensors package, which does "
                                  "not import here; save the checkpoint with "
                                  "safe_serialization=False for pytorch_model.bin") from None
        else:
            return config, load_file(safe, device="cpu")
    if os.path.exists(binary):
        return config, torch.load(binary, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{path} holds neither model.safetensors nor pytorch_model.bin")


def import_hf_bert(source, dtype=torch.float32, *, config=None,
                   device="cuda") -> Tuple[Transformer, TransformerConfig]:
    """One-call import: (params, cfg) from a checkpoint directory, a
    ``transformers`` model instance, or a state dict with its ``config``
    (a ``BertConfig`` or a dict of ``config.json``'s keys)."""
    if isinstance(source, (str, os.PathLike)):
        hf_cfg, sd = _read_directory(os.fspath(source))
    elif hasattr(source, "state_dict"):  # a torch nn.Module
        hf_cfg, sd = source.config, source.state_dict()
    elif isinstance(source, Mapping):
        if config is None:
            raise TypeError("import_hf_bert(state_dict) needs config= (a BertConfig or "
                            "a dict of config.json's keys)")
        hf_cfg, sd = config, source
    else:
        raise TypeError("import_hf_bert wants a checkpoint dir, a transformers model, "
                        "or a state dict with config=")
    cfg = dataclasses.replace(config_from_hf(hf_cfg), param_dtype=dtype)
    return params_from_state_dict(sd, cfg, dtype, device=device), cfg
