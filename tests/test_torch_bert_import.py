"""The port's HF BERT import (``deeplearning4j_tpu_torch.models.bert_import``)
against the JAX package's ``models/bert_import.py`` and against HF's own
forward, from a seeded ``transformers`` model, its state dict, and
directories it writes (nothing is downloaded).

Tolerances: the imported parameters equal JAX's exactly (the same
transposes and concatenations of the same float32 values); the port's
float32 logits within 1e-5 of JAX's (relative to the largest logit: two
float32 encoders summing in other orders) and within 1e-3 of HF's (the
JAX package's golden bound); padded positions are not compared with HF.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import bert_import as JB
from deeplearning4j_tpu.models import transformer as JT
from deeplearning4j_tpu_torch.models import bert_import as TB
from deeplearning4j_tpu_torch.models import transformer as TT
from deeplearning4j_tpu_torch.models.weights import params_to_numpy
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

JAX_REL = 1e-5
HF_ATOL = 1e-3
HF_CONFIG = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, max_position_embeddings=48, type_vocab_size=2,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, hidden_act="gelu")


def _transformers():
    return pytest.importorskip("transformers")


def _hf(seed=0, headless=False):
    tr = _transformers()
    torch.manual_seed(seed)
    cls = tr.BertModel if headless else tr.BertForMaskedLM
    return cls(tr.BertConfig(**HF_CONFIG)).eval()


def _same_params(port, jparams):
    got = params_to_numpy(port)
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)


def _inputs(seed=0, B=3, T=16, pad_from=None):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, HF_CONFIG["vocab_size"], (B, T))
    segments = (rs.rand(B, T) > 0.5).astype(np.int64)
    mask = np.ones((B, T), np.int64)
    if pad_from is not None:
        mask[:, pad_from:] = 0
    return tokens, segments, mask


def _logits(port, cfg, jparams, jcfg, tokens, segments, mask):
    with torch.no_grad():
        got = TT.forward(port, torch.from_numpy(tokens), cfg, segments=torch.from_numpy(segments),
                         pad_mask=torch.from_numpy(mask).float()).numpy()
    fwd = jax.jit(lambda p, t, s, m: JT.forward(p, t, jcfg, segments=s, pad_mask=m))
    want = np.asarray(fwd(jparams, jnp.asarray(tokens, jnp.int32), jnp.asarray(segments, jnp.int32),
                          jnp.asarray(mask, jnp.float32)))
    return got, want


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("pad_from", [None, 10])
def test_import_of_a_model_equals_jax_and_hf(pad_from):
    model = _hf()
    port, cfg = TB.import_hf_bert(model, device="cpu")
    jparams, jcfg = JB.import_hf_bert(model)
    assert cfg.norm_position == "post" and not cfg.gelu_approximate
    assert cfg.compute_dtype == torch.float32 and not cfg.causal
    _same_params(port, jparams)
    tokens, segments, mask = _inputs(pad_from=pad_from)
    got, want = _logits(port, cfg, jparams, jcfg, tokens, segments, mask)
    assert _rel(got, want) <= JAX_REL
    with torch.no_grad():
        golden = model(input_ids=torch.from_numpy(tokens), attention_mask=torch.from_numpy(mask),
                       token_type_ids=torch.from_numpy(segments)).logits.numpy()
    keep = slice(None) if pad_from is None else slice(0, pad_from)
    np.testing.assert_allclose(got[:, keep], golden[:, keep], atol=HF_ATOL, rtol=HF_ATOL)


def test_import_of_a_state_dict_and_a_dict_config():
    model = _hf(1)
    sd = model.state_dict()
    jparams = JB.params_from_state_dict(sd, JB.config_from_hf(model.config))
    port, cfg = TB.import_hf_bert(sd, config=model.config.to_dict(), device="cpu")
    _same_params(port, jparams)
    direct = TB.params_from_state_dict(sd, TB.config_from_hf(model.config), device="cpu")
    _same_params(direct, jparams)
    with pytest.raises(TypeError, match="config="):
        TB.import_hf_bert(sd, device="cpu")


def test_config_from_a_plain_dict_needs_no_transformers():
    keys = dict(vocab_size=30522, max_position_embeddings=512, hidden_size=768,
                num_attention_heads=12, num_hidden_layers=12, intermediate_size=3072,
                type_vocab_size=2, hidden_dropout_prob=0.1)
    cfg = TB.config_from_hf(keys)
    assert cfg == TT.TransformerConfig(norm_position="post", gelu_approximate=False,
                                       compute_dtype=torch.float32, dropout=0.1)
    jcfg = JB.config_from_hf(type("HFConfig", (), keys))  # the JAX package reads attributes
    for f in ("vocab_size", "max_len", "d_model", "n_heads", "n_layers", "d_ff", "type_vocab",
              "dropout", "causal", "norm_position", "gelu_approximate"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


@pytest.mark.parametrize("safe", [False, True])
def test_import_of_a_directory(tmp_path, safe):
    model = _hf(2)
    model.save_pretrained(str(tmp_path), safe_serialization=safe)
    port, cfg = TB.import_hf_bert(str(tmp_path), device="cpu")
    jparams, jcfg = JB.import_hf_bert(str(tmp_path))
    _same_params(port, jparams)
    assert dataclasses.replace(cfg, param_dtype=torch.float32) == cfg
    tokens, segments, mask = _inputs(3, pad_from=12)
    got, want = _logits(port, cfg, jparams, jcfg, tokens, segments, mask)
    assert _rel(got, want) <= JAX_REL


def test_a_safetensors_directory_without_safetensors_raises_naming_the_file(tmp_path,
                                                                            monkeypatch):
    model = _hf(2)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="model.safetensors"):
        TB.import_hf_bert(str(tmp_path), device="cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        TB.import_hf_bert(str(empty), device="cpu")


def test_a_headless_bert_model_gets_the_identity_head():
    model = _hf(4, headless=True)
    port, cfg = TB.import_hf_bert(model, device="cpu")
    jparams, jcfg = JB.import_hf_bert(model)
    _same_params(port, jparams)
    np.testing.assert_array_equal(port.mlm.w.detach().numpy(), np.eye(32, dtype=np.float32))
    tokens, segments, mask = _inputs(5, B=2, T=12)
    got, want = _logits(port, cfg, jparams, jcfg, tokens, segments, mask)
    assert _rel(got, want) <= JAX_REL
    # the encoder's states are HF's last hidden states
    with torch.no_grad():
        h = TT.encode(port, torch.from_numpy(tokens), cfg,
                      segments=torch.from_numpy(segments)).numpy()
        golden = model(input_ids=torch.from_numpy(tokens),
                       token_type_ids=torch.from_numpy(segments)).last_hidden_state.numpy()
    np.testing.assert_allclose(h, golden, atol=HF_ATOL, rtol=HF_ATOL)


def test_a_fine_tune_step_of_the_import_equals_jax():
    model = _hf(6)
    port, cfg = TB.import_hf_bert(model, device="cpu")
    jparams, jcfg = JB.import_hf_bert(model)
    cfg = dataclasses.replace(cfg, dropout=0.0)
    jcfg = dataclasses.replace(jcfg, dropout=0.0)
    tokens, segments, mask = _inputs(7, B=2, T=12)
    rs = np.random.RandomState(8)
    labels = rs.randint(0, HF_CONFIG["vocab_size"], tokens.shape)
    weights = (rs.rand(*tokens.shape) < 0.3).astype(np.float32)
    batch = {"tokens": tokens, "labels": labels, "weights": weights, "segments": segments}
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, b, jcfg, None, False)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = TT.loss_and_grads(port, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                               None, False)
    assert abs(float(tl) - float(jl)) <= JAX_REL * abs(float(jl))
    jflat = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    for name, g in tg.items():
        want = jflat[name]
        err = np.linalg.norm(g.numpy() - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= 1e-4, (name, err)
