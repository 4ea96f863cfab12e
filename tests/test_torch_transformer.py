"""Port parity: the serving forward of ``deeplearning4j_tpu_torch.models.
transformer`` against the JAX package's transformer, through the weight
bridge (the JAX ``init_params`` pytree as numpy → ``params_from_jax``).

Small model: 2 layers, d 32, 4 heads, vocab 97. Tolerances: float32
compute, atol 1e-5 (same math; sums in another order). bfloat16 compute,
atol 1e-2 on logits of magnitude ~0.5: the two frameworks round bf16
matmul outputs, gelu and softmax at different points (one bf16 ulp is
2^-8 relative), and those roundings accumulate over the layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common import bucketing as jbucket
from deeplearning4j_tpu.models import transformer as J
from deeplearning4j_tpu_torch.common import bucketing as tbucket
from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models.weights import (params_from_jax, params_to_numpy,
                                                     qa_params_from_jax)

FP32_ATOL = 1e-5
BF16_ATOL = 1e-2

_SMALL = dict(vocab_size=97, max_len=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              dropout=0.0)
_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="float32", **kw):
    jd, td = _DTYPES[dtype]
    kw = {**_SMALL, **kw}
    return (J.TransformerConfig(compute_dtype=jd, **kw),
            T.TransformerConfig(compute_dtype=td, **kw))


def _models(jc, tc, seed=0):
    jp = J.init_params(jax.random.key(seed), jc)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _batch(seed=1, B=2, L=19, vocab=97):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, vocab, (B, L)).astype(np.int32)
    pad = (np.arange(L)[None] < rs.randint(L // 2, L + 1, B)[:, None]).astype(np.float32)
    segments = (np.arange(L)[None] >= L // 2).repeat(B, 0).astype(np.int32)
    return tokens, pad, segments


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def test_bridge_names_mirror_the_pytree_and_round_trip():
    jc, tc = _cfgs()
    jp, tp = _models(jc, tc)
    flat = {jax.tree_util.keystr(path, simple=True, separator="."): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert set(tp.state_dict()) == set(flat)
    for name, p in tp.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), flat[name])
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_bridge_takes_bf16_params_and_rejects_mismatches():
    jc, tc = _cfgs(param_dtype=jnp.bfloat16)
    tc = dataclasses.replace(tc, param_dtype=torch.bfloat16)
    jp = J.init_params(jax.random.key(3), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    assert tp.blocks[0].qkv_w.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp.blocks[1].ffn_w2.float().numpy(),
                                  np.asarray(jp["blocks"][1]["ffn_w2"].astype(jnp.float32)))
    tree = jax.tree.map(np.asarray, jp)
    del tree["mlm"]["out_bias"]
    with pytest.raises(KeyError, match="out_bias"):
        params_from_jax(tree, tc, device="cpu")
    tree = jax.tree.map(np.asarray, jp)
    tree["embed"]["pos"] = tree["embed"]["pos"][:10]
    with pytest.raises(ValueError, match="embed.pos"):
        params_from_jax(tree, tc, device="cpu")


@pytest.mark.parametrize("with_segments", [False, True])
def test_embed_matches_jax(with_segments):
    jc, tc = _cfgs()
    jp, tp = _models(jc, tc)
    tokens, _, segments = _batch()
    segs = segments if with_segments else None
    ref = J.embed(jp, jnp.asarray(tokens), jc,
                  segments=None if segs is None else jnp.asarray(segs))
    out = T.embed(tp, tokens, tc, segments=segs)
    np.testing.assert_allclose(_np(out), _np(ref), atol=FP32_ATOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("norm", ["pre", "post"])
@pytest.mark.parametrize("causal", [False, True])
def test_block_matches_jax(impl, norm, causal):
    jc, tc = _cfgs(attn_impl=impl, norm_position=norm, causal=causal)
    jp, tp = _models(jc, tc)
    tokens, pad, _ = _batch()
    h = np.random.RandomState(4).randn(2, tokens.shape[1], 32).astype(np.float32)
    ref = J._block(jc, jp["blocks"][0], jnp.asarray(h), jnp.asarray(pad), None, False)
    out = T._block(tc, tp.blocks[0], torch.from_numpy(h), torch.from_numpy(pad))
    np.testing.assert_allclose(_np(out), _np(ref), atol=FP32_ATOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("norm", ["pre", "post"])
@pytest.mark.parametrize("gelu_approximate", [True, False])
def test_encode_and_forward_match_jax(impl, norm, gelu_approximate):
    jc, tc = _cfgs(attn_impl=impl, norm_position=norm, gelu_approximate=gelu_approximate)
    jp, tp = _models(jc, tc)
    tokens, pad, segments = _batch()
    kw_j = dict(pad_mask=jnp.asarray(pad), segments=jnp.asarray(segments))
    kw_t = dict(pad_mask=pad, segments=segments)
    np.testing.assert_allclose(_np(T.encode(tp, tokens, tc, **kw_t)),
                               _np(J.encode(jp, jnp.asarray(tokens), jc, **kw_j)),
                               atol=FP32_ATOL)
    logits = T.forward(tp, tokens, tc, **kw_t)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 19, 97)
    np.testing.assert_allclose(_np(logits), _np(J.forward(jp, jnp.asarray(tokens), jc, **kw_j)),
                               atol=FP32_ATOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_bf16_matches_jax(impl):
    jc, tc = _cfgs("bfloat16", attn_impl=impl)
    jp, tp = _models(jc, tc)
    tokens, pad, _ = _batch(seed=5)
    ref = J.forward(jp, jnp.asarray(tokens), jc, pad_mask=jnp.asarray(pad))
    out = T.forward(tp, tokens, tc, pad_mask=pad)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), atol=BF16_ATOL)
    h = T.encode(tp, tokens, tc, pad_mask=pad)
    assert h.dtype == torch.bfloat16  # the residual stream stays in the compute dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlm_head_at_positions_matches_jax(dtype):
    jc, tc = _cfgs(dtype)
    jp, tp = _models(jc, tc)
    h = np.random.RandomState(6).randn(2, 19, 32).astype(np.float32)
    positions = np.array([[0, 5, 18], [3, 3, 7]], np.int32)
    ref = J.mlm_head(jp, jnp.asarray(h).astype(jc.compute_dtype), jc,
                     positions=jnp.asarray(positions))
    out = T.mlm_head(tp, torch.from_numpy(h).to(tc.compute_dtype), tc, positions=positions)
    assert tuple(out.shape) == (2, 3, 97) and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref),
                               atol=FP32_ATOL if dtype == "float32" else BF16_ATOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_qa_forward_matches_jax(impl):
    jc, tc = _cfgs(attn_impl=impl, norm_position="post")
    jp, tp = _models(jc, tc)
    jqa = J.init_qa_head(jax.random.key(9), jc)
    tqa = qa_params_from_jax(jax.tree.map(np.asarray, jqa), tc, device="cpu")
    tokens, pad, segments = _batch(seed=7)
    rs, re_ = J.qa_forward(jp, jqa, jnp.asarray(tokens), jc, pad_mask=jnp.asarray(pad),
                           segments=jnp.asarray(segments))
    s, e = T.qa_forward(tp, tqa, tokens, tc, pad_mask=pad, segments=segments)
    np.testing.assert_allclose(_np(s), _np(rs), atol=FP32_ATOL)
    np.testing.assert_allclose(_np(e), _np(re_), atol=FP32_ATOL)


def test_module_call_is_the_functional_forward():
    _, tc = _cfgs()
    model = T.init_params(0, tc, device="cpu")
    tokens, pad, _ = _batch()
    np.testing.assert_array_equal(model(tokens, pad_mask=pad).numpy(),
                                  T.forward(model, tokens, tc, pad_mask=pad).numpy())


def test_init_params_is_seeded_and_shaped_like_jax():
    jc, tc = _cfgs()
    a = T.init_params(0, tc, device="cpu")
    b = T.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    c = T.init_params(1, tc, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in a.state_dict().items()}
    jp = J.init_params(jax.random.key(0), jc)
    assert shapes == {jax.tree_util.keystr(p, simple=True, separator="."): tuple(v.shape)
                      for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for k in shapes:
        assert torch.equal(a.state_dict()[k], b.state_dict()[k])
    assert not torch.equal(a.blocks[0].qkv_w, c.blocks[0].qkv_w)
    assert abs(a.embed.tok.std().item() - 0.02) < 0.002
    assert torch.all(a.blocks[1].ln2_scale == 1) and torch.all(a.mlm.out_bias == 0)
    qa = T.init_qa_head(0, tc, device="cpu")
    assert tuple(qa.w.shape) == (32, 2) and torch.all(qa.b == 0)


def test_configs_mirror_jax():
    for name in ("bert_base", "bert_large", "tiny"):
        j, t = getattr(J.TransformerConfig, name)(), getattr(T.TransformerConfig, name)()
        for field in ("vocab_size", "max_len", "d_model", "n_heads", "n_layers", "d_ff",
                      "type_vocab", "causal", "dropout", "attn_impl", "norm_position",
                      "gelu_approximate", "head_dim"):
            assert getattr(j, field) == getattr(t, field), (name, field)
    assert T.TransformerConfig().compute_dtype == torch.bfloat16
    assert T.TransformerConfig().param_dtype == torch.float32


def test_inputs_the_port_refuses():
    """JAX clamps out-of-range gathers; the port refuses them on the host
    (on the card such a gather would be a device-side assert)."""
    _, tc = _cfgs()
    model = T.init_params(0, tc, device="cpu")
    tokens, _, _ = _batch()
    with pytest.raises(ValueError, match=r"token ids must lie in \[0, 97\)"):
        T.forward(model, np.full((1, 4), 97), tc)
    with pytest.raises(ValueError, match="token ids"):
        T.forward(model, np.full((1, 4), -1), tc)
    with pytest.raises(TypeError, match="integers"):
        T.forward(model, np.full((1, 4), 1.5), tc)
    with pytest.raises(ValueError, match="segment ids"):
        T.forward(model, tokens, tc, segments=np.full(tokens.shape, 2))
    with pytest.raises(ValueError, match="exceeds max_len"):
        T.forward(model, np.zeros((1, 65), np.int64), tc)
    with pytest.raises(ValueError, match="position ids"):
        T.mlm_head(model, torch.zeros((1, 4, 32)), tc, positions=[[4]])
    with pytest.raises(NotImplementedError, match="training slice"):
        T.forward(model, tokens, tc, train=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.forward(model, tokens, dataclasses.replace(tc, attn_impl="ring"))


def test_bucketing_copy_matches_jax():
    for n in range(0, 300, 7):
        for mb in (1, 8, 16):
            for mult in (1, 3, 4):
                assert (tbucket.bucket_size(n, min_bucket=mb, multiple=mult)
                        == jbucket.bucket_size(n, min_bucket=mb, multiple=mult))
                assert (tbucket.bucket_ladder(n, min_bucket=mb, multiple=mult)
                        == jbucket.bucket_ladder(n, min_bucket=mb, multiple=mult))
    with pytest.raises(ValueError):
        tbucket.bucket_size(-1)
