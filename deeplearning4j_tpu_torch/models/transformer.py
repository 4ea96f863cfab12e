"""Flagship transformer (BERT-base family) in PyTorch: serving and training.

Counterpart of ``deeplearning4j_tpu/models/transformer.py``. The model is an
``nn.Module`` (:class:`Transformer` holding :class:`Block` s) whose parameter
names mirror the JAX pytree keys (``embed.tok``, ``blocks.3.qkv_w``,
``mlm.out_bias``); beside it, the JAX package's functional names (``embed``,
``encode``, ``forward``, ``mlm_head``, ``prefill_forward``, ...) are plain
functions of the module's tensors, so each has a counterpart to be found and
compared.

Weight layout: as in JAX, every dense weight is [in, out] and a layer
computes ``x @ W + b`` (no ``nn.Linear``, whose weight is [out, in]).

Numerics follow the JAX package: parameters in ``param_dtype``, products and
the residual stream in ``compute_dtype``, layer norms in float32 and cast
back, and the tied decoder of ``mlm_head`` with compute-dtype operands and
float32 products.

Serving: the inference forward (``forward``, ``encode``, ``qa_forward``,
run under ``torch.inference_mode``) and greedy generation through a KV-cache
slot pool (the block-paged ``models.paged_decode.PagedDecodeSlotPool`` by
default, or the dense :class:`DecodeSlotPool`). Training: dropout,
``token_ce_loss``, ``loss_fn``, ``qa_loss_fn`` and the train steps (``make_train_step``,
``make_qa_train_step``) with the updaters of ``nn.updaters``; gradients come
from autograd, through the flash backward kernels for the attention.
Randomness: where the JAX package takes a ``jax.random`` key (``rng``), the
port takes a ``torch.Generator`` (``generator``) on the parameters' device.

Sharded training: ``place_params`` gives each rank of a (dp, tp, sp) mesh
its blocks of the weights by ``partition_specs`` (Megatron's tensor
parallelism over tp, ring or Ulysses attention over the config's
``sequence_axis``); ``loss_fn``, ``loss_and_grads`` and
``make_train_step`` on such a model take the global batch and make one
logical step with the single-device numbers (the section "a model placed
on a mesh" below).
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.bucketing import bucket_size
from ..common.device import resolve_device
from ..kernels.attention import dot_product_attention, ring_attention, ulysses_attention

_NEG_INF = -1e30  # matches kernels.attention masking


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 30522          # BERT-base WordPiece vocab
    max_len: int = 512
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    type_vocab: int = 2              # segment ids (BERT)
    causal: bool = False             # False = BERT encoder, True = GPT-style LM
    dropout: float = 0.1             # applied only when training (train=True)
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"          # auto | xla | flash | ring | ulysses
    sequence_axis: Optional[str] = None  # mesh axis of ring/Ulysses attention ("sp")
    norm_position: str = "pre"       # "pre" (GPT-style) | "post" (original BERT)
    gelu_approximate: bool = True    # True = tanh gelu, False = erf gelu
    remat: bool = False              # recompute each block in the backward (memory for FLOPs)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def bert_base(**kw) -> "TransformerConfig":
        return TransformerConfig(**kw)

    @staticmethod
    def bert_large(**kw) -> "TransformerConfig":
        kw.setdefault("d_model", 1024)
        kw.setdefault("n_heads", 16)
        kw.setdefault("n_layers", 24)
        kw.setdefault("d_ff", 4096)
        return TransformerConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "TransformerConfig":
        kw.setdefault("vocab_size", 1024)
        kw.setdefault("max_len", 128)
        kw.setdefault("d_model", 128)
        kw.setdefault("n_heads", 4)
        kw.setdefault("n_layers", 2)
        kw.setdefault("d_ff", 512)
        return TransformerConfig(**kw)


# ------------------------------------------------------------------ modules


def _param(shape, dtype, device) -> nn.Parameter:
    # trainable; the serving entry points run under inference_mode, so they
    # record no graph
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Embed(nn.Module):
    """``params["embed"]``: token, position and segment tables + layer norm."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        D, dt = cfg.d_model, cfg.param_dtype
        self.tok = _param((cfg.vocab_size, D), dt, device)
        self.pos = _param((cfg.max_len, D), dt, device)
        self.seg = _param((cfg.type_vocab, D), dt, device)
        self.ln_scale = _param((D,), dt, device)
        self.ln_bias = _param((D,), dt, device)


class Block(nn.Module):
    """``params["blocks"][i]``: attention and FFN weights of one layer."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        D, Fd, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.qkv_w = _param((D, 3 * D), dt, device)
        self.qkv_b = _param((3 * D,), dt, device)
        self.out_w = _param((D, D), dt, device)
        self.out_b = _param((D,), dt, device)
        self.ln1_scale = _param((D,), dt, device)
        self.ln1_bias = _param((D,), dt, device)
        self.ffn_w1 = _param((D, Fd), dt, device)
        self.ffn_b1 = _param((Fd,), dt, device)
        self.ffn_w2 = _param((Fd, D), dt, device)
        self.ffn_b2 = _param((D,), dt, device)
        self.ln2_scale = _param((D,), dt, device)
        self.ln2_bias = _param((D,), dt, device)


class MlmHead(nn.Module):
    """``params["mlm"]``: dense + layer norm + bias of the tied decoder."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        D, dt = cfg.d_model, cfg.param_dtype
        self.w = _param((D, D), dt, device)
        self.b = _param((D,), dt, device)
        self.ln_scale = _param((D,), dt, device)
        self.ln_bias = _param((D,), dt, device)
        self.out_bias = _param((cfg.vocab_size,), dt, device)


class Transformer(nn.Module):
    """The whole parameter set (uninitialised until :func:`init_params` or
    the weight bridge fills it). Calling it runs :func:`forward`."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = Embed(cfg, dev)
        self.blocks = nn.ModuleList(Block(cfg, dev) for _ in range(cfg.n_layers))
        self.mlm = MlmHead(cfg, dev)
        # set by place_params: the mesh whose rank's blocks this module holds
        self.mesh = None

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def forward(self, tokens, *, segments=None, pad_mask=None):
        return forward(self, tokens, self.cfg, segments=segments, pad_mask=pad_mask)


class QaHead(nn.Module):
    """Span head of ``qa_forward``: w [D, 2], b [2], float32."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.w = _param((cfg.d_model, 2), torch.float32, dev)
        self.b = _param((2,), torch.float32, dev)


# --------------------------------------------------------------------- init


def _generator(generator) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator().manual_seed(int(generator))


@torch.no_grad()
def init_params(generator, cfg: TransformerConfig, *, device="cuda") -> Transformer:
    """Random weights as the JAX ``init_params`` draws them: dense weights
    N(0, 0.02), biases 0, layer-norm scales 1. ``generator`` is a CPU
    ``torch.Generator`` or an int seed; the draws are made on the CPU, so a
    seed gives the same weights on every device (not JAX's numbers: those
    come through ``models.weights.params_from_jax``)."""
    gen = _generator(generator)
    model = Transformer(cfg, device=device)

    def dense(p):
        p.copy_(torch.randn(p.shape, generator=gen) * 0.02)

    def const(p, value):
        p.fill_(value)

    e, m = model.embed, model.mlm
    for p in (e.tok, e.pos, e.seg, m.w):
        dense(p)
    for p, value in ((e.ln_scale, 1.0), (e.ln_bias, 0.0), (m.b, 0.0),
                     (m.ln_scale, 1.0), (m.ln_bias, 0.0), (m.out_bias, 0.0)):
        const(p, value)
    for blk in model.blocks:
        for p in (blk.qkv_w, blk.out_w, blk.ffn_w1, blk.ffn_w2):
            dense(p)
        for p in (blk.qkv_b, blk.out_b, blk.ffn_b1, blk.ffn_b2, blk.ln1_bias, blk.ln2_bias):
            const(p, 0.0)
        const(blk.ln1_scale, 1.0)
        const(blk.ln2_scale, 1.0)
    return model


@torch.no_grad()
def init_qa_head(generator, cfg: TransformerConfig, *, device="cuda") -> QaHead:
    """Span head: w ~ N(0, 0.02) [D, 2], b = 0."""
    head = QaHead(cfg, device=device)
    head.w.copy_(torch.randn(head.w.shape, generator=_generator(generator)) * 0.02)
    head.b.zero_()
    return head


# ------------------------------------------------------------------ forward


def _index_tensor(x, upper: int, what: str, device) -> torch.Tensor:
    """Integer ids as a long tensor on ``device``, each checked to lie in
    [0, upper). JAX clamps an out-of-range gather; in PyTorch a CPU gather
    raises and a CUDA gather hits a device-side assert that poisons the
    CUDA context, so ids are checked before any gather (on the host where
    they come from the host)."""
    t = torch.as_tensor(x)
    if t.dtype.is_floating_point or t.dtype == torch.bool or t.is_complex():
        raise TypeError(f"{what} ids must be integers, got {t.dtype}")
    if t.numel() and (bool((t < 0).any()) or bool((t >= upper).any())):
        raise ValueError(f"{what} ids must lie in [0, {upper})")
    return t.to(device=device, dtype=torch.long)


def _layer_norm(x, scale, bias, eps=1e-12):
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * scale.float() + bias.float()


def _gelu(x, cfg: TransformerConfig):
    return F.gelu(x, approximate="tanh" if cfg.gelu_approximate else "none")


def _attention(cfg: TransformerConfig, q, k, v, pad_mask):
    if cfg.attn_impl in ("ring", "ulysses") and cfg.sequence_axis:
        # this rank's sequence shard of a model placed on a mesh
        # (place_params); the heads may be tp-split at the same time
        fn = ring_attention if cfg.attn_impl == "ring" else ulysses_attention
        return fn(q, k, v, axis_name=cfg.sequence_axis, causal=cfg.causal, key_mask=pad_mask)
    if cfg.attn_impl in ("ring", "ulysses"):
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} requires sequence_axis (a mesh axis "
            "name) — silently falling back to dense attention would fake "
            "sequence parallelism")
    return dot_product_attention(q, k, v, pad_mask, causal=cfg.causal,
                                 impl=cfg.attn_impl)


def dropout_mask(generator: torch.Generator, keep: float, shape, device) -> torch.Tensor:
    """The keep mask of one dropout: True with probability ``keep``, drawn
    from ``generator`` (which must live on ``device``). The JAX package
    draws ``jax.random.bernoulli`` from its key folded per layer and
    sublayer; the bits differ, so the tests replace this function to hand
    both packages the same masks."""
    return torch.rand(shape, generator=generator, device=device) < keep


def _dropout(x, cfg: TransformerConfig, generator, train: bool):
    """Inverted dropout, ``where(mask, x / keep, 0)``; the identity when not
    training, at ``dropout <= 0`` or without a generator (as in JAX)."""
    if not train or cfg.dropout <= 0.0 or generator is None:
        return x
    keep = 1.0 - cfg.dropout
    return torch.where(dropout_mask(generator, keep, x.shape, x.device), x / keep, 0.0)


def _block(cfg: TransformerConfig, p: Block, h, pad_mask, generator=None,
           train: bool = False, return_kv: bool = False):
    """One transformer layer, h [B,T,D] → [B,T,D] (and its K/V [B,H,T,hd]
    with ``return_kv``). With ``train`` and a generator, dropout follows
    the attention output projection and the FFN, as in JAX."""
    B, T, D = h.shape
    H, hd = cfg.n_heads, cfg.head_dim
    cd = cfg.compute_dtype
    kv: Dict[str, torch.Tensor] = {}

    def attn_sub(x):
        qkv = x @ p.qkv_w.to(cd) + p.qkv_b.to(cd)
        # [B,T,D] -> [B,H,T,hd]: strided views; the kernel takes the strides
        q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2) for t in qkv.split(D, dim=-1))
        if return_kv:
            kv["k"], kv["v"] = k, v
        o = _attention(cfg, q, k, v, pad_mask)
        o = o.transpose(1, 2).reshape(B, T, D)
        return _dropout(o @ p.out_w.to(cd) + p.out_b.to(cd), cfg, generator, train)

    h = _residual(cfg, p, h, attn_sub,
                  lambda x: _dropout(_ffn(cfg, p, x), cfg, generator, train))
    return (h, kv["k"], kv["v"]) if return_kv else h


def _ffn(cfg: TransformerConfig, p: Block, x):
    """The feed-forward sublayer: gelu(x W1 + b1) W2 + b2 in compute dtype."""
    cd = cfg.compute_dtype
    x = _gelu(x @ p.ffn_w1.to(cd) + p.ffn_b1.to(cd), cfg)
    return x @ p.ffn_w2.to(cd) + p.ffn_b2.to(cd)


def _residual(cfg: TransformerConfig, p: Block, h, attn_sub, ffn_sub):
    """One layer's two sublayers around the residual stream h: pre-LN,
    ``h + f(LN(h))`` (GPT-style), or post-LN, ``LN(h + f(h))`` (original
    BERT); sublayers take and return the compute dtype, the stream keeps
    h's dtype."""
    cd = cfg.compute_dtype
    if cfg.norm_position == "pre":
        h = h + attn_sub(_layer_norm(h, p.ln1_scale, p.ln1_bias).to(cd)).to(h.dtype)
        return h + ffn_sub(_layer_norm(h, p.ln2_scale, p.ln2_bias).to(cd)).to(h.dtype)
    h = _layer_norm(h + attn_sub(h.to(cd)).to(h.dtype), p.ln1_scale, p.ln1_bias).to(h.dtype)
    return _layer_norm(h + ffn_sub(h.to(cd)).to(h.dtype), p.ln2_scale, p.ln2_bias).to(h.dtype)


# The functions below come in pairs: ``_embed``/``_encode``/``_mlm_head``/
# ``_qa_forward`` record autograd graphs (the training path), and the
# public names run them under inference_mode (the serving path).


def _embed(params: Transformer, tokens, cfg: TransformerConfig, *, segments=None):
    if params.mesh is not None:
        raise RuntimeError(
            "a model placed on a mesh (place_params) holds this rank's blocks: it trains "
            "through loss_fn / loss_and_grads / make_train_step; gather_params gives the "
            "whole weights for the other entry points")
    e = params.embed
    tokens = _index_tensor(tokens, cfg.vocab_size, "token", e.tok.device)
    T = tokens.shape[-1]
    if T > cfg.max_len:
        raise ValueError(f"sequence of {T} tokens exceeds max_len={cfg.max_len}")
    h = e.tok[tokens] + e.pos[:T][None]
    if segments is not None:
        h = h + e.seg[_index_tensor(segments, cfg.type_vocab, "segment", e.tok.device)]
    elif cfg.type_vocab > 0:
        h = h + e.seg[0]  # BERT semantics: token_type defaults to segment 0
    return _layer_norm(h, e.ln_scale, e.ln_bias).to(cfg.compute_dtype)


@torch.inference_mode()
def embed(params: Transformer, tokens, cfg: TransformerConfig, *, segments=None):
    """Embedding front end: tokens [B,T] → block input [B,T,D] (compute dtype)."""
    return _embed(params, tokens, cfg, segments=segments)


def _mlm_head(params: Transformer, h, cfg: TransformerConfig, *, positions=None):
    m = params.mlm
    cd = cfg.compute_dtype
    if positions is not None:
        pos = _index_tensor(positions, h.shape[1], "position", h.device)
        h = torch.gather(h, 1, pos[..., None].expand(*pos.shape, h.shape[-1]))
    x = _gelu(h.to(cd) @ m.w.to(cd) + m.b.to(cd), cfg)
    x = _layer_norm(x, m.ln_scale, m.ln_bias)
    logits = x.to(cd).float() @ params.embed.tok.to(cd).float().T
    return logits + m.out_bias.float()


@torch.inference_mode()
def mlm_head(params: Transformer, h, cfg: TransformerConfig, *, positions=None):
    """MLM head with the tied output embedding: [B,T,D] → logits [B,T,V]
    float32 (or at ``positions`` [B,P] only → [B,P,V]).

    The tied decoder takes compute-dtype operands with float32 products and
    sums, as the JAX package asks of the TPU: both operands are rounded to
    the compute dtype, then multiplied in float32 (exact for bf16 values;
    TF32 must be off, see ``common.device.set_fp32_numerics``)."""
    return _mlm_head(params, h, cfg, positions=positions)


def _encode(params: Transformer, tokens, cfg: TransformerConfig, *, segments=None,
            pad_mask=None, generator=None, train: bool = False):
    h = _embed(params, tokens, cfg, segments=segments)
    if pad_mask is not None:
        pad_mask = torch.as_tensor(pad_mask, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in params.blocks:
        if remat:
            h = _remat_block(cfg, p, h, pad_mask, generator, train)
        else:
            h = _block(cfg, p, h, pad_mask, generator, train)
    return h


def _remat_block(cfg: TransformerConfig, p: Block, h, pad_mask, generator, train: bool):
    """``_block`` under ``torch.utils.checkpoint``: its activations are not
    kept, and the backward runs the block again to get them (the JAX
    package's ``jax.checkpoint`` per block).

    The recompute must draw the dropout masks of the forward.
    ``checkpoint``'s ``preserve_rng_state`` restores only the default CPU and
    CUDA generators, not the explicit ``generator`` the masks come from; so
    the block's first run notes the generator's state, and the recompute
    sets it back to that state for the block and afterwards returns it to
    where the step had left it (later blocks, and the next step, draw what
    they would draw without remat). No other op of the block draws random
    numbers, so the default generators need no saving."""
    if generator is None:
        return checkpoint(_block, cfg, p, h, pad_mask, None, train,
                          use_reentrant=False, preserve_rng_state=False)
    start = generator.get_state()
    recompute = []

    def run(h):
        if not recompute:  # the forward: draw from where the step is
            recompute.append(True)
            return _block(cfg, p, h, pad_mask, generator, train)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return _block(cfg, p, h, pad_mask, generator, train)
        finally:
            generator.set_state(now)

    return checkpoint(run, h, use_reentrant=False, preserve_rng_state=False)


@torch.inference_mode()
def encode(params: Transformer, tokens, cfg: TransformerConfig, *, segments=None,
           pad_mask=None, generator=None, train: bool = False):
    """Encoder-only forward: tokens [B,T] → hidden states [B,T,D] (no head).
    ``pad_mask`` [B,T]: nonzero = real token. ``train`` with a
    ``generator`` applies dropout (no gradients here: see ``loss_fn``)."""
    return _encode(params, tokens, cfg, segments=segments, pad_mask=pad_mask,
                   generator=generator, train=train)


@torch.inference_mode()
def forward(params: Transformer, tokens, cfg: TransformerConfig, *, segments=None,
            pad_mask=None, generator=None, train: bool = False):
    """tokens [B,T] → logits [B,T,V] (float32)."""
    return _mlm_head(params, _encode(params, tokens, cfg, segments=segments,
                                     pad_mask=pad_mask, generator=generator,
                                     train=train), cfg)


def _qa_forward(params: Transformer, qa_params: QaHead, tokens, cfg: TransformerConfig,
                *, segments=None, pad_mask=None, generator=None, train: bool = False):
    h = _encode(params, tokens, cfg, segments=segments, pad_mask=pad_mask,
                generator=generator, train=train)
    logits = h.float() @ qa_params.w + qa_params.b
    return logits[..., 0], logits[..., 1]


@torch.inference_mode()
def qa_forward(params: Transformer, qa_params: QaHead, tokens, cfg: TransformerConfig,
               *, segments=None, pad_mask=None, generator=None, train: bool = False):
    """→ (start_logits [B,T], end_logits [B,T]) float32."""
    return _qa_forward(params, qa_params, tokens, cfg, segments=segments,
                       pad_mask=pad_mask, generator=generator, train=train)


# ------------------------------------------------------------------ training


def token_ce_loss(logits, labels, weights=None):
    """Weighted token cross-entropy (masked-LM and causal-LM alike), float32:
    sum((logsumexp - gold) * weights) / max(sum(weights), 1)."""
    labels = _index_tensor(labels, logits.shape[-1], "label", logits.device)
    if weights is None:
        weights = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
    else:
        weights = torch.as_tensor(weights, device=logits.device).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return ((logz - gold) * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def loss_fn(params: Transformer, batch, cfg: TransformerConfig, generator=None,
            train: bool = True):
    """Weighted token cross-entropy of the MLM head, with autograd.

    ``batch``: ``tokens`` [B,T], ``labels``, and optional ``weights``,
    ``segments``, ``pad_mask``. With ``mlm_positions`` ([B,P]) the head and
    the loss run only at those positions, and ``labels``/``weights`` are
    [B,P] (the TF-BERT pretraining layout).

    On a model placed on a mesh (:func:`place_params`), ``batch`` is still
    the global batch: this rank computes its rows and sequence positions and
    returns its share of the loss (:func:`_placed_loss`)."""
    if params.mesh is not None:
        return _placed_loss(params, batch, cfg, generator, train)
    h = _encode(params, batch["tokens"], cfg, segments=batch.get("segments"),
                pad_mask=batch.get("pad_mask"), generator=generator, train=train)
    logits = _mlm_head(params, h, cfg, positions=batch.get("mlm_positions"))
    return token_ce_loss(logits, batch["labels"], batch.get("weights"))


def layer_costs(cfg: TransformerConfig, batch: int, seq: int,
                mlm_positions: Optional[int] = None, train: bool = True) -> list:
    """Per-layer cost rows ``{layer, kind, flops, param_bytes,
    activation_bytes}``: the embedding front end, every block and the MLM
    head (the JAX package's ``layer_costs``, the same rows and constants).
    Flops count 2 per multiply-add; ``train=True`` applies the forward +
    backward factor of 3 (the embedding's scatter-add on the backward is
    counted as bytes, not flops). Byte sizes follow the config's parameter
    and compute dtypes."""
    B, T = batch, seq
    D, F_, V, H = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_heads
    P = mlm_positions if mlm_positions is not None else T
    pbytes = cfg.param_dtype.itemsize
    abytes = cfg.compute_dtype.itemsize
    factor = 3.0 if train else 1.0

    # elementwise expansions as XLA's cost model counts them (the JAX
    # package's constants): a numerically stable softmax ~32 flops per
    # score, tanh gelu ~28 per element, a float32 layer norm ~15 per element
    SOFTMAX, GELU, LN = 32.0, 28.0, 15.0
    rows = [{
        "layer": "embed", "kind": "Embedding",
        "flops": (LN * T * D) * B * factor,
        "param_bytes": (V * D + cfg.max_len * D + cfg.type_vocab * D + 2 * D) * pbytes,
        "activation_bytes": B * T * D * abytes,
    }]
    per_block_fwd = (
        2.0 * T * D * 3 * D        # qkv projection
        + 2.0 * T * D * D          # attention output projection
        + 4.0 * T * T * D          # QK^T and AV contractions
        + SOFTMAX * H * T * T      # stable softmax over the scores
        + 2.0 * 2.0 * T * D * F_   # the two FFN matmuls
        + GELU * T * F_            # gelu over the FFN hidden
        + 2.0 * LN * T * D         # the two layer norms
        + 2.0 * T * D)             # residual adds
    block_params = (D * 3 * D + 3 * D + D * D + D
                    + D * F_ + F_ + F_ * D + D + 4 * D) * pbytes
    for i in range(cfg.n_layers):
        rows.append({
            "layer": f"block{i}", "kind": "TransformerBlock",
            "flops": per_block_fwd * B * factor,
            "param_bytes": block_params,
            "activation_bytes": B * T * D * abytes,
        })
    rows.append({
        "layer": "mlm_head", "kind": "MlmHead",
        "flops": (2.0 * P * D * D       # dense projection
                  + GELU * P * D        # gelu on the projection
                  + LN * P * D          # layer norm
                  + 2.0 * P * D * V     # tied-decoder projection
                  + 8.0 * P * V         # token cross-entropy (logsumexp)
                  ) * B * factor,
        "param_bytes": (D * D + D + 2 * D + V) * pbytes,
        "activation_bytes": B * P * V * 4,  # float32 logits
    })
    return rows


def qa_loss_fn(params: Transformer, qa_params: QaHead, batch, cfg: TransformerConfig,
               generator=None, train: bool = True):
    """Mean of the start- and end-position cross-entropies
    (BertForQuestionAnswering). ``batch``: tokens, segments, start_positions
    [B], end_positions [B], optional pad_mask."""
    s_logits, e_logits = _qa_forward(params, qa_params, batch["tokens"], cfg,
                                     segments=batch.get("segments"),
                                     pad_mask=batch.get("pad_mask"),
                                     generator=generator, train=train)

    def ce(logits, pos):
        pos = _index_tensor(pos, logits.shape[-1], "answer position", logits.device)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1, pos[:, None])[:, 0]
        return (logz - gold).mean()

    return 0.5 * (ce(s_logits, batch["start_positions"])
                  + ce(e_logits, batch["end_positions"]))


def _grads(loss, *modules):
    """d loss / d parameter for each module, as {name: tensor} dicts; a
    parameter the loss does not use gets zeros, as ``jax.grad`` gives."""
    named = [list(m.named_parameters()) for m in modules]
    flat = [p for group in named for _, p in group]
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    return [{name: g if g is not None else torch.zeros_like(p)
             for (name, p), g in zip(group, grads)} for group in named]


def loss_and_grads(params: Transformer, batch, cfg: TransformerConfig, generator=None,
                   train: bool = True):
    """``jax.value_and_grad(loss_fn)``: (loss, {name: grad}). Gradients are
    in the parameters' dtype (float32 master parameters give float32
    gradients; autograd through ``.to(compute_dtype)`` casts back)."""
    with torch.enable_grad():
        loss = loss_fn(params, batch, cfg, generator, train)
    (grads,) = _grads(loss, params)
    if params.mesh is not None:  # this rank's share: sum over the ranks of distinct tokens
        return _reduce_placed(params, cfg, loss.detach(), grads)
    return loss.detach(), grads


@torch.no_grad()
def _subtract(module: nn.Module, updates) -> None:
    # p -= u in place (the JAX step returns new arrays)
    for name, p in module.named_parameters():
        p.sub_(updates[name])


def make_train_step(cfg: TransformerConfig, updater):
    """One train step: loss and grads, ``updater.apply``, then p -= u.

    ``step(params, opt_state, batch, iteration, generator=None)`` updates
    ``params`` and ``opt_state`` in place and returns ``(params,
    opt_state, loss)`` with the loss as a float32 scalar tensor on the
    device (reading it waits for the step)."""

    def step(params, opt_state, batch, iteration, generator=None):
        loss, grads = loss_and_grads(params, batch, cfg, generator, True)
        updates, opt_state = updater.apply(grads, opt_state, params, iteration, 0)
        _subtract(params, updates)
        return params, opt_state, loss

    return step


def make_qa_train_step(cfg: TransformerConfig, updater):
    """Fine-tune step over the encoder and the span head jointly: ``step(
    params, qa_params, opt_state, qa_opt_state, batch, iteration,
    generator=None)`` → ``(params, qa_params, opt_state, qa_opt_state,
    loss)``, updating in place as :func:`make_train_step` does."""

    def step(params, qa_params, opt_state, qa_opt_state, batch, iteration, generator=None):
        with torch.enable_grad():
            loss = qa_loss_fn(params, qa_params, batch, cfg, generator, True)
        g_p, g_q = _grads(loss, params, qa_params)
        upd_p, opt_state = updater.apply(g_p, opt_state, params, iteration, 0)
        upd_q, qa_opt_state = updater.apply(g_q, qa_opt_state, qa_params, iteration, 0)
        _subtract(params, upd_p)
        _subtract(qa_params, upd_q)
        return params, qa_params, opt_state, qa_opt_state, loss.detach()

    return step


# ------------------------------------------------------- autoregressive decode
# KV-cache generation for causal configs, mirroring the JAX package: the
# decode step runs over the WHOLE slot pool whatever subset of slots is live
# (inactive slots compute junk into their own free cache rows, which the next
# prefill overwrites), and prompts pad to the power-of-2 bucket ladder. The
# decode math mirrors ``_block``/``mha_reference`` (same dtypes, the same
# -1e30 masking and softmax), so incremental generation gives the tokens of
# repeated full forwards. The decode attention is plain PyTorch, as it is
# plain XLA in the JAX package (no kernel there).


def init_kv_cache(cfg: TransformerConfig, slots: int, max_len: Optional[int] = None,
                  *, device="cuda") -> Dict[str, torch.Tensor]:
    """Per-slot KV cache ``{'k','v'}`` of
    ``[n_layers, slots, max_len, n_heads, head_dim]`` in compute dtype."""
    T = max_len or cfg.max_len
    if T > cfg.max_len:
        raise ValueError(f"kv cache max_len {T} exceeds the model's "
                         f"positional range max_len={cfg.max_len}")
    dev = resolve_device(device)
    shape = (cfg.n_layers, slots, T, cfg.n_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}


@torch.inference_mode()
def prefill_forward(params: Transformer, tokens, cfg: TransformerConfig, *,
                    segments=None, pad_mask=None):
    """Encoder forward that also returns each layer's K/V:
    tokens [B,T] → (hidden [B,T,D], k [L,B,H,T,hd], v [L,B,H,T,hd])."""
    h = embed(params, tokens, cfg, segments=segments)
    if pad_mask is not None:
        pad_mask = torch.as_tensor(pad_mask, device=h.device)
    ks, vs = [], []
    for p in params.blocks:
        h, k, v = _block(cfg, p, h, pad_mask, return_kv=True)
        ks.append(k)
        vs.append(v)
    return h, torch.stack(ks), torch.stack(vs)


def _decode_block(cfg: TransformerConfig, p: Block, h, kc, vc, positions, kv_mask):
    """One layer for a single-token step over the slot pool.

    h [S,D]; kc/vc [S,maxT,H,hd] (this layer's cache, written IN PLACE at
    ``positions`` [S]: the JAX version returns new arrays, here the pool's
    buffers are updated); kv_mask [S,maxT] = attendable keys. Returns h."""
    S, D = h.shape
    H, hd = cfg.n_heads, cfg.head_dim
    cd = cfg.compute_dtype
    scale = 1.0 / math.sqrt(hd)
    rows = torch.arange(S, device=h.device)

    def attn_sub(x):
        qkv = x @ p.qkv_w.to(cd) + p.qkv_b.to(cd)
        q, k, v = (t.reshape(S, H, hd) for t in qkv.split(D, dim=-1))
        kc[rows, positions] = k.to(kc.dtype)
        vc[rows, positions] = v.to(vc.dtype)
        scores = torch.einsum("shd,sthd->sht", q, kc.to(cd)) * scale
        scores = torch.where(kv_mask[:, None, :], scores, _NEG_INF)
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("sht,sthd->shd", w, vc.to(cd)).reshape(S, D)
        return o @ p.out_w.to(cd) + p.out_b.to(cd)

    return _residual(cfg, p, h, attn_sub, lambda x: _ffn(cfg, p, x))


class KvCacheLostError(RuntimeError):
    """A prefill or decode call failed part-way through updating the KV
    cache: every in-flight sequence is lost. The pool has already reset
    itself (zero cache, all slots free), so the next admission works.
    ``all_sequences_lost`` is the duck-typed marker serving code keys on."""

    all_sequences_lost = True


class DecodeSlotPool:
    """Fixed-shape KV-cache slot pool, the continuous-batching substrate.

    ``slots`` sequences share one preallocated cache; ``admit`` prefills a
    prompt (padded to the bucket ladder) into a free slot, ``step``
    advances every live sequence one greedy token over the whole pool, and
    ``release`` frees a slot. Membership can change every step; shapes
    never do.

    The JAX pool counts jit traces (``decode_traces``, ``prefill_traces``)
    to pin one decode signature; PyTorch runs eagerly, so there is no trace
    to count and those counters are gone.

    Single-owner object: one decode loop (or :func:`generate`) calls it.
    """

    def __init__(self, params: Transformer, cfg: TransformerConfig, *, slots: int = 8,
                 max_len: Optional[int] = None, eos_id: Optional[int] = None,
                 min_prompt_bucket: int = 16, device="cuda"):
        if not cfg.causal:
            raise ValueError(
                "autoregressive decode needs a causal config "
                "(TransformerConfig(causal=True)) — a bidirectional encoder "
                "cannot extend a sequence incrementally")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        dev = resolve_device(device)
        if params.device.type != dev.type:
            raise ValueError(f"params live on {params.device}, the pool on {dev}")
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len or cfg.max_len
        self.eos_id = eos_id
        self.min_prompt_bucket = max(1, min_prompt_bucket)
        self.device = params.device
        cache = init_kv_cache(cfg, slots, self.max_len, device=self.device)
        self._kc, self._vc = cache["k"], cache["v"]
        self._positions = np.zeros(slots, np.int64)
        self._tokens = np.zeros(slots, np.int64)
        self._active = np.zeros(slots, bool)
        self._decode_fn = self._decode
        self._prefill_fn = self._prefill

    @torch.inference_mode()
    def _decode(self, tokens: np.ndarray, positions: np.ndarray) -> np.ndarray:
        cfg, params = self.cfg, self.params
        tok = torch.from_numpy(tokens).to(self.device)
        pos = torch.from_numpy(positions).to(self.device)
        e = params.embed
        h = e.tok[tok] + e.pos[pos]
        if cfg.type_vocab > 0:
            h = h + e.seg[0]
        h = _layer_norm(h, e.ln_scale, e.ln_bias).to(cfg.compute_dtype)
        kv_mask = (torch.arange(self._kc.shape[2], device=self.device)[None, :]
                   <= pos[:, None])
        for layer in range(cfg.n_layers):
            h = _decode_block(cfg, params.blocks[layer], h, self._kc[layer],
                              self._vc[layer], pos, kv_mask)
        logits = mlm_head(params, h, cfg)  # [S, V] float32 (tied decoder)
        return logits.argmax(dim=-1).cpu().numpy()

    @torch.inference_mode()
    def _prefill(self, slot: int, tokens: np.ndarray, length: int) -> int:
        h, ks, vs = prefill_forward(self.params, tokens, self.cfg)
        Tb = tokens.shape[1]
        # [L, 1, H, Tb, hd] -> the cache layout [L, Tb, H, hd], in place
        self._kc[:, slot, :Tb] = ks[:, 0].transpose(1, 2).to(self._kc.dtype)
        self._vc[:, slot, :Tb] = vs[:, 0].transpose(1, 2).to(self._vc.dtype)
        last = h[0, length - 1]  # hidden at the LAST REAL prompt position
        logits = mlm_head(self.params, last[None], self.cfg)[0]
        return int(logits.argmax())

    # -- capacity ----------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return self.cfg.vocab_size

    @property
    def free_slots(self) -> int:
        return int(self.slots - self._active.sum())

    @property
    def occupancy(self) -> int:
        return int(self._active.sum())

    def prompt_bucket(self, n: int) -> int:
        return min(self.max_len, bucket_size(n, min_bucket=self.min_prompt_bucket))

    # -- lifecycle ---------------------------------------------------------

    def admit(self, prompt, max_new_tokens: int = 1):
        """Prefill ``prompt`` (1-D int tokens) into a free slot. Returns
        ``(slot, first_token)``. Raises ``RuntimeError`` when no slot is
        free and ``ValueError`` when the prompt (plus its token budget)
        cannot fit the cache or holds an id outside [0, vocab_size)."""
        toks = np.asarray(prompt, np.int64).reshape(-1)
        n = toks.shape[0]
        if n < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if n + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt of {n} tokens + {max_new_tokens} new tokens exceeds "
                f"the {self.max_len}-position KV cache")
        if toks.min() < 0 or toks.max() >= self.cfg.vocab_size:
            raise ValueError(f"token ids must lie in [0, {self.cfg.vocab_size})")
        free = np.flatnonzero(~self._active)
        if free.size == 0:
            raise RuntimeError("no free decode slot")
        slot = int(free[0])
        padded = np.zeros((1, self.prompt_bucket(n)), np.int64)
        padded[0, :n] = toks
        try:
            first = self._prefill_fn(slot, padded, n)
        except Exception as e:
            self._reset_after_failure()
            raise KvCacheLostError(
                f"prefill failed part-way through the in-place KV cache update "
                f"({type(e).__name__}: {e}); cache reset, in-flight sequences "
                f"lost") from e
        self._active[slot] = True
        self._positions[slot] = n  # where the first generated token lands
        self._tokens[slot] = first
        return slot, first

    def step(self):
        """One decode step for EVERY live slot. Returns ``{slot:
        next_token}`` for the live slots; the caller decides retirement
        and calls :meth:`release`."""
        if not self._active.any():
            return {}
        if (self._positions[self._active] >= self.max_len).any():
            raise RuntimeError(
                "a live slot is at the end of its KV cache — the caller "
                "must retire sequences before position reaches max_len")
        try:
            nxt = self._decode_fn(self._tokens.copy(), self._positions.copy())
        except Exception as e:
            self._reset_after_failure()
            raise KvCacheLostError(
                f"decode step failed part-way through the in-place KV cache "
                f"update ({type(e).__name__}: {e}); cache reset, in-flight "
                f"sequences lost") from e
        out = {}
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            out[slot] = int(nxt[slot])
            self._positions[slot] += 1
            self._tokens[slot] = nxt[slot]
        return out

    def _reset_after_failure(self) -> None:
        """Recover from a failed call: the cache is updated in place, so a
        call that failed part-way may have left some layers' rows written
        and others not. Zero the cache and free every slot — the in-flight
        sequences are lost, the pool keeps serving."""
        self._kc.zero_()
        self._vc.zero_()
        self._active[:] = False
        self._positions[:] = 0
        self._tokens[:] = 0

    def release(self, slot: int) -> None:
        """Free a slot (its cache rows become junk a later prefill overwrites)."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self._active[slot] = False
        self._positions[slot] = 0
        self._tokens[slot] = 0


def generate(params: Transformer, prompts, max_new_tokens: int, cfg: TransformerConfig,
             *, slots: Optional[int] = None, eos_id: Optional[int] = None,
             max_len: Optional[int] = None, pool=None, draft_params: Optional[Transformer] = None,
             draft_cfg: Optional[TransformerConfig] = None, spec_tokens: int = 4,
             device="cuda"):
    """Greedy batch generation through a decode pool (offline API).

    ``prompts``: 1-D int token sequences (ragged ok). Returns one list of
    generated tokens per prompt, each ending at ``eos_id`` (inclusive) or
    ``max_new_tokens``. Admission is continuous: a finished sequence's slot
    is refilled at once.

    Without ``pool`` a block-paged :class:`PagedDecodeSlotPool` is built on
    ``device`` (which must be where ``params`` live), as in the JAX package;
    pass ``draft_params``/``draft_cfg`` to decode speculatively, with the
    tokens of plain greedy decoding. A dense :class:`DecodeSlotPool` still
    works through ``pool=``; both step protocols (``{slot: tok}`` and
    ``{slot: [toks...]}``) are understood."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    prompts = list(prompts)
    if not prompts:
        return []
    if pool is None:
        T = max_len or cfg.max_len
        # the largest power-of-two block size (<= 16) that divides max_len
        block_T = 16
        while T % block_T:
            block_T //= 2
        # looked up through the module globals first, so that a patched
        # ``transformer.PagedDecodeSlotPool`` is the one built
        pool_cls = globals().get("PagedDecodeSlotPool") or __getattr__("PagedDecodeSlotPool")
        pool = pool_cls(params, cfg, slots=slots or min(8, len(prompts)), eos_id=eos_id,
                        max_len=max_len, block_T=block_T, draft_params=draft_params,
                        draft_cfg=draft_cfg, spec_tokens=spec_tokens, device=device)
    eos = eos_id if eos_id is not None else pool.eos_id
    pending = deque(enumerate(prompts))
    live: Dict[int, list] = {}  # slot -> [prompt index, generated tokens]
    results: Dict[int, list] = {}
    while pending or live:
        while pending and pool.free_slots:
            idx, prompt = pending[0]
            try:
                slot, first = pool.admit(prompt, max_new_tokens)
            except Exception as e:
                # a paged pool can have a free slot and no free blocks: drain
                # the live sequences and retry (with nothing live an empty
                # pool would have admitted it, so re-raise)
                if getattr(e, "retry_admission", False) and live:
                    break
                raise
            pending.popleft()
            if max_new_tokens == 1 or (eos is not None and first == eos):
                results[idx] = [first]
                pool.release(slot)
            else:
                live[slot] = [idx, [first]]
        if not live:
            continue
        for slot, step_toks in pool.step().items():
            if not isinstance(step_toks, (list, tuple)):
                step_toks = (step_toks,)
            idx, toks = live.get(slot, (None, None))
            if idx is None:
                continue
            for tok in step_toks:
                toks.append(tok)
                if len(toks) >= max_new_tokens or (eos is not None and tok == eos):
                    results[idx] = toks
                    pool.release(slot)
                    del live[slot]
                    break
    return [results[i] for i in range(len(prompts))]


_PAGED_EXPORTS = ("BlockAllocator", "NoFreeBlocksError", "PagedDecodeSlotPool")


# ------------------------------------------------ a model placed on a mesh
#
# The flagship on a dp x tp x sp mesh (``parallel.mesh``: axes "dp", "tp"
# and the config's ``sequence_axis``), the JAX package's ``partition_specs``
# and ``batch_specs`` and its shard_map'd step, written out by hand. Each
# rank's module holds its blocks of the parameters (``place_params``) and
# computes its rows (dp) and sequence positions (sp) of the global batch:
#
# - Megatron tensor parallelism over tp: ``qkv_w`` is split by columns but
#   its blocks are contiguous over q|k|v, not grouped by head, so it (and
#   ``qkv_b``) is all-gathered over tp and each rank takes its heads'
#   columns; ``out_w`` and ``ffn_w2`` (rows) and ``ffn_w1`` (columns) line
#   up with Megatron's split as they are, their partial products summed
#   over tp before ``out_b`` / ``ffn_b2`` are added once;
# - the embedding table is vocab-split over tp: a masked local lookup
#   summed over tp, and the tied decoder gives vocab-split logits whose
#   logsumexp and gold logit are reduced over tp;
# - sequence parallelism over sp: ``pos`` rows at the rank's offset, ring or
#   Ulysses attention (``kernels.attention``), and the MLM positions (which
#   index the global sequence) each counted by the rank that owns them;
# - dropout masks drawn at the global shape and sliced.
#
# Each rank's loss is its share of the global loss; ``loss_and_grads`` sums
# the shares and the gradients over the ranks that saw distinct tokens (dp
# and sp), and only over those: a leaf's tp copies compute the same thing.


def partition_specs(cfg: TransformerConfig) -> Dict[str, object]:
    """PartitionSpec tree matching the JAX ``init_params`` tree: Megatron
    splits over ``tp`` (qkv/ffn_w1 by columns, out_w/ffn_w2 by rows, the
    embedding table and the decoder's bias by vocab), the rest whole."""
    from ..parallel.sharding import P

    block = {
        "qkv_w": P(None, "tp"), "qkv_b": P("tp"),
        "out_w": P("tp", None), "out_b": P(),
        "ln1_scale": P(), "ln1_bias": P(),
        "ffn_w1": P(None, "tp"), "ffn_b1": P("tp"),
        "ffn_w2": P("tp", None), "ffn_b2": P(),
        "ln2_scale": P(), "ln2_bias": P(),
    }
    return {
        "embed": {"tok": P("tp", None), "pos": P(), "seg": P(),
                  "ln_scale": P(), "ln_bias": P()},
        "blocks": [dict(block) for _ in range(cfg.n_layers)],
        "mlm": {"w": P(), "b": P(), "ln_scale": P(), "ln_bias": P(), "out_bias": P("tp")},
    }


def batch_specs(cfg: TransformerConfig) -> Dict[str, object]:
    """Input split: batch over dp, sequence over the sequence axis."""
    from ..parallel.sharding import P

    tok = P("dp", cfg.sequence_axis)
    return {"tokens": tok, "segments": tok, "labels": tok, "weights": tok,
            "mlm_positions": P("dp", None), "pad_mask": tok}


def _flat_specs(cfg: TransformerConfig) -> Dict[str, object]:
    """{parameter name (``blocks.3.qkv_w``): spec} of :func:`partition_specs`."""
    specs = partition_specs(cfg)
    out = {f"{top}.{k}": sp for top in ("embed", "mlm") for k, sp in specs[top].items()}
    for i, blk in enumerate(specs["blocks"]):
        out.update({f"blocks.{i}.{k}": sp for k, sp in blk.items()})
    return out


def _present(spec, mesh):
    """``spec`` with the axes the mesh lacks dropped (a whole dim)."""
    from ..parallel.sharding import P

    return P(*(a if a is None or a in mesh.shape else None for a in spec))


@torch.no_grad()
def place_params(tree, cfg: TransformerConfig, mesh, *, device="cuda") -> Transformer:
    """This rank's :class:`Transformer` on ``mesh``: the JAX ``init_params``
    tree (numpy leaves), each leaf cut to the block that
    :func:`partition_specs` gives the rank's mesh coordinates. The model
    trains through ``loss_fn``/``loss_and_grads``/``make_train_step`` on the
    global batch; :func:`gather_params` is the inverse."""
    from ..parallel.sharding import shard_slices
    from .weights import _flatten, _to_tensor

    if "tp" not in mesh.shape or (cfg.sequence_axis and cfg.sequence_axis not in mesh.shape):
        raise ValueError(f"mesh {mesh.shape} lacks the tp axis or the sequence axis "
                         f"{cfg.sequence_axis!r}")
    if cfg.remat:
        raise ValueError("remat on a placed model: recomputing a block would repeat its "
                         "collectives; train the placed model with remat=False")
    specs = _flat_specs(cfg)
    flat = dict(_flatten(tree))
    model = Transformer(cfg, device=device)
    for name, p in model.named_parameters():
        whole = _to_tensor(flat[name])
        block = whole[shard_slices(whole.shape, _present(specs[name], mesh), mesh)]
        p.data = block.to(device=p.device, dtype=p.dtype).contiguous()
    model.mesh = mesh
    return model


@torch.no_grad()
def gather_params(model: Transformer, tensors: Optional[Dict[str, torch.Tensor]] = None):
    """The whole parameters of a placed model (or of ``tensors``, blocks
    keyed by parameter name: its gradients, an updater slot) as the JAX
    ``init_params`` tree of numpy arrays. A collective: every rank of the
    mesh calls it."""
    from ..parallel.partition import gather_leaf

    specs = _flat_specs(model.cfg)
    tensors = dict(model.named_parameters()) if tensors is None else tensors
    out: Dict[str, object] = {"embed": {}, "blocks": [{} for _ in model.blocks], "mlm": {}}
    for name, p in tensors.items():
        whole = gather_leaf(p.detach(), _present(specs[name], model.mesh), model.mesh)
        parts = name.split(".")
        node = out["blocks"][int(parts[1])] if parts[0] == "blocks" else out[parts[0]]
        node[parts[-1]] = whole.float().cpu().numpy()
    return out


def shard_batch(batch, cfg: TransformerConfig, mesh):
    """This rank's part of each array of a global batch, by
    :func:`batch_specs`; with ``mlm_positions``, ``labels`` and ``weights``
    are [B, P] in position space and split over dp only."""
    from ..parallel.sharding import shard_slices

    specs = batch_specs(cfg)
    if batch.get("mlm_positions") is not None:
        specs["labels"] = specs["weights"] = specs["mlm_positions"]
    out = {}
    for key, x in batch.items():
        if x is None:
            out[key] = None
            continue
        shape = tuple(np.shape(x))
        out[key] = x[shard_slices(shape, _present(specs[key], mesh), mesh)]
    return out


def _rows(cfg: TransformerConfig, mesh, positions: bool = False):
    """The mesh axes of distinct tokens (dp, and the sequence axis): the
    ranks whose loss shares and gradients add up. With MLM ``positions``
    the weights are split over dp only."""
    axes = ["dp"] + ([] if positions else [cfg.sequence_axis])
    return tuple(a for a in axes if a and a in mesh.shape)


def _placed_dropout(x, cfg: TransformerConfig, generator, train: bool, mesh, B: int, T: int):
    """``_dropout`` with the mask drawn at the global [B, T, D] and cut to
    this rank's rows and positions."""
    if not train or cfg.dropout <= 0.0 or generator is None:
        return x
    from ..parallel.sharding import P, shard_slices

    keep = 1.0 - cfg.dropout
    shape = (B, T, x.shape[-1])
    mask = dropout_mask(generator, keep, shape, x.device)
    mask = mask[shard_slices(shape, _present(P("dp", cfg.sequence_axis), mesh), mesh)]
    return torch.where(mask, x / keep, 0.0)


def _placed_block(cfg: TransformerConfig, p: Block, h, pad_mask, generator, train, mesh,
                  B: int, T: int):
    """``_block`` on this rank's rows, positions and heads."""
    from ..parallel.collectives import all_gather_grad, copy_to_axis, reduce_from_axis

    b, t, D = h.shape
    tp = mesh.axis_size("tp")
    Hl, hd = cfg.n_heads // tp, cfg.head_dim
    cd = cfg.compute_dtype
    lo = mesh.axis_index("tp") * Hl * hd
    # this rank's heads' columns of q, k and v in the whole [D, 3D] weight
    cols = torch.cat([torch.arange(j * D + lo, j * D + lo + Hl * hd, device=h.device)
                      for j in range(3)])

    def attn_sub(x):
        x = copy_to_axis(x, "tp")
        w = all_gather_grad(p.qkv_w, "tp", axis=1)[:, cols]
        bias = all_gather_grad(p.qkv_b, "tp", axis=0)[cols]
        qkv = x @ w.to(cd) + bias.to(cd)
        q, k, v = (u.reshape(b, t, Hl, hd).transpose(1, 2) for u in qkv.split(Hl * hd, dim=-1))
        o = _attention(cfg, q, k, v, pad_mask).transpose(1, 2).reshape(b, t, Hl * hd)
        o = reduce_from_axis(o @ p.out_w.to(cd), "tp") + p.out_b.to(cd)
        return _placed_dropout(o, cfg, generator, train, mesh, B, T)

    def ffn_sub(x):
        x = copy_to_axis(x, "tp")
        x = _gelu(x @ p.ffn_w1.to(cd) + p.ffn_b1.to(cd), cfg)
        x = reduce_from_axis(x @ p.ffn_w2.to(cd), "tp") + p.ffn_b2.to(cd)
        return _placed_dropout(x, cfg, generator, train, mesh, B, T)

    return _residual(cfg, p, h, attn_sub, ffn_sub)


def _placed_loss(params: Transformer, batch, cfg: TransformerConfig, generator, train: bool):
    """This rank's share of ``loss_fn`` on the global ``batch``: the sum of
    its tokens' (or owned MLM positions') weighted cross-entropy over the
    global weight sum."""
    from ..parallel.collectives import copy_to_axis, pmax, psum, reduce_from_axis
    from ..parallel.mesh import use_mesh

    mesh = params.mesh
    B, T = np.shape(batch["tokens"])
    local = shard_batch(batch, cfg, mesh)
    e, m = params.embed, params.mlm
    dev = e.tok.device
    V = cfg.vocab_size
    Vl = e.tok.shape[0]
    cd = cfg.compute_dtype
    with use_mesh(mesh):
        vlo = mesh.axis_index("tp") * Vl
        tokens = _index_tensor(local["tokens"], V, "token", dev)
        b, t = tokens.shape
        off = mesh.axis_index(cfg.sequence_axis) * t if cfg.sequence_axis else 0
        # vocab-parallel lookup: each tp rank adds its rows of the table
        ids = tokens - vlo
        inside = (ids >= 0) & (ids < Vl)
        h = reduce_from_axis(e.tok[ids.clamp(0, Vl - 1)] * inside[..., None], "tp")
        h = h + e.pos[off:off + t][None]
        if local.get("segments") is not None:
            h = h + e.seg[_index_tensor(local["segments"], cfg.type_vocab, "segment", dev)]
        elif cfg.type_vocab > 0:
            h = h + e.seg[0]
        h = _layer_norm(h, e.ln_scale, e.ln_bias).to(cd)
        pad_mask = local.get("pad_mask")
        if pad_mask is not None:
            pad_mask = torch.as_tensor(pad_mask, device=dev)
        for blk in params.blocks:
            h = _placed_block(cfg, blk, h, pad_mask, generator, train, mesh, B, T)
        positions = local.get("mlm_positions")
        weights = local.get("weights")
        labels = _index_tensor(local["labels"], V, "label", dev)
        weights = (torch.ones(labels.shape, dtype=torch.float32, device=dev) if weights is None
                   else torch.as_tensor(weights, device=dev).float())
        if positions is not None:
            # global positions: this rank counts those in its sequence shard
            pos = _index_tensor(positions, T, "position", dev) - off
            own = (pos >= 0) & (pos < t)
            pos = pos.clamp(0, t - 1)
            h = torch.gather(h, 1, pos[..., None].expand(*pos.shape, h.shape[-1]))
            counted = weights * own
        else:
            counted = weights
        x = _gelu(h.to(cd) @ m.w.to(cd) + m.b.to(cd), cfg)
        x = copy_to_axis(_layer_norm(x, m.ln_scale, m.ln_bias), "tp")
        logits = x.to(cd).float() @ e.tok.to(cd).float().T + m.out_bias.float()
        # vocab-parallel logsumexp and gold logit
        mx = pmax(logits.detach().amax(dim=-1), "tp")
        logz = torch.log(reduce_from_axis(torch.exp(logits - mx[..., None]).sum(-1), "tp")) + mx
        lab = labels - vlo
        hit = (lab >= 0) & (lab < Vl)
        gold = reduce_from_axis(
            torch.gather(logits, -1, lab.clamp(0, Vl - 1)[..., None])[..., 0] * hit, "tp")
        total = psum(weights.sum(), _rows(cfg, mesh, positions is not None))
        return ((logz - gold) * counted).sum() / torch.clamp(total, min=1.0)


def _reduce_placed(params: Transformer, cfg: TransformerConfig, share, grads):
    """(loss, grads) of the global batch from this rank's share and its
    gradients: one all-reduce of the flattened gradients and the share over
    the ranks of distinct tokens."""
    from ..parallel.collectives import psum
    from ..parallel.mesh import use_mesh

    rows = _rows(cfg, params.mesh)
    if params.mesh.axis_size(rows) == 1:
        return share, grads
    names = list(grads)
    buf = torch.cat([grads[n].reshape(-1) for n in names] + [share.float().reshape(1)])
    with use_mesh(params.mesh):
        buf = psum(buf, rows)
    out, off = {}, 0
    for n in names:
        k = grads[n].numel()
        out[n] = buf[off:off + k].view(grads[n].shape).to(grads[n].dtype)
        off += k
    return buf[-1], out


def __getattr__(name):
    # Lazy re-export of the paged pool (PEP 562): paged_decode imports this
    # module's building blocks, so importing it here at the top would be
    # cyclic whenever paged_decode is imported first.
    if name in _PAGED_EXPORTS:
        from . import paged_decode

        return getattr(paged_decode, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
