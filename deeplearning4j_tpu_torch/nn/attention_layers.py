"""Attention layers of a MultiLayerNetwork and the attention vertex of a
ComputationGraph.

Counterpart of ``deeplearning4j_tpu/nn/attention_layers.py`` (DL4J's
``conf.layers.SelfAttentionLayer``/``LearnedSelfAttentionLayer``/
``RecurrentAttentionLayer`` and ``conf.graph.AttentionVertex``). All take
and give the DL4J recurrent layout [B, C, T]. The self-attention layers and
the vertex go through the port's ``kernels.attention.dot_product_attention``:
on a CUDA tensor whose head size the kernels take (16, 32, 64 or 128,
float32 or bf16), its ``auto`` route runs the hand-written flash kernels
forward and backward, and on a CPU tensor the dense path. The features mask
becomes a key mask [B, 1, 1, T]. ``RecurrentAttentionLayer`` attends with
one query per step, in an eager loop over time, and uses no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.attention import dot_product_attention
from . import activations as act
from .conf import LAYER_REGISTRY, InputType, Layer, _mm
from .graph_conf import VERTEX_REGISTRY, GraphVertex
from .weights import init_weights


def _split_heads(x, n_heads):
    """[B, T, H*hd] → [B, H, T, hd]"""
    B, T, D = x.shape
    return x.reshape(B, T, n_heads, D // n_heads).transpose(1, 2)


def _merge_heads(x):
    """[B, H, T, hd] → [B, T, H*hd]"""
    B, H, T, hd = x.shape
    return x.transpose(1, 2).reshape(B, T, H * hd)


def _mha(q, k, v, n_heads, mask=None):
    """Multi-head attention on [B, T, D] inputs (already projected)."""
    o = dot_product_attention(_split_heads(q, n_heads), _split_heads(k, n_heads),
                              _split_heads(v, n_heads), mask)
    return _merge_heads(o)


def _key_mask(mask, x):
    return None if mask is None else torch.as_tensor(mask, device=x.device)[:, None, None, :]


@dataclass
class SelfAttentionLayer(Layer):
    """conf.layers.SelfAttentionLayer: dot-product self-attention over the
    sequence. Input/output [B, nIn, T] / [B, nOut, T].

    ``project_input=True`` (required when n_heads > 1) adds Wq/Wk/Wv
    projections and an output projection Wo; otherwise attention runs
    directly on the input features (nOut == nIn)."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    head_size: int = 0      # default nOut / nHeads
    project_input: bool = True

    def __post_init__(self):
        if self.n_heads > 1 and not self.project_input:
            raise ValueError("n_heads > 1 requires project_input=True")

    def output_type(self, it: InputType) -> InputType:
        n = self.n_out if self.project_input else (self.n_in or it.size)
        return InputType.recurrent(n, it.timeseries_length)

    def has_params(self):
        return self.project_input

    def _dims(self, it):
        n_in = self.n_in or it.size
        head = self.head_size or max(self.n_out // self.n_heads, 1)
        return n_in, head

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        if not self.project_input:
            return {}
        n_in, head = self._dims(it)
        proj = self.n_heads * head
        w = lambda shape, fi, fo: init_weights(generator, shape, fi, fo, self.weight_init, dtype)
        return {"Wq": w((n_in, proj), n_in, proj), "Wk": w((n_in, proj), n_in, proj),
                "Wv": w((n_in, proj), n_in, proj), "Wo": w((proj, self.n_out), proj, self.n_out)}

    def forward(self, params, x, it, *, training, rng=None, mask=None):
        x = self._apply_dropout(x, training, rng)
        h = x.transpose(1, 2)  # [B, T, C]
        m = _key_mask(mask, x)
        if self.project_input:
            o = _mha(_mm(h, params["Wq"]), _mm(h, params["Wk"]), _mm(h, params["Wv"]),
                     self.n_heads, m)
            o = _mm(o, params["Wo"])
        else:
            o = _mha(h, h, h, 1, m)
        return act.get(self.activation)(o).transpose(1, 2)


@dataclass
class LearnedSelfAttentionLayer(SelfAttentionLayer):
    """conf.layers.LearnedSelfAttentionLayer: attention against n_queries
    LEARNED query vectors — pools a variable-length sequence into a fixed
    [B, nOut, nQueries] output."""

    n_queries: int = 1

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, self.n_queries)

    def has_params(self):
        return True

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        n_in, head = self._dims(it)
        proj = self.n_heads * head
        w = lambda shape, fi, fo: init_weights(generator, shape, fi, fo, self.weight_init, dtype)
        p = {"Q": w((self.n_queries, proj), self.n_queries, proj),
             "Wk": w((n_in, proj), n_in, proj), "Wv": w((n_in, proj), n_in, proj),
             "Wo": w((proj, self.n_out), proj, self.n_out)}
        if self.project_input:
            p["Wq"] = w((proj, proj), proj, proj)
        return p

    def forward(self, params, x, it, *, training, rng=None, mask=None):
        x = self._apply_dropout(x, training, rng)
        h = x.transpose(1, 2)                            # [B, T, C]
        q = params["Q"][None].expand(h.shape[0], -1, -1)
        if self.project_input:
            q = _mm(q, params["Wq"])
        o = _mha(q, _mm(h, params["Wk"]), _mm(h, params["Wv"]), self.n_heads,
                 _key_mask(mask, x))
        o = _mm(o, params["Wo"])                         # [B, nQueries, nOut]
        return act.get(self.activation)(o).transpose(1, 2)


@dataclass
class RecurrentAttentionLayer(Layer):
    """conf.layers.RecurrentAttentionLayer: recurrent cell whose step-t input
    is augmented with attention over the WHOLE sequence, queried by the
    previous hidden state:

        attn_t = MHA(query=a_{t-1} Wq, keys=x Wk, values=x Wv)
        a_t    = activation(x_t W + attn_t Wr + b)

    The JAX package's ``lax.scan`` over time is an eager loop here, as
    ``conf._lstm_scan``: the key, value and input projections of all steps
    are one product each before the loop."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    head_size: int = 0
    activation: str = "tanh"
    has_bias: bool = True

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init_params(self, generator, it: InputType, dtype=torch.float32):
        n_in = self.n_in or it.size
        head = self.head_size or max(self.n_out // self.n_heads, 1)
        proj = self.n_heads * head
        w = lambda shape, fi, fo: init_weights(generator, shape, fi, fo, self.weight_init, dtype)
        p = {"W": w((n_in, self.n_out), n_in, self.n_out),
             "Wr": w((proj, self.n_out), proj, self.n_out),
             "Wq": w((self.n_out, proj), self.n_out, proj),
             "Wk": w((n_in, proj), n_in, proj), "Wv": w((n_in, proj), n_in, proj)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=generator.device)
        return p

    def forward(self, params, x, it, *, training, rng=None, mask=None):
        x = self._apply_dropout(x, training, rng)
        h = x.transpose(1, 2)                               # [B, T, C]
        B, T, _ = h.shape
        keys, vals = _mm(h, params["Wk"]), _mm(h, params["Wv"])   # [B, T, P]
        xw = _mm(h, params["W"])                            # [B, T, nOut]
        if self.has_bias:
            xw = xw + params["b"]
        n_heads = self.n_heads
        hd = keys.shape[-1] // n_heads
        kt = _split_heads(keys, n_heads).transpose(2, 3)    # [B, H, hd, T]
        vh = _split_heads(vals, n_heads)                    # [B, H, T, hd]
        scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=h.dtype, device=h.device))
        live = None if mask is None else (_key_mask(mask, x)[:, :, 0] > 0)   # [B, 1, T]
        fn = act.get(self.activation)
        a = torch.zeros((B, self.n_out), dtype=xw.dtype, device=h.device)
        outs = []
        for t in range(T):
            q = _mm(a, params["Wq"]).reshape(B, n_heads, 1, hd)
            logits = (q @ kt)[:, :, 0] * scale              # [B, H, T]
            if live is not None:
                logits = torch.where(live, logits, torch.full_like(logits, -1e30))
            w = torch.softmax(logits, dim=-1)
            attn = (w[:, :, None] @ vh).reshape(B, n_heads * hd)
            a = fn(xw[:, t] + _mm(attn, params["Wr"]))
            outs.append(a)
        return torch.stack(outs, dim=2)                     # [B, nOut, T]


@dataclass
class AttentionVertex(GraphVertex):
    """conf.graph.AttentionVertex: multi-head dot-product attention as a
    graph vertex. Inputs: (queries, keys, values), or one input used for
    all three (self-attention); activations [B, C, T], C = ``n_in`` for
    each. The graph draws its Wq/Wk/Wv/Wo (as ``SelfAttentionLayer``'s)
    with ``init_params``; a cross-attention call (Tq != Tk) is non-causal."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    head_size: int = 0
    weight_init: str = "xavier"

    def init_params(self, generator, dtype=torch.float32):
        head = self.head_size or max(self.n_out // self.n_heads, 1)
        proj = self.n_heads * head
        n_in = self.n_in
        w = lambda shape, fi, fo: init_weights(generator, shape, fi, fo, self.weight_init, dtype)
        return {"Wq": w((n_in, proj), n_in, proj), "Wk": w((n_in, proj), n_in, proj),
                "Wv": w((n_in, proj), n_in, proj), "Wo": w((proj, self.n_out), proj, self.n_out)}

    def apply(self, inputs, params=None):
        if params is None:
            raise ValueError("AttentionVertex needs params (graph must init them)")
        qs = inputs[0].transpose(1, 2)
        ks = inputs[1 if len(inputs) > 1 else 0].transpose(1, 2)
        vs = inputs[2 if len(inputs) > 2 else 0].transpose(1, 2)
        o = _mha(_mm(qs, params["Wq"]), _mm(ks, params["Wk"]), _mm(vs, params["Wv"]),
                 self.n_heads)
        return _mm(o, params["Wo"]).transpose(1, 2)

    def output_type(self, its):
        return InputType.recurrent(self.n_out, its[0].timeseries_length)


for _cls in (SelfAttentionLayer, LearnedSelfAttentionLayer, RecurrentAttentionLayer):
    LAYER_REGISTRY[_cls.__name__] = _cls
VERTEX_REGISTRY[AttentionVertex.__name__] = AttentionVertex
