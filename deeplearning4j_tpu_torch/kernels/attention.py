"""Attention: dense reference, and flash attention with a hand-written
CUDA forward kernel.

Counterpart of ``deeplearning4j_tpu/kernels/attention.py``. Layout is the
same: q/k/v are [B, H, T, D].

Masking model (as in the JAX package): key padding masks and segment masks
are one mechanism, per-position int32 segment ids — query i attends to key
j iff ``qseg[i] == kseg[j]``. A key padding mask turns padded keys into
``kseg = -1`` against an all-zero ``qseg``. Masked scores are the finite
``-1e30``, never ``-inf``, so a row with no live key gets a uniform softmax
over the original keys and no NaN ever appears.

One deliberate difference from the JAX package: user segment ids must be
non-negative. There, negative ids collide with the -1/-2 sentinels of its
pad shim; here they raise ``ValueError``.

``flash_attention`` runs the CUDA kernel (``csrc/flash_fwd.cu``, replacing
the TPU's ``_flash_kernel``) for CUDA tensors and its plain PyTorch version
``flash_forward_reference`` for CPU tensors. A CUDA tensor gets the kernel
or an exception; nothing falls back. The kernel needs no pad shim: it masks
the ragged last tile itself. There is no backward yet (training is the next
slice), so these functions are for inference.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

_NEG_INF = -1e30
# key-tile width of the plain blockwise version (the kernel's is the same)
REFERENCE_BLOCK_K = 64
# head dims the CUDA kernel is compiled for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mha_reference(q, k, v, mask=None, *, causal: bool = False,
                  scale: Optional[float] = None):
    """Dense attention, softmax(q k^T * scale) v with the whole
    [B, H, Tq, Tk] score matrix, in the inputs' dtype.

    ``mask``: [B, Tk] or [B, 1, Tq, Tk] (or broadcastable), nonzero =
    attend. Causal rows align to the end of the keys (``Tk - Tq``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        Tq, Tk = scores.shape[-2], scores.shape[-1]
        qpos = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
        cmask = qpos >= torch.arange(Tk, device=q.device)[None, :]
        scores = torch.where(cmask, scores, _NEG_INF)
    if mask is not None:
        mask = torch.as_tensor(mask, device=q.device)
        if mask.dim() == 2:
            mask = mask[:, None, None, :]
        scores = torch.where(mask.to(torch.bool), scores, _NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def _as_key_mask(mask):
    """A mask in key-padding form [B, Tk], or None if it is not one.

    Takes [B, Tk] and the broadcast form [B, 1, 1, Tk]; a full [B,1,Tq,Tk]
    score mask has per-query structure that segment ids cannot express."""
    if mask is None:
        return None
    if mask.dim() == 2:
        return mask
    if mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        return mask[:, 0, 0, :]
    return None


def flash_forward_reference(q, k, v, qseg, kseg, causal: bool, scale: float,
                            q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash forward kernel: the same function,
    blockwise over k-tiles with an online softmax in float32.

    q [B,H,Tq,D], k/v [B,H,Tk,D]; qseg [B,Tq] and kseg [B,Tk] int32 or both
    None. Returns (out [B,H,Tq,D] in q's dtype, lse [B,H,Tq] float32). A row
    with no live key comes out as the mean of v over the Tk keys with
    lse = -1e30 + log Tk, which is -1e30 in float32."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, H, Tq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    qpos = q_offset + torch.arange(Tq, device=q.device)[:, None]
    for k0 in range(0, Tk, REFERENCE_BLOCK_K):
        kt = kf[:, :, k0:k0 + REFERENCE_BLOCK_K]
        vt = vf[:, :, k0:k0 + REFERENCE_BLOCK_K]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * scale
        if causal:
            kpos = k0 + torch.arange(kt.shape[2], device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, _NEG_INF)
        if qseg is not None:
            same = qseg[:, :, None] == kseg[:, None, k0:k0 + REFERENCE_BLOCK_K]
            s = torch.where(same[:, None], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vt)
        m = m_new
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


_flash_fn = None


def _flash_kernel_fn():
    global _flash_fn
    if _flash_fn is None:
        lib = _build.library("flash_fwd")
        fn = lib.tdl_flash_fwd
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * 7 + [i32] * 6 + [i64] * 9
                       + [i32, ctypes.c_float, i32, ptr])
        fn.restype = i32
        lib.tdl_cuda_error_string.argtypes = [i32]
        lib.tdl_cuda_error_string.restype = ctypes.c_char_p
        _flash_fn = (fn, lib.tdl_cuda_error_string)
    return _flash_fn


def flash_forward(q, k, v, qseg, kseg, causal: bool, scale: float,
                  q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA flash forward kernel (``csrc/flash_fwd.cu``).

    Same arguments and results as :func:`flash_forward_reference`, for CUDA
    tensors only: float32 or bfloat16 q/k/v on one device with a contiguous
    last axis (other strides are passed to the kernel), head dim in
    ``KERNEL_HEAD_DIMS``. Raises on anything else, and when the launch
    fails. ``flash_forward.launches`` counts the launches."""
    if (qseg is None) != (kseg is None):
        raise ValueError("qseg and kseg come together")
    tensors = [q, k, v] + ([qseg, kseg] if qseg is not None else [])
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash_forward needs every tensor on one CUDA device")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_forward takes float32 or bfloat16 q/k/v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_forward takes q/k/v of shape [B, H, T, D]")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if tuple(k.shape) != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the kernel "
                         f"(one of {KERNEL_HEAD_DIMS})")
    if Tq < 1 or Tk < 1 or B * H > 65535:
        raise ValueError(f"flash_forward needs Tq, Tk >= 1 and B*H <= 65535; "
                         f"got Tq={Tq}, Tk={Tk}, B*H={B * H}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_forward needs q/k/v with a contiguous last axis")
    if qseg is not None:
        if qseg.dtype != torch.int32 or kseg.dtype != torch.int32:
            raise TypeError("segment ids must be int32")
        if tuple(qseg.shape) != (B, Tq) or tuple(kseg.shape) != (B, Tk):
            raise ValueError(f"segment ids must be [B,Tq]/[B,Tk]; got "
                             f"{tuple(qseg.shape)}/{tuple(kseg.shape)}")
        if not (qseg.is_contiguous() and kseg.is_contiguous()):
            raise ValueError("segment ids must be contiguous")
    fn, err_str = _flash_kernel_fn()
    out = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    # the launch goes to the current device's context: switch only if needed
    on_current = q.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if on_current else torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if qseg is None else qseg.data_ptr(),
                None if kseg is None else kseg.data_ptr(),
                out.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, D,
                _KERNEL_DTYPES[q.dtype],
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                int(bool(causal)), float(scale), int(q_offset),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: {err_str(rc).decode()} ({rc})")
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def _segment_ids(segment_ids, B, Tq, Tk, device):
    """(qseg [B,Tq], kseg [B,Tk]) int32 from one [B,T] array or a pair."""
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        qseg, kseg = segment_ids
    else:
        qseg = kseg = segment_ids
    qseg = torch.as_tensor(qseg, device=device).to(torch.int32).contiguous()
    kseg = torch.as_tensor(kseg, device=device).to(torch.int32).contiguous()
    if tuple(qseg.shape) != (B, Tq) or tuple(kseg.shape) != (B, Tk):
        raise ValueError(f"segment ids must be [B,Tq]/[B,Tk] = [{B},{Tq}]/[{B},{Tk}]; "
                         f"got {tuple(qseg.shape)}/{tuple(kseg.shape)}")
    if bool((qseg < 0).any()) or bool((kseg < 0).any()):
        raise ValueError("segment ids must be >= 0 (negative ids are reserved "
                         "for masked keys)")
    return qseg, kseg


def attention_segments(mask, segment_ids, B: int, Tq: int, Tk: int, device):
    """The (qseg [B,Tq], kseg [B,Tk]) int32 pair that the flash forward
    takes for a key padding mask and/or segment ids (both None when neither
    is given): padded keys get id -1, which no query id (>= 0) matches."""
    qseg, kseg = _segment_ids(segment_ids, B, Tq, Tk, device)
    if mask is None:
        return qseg, kseg
    mask = torch.as_tensor(mask, device=device)
    key_mask = _as_key_mask(mask)
    if key_mask is None:
        raise ValueError(f"flash_attention mask must be [B,Tk] or [B,1,1,Tk]; "
                         f"got {tuple(mask.shape)}")
    base = kseg if kseg is not None else torch.zeros((B, Tk), dtype=torch.int32,
                                                     device=device)
    kseg = torch.where(key_mask.to(torch.bool), base, torch.full_like(base, -1))
    if qseg is None:
        qseg = torch.zeros((B, Tq), dtype=torch.int32, device=device)
    return qseg, kseg.contiguous()


def flash_attention(q, k, v, mask=None, *, segment_ids=None, causal: bool = False,
                    scale: Optional[float] = None, return_lse: bool = False):
    """Flash attention forward: O(T) memory, no [Tq, Tk] matrix in memory.

    ``mask``: key padding mask [B, Tk] (or [B,1,1,Tk]), nonzero = attend.
    ``segment_ids``: int32 [B, T] (or a (qseg, kseg) pair) restricting
    attention to equal ids; negative ids raise. Both compose: padded keys
    get id -1. Causal rows align to the end of the keys (``q_offset = Tk -
    Tq``). A row with no live key gets the uniform softmax over the
    original keys. ``return_lse=True`` also returns the per-row logsumexp
    [B, H, Tq] in float32.

    CUDA tensors go through the CUDA kernel (:func:`flash_forward`), CPU
    tensors through :func:`flash_forward_reference`."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q/k/v of shape [B, H, T, D]")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qseg, kseg = attention_segments(mask, segment_ids, B, Tq, Tk, q.device)
    if q.is_cuda:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
        out, lse = flash_forward(q, k, v, qseg, kseg, causal, scale, Tk - Tq)
    else:
        out, lse = flash_forward_reference(q, k, v, qseg, kseg, causal, scale, Tk - Tq)
    return (out, lse) if return_lse else out


def dot_product_attention(q, k, v, mask=None, *, causal: bool = False,
                          scale: Optional[float] = None, impl: str = "auto"):
    """Front door used by the transformer. ``impl``: auto | xla | flash.

    ``xla`` is :func:`mha_reference` (the JAX package's name for the dense
    path), ``flash`` is :func:`flash_attention`. ``auto`` takes flash for
    CUDA tensors whenever the mask is None or a key padding mask, at every
    length, and the dense path for CPU tensors and for a full per-query
    [B,1,Tq,Tk] mask."""
    if impl == "flash":
        return flash_attention(q, k, v, mask, causal=causal, scale=scale)
    if impl == "xla":
        return mha_reference(q, k, v, mask, causal=causal, scale=scale)
    if impl == "auto":
        if mask is not None:
            mask = torch.as_tensor(mask, device=q.device)
        if q.is_cuda and (mask is None or _as_key_mask(mask) is not None):
            return flash_attention(q, k, v, mask, causal=causal, scale=scale)
        return mha_reference(q, k, v, mask, causal=causal, scale=scale)
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"impl={impl!r}: sequence-parallel attention is not ported yet "
            "(ROADMAP.md, 'Modules still to port': distribution, ring and "
            "Ulysses attention)")
    raise ValueError(f"unknown attention impl {impl!r} (auto, xla or flash)")
