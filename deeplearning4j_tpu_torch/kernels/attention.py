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

``flash_attention`` runs the CUDA kernels for CUDA tensors and their plain
PyTorch versions for CPU tensors: the forward ``csrc/flash_fwd.cu``
(replacing the TPU's ``_flash_kernel``) and, through a
``torch.autograd.Function``, the two backward kernels of
``csrc/flash_bwd.cu`` (replacing ``_flash_bwd_dq_kernel``, which here also
computes ``delta = rowsum(dO * out)``, and ``_flash_bwd_dkv_kernel``), all
with tensor-core products: bfloat16 operands, and for float32 split TF32
operands (3xTF32: each product to about 2^-21 of its value, within the
float32 bounds the kernels are held to). A CUDA tensor gets the kernels or
an exception; nothing falls back: ``dot_product_attention(impl="auto")``
decides before any launch, by :func:`flash_takes`, whether a call goes to
the kernels or to the dense path. The kernels need no pad shim: they mask
the ragged last tile themselves.

Rows with no live key. The forward gives such a row the uniform softmax
over the Tk keys (out = mean of v) and lse = -1e30 + log Tk, which is -1e30
in float32. Its gradient is that of ``mha_reference``: dq = 0, nothing
flows to dk, and dv gains dO / Tk on every key. The JAX package's flash
backward recomputes P = exp(-1e30 - lse) = 1 for such a row and is wrong
there unless its pad shim zeroes dO; here both backward versions detect
the row by ``lse <= -1e29`` (no live row comes near) and apply the rule.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

_NEG_INF = -1e30
# a row's lse at or below this means the row had no live key (see above)
DEAD_ROW_LSE = -1e29
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
    attend. Causal rows align to the end of the keys (``Tk - Tq``). Masked
    scores are -1e30, or the dtype's lowest finite value where -1e30 does
    not fit (float16): a row with no live key stays a uniform softmax."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    fill = max(_NEG_INF, torch.finfo(scores.dtype).min)
    if causal:
        Tq, Tk = scores.shape[-2], scores.shape[-1]
        qpos = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
        cmask = qpos >= torch.arange(Tk, device=q.device)[None, :]
        scores = torch.where(cmask, scores, fill)
    if mask is not None:
        mask = torch.as_tensor(mask, device=q.device)
        if mask.dim() == 2:
            mask = mask[:, None, None, :]
        scores = torch.where(mask.to(torch.bool), scores, fill)
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
    for k0 in range(0, Tk, REFERENCE_BLOCK_K):
        kt = kf[:, :, k0:k0 + REFERENCE_BLOCK_K]
        vt = vf[:, :, k0:k0 + REFERENCE_BLOCK_K]
        s = _tile_scores(qf, kt, k0, qseg, kseg, causal, scale, q_offset)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vt)
        m = m_new
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _tile_scores(qf, kt, k0, qseg, kseg, causal, scale, q_offset):
    """float32 scores [B,H,Tq,bk] of q against the key tile that starts at
    ``k0``, masked to -1e30 (causal, segment ids)."""
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * scale
    if causal:
        qpos = q_offset + torch.arange(qf.shape[2], device=qf.device)[:, None]
        kpos = k0 + torch.arange(kt.shape[2], device=qf.device)[None, :]
        s = torch.where(qpos >= kpos, s, _NEG_INF)
    if qseg is not None:
        same = qseg[:, :, None] == kseg[:, None, k0:k0 + kt.shape[2]]
        s = torch.where(same[:, None], s, _NEG_INF)
    return s


def flash_backward_delta(out, do) -> torch.Tensor:
    """delta = rowsum(dO * O), [B,H,Tq] float32. The JAX package computes it
    in XLA before its backward kernels (attention.py:312); here the dq
    kernel computes it (:func:`flash_backward_dq`) and this is its plain
    version."""
    return (do.float() * out.float()).sum(dim=-1).contiguous()


def _bwd_tile(qf, dof, kt, vt, k0, lse, delta, qseg, kseg, causal, scale, q_offset):
    """(P, dS) of one key tile, float32 [B,H,Tq,bk]: P = exp(S - lse)
    recomputed from the saved lse (0 on rows with no live key) and
    dS = P * (dO V^T - delta) * scale."""
    s = _tile_scores(qf, kt, k0, qseg, kseg, causal, scale, q_offset)
    p = torch.where(lse[..., None] <= DEAD_ROW_LSE, 0.0, torch.exp(s - lse[..., None]))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vt)
    return p, p * (dp - delta[..., None]) * scale


def flash_backward_dkv_reference(q, k, v, do, lse, delta, qseg, kseg, causal: bool,
                                 scale: float, q_offset: int):
    """Plain PyTorch version of the dk/dv kernel: for each 64-key tile,
    dV = P^T dO and dK = dS^T Q over all query rows, in float32. A row with
    no live key adds dO / Tk to dV on every key and nothing to dK. Returns
    (dk, dv) in k's and v's dtypes."""
    Tk = k.shape[2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    dead = (lse <= DEAD_ROW_LSE)[..., None]
    dead_dv = torch.where(dead, dof, 0.0).sum(dim=2, keepdim=True) / Tk
    for k0 in range(0, Tk, REFERENCE_BLOCK_K):
        k1 = min(Tk, k0 + REFERENCE_BLOCK_K)
        p, ds = _bwd_tile(qf, dof, kf[:, :, k0:k1], vf[:, :, k0:k1], k0, lse, delta,
                          qseg, kseg, causal, scale, q_offset)
        dv[:, :, k0:k1] = torch.einsum("bhqk,bhqd->bhkd", p, dof) + dead_dv
        dk[:, :, k0:k1] = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_dq_reference(q, k, v, out, do, lse, qseg, kseg, causal: bool,
                                scale: float, q_offset: int):
    """Plain PyTorch version of the dq kernel: delta = rowsum(dO * O), then
    dQ = sum over 64-key tiles of dS K, in float32 (0 on rows with no live
    key). Returns (dq in q's dtype, delta [B,H,Tq] float32), delta being what
    the dk/dv half takes."""
    delta = flash_backward_delta(out, do)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq = torch.zeros_like(qf)
    for k0 in range(0, k.shape[2], REFERENCE_BLOCK_K):
        kt = kf[:, :, k0:k0 + REFERENCE_BLOCK_K]
        _, ds = _bwd_tile(qf, dof, kt, vf[:, :, k0:k0 + REFERENCE_BLOCK_K], k0, lse, delta,
                          qseg, kseg, causal, scale, q_offset)
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kt)
    return dq.to(q.dtype), delta


def flash_backward_reference(q, k, v, out, lse, do, qseg, kseg, causal: bool,
                             scale: float, q_offset: int):
    """Plain PyTorch version of the flash backward (both kernels): the
    gradients (dq, dk, dv) of ``out`` for the upstream gradient ``do``, from
    the forward's ``out`` and ``lse``, in the inputs' dtypes."""
    rest = (qseg, kseg, causal, scale, q_offset)
    dq, delta = flash_backward_dq_reference(q, k, v, out, do, lse, *rest)
    return (dq, *flash_backward_dkv_reference(q, k, v, do, lse, delta, *rest))


_kernel_fns = {}


def _kernel_fn(stem: str, name: str, n_ptrs: int, n_strides: int):
    """The ctypes binding of ``name`` in ``csrc/<stem>.cu`` (built at first
    use), whose arguments are ``n_ptrs`` pointers, B, H, Tq, Tk, D, dtype,
    ``n_strides`` element strides, causal, scale, q_offset and the stream;
    and that library's error-string function."""
    key = (stem, name)
    if key not in _kernel_fns:
        _kernel_fns[key] = bind_kernel(_build.library(stem), name, n_ptrs, n_strides)
    return _kernel_fns[key]


def bind_kernel(lib: ctypes.CDLL, name: str, n_ptrs: int, n_strides: int):
    """(function, error-string function) of ``name`` in a loaded kernel
    library, with the argument types described in :func:`_kernel_fn`."""
    fn = getattr(lib, name)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * n_ptrs + [i32] * 6 + [i64] * n_strides
                   + [i32, ctypes.c_float, i32, ptr])
    fn.restype = i32
    lib.tdl_cuda_error_string.argtypes = [i32]
    lib.tdl_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.tdl_cuda_error_string


def _unmet_contract(name: str, q, k, v, more=()):
    """The kernels' input contract, decided from dtypes and shapes alone:
    one dtype, float32 or bfloat16 (``more`` are further tensors typed like
    q); [B, H, T, D] with D in ``KERNEL_HEAD_DIMS``, Tq, Tk >= 1 and
    B*H <= 65535 (the grid's second axis). Returns the exception that a
    call failing it raises, or None."""
    dtypes = [t.dtype for t in (q, k, v, *more)]
    if q.dtype not in _KERNEL_DTYPES or any(d != q.dtype for d in dtypes):
        return TypeError(f"{name} takes float32 or bfloat16 q/k/v of one dtype; "
                         f"got {', '.join(str(d) for d in dtypes)}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return ValueError(f"{name} takes q/k/v of shape [B, H, T, D]")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        return ValueError(f"head dim {D} not supported by the kernel "
                          f"(one of {KERNEL_HEAD_DIMS})")
    if Tq < 1 or Tk < 1 or B * H > 65535:
        return ValueError(f"{name} needs Tq, Tk >= 1 and B*H <= 65535; "
                          f"got Tq={Tq}, Tk={Tk}, B*H={B * H}")
    return None


def flash_takes(q, k, v) -> bool:
    """Whether the flash kernels take q/k/v of these dtypes and shapes
    (:func:`_unmet_contract`); :func:`_check_kernel_inputs` raises for a
    call that they do not take."""
    return _unmet_contract("flash_attention", q, k, v) is None


def _check_kernel_inputs(name: str, q, k, v, qseg, kseg, more=()):
    """The checks every attention kernel's wrapper makes; ``more`` are
    further tensors shaped and typed like q (the backward's out and dO).
    Returns (B, H, Tq, Tk, D)."""
    if (qseg is None) != (kseg is None):
        raise ValueError("qseg and kseg come together")
    tensors = [q, k, v, *more] + ([qseg, kseg] if qseg is not None else [])
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    err = _unmet_contract(name, q, k, v, more)
    if err is not None:
        raise err
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if tuple(k.shape) != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if any(t.shape != q.shape for t in more):
        raise ValueError(f"{name}: the forward's output and the upstream gradient must "
                         f"be shaped like q {tuple(q.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v, *more)):
        raise ValueError(f"{name} needs q/k/v with a contiguous last axis")
    if qseg is not None:
        if qseg.dtype != torch.int32 or kseg.dtype != torch.int32:
            raise TypeError("segment ids must be int32")
        if tuple(qseg.shape) != (B, Tq) or tuple(kseg.shape) != (B, Tk):
            raise ValueError(f"segment ids must be [B,Tq]/[B,Tk]; got "
                             f"{tuple(qseg.shape)}/{tuple(kseg.shape)}")
        if not (qseg.is_contiguous() and kseg.is_contiguous()):
            raise ValueError("segment ids must be contiguous")
    return B, H, Tq, Tk, D


def _launch(stem: str, name: str, pointers, strided, shape, dtype, causal, scale,
            q_offset, device) -> None:
    """Call ``name`` of ``csrc/<stem>.cu`` on the current stream with the
    pointers, then B, H, Tq, Tk, D and the dtype code, then the (b, h, t)
    strides of each tensor of ``strided``; raises if the launch fails."""
    strides = [s for t in strided for s in (t.stride(0), t.stride(1), t.stride(2))]
    fn, err_str = _kernel_fn(stem, name, len(pointers), len(strides))
    # the launch goes to the current device's context: switch only if needed
    on_current = device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if on_current else torch.cuda.device(device):
        rc = fn(*pointers, *shape, _KERNEL_DTYPES[dtype], *strides, int(bool(causal)),
                float(scale), int(q_offset), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err_str(rc).decode()} ({rc})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def rows_16_byte_aligned(ptr: int, strides, element_size: int) -> bool:
    """Whether every row of a [B, H, T, D] tensor with data pointer ``ptr``,
    element strides ``strides`` of its b/h/t axes and a contiguous last axis
    starts on a 16-byte boundary: the kernels copy rows into shared memory
    16 bytes at a time (cp.async), which needs the pointer and each stride,
    in bytes, to be multiples of 16."""
    return ptr % 16 == 0 and all(s * element_size % 16 == 0 for s in strides)


def _check_rows_aligned(name: str, **tensors) -> None:
    for arg, t in tensors.items():
        # a stride of an axis of size 1 never moves the address
        strides = [t.stride(i) for i in range(3) if t.shape[i] > 1]
        if not rows_16_byte_aligned(t.data_ptr(), strides, t.element_size()):
            raise ValueError(
                f"{name}: {str(t.dtype).split('.')[-1]} {arg} must start every row on a "
                f"16-byte boundary "
                f"(data pointer {t.data_ptr():#x}, b/h/t strides {tuple(t.stride()[:3])} "
                f"elements); pass a contiguous tensor")


def flash_forward(q, k, v, qseg, kseg, causal: bool, scale: float,
                  q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA flash forward kernel (``csrc/flash_fwd.cu``).

    Same arguments and results as :func:`flash_forward_reference`, for CUDA
    tensors only: float32 or bfloat16 q/k/v on one device with a contiguous
    last axis (other strides are passed to the kernel), head dim in
    ``KERNEL_HEAD_DIMS``; every row 16-byte aligned
    (:func:`rows_16_byte_aligned`; views of the fused QKV projection are).
    Raises on anything else, and when the launch fails; it never copies.
    ``flash_forward.launches`` counts the launches."""
    B, H, Tq, Tk, D = _check_kernel_inputs("flash_forward", q, k, v, qseg, kseg)
    _check_rows_aligned("flash_forward", q=q, k=k, v=v)
    out = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "tdl_flash_fwd",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(qseg), _ptr(kseg),
             out.data_ptr(), lse.data_ptr()],
            (q, k, v), (B, H, Tq, Tk, D), q.dtype, causal, scale, q_offset, q.device)
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def _check_row_stats(q, B, H, Tq, **stats):
    for name, t in stats.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, Tq)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous float32 [B,H,Tq] tensor on "
                             f"the inputs' device; got {t.dtype} {tuple(t.shape)}")


def flash_backward_dkv(q, k, v, do, lse, delta, qseg, kseg, causal: bool,
                       scale: float, q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA dk/dv kernel (``csrc/flash_bwd.cu``, replacing the
    TPU's ``_flash_bwd_dkv_kernel``). Same arguments and results as
    :func:`flash_backward_dkv_reference`, for CUDA tensors only (checked as
    in :func:`flash_forward`; ``do`` like q, ``lse``/``delta`` contiguous
    float32 [B,H,Tq]; every row of q, k, v and ``do`` 16-byte aligned).
    ``flash_backward_dkv.launches`` counts the launches."""
    B, H, Tq, Tk, D = _check_kernel_inputs("flash_backward_dkv", q, k, v, qseg, kseg, (do,))
    _check_row_stats(q, B, H, Tq, lse=lse, delta=delta)
    _check_rows_aligned("flash_backward_dkv", q=q, k=k, v=v, do=do)
    dk = torch.empty((B, H, Tk, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, H, Tk, D), dtype=v.dtype, device=v.device)
    _launch("flash_bwd", "tdl_flash_bwd_dkv",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), _ptr(qseg), _ptr(kseg), dk.data_ptr(), dv.data_ptr()],
            (q, k, v, do), (B, H, Tq, Tk, D), q.dtype, causal, scale, q_offset, q.device)
    flash_backward_dkv.launches += 1
    return dk, dv


flash_backward_dkv.launches = 0


def flash_backward_dq(q, k, v, out, do, lse, qseg, kseg, causal: bool,
                      scale: float, q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA dq kernel (``csrc/flash_bwd.cu``, replacing the TPU's
    ``_flash_bwd_dq_kernel``), which also computes delta = rowsum(dO * O)
    for the dk/dv kernel. Same arguments and results (dq, delta) as
    :func:`flash_backward_dq_reference`, for CUDA tensors only (checked as
    in :func:`flash_backward_dkv`; ``out`` like q). ``flash_backward_dq.
    launches`` counts the launches."""
    B, H, Tq, Tk, D = _check_kernel_inputs("flash_backward_dq", q, k, v, qseg, kseg,
                                           (out, do))
    _check_row_stats(q, B, H, Tq, lse=lse)
    _check_rows_aligned("flash_backward_dq", q=q, k=k, v=v, out=out, do=do)
    dq = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    _launch("flash_bwd", "tdl_flash_bwd_dq",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), _ptr(qseg), _ptr(kseg), dq.data_ptr()],
            (q, k, v, out, do), (B, H, Tq, Tk, D), q.dtype, causal, scale, q_offset, q.device)
    flash_backward_dq.launches += 1
    return dq, delta


flash_backward_dq.launches = 0


def flash_backward(q, k, v, out, lse, do, qseg, kseg, causal: bool, scale: float,
                   q_offset: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward on the card: the dq kernel, which also computes
    delta, then the dk/dv kernel with that delta, on the current stream.
    Same arguments and results as :func:`flash_backward_reference`.
    Neither kernel uses atomics, so the gradients are the same bits from run
    to run."""
    rest = (qseg, kseg, causal, scale, q_offset)
    dq, delta = flash_backward_dq(q, k, v, out, do, lse, *rest)
    return (dq, *flash_backward_dkv(q, k, v, do, lse, delta, *rest))


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its backward, the counterpart of the JAX
    package's ``custom_vjp`` (attention.py:179-189, :403). ``apply(q, k, v,
    qseg, kseg, causal, scale, q_offset)`` returns (out, lse); lse carries
    no gradient. CUDA tensors go through the kernels, CPU tensors through
    the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, causal, scale, q_offset):
        fwd = flash_forward if q.is_cuda else flash_forward_reference
        out, lse = fwd(q, k, v, qseg, kseg, causal, scale, q_offset)
        ctx.save_for_backward(q, k, v, out, lse, qseg, kseg)
        ctx.attrs = (causal, scale, q_offset)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _lse_grad):
        q, k, v, out, lse, qseg, kseg = ctx.saved_tensors
        if do.stride(-1) != 1:  # e.g. the expanded gradient of a sum
            do = do.contiguous()
        bwd = flash_backward if q.is_cuda else flash_backward_reference
        dq, dk, dv = bwd(q, k, v, out, lse, do, qseg, kseg, *ctx.attrs)
        return dq, dk, dv, None, None, None, None, None


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
    """Flash attention: O(T) memory both ways, no [Tq, Tk] matrix in memory.

    ``mask``: key padding mask [B, Tk] (or [B,1,1,Tk]), nonzero = attend.
    ``segment_ids``: int32 [B, T] (or a (qseg, kseg) pair) restricting
    attention to equal ids; negative ids raise. Both compose: padded keys
    get id -1. Causal rows align to the end of the keys (``q_offset = Tk -
    Tq``). A row with no live key gets the uniform softmax over the
    original keys. ``return_lse=True`` also returns the per-row logsumexp
    [B, H, Tq] in float32.

    Differentiable in q, k and v (:class:`FlashAttentionFunction`). CUDA
    tensors go through the CUDA kernels (:func:`flash_forward`, and
    :func:`flash_backward` for the gradients), CPU tensors through their
    plain versions."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q/k/v of shape [B, H, T, D]")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qseg, kseg = attention_segments(mask, segment_ids, B, Tq, Tk, q.device)
    if q.is_cuda:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out, lse = FlashAttentionFunction.apply(q, k, v, qseg, kseg, causal, scale, Tk - Tq)
    return (out, lse) if return_lse else out


def dot_product_attention(q, k, v, mask=None, *, causal: bool = False,
                          scale: Optional[float] = None, impl: str = "auto"):
    """Front door used by the transformer. ``impl``: auto | xla | flash.

    ``xla`` is :func:`mha_reference` (the JAX package's name for the dense
    path), ``flash`` is :func:`flash_attention`. ``auto`` takes flash for
    CUDA tensors whenever the mask is None or a key padding mask and the
    kernels take the call (:func:`flash_takes`), at every length; it takes
    the dense path for CPU tensors, for a full per-query [B,1,Tq,Tk] mask,
    and for a head dim or dtype the kernels are not built for, which is what
    the JAX package's ``auto`` returns for such calls. This is routing
    before any launch: ``impl="flash"`` still raises for them."""
    if impl == "flash":
        return flash_attention(q, k, v, mask, causal=causal, scale=scale)
    if impl == "xla":
        return mha_reference(q, k, v, mask, causal=causal, scale=scale)
    if impl == "auto":
        if mask is not None:
            mask = torch.as_tensor(mask, device=q.device)
        if (q.is_cuda and flash_takes(q, k, v)
                and (mask is None or _as_key_mask(mask) is not None)):
            return flash_attention(q, k, v, mask, causal=causal, scale=scale)
        return mha_reference(q, k, v, mask, causal=causal, scale=scale)
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"impl={impl!r}: sequence-parallel attention is not ported yet "
            "(ROADMAP.md, 'Modules still to port': distribution, ring and "
            "Ulysses attention)")
    raise ValueError(f"unknown attention impl {impl!r} (auto, xla or flash)")
