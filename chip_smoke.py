#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    (needs one CUDA card and nvcc)

Phases:

1. build every CUDA kernel of ``deeplearning4j_tpu_torch/csrc`` with nvcc,
   and print the registers and spills of each instantiation of the bf16
   kernels (forward, dkv, dq) and of the float32 kernels (the split-TF32
   forward per head dim and q-tile height, the FMA backward pair); no
   forward, and no bf16 backward, may spill at D=64 and D=128;
2. hold each kernel against its plain PyTorch version on the card, over the
   shapes of the main path and the edge cases of the masking model (the
   backward's gradients, and the delta that the dq kernel computes; the
   float32 forward at each of its q-tile heights), and time the kernel, the
   plain version and the nearest PyTorch library call: the bf16 flash
   forward at the serving shape [8,12,128,64], the training shape
   [16,12,128,64] and a causal prefill [1,12,512,64] (also built with 32-
   and 128-row q-tiles, timed in turns against its 64); the float32 forward
   at generation's causal prefills [1,12,T,64] (T = 512, 128, 256, and 512
   with keys past 300 masked) and at the float32 step check's [16,12,128,64]
   beside SDPA in float32 with TF32 off; the two backward kernels, alone and
   as a pair, at the training shape [16,12,128,64] and the causal prefill,
   bf16, and at the training shape in float32;
3. serve BERT-base (12 layers, d 768, vocab 30522, bf16, random weights from
   a seed): ``forward`` on tokens [8, 128], then a ragged key-padding
   request; every request must launch the flash kernel once per layer, and
   the logits must match the dense-attention path;
4. generate with a causal model of BERT-base width through
   ``DecodeSlotPool(slots=4)``: 6 ragged prompts, 16 new tokens each; every
   prefill must go through the kernel, and the tokens must equal those of
   the dense-attention path;
5. train BERT-base (fp32 parameters, bf16 compute, dropout 0) on the
   ``bench.py`` batch: B=16, T=128, 19 sorted MLM positions, Adam(1e-4).
   One float32 step through the kernels must match the dense-attention
   step (loss and every gradient); every step must launch each of the three
   kernels once per layer; 45 steps on one batch must lower a finite loss
   (40 of them timed); a seeded dropout-0.1 step must repeat its loss; one
   QA fine-tune step at [8,128] must be finite and go through the kernels.

The line before the last is a JSON object describing each kernel (launch
counts on the main path, error against the plain version, times and the
card's bound); the last line is ``{"ok": true, "device": {...}}``. Any
failed phase exits non-zero and prints no result. The script imports only
the port (``deeplearning4j_tpu_torch``), never JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# Published peaks of one H100 SXM (dense): HBM bytes/s, and operations/s
# by input type (bf16 on the tensor cores, float32 on the CUDA cores). The
# float32 forward multiplies on the TF32 tensor cores with split operands:
# three TF32 products per float32 product (3xTF32), so its bound is a third
# of the TF32 peak (494.7 TFLOP/s), and kernel / bound never reads below 1.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "3xtf32": 494.7e12 / 3}

# kernel vs plain version on the same CUDA inputs
FP32_ATOL = 2e-5             # float32: only the order of the sums differs
BF16_ULP_REL = 2.0 ** -7     # bf16 out: one bf16 ulp of the value ...
BF16_ATOL = 1e-5             # ... plus float32 reordering near zero
LSE_TOL = 1e-5               # relative, float32 lse
# backward kernels vs plain version: float32 sums of up to 256 terms in
# another order (and expf against torch.exp), so 1e-4 + 1e-4 relative;
# bf16 gradients: one bf16 ulp of the value + 1e-4 near zero
BWD_FP32_ATOL = 1e-4
BWD_FP32_RTOL = 1e-4
BWD_BF16_ATOL = 1e-4
# delta = rowsum(dO * out), computed by the dq kernel, vs the plain version:
# float32 reordering, at worst 2 (D + 1) 2^-24 rowsum|dO * out| (each side's
# sum of D products is off by at most (D + 1) 2^-24 of the sum of |terms|)
DELTA_REL_OF_ABS_SUM = 2.0 ** -24
# train step at float32 compute, flash kernels vs dense attention: the loss
# within 1e-5 relative; each gradient within 1e-3 of its L2 norm (float32
# sums in another order through 12 layers of backward)
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-3
# encoder logits, flash (float32 scores) vs dense path (bf16 scores and
# softmax): both run bf16 matmuls and a bf16 residual stream over 12 layers
ENCODER_LOGIT_ATOL = 0.1
# generation: a token may differ only where the dense path's top-2 logit
# margin is below this (a float32 near-tie that reordering can flip)
TIE_EPS = 1e-4
# spin of the timing queue: ~0.1 s at the H100's clock, longer than the host
# takes to queue the timed runs
SPIN_CYCLES = 200_000_000


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n=30, warmup=5) -> float:
    """Median over ``n`` runs of the device time of ``fn`` (CUDA events).

    The runs are queued behind a spin kernel, so the card is still busy when
    the host has queued them all: the events then time the work on the card
    and not the host's launch cost (a short kernel takes less time on the
    card than its Python wrapper takes on the host)."""
    import torch

    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def wall_ms(fn, n=40, warmup=2) -> list:
    """Host times (ms) of ``n`` calls of ``fn``, each ending in a
    synchronize: request latency as a caller sees it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def spread(times_ms) -> str:
    """Median, and the highest percentile with at least ten samples beyond it."""
    xs = sorted(times_ms)
    n = len(xs)
    text = f"median {statistics.median(xs):.3f} ms"
    if n > 10:
        q = (n - 10) * 100 // n
        text += f", p{q} {xs[max(0, math.ceil(q * n / 100) - 1)]:.3f} ms"
    return text + f" (n={n})"


def device_profile(tag, what, fn, reps=3, top=6):
    """Where a request's time goes: torch.profiler over ``reps`` runs of
    ``fn``; prints the card's busy share of the host's wall time, the
    kernels that take most device time and every flash kernel. The profiler's own host cost makes
    the wall time (and so the idle share) an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    if not device:
        print(f"{tag} {what} profile: device time not measured (no CUDA events)", flush=True)
        return
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    print(f"{tag} {what} profile ({reps} runs): wall {wall_us / reps / 1e3:.3f} ms/run, "
          f"device busy {busy_us / reps / 1e3:.3f} ms/run ({busy_us / wall_us:.1%}), "
          f"{len(device) // reps} device ops/run", flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    # the top kernels, and the port's own kernels wherever they rank
    for rank, (name, us) in enumerate(ranked):
        if rank < top or "flash_" in name:
            print(f"{tag}   {us / reps:9.1f} us/run {us / busy_us:6.1%}  #{rank + 1} "
                  f"{name[:100]}", flush=True)


# ------------------------------------------------------------------ phase 1


def ptxas_kernels(log) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    from nvcc's ``-Xptxas -v`` messages."""
    kernels, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = kernels.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"], current["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return kernels


BF16_KERNELS = ("flash_fwd_bf16_kernel", "flash_bwd_dkv_bf16_kernel", "flash_bwd_dq_bf16_kernel")
# the float32 forward, instantiated per head dim and q-tile row groups (16
# or 32 rows), and the float32 backward pair (FMA), per head dim
F32_FWD_KERNEL = "flash_fwd_f32_kernel"
F32_Q_ROWS = (16, 32)
F32_BWD_KERNELS = ("flash_bwd_dkv_fma_kernel", "flash_bwd_dq_fma_kernel")


def report_bf16_registers(tag, log):
    """Print registers and spills of each instantiation of the bf16 kernels
    (forward, dkv, dq; head dim D, and whether it applies masks); fail if a
    main-path width (D=64, D=128) spills."""
    found = {}
    for name, info in ptxas_kernels(log).items():
        m = re.search(r"(%s)ILi(\d+)ELb([01])E" % "|".join(BF16_KERNELS), name)
        if m:
            found[(m.group(1), int(m.group(2)), m.group(3) == "1")] = info
    want = [(k, d, masked) for k in sorted(BF16_KERNELS) for d in (16, 32, 64, 128)
            for masked in (False, True)]
    check(sorted(found) == want, f"ptxas reported bf16 kernels {sorted(found)}")
    for (kernel, d, masked), info in sorted(found.items()):
        print(f"{tag} ptxas {kernel}<D={d}, masked={masked}>: "
              f"{info.get('registers')} registers, {info.get('spill_stores')} bytes spill "
              f"stores, {info.get('spill_loads')} bytes spill loads", flush=True)
    for (kernel, d, masked), info in found.items():
        if d in (64, 128):
            check(info.get("spill_stores") == 0 and info.get("spill_loads") == 0,
                  f"{kernel}<D={d}, masked={masked}> spills registers: {info}")


def report_f32_registers(tag, log):
    """Print registers and spills of each float32 instantiation (forward
    per head dim and row groups; the FMA backward pair per head dim); fail
    if a D=64 or D=128 forward spills."""
    fwd, bwd = {}, {}
    for name, info in ptxas_kernels(log).items():
        m = re.search(r"%sILi(\d+)ELi(\d+)E" % F32_FWD_KERNEL, name)
        if m:
            fwd[(int(m.group(1)), int(m.group(2)))] = info
        m = re.search(r"(%s)ILi(\d+)EE" % "|".join(F32_BWD_KERNELS), name)
        if m:
            bwd[(m.group(1), int(m.group(2)))] = info
    want = [(d, rows // 16) for d in (16, 32, 64, 128) for rows in F32_Q_ROWS]
    check(sorted(fwd) == want, f"ptxas reported float32 forward kernels {sorted(fwd)}")
    check(sorted(bwd) == [(k, d) for k in sorted(F32_BWD_KERNELS) for d in (16, 32, 64, 128)],
          f"ptxas reported float32 backward kernels {sorted(bwd)}")
    for (d, r), info in sorted(fwd.items()):
        print(f"{tag} ptxas {F32_FWD_KERNEL}<D={d}, rows={16 * r}>: "
              f"{info.get('registers')} registers, {info.get('spill_stores')} bytes spill "
              f"stores, {info.get('spill_loads')} bytes spill loads", flush=True)
        if d in (64, 128):
            check(info.get("spill_stores") == 0 and info.get("spill_loads") == 0,
                  f"{F32_FWD_KERNEL}<D={d}, rows={16 * r}> spills registers: {info}")
    for (kernel, d), info in sorted(bwd.items()):
        print(f"{tag} ptxas {kernel}<D={d}>: {info.get('registers')} registers, "
              f"{info.get('spill_stores')} bytes spill stores, {info.get('spill_loads')} bytes "
              f"spill loads", flush=True)


def f32_q_rows(B, H, Tq) -> int:
    """Rows of the float32 forward's q-tile for a call of this shape, as
    the launch in csrc/flash_fwd.cu picks them (16 or 32)."""
    import ctypes

    from deeplearning4j_tpu_torch.kernels import _build

    fn = _build.library("flash_fwd").tdl_flash_fwd_f32_q_rows
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    rows = fn(B, H, Tq)
    check(rows in (16, 32), f"tdl_flash_fwd_f32_q_rows({B}, {H}, {Tq}) = {rows}")
    return rows


# ------------------------------------------------------------------ phase 2


def _attention_inputs(rs, B, H, Tq, Tk, D, dtype, *, strided):
    """q/k/v on the card; ``strided`` takes them from one [B,T,3*H*D]
    projection as ``_block`` does (non-contiguous [B,H,T,D] views)."""
    import torch

    if strided and Tq == Tk:
        qkv = torch.from_numpy(rs.randn(B, Tq, 3 * H * D).astype(np.float32))
        qkv = qkv.to("cuda", dtype)
        return [t.reshape(B, Tq, H, D).transpose(1, 2) for t in qkv.split(H * D, -1)]
    shapes = [(B, H, Tq, D), (B, H, Tk, D), (B, H, Tk, D)]
    return [torch.from_numpy(rs.randn(*s).astype(np.float32)).to("cuda", dtype)
            for s in shapes]


def _kernel_cases():
    """(name, B, H, Tq, Tk, D, causal, masking) — masking is None, 'pad'
    (random key padding with one fully padded example), 'seg' (four
    segments) or 'seg+pad'."""
    return [
        ("bert_base", 8, 12, 128, 128, 64, False, None),
        ("bert_base_pad", 8, 12, 128, 128, 64, False, "pad"),
        ("causal_256", 2, 4, 256, 256, 64, True, None),
        ("pad_200", 2, 4, 200, 200, 64, False, "pad"),
        ("pad_200_causal", 2, 4, 200, 200, 64, True, "pad"),
        ("segments_128", 2, 4, 128, 128, 32, False, "seg"),
        ("segments_pad_128", 2, 4, 128, 128, 32, False, "seg+pad"),
        ("rect_q64_k256_causal", 2, 4, 64, 256, 64, True, None),
        ("rect_q130_k70_causal", 1, 2, 130, 70, 32, True, None),
        ("odd_77_d128", 2, 3, 77, 77, 128, False, "pad"),
        ("odd_200_d32_causal", 2, 3, 200, 200, 32, True, None),
        ("d128_256", 2, 4, 256, 256, 128, False, None),
        ("d16_96", 2, 2, 96, 96, 16, True, "pad"),
    ]


def _masking(rs, kind, B, Tq, Tk):
    import torch

    mask = seg = None
    if kind in ("pad", "seg+pad"):
        m = (rs.rand(B, Tk) > 0.25).astype(np.float32)
        m[0, :] = 0.0  # one example with no live key at all
        mask = torch.from_numpy(m).cuda()
    if kind in ("seg", "seg+pad"):
        s = np.repeat(np.arange(4), -(-Tk // 4))[:Tk]
        seg = torch.from_numpy(np.broadcast_to(s, (B, Tk)).astype(np.int32)).cuda()
    return mask, seg


def phase_kernels(tag):
    import torch

    from deeplearning4j_tpu_torch.kernels import attention as A

    rs = np.random.RandomState(0)
    errors = {}
    q_rows = set()
    for name, B, H, Tq, Tk, D, causal, kind in _kernel_cases():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _attention_inputs(rs, B, H, Tq, Tk, D, dtype, strided=kind is None)
            mask, seg = _masking(rs, kind, B, Tq, Tk)
            out, lse = A.flash_attention(q, k, v, mask, segment_ids=seg, causal=causal,
                                         return_lse=True)
            torch.cuda.synchronize()
            # the same inputs through the plain version, as flash_attention
            # hands them to the kernel
            qseg, kseg = A.attention_segments(mask, seg, B, Tq, Tk, q.device)
            ref, ref_lse = A.flash_forward_reference(q, k, v, qseg, kseg, causal,
                                                     1.0 / math.sqrt(D), Tk - Tq)
            check(torch.isfinite(out).all().item(), f"{name}: non-finite kernel output")
            diff = (out.float() - ref.float()).abs()
            if dtype == torch.float32:
                ok = bool((diff <= FP32_ATOL).all())
            else:
                ok = bool((diff <= BF16_ULP_REL * ref.float().abs() + BF16_ATOL).all())
            lse_diff = (lse - ref_lse).abs()
            lse_ok = bool((lse_diff <= LSE_TOL * ref_lse.abs().clamp(min=1.0)).all())
            dt = str(dtype).split(".")[-1]
            tile = ""
            if dtype == torch.float32:
                q_rows.add(f32_q_rows(B, H, Tq))
                tile = f" ({f32_q_rows(B, H, Tq)}-row q-tiles)"
            print(f"{tag} kernel {name} {dt}{tile}: max|out-plain|={diff.max().item():.3e} "
                  f"max|lse-plain|={lse_diff.max().item():.3e}", flush=True)
            check(ok, f"kernel {name} {dt}: output disagrees with the plain version")
            check(lse_ok, f"kernel {name} {dt}: lse disagrees with the plain version")
            errors[(name, dt)] = diff.max().item()
    check(q_rows == set(F32_Q_ROWS),
          f"phase 2 ran the float32 forward with {sorted(q_rows)}-row q-tiles only")
    return errors


# bf16 forward timed at: the serving shape (the kernels line reports it), the
# training shape, and a causal prefill of one 512-token sequence
FWD_TIMED_SHAPES = (("serving", 8, 12, 128, 64, False), ("training", 16, 12, 128, 64, False),
                    ("prefill_512_causal", 1, 12, 512, 64, True))


def time_kernel(tag):
    """The bf16 forward kernel, its plain version and the library call at
    each shape of ``FWD_TIMED_SHAPES`` (strided q/k/v from one fused
    projection, as ``_block`` gives them), each held against the plain
    version first. Returns the serving shape's numbers."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.kernels import attention as A

    rs = np.random.RandomState(1)
    timings = {}
    for name, B, H, T, D, causal in FWD_TIMED_SHAPES:
        q, k, v = _attention_inputs(rs, B, H, T, T, D, torch.bfloat16, strided=True)
        scale = 1.0 / math.sqrt(D)
        args = (None, None, causal, scale, 0)
        out, _ = A.flash_forward(q, k, v, *args)
        ref, _ = A.flash_forward_reference(q, k, v, *args)
        diff = (out.float() - ref.float()).abs()
        check(bool((diff <= BF16_ULP_REL * ref.float().abs() + BF16_ATOL).all()),
              f"flash_fwd at the {name} shape disagrees with the plain version")
        ms = time_ms(lambda: A.flash_forward(q, k, v, *args))
        plain_ms = time_ms(lambda: A.flash_forward_reference(q, k, v, *args))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale, is_causal=causal))
        if name == "serving":
            us = host_us(lambda: A.flash_forward(q, k, v, *args))
            print(f"{tag} flash_fwd host time per wrapper call (launch included): "
                  f"{us:.1f} us", flush=True)
        nbytes = 4 * B * H * T * D * q.element_size() + B * H * T * 4
        pairs = T * (T + 1) // 2 if causal else T * T  # (query, key) pairs with a live score
        ops = 2 * 2 * B * H * pairs * D  # q k^T and p v
        timings[name] = {"max_abs_err": diff.max().item(), **report_timing(
            tag, f"flash_fwd {name} B={B} H={H} T={T} D={D} bf16"
            + (" causal" if causal else ""), ms, plain_ms, library_ms, nbytes, ops, "sdpa")}

    return timings["serving"]


# float32 forward timed at: generation's prefill calls (B=1, causal, strided
# views of the fused projection; prefill_forward passes no key mask, the
# causal mask keeps a bucket's padding out of the prompt's rows) at buckets
# 512 (the kernels line reports it), 128 and 256; the 512 bucket again with
# the keys past a 300-token prompt masked by segment ids (the mask path);
# and the float32 train-step check's shape. (name, B, H, T, D, causal,
# live keys or None)
F32_FWD_TIMED_SHAPES = (("prefill_512_causal", 1, 12, 512, 64, True, None),
                        ("prefill_128_causal", 1, 12, 128, 64, True, None),
                        ("prefill_256_causal", 1, 12, 256, 64, True, None),
                        ("prefill_512_causal_kseg300", 1, 12, 512, 64, True, 300),
                        ("training", 16, 12, 128, 64, False, None))


def time_f32_forward(tag):
    """The float32 forward kernel at each shape of ``F32_FWD_TIMED_SHAPES``,
    held against the plain version first, then timed beside the plain
    version, SDPA in float32 with TF32 off, and its bound at the rate of its
    3xTF32 products. Returns the 512-token prefill's numbers."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.kernels import attention as A

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for the float32 timing")
    rs = np.random.RandomState(8)
    timings = {}
    for name, B, H, T, D, causal, n_live in F32_FWD_TIMED_SHAPES:
        q, k, v = _attention_inputs(rs, B, H, T, T, D, torch.float32, strided=True)
        scale = 1.0 / math.sqrt(D)
        qseg = kseg = None
        attn_mask = None
        if n_live is not None:
            qseg = torch.zeros((B, T), dtype=torch.int32, device="cuda")
            kseg = torch.where(torch.arange(T, device="cuda") < n_live, 0, -1).to(
                torch.int32).expand(B, T).contiguous()
            pos = torch.arange(T, device="cuda")
            attn_mask = (pos[:, None] >= pos[None, :]) & (pos[None, :] < n_live)
        args = (qseg, kseg, causal, scale, 0)
        out, lse = A.flash_forward(q, k, v, *args)
        ref, ref_lse = A.flash_forward_reference(q, k, v, *args)
        diff = (out - ref).abs().max().item()
        lse_ok = bool(((lse - ref_lse).abs() <= LSE_TOL * ref_lse.abs().clamp(min=1.0)).all())
        check(diff <= FP32_ATOL and lse_ok,
              f"float32 flash_fwd at the {name} shape disagrees with the plain version: {diff}")
        if attn_mask is None:
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale, is_causal=causal)
        else:
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                          scale=scale)
        ms = time_ms(lambda: A.flash_forward(q, k, v, *args))
        plain_ms = time_ms(lambda: A.flash_forward_reference(q, k, v, *args))
        library_ms = time_ms(sdpa)
        # (query, key) pairs with a live score, for this run's mask
        rows = np.arange(T)
        live = np.minimum(rows + 1, n_live or T) if causal else np.full(T, n_live or T)
        ops = 2 * 2 * B * H * int(live.sum()) * D  # q k^T and p v
        nbytes = 4 * B * H * T * D * 4 + B * H * T * 4 + (2 * B * T * 4 if qseg is not None else 0)
        what = (f"flash_fwd float32 {name} B={B} H={H} T={T} D={D}"
                f" ({f32_q_rows(B, H, T)}-row q-tiles)")
        timings[name] = {"max_abs_err": diff, **report_timing(
            tag, what, ms, plain_ms, library_ms, nbytes, ops, "sdpa float32", dtype="3xtf32")}
        print(f"{tag} {what}: max|kernel-plain| {diff:.3e}", flush=True)
    return timings["prefill_512_causal"]


# q-tile heights the bf16 forward is also built with, to time against its 64
Q_TILE_VARIANTS = (32, 128)


def start_q_tile_builds() -> dict:
    """Start nvcc on csrc/flash_fwd.cu with -DTDL_FWD_BLOCK_Q=n for each n of
    ``Q_TILE_VARIANTS`` (beside the main build, all at once); returns
    {n: (process, library path)}."""
    from deeplearning4j_tpu_torch.kernels import _build

    nvcc = _build.find_nvcc()
    out_dir = _build.build_dir() / "q_tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {}
    for n in Q_TILE_VARIANTS:
        lib = out_dir / f"libflash_fwd_q{n}.so"
        cmd = _build.nvcc_command(nvcc, _build.CSRC / "flash_fwd.cu", lib) + [
            f"-DTDL_FWD_BLOCK_Q={n}"]
        builds[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True), lib)
    return builds


def time_q_tiles(tag, builds):
    """The bf16 forward with 32-, 64- and 128-row q-tiles at each shape of
    ``FWD_TIMED_SHAPES``: each held against the plain version, then timed in
    turns (64, 32, 128, 128, 32, 64) in this call; prints the mean of each
    height's two timings."""
    import ctypes

    import torch

    from deeplearning4j_tpu_torch.kernels import attention as A

    fns = {}
    for n, (proc, lib) in builds.items():
        output, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed for the {n}-row q-tile build:\n{output}")
        fns[n] = A.bind_kernel(ctypes.CDLL(str(lib)), "tdl_flash_fwd", 7, 9)

    def variant(n, q, k, v, causal, scale):
        fn, err_str = fns[n]
        B, H, T, D = q.shape
        out = torch.empty((B, H, T, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, out.data_ptr(),
                lse.data_ptr(), B, H, T, T, D, 1, *strides, int(causal), scale, 0,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"{n}-row q-tile launch failed: {err_str(rc).decode()}")
        return out

    rs = np.random.RandomState(7)
    for name, B, H, T, D, causal in FWD_TIMED_SHAPES:
        q, k, v = _attention_inputs(rs, B, H, T, T, D, torch.bfloat16, strided=True)
        scale = 1.0 / math.sqrt(D)
        runs = {64: lambda: A.flash_forward(q, k, v, None, None, causal, scale, 0)[0]}
        for n in fns:
            runs[n] = lambda n=n: variant(n, q, k, v, causal, scale)
        ref = A.flash_forward_reference(q, k, v, None, None, causal, scale, 0)[0].float()
        for n, run in runs.items():
            diff = (run().float() - ref).abs()
            check(bool((diff <= BF16_ULP_REL * ref.abs() + BF16_ATOL).all()),
                  f"{n}-row q-tile forward at the {name} shape disagrees with the plain version")
        order = [64, *fns, *reversed(list(fns)), 64]
        times = {n: [] for n in runs}
        for n in order:
            times[n].append(time_ms(runs[n]))
        blocks = {n: -(-T // n) * B * H for n in runs}
        print(f"{tag} flash_fwd q-tile rows at {name} B={B} H={H} T={T} D={D} bf16"
              + (" causal" if causal else "") + ": " + ", ".join(
                  f"{n} rows ({blocks[n]} blocks) {statistics.mean(times[n]):.4f} ms"
                  for n in sorted(runs)), flush=True)


def report_timing(tag, what, ms, plain_ms, library_ms, nbytes, ops, library,
                  dtype="bfloat16") -> dict:
    """Print a kernel's times beside its bound: the larger of its bytes over
    the card's memory rate and its operations over the peak for ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"{tag} {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {library} "
          f"{library_ms:.4f} ms; bound {bound_ms * 1e3:.3f} us ({nbytes} bytes -> "
          f"{t_bytes * 1e3:.3f} us, {ops} ops -> {t_ops * 1e3:.3f} us); kernel / bound "
          f"{ms / bound_ms:.1f}, kernel / {library} {ms / library_ms:.2f}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def host_us(fn, n=50) -> float:
    """Host time of one call of ``fn`` (its launch included), averaged."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _bwd_ratio(got, ref, dtype) -> float:
    """Largest |got - ref| as a share of the backward bound for ``dtype``."""
    import torch

    diff = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        tol = BWD_FP32_ATOL + BWD_FP32_RTOL * ref.float().abs()
    else:
        tol = BF16_ULP_REL * ref.float().abs() + BWD_BF16_ATOL
    return (diff / tol).max().item()


def _delta_ratio(delta, out, do) -> float:
    """Largest |delta - plain| as a share of its bound (DELTA_REL_OF_ABS_SUM)."""
    from deeplearning4j_tpu_torch.kernels import attention as A

    prods = do.float() * out.float()
    tol = 2 * (do.shape[-1] + 1) * DELTA_REL_OF_ABS_SUM * prods.abs().sum(-1)
    diff = (delta - A.flash_backward_delta(out, do)).abs()
    return (diff / tol.clamp(min=1e-30)).max().item()


def phase_backward_kernels(tag):
    """Both backward kernels against the plain backward over the cases of
    phase 2: the forward kernel's (out, lse) and an upstream gradient dO
    (a transposed view where q/k/v are the strided views of ``_block``);
    and the delta that the dq kernel computes against its plain version.
    Prints the worst element of each as a share of its bound."""
    import torch

    from deeplearning4j_tpu_torch.kernels import attention as A

    rs = np.random.RandomState(3)
    for name, B, H, Tq, Tk, D, causal, kind in _kernel_cases():
        for dtype in (torch.bfloat16, torch.float32):
            strided = kind is None and Tq == Tk
            q, k, v = _attention_inputs(rs, B, H, Tq, Tk, D, dtype, strided=strided)
            do = torch.from_numpy(rs.randn(B, Tq, H, D).astype(np.float32)).to("cuda", dtype)
            do = do.transpose(1, 2) if strided else do.transpose(1, 2).contiguous()
            mask, seg = _masking(rs, kind, B, Tq, Tk)
            qseg, kseg = A.attention_segments(mask, seg, B, Tq, Tk, q.device)
            args = (qseg, kseg, causal, 1.0 / math.sqrt(D), Tk - Tq)
            out, lse = A.flash_forward(q, k, v, *args)
            got = A.flash_backward(q, k, v, out, lse, do, *args)
            _, delta = A.flash_backward_dq(q, k, v, out, do, lse, *args)
            torch.cuda.synchronize()
            ref = A.flash_backward_reference(q, k, v, out, lse, do, *args)
            dt = str(dtype).split(".")[-1]
            ratios = []
            for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
                check(g.dtype == dtype and g.shape == r.shape and g.is_contiguous(),
                      f"backward {name} {dt}: {gname} {g.dtype} {tuple(g.shape)}")
                check(torch.isfinite(g).all().item(), f"backward {name} {dt}: non-finite {gname}")
                ratios.append(_bwd_ratio(g, r, dtype))
            ratios.append(_delta_ratio(delta, out, do))
            print(f"{tag} backward {name} {dt}: worst |kernel - plain| / bound: dq "
                  f"{ratios[0]:.3f} dk {ratios[1]:.3f} dv {ratios[2]:.3f} delta {ratios[3]:.3f}",
                  flush=True)
            for what, ratio in zip(("dq", "dk", "dv", "delta"), ratios):
                check(ratio <= 1.0, f"backward kernel {name} {dt}: {what} disagrees with the "
                                    f"plain version ({ratio:.3f} of the bound)")


# backward timed at: the BERT-base training shape (the kernels line reports
# it) and a causal prefill of one 512-token sequence, bf16; and the float32
# train-step check's shape (the FMA kernels)
BWD_TIMED_SHAPES = (("training", 16, 12, 128, 64, False, "bfloat16"),
                    ("prefill_512_causal", 1, 12, 512, 64, True, "bfloat16"),
                    ("training_f32", 16, 12, 128, 64, False, "float32"))


def time_backward(tag):
    """The backward at each shape of ``BWD_TIMED_SHAPES``: the dq
    kernel (which also computes delta), the dkv kernel, and the pair as
    ``flash_backward`` launches it, each held against its plain version
    first, then timed beside its plain version, its bound and the library
    yardstick (the backward of scaled_dot_product_attention, which computes
    dq, dk, dv and its own delta: forward+backward minus forward). Returns
    the training shape's numbers of the two kernels."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.kernels import attention as A

    timings = {}
    for shape, B, H, T, D, causal, dt in BWD_TIMED_SHAPES:
        dtype = getattr(torch, dt)
        rs = np.random.RandomState(4)
        q, k, v = _attention_inputs(rs, B, H, T, T, D, dtype, strided=True)
        do = torch.from_numpy(rs.randn(B, T, H, D).astype(np.float32)).to("cuda", dtype)
        do = do.transpose(1, 2)  # as autograd hands it back through _block's reshape
        scale = 1.0 / math.sqrt(D)
        rest = (None, None, causal, scale, 0)
        out, lse = A.flash_forward(q, k, v, *rest)
        dq, delta = A.flash_backward_dq(q, k, v, out, do, lse, *rest)
        dk, dv = A.flash_backward_dkv(q, k, v, do, lse, delta, *rest)
        torch.cuda.synchronize()
        rdq, _ = A.flash_backward_dq_reference(q, k, v, out, do, lse, *rest)
        rdk, rdv = A.flash_backward_dkv_reference(q, k, v, do, lse, delta, *rest)
        ratios = {g: _bwd_ratio(a, r, dtype) for g, a, r in
                  (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv))}
        ratios["delta"] = _delta_ratio(delta, out, do)
        check(max(ratios.values()) <= 1.0, f"backward at the {shape} shape disagrees with the "
                                           f"plain version: {ratios}")
        err = {"flash_bwd_dq": (dq.float() - rdq.float()).abs().max().item(),
               "flash_bwd_dkv": max((dk.float() - rdk.float()).abs().max().item(),
                                    (dv.float() - rdv.float()).abs().max().item())}
        err["pair"] = max(err.values())

        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qg, kg, vg, scale=scale, is_causal=causal)
        sdpa_fwd = time_ms(sdpa)
        sdpa_fwd_bwd = time_ms(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg), do))
        library_ms = sdpa_fwd_bwd - sdpa_fwd
        what = f"B={B} H={H} T={T} D={D} {dt}" + (" causal" if causal else "")
        print(f"{tag} sdpa at {what}: forward {sdpa_fwd:.4f} ms, forward+backward "
              f"{sdpa_fwd_bwd:.4f} ms, backward {library_ms:.4f} ms (yardstick of both kernels)",
              flush=True)
        elem = q.element_size()
        bhtd, bht = B * H * T * D, B * H * T
        pairs = T * (T + 1) // 2 if causal else T * T  # (query, key) pairs with a live score
        prod = 2 * B * H * pairs * D  # operations of one [T,T,D] product
        cases = (
            # reads q, k, v, out, dO, lse; writes dq, delta; S, dP, dQ, delta
            ("flash_bwd_dq", lambda: A.flash_backward_dq(q, k, v, out, do, lse, *rest),
             lambda: A.flash_backward_dq_reference(q, k, v, out, do, lse, *rest),
             6 * bhtd * elem + 2 * bht * 4, 3 * prod + 2 * bhtd),
            # reads q, k, v, dO, lse, delta; writes dk, dv; S, dP, dV, dK
            ("flash_bwd_dkv", lambda: A.flash_backward_dkv(q, k, v, do, lse, delta, *rest),
             lambda: A.flash_backward_dkv_reference(q, k, v, do, lse, delta, *rest),
             6 * bhtd * elem + 2 * bht * 4, 4 * prod),
            # the function of the SDPA backward: reads q, k, v, out, dO, lse;
            # writes dq, dk, dv
            ("pair", lambda: A.flash_backward(q, k, v, out, lse, do, *rest),
             lambda: A.flash_backward_reference(q, k, v, out, lse, do, *rest),
             8 * bhtd * elem + bht * 4, 5 * prod + 2 * bhtd))
        timings[shape] = {}
        for name, fn, plain, nbytes, ops in cases:
            ms = time_ms(fn)
            plain_ms = time_ms(plain)
            print(f"{tag} {name} at {what}: host time per wrapper call (launch included) "
                  f"{host_us(fn):.1f} us; max|kernel-plain| {err[name]:.3e}", flush=True)
            timings[shape][name] = {"max_abs_err": err[name], **report_timing(
                tag, f"{name} at {what}", ms, plain_ms, library_ms, nbytes, ops,
                "sdpa backward", dtype=dt)}
        print(f"{tag} backward at {what}: worst |kernel - plain| / bound " + ", ".join(
            f"{g} {r:.3f}" for g, r in ratios.items()), flush=True)
    return {name: timings["training"][name] for name in ("flash_bwd_dkv", "flash_bwd_dq")}


# ------------------------------------------------------------------ phase 3


def phase_encoder(tag, launches):
    import torch

    from deeplearning4j_tpu_torch.kernels.attention import flash_forward
    from deeplearning4j_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig.bert_base(dropout=0.0)
    params = tfm.init_params(0, cfg, device="cuda")
    rs = np.random.RandomState(0)
    B, T = 8, 128
    tokens = rs.randint(0, cfg.vocab_size, (B, T))
    lengths = rs.randint(T // 4, T + 1, B)
    lengths[0] = T
    pad_mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    requests = [("dense", None), ("ragged", pad_mask)]
    logits = {}
    for name, mask in requests:
        flash_forward.launches = 0
        out = tfm.forward(params, tokens, cfg, pad_mask=mask)
        torch.cuda.synchronize()
        n = flash_forward.launches
        launches.append(n)
        check(n == cfg.n_layers, f"encoder {name}: {n} kernel launches, expected {cfg.n_layers}")
        check(tuple(out.shape) == (B, T, cfg.vocab_size) and out.dtype == torch.float32,
              f"encoder {name}: logits {tuple(out.shape)} {out.dtype}")
        check(torch.isfinite(out).all().item(), f"encoder {name}: non-finite logits")
        logits[name] = out
    xla = dataclasses.replace(cfg, attn_impl="xla")
    for name, mask in requests:
        ref = tfm.forward(params, tokens, xla, pad_mask=mask)
        diff = (logits[name] - ref).abs().max().item()
        print(f"{tag} encoder {name}: flash launches {cfg.n_layers}, "
              f"max|logits - dense path| = {diff:.4e} (max|logits| "
              f"{ref.abs().max().item():.3f})", flush=True)
        check(diff <= ENCODER_LOGIT_ATOL,
              f"encoder {name}: logits differ from the dense path by {diff}")
    for name, mask in requests:
        times = wall_ms(lambda: tfm.forward(params, tokens, cfg, pad_mask=mask))
        ms = statistics.median(times)
        print(f"{tag} encoder {name} forward [8,128] bf16: {spread(times)} per request, "
              f"{B * T / ms * 1e3:.0f} tokens/s at the median", flush=True)
    device_profile(tag, "encoder forward [8,128] bf16",
                   lambda: tfm.forward(params, tokens, cfg))


# ------------------------------------------------------------------ phase 4


def _timed(fn, sink):
    import torch

    def run(*a):
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out

    return run


def phase_generate(tag, launches):
    import torch

    from deeplearning4j_tpu_torch.kernels.attention import flash_forward
    from deeplearning4j_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig.bert_base(causal=True, dropout=0.0,
                                          compute_dtype=torch.float32)
    params = tfm.init_params(1, cfg, device="cuda")
    rs = np.random.RandomState(2)
    lengths = (20, 100, 130, 200, 300, 64)
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist() for n in lengths]
    max_new = 16

    pool = tfm.DecodeSlotPool(params, cfg, slots=4)
    prefill_ms, step_ms, live_per_step = [], [], []
    pool._prefill_fn = _timed(pool._prefill_fn, prefill_ms)
    decode = _timed(pool._decode_fn, step_ms)

    def counted_decode(tokens, positions):
        live_per_step.append(pool.occupancy)
        return decode(tokens, positions)

    pool._decode_fn = counted_decode
    flash_forward.launches = 0
    got = tfm.generate(params, prompts, max_new, cfg, pool=pool)
    torch.cuda.synchronize()
    n = flash_forward.launches
    launches.append(n)
    check(n == cfg.n_layers * len(prompts),
          f"generate: {n} kernel launches, expected {cfg.n_layers} x {len(prompts)} admissions")
    check(all(len(g) == max_new for g in got), "generate: wrong number of tokens")

    xla = dataclasses.replace(cfg, attn_impl="xla")
    ref = tfm.generate(params, prompts, max_new, xla,
                       pool=tfm.DecodeSlotPool(params, xla, slots=4))
    for prompt, a, b in zip(prompts, got, ref):
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        logits = tfm.forward(params, [prompt + b[:t]], xla)[0, -1]
        top2 = torch.topk(logits, 2).values
        margin = (top2[0] - top2[1]).item()
        print(f"{tag} generate: prompt of {len(prompt)} diverges at token {t}; "
              f"dense path's top-2 margin there {margin:.3e}", flush=True)
        check(margin <= TIE_EPS, f"generate: tokens differ from the dense path at a "
                                 f"margin of {margin} > {TIE_EPS}")
    same = sum(a == b for a, b in zip(got, ref))
    decode_tokens = sum(live_per_step)
    print(f"{tag} generate: {same}/{len(prompts)} sequences token-identical to the dense "
          f"path; flash launches {n} for {len(prompts)} admissions", flush=True)
    print(f"{tag} generate fp32 slots=4: prefill per admission "
          + ", ".join(f"{n}: {t:.3f} ms" for n, t in zip(lengths, prefill_ms))
          + f"; decode step {spread(step_ms)}, {decode_tokens} tokens in "
          f"{sum(step_ms):.1f} ms = {decode_tokens / sum(step_ms) * 1e3:.1f} tokens/s",
          flush=True)
    pool = tfm.DecodeSlotPool(params, cfg, slots=4)
    slot, _ = pool.admit(prompts[4], max_new)
    device_profile(tag, "prefill of a 300-token prompt (512 bucket) fp32",
                   lambda: pool._prefill_fn(slot, np.zeros((1, 512), np.int64), 300))
    device_profile(tag, "decode step, slots=4 fp32", lambda: pool.step(), reps=5)


# ------------------------------------------------------------------ phase 5


def _counters():
    from deeplearning4j_tpu_torch.kernels import attention as A

    return {"flash_fwd": A.flash_forward, "flash_bwd_dkv": A.flash_backward_dkv,
            "flash_bwd_dq": A.flash_backward_dq}


def _zero_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _mlm_batch(cfg, rs, B, T, P):
    """``bench.py``'s BERT batch: random tokens, P sorted masked positions
    per row (the TF-BERT layout), random labels, unit weights."""
    positions = np.stack([np.sort(rs.choice(T, P, replace=False)) for _ in range(B)])
    return {"tokens": rs.randint(0, cfg.vocab_size, (B, T)),
            "mlm_positions": positions.astype(np.int64),
            "labels": rs.randint(0, cfg.vocab_size, (B, P)),
            "weights": np.ones((B, P), np.float32)}


def _check_step_counts(what, counts, steps, n_layers):
    want = {name: steps * n_layers for name in _counters()}
    check(counts == want, f"{what}: kernel launches {counts}, expected {want}")


def phase_train(tag, launches):
    """BERT-base training through the three kernels (see the module
    docstring). Returns the launches of each kernel on the main path."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    B, T, P = 16, 128, 19
    cfg = tfm.TransformerConfig.bert_base(max_len=T, dropout=0.0)
    batch = _mlm_batch(cfg, np.random.RandomState(5), B, T, P)

    # one float32 step: the kernels against dense attention, same weights
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    params = tfm.init_params(3, cfg32, device="cuda")
    _zero_counts()
    loss, grads = tfm.loss_and_grads(params, batch, cfg32)
    _check_step_counts("fp32 step", _read_counts(), 1, cfg.n_layers)
    ref_loss, ref_grads = tfm.loss_and_grads(
        params, batch, dataclasses.replace(cfg32, attn_impl="xla"))
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    worst_name, worst = "", 0.0
    for name, g in grads.items():
        r = ref_grads[name]
        check(torch.isfinite(g).all().item(), f"fp32 step: non-finite gradient {name}")
        rel = ((g - r).norm() / r.norm().clamp(min=1e-30)).item() if r.norm() > 0 \
            else g.norm().item()
        if rel > worst:
            worst_name, worst = name, rel
    print(f"{tag} train fp32 step, flash kernels vs dense attention: loss {loss.item():.6f} vs "
          f"{ref_loss.item():.6f} (rel {loss_rel:.2e}); largest gradient error "
          f"{worst:.2e} of its norm ({worst_name}, {len(grads)} tensors)", flush=True)
    check(loss_rel <= TRAIN_LOSS_REL, f"fp32 step: loss differs by {loss_rel:.2e} relative")
    check(worst <= TRAIN_GRAD_REL, f"fp32 step: gradient {worst_name} differs by {worst:.2e}")
    del params, grads, ref_grads

    # the main path: bf16 compute, Adam, 45 steps on one batch (40 timed)
    params = tfm.init_params(3, cfg, device="cuda")
    updater = Adam(1e-4)
    state = updater.init(params)
    step = tfm.make_train_step(cfg, updater)
    warmup, timed = 5, 40
    losses, times = [], []
    _zero_counts()
    torch.cuda.synchronize()
    for it in range(warmup + timed):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch, it)
        losses.append(loss.item())  # waits for the step
        if it >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    counts = _read_counts()
    _check_step_counts("bf16 train steps", counts, warmup + timed, cfg.n_layers)
    for name, n in counts.items():
        launches[name].append(n)
    check(all(math.isfinite(x) for x in losses), f"train: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall ({losses[0]} -> {losses[-1]})")
    ms = statistics.median(times)
    print(f"{tag} train bf16 B={B} T={T} P={P} Adam: loss " + " ".join(
        f"{x:.4f}" for x in losses), flush=True)
    print(f"{tag} train step: {spread(times)}, {B * T / ms * 1e3:.0f} tokens/s at the median; "
          f"launches per step {', '.join(f'{k} {v // (warmup + timed)}' for k, v in counts.items())}",
          flush=True)
    it = warmup + timed
    device_profile(tag, f"train step [{B},{T}] bf16",
                   lambda: step(params, state, batch, it), reps=3, top=12)
    del params, state

    # dropout 0.1 from a seeded generator: the same loss twice, another at 0
    def one_step(c, generator):
        prm = tfm.init_params(3, c, device="cuda")
        upd = Adam(1e-4)
        return tfm.make_train_step(c, upd)(prm, upd.init(prm), batch, 0, generator)[2].item()

    drop = dataclasses.replace(cfg, dropout=0.1)
    a = one_step(drop, torch.Generator(device="cuda").manual_seed(7))
    b = one_step(drop, torch.Generator(device="cuda").manual_seed(7))
    c = one_step(cfg, torch.Generator(device="cuda").manual_seed(7))
    print(f"{tag} train dropout 0.1, generator seed 7: loss {a:.6f} and {b:.6f}; "
          f"dropout 0: {c:.6f}", flush=True)
    check(a == b, "dropout: one seed gave two losses")
    check(a != c, "dropout 0.1 gave the loss of dropout 0")

    # one QA fine-tune step at [8, 128]
    qB = 8
    rs = np.random.RandomState(6)
    params = tfm.init_params(3, cfg, device="cuda")
    qa = tfm.init_qa_head(4, cfg, device="cuda")
    qa_batch = {"tokens": rs.randint(0, cfg.vocab_size, (qB, T)),
                "segments": (np.arange(T)[None] >= 24).repeat(qB, 0).astype(np.int64),
                "start_positions": rs.randint(24, T, qB), "end_positions": rs.randint(24, T, qB)}
    updater = Adam(1e-4)
    _zero_counts()
    out = tfm.make_qa_train_step(cfg, updater)(params, qa, updater.init(params),
                                               updater.init(qa), qa_batch, 0)
    qa_loss = out[-1].item()
    counts = _read_counts()
    print(f"{tag} QA fine-tune step [{qB},{T}] bf16: loss {qa_loss:.6f}, launches {counts}",
          flush=True)
    check(math.isfinite(qa_loss), "QA step: non-finite loss")
    _check_step_counts("QA step", counts, 1, cfg.n_layers)
    check(all(torch.isfinite(p).all().item() for p in qa.parameters()),
          "QA step: non-finite span head")


# --------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)", flush=True)
        return 2
    from deeplearning4j_tpu_torch import set_fp32_numerics
    from deeplearning4j_tpu_torch.kernels import _build

    set_fp32_numerics()
    card = card_line()
    tag = f"[{card}]"
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    q_tile_builds = {}
    try:
        t0 = time.perf_counter()
        q_tile_builds = start_q_tile_builds()
        _build.build_all()
        print(f"{tag} phase 1 build: {time.perf_counter() - t0:.2f} s "
              f"({', '.join(_build.build_info['built']) or 'cached'})", flush=True)
        for line in _build.build_info["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  " + line.strip(), flush=True)
        report_bf16_registers(tag, _build.build_info["log"])
        report_f32_registers(tag, _build.build_info["log"])

        errors = phase_kernels(tag)
        timing = time_kernel(tag)
        f32_timing = time_f32_forward(tag)
        time_q_tiles(tag, q_tile_builds)
        phase_backward_kernels(tag)
        bwd_timing = time_backward(tag)
        print("phase 2 kernel vs plain: ok", flush=True)
        launches = {"flash_fwd": [], "flash_fwd_f32": [], "flash_bwd_dkv": [], "flash_bwd_dq": []}
        phase_encoder(tag, launches["flash_fwd"])
        print("phase 3 encoder serving: ok", flush=True)
        phase_generate(tag, launches["flash_fwd_f32"])
        print("phase 4 generation: ok", flush=True)
        phase_train(tag, launches)
        print("phase 5 training: ok", flush=True)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    finally:
        for proc, _ in q_tile_builds.values():
            if proc.poll() is None:  # a phase failed before its build was read
                proc.kill()
                proc.wait()

    main_path = [e for (name, dt), e in errors.items() if name.startswith("bert_base")]
    bwd = "deeplearning4j_tpu_torch/csrc/flash_bwd.cu"
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "deeplearning4j_tpu/kernels/attention.py:70",
        "launches": sum(launches["flash_fwd"]), "max_abs_err": max(main_path), **timing,
    }, {
        # the float32 forward (generation's prefill), a kernel of its own in
        # the same source, timed at a 512-token causal prefill
        "name": "flash_fwd_f32", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "deeplearning4j_tpu/kernels/attention.py:70",
        "launches": sum(launches["flash_fwd_f32"]), **f32_timing,
    }, {
        "name": "flash_bwd_dkv", "route": "cuda", "source": bwd,
        "replaces": "deeplearning4j_tpu/kernels/attention.py:213",
        "launches": sum(launches["flash_bwd_dkv"]), **bwd_timing["flash_bwd_dkv"],
    }, {
        "name": "flash_bwd_dq", "route": "cuda", "source": bwd,
        "replaces": "deeplearning4j_tpu/kernels/attention.py:258",
        "launches": sum(launches["flash_bwd_dq"]), **bwd_timing["flash_bwd_dq"],
    }]
    check_failed = [k["name"] for k in kernels if k["launches"] < 1]
    if check_failed:
        print(f"FAIL: kernels never launched on the main path: {check_failed}", flush=True)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
