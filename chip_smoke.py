#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    (needs one CUDA card and nvcc)

Phases:

1. build every CUDA kernel of ``deeplearning4j_tpu_torch/csrc`` with nvcc,
   and print the registers and spills of each instantiation of the bf16
   kernels (the forward per head dim, q-tile height and masking; dkv, dq)
   and of the float32 kernels (the split-TF32 forward per head dim and
   q-tile height, the split-TF32 backward pair per head dim and masking);
   no forward and no bf16 backward may spill at D=64 and D=128, and no
   float32 backward instantiation at all;
2. hold each kernel against its plain PyTorch version on the card, over the
   shapes of the main path and the edge cases of the masking model (the
   backward's gradients, and the delta that the dq kernel computes; the
   forward at each of its q-tile heights, bf16 32/64/128 rows and float32
   16/32, every height launched), and time the kernel, the
   plain version and the nearest PyTorch library call: the bf16 flash
   forward at the serving shape [8,12,128,64], the training shape
   [16,12,128,64] and a causal prefill [1,12,512,64]; the float32 forward
   at generation's causal prefills [1,12,T,64] (T = 512, 128, 256, and 512
   with keys past 300 masked) and at the float32 step check's [16,12,128,64]
   beside SDPA in float32 with TF32 off; ``dot_product_attention(impl=
   "auto")`` routing a head dim or dtype the kernels do not take to the
   dense path with no launch; the two backward kernels, alone and as a
   pair, at the training shape [16,12,128,64] and the causal prefill, bf16,
   and in float32 (bound at the 3xTF32 rate) at the training shape and at
   [4,12,512,64], whose blocks sweep four times the tiles;
2b. the autotune search (``autotune_flash_attention``, into a temporary
   ``TDL_AUTOTUNE_DIR``) at the serving and training shapes (bf16), the
   causal float32 prefills of 32, 64, 128 and 512 tokens and a causal bf16
   512-token prefill: every q-tile height launches and is timed, beside SDPA
   and the dense ``mha_reference``; ``resolve_blocks`` and ``flash_attention``
   then take each winner, also after the table is read back from disk; the
   table's static float32 rule equals the kernel's on this card; the host
   cost of the table lookup per call; the training shape searched again,
   forward plus backward;
3. serve BERT-base (12 layers, d 768, vocab 30522, bf16, random weights from
   a seed): ``forward`` on tokens [8, 128], then a ragged key-padding
   request; every request must launch the flash kernel once per layer, and
   the logits must match the dense-attention path;
4. generate with a causal model of BERT-base width through
   ``DecodeSlotPool(slots=4)``: 6 ragged prompts, 16 new tokens each; every
   prefill must go through the kernel, and the tokens must equal those of
   the dense-attention path;
4b. paged generation on phase 4's model and prompts: (a) ``generate`` with
   no pool builds a ``PagedDecodeSlotPool``, whose tokens must equal phase
   4's, with 12 kernel launches per prefill, one capture of the decode step
   (``decode_traces == 1``) and every block free afterwards; (b) two prompts
   sharing a 256-token prefix share its 16 blocks (copy-on-write) and
   generate what each does alone; (c) speculative decoding (spec_tokens 4)
   with an identity-tail 2-layer draft (acceptance at least 0.9) and with a
   random 2-layer draft gives the tokens of plain paged decoding; (d) the
   paged step, replayed as one CUDA graph, timed against the dense eager
   step in turns (4 live slots, 30 steps each), with a profile, and the
   speculative step's time and tokens per step;
5. train BERT-base (fp32 parameters, bf16 compute, dropout 0) on the
   ``bench.py`` batch: B=16, T=128, 19 sorted MLM positions, Adam(1e-4).
   One float32 step through the kernels must match the dense-attention
   step (loss and every gradient); every step must launch each of the three
   kernels once per layer; 45 steps on one batch must lower a finite loss
   (40 of them timed); a seeded dropout-0.1 step must repeat its loss; one
   QA fine-tune step at [8,128] must be finite and go through the kernels;
5b. on phase 5's model and batch, each of the seven updaters of this slice
   (Nesterovs, AdaGrad, RmsProp, AdaDelta, AdaMax, Nadam, AMSGrad) with a
   schedule: three steps from a bridged nonzero state, a finite loss, the
   first update of three tensors within 1e-5 of a float64 update from the
   same gradient and state, 12 launches of each kernel per step;
5c. per-block remat on the same model and batch: a float32 step with
   remat against one without at dropout 0.1 (loss and every gradient within
   1e-6, 24 forward launches and 12 of each backward), remat's lower peak
   memory, and 20 bf16 steps of each in turns; then the train step's
   achieved share of the dense bf16 peak, from ``layer_costs`` and phase
   5's median step.

A line before the last is a JSON object describing each kernel (launch
counts on the main path, error against the plain version, times and the
card's bound; the forward also by q-tile instantiation, with the launches
of the autotune search), then the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero and
prints no result. The script imports only the port
(``deeplearning4j_tpu_torch``), never JAX.
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


BF16_FWD_KERNEL = "flash_fwd_bf16_kernel"
BF16_Q_ROWS = (32, 64, 128)
BF16_BWD_KERNELS = ("flash_bwd_dkv_bf16_kernel", "flash_bwd_dq_bf16_kernel")
# the float32 forward, instantiated per head dim and q-tile row groups (16
# or 32 rows), and the float32 backward pair (3xTF32), per head dim and
# masking
F32_FWD_KERNEL = "flash_fwd_f32_kernel"
F32_Q_ROWS = (16, 32)
F32_BWD_KERNELS = ("flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel")


def report_bf16_registers(tag, log):
    """Print registers and spills of each instantiation of the bf16 kernels
    (the forward per head dim D, q-tile rows and masking; dkv and dq per D
    and masking); fail if a main-path width (D=64, D=128) spills."""
    found = {}
    for name, info in ptxas_kernels(log).items():
        m = re.search(r"(%s)ILi(\d+)ELi(\d+)ELb([01])E" % BF16_FWD_KERNEL, name)
        if m:
            found[(m.group(1), int(m.group(2)), int(m.group(3)), m.group(4) == "1")] = info
        m = re.search(r"(%s)ILi(\d+)ELb([01])E" % "|".join(BF16_BWD_KERNELS), name)
        if m:
            found[(m.group(1), int(m.group(2)), 64, m.group(3) == "1")] = info
    want = sorted([(k, d, 64, masked) for k in BF16_BWD_KERNELS for d in (16, 32, 64, 128)
                   for masked in (False, True)]
                  + [(BF16_FWD_KERNEL, d, rows, masked) for d in (16, 32, 64, 128)
                     for rows in BF16_Q_ROWS for masked in (False, True)])
    check(sorted(found) == want, f"ptxas reported bf16 kernels {sorted(found)}")
    for (kernel, d, rows, masked), info in sorted(found.items()):
        print(f"{tag} ptxas {kernel}<D={d}, rows={rows}, masked={masked}>: "
              f"{info.get('registers')} registers, {info.get('spill_stores')} bytes spill "
              f"stores, {info.get('spill_loads')} bytes spill loads", flush=True)
    for (kernel, d, rows, masked), info in found.items():
        if d in (64, 128):
            check(info.get("spill_stores") == 0 and info.get("spill_loads") == 0,
                  f"{kernel}<D={d}, rows={rows}, masked={masked}> spills registers: {info}")


def report_f32_registers(tag, log):
    """Print registers and spills of each float32 instantiation (forward
    per head dim and row groups; the backward pair per head dim and
    masking); fail if a D=64 or D=128 forward spills, or if any
    backward instantiation does."""
    fwd, bwd = {}, {}
    for name, info in ptxas_kernels(log).items():
        m = re.search(r"%sILi(\d+)ELi(\d+)E" % F32_FWD_KERNEL, name)
        if m:
            fwd[(int(m.group(1)), int(m.group(2)))] = info
        m = re.search(r"(%s)ILi(\d+)ELb([01])E" % "|".join(F32_BWD_KERNELS), name)
        if m:
            bwd[(m.group(1), int(m.group(2)), m.group(3) == "1")] = info
    want = [(d, rows // 16) for d in (16, 32, 64, 128) for rows in F32_Q_ROWS]
    check(sorted(fwd) == want, f"ptxas reported float32 forward kernels {sorted(fwd)}")
    check(sorted(bwd) == [(k, d, masked) for k in sorted(F32_BWD_KERNELS)
                          for d in (16, 32, 64, 128) for masked in (False, True)],
          f"ptxas reported float32 backward kernels {sorted(bwd)}")
    for (d, r), info in sorted(fwd.items()):
        print(f"{tag} ptxas {F32_FWD_KERNEL}<D={d}, rows={16 * r}>: "
              f"{info.get('registers')} registers, {info.get('spill_stores')} bytes spill "
              f"stores, {info.get('spill_loads')} bytes spill loads", flush=True)
        if d in (64, 128):
            check(info.get("spill_stores") == 0 and info.get("spill_loads") == 0,
                  f"{F32_FWD_KERNEL}<D={d}, rows={16 * r}> spills registers: {info}")
    for (kernel, d, masked), info in sorted(bwd.items()):
        print(f"{tag} ptxas {kernel}<D={d}, masked={masked}>: "
              f"{info.get('registers')} registers, {info.get('spill_stores')} bytes spill "
              f"stores, {info.get('spill_loads')} bytes spill loads", flush=True)
        check(info.get("spill_stores") == 0 and info.get("spill_loads") == 0,
              f"{kernel}<D={d}, masked={masked}> spills registers: {info}")


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

    from deeplearning4j_tpu_torch.kernels.autotune import FWD_Q_ROWS

    rs = np.random.RandomState(0)
    errors, tile_errors = {}, {}
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
            # every q-tile height the kernel has, held to the same bounds
            worst = []
            for rows in FWD_Q_ROWS[dt]:
                before = A.flash_forward.launches_by_q_rows[(dt, rows)]
                got, got_lse = A.flash_attention(q, k, v, mask, segment_ids=seg, causal=causal,
                                                 return_lse=True, block_q=rows, block_k=64)
                torch.cuda.synchronize()
                check(A.flash_forward.launches_by_q_rows[(dt, rows)] == before + 1,
                      f"kernel {name} {dt}: the {rows}-row q-tile did not launch")
                d = (got.float() - ref.float()).abs()
                if dtype == torch.float32:
                    ok = bool((d <= FP32_ATOL).all())
                else:
                    ok = bool((d <= BF16_ULP_REL * ref.float().abs() + BF16_ATOL).all())
                lse_ok = bool(((got_lse - ref_lse).abs()
                               <= LSE_TOL * ref_lse.abs().clamp(min=1.0)).all())
                check(ok and lse_ok, f"kernel {name} {dt} with {rows}-row q-tiles disagrees "
                                     f"with the plain version")
                tile_errors[(dt, rows)] = max(tile_errors.get((dt, rows), 0.0), d.max().item())
                worst.append(f"{rows} rows {d.max().item():.3e}")
            print(f"{tag} kernel {name} {dt} by q-tile height: max|out-plain| "
                  + ", ".join(worst), flush=True)
    check(q_rows == set(F32_Q_ROWS),
          f"phase 2 ran the float32 forward with {sorted(q_rows)}-row q-tiles only")
    return errors, tile_errors


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


def phase_auto_routing(tag):
    """``dot_product_attention(impl="auto")`` on the card: a head dim (48)
    or a dtype (float16) the kernels are not built for goes to the dense
    path, as the JAX package's ``auto`` does, with no kernel launch;
    ``impl="flash"`` raises for both; a call the kernels take launches."""
    import torch

    from deeplearning4j_tpu_torch.kernels import attention as A

    rs = np.random.RandomState(12)
    for what, D, dtype in (("D=48 float32", 48, torch.float32),
                           ("D=64 float16", 64, torch.float16)):
        q, k, v = (torch.from_numpy(rs.randn(2, 4, 96, D).astype(np.float32)).to("cuda", dtype)
                   for _ in range(3))
        check(not A.flash_takes(q, k, v), f"flash_takes accepts {what}")
        before = A.flash_forward.launches
        out = A.dot_product_attention(q, k, v, causal=True)
        check(A.flash_forward.launches == before, f"auto launched the kernel at {what}")
        check(torch.equal(out, A.mha_reference(q, k, v, causal=True)),
              f"auto at {what} is not the dense path")
        try:
            A.dot_product_attention(q, k, v, causal=True, impl="flash")
            raised = False
        except (TypeError, ValueError):
            raised = True
        check(raised, f"impl='flash' took {what}")
    q, k, v = (torch.from_numpy(rs.randn(2, 4, 96, 64).astype(np.float32)).cuda() for _ in range(3))
    before = A.flash_forward.launches
    A.dot_product_attention(q, k, v, causal=True)
    check(A.flash_forward.launches == before + 1, "auto did not launch the kernel at D=64 float32")
    print(f"{tag} auto routing: D=48 float32 and D=64 float16 take the dense path with no "
          f"launch, impl='flash' refuses both; D=64 float32 launches the kernel", flush=True)


# backward timed at: the BERT-base training shape (the kernels line reports
# it) and a causal prefill of one 512-token sequence, bf16; the float32
# train-step check's shape (the kernels line's float32 entries), and
# [4,12,512,64] float32, as many blocks as that shape with 8 swept tiles
# each instead of 2 (the two times part a block's fixed cost from its cost
# per tile)
BWD_TIMED_SHAPES = (("training", 16, 12, 128, 64, False, "bfloat16"),
                    ("prefill_512_causal", 1, 12, 512, 64, True, "bfloat16"),
                    ("training_f32", 16, 12, 128, 64, False, "float32"),
                    ("long_512_f32", 4, 12, 512, 64, False, "float32"))


def time_backward(tag):
    """The backward at each shape of ``BWD_TIMED_SHAPES``: the dq
    kernel (which also computes delta), the dkv kernel, and the pair as
    ``flash_backward`` launches it, each held against its plain version
    first, then timed beside its plain version, its bound and the library
    yardstick (the backward of scaled_dot_product_attention, which computes
    dq, dk, dv and its own delta: forward+backward minus forward). The
    float32 bound prices the products at the 3xTF32 rate. Returns the
    numbers of the two kernels at the training shape, bf16 and float32."""
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
                "sdpa backward", dtype="3xtf32" if dt == "float32" else dt)}
        print(f"{tag} backward at {what}: worst |kernel - plain| / bound " + ", ".join(
            f"{g} {r:.3f}" for g, r in ratios.items()), flush=True)
    return {f"{name}{sfx}": timings[shape][name]
            for shape, sfx in (("training", ""), ("training_f32", "_f32"))
            for name in ("flash_bwd_dkv", "flash_bwd_dq")}



# ----------------------------------------------------------------- phase 2b

# the autotune search's shapes: serving and training (bf16), generation's
# causal float32 prefills at the 32-, 64-, 128- and 512-token buckets, and a
# causal bf16 512-token prefill. (name, B, H, T, dtype, causal)
AUTOTUNE_SHAPES = (("serving", 8, 12, 128, "bfloat16", False),
                   ("training", 16, 12, 128, "bfloat16", False),
                   ("prefill_32_causal", 1, 12, 32, "float32", True),
                   ("prefill_64_causal", 1, 12, 64, "float32", True),
                   ("prefill_128_causal", 1, 12, 128, "float32", True),
                   ("prefill_512_causal", 1, 12, 512, "float32", True),
                   ("prefill_512_causal_bf16", 1, 12, 512, "bfloat16", True))
# where the kernels line reports each q-tile instantiation
TILE_REPORT_SHAPE = {"bfloat16": "serving", "float32": "prefill_512_causal"}


def phase_autotune(tag, tile_errors):
    """The autotune search (``autotune_flash_attention``) into a temporary
    ``TDL_AUTOTUNE_DIR`` at each shape of ``AUTOTUNE_SHAPES``: every q-tile
    height the kernel has is launched and timed; the winner must be what
    ``resolve_blocks`` then returns and what ``flash_attention`` launches
    with no tile named, and must survive a reload of the table. Beside each
    search: the winner, SDPA and the dense ``mha_reference`` timed alike.
    The directory and the default table are put back afterwards, so the
    later phases run on the static table. Returns the kernels-line entries
    of each q-tile instantiation."""
    import os
    import shutil
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.kernels import attention as A
    from deeplearning4j_tpu_torch.kernels import autotune as AT

    sms = AT.sm_count(torch.device("cuda"))
    for B, H, T in ((1, 12, 32), (1, 12, 64), (1, 12, 128), (1, 12, 512), (8, 12, 128),
                    (16, 12, 128), (4, 12, 512), (2, 4, 256), (1, 2, 130)):
        rule = AT.static_flash_blocks(T, T, "float32", batch_heads=B * H, sms=sms)[0]
        check(rule == f32_q_rows(B, H, T), f"static float32 rule at B={B} H={H} T={T}: "
                                          f"{rule} rows, the kernel's {f32_q_rows(B, H, T)}")
    print(f"{tag} autotune: the static float32 rule equals tdl_flash_fwd_f32_q_rows on this "
          f"card ({sms} SMs) at 9 shapes", flush=True)
    old = os.environ.get(AT.ENV_DIR)
    tmp = tempfile.mkdtemp(prefix="tdl_autotune_")
    os.environ[AT.ENV_DIR] = tmp
    AT.reset_table()
    try:
        return _autotune_search(tag, tile_errors, sms)
    finally:
        if old is None:
            os.environ.pop(AT.ENV_DIR, None)
        else:
            os.environ[AT.ENV_DIR] = old
        AT.reset_table()
        shutil.rmtree(tmp, ignore_errors=True)


def _autotune_search(tag, tile_errors, sms):
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.kernels import attention as A
    from deeplearning4j_tpu_torch.kernels import autotune as AT

    D = 64
    # the search is this slice's path: its launches by q-tile height
    A.flash_forward.launches_by_q_rows.clear()
    entries = {}
    t0 = time.perf_counter()
    for name, B, H, T, dt, causal in AUTOTUNE_SHAPES:
        entries[name] = AT.autotune_flash_attention(B, H, T, D, getattr(torch, dt),
                                                    causal=causal, trials=20)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = dict(A.flash_forward.launches_by_q_rows)
    for dt, heights in AT.FWD_Q_ROWS.items():
        for rows in heights:
            check(launches.get((dt, rows), 0) >= 1,
                  f"the autotune search never launched the {dt} {rows}-row q-tile")
    print(f"{tag} autotune search: {len(AUTOTUNE_SHAPES)} shapes in {search_s:.2f} s; launches "
          "by q-tile " + ", ".join(f"{dt} {rows} rows {n}" for (dt, rows), n in
                                    sorted(launches.items())), flush=True)

    table = AT.get_table()
    inputs, differs = {}, []
    for name, B, H, T, dt, causal in AUTOTUNE_SHAPES:
        entry = entries[name]
        dtype = getattr(torch, dt)
        static = AT.static_flash_blocks(T, T, dt, batch_heads=B * H, sms=sms)[0]
        check(entry["measured"] and entry["block_k"] == 64
              and entry["block_q"] in AT.FWD_Q_ROWS[dt], f"autotune {name}: entry {entry}")
        rs = np.random.RandomState(0)  # the search's own inputs
        q, k, v = (torch.from_numpy(rs.randn(B, H, T, D).astype(np.float32)).to("cuda", dtype)
                   for _ in range(3))
        inputs[name] = (q, k, v, causal)
        check(AT.resolve_blocks("flash_attention", B=B, H=H, Tq=T, Tk=T, D=D, dtype=dt, sms=sms)
              == (entry["block_q"], 64), f"autotune {name}: resolve_blocks is not the winner")
        before = A.flash_forward.launches_by_q_rows[(dt, entry["block_q"])]
        hits = AT.METRICS["tdl_autotune_lookups_total"][("flash_attention", "table")]
        A.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(A.flash_forward.launches_by_q_rows[(dt, entry["block_q"])] == before + 1
              and AT.METRICS["tdl_autotune_lookups_total"][("flash_attention", "table")]
              == hits + 1, f"autotune {name}: flash_attention did not launch the table's winner")
        flash_ms = time_ms(lambda: A.flash_attention(q, k, v, causal=causal))
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
        dense_ms = time_ms(lambda: A.mha_reference(q, k, v, causal=causal))
        if entry["block_q"] != static:
            differs.append(name)
        print(f"{tag} autotune {name} B={B} H={H} T={T} D={D} {dt}"
              + (" causal" if causal else "") + ": candidates (best of 20, device us) "
              + ", ".join(f"{rows} rows {us:.3f}" for rows, us in entry["candidates_us"].items())
              + f"; winner {entry['block_q']} rows, static {static} rows"
              + (" (the winner differs from the static table)" if entry["block_q"] != static
                 else "")
              + f"; median device ms: flash (winner, through flash_attention) {flash_ms:.4f}, "
              f"sdpa {sdpa_ms:.4f}, dense mha_reference {dense_ms:.4f}; flash / sdpa "
              f"{flash_ms / sdpa_ms:.2f}, flash / dense {flash_ms / dense_ms:.2f}", flush=True)
    print(f"{tag} autotune: winners differing from the static table: "
          f"{', '.join(differs) or 'none'}", flush=True)
    # the training shape timed forward plus backward with each forward
    # height (the backward kernels have one tile), into a table of its own
    both = AT.autotune_flash_attention(16, 12, 128, D, torch.bfloat16, trials=20,
                                       include_backward=True, table=AT.AutotuneTable(None))
    check(both["measured"] and both["block_q"] in AT.FWD_Q_ROWS["bfloat16"],
          f"autotune with the backward: entry {both}")
    print(f"{tag} autotune training shape, forward+backward (best of 20, device us): "
          + ", ".join(f"{rows} rows {us:.3f}" for rows, us in both["candidates_us"].items())
          + f"; winner {both['block_q']} rows", flush=True)

    # the table read back from disk answers the same
    saved = {key: table.lookup(key) for key in (
        AT.shape_key("flash_attention", B=B, H=H, Tq=T, Tk=T, D=D, dtype=dt)
        for _, B, H, T, dt, _ in AUTOTUNE_SHAPES)}
    AT.reset_table()
    reloaded = AT.get_table()
    check(reloaded is not table and len(reloaded) == len(AUTOTUNE_SHAPES)
          and all(reloaded.lookup(key) == e for key, e in saved.items()),
          "autotune: the table did not read back from disk")
    hits = AT.METRICS["tdl_autotune_lookups_total"][("flash_attention", "table")]
    for name, B, H, T, dt, causal in AUTOTUNE_SHAPES:
        check(AT.resolve_blocks("flash_attention", B=B, H=H, Tq=T, Tk=T, D=D, dtype=dt, sms=sms)
              == (entries[name]["block_q"], 64), f"autotune {name}: reloaded winner differs")
    check(AT.METRICS["tdl_autotune_lookups_total"][("flash_attention", "table")]
          == hits + len(AUTOTUNE_SHAPES), "autotune: reloaded lookups did not hit the table")
    print(f"{tag} autotune: table reloaded from disk ({len(reloaded)} entries, card "
          f"{reloaded.device!r}); every winner resolves again", flush=True)

    # the per-call cost of the lookup: flash_attention resolving its tile
    # against naming it, in turns, and resolve_blocks alone
    q, k, v, _ = inputs["serving"]
    named = lambda: A.flash_attention(q, k, v, block_q=64, block_k=64)  # noqa: E731
    resolved = lambda: A.flash_attention(q, k, v)  # noqa: E731
    pairs = []  # (resolved, named) host us, 10 pairs, the order alternating
    for i in range(10):
        first, second = (resolved, named) if i % 2 == 0 else (named, resolved)
        a, b = host_us(first, n=500), host_us(second, n=500)
        pairs.append((a, b) if i % 2 == 0 else (b, a))
    lookup_us = host_us(lambda: AT.resolve_blocks("flash_attention", B=8, H=12, Tq=128, Tk=128,
                                                  D=D, dtype="bfloat16", sms=sms), n=5000)
    print(f"{tag} host time per flash_attention call at the serving shape (launch included, "
          f"10 pairs of 500 calls, in turns): tile resolved by the table median "
          f"{statistics.median(r for r, _ in pairs):.1f} us, tile named median "
          f"{statistics.median(n for _, n in pairs):.1f} us, median paired difference "
          f"{statistics.median(r - n for r, n in pairs):+.1f} us (resolved faster in "
          f"{sum(r < n for r, n in pairs)}/10); resolve_blocks alone {lookup_us:.2f} us",
          flush=True)

    # each q-tile instantiation at its report shape, for the kernels line
    kernels = []
    for dt, heights in AT.FWD_Q_ROWS.items():
        shape = TILE_REPORT_SHAPE[dt]
        B, H, T = next((b, h, t) for n, b, h, t, _, _ in AUTOTUNE_SHAPES if n == shape)
        q, k, v, causal = inputs[shape]
        args = (None, None, causal, 1.0 / math.sqrt(D), 0)
        ref = A.flash_forward_reference(q, k, v, *args)[0]
        plain_ms = time_ms(lambda: A.flash_forward_reference(q, k, v, *args))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
        pairs = T * (T + 1) // 2 if causal else T * T
        ops = 2 * 2 * B * H * pairs * D
        nbytes = 4 * B * H * T * D * q.element_size() + B * H * T * 4
        for rows in heights:
            out = A.flash_forward(q, k, v, *args, rows)[0]
            err = (out.float() - ref.float()).abs().max().item()
            ms = time_ms(lambda: A.flash_forward(q, k, v, *args, rows))
            short = "bf16" if dt == "bfloat16" else "f32"
            kernels.append({
                "name": f"flash_fwd_{short}_q{rows}", "route": "cuda",
                "source": "deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
                "replaces": "deeplearning4j_tpu/kernels/attention.py:70",
                "launches": launches[(dt, rows)],
                "max_abs_err": max(err, tile_errors[(dt, rows)]), **report_timing(
                    tag, f"flash_fwd {dt} {rows}-row q-tiles at {shape} B={B} H={H} T={T} "
                    f"D={D}" + (" causal" if causal else ""), ms, plain_ms, library_ms,
                    nbytes, ops, "sdpa", dtype="3xtf32" if dt == "float32" else dt)})
    return kernels


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


def check_near_ties(tag, what, params, cfg, prompts, got, ref) -> int:
    """Hold generated tokens to reference tokens: a sequence may differ only
    from a token where the dense path's top-2 logit margin (a full forward
    through ``attn_impl="xla"``) is at most TIE_EPS, a float32 near-tie
    that another order of the sums can flip. Prints each such case; returns
    how many sequences are identical."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as tfm

    xla = dataclasses.replace(cfg, attn_impl="xla")
    for prompt, a, b in zip(prompts, got, ref):
        if a == b:
            continue
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        check(t < min(len(a), len(b)), f"{what}: {len(a)} tokens against {len(b)}")
        logits = tfm.forward(params, [prompt + b[:t]], xla)[0, -1]
        top2 = torch.topk(logits, 2).values
        margin = (top2[0] - top2[1]).item()
        print(f"{tag} {what}: prompt of {len(prompt)} diverges at token {t}; "
              f"dense path's top-2 margin there {margin:.3e}", flush=True)
        check(margin <= TIE_EPS, f"{what}: tokens differ from the reference at a "
                                 f"margin of {margin} > {TIE_EPS}")
    return sum(a == b for a, b in zip(got, ref))


def phase_generate(tag, launches):
    """Generation through the dense ``DecodeSlotPool`` (see the module
    docstring). Returns what phase 4b reuses: the model, its config, the
    prompts, the new-token budget and the generated tokens."""
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
    same = check_near_ties(tag, "generate", params, cfg, prompts, got, ref)
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
    return {"params": params, "cfg": cfg, "prompts": prompts, "max_new": max_new, "tokens": got}


# ----------------------------------------------------------------- phase 4b


def identity_tail_models(params, cfg, layers):
    """(target, draft, draft_cfg): a copy of ``params`` whose blocks from
    ``layers`` on get zero ``out_w`` and ``ffn_w2``, and a draft holding its
    first ``layers`` blocks. The zeroed blocks are exact no-ops only because
    the config is pre-LN (``norm_position="pre"``, the default) and
    ``init_params`` leaves every bias at zero: each then adds zero to the
    residual stream, so the draft's argmax is the target's."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as tfm

    check(cfg.norm_position == "pre", "identity-tail draft needs a pre-LN config")
    target = tfm.Transformer(cfg, device=params.device)
    target.load_state_dict(params.state_dict())
    with torch.no_grad():
        for blk in target.blocks[layers:]:
            check(not blk.out_b.any().item() and not blk.ffn_b2.any().item(),
                  "identity-tail draft needs zero out_b and ffn_b2")
            blk.out_w.zero_()
            blk.ffn_w2.zero_()
    draft_cfg = dataclasses.replace(cfg, n_layers=layers)
    draft = tfm.Transformer(draft_cfg, device=params.device)
    draft.load_state_dict({k: v for k, v in target.state_dict().items()
                           if not k.startswith("blocks.") or int(k.split(".")[1]) < layers})
    return target, draft, draft_cfg


def _step_times(pools, n):
    """Host times (ms) of ``n`` steps of each pool, in turns (one step of
    each pool per round), each step ending in a synchronize; returns
    ({name: [ms]}, {name: [step outputs]})."""
    import torch

    times = {name: [] for name in pools}
    outs = {name: [] for name in pools}
    for _ in range(n):
        for name, pool in pools.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name].append(pool.step())
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return times, outs


def phase_paged_generate(tag, launches, gen):
    """Generation through ``PagedDecodeSlotPool``, ``generate``'s default,
    on phase 4's model and prompts (``gen``): (a) the default path, tokens
    held to phase 4's; (b) copy-on-write prefix sharing; (c) speculative
    decoding with an identity-tail and with a random 2-layer draft; (d) the
    graph-replayed paged step timed against the dense eager step, in turns.
    Appends the prefill kernel launches of (a) and (c) to ``launches``."""
    import torch

    from deeplearning4j_tpu_torch.kernels.attention import flash_forward
    from deeplearning4j_tpu_torch.models import paged_decode as pd
    from deeplearning4j_tpu_torch.models import transformer as tfm

    params, cfg, prompts, max_new = gen["params"], gen["cfg"], gen["prompts"], gen["max_new"]
    L = cfg.n_layers

    def check_pool_drained(what, pool):
        stats = pool.block_stats()
        check(pool.free_slots == pool.slots and stats["blocks_free"] == pool.total_blocks
              and stats["blocks_free"] == stats["blocks_total"],
              f"{what}: slots or blocks left taken: {stats}")
        check(pool.decode_traces == 1, f"{what}: decode_traces {pool.decode_traces}, expected 1")
        check(pool.graph_replays > 0, f"{what}: the step never ran as a graph replay")

    # (a) the default path: generate builds the paged pool
    built = []

    class Recorder(pd.PagedDecodeSlotPool):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    tfm.PagedDecodeSlotPool = Recorder
    try:
        flash_forward.launches = 0
        paged = tfm.generate(params, prompts, max_new, cfg, slots=4)
        torch.cuda.synchronize()
        n = flash_forward.launches
    finally:
        del tfm.PagedDecodeSlotPool  # back to the module's lazy export
    launches.append(n)
    check(len(built) == 1, f"generate built {len(built)} paged pools, expected 1")
    pool = built.pop()
    check(n == L * len(prompts), f"paged generate: {n} kernel launches, expected "
                                 f"{L} x {len(prompts)} admissions")
    check(all(len(g) == max_new for g in paged), "paged generate: wrong number of tokens")
    same = check_near_ties(tag, "paged generate", params, cfg, prompts, paged, gen["tokens"])
    check_pool_drained("paged generate", pool)
    print(f"{tag} paged generate (default pool, block_T {pool.block_T}, {pool.total_blocks} "
          f"blocks): {same}/{len(prompts)} sequences token-identical to phase 4's dense pool; "
          f"flash launches {n} for {len(prompts)} admissions; decode_traces "
          f"{pool.decode_traces}, {pool.graph_replays} graph replays; blocks free "
          f"{pool.block_stats()['blocks_free']}/{pool.total_blocks}", flush=True)
    del pool

    # (b) copy-on-write: a 256-token prefix (16 full blocks), tails of 7 and 19
    rs = np.random.RandomState(9)
    prefix = rs.randint(0, cfg.vocab_size, 256).tolist()
    pair = [prefix + rs.randint(0, cfg.vocab_size, n).tolist() for n in (7, 19)]
    solo_pool = pd.PagedDecodeSlotPool(params, cfg, slots=4)
    solo = [tfm.generate(params, [p], max_new, cfg, pool=solo_pool)[0] for p in pair]
    del solo_pool
    pool = pd.PagedDecodeSlotPool(params, cfg, slots=4)
    free0 = pool.block_stats()["blocks_free"]
    sa, fa = pool.admit(pair[0], max_new)
    used_a = free0 - pool.block_stats()["blocks_free"]
    sb, fb = pool.admit(pair[1], max_new)
    used_b = free0 - used_a - pool.block_stats()["blocks_free"]
    stats = pool.block_stats()
    check(stats["cow_shared_blocks"] == 16, f"CoW: {stats['cow_shared_blocks']} shared blocks, "
                                            f"expected 16")
    check(used_b < used_a, f"CoW: the sharer paid {used_b} blocks, the first {used_a}")
    toks = {sa: [fa], sb: [fb]}
    while min(len(t) for t in toks.values()) < max_new:
        for slot, new in pool.step().items():
            toks[slot].extend(new)
    shared = [toks[sa][:max_new], toks[sb][:max_new]]
    pool.release(sa)
    pool.release(sb)
    same = check_near_ties(tag, "CoW", params, cfg, pair, shared, solo)
    check_pool_drained("CoW", pool)
    print(f"{tag} paged CoW: prompts of {len(pair[0])} and {len(pair[1])} tokens sharing a "
          f"256-token prefix: first paid {used_a} blocks, sharer {used_b}; "
          f"cow_shared_blocks {stats['cow_shared_blocks']}, cow_saved_blocks "
          f"{stats['cow_saved_blocks']}; {same}/2 token-identical to solo runs", flush=True)
    del pool

    # (c) speculative decoding, spec_tokens=4
    spec_pools = {}
    target, draft, draft_cfg = identity_tail_models(params, cfg, 2)
    plain = tfm.generate(target, prompts, max_new, cfg, slots=4)
    random_cfg = dataclasses.replace(cfg, n_layers=2)
    random_draft = tfm.init_params(7, random_cfg, device="cuda")
    for kind, tgt, drf, dcfg, ref in (("identity-tail", target, draft, draft_cfg, plain),
                                      ("random", params, random_draft, random_cfg, paged)):
        pool = pd.PagedDecodeSlotPool(tgt, cfg, slots=4, draft_params=drf, draft_cfg=dcfg,
                                      spec_tokens=4)
        flash_forward.launches = 0
        got = tfm.generate(tgt, prompts, max_new, cfg, pool=pool)
        torch.cuda.synchronize()
        n = flash_forward.launches
        launches.append(n)
        want = (L + dcfg.n_layers) * len(prompts)
        check(n == want, f"speculative ({kind}): {n} kernel launches, expected {want}")
        same = check_near_ties(tag, f"speculative ({kind})", tgt, cfg, prompts, got, ref)
        check_pool_drained(f"speculative ({kind})", pool)
        stats = pool.block_stats()
        rate = stats["spec_accepted"] / stats["spec_proposed"]
        print(f"{tag} speculative ({kind} {dcfg.n_layers}-layer draft, spec_tokens 4): "
              f"{same}/{len(prompts)} sequences token-identical to plain paged decoding; "
              f"acceptance {stats['spec_accepted']}/{stats['spec_proposed']} = {rate:.3f}; "
              f"flash launches {n}; decode_traces {pool.decode_traces}", flush=True)
        if kind == "identity-tail":
            check(rate >= 0.9, f"identity-tail acceptance {rate:.3f} < 0.9")
        spec_pools[kind] = pool

    # (d) step time: 4 live slots at the same positions, dense eager step
    # against the paged graph replay, in turns
    steps = 30
    dense = tfm.DecodeSlotPool(params, cfg, slots=4)
    paged_pool = pd.PagedDecodeSlotPool(params, cfg, slots=4)
    for p in prompts[:4]:
        dense.admit(p, 64)
        paged_pool.admit(p, 64)
    for pool in (dense, paged_pool):  # warm-up; the paged pool captures here
        pool.step()
    check(paged_pool.decode_traces == 1 and paged_pool.graph_replays == 1,
          "paged step: not captured once and replayed")
    eager_runs = []
    body = paged_pool._step_body
    paged_pool._step_body = lambda *a: eager_runs.append(1) or body(*a)
    times, _ = _step_times({"dense eager": dense, "paged graph": paged_pool}, steps)
    check(not eager_runs and paged_pool.graph_replays == 1 + steps
          and paged_pool.decode_traces == 1,
          f"paged step: {len(eager_runs)} eager runs, {paged_pool.graph_replays} replays")
    check(np.array_equal(dense._positions[:4], paged_pool._positions[:4]),
          "dense and paged pools at different positions")
    for name, ts in times.items():
        print(f"{tag} decode step slots=4 fp32, {name}: {spread(ts)}, "
              f"{4 / statistics.median(ts) * 1e3:.1f} tokens/s at the median", flush=True)
    print(f"{tag} decode step paged graph / dense eager: "
          f"{statistics.median(times['paged graph']) / statistics.median(times['dense eager']):.3f}"
          f" (medians, {steps} steps each in turns, all {steps} paged steps replays)", flush=True)
    device_profile(tag, "paged decode step (graph replay), slots=4 fp32",
                   lambda: paged_pool.step(), reps=5)
    paged_pool._step_body = body
    check(not eager_runs, "paged step ran eagerly under the profiler")
    del dense, paged_pool

    # the speculative step: 4 live slots, step time and tokens per step
    for kind, pool in spec_pools.items():
        for p in prompts[:4]:
            pool.admit(p, 200)
        pool.step()
        accepted, replays = pool.spec_accepted, pool.graph_replays
        times, outs = _step_times({kind: pool}, steps)
        check(pool.graph_replays == replays + steps and pool.decode_traces == 1,
              f"speculative ({kind}) step: not replayed")
        per_slot = statistics.mean(sum(len(v) for v in out.values()) / len(out)
                                   for out in outs[kind])
        acc = (pool.spec_accepted - accepted) / (steps * 4)
        print(f"{tag} speculative step ({kind} draft) slots=4 fp32: {spread(times[kind])}; "
              f"{per_slot:.3f} tokens per slot per step ({acc:.3f} drafted tokens accepted), "
              f"{4 * per_slot / statistics.median(times[kind]) * 1e3:.1f} tokens/s at the median",
              flush=True)


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
    docstring). Appends the launches of each kernel on the main path to
    ``launches``: the float32 step's backward pair under the ``_f32``
    names, the bf16 steps' under the plain names."""
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
    counts = _read_counts()
    _check_step_counts("fp32 step", counts, 1, cfg.n_layers)
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        launches[f"{name}_f32"].append(counts[name])
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
    return ms


# the seven updaters of this slice's training surface, each with one of the
# five schedules it added (AdaDelta takes no learning rate, in either
# package: its schedule rides along unused)
def _new_updaters():
    from deeplearning4j_tpu_torch.nn import updaters as U

    return [U.Nesterovs(1e-3, momentum=0.9, lr_schedule=U.ExponentialSchedule(1e-3, 0.97)),
            U.AdaGrad(1e-3, lr_schedule=U.InverseSchedule(1e-3, 0.1, 0.75)),
            U.RmsProp(1e-4, lr_schedule=U.StepSchedule(1e-4, 0.5, 2.0)),
            U.AdaDelta(lr_schedule=U.SigmoidSchedule(1e-3, 0.3, 10)),
            U.AdaMax(1e-4, lr_schedule=U.SigmoidSchedule(1e-4, 0.3, 10)),
            U.Nadam(1e-4, lr_schedule=U.PolySchedule(1e-4, 1.0, 50)),
            U.AMSGrad(1e-4, lr_schedule=U.ExponentialSchedule(1e-4, 0.9, "EPOCH"))]


# the kind of value each state slot holds: a mean of squares (>= 0), a
# maximum of |g| (>= 0, the scale of |g|), or else a signed mean of g
SQUARE_SLOTS = {"h", "g2", "msg", "msdx", "v", "vhat"}
ABS_SLOTS = {"u"}
# the first step's update is checked on these tensors
UPDATE_CHECKED = ("embed.tok", "blocks.0.qkv_w", "mlm.ln_bias")
UPDATE_REL = 1e-5  # float32 on the card against float64 on the CPU, of the norm


def reference_update(upd, g, state, it):
    """One tensor's update at iteration ``it`` in float64 (numpy) from its
    gradient and state: each updater's formula written out on its own,
    independent of ``nn.updaters``."""
    name = type(upd).__name__
    lr = upd.lr_schedule.value(it, 0) if upd.lr_schedule is not None else upd.learning_rate
    t = it + 1
    if name == "Nesterovs":
        v = upd.momentum * state["v"] - lr * g
        return lr * g - upd.momentum * v
    if name == "AdaGrad":
        return lr * g / (np.sqrt(state["h"] + g * g) + upd.epsilon)
    if name == "RmsProp":
        a = upd.rms_decay * state["g2"] + (1 - upd.rms_decay) * g * g
        return lr * g / (np.sqrt(a) + upd.epsilon)
    if name == "AdaDelta":
        msg = upd.rho * state["msg"] + (1 - upd.rho) * g * g
        return g * np.sqrt(state["msdx"] + upd.epsilon) / np.sqrt(msg + upd.epsilon)
    b1, b2, eps = upd.beta1, upd.beta2, upd.epsilon
    m = b1 * state["m"] + (1 - b1) * g
    if name == "AdaMax":
        return lr / (1 - b1 ** t) * m / (np.maximum(b2 * state["u"], np.abs(g)) + eps)
    v = b2 * state["v"] + (1 - b2) * g * g
    if name == "Nadam":
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        return lr * (b1 * m / c1 + (1 - b1) * g / c1) / (np.sqrt(v / c2) + eps)
    if name == "AMSGrad":
        vhat = np.maximum(state["vhat"], v)
        return lr * np.sqrt(1 - b2 ** t) / (1 - b1 ** t) * m / (np.sqrt(vhat) + eps)
    raise SmokeFailure(f"no reference update for {name}")


def phase_updaters(tag, launches):
    """Phase 5's model and batch (BERT-base, bf16, B=16, T=128, P=19) under
    each of the seven new updaters with a schedule: three train steps from
    the same initial weights and a nonzero state bridged in as a JAX-shaped
    numpy pytree (``updater_state_from_jax``); a finite loss every step;
    the first step's update of three tensors within UPDATE_REL (of its
    norm) of the float64 update from the same gradient and state; 12
    launches of each kernel per step."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.models.weights import params_to_numpy, updater_state_from_jax

    B, T, P = 16, 128, 19
    cfg = tfm.TransformerConfig.bert_base(max_len=T, dropout=0.0)
    batch = _mlm_batch(cfg, np.random.RandomState(5), B, T, P)
    params = tfm.init_params(3, cfg, device="cuda")
    initial = {n: t.detach().clone() for n, t in params.state_dict().items()}
    # three nonzero JAX-shaped state trees from a numpy seed, of the scales
    # a state has after some steps with gradients ~1e-4: signed means (first
    # moments, momentum), means of squares, and maxima of |g|
    rng = np.random.default_rng(11)
    shapes = params_to_numpy(params)

    def tree(node, kind):
        if isinstance(node, dict):
            return {k: tree(v, kind) for k, v in node.items()}
        if isinstance(node, list):
            return [tree(v, kind) for v in node]
        x = rng.standard_normal(node.shape, dtype=np.float32)
        if kind == "square":
            return x * x * np.float32(1e-8)
        return (np.abs(x) if kind == "abs" else x) * np.float32(1e-4)

    trees = {kind: tree(shapes, kind) for kind in ("signed", "square", "abs")}

    def kind(slot):
        return "square" if slot in SQUARE_SLOTS else "abs" if slot in ABS_SLOTS else "signed"

    for upd in _new_updaters():
        name = type(upd).__name__
        params.load_state_dict(initial)
        state = updater_state_from_jax({slot: trees[kind(slot)]
                                        for slot in upd.init({"x": torch.zeros(1)})}, params)
        first = {}
        apply = upd.apply

        def spy(grads, st, prm, it, epoch=0):
            if not first:  # the first step's gradient and state, before the update
                first["g"] = {n: grads[n].double().cpu().numpy() for n in UPDATE_CHECKED}
                first["s"] = {slot: {n: st[slot][n].double().cpu().numpy()
                                     for n in UPDATE_CHECKED} for slot in st}
            u, st = apply(grads, st, prm, it, epoch)
            if "u" not in first:
                first["u"] = {n: u[n].double().cpu().numpy() for n in UPDATE_CHECKED}
            return u, st

        upd.apply = spy
        step = tfm.make_train_step(cfg, upd)
        losses, times = [], []
        _zero_counts()
        for it in range(3):
            t0 = time.perf_counter()
            _, state, loss = step(params, state, batch, it)
            losses.append(loss.item())
            times.append((time.perf_counter() - t0) * 1e3)
        counts = _read_counts()
        _check_step_counts(f"{name} steps", counts, 3, cfg.n_layers)
        for kernel, n in counts.items():
            launches[kernel].append(n)
        check(all(math.isfinite(x) for x in losses), f"{name}: non-finite loss {losses}")
        errs = {}
        for n in UPDATE_CHECKED:
            ref = reference_update(upd, first["g"][n], {s: v[n] for s, v in first["s"].items()}, 0)
            errs[n] = np.linalg.norm(first["u"][n] - ref) / max(np.linalg.norm(ref), 1e-300)
        print(f"{tag} updater {name} + {type(upd.lr_schedule).__name__} (slots "
              f"{', '.join(sorted(state)) or 'none'}): losses "
              + " ".join(f"{x:.5f}" for x in losses) + "; first update vs float64: "
              + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f"; step ms (steps 2 and 3; step 1 also copies the checked tensors to the "
              f"host) {times[1]:.1f} {times[2]:.1f}; launches {counts}", flush=True)
        for n, e in errs.items():
            check(e <= UPDATE_REL, f"{name}: the first update of {n} is {e:.2e} of its norm "
                                   f"from the float64 update")
        del state, first
    del params, initial, trees


REMAT_REL = 1e-6  # remat against no remat, float32 compute: loss, and each gradient's norm


def phase_remat(tag, launches):
    """Per-block remat at phase 5's model and batch: a float32-compute step
    with ``remat=True`` against one without, at dropout 0.1 from two
    generators seeded alike (loss and each gradient within REMAT_REL, the
    generators left alike); the peak memory of a bf16 Adam step with and
    without remat (remat's must be lower); 20 bf16 steps of each, in turns;
    24 forward and 12 of each backward launch per remat step."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    B, T, P = 16, 128, 19
    base = tfm.TransformerConfig.bert_base(max_len=T, dropout=0.1)
    batch = _mlm_batch(base, np.random.RandomState(5), B, T, P)
    cfg32 = dataclasses.replace(base, compute_dtype=torch.float32)
    params = tfm.init_params(3, cfg32, device="cuda")
    gens = [torch.Generator(device="cuda").manual_seed(21) for _ in range(2)]
    loss, grads = tfm.loss_and_grads(params, batch, cfg32, gens[0])
    _zero_counts()
    rloss, rgrads = tfm.loss_and_grads(params, batch, dataclasses.replace(cfg32, remat=True),
                                       gens[1])
    counts = _read_counts()
    check(counts == {"flash_fwd": 2 * base.n_layers, "flash_bwd_dkv": base.n_layers,
                     "flash_bwd_dq": base.n_layers}, f"remat fp32 step: launches {counts}")
    launches["flash_fwd_f32"].append(counts["flash_fwd"])
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        launches[f"{name}_f32"].append(counts[name])
    loss_rel = abs(rloss.item() - loss.item()) / abs(loss.item())
    worst_name, worst = max(((n, ((rgrads[n] - g).norm() / g.norm().clamp(min=1e-30)).item())
                             for n, g in grads.items()), key=lambda x: x[1])
    print(f"{tag} remat fp32 step, dropout 0.1: loss {rloss.item():.7f} vs {loss.item():.7f} "
          f"(rel {loss_rel:.2e}, bitwise {rloss.item() == loss.item()}); largest gradient "
          f"difference {worst:.2e} of its norm ({worst_name}); launches {counts}", flush=True)
    check(loss_rel <= REMAT_REL, f"remat: loss differs by {loss_rel:.2e} relative")
    check(worst <= REMAT_REL, f"remat: gradient {worst_name} differs by {worst:.2e} of its norm")
    check(torch.equal(gens[0].get_state(), gens[1].get_state()),
          "remat: the generator ends the step elsewhere than without remat")
    del params, grads, rgrads

    # bf16 Adam steps: peak memory once each, then 20 of each in turns
    models = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        prm = tfm.init_params(3, cfg, device="cuda")
        upd = Adam(1e-4)
        models[remat] = [cfg, prm, upd.init(prm), tfm.make_train_step(cfg, upd),
                         torch.Generator(device="cuda").manual_seed(5)]
    def peak_of(fn):
        """(peak bytes allocated during ``fn``, bytes allocated before it)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(), resident

    peak, fwd_bwd = {}, {}
    for remat, (cfg, prm, st, step, gen) in models.items():
        step(prm, st, batch, 0, gen)  # warm-up
        peak[remat] = peak_of(lambda: step(prm, st, batch, 1, gen))
        # the forward and backward alone: the updater's temporaries left out
        fwd_bwd[remat] = peak_of(lambda: tfm.loss_and_grads(prm, batch, cfg, gen))
    for what, pk in (("step", peak), ("forward+backward (loss_and_grads)", fwd_bwd)):
        print(f"{tag} remat bf16 {what} peak memory: without {pk[False][0] / 2**20:.1f} MiB "
              f"({(pk[False][0] - pk[False][1]) / 2**20:.1f} MiB above the resident "
              f"{pk[False][1] / 2**20:.1f} MiB), with remat {pk[True][0] / 2**20:.1f} MiB "
              f"({(pk[True][0] - pk[True][1]) / 2**20:.1f} MiB above the resident "
              f"{pk[True][1] / 2**20:.1f} MiB)", flush=True)
    check(peak[True][0] < peak[False][0], f"remat did not lower the peak memory: {peak}")
    n = 20
    times = {False: [], True: []}
    _zero_counts()
    for it in range(2, 2 + n):
        for remat, (cfg, prm, st, step, gen) in models.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(prm, st, batch, it, gen)[2].item()
            times[remat].append((time.perf_counter() - t0) * 1e3)
    counts = _read_counts()
    L = base.n_layers
    check(counts == {"flash_fwd": 3 * L * n, "flash_bwd_dkv": 2 * L * n,
                     "flash_bwd_dq": 2 * L * n},
          f"remat timing: launches {counts} for {n} steps of each")
    for name, c in counts.items():
        launches[name].append(c)
    print(f"{tag} train step bf16 dropout 0.1, in turns: without remat {spread(times[False])}, "
          f"with remat {spread(times[True])}; remat / plain "
          f"{statistics.median(times[True]) / statistics.median(times[False]):.3f}; launches "
          f"{counts} ({2 * L} forward per remat step)", flush=True)
    del models


def print_peak_share(tag, step_ms):
    """The train step's achieved share of the card's dense bf16 peak: the
    flops ``layer_costs`` counts for phase 5's step, over its median time."""
    from deeplearning4j_tpu_torch.models import TransformerConfig, layer_costs

    flops = sum(r["flops"] for r in layer_costs(
        TransformerConfig.bert_base(max_len=128), 16, 128, 19, train=True))
    share = flops / (step_ms / 1e3) / PEAK_OPS_PER_S["bfloat16"]
    print(f"{tag} train step achieved share of the dense bf16 peak: {share:.4f} "
          f"({flops:.4e} flops by layer_costs(bert_base, 16, 128, 19, train=True) in the "
          f"{step_ms:.3f} ms median step of phase 5, against 989 TFLOP/s)", flush=True)


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
    try:
        t0 = time.perf_counter()
        _build.build_all()
        print(f"{tag} phase 1 build: {time.perf_counter() - t0:.2f} s "
              f"({', '.join(_build.build_info['built']) or 'cached'})", flush=True)
        for line in _build.build_info["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  " + line.strip(), flush=True)
        report_bf16_registers(tag, _build.build_info["log"])
        report_f32_registers(tag, _build.build_info["log"])

        errors, tile_errors = phase_kernels(tag)
        timing = time_kernel(tag)
        f32_timing = time_f32_forward(tag)
        phase_backward_kernels(tag)
        phase_auto_routing(tag)
        bwd_timing = time_backward(tag)
        print("phase 2 kernel vs plain: ok", flush=True)
        t2b = time.perf_counter()
        tile_kernels = phase_autotune(tag, tile_errors)
        print(f"phase 2b autotune: ok ({time.perf_counter() - t2b:.1f} s)", flush=True)
        launches = {name: [] for name in ("flash_fwd", "flash_fwd_f32", "flash_bwd_dkv",
                                          "flash_bwd_dq", "flash_bwd_dkv_f32", "flash_bwd_dq_f32")}
        phase_encoder(tag, launches["flash_fwd"])
        print("phase 3 encoder serving: ok", flush=True)
        gen = phase_generate(tag, launches["flash_fwd_f32"])
        print("phase 4 generation: ok", flush=True)
        t4b = time.perf_counter()
        phase_paged_generate(tag, launches["flash_fwd_f32"], gen)
        del gen
        print(f"phase 4b paged generation: ok ({time.perf_counter() - t4b:.1f} s)", flush=True)
        step_ms = phase_train(tag, launches)
        print("phase 5 training: ok", flush=True)
        t5 = time.perf_counter()
        phase_updaters(tag, launches)
        print(f"phase 5b updaters: ok ({time.perf_counter() - t5:.1f} s)", flush=True)
        t5 = time.perf_counter()
        phase_remat(tag, launches)
        print(f"phase 5c remat: ok ({time.perf_counter() - t5:.1f} s)", flush=True)
        print_peak_share(tag, step_ms)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1

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
    }, {
        # the float32 backward pair (the float32 step check), kernels of
        # their own in the same source, timed at that step's shape
        "name": "flash_bwd_dkv_f32", "route": "cuda", "source": bwd,
        "replaces": "deeplearning4j_tpu/kernels/attention.py:213",
        "launches": sum(launches["flash_bwd_dkv_f32"]), **bwd_timing["flash_bwd_dkv_f32"],
    }, {
        "name": "flash_bwd_dq_f32", "route": "cuda", "source": bwd,
        "replaces": "deeplearning4j_tpu/kernels/attention.py:258",
        "launches": sum(launches["flash_bwd_dq_f32"]), **bwd_timing["flash_bwd_dq_f32"],
    }, *tile_kernels]
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
