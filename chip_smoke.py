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
   5's median step;
6. the MultiLayerNetwork path: (a) LeNet (conv 20 and 50 of 5x5 "same",
   max pool 2x2, dense 500, Adam 1e-3) at batch 128 of the synthetic MNIST:
   a float32 fit against the same fit on the CPU (score 1e-5 relative, each
   update within 1e-4 of its norm), then bf16 training until held-out
   accuracy reaches 0.90 (at most 6 epochs of 1280 examples), fit step time
   and images/s, ``output()`` latency, a profile and the share of the bf16
   peak; (b) the GravesLSTM char-RNN (vocab 77, hidden 256, 2 layers, tbptt
   50) at B=64, T=200: a float32 fit against the CPU's, 10 bf16 fits with a
   falling score, chars/s, a profile, and ``rnn_time_step`` over 20 steps
   against ``output()``; (c) SelfAttentionLayer (4 heads of 64) →
   GlobalPooling → Output on [16, 256, 128] with a ragged features mask: a
   float32 Sgd step through the flash kernels against the same step on the
   CPU, the dense path (phase 5's limits), bf16 Adam steps each launching
   the flash forward, dkv and dq once, and then the bf16 kernels on the
   layer's own q/k/v and key mask against their plain versions (phase 2's
   bf16 limits). Phase 6a and 6b time batches staged on the card;
7. the ComputationGraph path: (a) ResNet-50 (published widths, 25,557,032
   parameters, Nesterovs(0.1, 0.9)) at bench.py's shape, 3x224x224, 1000
   classes: a float32 fit at batch 4 against the same fit on the CPU (score,
   every update and the BN running statistics), then bf16 training at batch
   256 on a batch staged on the card: step time (median and p75 of 40 after
   3 warm-up steps), images/s, peak memory, a profile (busy share, top
   kernels), the share of the bf16 peak, ``output()`` latency at batch 256,
   and the step with ``cudnn.benchmark`` off and on in turns; (b)
   InceptionResNetV1 at its defaults (3x160x160, blocks (5, 10, 5), 1001
   classes, two outputs): a float32 fit against the CPU's at batch 4 with
   its DropoutLayer off, unit-norm embeddings, then bf16 Adam at batch 128:
   step time, images/s, peak memory, a profile; (c) a graph of two
   AttentionVertex nodes (cross-attention on q [16,256,96] and kv
   [16,256,200], self-attention on q; 4 heads of 64) beside a
   RecurrentAttentionLayer, MergeVertex → GlobalPooling → Output: a float32
   Sgd step against the CPU's dense path (phase 5's limits), bf16 Adam steps
   each launching the flash forward, dkv and dq twice, and the bf16 kernels
   on each vertex's own q/k/v against their plain versions. Phase 2's
   ``rect_q96_k200`` case holds the kernels at 7c's non-causal rectangle;
8. serving through ``JsonModelServer`` (every request must answer 200):
   (a) bench.py's serving configuration, a float32 Dense(64->128, relu) ->
   Output(8) MLN behind ``batch_limit(16).queue_size(256)``, 16 clients x
   20 one-row requests: req/s, p50/p99, mean coalesced rows, each answer
   equal to its row's ``output`` alone; (b) phase 6c's attention MLN in
   bf16 behind ``batch_limit(8)`` (8 clients x 8 sequences): one flash
   forward per executed batch, each answer within one bf16 ulp of its
   sequence's ``output`` alone at the served batch shape; then ResNet-50's
   float32 ``output()`` (a ComputationGraph) behind ``batch_limit(32)``, 64
   one-image requests from 8 clients, one [1, 1000] answer per image; (c)
   phase 4's generator behind a generative server over a
   ``PagedDecodeSlotPool(slots=4)``: the six prompts from six concurrent
   clients, in turns with direct ``generate`` on a warm pool (the cost of
   the queue and HTTP), tokens held to phase 4's, 12 float32 forward
   launches per admission; then bench.py's serving_pool trace shape (max_new
   mix 4/8/16/48, diurnal 0.4, a 10x burst over 15% of 6 s) replayed into
   ``GenerativeInferenceExecutor(slots=8)``, continuous and static: p99,
   tokens/s, slot occupancy; (d) a ``ServingPool`` of two replica processes
   of 8c's model (``chip_smoke.py:serving_replica``, one CUDA context each,
   one kernel build shared through the pool's compile cache): the six
   prompts through the router (tokens held to phase 4's), ``scale_to(3)``
   and the third replica's time to ready beside the first two's, and a
   draining stop after which every replica exited 0.

A line before the last is a JSON object describing each kernel (launch
counts on the main path, error against the plain version, times and the
card's bound; the forward also by q-tile instantiation, with the launches
of the autotune search), then the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero and
prints no result. The script imports only the port
(``deeplearning4j_tpu_torch``), never JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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


# device kernels by kind, for the graphs' breakdowns: (kind, name fragments)
KERNEL_KINDS = (("layout transposes (cuDNN NCHW<->NHWC)", ("nchwToNhwc", "nhwcToNchw")),
                ("convolutions and GEMMs", ("cudnn", "xmma", "sm90_", "gemm", "conv", "cutlass",
                                            "dgrad", "wgrad")),
                ("reductions", ("reduce_kernel",)),
                ("casts and copies", ("copy_kernel", "direct_copy")),
                ("pooling", ("pool",)),
                ("other elementwise", ("elementwise",)))


def kernel_kind(name) -> str:
    for kind, fragments in KERNEL_KINDS:
        if any(f in name for f in fragments):
            return kind
    return "other"


def device_profile(tag, what, fn, reps=3, top=6, by_kind=False):
    """Where a request's time goes: torch.profiler over ``reps`` runs of
    ``fn``; prints the card's busy share of the host's wall time, the
    kernels that take most device time and every flash kernel (and, with
    ``by_kind``, the device time by kind of kernel, ``KERNEL_KINDS``). The
    profiler's own host cost makes the wall time (and so the idle share) an
    upper bound."""
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
    if by_kind:
        kinds = {}
        for name, us in by_name.items():
            kinds[kernel_kind(name)] = kinds.get(kernel_kind(name), 0.0) + us
        print(f"{tag} {what} device time by kind: " + "; ".join(
            f"{kind} {us / reps / 1e3:.3f} ms ({us / busy_us:.1%})"
            for kind, us in sorted(kinds.items(), key=lambda kv: -kv[1])), flush=True)


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
        # non-causal cross-attention, Tq != Tk: phase 7c's AttentionVertex shape
        ("rect_q96_k200", 2, 4, 96, 200, 64, False, "pad"),
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


GEN_LENGTHS, GEN_MAX_NEW = (20, 100, 130, 200, 300, 64), 16


def generator_model(device="cuda"):
    """Phase 4's generator: a causal model of BERT-base width in float32,
    random weights from seed 1, and its six ragged prompts (the same in
    every process that calls this: phases 4, 4b, 8c and 8d's replicas)."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig.bert_base(causal=True, dropout=0.0,
                                          compute_dtype=torch.float32)
    params = tfm.init_params(1, cfg, device=device)
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist() for n in GEN_LENGTHS]
    return params, cfg, prompts


def phase_generate(tag, launches):
    """Generation through the dense ``DecodeSlotPool`` (see the module
    docstring). Returns what phase 4b reuses: the model, its config, the
    prompts, the new-token budget and the generated tokens."""
    import torch

    from deeplearning4j_tpu_torch.kernels.attention import flash_forward
    from deeplearning4j_tpu_torch.models import transformer as tfm

    params, cfg, prompts = generator_model()
    lengths, max_new = GEN_LENGTHS, GEN_MAX_NEW

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


# ------------------------------------------------------------------ phase 6

# The MultiLayerNetwork models at bench.py's CUDA shapes, their published widths
LENET_BATCH, LENET_EXAMPLES, LENET_MAX_EPOCHS, LENET_TARGET = 128, 1280, 6, 0.90
LSTM_B, LSTM_T, LSTM_FITS = 64, 200, 10
ATTN_B, ATTN_C, ATTN_T, ATTN_HEADS, ATTN_STEPS = 16, 256, 128, 4, 20
# the card's float32 fit against the CPU's, same weights and batch: the score
# within 1e-5 relative, each parameter's update within 1e-4 of its norm
MLN_LOSS_REL = 1e-5
MLN_UPDATE_REL = 1e-4
# rnn_time_step one step at a time against output() over the sequence,
# float32 softmax outputs: products in another order
RNN_STEP_ATOL = 1e-5


@contextlib.contextmanager
def float32_policy():
    """The precision policy set to float32 (no bf16 compute) for a block."""
    from deeplearning4j_tpu_torch.common.environment import env

    old = env().matmul_precision
    env().set("matmul_precision", "float32")
    try:
        yield
    finally:
        env().set("matmul_precision", old)


def _update_errors(net, ref, before, ref_before):
    """Each parameter's update on ``net`` against ``ref``'s, as a share of
    the norm of ``ref``'s update: {name: error}."""
    errs = {}
    for (i, k, p), (_, _, r) in zip(net._param_entries(), ref._param_entries()):
        got = p.detach().double().cpu() - before[f"{i}.{k}"]
        want = r.detach().double().cpu() - ref_before[f"{i}.{k}"]
        errs[f"{i}.{k}"] = ((got - want).norm() / want.norm().clamp(min=1e-300)).item()
    return errs


def _whole_update_error(net, ref, before, ref_before):
    """The update of all parameters as one vector on ``net`` against
    ``ref``'s, as a share of the norm of ``ref``'s."""
    num = den = 0.0
    for (i, k, p), (_, _, r) in zip(net._param_entries(), ref._param_entries()):
        got = p.detach().double().cpu() - before[f"{i}.{k}"]
        want = r.detach().double().cpu() - ref_before[f"{i}.{k}"]
        num += float(((got - want) ** 2).sum())
        den += float((want ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5


def _snapshot(net):
    return {f"{i}.{k}": p.detach().double().cpu().clone() for i, k, p in net._param_entries()}


def check_fit_on_cpu(tag, what, make_net, ds, loss_rel=MLN_LOSS_REL,
                     update_rel=MLN_UPDATE_REL, all_rel=None, bn_rel=None):
    """One float32 fit of the same network on the card and on the CPU (the
    explicit reference), from the same weights and batch: the score and
    every parameter's update (and, where given, the update of all parameters
    as one vector and each BN layer's running statistics, as a share of
    their norms). Returns the kernels' launches in the card's fit."""
    with float32_policy():
        card, cpu = make_net("cuda"), make_net("cpu")
        cpu.set_params(card.params().cpu())
        before, cpu_before = _snapshot(card), _snapshot(cpu)
        _zero_counts()
        t0 = time.perf_counter()
        card.fit(ds)
        card_score = card.score_
        card_s = time.perf_counter() - t0
        counts = _read_counts()
        t0 = time.perf_counter()
        cpu.fit(ds)
        cpu_s = time.perf_counter() - t0
        rel = abs(card_score - cpu.score_) / abs(cpu.score_)
        errs = _update_errors(card, cpu, before, cpu_before)
        whole = _whole_update_error(card, cpu, before, cpu_before)
        bn_errs = {}
        for k, st in card.bn_state.items():
            for stat in ("mean", "var"):
                want = getattr(cpu.bn_state[k], stat).double()
                got = getattr(st, stat).double().cpu()
                bn_errs[f"{k}.{stat}"] = ((got - want).norm() / want.norm()).item()
    worst = max(errs, key=errs.get)
    median = statistics.median(errs.values())
    print(f"{tag} {what} float32 fit, card vs CPU: score {card_score:.7f} vs {cpu.score_:.7f} "
          f"(rel {rel:.2e}); largest update error {errs[worst]:.2e} of its norm ({worst}, "
          f"{len(errs)} tensors), median {median:.2e}, all parameters as one vector {whole:.2e}; "
          f"card {card_s:.3f} s, CPU {cpu_s:.3f} s", flush=True)
    check(rel <= loss_rel, f"{what}: float32 score differs from the CPU's by {rel:.2e}")
    check(errs[worst] <= update_rel,
          f"{what}: update of {worst} differs from the CPU's by {errs[worst]:.2e}")
    if all_rel is not None:
        check(whole <= all_rel, f"{what}: the update of all parameters differs from the CPU's "
                                f"by {whole:.2e} of its norm")
    if bn_rel is not None:
        bn_worst = max(bn_errs, key=bn_errs.get)
        print(f"{tag} {what} float32 fit, BN running statistics card vs CPU: largest error "
              f"{bn_errs[bn_worst]:.2e} of the norm ({bn_worst}, {len(bn_errs)} tensors)",
              flush=True)
        check(bn_errs[bn_worst] <= bn_rel, f"{what}: BN statistics {bn_worst} differ from the "
                                           f"CPU's by {bn_errs[bn_worst]:.2e}")
    return counts


def print_mln_peak_share(tag, what, conf, batch, step_ms, input_type=None):
    """A train step's achieved share of the dense bf16 peak: three times the
    forward flops of ``flops_per_example`` (forward + backward), per step;
    ``input_type`` gives a sequence's length where the configuration's
    input type leaves it open."""
    if input_type is not None:
        conf = dataclasses.replace(conf, input_type=input_type)
    fwd = sum(l.flops_per_example(it) for l, it in zip(conf.layers, conf.input_types()))
    flops = 3.0 * fwd * batch
    share = flops / (step_ms / 1e3) / PEAK_OPS_PER_S["bfloat16"]
    print(f"{tag} {what} achieved share of the dense bf16 peak: {share:.3e} ({flops:.4e} "
          f"flops per step, 3 x flops_per_example x {batch}, in the {step_ms:.3f} ms median "
          f"step, against 989 TFLOP/s)", flush=True)


def phase_lenet(tag):
    """6a: LeNet (published widths) at bench.py's CUDA shape, batch 128 of
    the port's synthetic MNIST (byte for byte the JAX package's)."""
    import torch

    from deeplearning4j_tpu_torch.data import DataSet, MnistDataSetIterator
    from deeplearning4j_tpu_torch.models import LeNet

    train = MnistDataSetIterator(LENET_BATCH, train=True, num_examples=LENET_EXAMPLES)
    test = MnistDataSetIterator(256, train=False, num_examples=LENET_EXAMPLES)
    check(train.synthetic, "LeNet: expected the synthetic MNIST (no IDX files in the checkout)")
    host_batches = list(train)
    check_fit_on_cpu(tag, f"LeNet [{LENET_BATCH},1,28,28]",
                     lambda dev: LeNet().init(device=dev), host_batches[0])

    net = LeNet().init(device="cuda")
    # the training batches staged on the card once, as bench.py does: the
    # times below hold no host-to-device copy of the images
    batches = [DataSet(*(torch.as_tensor(a, device=net.device) for a in (b.features, b.labels)))
               for b in host_batches]
    t0 = time.perf_counter()
    train_s, accs, tta = 0.0, [], None
    for epoch in range(LENET_MAX_EPOCHS):
        te = time.perf_counter()
        for ds in batches:
            net.fit(ds)
        torch.cuda.synchronize()
        train_s += time.perf_counter() - te
        accs.append(net.evaluate(test).accuracy())
        if accs[-1] >= LENET_TARGET:
            tta = time.perf_counter() - t0
            break
    check(math.isfinite(net.score_), "LeNet: non-finite score")
    print(f"{tag} LeNet bf16 Adam 1e-3, {LENET_EXAMPLES} examples per epoch: held-out accuracy "
          f"by epoch {', '.join(f'{a:.4f}' for a in accs)}; time to {LENET_TARGET:.0%}: "
          + (f"{tta:.3f} s ({len(accs)} epochs, {train_s:.3f} s of it in fit)" if tta
             else "not reached") + f"; score {net.score_:.5f}", flush=True)
    check(tta is not None, f"LeNet: held-out accuracy {accs} never reached {LENET_TARGET}")

    cycle = itertools.cycle(batches)
    times = wall_ms(lambda: net.fit(next(cycle)), n=40, warmup=5)
    step_ms = statistics.median(times)
    print(f"{tag} LeNet fit step [{LENET_BATCH},1,28,28] bf16: {spread(times)}, "
          f"{LENET_BATCH / step_ms * 1e3:.0f} images/s at the median", flush=True)
    x = batches[0].features
    out_times = wall_ms(lambda: net.output(x), n=40, warmup=3)
    print(f"{tag} LeNet output() [{LENET_BATCH},1,28,28] float32: {spread(out_times)}",
          flush=True)
    device_profile(tag, f"LeNet fit step [{LENET_BATCH},1,28,28] bf16",
                   lambda: net.fit(batches[1]), reps=5, top=8)
    print_mln_peak_share(tag, "LeNet fit step", net.conf, LENET_BATCH, step_ms)


def _char_batch(B, V, T, seed):
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, V, (B, T))
    x = np.eye(V, dtype=np.float32)[idx].transpose(0, 2, 1)  # [B, V, T]
    y = np.eye(V, dtype=np.float32)[np.roll(idx, -1, 1)].transpose(0, 2, 1)
    return x, y


def phase_char_rnn(tag):
    """6b: the GravesLSTM char-RNN (vocab 77, hidden 256, 2 layers, tbptt
    50, Adam, element-wise clipping at 1.0) at bench.py's CUDA shape B=64,
    T=200: 4 segments per fit."""
    import torch

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import TextGenerationLSTM
    from deeplearning4j_tpu_torch.nn import InputType

    model = TextGenerationLSTM()
    x, y = _char_batch(LSTM_B, model.vocab_size, LSTM_T, 0)
    check_fit_on_cpu(tag, f"char-RNN [{LSTM_B},{model.vocab_size},{LSTM_T}] tbptt 50",
                     lambda dev: model.init(device=dev), DataSet(x, y))

    net = model.init(device="cuda")
    # the batch staged on the card once, as bench.py does
    ds = DataSet(torch.as_tensor(x, device=net.device), torch.as_tensor(y, device=net.device))
    scores, times = [], []
    for _ in range(LSTM_FITS):
        t0 = time.perf_counter()
        net.fit(ds)
        scores.append(net.score_)  # waits for the fit
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"{tag} char-RNN bf16 fits (4 segments each): score "
          + " ".join(f"{s:.4f}" for s in scores), flush=True)
    check(all(math.isfinite(s) for s in scores), f"char-RNN: non-finite score in {scores}")
    check(scores[-1] < scores[0], f"char-RNN: score did not fall ({scores[0]} -> {scores[-1]})")
    fit_ms = statistics.median(times[1:])
    print(f"{tag} char-RNN fit [{LSTM_B},{LSTM_T}] bf16: {spread(times[1:])} (after the first), "
          f"{LSTM_B * LSTM_T / fit_ms * 1e3:.0f} chars/s at the median", flush=True)
    device_profile(tag, f"char-RNN fit [{LSTM_B},{LSTM_T}] bf16", lambda: net.fit(ds), reps=1,
                   top=8)
    print_mln_peak_share(tag, "char-RNN fit (4 segments)", net.conf, LSTM_B, fit_ms,
                         InputType.recurrent(model.vocab_size, LSTM_T))

    xs = ds.features[:, :, :20]
    full = net.output(xs)
    net.rnn_clear_previous_state()
    steps = torch.cat([net.rnn_time_step(xs[:, :, t]) for t in range(20)], dim=2)
    err = (steps - full).abs().max().item()
    print(f"{tag} char-RNN rnn_time_step x20 vs output() over 20 steps, float32: max abs "
          f"error {err:.2e}", flush=True)
    check(err <= RNN_STEP_ATOL, f"char-RNN: rnn_time_step differs from output() by {err:.2e}")


def _attention_conf(updater):
    from deeplearning4j_tpu_torch.nn import conf as C
    from deeplearning4j_tpu_torch.nn.attention_layers import SelfAttentionLayer

    return (C.NeuralNetConfiguration.Builder().seed(21).updater(updater).list()
            .layer(SelfAttentionLayer(n_out=ATTN_C, n_heads=ATTN_HEADS, head_size=64))
            .layer(C.GlobalPoolingLayer(pooling_type="avg"))
            .layer(C.OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(C.InputType.recurrent(ATTN_C, ATTN_T)).build())


def _check_attention_counts(what, counts, steps):
    want = {name: steps for name in _counters()}
    check(counts == want, f"{what}: kernel launches {counts}, expected {want}")


def bf16_kernel_ratios(what, q, k, v, qseg, kseg, rs):
    """The bf16 flash forward and both backward kernels (and the dq
    kernel's delta) on the given q/k/v and key segments, with an upstream
    gradient dO from ``rs``, against their plain versions: the worst
    element of each as a share of phase 2's bf16 bound, {name: ratio}."""
    import torch

    from deeplearning4j_tpu_torch.kernels import attention as A

    B, H, Tq, D = q.shape
    args = (qseg, kseg, False, 1.0 / math.sqrt(D), k.shape[2] - Tq)
    out, lse = A.flash_forward(q, k, v, *args)
    do = torch.from_numpy(rs.randn(B, Tq, H, D).astype(np.float32)).to(q.device, torch.bfloat16)
    do = do.transpose(1, 2)
    got = A.flash_backward(q, k, v, out, lse, do, *args)
    _, delta = A.flash_backward_dq(q, k, v, out, do, lse, *args)
    torch.cuda.synchronize()
    ref, ref_lse = A.flash_forward_reference(q, k, v, *args)
    ref_grads = A.flash_backward_reference(q, k, v, out, lse, do, *args)
    diff = (out.float() - ref.float()).abs()
    fwd_ratio = (diff / (BF16_ULP_REL * ref.float().abs() + BF16_ATOL)).max().item()
    lse_ratio = ((lse - ref_lse).abs() / (LSE_TOL * ref_lse.abs().clamp(min=1.0))).max().item()
    ratios = {"out": fwd_ratio, "lse": lse_ratio}
    for gname, g, r in zip(("dq", "dk", "dv"), got, ref_grads):
        check(torch.isfinite(g).all().item(), f"{what}: non-finite {gname}")
        ratios[gname] = _bwd_ratio(g, r, torch.bfloat16)
    ratios["delta"] = _delta_ratio(delta, out, do)
    return ratios


def check_ratios(tag, what, ratios):
    print(f"{tag} {what}, worst |kernel - plain| / bound: "
          + " ".join(f"{n} {r:.3f}" for n, r in ratios.items()), flush=True)
    for name, ratio in ratios.items():
        check(ratio <= 1.0, f"{what}: {name} disagrees with the plain version ({ratio:.3f} of "
                            f"the bound)")


def check_attention_layer_kernels(tag, net, ds):
    """The bf16 flash forward and backward kernels on the attention layer's
    own inputs: q/k/v as its bf16 step projects them from this batch (the
    strided per-head views), its key mask from the ragged features mask,
    and an upstream gradient dO of the output's shape, against their plain
    versions by phase 2's bf16 limits."""
    import torch

    from deeplearning4j_tpu_torch.kernels import attention as A
    from deeplearning4j_tpu_torch.nn.attention_layers import _key_mask, _split_heads

    w = {k: p.detach().to(torch.bfloat16) for k, p in net.params_["0"].items()}
    x = torch.as_tensor(ds.features, device=net.device).to(torch.bfloat16)
    h = x.transpose(1, 2)
    q, k, v = (_split_heads(h @ w[n], ATTN_HEADS) for n in ("Wq", "Wk", "Wv"))
    B, H, T, D = q.shape
    qseg, kseg = A.attention_segments(_key_mask(ds.features_mask, x), None, B, T, T, q.device)
    ratios = bf16_kernel_ratios("attention MLN kernels", q, k, v, qseg, kseg,
                                np.random.RandomState(9))
    check_ratios(tag, f"attention MLN bf16 kernels on the layer's q/k/v [{B},{H},{T},{D}] and "
                      f"key mask", ratios)


def phase_attention_mln(tag, launches):
    """6c: SelfAttentionLayer (nIn 256, 4 heads of 64) → GlobalPooling(avg)
    → Output on [16, 256, 128] with a ragged features mask: a float32 Sgd
    step through the flash kernels against the same network's step on the
    CPU (the dense path; phase 5's limits), then bf16 Adam steps, each
    launching the flash forward, dkv and dq once, and the bf16 kernels held
    to their plain versions on the layer's own inputs."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam, Sgd

    rs = np.random.RandomState(8)
    lengths = np.concatenate([[ATTN_T], rs.randint(16, ATTN_T + 1, ATTN_B - 1)])
    fm = (np.arange(ATTN_T)[None] < lengths[:, None]).astype(np.float32)
    ds = DataSet(rs.randn(ATTN_B, ATTN_C, ATTN_T).astype(np.float32),
                 np.eye(10, dtype=np.float32)[rs.randint(0, 10, ATTN_B)], features_mask=fm)

    counts = check_fit_on_cpu(
        tag, f"attention MLN [{ATTN_B},{ATTN_C},{ATTN_T}] Sgd (update = lr x gradient)",
        lambda dev: MultiLayerNetwork(_attention_conf(Sgd(0.1)), device=dev).init(), ds,
        loss_rel=TRAIN_LOSS_REL, update_rel=TRAIN_GRAD_REL)
    print(f"{tag} attention MLN float32 step on the card: launches {counts}", flush=True)
    _check_attention_counts("attention MLN float32 step", counts, 1)
    for name, n in counts.items():
        launches[f"{name}_f32"].append(n)

    net = MultiLayerNetwork(_attention_conf(Adam(1e-3)), device="cuda").init()
    scores, times = [], []
    _zero_counts()
    for _ in range(ATTN_STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        scores.append(net.score_)
        times.append((time.perf_counter() - t0) * 1e3)
    counts = _read_counts()
    _check_attention_counts("attention MLN bf16 steps", counts, ATTN_STEPS)
    for name, n in counts.items():
        launches[name].append(n)
    check(all(math.isfinite(s) for s in scores), f"attention MLN: non-finite score {scores}")
    check(scores[-1] < scores[0], f"attention MLN: score did not fall {scores[0]} -> "
                                  f"{scores[-1]}")
    print(f"{tag} attention MLN [{ATTN_B},{ATTN_C},{ATTN_T}] bf16 Adam, {ATTN_STEPS} steps: "
          f"score {scores[0]:.4f} -> {scores[-1]:.4f}; step {spread(times[2:])}; launches "
          f"{counts} ({ATTN_STEPS} steps)", flush=True)
    check_attention_layer_kernels(tag, net, ds)


# ------------------------------------------------------------------ phase 7

# The ComputationGraph models at their published widths: ResNet-50 at
# bench.py's shape (batch 256, 3x224x224, 1000 classes), InceptionResNetV1
# at its defaults (3x160x160, blocks (5, 10, 5), embedding 128, 1001
# classes) at batch 128, and phase 7c's attention graph
RESNET_BATCH, RESNET_STEPS, RESNET_CHECK_BATCH = 256, 40, 4
RESNET_PARAMS = 25_557_032
FACENET_BATCH, FACENET_STEPS, FACENET_CHECK_BATCH = 128, 10, 4
AG_B, AG_C, AG_TQ, AG_TK, AG_HEADS, AG_STEPS = 16, 256, 96, 200, 4, 10
# The graphs' float32 fit on the card against the CPU's. A random ResNet-50
# or InceptionResNetV1 at batch 4 amplifies float32 rounding in its updates
# (BN over few values per channel). `python3 tests/torch_float64_step.py
# --device cuda` on the H100 puts the card's float32 step, and the CPU's,
# this far from a float64 step of the same network and batch (ResNet-50;
# InceptionResNetV1): score 1.7e-6 and 3.7e-6 relative; 3.3e-7 and 8.2e-8;
# the worst tensor's update 3.2% and 2.9% of its norm; 35.3% and 35.4%; all
# parameters' update as one vector 2.6% and 2.6%; 8.2% and 6.0%; the worst
# BN running statistic 8.7e-6 and 9.4e-6; 2.3e-6 and 1.6e-6. By the triangle
# inequality the card is held within the sum of the two, rounded up.
RESNET_LOSS_REL, RESNET_UPDATE_REL, RESNET_ALL_REL, RESNET_BN_REL = 1e-5, 0.07, 0.06, 2e-5
FACENET_LOSS_REL, FACENET_UPDATE_REL, FACENET_ALL_REL, FACENET_BN_REL = 1e-6, 0.75, 0.15, 5e-6
# L2-normalised embeddings: |row norm - 1| in float32
EMBED_NORM_ATOL = 1e-5


def _image_batch(batch, shape, classes, seed=0):
    """``bench.py``'s ResNet-50 batch: uniform images and one-hot labels."""
    rs = np.random.RandomState(seed)
    x = rs.rand(batch, *shape).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rs.randint(0, classes, batch)]


def _staged(x, y):
    """A DataSet whose arrays are staged on the card once."""
    import torch

    from deeplearning4j_tpu_torch.data import DataSet

    return DataSet(torch.as_tensor(x, device="cuda"), torch.as_tensor(y, device="cuda"))


def _free_card():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def graph_flops(net, batch) -> float:
    """A train step's flops: three times the forward flops that the graph's
    layers count (``flops_per_example``; vertices are not counted), per
    step."""
    fwd = sum(net.conf.nodes[n].layer.flops_per_example(net._in_types[n])
              for n in net._topo if net.conf.nodes[n].layer is not None)
    return 3.0 * fwd * batch


def print_graph_peak_share(tag, what, net, batch, step_ms):
    flops = graph_flops(net, batch)
    share = flops / (step_ms / 1e3) / PEAK_OPS_PER_S["bfloat16"]
    print(f"{tag} {what} achieved share of the dense bf16 peak: {share:.4f} ({flops:.4e} flops "
          f"per step, 3 x flops_per_example x {batch}, in the {step_ms:.3f} ms median step, "
          f"against 989 TFLOP/s)", flush=True)


def _train_steps(net, ds, n, warmup=3):
    """Host times (ms) of ``n`` fits after ``warmup``, each ending in a
    synchronize; the scores of all fits."""
    scores = []

    def fit():
        net.fit(ds)
        scores.append(net.score_)

    times = wall_ms(fit, n=n, warmup=warmup)
    return times, scores


def phase_resnet(tag):
    """7a: ResNet-50 at bench.py's shape: a float32 fit on the card against
    the CPU's at batch 4 (full width), then bf16 training at batch 256 with
    the zoo's Nesterovs(0.1, 0.9): step time, images/s, peak memory, a
    profile, the share of the bf16 peak, ``output()`` latency, and the step
    with ``cudnn.benchmark`` off and on in turns."""
    import torch

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import ResNet50

    model = ResNet50()
    shape, classes = model.input_shape, model.num_classes
    x4, y4 = _image_batch(RESNET_CHECK_BATCH, shape, classes)
    dims = ",".join(map(str, shape))
    check_fit_on_cpu(tag, f"ResNet-50 [{RESNET_CHECK_BATCH},{dims}] Nesterovs",
                     lambda dev: model.init(device=dev), DataSet(x4, y4),
                     loss_rel=RESNET_LOSS_REL, update_rel=RESNET_UPDATE_REL,
                     all_rel=RESNET_ALL_REL, bn_rel=RESNET_BN_REL)
    _free_card()

    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    net = model.init(device="cuda")
    check(net.num_params() == RESNET_PARAMS,
          f"ResNet-50 has {net.num_params()} parameters, expected {RESNET_PARAMS}")
    ds = _staged(*_image_batch(RESNET_BATCH, shape, classes))
    times, scores = _train_steps(net, ds, RESNET_STEPS)
    check(all(math.isfinite(s) for s in scores), f"ResNet-50: non-finite score in {scores}")
    step_ms = statistics.median(times)
    peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    print(f"{tag} ResNet-50 fit step [{RESNET_BATCH},{dims}] bf16 Nesterovs: {spread(times)}, "
          f"{RESNET_BATCH / step_ms * 1e3:.1f} images/s at the median; peak memory {peak:.2f} "
          f"GiB (max_memory_allocated); score {scores[0]:.4f} -> {scores[-1]:.4f} over "
          f"{len(scores)} steps", flush=True)
    device_profile(tag, f"ResNet-50 fit step [{RESNET_BATCH},{dims}] bf16",
                   lambda: net.fit(ds), reps=2, top=12, by_kind=True)
    print_graph_peak_share(tag, "ResNet-50 fit step", net, RESNET_BATCH, step_ms)
    # cudnn.benchmark off (the library's default) and on, in turns
    by_mode = {False: [], True: []}
    try:
        for mode in (True, False, True, True, False, False, True):
            torch.backends.cudnn.benchmark = mode
            t, _ = _train_steps(net, ds, 4, warmup=1)
            by_mode[mode] += t
    finally:
        torch.backends.cudnn.benchmark = False
    print(f"{tag} ResNet-50 fit step with cudnn.benchmark off: {spread(by_mode[False])}; on: "
          f"{spread(by_mode[True])} (in turns, 4 timed steps per turn after one)", flush=True)
    x = ds.features
    out_times = wall_ms(lambda: net.output(x), n=10, warmup=2)
    out = net.output(x)[0]
    check(tuple(out.shape) == (RESNET_BATCH, classes) and bool(torch.isfinite(out).all()),
          "ResNet-50: output() is not finite or has the wrong shape")
    print(f"{tag} ResNet-50 output() [{RESNET_BATCH},{dims}] float32: {spread(out_times)}, "
          f"{RESNET_BATCH / statistics.median(out_times) * 1e3:.1f} images/s", flush=True)
    del net, ds
    _free_card()


def _facenet(dev, dropout=True):
    from deeplearning4j_tpu_torch.models import InceptionResNetV1
    from deeplearning4j_tpu_torch.nn import ComputationGraph

    conf = InceptionResNetV1().conf()
    if not dropout:
        conf.nodes["drop"].layer.dropout = 0.0
    return ComputationGraph(conf, device=dev).init()


def phase_facenet(tag):
    """7b: InceptionResNetV1 at its published defaults: a float32 fit on the
    card against the CPU's at batch 4 with the DropoutLayer off in both,
    unit-norm embeddings, then bf16 Adam at batch 128 (dropout on): step
    time, images/s, peak memory and a profile."""
    import torch

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import InceptionResNetV1

    model = InceptionResNetV1()
    shape, classes = model.input_shape, model.num_classes
    x4, y4 = _image_batch(FACENET_CHECK_BATCH, shape, classes)
    dims = ",".join(map(str, shape))
    check_fit_on_cpu(tag, f"InceptionResNetV1 [{FACENET_CHECK_BATCH},{dims}] Adam, dropout off",
                     lambda dev: _facenet(dev, dropout=False), DataSet(x4, y4),
                     loss_rel=FACENET_LOSS_REL, update_rel=FACENET_UPDATE_REL,
                     all_rel=FACENET_ALL_REL, bn_rel=FACENET_BN_REL)
    with float32_policy():
        probs, emb = _facenet("cuda").output(x4)
    err = (emb.norm(dim=1) - 1.0).abs().max().item()
    print(f"{tag} InceptionResNetV1 output() float32: output {tuple(probs.shape)}, embeddings "
          f"{tuple(emb.shape)}, max |row norm - 1| {err:.2e}", flush=True)
    check(tuple(emb.shape) == (FACENET_CHECK_BATCH, model.embedding_size) and
          err <= EMBED_NORM_ATOL, f"InceptionResNetV1: embeddings not unit norm ({err:.2e})")
    _free_card()

    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    net = _facenet("cuda")
    ds = _staged(*_image_batch(FACENET_BATCH, shape, classes))
    times, scores = _train_steps(net, ds, FACENET_STEPS)
    check(all(math.isfinite(s) for s in scores),
          f"InceptionResNetV1: non-finite score in {scores}")
    step_ms = statistics.median(times)
    peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    print(f"{tag} InceptionResNetV1 fit step [{FACENET_BATCH},{dims}] bf16 Adam: "
          f"{spread(times)}, {FACENET_BATCH / step_ms * 1e3:.1f} images/s at the median; peak "
          f"memory {peak:.2f} GiB; score {scores[0]:.4f} -> {scores[-1]:.4f}", flush=True)
    device_profile(tag, f"InceptionResNetV1 fit step [{FACENET_BATCH},{dims}] bf16",
                   lambda: net.fit(ds), reps=2, top=8, by_kind=True)
    print_graph_peak_share(tag, "InceptionResNetV1 fit step", net, FACENET_BATCH, step_ms)
    del net, ds
    _free_card()


def _attention_graph_conf(updater):
    from deeplearning4j_tpu_torch.nn import conf as C
    from deeplearning4j_tpu_torch.nn import graph_conf as G
    from deeplearning4j_tpu_torch.nn.attention_layers import (AttentionVertex,
                                                              RecurrentAttentionLayer)

    g = (C.NeuralNetConfiguration.Builder().seed(31).updater(updater).graph_builder()
         .add_inputs("q", "kv")
         .set_input_types(C.InputType.recurrent(AG_C, AG_TQ), C.InputType.recurrent(AG_C, AG_TK)))
    attention = dict(n_in=AG_C, n_out=AG_C, n_heads=AG_HEADS, head_size=64)
    g.add_vertex("cross", AttentionVertex(**attention), "q", "kv", "kv")
    g.add_vertex("self", AttentionVertex(**attention), "q")
    g.add_layer("rec", RecurrentAttentionLayer(n_out=64, n_heads=4, head_size=16), "q")
    g.add_vertex("cat", G.MergeVertex(), "cross", "self", "rec")
    g.add_layer("pool", C.GlobalPoolingLayer(pooling_type="avg"), "cat")
    g.add_layer("out", C.OutputLayer(n_out=10, activation="softmax", loss="mcxent"), "pool")
    return g.set_outputs("out").build()


def check_attention_vertex_kernels(tag, net, ds):
    """The bf16 flash forward and backward kernels on each AttentionVertex's
    own inputs: q/k/v as its bf16 step projects them from this batch
    (cross-attention: q from "q", k and v from "kv"; self-attention: all
    from "q"), and an upstream gradient dO, against their plain versions by
    phase 2's bf16 limits."""
    import torch

    from deeplearning4j_tpu_torch.kernels import attention as A
    from deeplearning4j_tpu_torch.nn.attention_layers import _split_heads

    xq, xkv = (torch.as_tensor(f, device=net.device).to(torch.bfloat16).transpose(1, 2)
               for f in ds.features)
    rs = np.random.RandomState(10)
    for name, (hq, hk) in (("cross", (xq, xkv)), ("self", (xq, xq))):
        w = {k: p.detach().to(torch.bfloat16) for k, p in net.params_[name].items()}
        q = _split_heads(hq @ w["Wq"], AG_HEADS)
        k, v = (_split_heads(hk @ w[n], AG_HEADS) for n in ("Wk", "Wv"))
        B, H, Tq, D = q.shape
        Tk = k.shape[2]
        qseg, kseg = A.attention_segments(None, None, B, Tq, Tk, q.device)
        ratios = bf16_kernel_ratios(f"attention graph {name}", q, k, v, qseg, kseg, rs)
        check_ratios(tag, f"attention graph {name} vertex bf16 kernels on its q [{B},{H},{Tq},"
                          f"{D}] and k/v [{B},{H},{Tk},{D}]", ratios)


def phase_attention_graph(tag, launches):
    """7c: a ComputationGraph whose two AttentionVertex nodes (cross on
    (q, kv, kv), self on q) run the flash kernels, beside a
    RecurrentAttentionLayer on q: a float32 Sgd step on the card against the
    CPU's dense path (phase 5's limits), bf16 Adam steps each launching the
    flash forward, dkv and dq twice, and the bf16 kernels on each vertex's
    own q/k/v held to their plain versions."""
    from deeplearning4j_tpu_torch.data import MultiDataSet
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.nn.updaters import Adam, Sgd

    rs = np.random.RandomState(13)
    ds = MultiDataSet([rs.randn(AG_B, AG_C, AG_TQ).astype(np.float32),
                       rs.randn(AG_B, AG_C, AG_TK).astype(np.float32)],
                      [np.eye(10, dtype=np.float32)[rs.randint(0, 10, AG_B)]])
    shape = f"q [{AG_B},{AG_C},{AG_TQ}], kv [{AG_B},{AG_C},{AG_TK}]"
    counts = check_fit_on_cpu(
        tag, f"attention graph {shape} Sgd (update = lr x gradient)",
        lambda dev: ComputationGraph(_attention_graph_conf(Sgd(0.1)), device=dev).init(), ds,
        loss_rel=TRAIN_LOSS_REL, update_rel=TRAIN_GRAD_REL)
    print(f"{tag} attention graph float32 step on the card: launches {counts}", flush=True)
    _check_attention_counts("attention graph float32 step", counts, 2)
    for name, n in counts.items():
        launches[f"{name}_f32"].append(n)

    net = ComputationGraph(_attention_graph_conf(Adam(1e-3)), device="cuda").init()
    scores, times = [], []
    _zero_counts()
    for _ in range(AG_STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        scores.append(net.score_)
        times.append((time.perf_counter() - t0) * 1e3)
    counts = _read_counts()
    _check_attention_counts("attention graph bf16 steps", counts, 2 * AG_STEPS)
    for name, n in counts.items():
        launches[name].append(n)
    check(all(math.isfinite(s) for s in scores), f"attention graph: non-finite score {scores}")
    check(scores[-1] < scores[0], f"attention graph: score did not fall {scores[0]} -> "
                                  f"{scores[-1]}")
    print(f"{tag} attention graph {shape} bf16 Adam, {AG_STEPS} steps: score {scores[0]:.4f} -> "
          f"{scores[-1]:.4f}; step {spread(times[2:])}; launches {counts} ({AG_STEPS} steps, "
          f"two vertices)", flush=True)
    check_attention_vertex_kernels(tag, net, ds)


# --------------------------------------------------------------------- main


# ------------------------------------------------------------------ phase 8

# Serving through the port's front door: JsonModelServer over the batching
# and generative executors, the trace replay, and a ServingPool of replica
# processes. 8a is bench.py's "serving" configuration (bench.py:160): a
# Dense(64->128, relu) -> Output(8, softmax) MLN, batch_limit 16, queue 256,
# 16 clients x 20 one-row requests. 8c's replay has bench.py's serving_pool
# trace shape (bench.py:172-179): max_new mix (4, 8, 16, 48), diurnal
# amplitude 0.4, a 10x burst over 15% of the run, 48 clients, slots 8.
SERVE_MLN_FEATURES, SERVE_MLN_CLASSES, SERVE_MLN_HIDDEN = 64, 8, 128
SERVE_MLN_CLIENTS, SERVE_MLN_REQUESTS = 16, 20          # per client
SERVE_ATTN_CLIENTS, SERVE_ATTN_REQUESTS = 8, 8          # one sequence each
SERVE_RESNET_CLIENTS, SERVE_RESNET_REQUESTS, SERVE_RESNET_LIMIT = 8, 8, 32
SERVE_REPLAY_S, SERVE_REPLAY_SLOTS, SERVE_REPLAY_CLIENTS = 6.0, 8, 48
SERVE_REPLAY_MIX = (4, 8, 16, 48)
SERVE_REPLAY_PROMPTS = (3, 5, 9, 14)
# requests per second at the trough-to-peak mean; the 10x burst lands at
# the diurnal peak (1.4x), 168 req/s, past what slots=8 decode sustains
SERVE_REPLAY_BASE_RATE = 12.0
SERVE_DIRECT_TURNS = 3
# a float32 network's batched answer against the same rows alone: float32
# sums in another order (a GEMV for one row, a GEMM for a batch)
SERVE_F32_ATOL = 1e-5


def _pct(values, q):
    """The q-quantile of ``values`` as the load generator reports it."""
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def _drive_clients(what, port, payloads, clients, headers_fn=None):
    """Send ``payloads`` from ``clients`` threads, each with its own
    ``JsonModelClient`` and no retries: every request must answer 200 the
    first time. Returns (outputs in payload order, per-request ms, wall s)."""
    from deeplearning4j_tpu_torch.serving import JsonModelClient

    outs, lat, errors = [None] * len(payloads), [0.0] * len(payloads), []

    def worker(first):
        client = JsonModelClient(port=port, retries=0, timeout=300.0,
                                 breaker_threshold=10 ** 9)
        for i in range(first, len(payloads), clients):
            t0 = time.perf_counter()
            try:
                outs[i] = client.predict(payloads[i], request_id=f"smoke-{i}")
            except RuntimeError as e:
                errors.append(f"request {i}: {e}")
            lat[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=worker, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(not errors, f"{what}: {len(errors)} of {len(payloads)} requests did not answer 200; "
                      f"first: {errors[:1]}")
    return outs, lat, wall


def _batches(reg):
    """(executed batches, rows) from the server's tdl_inference_batch_size."""
    series = reg.get("tdl_inference_batch_size").snapshot()["series"]
    return (series[0]["count"], series[0]["sum"]) if series else (0, 0.0)


def _latency_line(lat):
    return (f"p50 {_pct(lat, 0.5):.3f} ms, p99 {_pct(lat, 0.99):.3f} ms, "
            f"max {max(lat):.3f} ms")


def _serve(model, what, warmup, registry, **builder):
    """A started JsonModelServer over ``model`` (builder calls by name),
    warm and ready."""
    from deeplearning4j_tpu_torch.serving import JsonModelServer

    b = JsonModelServer.Builder(model).port(0).registry(registry).warmup_input(warmup)
    for name, arg in builder.items():
        b = getattr(b, name)(arg)
    server = b.build().start()
    if not server.wait_ready(300.0):
        server.stop()
        raise SmokeFailure(f"{what}: the server never became ready")
    return server


def phase_serve_mln(tag):
    """8a: micro-batching a float32 MLN (bench.py's serving config)."""
    from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
    from deeplearning4j_tpu_torch.nn import (DenseLayer, MultiLayerNetwork,
                                             NeuralNetConfiguration, OutputLayer)
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    F, C = SERVE_MLN_FEATURES, SERVE_MLN_CLASSES
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-3)).list()
            .layer(DenseLayer(n_in=F, n_out=SERVE_MLN_HIDDEN, activation="relu"))
            .layer(OutputLayer(n_out=C, activation="softmax", loss="mcxent")).build())
    net = MultiLayerNetwork(conf, device="cuda").init()
    reg = MetricsRegistry()
    n = SERVE_MLN_CLIENTS * SERVE_MLN_REQUESTS
    rows = list(np.random.RandomState(0).randn(n, 1, F).astype(np.float32))
    server = _serve(net, "8a MLN", np.zeros((1, F), np.float32), reg,
                    batch_limit=16, queue_size=256)
    try:
        outs, lat, wall = _drive_clients("8a MLN", server.port, rows, SERVE_MLN_CLIENTS)
    finally:
        server.stop()
    batches, coalesced = _batches(reg)
    got = np.asarray(outs, np.float32)
    ref = np.stack([net.output(r).float().cpu().numpy() for r in rows])
    check(got.shape == (n, 1, C), f"8a MLN: responses of shape {got.shape}")
    err = float(np.abs(got - ref).max())
    print(f"{tag} 8a MLN Dense({F}->{SERVE_MLN_HIDDEN}, relu) -> Output({C}, softmax) float32, "
          f"batch_limit 16: {n} one-row requests from {SERVE_MLN_CLIENTS} clients, all 200 in "
          f"{wall:.3f} s = {n / wall:.1f} req/s; latency {_latency_line(lat)}; {batches} "
          f"batches, mean coalesced rows {coalesced / max(batches, 1):.2f}; max |response - "
          f"output(row alone)| {err:.2e} (limit {SERVE_F32_ATOL})", flush=True)
    check(err <= SERVE_F32_ATOL, f"8a MLN: a response differs from its row's output() by {err}")


def phase_serve_attention(tag, launches):
    """8b: micro-batching phase 6c's attention MLN in bf16 (one flash
    forward per executed batch), then ResNet-50's float32 output() through
    the ComputationGraph path."""
    from deeplearning4j_tpu_torch.kernels.attention import flash_forward
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    conf = _attention_conf(Adam(1e-3))
    conf.dtype = "bfloat16"
    net = MultiLayerNetwork(conf, device="cuda").init()
    reg = MetricsRegistry()
    n = SERVE_ATTN_CLIENTS * SERVE_ATTN_REQUESTS
    seqs = list(np.random.RandomState(4).randn(n, 1, ATTN_C, ATTN_T).astype(np.float32))
    server = _serve(net, "8b attention MLN", np.zeros((1, ATTN_C, ATTN_T), np.float32), reg,
                    batch_limit=8)
    try:
        base, _ = _batches(reg)
        flash_forward.launches = 0
        outs, lat, wall = _drive_clients("8b attention MLN", server.port, seqs,
                                         SERVE_ATTN_CLIENTS)
        launched = flash_forward.launches
    finally:
        server.stop()
    batches, coalesced = _batches(reg)
    batches -= base
    launches.append(launched)
    check(launched == batches, f"8b attention MLN: {launched} flash forward launches for "
                               f"{batches} executed batches")
    pi = server.parallel_inference
    got = np.asarray(outs, np.float32)
    ref = np.stack([pi.output(x) for x in seqs])
    ratio = float((np.abs(got - ref) / (BF16_ULP_REL * np.abs(ref) + BF16_ATOL)).max())
    alone = np.stack([net.output(x).float().cpu().numpy() for x in seqs])
    print(f"{tag} 8b attention MLN [1,{ATTN_C},{ATTN_T}] bf16, batch_limit 8: {n} requests from "
          f"{SERVE_ATTN_CLIENTS} clients, all 200 in {wall:.3f} s = {n / wall:.1f} req/s; "
          f"latency {_latency_line(lat)}; {batches} batches (mean {coalesced / max(batches, 1):.2f} "
          f"sequences), {launched} flash forward launches; worst |response - output(sequence "
          f"alone, at the served batch shape)| {ratio:.3f} of one bf16 ulp; against output() "
          f"of the sequence unpadded: max {float(np.abs(got - alone).max()):.2e}", flush=True)
    check(got.shape == (n, 1, 10), f"8b attention MLN: responses of shape {got.shape}")
    check(ratio <= 1.0, f"8b attention MLN: a response differs from its sequence alone by "
                        f"{ratio:.3f} of one bf16 ulp")
    del net, server, pi
    _free_card()

    model = ResNet50()
    shape, classes = model.input_shape, model.num_classes
    net = model.init(device="cuda")
    reg = MetricsRegistry()
    n = SERVE_RESNET_CLIENTS * SERVE_RESNET_REQUESTS
    images = list(_image_batch(n, shape, classes, seed=3)[0][:, None])
    server = _serve(net, "8b ResNet-50", np.zeros((1, *shape), np.float32), reg,
                    batch_limit=SERVE_RESNET_LIMIT)
    try:
        outs, lat, wall = _drive_clients("8b ResNet-50", server.port, images,
                                         SERVE_RESNET_CLIENTS)
    finally:
        server.stop()
    batches, coalesced = _batches(reg)
    pi = server.parallel_inference
    got = np.asarray(outs, np.float32)
    check(got.shape == (n, 1, classes), f"8b ResNet-50: responses of shape {got.shape} "
                                        f"(one [1, {classes}] answer per image expected)")
    ref = np.stack([pi.output(x) for x in images])
    err = float(np.abs(got - ref).max())
    alone = np.stack([net.output(x)[0].float().cpu().numpy() for x in images])
    print(f"{tag} 8b ResNet-50 [1,{','.join(map(str, shape))}] float32 output(), batch_limit "
          f"{SERVE_RESNET_LIMIT}: {n} one-image requests from {SERVE_RESNET_CLIENTS} clients, "
          f"all 200 in {wall:.3f} s = {n / wall:.1f} images/s; latency {_latency_line(lat)}; "
          f"{batches} batches (mean {coalesced / max(batches, 1):.2f} images); max |response - "
          f"output(image alone, at the served batch shape)| {err:.2e} (limit {SERVE_F32_ATOL}); "
          f"against output() of the image unpadded: max {float(np.abs(got - alone).max()):.2e}",
          flush=True)
    check(err <= SERVE_F32_ATOL, f"8b ResNet-50: a response differs from its image alone by "
                                 f"{err}")
    del net, server, pi
    _free_card()


def _replay_executor(ex, spec, prompt_fn, max_new_fn, clients):
    """Open-loop replay of ``spec``'s arrivals straight into a generative
    executor (bench.py's ``_replay_generative_executor``): per-request
    client latency in ms; every request must complete."""
    arrivals = spec.arrivals()
    lat, errors, nxt, lock = [None] * len(arrivals), [], [0], threading.Lock()
    t0 = time.perf_counter()

    def worker():
        while True:
            with lock:
                i = nxt[0]
                if i >= len(arrivals):
                    return
                nxt[0] = i + 1
            delay = arrivals[i][0] - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            sent = time.perf_counter()
            fut = ex.submit(prompt_fn(i), max_new_tokens=max_new_fn(i))
            if not fut.wait(300.0) or fut.error is not None:
                errors.append(f"request {i}: {fut.error}")
            lat[i] = (time.perf_counter() - sent) * 1e3

    threads = [threading.Thread(target=worker) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"replay: {len(errors)} of {len(arrivals)} requests failed: {errors[:1]}")
    return lat, time.perf_counter() - t0


def phase_serve_generate(tag, launches, gen_tokens):
    """8c: continuous batching at BERT-base width: phase 4's generator and
    prompts behind JsonModelServer over a PagedDecodeSlotPool(slots=4),
    six concurrent clients, in turns with direct ``generate`` on a warm
    pool of the same shape; then the serving_pool trace replayed into the
    generative executor (slots 8), continuous and static. Returns the model
    and prompts for 8d."""
    import torch

    from deeplearning4j_tpu_torch.kernels.attention import flash_forward
    from deeplearning4j_tpu_torch.models import paged_decode as pd
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
    from deeplearning4j_tpu_torch.serving import (GenerativeInferenceExecutor, JsonModelServer,
                                                  TraceSpec)

    params, cfg, prompts = generator_model()
    L, max_new = cfg.n_layers, GEN_MAX_NEW
    # the paged pool captures its decode step as a CUDA graph on its first
    # step, on the executor's thread (the warm-up): this thread makes no
    # CUDA call until the server is ready
    session = pd.PagedDecodeSlotPool(params, cfg, slots=4)
    server = JsonModelServer(None, generative_session=session, default_max_new_tokens=max_new,
                             warmup_input=[1, 2, 3], registry=MetricsRegistry()).start()
    try:
        check(server.wait_ready(300.0), "8c: the generative server never became ready")
        direct_pool = pd.PagedDecodeSlotPool(params, cfg, slots=4)
        tfm.generate(params, prompts, max_new, cfg, pool=direct_pool)  # capture
        direct_ms, served_ms, lat, served = [], [], [], None
        for _ in range(SERVE_DIRECT_TURNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            direct = tfm.generate(params, prompts, max_new, cfg, pool=direct_pool)
            torch.cuda.synchronize()
            direct_ms.append((time.perf_counter() - t0) * 1e3)
            check_near_ties(tag, "8c direct generate", params, cfg, prompts, direct, gen_tokens)
            admitted = server._executor.stats()["admitted"]
            flash_forward.launches = 0
            served, turn_lat, wall = _drive_clients("8c generative server", server.port,
                                                    prompts, len(prompts))
            n = flash_forward.launches
            admitted = server._executor.stats()["admitted"] - admitted
            launches.append(n)
            check(admitted == len(prompts) and n == L * admitted,
                  f"8c: {n} float32 flash launches for {admitted} admissions, expected {L} each")
            served_ms.append(wall * 1e3)
            lat += turn_lat
        same = check_near_ties(tag, "8c served", params, cfg, prompts, served, gen_tokens)
        stats = server._executor.stats()
    finally:
        server.stop()
    tokens = len(prompts) * max_new
    d_med, s_med = statistics.median(direct_ms), statistics.median(served_ms)
    print(f"{tag} 8c generative server, BERT-base width fp32, PagedDecodeSlotPool(slots=4), "
          f"{len(prompts)} concurrent clients x {SERVE_DIRECT_TURNS} turns: all 200, "
          f"{same}/{len(prompts)} sequences token-identical to phase 4's; per request "
          f"{_latency_line(lat)}; all {len(prompts)} prompts served in median {s_med:.3f} ms = "
          f"{tokens / s_med * 1e3:.1f} generated tokens/s; direct generate on a warm pool "
          f"median {d_med:.3f} ms ({tokens / d_med * 1e3:.1f} tokens/s): queue + HTTP + JSON "
          f"cost {s_med - d_med:.3f} ms per batch of {len(prompts)} ({(s_med - d_med) / d_med:.1%});"
          f" mean slot occupancy {stats['mean_slot_occupancy']}", flush=True)

    rs = np.random.RandomState(7)
    replay_prompts = [rs.randint(1, cfg.vocab_size, n).tolist() for n in SERVE_REPLAY_PROMPTS]
    dur = SERVE_REPLAY_S
    spec = TraceSpec(duration_s=dur, base_rate=SERVE_REPLAY_BASE_RATE, seed=0,
                     diurnal_amplitude=0.4, bursts=((0.5 * dur, 0.15 * dur, 10.0),))
    offered = len(spec.arrivals())
    for mode, continuous in (("continuous", True), ("static", False)):
        pool = pd.PagedDecodeSlotPool(params, cfg, slots=SERVE_REPLAY_SLOTS)
        ex = GenerativeInferenceExecutor(pool, continuous=continuous, max_queue=1024,
                                         default_max_new_tokens=max(SERVE_REPLAY_MIX),
                                         warmup_prompt=np.asarray([1, 2, 3], np.int32),
                                         registry=MetricsRegistry()).start()
        try:
            check(ex.wait_warm(300.0), f"8c replay {mode}: the executor never warmed")
            flash_forward.launches = 0
            lat, elapsed = _replay_executor(
                ex, spec, lambda i: replay_prompts[i % len(replay_prompts)],
                lambda i: SERVE_REPLAY_MIX[i % len(SERVE_REPLAY_MIX)], SERVE_REPLAY_CLIENTS)
        finally:
            ex.stop(drain=True)
        n, stats = flash_forward.launches, ex.stats()
        launches.append(n)
        check(stats["admitted"] == offered and n == L * offered,
              f"8c replay {mode}: {stats['admitted']} admissions of {offered}, {n} launches")
        print(f"{tag} 8c replay {mode}, slots {SERVE_REPLAY_SLOTS}: {offered} requests over "
              f"{dur:.0f} s (base rate {SERVE_REPLAY_BASE_RATE} req/s, diurnal 0.4, 10x burst "
              f"at {0.5 * dur:.1f}-{0.65 * dur:.1f} s offering up to {spec.peak_rate:.0f} req/s),"
              f" max_new mix {SERVE_REPLAY_MIX}: all completed in {elapsed:.3f} s ("
              f"{offered / elapsed:.1f} req/s served); latency {_latency_line(lat)}; "
              f"{stats['tokens'] / elapsed:.1f} generated tokens/s; mean slot occupancy "
              f"{stats['mean_slot_occupancy']}; {stats['steps']} decode steps", flush=True)
        del pool, ex
    _free_card()
    return {"params": params, "cfg": cfg, "prompts": prompts}


def serving_replica():
    """``ServingPool`` replica target of phase 8d (``chip_smoke.py:serving_replica``):
    phase 4's generator built from its seed on the card, behind a generative
    JsonModelServer over a PagedDecodeSlotPool(slots=4) whose ``/stats``
    also report this process's flash forward launches and the kernels its
    build compiled."""
    from deeplearning4j_tpu_torch import set_fp32_numerics
    from deeplearning4j_tpu_torch.kernels import _build
    from deeplearning4j_tpu_torch.kernels.attention import flash_forward
    from deeplearning4j_tpu_torch.models import paged_decode as pd
    from deeplearning4j_tpu_torch.serving import JsonModelServer

    class ReportingPool(pd.PagedDecodeSlotPool):
        def block_stats(self):
            return {**super().block_stats(), "flash_fwd_launches": flash_forward.launches,
                    "kernels_built": len(_build.build_info.get("built", ()))}

    set_fp32_numerics()
    params, cfg, _ = generator_model()
    return JsonModelServer(None, generative_session=ReportingPool(params, cfg, slots=4),
                           default_max_new_tokens=GEN_MAX_NEW, warmup_input=[1, 2, 3])


def _await_ready(pool, ids, timeout, ready_at):
    """Poll until every replica in ``ids`` is ready; records the monotonic
    time each was first seen ready."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for rid, state in pool.replica_states().items():
            if state == "ready":
                ready_at.setdefault(rid, time.monotonic())
        if all(i in ready_at for i in ids):
            return True
        time.sleep(0.05)
    return False


def _replica_logs(pool):
    for name in sorted(os.listdir(pool._logs_dir)):
        with open(os.path.join(pool._logs_dir, name)) as f:
            tail = f.read().splitlines()[-30:]
        print(f"--- {name}\n" + "\n".join(tail), flush=True)


def phase_serving_pool(tag, launches, gen, gen_tokens, target=None):
    """8d: a ServingPool of two replica processes of 8c's model (each its
    own CUDA context, sharing one kernel build through the pool's compile
    cache): the six prompts through the router, then a third replica, then
    a draining stop."""
    from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
    from deeplearning4j_tpu_torch.serving import ServingPool

    target = target or f"{os.path.abspath(__file__)}:serving_replica"
    workdir = tempfile.mkdtemp(prefix="tdl_smoke_pool_")
    pool = ServingPool(target, replicas=2, min_replicas=1, max_replicas=3, workdir=workdir,
                       registry=MetricsRegistry())
    ready_at, handles = {}, []
    try:
        pool.start()
        if not _await_ready(pool, (0, 1), 300.0, ready_at):
            _replica_logs(pool)
            raise SmokeFailure(f"8d: replicas not ready: {pool.replica_states()}")
        prompts = gen["prompts"]
        served, lat, wall = _drive_clients("8d pool", pool.port, prompts, len(prompts))
        same = check_near_ties(tag, "8d pool", gen["params"], gen["cfg"], prompts, served,
                               gen_tokens)
        pool.scale_to(3)
        if not _await_ready(pool, (0, 1, 2), 300.0, ready_at):
            _replica_logs(pool)
            raise SmokeFailure(f"8d: the third replica never became ready: "
                               f"{pool.replica_states()}")
        stats = pool.replica_stats()
        with pool._lock:
            handles = list(pool._replicas.values())
        spawned = {h.id: h.spawned_at for h in handles}
    finally:
        pool.stop(drain=True, timeout=60.0)
    codes = {h.id: h.proc.returncode for h in handles}
    check(codes == {0: 0, 1: 0, 2: 0}, f"8d: replica exit codes {codes}, expected 0 each")
    L = gen["cfg"].n_layers
    replica_launches = 0
    for rid in (0, 1, 2):
        s = stats.get(rid)
        check(s is not None, f"8d: replica {rid} reported no stats")
        n, admitted = s["blocks"]["flash_fwd_launches"], s["admitted"]
        # the warm-up prompt is one admission that stats() does not count
        check(n == L * (admitted + 1), f"8d: replica {rid}: {n} flash launches for "
                                       f"{admitted} admissions and the warm-up")
        replica_launches += n
    check(stats[2]["blocks"]["kernels_built"] == 0,
          "8d: the third replica ran nvcc instead of loading the shared build")
    launches.append(replica_launches)
    ready_s = {rid: ready_at[rid] - spawned[rid] for rid in (0, 1, 2)}
    print(f"{tag} 8d ServingPool, 2 replica processes of 8c's model: {len(prompts)} prompts "
          f"through the router, all 200, {same}/{len(prompts)} token-identical to phase 4's; "
          f"per request {_latency_line(lat)}; admissions per replica "
          f"{ {rid: stats[rid]['admitted'] for rid in (0, 1)} }; time to ready: replicas 0 and 1 "
          f"(cold kernel build, nvcc run {stats[0]['blocks']['kernels_built']} and "
          f"{stats[1]['blocks']['kernels_built']} sources) {ready_s[0]:.3f} s and "
          f"{ready_s[1]:.3f} s, replica 2 after scale_to(3) (the shared build, no nvcc) "
          f"{ready_s[2]:.3f} s; {replica_launches} flash forward launches in the replicas; "
          f"every replica exited 0 at stop(drain=True)", flush=True)
    shutil.rmtree(workdir, ignore_errors=True)


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
        gen_tokens = gen["tokens"]
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
        t6 = time.perf_counter()
        phase_lenet(tag)
        print(f"phase 6a LeNet: ok ({time.perf_counter() - t6:.1f} s)", flush=True)
        t6 = time.perf_counter()
        phase_char_rnn(tag)
        print(f"phase 6b char-RNN: ok ({time.perf_counter() - t6:.1f} s)", flush=True)
        t6 = time.perf_counter()
        phase_attention_mln(tag, launches)
        print(f"phase 6c attention MLN: ok ({time.perf_counter() - t6:.1f} s)", flush=True)
        t7 = time.perf_counter()
        phase_resnet(tag)
        print(f"phase 7a ResNet-50: ok ({time.perf_counter() - t7:.1f} s)", flush=True)
        t7 = time.perf_counter()
        phase_facenet(tag)
        print(f"phase 7b InceptionResNetV1: ok ({time.perf_counter() - t7:.1f} s)", flush=True)
        t7 = time.perf_counter()
        phase_attention_graph(tag, launches)
        print(f"phase 7c attention graph: ok ({time.perf_counter() - t7:.1f} s)", flush=True)
        _free_card()
        t8 = time.perf_counter()
        phase_serve_mln(tag)
        print(f"phase 8a MLN micro-batching: ok ({time.perf_counter() - t8:.1f} s)", flush=True)
        t = time.perf_counter()
        phase_serve_attention(tag, launches["flash_fwd"])
        print(f"phase 8b attention MLN and ResNet-50 serving: ok ({time.perf_counter() - t:.1f} s)",
              flush=True)
        t = time.perf_counter()
        served = phase_serve_generate(tag, launches["flash_fwd_f32"], gen_tokens)
        print(f"phase 8c continuous batching: ok ({time.perf_counter() - t:.1f} s)", flush=True)
        t = time.perf_counter()
        phase_serving_pool(tag, launches["flash_fwd_f32"], served, gen_tokens)
        del served
        print(f"phase 8d serving pool: ok ({time.perf_counter() - t:.1f} s); phase 8 "
              f"{time.perf_counter() - t8:.1f} s", flush=True)
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
