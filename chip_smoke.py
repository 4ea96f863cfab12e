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
   draining stop after which every replica exited 0;
9. checkpoints (``serde.checkpoint``): (a) phase 7a's ResNet-50 state
   through ``TrainingCheckpointer(async_write=True, durable=True)``: the time
   ``save()`` blocks (the device->host snapshot, cold and warm) against the
   pinned ``copy_`` rate of a 256 MiB buffer, the background write, the
   generation's bytes, deep verify and a restore into a fresh network (state
   and float32 ``output()`` at batch 8 bit for bit), 10 steps with a save
   after every fifth against 10 without, in turns; (b) phase 6c's attention
   MLN with dropout 0.9, 12 batches with the ragged mask: 12 steps
   uninterrupted here against a worker process (``checkpoint_worker``) that a
   SIGTERM preempts after step 5 (``PreemptionHandler``) and a second that
   restores the ``preempt`` generation with the iterator position and fits
   steps 6-12, float32 (scores, parameters and Adam state bit for bit) and
   bfloat16 (within one bf16 ulp; whether bitwise is printed), one launch of
   each flash kernel per step of every worker; (c) a worker killed by
   ``torn_ckpt@stage=`` at each commit boundary, after which restore comes
   back with the previous generation (past the COMMIT marker, the new one),
   and a ``corrupt_ckpt`` bit flip that deep verify names; (d) a
   ``ServingPool`` of one ``checkpoint_replica``: ``swap_model`` onto (c)'s
   corrupted lineage refused at preflight, onto (b)'s resumed lineage
   rolled, answers equal to the resumed network's float32 output at the
   served batch shape bit for bit, one flash forward per executed batch;
10. export and data-parallel training, the kernels reached through their
   operators (``tdl::flash_fwd``, ``tdl::flash_bwd_dq``,
   ``tdl::flash_bwd_dkv``): (a) phase 6c's attention MLN exported at [16,
   256, 128] in float32 and bf16 (``MultiLayerNetwork.export``, the graph
   holding ``tdl.flash_fwd``, no launch while tracing), reloaded in a child
   process that imports only torch, numpy and ``serde.compiled`` (neither
   the port's ``nn`` nor ``models``): float32 answers equal to eager
   ``output()`` bit for bit, bf16 within one bf16 ulp (bitwise printed),
   one flash forward per call at eager's q-tile; the seconds of export,
   save and load, and the reloaded call against ``output()`` in turns
   (median of 20); (b) ``parallel.launcher.launch(n_processes=1,
   backend="nccl")`` fits 6c's MLN with ``MultiProcessTrainer`` (float32
   Sgd, 6 steps): scores and parameters equal to the same fit in this
   process bit for bit, one launch of each kernel per step, and the
   trainer's step against plain ``fit`` in turns (median of 20); (c) two
   ranks sharing the card over gloo with CUDA tensors, each feeding half of
   every global batch of 16: 6c's MLN at dropout 0.0 and 0.9 (each rank
   its rows of the global mask) against the one-process fit on the global
   batches (loss 1e-5 relative, each update 1e-3 of its norm), one launch
   of each kernel per step per rank, then Conv -> BatchNormalization ->
   Dense -> Output, whose running statistics equal the one-process fit's
   within 1e-5; (d) ``ParameterAveragingTrainingMaster(workers=2,
   averaging_frequency=2)`` on 6c's MLN, 8 batches, card against CPU
   (1e-5, 1e-4);
11. sharded training, ranks sharing the card over gloo with CUDA tensors
   (``launcher.launch(backend="gloo")``; the collectives gloo refuses for
   CUDA tensors stage through the host, and the phase prints which did):
   (a) BERT-base at full width and depth (max_len 128, phase 5's batch: B
   16, T 128, 19 MLM positions, Adam) placed on a 4-rank (dp, tp, sp) =
   (1, 2, 2) mesh (``place_params``), Ulysses attention through the flash
   kernels: one float32 step against the one-process float32 step (loss
   1e-5, each gathered gradient 1e-3 of its norm), then 5 + 10 bf16 steps
   (median ms on rank 0), exactly 12 launches of each flash kernel per rank
   per step, each rank's resident bytes of parameters and Adam state
   against the one-process total and the spec-derived expectation, and the
   bytes the collectives moved per step; (b) the same model at (2, 1, 2)
   with ring attention (plain PyTorch, no launch): one float32 step within
   the same limits; (c) phase 10's attention MLN under
   ``MultiProcessTrainer(mesh_layout=SpecLayout(1, 2, 2))`` on 4 ranks, 6
   float32 steps against the one-process fit (10c's limits), one launch of
   each kernel per step per rank, saved through ``trainer.checkpointer``
   after step 3; a 2-rank gang under ``SpecLayout(1, 2, 1)`` refuses the
   restore without ``reshard=True`` (naming both layouts), restores with it
   bit for bit to the saved state, and trains steps 4-6 within 10c's limits
   of the uninterrupted fit; save, verify and restore ms and the reshard
   metrics;
12. pipeline parallelism (``parallel.pipeline``), ranks sharing the card
   over gloo: (a) BERT-base at full width and depth (max_len 128, phase 5's
   batch and weights, its 19 MLM positions as weight-1 labels of [16, 128])
   on 4 ranks at ``SpecLayout(data=1, fsdp=1, pipe=4)``, 3 layers per stage
   (the cost model's split), M=4 microbatches of [4, 12, 128, 64] into the
   kernels: one float32 GPipe and one 1F1B step against the one-process
   float32 step (loss 1e-5, each gathered gradient 1e-3 of its norm), their
   losses bitwise equal, launches per rank per step (1F1B: 36 forward, 12
   of each backward kernel; GPipe 12 each); ``PipelineParallelTrainer``
   bf16 1F1B steps (5 + 10 timed, rank 0's median), each rank's resident
   parameters + Adam state against the spec-derived count, the bytes of the
   rings and the broadcasts over ``pipe``, and the peak memory above
   resident of one bf16 step at M=8 (mb 2), GPipe against 1F1B in turns;
   (b) the same model and batch in float32 at ``SpecLayout(data=2,
   pipe=2)``: two 1F1B steps, ``profile_stages`` beside the predicted
   fractions, ``maybe_rebalance([2.0, 1.0])`` moving the split to the one
   ``balance_stages`` gives for the corrected costs, two more steps (stage
   1 fetching rows from stage 0's chunk), all four within 10c's limits of
   the one-process fit; saved through ``trainer.checkpointer``, restored
   onto ``PipelinePartitioner(SpecLayout(data=1, fsdp=2))`` in a fresh
   2-rank gang, refused without ``reshard=True`` and bit for bit with it;
13. unattended operation on 9b's network (6c's attention MLN, Adam, dropout
   0.9) in float32, ranks sharing the card over gloo; (b) runs beside (a)
   and (c), and (c)'s pool warms during (a): (a) ``GangSupervisor`` of two
   ``sup_worker`` ranks, global batch 16 (8 rows each), 12 steps, a lineage
   generation every 3 (``keep_last`` 4), restored at every start, under
   ``crash@iter=7,rank=1;loss_spike@iter=11,scale=60,restart=1``: one
   restart classified crash, generations at 3, 6, 9 and 12, gen-9 within
   10c's limits of the one-process fit of 9 steps, one launch of each
   kernel per step per rank, the postmortem and the timeline with the
   crash and the respawn, ``tdl_gang_recovery_seconds`` observed once;
   (b) an elastic gang of two ranks under ``largest_layout`` (fsdp=2), a
   generation every 2 steps, ``max_restarts`` 1: rank 1 crashes at
   iteration 3 and dies at boot after that, the supervisor resizes 2 -> 1
   (``tdl_gang_resizes_total{direction="down"}`` 1, ``postmortem.json``
   ``elastic_resize``), the survivor restores iteration 2 with
   ``reshard=True`` and finishes 8 steps within 10c's limits; (c) (a)'s
   lineage with gen-6 bit-flipped, a ``ServingPool`` of two
   ``checkpoint_replica`` with ``latency_inject@value=0.5`` on gen-9, and a
   ``FleetController`` run once (integrity, eval on a held-out batch
   through ``Evaluation.to_metrics``, canary under a seeded ``TraceSpec``):
   gen-6 rejected at integrity, gen-12 (loss-spiked) at eval, gen-9 at the
   canary, gen-3 promoted through the canary and swapped into both
   replicas; only 200 and 429 escape the pool, the audit and the
   ``deploy_rollback`` flight events agree, the canaries and the promoted
   replicas launch one flash forward per executed batch, and the promoted
   replicas answer gen-3's output bit for bit;
14. the NLP package (``deeplearning4j_tpu_torch.nlp``): (a) ``Word2Vec``
   skip-gram with negative sampling at bench.py's accelerator shapes (its
   corpus: 20,000 Zipf sentences of 8-19 words over 2,000 words, seed 0;
   layer 100, batch 16384, window 5, 5 negatives, one epoch): a warm fit,
   then a timed fit, words/s as bench.py computes it, the fit split into its
   host part and the device loop (run with CUDA's sync debug mode set to
   error: the loop never waits for the card), the loop's profile, and syn0
   and syn1neg against the CPU fit on the same seed; then CBOW with
   hierarchical softmax and negative sampling at the same shapes against
   its CPU fit; (b) ``Glove`` on (a)'s corpus, ``ParagraphVectors`` (DM)
   with ``infer_vector`` on a seeded four-topic corpus, ``SequenceVectors``
   over a ``GraphWalkIterator`` of a 200-node community graph, and
   ``BarnesHutTsne`` of (a)'s 2,000 word vectors (the affinities, the first
   10 steps from one start, the final KL of 500), each against its CPU run
   on the same seed; (c) ``BertIterator`` (masked LM, ``max_length`` 128,
   batch 16) over WordPiece text from a seeded vocabulary, sentences and
   pairs of ~10 to past 128 pieces, feeding BERT-base at full width and
   depth: a float32 step with the iterator's key padding through the
   kernels against the dense path (phase 5's limits), then 24 bf16 Adam
   steps, 12 launches of each kernel per step and no dense attention, a
   falling loss, the median step.

A line before the last is a JSON object describing each kernel (launch
counts on the main path, error against the plain version, times and the
card's bound; the forward also by q-tile instantiation, with the launches
of the autotune search; phase 10's to 14's launches are in the counts:
the forward in 10a-d, the backward pair in 10b-d, all three in 11a, 11c,
12a, 12b, 13a, 13b and 14c, the forward in 13c's replicas and eval gate),
then the card's name and power
limit; the last line is
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
from collections import Counter

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
        # a pipeline microbatch of phase 12: mb 4 (M=4) and mb 2 (M=8)
        ("bert_base_mb4", 4, 12, 128, 128, 64, False, None),
        ("bert_base_mb2", 2, 12, 128, 128, 64, False, None),
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


def _attention_conf(updater, dropout=0.0):
    """Phase 6c's attention MLN; ``dropout`` (a retain probability) on every
    layer's input where given (phase 9b)."""
    from deeplearning4j_tpu_torch.nn import conf as C
    from deeplearning4j_tpu_torch.nn.attention_layers import SelfAttentionLayer

    b = C.NeuralNetConfiguration.Builder().seed(21).updater(updater)
    if dropout:
        b = b.dropout(dropout)
    return (b.list()
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
    with ``cudnn.benchmark`` off and on in turns. Returns the trained
    network and its staged batch (phase 9a)."""
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
    return net, ds  # phase 9a checkpoints this state


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


# ------------------------------------------------------------------ phase 9

# Checkpoints on the card. 9a: phase 7a's ResNet-50 state; the host link's
# bound is the pinned device->host copy_ of a buffer this large, beside PCIe
# Gen5 x16's nominal rate. 9b: phase 6c's attention MLN with dropout on every
# layer (its key is (seed, iteration): restoring the iteration replays the
# masks), 12 batches with the ragged mask, preempted after step 5.
CKPT_LINK_BYTES = 256 << 20
PCIE5_X16_GBS = 64.0
CKPT_STEPS, CKPT_PREEMPT_AT, CKPT_DROPOUT = 12, 5, 0.9
CKPT_TIMED_STEPS, CKPT_SAVE_EVERY = 10, 5
CKPT_OUTPUT_BATCH = 8
CKPT_SERVE_CLIENTS, CKPT_SERVE_REQUESTS = 4, 4     # requests per client
CKPT_WORKER_TIMEOUT = 300.0


def _link_gbs():
    """The pinned device->host ``copy_`` rate of a CKPT_LINK_BYTES buffer
    (GB/s, median of 5, CUDA events)."""
    import torch

    src = torch.empty(CKPT_LINK_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty(CKPT_LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    ms = time_ms(lambda: dst.copy_(src, non_blocking=True), n=5, warmup=2)
    return CKPT_LINK_BYTES / (ms / 1e3) / 1e9


def _state(net):
    from deeplearning4j_tpu_torch.serde.net_state import snapshot

    return snapshot(net)


def _states_equal(a, b) -> bool:
    return sorted(a) == sorted(b) and all(
        a[p].dtype == b[p].dtype and np.array_equal(a[p].view(np.uint8), b[p].view(np.uint8))
        for p in a)


def _generation_bytes(gendir):
    """(bytes the manifests count, bytes of the shard files)."""
    names = os.listdir(gendir)
    counted = sum(json.load(open(os.path.join(gendir, n)))["nbytes"]
                  for n in names if n.startswith("manifest_"))
    on_disk = sum(os.path.getsize(os.path.join(gendir, n))
                  for n in names if n.startswith("shard_"))
    return counted, on_disk


def phase_checkpoint_resnet(tag, net, ds, workdir):
    """9a: ``TrainingCheckpointer(async_write=True, durable=True).save()`` of
    phase 7a's ResNet-50 (bf16 compute, Nesterovs, after its timed steps):
    the time ``save()`` blocks (the device->host snapshot) against the host
    link, the background write, the generation's bytes; deep verify and a
    restore into a fresh network, each timed, state and float32 ``output()``
    at batch 8 bit for bit; 10 steps with a save after every fifth against
    10 without, in turns."""
    import torch

    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.serde import TrainingCheckpointer, verify_checkpoint

    card = card_line()
    link = _link_gbs()
    root = os.path.join(workdir, "resnet")
    ck = TrainingCheckpointer(root, async_write=True, durable=True)
    times = []
    for _ in range(2):  # the first save also allocates the pinned buffers
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gendir = ck.save(net)
        t1 = time.perf_counter()
        ck.wait()
        times.append((t1 - t0, time.perf_counter() - t1, gendir))
    state = _state(net)
    snap_bytes = sum(a.nbytes for a in state.values())
    counted, on_disk = _generation_bytes(times[-1][2])
    for i, (block, write, gendir) in enumerate(times):
        print(f"{tag} 9a ResNet-50 save {i + 1} ({'cold' if i == 0 else 'warm'} pinned buffers), "
              f"async, durable: save() blocked {block * 1e3:.3f} ms (device->host snapshot of "
              f"{snap_bytes / 1e6:.3f} MB = {snap_bytes / block / 1e9:.3f} GB/s against the "
              f"measured pinned copy_ {link:.3f} GB/s and PCIe Gen5 x16's nominal "
              f"{PCIE5_X16_GBS} GB/s: {snap_bytes / block / 1e9 / link:.3f} of the link); "
              f"background write until wait() {write * 1e3:.3f} ms; "
              f"{os.path.basename(gendir)} [{card}]", flush=True)
    print(f"{tag} 9a ResNet-50 generation: {counted} bytes in the manifest's nbytes "
          f"({counted / 1e6:.3f} MB), shard file {on_disk} bytes, {len(state)} arrays "
          f"[{card}]", flush=True)
    t0 = time.perf_counter()
    verdict = verify_checkpoint(root, deep=True)
    verify_s = time.perf_counter() - t0
    check(verdict["ok"], f"9a: the ResNet-50 checkpoint does not verify: {verdict}")
    fresh = ResNet50().init(device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(TrainingCheckpointer(root).restore(fresh), "9a: restore found no checkpoint")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(_states_equal(_state(fresh), state),
          "9a: the restored ResNet-50's parameters, Nesterovs state or BN statistics differ")
    x8 = ds.features[:CKPT_OUTPUT_BATCH]
    with float32_policy():
        same = torch.equal(net.output(x8)[0], fresh.output(x8)[0])
    check(same, "9a: the restored ResNet-50's float32 output() differs from the original's")
    print(f"{tag} 9a ResNet-50 deep verify {verify_s * 1e3:.3f} ms ({verdict['bytes']} bytes, "
          f"{verdict['bytes'] / verify_s / 1e9:.3f} GB/s), restore into a fresh network "
          f"{restore_s * 1e3:.3f} ms; parameters, Nesterovs state and BN statistics equal bit "
          f"for bit; float32 output() {list(x8.shape)} equal bit for bit [{card}]", flush=True)
    del fresh
    _free_card()

    def steps(save):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(1, CKPT_TIMED_STEPS + 1):
            net.fit(ds)
            if save and k % CKPT_SAVE_EVERY == 0:
                ck.save(net)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        ck.wait()
        return dt

    runs = {False: [], True: []}
    for save in (False, True, True, False, False, True):
        runs[save].append(steps(save))
    plain, saving = statistics.median(runs[False]), statistics.median(runs[True])
    print(f"{tag} 9a ResNet-50 {CKPT_TIMED_STEPS} bf16 steps [{RESNET_BATCH},3,224,224]: "
          f"{plain:.3f} ms without saves {runs[False]}, {saving:.3f} ms with a save after "
          f"every {CKPT_SAVE_EVERY}th {runs[True]} (in turns); saving costs "
          f"{(saving - plain) / plain:.4f} of the step time [{card}]", flush=True)


def _preempt_data():
    """Phase 6c's batch shape and ragged mask, CKPT_STEPS batches from one seed."""
    from deeplearning4j_tpu_torch.data import DataSet

    rs = np.random.RandomState(8)
    out = []
    for _ in range(CKPT_STEPS):
        lengths = np.concatenate([[ATTN_T], rs.randint(16, ATTN_T + 1, ATTN_B - 1)])
        fm = (np.arange(ATTN_T)[None] < lengths[:, None]).astype(np.float32)
        out.append(DataSet(rs.randn(ATTN_B, ATTN_C, ATTN_T).astype(np.float32),
                           np.eye(10, dtype=np.float32)[rs.randint(0, 10, ATTN_B)],
                           features_mask=fm))
    return out


def _preempt_net(dtype):
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    conf = _attention_conf(Adam(1e-3), dropout=CKPT_DROPOUT)
    conf.dtype = dtype
    return MultiLayerNetwork(conf, device="cuda").init()


def _policy(dtype):
    """float32: the float32 precision policy (no bf16 compute), so the run
    is held bit for bit in float32; bfloat16: the default policy."""
    return float32_policy() if dtype == "float32" else contextlib.nullcontext()


def checkpoint_worker(spec_json):
    """Phase 9's worker process (``chip_smoke.py:checkpoint_worker``, run by
    ``python3 -c``): ``preempt`` fits phase 9b's network under a
    ``PreemptionHandler`` and waits after step 5 for SIGTERM; ``resume``
    restores the ``preempt`` generation and fits steps 6-12, then saves the
    result under ``latest``; ``torn`` restores a lineage, fits one step and
    saves under a ``torn_ckpt`` fault. Results go to ``spec["out"]``."""
    from deeplearning4j_tpu_torch import set_fp32_numerics
    from deeplearning4j_tpu_torch.data import ListDataSetIterator
    from deeplearning4j_tpu_torch.serde import PreemptionHandler, TrainingCheckpointer

    spec = json.loads(spec_json)
    set_fp32_numerics()
    data = _preempt_data()
    it = ListDataSetIterator(data)
    net = _preempt_net(spec["dtype"])
    result = {"scores": []}

    def dump():
        with open(spec["out"] + ".tmp", "w") as f:
            json.dump(result, f)
        os.replace(spec["out"] + ".tmp", spec["out"])

    with _policy(spec["dtype"]):
        ck = TrainingCheckpointer(spec["root"], async_write=False)
        if spec["role"] == "preempt":
            class Park:
                def iteration_done(self, model, iteration, epoch):
                    result["scores"].append(model.score_)
                    if iteration == CKPT_PREEMPT_AT:
                        result.update(iteration=iteration, epoch=epoch, iterator=it.state(),
                                      launches=_read_counts())
                        dump()
                        while True:  # SIGTERM lands here: the handler saves, then dies
                            time.sleep(0.05)

            PreemptionHandler(ck, net, it).install()
            net.add_listeners(Park())
            _zero_counts()
            net.fit(it)
            raise SmokeFailure("the preempted worker finished its epoch")
        check(ck.restore(net, it, tag=spec["tag"]), f"worker: no {spec['tag']} checkpoint")
        result.update(iteration=net.iteration, epoch=net.epoch, iterator=it.state())
        _zero_counts()
        if spec["role"] == "resume":
            while it.has_next():
                net._fit_batch(it.next())
                result["scores"].append(net.score_)
            net.epoch += 1
            result["launches"] = _read_counts()
            ck.save(net)
        else:  # torn: one step, then a save killed at spec["stage"]
            net._fit_batch(it.next())
            result["launches"] = _read_counts()
            np.savez(spec["out"] + ".npz", **_state(net))
            dump()
            os.environ["TDL_FAULT_SPEC"] = f"torn_ckpt@stage={spec['stage']}"
            ck.save(net)
            raise SmokeFailure(f"the save torn at stage {spec['stage']} returned")
    dump()


def _start_worker(workdir, name, **spec):
    spec["out"] = os.path.join(workdir, f"{name}.json")
    code = (f"import sys; sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r}); "
            f"import chip_smoke; chip_smoke.checkpoint_worker({json.dumps(spec)!r})")
    log = open(os.path.join(workdir, f"{name}.log"), "w")
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, spec["out"]


def _finish_worker(proc, name, workdir, want_rc):
    try:
        rc = proc.wait(CKPT_WORKER_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    if rc != want_rc:
        with open(os.path.join(workdir, f"{name}.log")) as f:
            print(f"--- {name}.log\n" + "\n".join(f.read().splitlines()[-30:]), flush=True)
        raise SmokeFailure(f"9: worker {name} ended with {rc}, expected {want_rc}")


def _await_file(path, proc, timeout=CKPT_WORKER_TIMEOUT):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if proc.poll() is not None or time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def _sum_launches(launches, counts, dtype):
    suffix = "_f32" if dtype == "float32" else ""
    for name, n in counts.items():
        launches[f"{name}{suffix}"].append(n)


def phase_preempt_resume(tag, launches, workdir):
    """9b: phase 6c's attention MLN with dropout, 12 steps uninterrupted in
    this process against a worker preempted by SIGTERM after step 5 and a
    second worker that restores the ``preempt`` generation (with the
    iterator position) and fits steps 6-12; float32 (bit for bit) and
    bfloat16. Returns {dtype: checkpointer root}."""
    import signal

    import torch

    from deeplearning4j_tpu_torch.data import ListDataSetIterator
    from deeplearning4j_tpu_torch.serde import TrainingCheckpointer, lineage_state

    card = card_line()
    roots, refs, procs = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        roots[dtype] = os.path.join(workdir, f"preempt_{dtype}")
        procs[dtype] = _start_worker(workdir, f"preempt_{dtype}", role="preempt", dtype=dtype,
                                     root=roots[dtype])
    for dtype in ("float32", "bfloat16"):  # the uninterrupted runs, while the workers start
        with _policy(dtype):
            net, it, seen = _preempt_net(dtype), ListDataSetIterator(_preempt_data()), {}
            scores = []

            class Record:
                def iteration_done(self, model, iteration, epoch):
                    scores.append(model.score_)
                    if iteration == CKPT_PREEMPT_AT:
                        seen.update(iteration=iteration, epoch=epoch, iterator=it.state())

            net.add_listeners(Record())
            _zero_counts()
            net.fit(it)
            counts = _read_counts()
            _check_attention_counts(f"9b {dtype} uninterrupted", counts, CKPT_STEPS)
            _sum_launches(launches, counts, dtype)
            refs[dtype] = (scores, seen, _state(net))
            del net
    for dtype, (proc, out) in procs.items():
        check(_await_file(out, proc), f"9b {dtype}: the worker never reached step "
                                      f"{CKPT_PREEMPT_AT}")
        proc.send_signal(signal.SIGTERM)
        _finish_worker(proc, f"preempt_{dtype}", workdir, -signal.SIGTERM)
        state = lineage_state(roots[dtype], tag="preempt")
        check(state["newest_committed"] == f"gen-{CKPT_PREEMPT_AT:08d}",
              f"9b {dtype}: no committed preempt generation after SIGTERM: {state}")
        with open(out) as f:
            first = json.load(f)
        _check_attention_counts(f"9b {dtype} preempted steps", first["launches"],
                                CKPT_PREEMPT_AT)
        _sum_launches(launches, first["launches"], dtype)
        refs[dtype] += (first,)
    resumed = {dtype: _start_worker(workdir, f"resume_{dtype}", role="resume", dtype=dtype,
                                    root=roots[dtype], tag="preempt")
               for dtype in ("float32", "bfloat16")}
    for dtype, (proc, out) in resumed.items():
        _finish_worker(proc, f"resume_{dtype}", workdir, 0)
        with open(out) as f:
            second = json.load(f)
        scores, seen, ref_state, first = refs[dtype]
        got = first["scores"] + second["scores"]
        _check_attention_counts(f"9b {dtype} resumed steps", second["launches"],
                                CKPT_STEPS - CKPT_PREEMPT_AT)
        _sum_launches(launches, second["launches"], dtype)
        check({k: first[k] for k in seen} == seen,
              f"9b {dtype}: at the preemption {first} against the uninterrupted {seen}")
        check({k: second[k] for k in seen} == {**seen, "iteration": CKPT_PREEMPT_AT},
              f"9b {dtype}: restored {second} against the uninterrupted run's {seen}")
        with _policy(dtype):
            final = _preempt_net(dtype)
            check(TrainingCheckpointer(roots[dtype]).restore(final),
                  f"9b {dtype}: the resumed worker left no checkpoint")
        bitwise = got == scores and _states_equal(_state(final), ref_state)
        worst = max(abs(a - b) / (BF16_ULP_REL * abs(b) + BF16_ATOL) for a, b in zip(got, scores))
        print(f"{tag} 9b attention MLN [{ATTN_B},{ATTN_C},{ATTN_T}] {dtype}, dropout "
              f"{CKPT_DROPOUT}, Adam: preempted by SIGTERM after step {CKPT_PREEMPT_AT} "
              f"(preempt generation committed, worker died by the signal), resumed in a new "
              f"process from iteration {second['iteration']}, epoch {second['epoch']}, "
              f"iterator {second['iterator']}; scores and final parameters + Adam state "
              f"{'equal bit for bit' if bitwise else 'NOT bitwise'} to the uninterrupted run "
              f"(worst score {worst:.3f} of one bf16 ulp); launches per resumed step "
              f"{ {k: v // (CKPT_STEPS - CKPT_PREEMPT_AT) for k, v in second['launches'].items()} } "
              f"[{card}]", flush=True)
        if dtype == "float32":
            check(bitwise, "9b float32: the resumed run is not bitwise equal to the "
                           "uninterrupted one")
        else:
            check(worst <= 1.0, f"9b bfloat16: a resumed score is {worst:.3f} bf16 ulps from "
                                f"the uninterrupted run's")
    del refs
    _free_card()
    return roots


def phase_torn_and_corrupt(tag, launches, workdir, root):
    """9c: for each commit boundary a worker restores the float32 ``preempt``
    generation (cloned into a lineage of its own), fits one step and dies at
    that boundary (``torn_ckpt``); restore then comes back to the previous
    generation (past the COMMIT marker, to the new one). ``corrupt_ckpt``
    bit-flips a committed shard, which deep verify names. Returns the
    corrupted lineage's root."""
    from deeplearning4j_tpu_torch.common.faults import CKPT_STAGES, CRASH_EXIT_CODE
    from deeplearning4j_tpu_torch.serde import (TrainingCheckpointer, lineage_state,
                                                verify_checkpoint)
    from deeplearning4j_tpu_torch.serde.checkpoint import clone_generation

    card = card_line()
    src = os.path.join(root, "preempt", f"gen-{CKPT_PREEMPT_AT:08d}")
    procs = {}
    for stage in CKPT_STAGES:
        lineage = os.path.join(workdir, f"torn_{stage}")
        clone_generation(src, lineage)
        procs[stage] = (lineage,) + _start_worker(workdir, f"torn_{stage}", role="torn",
                                                  dtype="float32", root=lineage, tag="latest",
                                                  stage=stage)
    with float32_policy():
        before = _preempt_net("float32")
        TrainingCheckpointer(root).restore(before, tag="preempt")
        before = _state(before)
        lines = []
        for stage, (lineage, proc, out) in procs.items():
            _finish_worker(proc, f"torn_{stage}", workdir, CRASH_EXIT_CODE)
            with open(out) as f:
                counts = json.load(f)["launches"]
            _check_attention_counts(f"9c {stage} step", counts, 1)
            _sum_launches(launches, counts, "float32")
            after = dict(np.load(out + ".npz"))
            net = _preempt_net("float32")
            check(TrainingCheckpointer(lineage).restore(net), f"9c {stage}: nothing restored")
            want_it, want = ((CKPT_PREEMPT_AT + 1, after) if stage == "pointer"
                             else (CKPT_PREEMPT_AT, before))
            state = lineage_state(lineage)
            check(net.iteration == want_it and _states_equal(_state(net), want),
                  f"9c {stage}: restored iteration {net.iteration} (want {want_it}) or its "
                  f"state differs; lineage {state}")
            lines.append(f"{stage}: iteration {net.iteration}, quarantined "
                         f"{state['quarantined']}, pointer {state['pointer']}")
        print(f"{tag} 9c torn saves (each worker exited {CRASH_EXIT_CODE} at its commit "
              f"boundary), restore on the card with equal state: " + "; ".join(lines)
              + f" [{card}]", flush=True)
        corrupt = os.path.join(workdir, "corrupt")
        net = _preempt_net("float32")
        TrainingCheckpointer(root).restore(net)
        os.environ["TDL_FAULT_SPEC"] = "corrupt_ckpt"
        try:
            gendir = TrainingCheckpointer(corrupt, async_write=False).save(net)
        finally:
            del os.environ["TDL_FAULT_SPEC"]
        verdict = verify_checkpoint(corrupt, deep=True)
        check(not verdict["ok"] and verdict["reason"] == "shard_crc"
              and verdict["generation"] == os.path.basename(gendir),
              f"9c: deep verify of the bit-flipped generation: {verdict}")
        print(f"{tag} 9c corrupt_ckpt: deep verify names {verdict['generation']} "
              f"({verdict['reason']}) in {verdict['seconds'] * 1e3:.3f} ms [{card}]", flush=True)
    _free_card()
    return corrupt


def checkpoint_replica():
    """``ServingPool`` replica target of phases 9d and 13c
    (``chip_smoke.py:checkpoint_replica``): phase 9b's float32 network,
    restored from ``TDL_MODEL_CKPT`` when it is set (a lineage, or one
    generation of it), behind
    ``batch_limit(8)``; ``/stats`` reports the process's flash forward
    launches, the executed batches and the restored iteration."""
    from deeplearning4j_tpu_torch import set_fp32_numerics
    from deeplearning4j_tpu_torch.kernels.attention import flash_forward
    from deeplearning4j_tpu_torch.monitoring import get_registry
    from deeplearning4j_tpu_torch.serde import TrainingCheckpointer
    from deeplearning4j_tpu_torch.serving import JsonModelServer

    set_fp32_numerics()
    net = _preempt_net("float32")
    ckpt = os.environ.get("TDL_MODEL_CKPT")
    if ckpt:  # a checkpointer's root, or one generation of a lineage (13c)
        gen = re.fullmatch(r"gen-\d{8,}[a-z]?", os.path.basename(os.path.normpath(ckpt)))
        check(_restore_generation(net, ckpt) if gen else TrainingCheckpointer(ckpt).restore(net),
              f"no checkpoint in {ckpt}")

    class ReportingServer(JsonModelServer):
        def start(self):
            super().start()
            self._executor.stats = lambda: {"flash_fwd_launches": flash_forward.launches,
                                            "batches": _batches(self.registry)[0],
                                            "iteration": net.iteration}
            return self

    return ReportingServer(net, port=0, batch_limit=8, registry=get_registry(),
                           warmup_input=np.zeros((1, ATTN_C, ATTN_T), np.float32))


def phase_checkpoint_swap(tag, launches, workdir, healthy, corrupt, target=None):
    """9d: a ServingPool of one ``checkpoint_replica``: ``swap_model`` onto
    9c's corrupted lineage is refused at preflight with the verifier's
    reason while the old replica keeps serving; onto 9b's healthy float32
    lineage it rolls, and every answer equals the resumed network's float32
    output at the served batch shape bit for bit, with one flash forward per
    executed batch."""
    from deeplearning4j_tpu_torch.kernels import _build
    from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
    from deeplearning4j_tpu_torch.serde import TrainingCheckpointer
    from deeplearning4j_tpu_torch.serving import ServingPool

    card = card_line()
    target = target or f"{os.path.abspath(__file__)}:checkpoint_replica"
    reg = MetricsRegistry()
    # the replicas load phase 1's kernel build (TDL_COMPILE_CACHE_DIR/kernels)
    # instead of running nvcc into the pool's own cache
    pool = ServingPool(target, replicas=1, min_replicas=1, max_replicas=2,
                       workdir=os.path.join(workdir, "pool"), registry=reg,
                       extra_env={"TDL_COMPILE_CACHE_DIR": str(_build.build_dir().parent)})
    n = CKPT_SERVE_CLIENTS * CKPT_SERVE_REQUESTS
    seqs = list(np.random.RandomState(12).randn(n, 1, ATTN_C, ATTN_T).astype(np.float32))
    handles = []
    try:
        pool.start()
        if not _await_ready(pool, (0,), 300.0, {}):
            _replica_logs(pool)
            raise SmokeFailure(f"9d: the replica never became ready: {pool.replica_states()}")
        _drive_clients("9d old model", pool.port, seqs[:2], 1)
        try:
            pool.swap_model(corrupt)
            raise SmokeFailure("9d: swap_model accepted the corrupted lineage")
        except ValueError as e:
            refused = str(e)
        check("reason=shard_crc" in refused, f"9d: refused for another reason: {refused}")
        rejected = reg.get("tdl_pool_swap_rejected_total").value
        check(rejected == 1 and pool.replica_states() == {0: "ready"},
              f"9d: after the refusal: rejected {rejected}, replicas {pool.replica_states()}")
        _drive_clients("9d old model after the refusal", pool.port, seqs[:2], 1)
        t0 = time.perf_counter()
        res = pool.swap_model(healthy)
        swap_s = time.perf_counter() - t0
        check(res["ok"] and res["swapped"] == 1, f"9d: the healthy swap did not roll: {res}")
        before = pool.replica_stats()
        check(len(before) == 1, f"9d: replica stats {before}")
        (rid, before), = before.items()
        outs, lat, wall = _drive_clients("9d restored model", pool.port, seqs,
                                         CKPT_SERVE_CLIENTS)
        after = pool.replica_stats()[rid]
        with pool._lock:
            handles = list(pool._replicas.values())
    finally:
        pool.stop(drain=True, timeout=60.0)
    codes = [h.proc.returncode for h in handles]
    check(codes == [0], f"9d: replica exit codes {codes}")
    batches = after["batches"] - before["batches"]
    launched = after["flash_fwd_launches"] - before["flash_fwd_launches"]
    launches.append(launched)
    check(after["iteration"] == CKPT_STEPS and launched == batches,
          f"9d: the replica serves iteration {after['iteration']}, {launched} flash launches "
          f"for {batches} batches")
    net = _preempt_net("float32")
    TrainingCheckpointer(healthy).restore(net)
    pi = ParallelInference(net, batch_limit=8)
    ref = np.stack([pi.output(x) for x in seqs])
    got = np.asarray(outs, np.float32)
    check(got.shape == ref.shape, f"9d: responses of shape {got.shape}, expected {ref.shape}")
    worst = float(np.abs(got - ref).max())
    print(f"{tag} 9d ServingPool of one checkpoint_replica: swap onto the corrupted lineage "
          f"refused at preflight ({refused.split(': ', 1)[1][:60]}...), "
          f"tdl_pool_swap_rejected_total 1, the old replica kept serving; the swap onto the "
          f"healthy lineage rolled in {swap_s:.3f} s; {n} requests from {CKPT_SERVE_CLIENTS} "
          f"clients all 200, latency {_latency_line(lat)}; {batches} batches, {launched} flash "
          f"forward launches; worst |answer - float32 output of the resumed network at the "
          f"served batch shape| {worst:.2e} (must be 0) [{card}]", flush=True)
    check(np.array_equal(got, ref), f"9d: an answer differs from the resumed network's "
                                    f"float32 output by up to {worst:.2e}")
    del net, pi
    _free_card()


# ----------------------------------------------------------------- phase 10

# Phase 10: phase 6c's attention MLN exported and reloaded, and trained
# data-parallel: one NCCL rank, two gloo ranks sharing the card, the
# in-process parameter-averaging master
DP_STEPS, DP_TIMED, DP_DROPOUT, DP_MASTER_BATCHES = 6, 20, 0.9, 8
DP_BN_B, DP_BN_SHAPE, DP_BN_STEPS = 16, (3, 16, 16), 4
DP_BN_REL = 1e-5             # BN running statistics, relative to their norm
DP_TIMEOUT = 300.0
EXPORT_TIMED = 20


def _dp_batches(kind, steps, seed=10):
    """Global batches of phase 10's fits: phase 6c's shape and ragged
    features mask ("attention"), or images for the BN network ("bn")."""
    from deeplearning4j_tpu_torch.data import DataSet

    rs = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        if kind == "bn":
            x = rs.randn(DP_BN_B, *DP_BN_SHAPE).astype(np.float32)
            out.append(DataSet(x, np.eye(10, dtype=np.float32)[rs.randint(0, 10, DP_BN_B)]))
            continue
        lengths = np.concatenate([[ATTN_T], rs.randint(16, ATTN_T + 1, ATTN_B - 1)])
        fm = (np.arange(ATTN_T)[None] < lengths[:, None]).astype(np.float32)
        out.append(DataSet(rs.randn(ATTN_B, ATTN_C, ATTN_T).astype(np.float32),
                           np.eye(10, dtype=np.float32)[rs.randint(0, 10, ATTN_B)],
                           features_mask=fm))
    return out


def _dp_net(kind, device, dropout=0.0):
    """Phase 10's networks, float32: 6c's attention MLN with Sgd(0.1) (and
    dropout, a retain probability, on every layer's input where given), or
    Conv(8, 3x3, no bias: BN's mean takes it out) -> BatchNormalization ->
    Dense(32) -> Output(10)."""
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import conf as C
    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    if kind == "attention":
        return MultiLayerNetwork(_attention_conf(Sgd(0.1), dropout=dropout),
                                 device=device).init()
    conf = (C.NeuralNetConfiguration.Builder().seed(31).updater(Sgd(0.1)).list()
            .layer(C.ConvolutionLayer(n_out=8, kernel_size=(3, 3), has_bias=False))
            .layer(C.BatchNormalization(activation="relu"))
            .layer(C.DenseLayer(n_out=32, activation="relu"))
            .layer(C.OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(C.InputType.convolutional(*DP_BN_SHAPE[1:], DP_BN_SHAPE[0]))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def _rows(ds, rank, world):
    from deeplearning4j_tpu_torch.data import DataSet

    b = ds.num_examples() // world
    cut = lambda a: None if a is None else a[rank * b:(rank + 1) * b]  # noqa: E731
    return DataSet(cut(ds.features), cut(ds.labels), cut(ds.features_mask),
                   cut(ds.labels_mask))


def dp_worker():
    """Phase 10's data-parallel rank (``chip_smoke.py:dp_worker``, started
    by ``parallel.launcher.launch``, which has initialised the process
    group): the fits of ``TDL_SMOKE_DP``'s spec through
    ``MultiProcessTrainer``, each rank feeding its rows of every global
    batch, float32; the kernels' launches of every step, and the state
    (``serde.net_state.snapshot``) at the end. With ``timed``, the trainer's
    step against a plain ``fit`` of the same batch, in turns."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch import set_fp32_numerics
    from deeplearning4j_tpu_torch.parallel.launcher import local_device
    from deeplearning4j_tpu_torch.parallel.trainer import MultiProcessTrainer

    spec = json.loads(os.environ["TDL_SMOKE_DP"])
    set_fp32_numerics()
    rank, world = dist.get_rank(), dist.get_world_size()
    device = local_device()
    result = {"backend": dist.get_backend(), "world": world, "device": str(device), "fits": {}}
    with float32_policy():
        for fit in spec["fits"]:
            net = _dp_net(fit["kind"], device, fit["dropout"])
            trainer = MultiProcessTrainer(net)
            scores, launches = [], []
            for ds in _dp_batches(fit["kind"], fit["steps"]):
                _zero_counts()
                trainer.fit([_rows(ds, rank, world)])
                scores.append(net.score_)
                launches.append(_read_counts())
            np.savez(os.path.join(spec["dir"], f"{fit['name']}.rank{rank}.npz"), **_state(net))
            result["fits"][fit["name"]] = {"scores": scores, "launches": launches}
        if spec.get("timed"):
            ds = _rows(_dp_batches("attention", 1)[0], rank, world)
            trainer = MultiProcessTrainer(_dp_net("attention", device))
            plain = _dp_net("attention", device)
            times = {"trainer": [], "plain": []}
            for i in range(spec["timed"] + 2):
                for name, step in (("trainer", lambda: trainer.fit([ds])),
                                   ("plain", lambda: plain.fit(ds))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    if i >= 2:  # two warm-up rounds
                        times[name].append((time.perf_counter() - t0) * 1e3)
            result["times"] = times
    with open(os.path.join(spec["dir"], f"result.rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _launch_dp(tag, workdir, name, n, backend, fits, timed=0):
    """Run ``dp_worker`` on ``n`` ranks of ``backend``; returns each rank's
    result."""
    from deeplearning4j_tpu_torch.parallel import launcher

    d = os.path.join(workdir, name)
    os.makedirs(d, exist_ok=True)
    spec = {"dir": d, "fits": fits, "timed": timed}
    t0 = time.perf_counter()
    results = launcher.launch(f"{os.path.abspath(__file__)}:dp_worker", n_processes=n,
                              platform="cuda", backend=backend, timeout=DP_TIMEOUT,
                              extra_env={"TDL_SMOKE_DP": json.dumps(spec)})
    for r in results:
        if r.returncode != 0:
            print(f"--- {name} rank {r.rank} stderr\n{r.stderr[-3000:]}", flush=True)
    check(all(r.returncode == 0 for r in results),
          f"10: {name} ranks ended with {[r.returncode for r in results]}")
    print(f"{tag} 10 {name}: {n} rank(s) over {backend} ran in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = []
    for rank in range(n):
        with open(os.path.join(d, f"result.rank{rank}.json")) as f:
            res = json.load(f)
        res["states"] = {fit["name"]: dict(np.load(os.path.join(d, f"{fit['name']}.rank{rank}.npz")))
                         for fit in fits}
        out.append(res)
    return out


def _in_process_fit(kind, steps, dropout=0.0, device="cuda"):
    """The one-process float32 fit on the global batches: (scores, state)."""
    with float32_policy():
        net = _dp_net(kind, device, dropout)
        scores = []
        for ds in _dp_batches(kind, steps):
            net.fit(ds)
            scores.append(net.score_)
    return net, scores


def _check_dp_counts(what, per_step):
    want = {name: 1 for name in _counters()}
    for i, counts in enumerate(per_step):
        check(counts == want, f"{what}: step {i} launched {counts}, expected {want}")


def phase_export(tag, launches, workdir):
    """10a: phase 6c's attention MLN exported at [16, 256, 128] in float32
    and bf16 (``MultiLayerNetwork.export``), the program's graph holding
    ``tdl.flash_fwd``; a child process that imports only torch, numpy and
    ``serde.compiled`` reloads each artifact and answers equal to eager
    ``output()`` (float32 bit for bit, bf16 within one bf16 ulp) with one
    flash forward per call at eager's q-tile; then the reloaded call timed
    against eager ``output()`` in turns."""
    import torch

    from deeplearning4j_tpu_torch.kernels import attention as A
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.serde.compiled import load_compiled

    x = _dp_batches("attention", 1, seed=12)[0].features
    arts = {}
    for dtype in ("float32", "bfloat16"):
        conf = _attention_conf(Sgd(0.1))
        conf.dtype = dtype
        from deeplearning4j_tpu_torch.nn import MultiLayerNetwork

        net = MultiLayerNetwork(conf, device="cuda").init()
        before = Counter(A.flash_forward.launches_by_q_rows)
        want = net.output(x)
        torch.cuda.synchronize()
        eager_tiles = A.flash_forward.launches_by_q_rows - before
        path = os.path.join(workdir, f"attention_{dtype}.zip")
        n0 = A.flash_forward.launches
        secs = net.export(path, x)
        check(A.flash_forward.launches == n0, f"10a {dtype}: tracing the export launched "
                                              f"{A.flash_forward.launches - n0} kernels")
        t0 = time.perf_counter()
        model = load_compiled(path)
        secs["load"] = time.perf_counter() - t0
        calls = [n.target for n in model._program.graph.nodes if n.op == "call_function"]
        n_flash = sum(str(c).startswith("tdl.flash_fwd") for c in calls)
        check(n_flash == 1, f"10a {dtype}: the exported graph holds {n_flash} tdl.flash_fwd nodes")
        np.save(os.path.join(workdir, f"want_{dtype}.npy"),
                want.float().cpu().numpy() if dtype == "float32"
                else want.view(torch.int16).cpu().numpy())
        times = {"reloaded": [], "eager": []}
        for i in range(EXPORT_TIMED + 2):
            for name, fn in (("reloaded", lambda: model(x)), ("eager", lambda: net.output(x))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i >= 2:
                    times[name].append((time.perf_counter() - t0) * 1e3)
        arts[dtype] = (path, eager_tiles, secs, times, model.metadata)
        del model, net
    np.save(os.path.join(workdir, "x.npy"), x)
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = False\n"
        "from deeplearning4j_tpu_torch.serde.compiled import load_compiled\n"
        "from deeplearning4j_tpu_torch.kernels import attention as A\n"
        f"workdir = {workdir!r}\n"
        "x = np.load(workdir + '/x.npy')\n"
        "out = {}\n"
        "for dtype in ('float32', 'bfloat16'):\n"
        "    m = load_compiled(f'{workdir}/attention_{dtype}.zip')\n"
        "    n0 = A.flash_forward.launches\n"
        "    tiles0 = dict(A.flash_forward.launches_by_q_rows)\n"
        "    got = m(x)\n"
        "    torch.cuda.synchronize()\n"
        "    tiles = {f'{k[0]}:{k[1]}': v - tiles0.get(k, 0)\n"
        "             for k, v in A.flash_forward.launches_by_q_rows.items() if v != tiles0.get(k, 0)}\n"
        "    if dtype == 'float32':\n"
        "        np.save(f'{workdir}/got_{dtype}.npy', got.cpu().numpy())\n"
        "    else:\n"
        "        np.save(f'{workdir}/got_{dtype}.npy', got.view(torch.int16).cpu().numpy())\n"
        "    out[dtype] = {'launches': A.flash_forward.launches - n0, 'tiles': tiles,\n"
        "                  'dtype': str(got.dtype)}\n"
        "out['modules'] = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib',\n"
        "    'deeplearning4j_tpu') or k.startswith(('deeplearning4j_tpu_torch.nn',\n"
        "    'deeplearning4j_tpu_torch.models')))\n"
        "json.dump(out, open(workdir + '/child.json', 'w'))\n")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code], cwd=workdir, env=env, capture_output=True,
                       text=True, timeout=DP_TIMEOUT)
    if p.returncode != 0:
        print(p.stderr[-3000:], flush=True)
    check(p.returncode == 0, f"10a: the reloading child ended with {p.returncode}")
    with open(os.path.join(workdir, "child.json")) as f:
        child = json.load(f)
    print(f"{tag} 10a child process (torch, numpy and serde.compiled only) reloaded both "
          f"artifacts in {time.perf_counter() - t0:.1f} s; model modules loaded: "
          f"{child['modules']}", flush=True)
    check(child["modules"] == [], f"10a: the child loaded {child['modules']}")
    for dtype, (path, eager_tiles, secs, times, meta) in arts.items():
        c = child[dtype]
        want_tiles = {f"{k[0]}:{k[1]}": v for k, v in eager_tiles.items()}
        if dtype == "float32":
            got = np.load(os.path.join(workdir, "got_float32.npy"))
            want = np.load(os.path.join(workdir, "want_float32.npy"))
            bitwise = np.array_equal(got.view(np.uint32), want.view(np.uint32))
            err = float(np.abs(got - want).max())
            check(bitwise, f"10a float32: reloaded answers differ from output() by {err:.2e}")
            launches["flash_fwd_f32"].append(c["launches"] + 1)
        else:
            gi = np.load(os.path.join(workdir, "got_bfloat16.npy"))
            wi = np.load(os.path.join(workdir, "want_bfloat16.npy"))
            as_f = lambda a: (a.astype(np.int32) << 16).view(np.float32)  # noqa: E731
            got, want = as_f(gi), as_f(wi)
            bitwise = np.array_equal(gi, wi)
            err = float(np.abs(got - want).max())
            worst = float((np.abs(got - want) / (np.abs(want) * BF16_ULP_REL + 1e-30)).max())
            check(worst <= 1.0, f"10a bf16: reloaded answers differ from output() by {worst:.2f} "
                                f"bf16 ulp")
            launches["flash_fwd"].append(c["launches"] + 1)
        check(c["launches"] == 1, f"10a {dtype}: the reloaded call launched {c['launches']} "
                                  f"flash forwards")
        check(c["tiles"] == want_tiles, f"10a {dtype}: reloaded q-tiles {c['tiles']}, eager "
                                        f"{want_tiles}")
        print(f"{tag} 10a export {dtype} [{ATTN_B},{ATTN_C},{ATTN_T}]: export "
              f"{secs['export']:.2f} s, save {secs['save']:.2f} s, load {secs['load']:.2f} s "
              f"({os.path.getsize(path)} bytes); reloaded answers vs output(): max abs error "
              f"{err:.2e}, bitwise {bitwise}; 1 flash forward per call at {c['tiles']} (eager "
              f"{want_tiles}); q-tile chosen on {meta['device_name']}, compute dtype "
              f"{meta['compute_dtype']}; median ms (n={EXPORT_TIMED}, in turns): reloaded "
              f"{statistics.median(times['reloaded']):.3f}, eager output() "
              f"{statistics.median(times['eager']):.3f}", flush=True)


def phase_one_nccl_rank(tag, launches, workdir):
    """10b: ``launcher.launch(n_processes=1, backend="nccl")`` runs a
    ``MultiProcessTrainer`` fit of 6c's MLN (float32, Sgd, 6 steps); it
    equals the same fit in this process bit for bit (scores, parameters)
    with one launch of each flash kernel per step; then the trainer's step
    against a plain ``fit``, in turns (the one-rank overhead)."""
    fits = [{"name": "attention", "kind": "attention", "dropout": 0.0, "steps": DP_STEPS}]
    (res,) = _launch_dp(tag, workdir, "nccl1", 1, "nccl", fits, timed=DP_TIMED)
    check(res["backend"] == "nccl", f"10b: the rank ran over {res['backend']}")
    ref, scores = _in_process_fit("attention", DP_STEPS)
    got = res["fits"]["attention"]
    _check_dp_counts("10b NCCL rank", got["launches"])
    for name in _counters():
        launches[f"{name}_f32"].append(sum(c[name] for c in got["launches"]))
    same_scores = [float(a) for a in got["scores"]] == [float(b) for b in scores]
    same_state = _states_equal(res["states"]["attention"], _state(ref))
    check(same_scores, f"10b: scores {got['scores']} differ from this process's {scores}")
    check(same_state, "10b: the NCCL rank's parameters differ from this process's")
    t = res["times"]
    tr, pl = statistics.median(t["trainer"]), statistics.median(t["plain"])
    print(f"{tag} 10b one NCCL rank, MultiProcessTrainer on 6c's MLN [{ATTN_B},{ATTN_C},"
          f"{ATTN_T}] float32 Sgd, {DP_STEPS} steps: scores and parameters equal to this "
          f"process's fit bit for bit; 1 launch of each flash kernel per step; step median ms "
          f"(n={DP_TIMED}, in turns): trainer {tr:.3f}, plain fit {pl:.3f}, one-rank overhead "
          f"{tr - pl:.3f} ms ({spread(t['trainer'])} vs {spread(t['plain'])})", flush=True)


def _dp_errors(state, ref, before):
    """Each parameter's update in ``state`` against ``ref``'s (a network),
    as a share of the norm of ``ref``'s update: {name: error}."""
    errs = {}
    for i, k, p in ref._param_entries():
        want = p.detach().double().cpu().numpy() - before[f"{i}.{k}"].numpy()
        got = state[f"params/{i}/{k}"].astype(np.float64) - before[f"{i}.{k}"].numpy()
        errs[f"{i}.{k}"] = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))
    return errs


def phase_two_gloo_ranks(tag, launches, workdir):
    """10c: two ranks sharing the card over gloo with CUDA tensors, each
    feeding half of every global batch of 16: 6c's MLN at dropout 0.0 and
    0.9 (the rank's rows of the global mask) against the one-process fit on
    the global batches (loss within 1e-5 relative, each update within 1e-3
    of its norm), one launch of each flash kernel per step per rank; then
    Conv -> BN -> Dense -> Output, whose running mean and variance equal the
    one-process fit's within 1e-5 relative."""
    fits = [{"name": "dropout0", "kind": "attention", "dropout": 0.0, "steps": DP_STEPS},
            {"name": "dropout", "kind": "attention", "dropout": DP_DROPOUT, "steps": DP_STEPS},
            {"name": "bn", "kind": "bn", "dropout": 0.0, "steps": DP_BN_STEPS}]
    ranks = _launch_dp(tag, workdir, "gloo2", 2, "gloo", fits)
    check(all(r["backend"] == "gloo" and r["device"].startswith("cuda") for r in ranks),
          f"10c: ranks on {[(r['backend'], r['device']) for r in ranks]}")
    for fit in fits:
        name = fit["name"]
        check(_states_equal(ranks[0]["states"][name], ranks[1]["states"][name]),
              f"10c {name}: the two replicas differ")
        with float32_policy():
            before = _snapshot(_dp_net(fit["kind"], "cuda", fit["dropout"]))
        ref, scores = _in_process_fit(fit["kind"], fit["steps"], fit["dropout"])
        got = ranks[0]["fits"][name]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got["scores"], scores))
        errs = _dp_errors(ranks[0]["states"][name], ref, before)
        worst = max(errs, key=errs.get)
        line = (f"{tag} 10c two gloo ranks on one card, {name} ({fit['kind']}, dropout "
                f"{fit['dropout']}, {fit['steps']} steps, each rank half of every global "
                f"batch) vs the one-process fit: worst loss error {rel:.2e}, largest update "
                f"error {errs[worst]:.2e} ({worst})")
        check(rel <= TRAIN_LOSS_REL, f"10c {name}: loss differs by {rel:.2e}")
        check(errs[worst] <= TRAIN_GRAD_REL, f"10c {name}: update of {worst} differs by "
                                             f"{errs[worst]:.2e}")
        if fit["kind"] == "attention":
            for r in ranks:
                _check_dp_counts(f"10c {name} rank", r["fits"][name]["launches"])
                for kname in _counters():
                    launches[f"{kname}_f32"].append(
                        sum(c[kname] for c in r["fits"][name]["launches"]))
            line += "; 1 launch of each flash kernel per step per rank"
        else:
            bn_errs = {}
            for k, st in ref.bn_state.items():
                for stat in ("mean", "var"):
                    want = getattr(st, stat).double().cpu().numpy()
                    got_s = ranks[0]["states"][name][f"bn/{k}/{stat}"].astype(np.float64)
                    bn_errs[f"{k}.{stat}"] = float(np.linalg.norm(got_s - want)
                                                   / np.linalg.norm(want))
            bn_worst = max(bn_errs, key=bn_errs.get)
            check(bn_errs[bn_worst] <= DP_BN_REL, f"10c bn: running {bn_worst} differs by "
                                                  f"{bn_errs[bn_worst]:.2e}")
            line += (f"; BN running statistics vs the one-process fit: largest error "
                     f"{bn_errs[bn_worst]:.2e} ({bn_worst})")
        print(line, flush=True)


def phase_master(tag, launches):
    """10d: ``ParameterAveragingTrainingMaster(workers=2,
    averaging_frequency=2)`` on 6c's MLN on the card, 8 batches, against the
    same master on the CPU in this process (float32; the MLN limits)."""
    from deeplearning4j_tpu_torch.data import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParameterAveragingTrainingMaster

    data = _dp_batches("attention", DP_MASTER_BATCHES, seed=14)
    with float32_policy():
        card, cpu = _dp_net("attention", "cuda"), _dp_net("attention", "cpu")
        before, cpu_before = _snapshot(card), _snapshot(cpu)
        _zero_counts()
        t0 = time.perf_counter()
        ParameterAveragingTrainingMaster(workers=2, averaging_frequency=2).fit(
            card, ListDataSetIterator(data))
        card_s = time.perf_counter() - t0
        counts = _read_counts()
        ParameterAveragingTrainingMaster(workers=2, averaging_frequency=2).fit(
            cpu, ListDataSetIterator(data))
    rel = abs(card.score_ - cpu.score_) / abs(cpu.score_)
    errs = _update_errors(card, cpu, before, cpu_before)
    worst = max(errs, key=errs.get)
    want = {name: DP_MASTER_BATCHES for name in _counters()}
    check(counts == want, f"10d: launches {counts}, expected {want}")
    for name, n in counts.items():
        launches[f"{name}_f32"].append(n)
    print(f"{tag} 10d ParameterAveragingTrainingMaster(workers=2, averaging_frequency=2), 6c's "
          f"MLN float32 Sgd, {DP_MASTER_BATCHES} batches, card vs CPU: score {card.score_:.7f} "
          f"vs {cpu.score_:.7f} (rel {rel:.2e}), largest update error {errs[worst]:.2e} "
          f"({worst}); card {card_s:.2f} s; launches {counts}", flush=True)
    check(rel <= MLN_LOSS_REL, f"10d: score differs from the CPU's by {rel:.2e}")
    check(errs[worst] <= MLN_UPDATE_REL, f"10d: update of {worst} differs by {errs[worst]:.2e}")



# ------------------------------------------------------------- phase 11

SP_B, SP_T, SP_P = 16, 128, 19
SP_WARMUP, SP_TIMED = 5, 10
SP_TIMEOUT = 600.0
SHARD_SAVE_AFTER = 3  # 11c: steps before the checkpoint


def _sp_model_tree():
    """Phase 5's BERT-base weights (seed 3, drawn on the CPU) as the JAX
    ``init_params`` tree, and its config at max_len 128, dropout 0."""
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.models.weights import params_to_numpy

    cfg = tfm.TransformerConfig.bert_base(max_len=SP_T, dropout=0.0)
    return cfg, params_to_numpy(tfm.init_params(3, cfg, device="cpu"))


def _grad_errors(got, ref):
    """{name: |got - ref| / |ref|} of whole gradients (JAX-shaped trees of
    numpy arrays against {name: tensor})."""
    errs = {}
    for name, r in ref.items():
        parts = name.split(".")
        node = got["blocks"][int(parts[1])] if parts[0] == "blocks" else got[parts[0]]
        g = torch_from(node[parts[-1]], r.device)
        errs[name] = ((g - r).norm() / r.norm().clamp(min=1e-30)).item() if r.norm() > 0 \
            else g.norm().item()
    return errs


def torch_from(a, device):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def sp_worker():
    """Phase 11a/11b's rank (``chip_smoke.py:sp_worker``, started by
    ``parallel.launcher.launch`` over gloo, each rank on the card): the
    flagship placed on (dp, tp, sp) meshes; rank 0 also runs the
    one-process float32 step it is held to. Writes ``result.rank<r>.json``
    into ``TDL_SMOKE_SP``'s directory."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch import set_fp32_numerics
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.models.weights import _flatten, params_from_jax
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.parallel.launcher import local_device
    from deeplearning4j_tpu_torch.parallel.mesh import mesh_from_shape

    spec = json.loads(os.environ["TDL_SMOKE_SP"])
    set_fp32_numerics()
    rank = dist.get_rank()
    device = local_device()
    cfg, tree = _sp_model_tree()
    batch = _mlm_batch(cfg, np.random.RandomState(5), SP_B, SP_T, SP_P)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    result = {"backend": dist.get_backend(), "device": str(device)}
    ref = None
    if rank == 0:  # the one-process float32 step on the card, through the kernels
        whole = params_from_jax(tree, cfg32, device=device)
        ref_loss, ref_grads = tfm.loss_and_grads(whole, batch, cfg32)
        ref = (ref_loss.item(), ref_grads)
        del whole

    def f32_step(name, shape, impl):
        c = dataclasses.replace(cfg32, attn_impl=impl, sequence_axis="sp")
        mesh = mesh_from_shape(dict(zip(("dp", "tp", "sp"), shape)))
        model = tfm.place_params(tree, c, mesh, device=device)
        _zero_counts()
        loss, grads = tfm.loss_and_grads(model, batch, c)
        out = {"loss": loss.item(), "launches": _read_counts()}
        got = tfm.gather_params(model, grads)
        if ref is not None:
            errs = _grad_errors(got, ref[1])
            worst = max(errs, key=errs.get)
            out.update(ref_loss=ref[0], worst=worst, worst_err=errs[worst], n=len(errs))
        result[name] = out
        del model, grads, got

    f32_step("f32", (1, 2, 2), "ulysses")
    # 11a (ii): bf16 compute, Adam, the timed steps
    c16 = dataclasses.replace(cfg, attn_impl="ulysses", sequence_axis="sp")
    mesh = mesh_from_shape({"dp": 1, "tp": 2, "sp": 2})
    model = tfm.place_params(tree, c16, mesh, device=device)
    upd = Adam(1e-4)
    state = upd.init(model)
    step = tfm.make_train_step(c16, upd)
    times, losses, launches, moved = [], [], [], []
    for it in range(SP_WARMUP + SP_TIMED):
        _zero_counts()
        before = sum(collectives.traffic.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, loss = step(model, state, batch, it)
        losses.append(loss.item())
        torch.cuda.synchronize()
        if it >= SP_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
        launches.append(_read_counts())
        moved.append(sum(collectives.traffic.values()) - before)
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    held += sum(t.numel() * t.element_size() for slot in state.values() for t in slot.values())
    # parameters, Adam's m and v: a leaf split over tp is 1/tp of it, the
    # rest whole (sp replicates parameters)
    specs, tp = tfm._flat_specs(c16), mesh.axis_size("tp")
    flat = dict(_flatten(tree))
    expect = 3 * sum(a.nbytes // (tp if "tp" in specs[n] else 1) for n, a in flat.items())
    whole = 3 * sum(a.nbytes for a in flat.values())
    result["bf16"] = {"times": times, "losses": losses, "launches": launches,
                      "moved": moved, "held": held, "expect": expect, "whole": whole}
    del model, state
    # 11b: ring attention at (2, 1, 2), float32
    f32_step("ring", (2, 1, 2), "ring")
    result["staged"] = dict(collectives.staged_counts)
    with open(os.path.join(spec["dir"], f"result.rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _launch_gang(tag, workdir, name, target, n, env_key, spec, phase="11"):
    """Run ``chip_smoke.py:<target>`` on ``n`` gloo ranks sharing the card;
    returns each rank's ``result.rank<r>.json``."""
    from deeplearning4j_tpu_torch.parallel import launcher

    d = os.path.join(workdir, name)
    os.makedirs(d, exist_ok=True)
    spec = {"dir": d, **spec}
    t0 = time.perf_counter()
    results = launcher.launch(f"{os.path.abspath(__file__)}:{target}", n_processes=n,
                              platform="cuda", backend="gloo", timeout=SP_TIMEOUT,
                              extra_env={env_key: json.dumps(spec)})
    for r in results:
        if r.returncode != 0:
            print(f"--- {name} rank {r.rank} stderr\n{r.stderr[-3000:]}", flush=True)
    check(all(r.returncode == 0 for r in results),
          f"{phase}: {name} ranks ended with {[r.returncode for r in results]}")
    print(f"{tag} {phase} {name}: {n} gloo ranks on the card ran in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = []
    for rank in range(n):
        with open(os.path.join(d, f"result.rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def phase_sharded_flagship(tag, launches, workdir):
    """11a and 11b (module docstring)."""
    ranks = _launch_gang(tag, workdir, "flagship", "sp_worker", 4, "TDL_SMOKE_SP", {})
    check(all(r["backend"] == "gloo" and r["device"].startswith("cuda") for r in ranks),
          f"11a: ranks on {[(r['backend'], r['device']) for r in ranks]}")
    for name, what, impl in (("f32", "11a (dp, tp, sp) = (1, 2, 2) Ulysses", "ulysses"),
                             ("ring", "11b (dp, tp, sp) = (2, 1, 2) ring", "ring")):
        r0 = ranks[0][name]
        losses = [r[name]["loss"] for r in ranks]
        rel = max(abs(x - r0["ref_loss"]) / abs(r0["ref_loss"]) for x in losses)
        print(f"{tag} {what}, float32 step vs the one-process float32 step: loss "
              f"{r0['loss']:.7f} vs {r0['ref_loss']:.7f} (worst rank rel {rel:.2e}); largest "
              f"gathered gradient error {r0['worst_err']:.2e} of its norm ({r0['worst']}, "
              f"{r0['n']} tensors); launches per rank {[r[name]['launches'] for r in ranks]}",
              flush=True)
        check(rel <= TRAIN_LOSS_REL, f"{what}: loss differs by {rel:.2e}")
        check(r0["worst_err"] <= TRAIN_GRAD_REL,
              f"{what}: gradient {r0['worst']} differs by {r0['worst_err']:.2e}")
        for r in ranks:
            counts = r[name]["launches"]
            if impl == "ulysses":
                check(counts == {k: 12 for k in counts},
                      f"{what}: a rank launched {counts}, expected 12 of each per step")
                for k, v in counts.items():
                    launches[f"{k}_f32"].append(v)
            else:
                check(not any(counts.values()), f"{what}: ring attention launched {counts}")
    b = ranks[0]["bf16"]
    for r in ranks:
        for i, counts in enumerate(r["bf16"]["launches"]):
            check(counts == {k: 12 for k in counts},
                  f"11a bf16 step {i}: a rank launched {counts}, expected 12 of each")
        for k in r["bf16"]["launches"][0]:
            launches[k].append(sum(c[k] for c in r["bf16"]["launches"]))
        check(all(math.isfinite(x) for x in r["bf16"]["losses"]), "11a: non-finite bf16 loss")
        check(r["bf16"]["held"] == r["bf16"]["expect"],
              f"11a: a rank holds {r['bf16']['held']} B, the specs give {r['bf16']['expect']}")
    check(b["losses"][-1] < b["losses"][0], f"11a: bf16 loss did not fall: {b['losses']}")
    ms = statistics.median(b["times"])
    moved = statistics.median(b["moved"][SP_WARMUP:])
    print(f"{tag} 11a bf16 steps (4 ranks sharing the card over gloo), B={SP_B} T={SP_T} "
          f"P={SP_P} Adam: loss {b['losses'][0]:.4f} -> {b['losses'][-1]:.4f}; rank 0 step "
          f"{spread(b['times'])}, {SP_B * SP_T / ms * 1e3:.0f} tokens/s at the median; 12 "
          f"launches of each flash kernel per rank per step", flush=True)
    print(f"{tag} 11a resident parameters + Adam state per rank: "
          f"{[r['bf16']['held'] for r in ranks]} B (spec-derived {b['expect']} B) against "
          f"{b['whole']} B in one process ({b['held'] / b['whole']:.3f}); collectives moved "
          f"{moved / 1e6:.1f} MB per step per rank (median); staged through the host: "
          f"{ranks[0]['staged'] or 'none'}", flush=True)
    return ms


def shard_mln_worker():
    """Phase 11c's rank (``chip_smoke.py:shard_mln_worker``): ``train``
    (4 ranks: 6 float32 steps under (1, 2, 2), the checkpoint after step 3)
    or ``resume`` (2 ranks: the restore under (1, 2, 1), refused without
    reshard=True, then steps 4-6)."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch import set_fp32_numerics
    from deeplearning4j_tpu_torch.monitoring.partition import elastic_metrics
    from deeplearning4j_tpu_torch.parallel.launcher import local_device
    from deeplearning4j_tpu_torch.parallel.partition import Partitioner, SpecLayout
    from deeplearning4j_tpu_torch.parallel.trainer import MultiProcessTrainer
    from deeplearning4j_tpu_torch.serde.checkpoint import TrainingCheckpointer, verify_checkpoint

    spec = json.loads(os.environ["TDL_SMOKE_SHARD"])
    set_fp32_numerics()
    rank = dist.get_rank()
    device = local_device()
    ckdir = os.path.join(spec["dir"], "..", "ckpt")
    batches = _dp_batches("attention", DP_STEPS)
    result = {"scores": [], "launches": []}
    with float32_policy():
        net = _dp_net("attention", device)
        if spec["phase"] == "train":
            part = Partitioner(SpecLayout(1, 2, 2))
            first = 0
        else:
            part = Partitioner(SpecLayout(1, 2, 1))
            ck = TrainingCheckpointer(ckdir, partitioner=part)
            try:
                ck.restore(net)
                result["refused"] = None
            except ValueError as e:
                result["refused"] = str(e)
            t0 = time.perf_counter()
            ck.restore(net, reshard=True)
            result["restore_ms"] = (time.perf_counter() - t0) * 1e3
            m = elastic_metrics()
            result["reshard_bytes"] = m.reshard_bytes.value
            result["reshard_seconds"] = m.reshard_seconds.snapshot()["series"][0]["sum"]
            np.savez(os.path.join(spec["dir"], f"restored.rank{rank}.npz"),
                     **net._partition.gather_state(net))
            first = SHARD_SAVE_AFTER
        trainer = MultiProcessTrainer(net, mesh_layout=part)
        for i in range(first, DP_STEPS):
            _zero_counts()
            trainer.fit([batches[i]])
            result["scores"].append(net.score_)
            result["launches"].append(_read_counts())
            if spec["phase"] == "train" and i + 1 == SHARD_SAVE_AFTER:
                ck = trainer.checkpointer(ckdir, async_write=False)
                t0 = time.perf_counter()
                ck.save(net)
                result["save_ms"] = (time.perf_counter() - t0) * 1e3
                np.savez(os.path.join(spec["dir"], f"saved.rank{rank}.npz"),
                         **net._partition.gather_state(net))
                if rank == 0:
                    t0 = time.perf_counter()
                    v = verify_checkpoint(ckdir)
                    result["verify_ms"] = (time.perf_counter() - t0) * 1e3
                    result["verify_ok"] = v["ok"]
        np.savez(os.path.join(spec["dir"], f"final.rank{rank}.npz"),
                 **net._partition.gather_state(net))
    with open(os.path.join(spec["dir"], f"result.rank{rank}.json"), "w") as f:
        json.dump(result, f)


def phase_sharded_mln(tag, launches, workdir):
    """11c (module docstring)."""
    train = _launch_gang(tag, workdir, "shard_train", "shard_mln_worker", 4, "TDL_SMOKE_SHARD",
                         {"phase": "train"})
    resume = _launch_gang(tag, workdir, "shard_resume", "shard_mln_worker", 2,
                          "TDL_SMOKE_SHARD", {"phase": "resume"})
    load = lambda name, what, r: dict(np.load(os.path.join(workdir, name, f"{what}.rank{r}.npz")))  # noqa: E731
    with float32_policy():
        before = _snapshot(_dp_net("attention", "cuda"))
    ref, scores = _in_process_fit("attention", DP_STEPS)
    for r, res in enumerate(train):
        check(res["launches"] == [{k: 1 for k in _counters()}] * DP_STEPS,
              f"11c: rank {r} launched {res['launches']}, expected one of each per step")
        for k in _counters():
            launches[f"{k}_f32"].append(DP_STEPS)
    for r in range(2):
        check(resume[r]["launches"] == [{k: 1 for k in _counters()}] * (DP_STEPS - SHARD_SAVE_AFTER),
              f"11c resume: rank {r} launched {resume[r]['launches']}")
        for k in _counters():
            launches[f"{k}_f32"].append(DP_STEPS - SHARD_SAVE_AFTER)
    final = load("shard_train", "final", 0)
    rel = max(abs(a - b) / abs(b) for a, b in zip(train[0]["scores"], scores))
    errs = _dp_errors(final, ref, before)
    worst = max(errs, key=errs.get)
    print(f"{tag} 11c attention MLN under SpecLayout(1, 2, 2), 4 ranks, {DP_STEPS} float32 "
          f"steps vs the one-process fit: worst loss error {rel:.2e}, largest update error "
          f"{errs[worst]:.2e} ({worst}); one launch of each flash kernel per step per rank",
          flush=True)
    check(rel <= TRAIN_LOSS_REL, f"11c: loss differs by {rel:.2e}")
    check(errs[worst] <= TRAIN_GRAD_REL, f"11c: update of {worst} differs by {errs[worst]:.2e}")
    saved = load("shard_train", "saved", 0)
    for r in range(2):
        check(_states_equal(load("shard_resume", "restored", r), saved),
              f"11c: rank {r}'s resharded restore differs from the saved state")
    msg = resume[0]["refused"] or ""
    check("data=1 x fsdp=2 x tp=2" in msg and "data=1 x fsdp=2 x tp=1" in msg,
          f"11c: the restore without reshard=True was not refused naming both layouts: {msg!r}")
    check(train[0].get("verify_ok"), "11c: verify_checkpoint failed on the saved lineage")
    resumed = load("shard_resume", "final", 0)
    rel2 = max(abs(a - b) / abs(b) for a, b in zip(resume[0]["scores"],
                                                 scores[SHARD_SAVE_AFTER:]))
    errs2 = _dp_errors(resumed, ref, before)
    worst2 = max(errs2, key=errs2.get)
    print(f"{tag} 11c checkpoint after step {SHARD_SAVE_AFTER}: save {train[0]['save_ms']:.1f} "
          f"ms (rank 0), verify {train[0]['verify_ms']:.1f} ms, restore onto SpecLayout(1, 2, 1) "
          f"with reshard=True {resume[0]['restore_ms']:.1f} ms, bit for bit on both ranks; "
          f"tdl_reshard_bytes_total {resume[0]['reshard_bytes']:.0f}, tdl_reshard_seconds "
          f"{resume[0]['reshard_seconds']:.4f} (rank 0); without reshard=True: refused, naming "
          f"both layouts", flush=True)
    print(f"{tag} 11c resumed on 2 ranks, steps {SHARD_SAVE_AFTER + 1}-{DP_STEPS} vs the "
          f"uninterrupted fit: worst loss error {rel2:.2e}, largest update error "
          f"{errs2[worst2]:.2e} ({worst2})", flush=True)
    check(rel2 <= TRAIN_LOSS_REL, f"11c resume: loss differs by {rel2:.2e}")
    check(errs2[worst2] <= TRAIN_GRAD_REL,
          f"11c resume: update of {worst2} differs by {errs2[worst2]:.2e}")


# ------------------------------------------------------------- phase 12

PP_M, PP_MEM_M = 4, 8      # microbatches: the steps (mb 4) and the memory steps (mb 2)
PP_WARMUP, PP_TIMED = 5, 10
PP_LR = 1e-4


def _pp_batch(cfg):
    """Phase 5's batch (B 16, T 128, its 19 MLM positions per row) in the
    pipeline's layout: labels and weights [B, T], weight 1 at the
    positions."""
    b = _mlm_batch(cfg, np.random.RandomState(5), SP_B, SP_T, SP_P)
    labels = np.zeros((SP_B, SP_T), np.int64)
    weights = np.zeros((SP_B, SP_T), np.float32)
    rows = np.arange(SP_B)[:, None]
    labels[rows, b["mlm_positions"]] = b["labels"]
    weights[rows, b["mlm_positions"]] = 1.0
    return {"tokens": b["tokens"], "labels": labels, "weights": weights}


def _pp_counts(stage_layers, M, schedule):
    """Launches of each kernel per rank per step: the fill-drain forward
    runs each of the stage's layers once per microbatch, 1F1B's backward
    loop twice more (the forward unit and the recompute); each backward
    kernel once per layer and microbatch."""
    fwd = M * stage_layers * (3 if schedule == "1f1b" else 1)
    return {"flash_fwd": fwd, "flash_bwd_dkv": M * stage_layers, "flash_bwd_dq": M * stage_layers}


def _whole_grads(grads, mesh):
    """{"blocks.qkv_w": [L, ...], "embed.tok": ...}: block gradients
    gathered over ``pipe`` from the chunks."""
    from deeplearning4j_tpu_torch.parallel.collectives import all_gather
    from deeplearning4j_tpu_torch.parallel.mesh import use_mesh

    out = {}
    with use_mesh(mesh):
        for k, g in grads.items():
            out[k] = all_gather(g.contiguous(), "pipe", axis=0) if k.startswith("blocks.") else g
    return out


def _pp_grad_errors(got, ref):
    """{name: |got - ref| / |ref|} of the one-process gradients ({"blocks.3.
    qkv_w": tensor}) against stacked pipeline gradients."""
    errs = {}
    for name, r in ref.items():
        parts = name.split(".")
        g = got[f"blocks.{parts[2]}"][int(parts[1])] if parts[0] == "blocks" else got[name]
        errs[name] = ((g - r).norm() / r.norm().clamp(min=1e-30)).item() if r.norm() > 0 \
            else g.norm().item()
    return errs


def _digests(state):
    import hashlib

    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in state.items()}


def _held_bytes(net):
    return (sum(t.numel() * t.element_size() for d in net.params_.values() for t in d.values())
            + sum(t.numel() * t.element_size() for slot in net.updater_state.values()
                  for t in slot.values()))


def pp_worker():
    """Phase 12's rank (``chip_smoke.py:pp_worker``, gloo, every rank on the
    card): ``12a`` (4 ranks, pipe=4), ``12b`` (4 ranks, data=2 x pipe=2)
    or ``12b-restore`` (2 ranks, data=1 x fsdp=2). Writes
    ``result.rank<r>.json`` into ``TDL_SMOKE_PP``'s directory."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch import set_fp32_numerics
    from deeplearning4j_tpu_torch.parallel.launcher import local_device

    spec = json.loads(os.environ["TDL_SMOKE_PP"])
    set_fp32_numerics()
    rank = dist.get_rank()
    device = local_device()
    result = {"backend": dist.get_backend(), "device": str(device)}
    run = {"12a": _pp_flagship, "12b": _pp_rebalance, "12b-restore": _pp_restore}[spec["phase"]]
    result.update(run(spec, rank, device))
    with open(os.path.join(spec["dir"], f"result.rank{rank}.json"), "w") as f:
        json.dump(result, f)
    torch.cuda.synchronize()


def _pp_flagship(spec, rank, device):
    """12a: BERT-base over 4 stages of 3 layers."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.models.weights import params_from_jax, pipeline_state_from_jax
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.parallel import pipeline as PP
    from deeplearning4j_tpu_torch.parallel.partition import PipelinePartitioner, SpecLayout

    cfg, tree = _sp_model_tree()
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    batch = _pp_batch(cfg)
    layout = SpecLayout(data=1, fsdp=1, pipe=4)
    part = PipelinePartitioner(layout)
    mesh = part.mesh
    bounds = PP.transformer_stage_boundaries(cfg, 4)
    out = {"boundaries": bounds}
    ref = None
    if rank == 0:  # the one-process float32 step on the card, through the kernels
        whole = params_from_jax(tree, cfg32, device=device)
        ref_loss, ref_grads = tfm.loss_and_grads(whole, batch, cfg32)
        ref = (ref_loss.item(), ref_grads)
        del whole
    canon = PP.canonical_pp_params(tree)
    params, _ = pipeline_state_from_jax(canon, layout, rank, 4, device=device)
    for sched in ("gpipe", "1f1b"):
        view = {top: {k: t.detach().requires_grad_() for k, t in d.items()}
                for top, d in params.items()}
        flat = PP._flat_state(view)
        loss_fn = PP.transformer_pp_loss_fn(cfg32, PP_M, mesh, schedule=sched, boundaries=bounds)
        torch.cuda.synchronize()
        _zero_counts()
        loss = loss_fn(view, batch)
        grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
        torch.cuda.synchronize()
        r = {"loss": loss.item(), "launches": _read_counts(), "run": dict(PP.last_run)}
        got = _whole_grads(PP.reduce_replicated_grads(grads, mesh, None), mesh)
        if ref is not None:
            errs = _pp_grad_errors(got, ref[1])
            worst = max(errs, key=errs.get)
            r.update(ref_loss=ref[0], worst=worst, worst_err=errs[worst], n=len(errs))
        out[sched] = r
        del view, flat, grads, got
    del params
    # bf16 compute, 1F1B, Adam: the timed steps
    from deeplearning4j_tpu_torch.parallel import collectives

    trainer = PP.PipelineParallelTrainer(tree, cfg, Adam(PP_LR), part, n_microbatches=PP_M,
                                         schedule="1f1b", device=device)
    held = _held_bytes(trainer.net)
    times, losses, launches, moved = [], [], [], []
    for it in range(PP_WARMUP + PP_TIMED):
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._fit_batch(batch)
        torch.cuda.synchronize()
        if it >= PP_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(trainer.net.score_)
        launches.append(_read_counts())
        moved.append(dict(trainer._moved))
    out["bf16"] = {"times": times, "losses": losses, "launches": launches, "moved": moved,
                   "run": dict(PP.last_run), "held": held,
                   "staged": dict(collectives.staged_counts)}
    # peak memory above resident, one bf16 step at M=8 (mb 2), in turns
    trainer.n_microbatches = PP_MEM_M
    peaks = {"gpipe": [], "1f1b": []}
    mem_launches = []
    for sched in ("gpipe", "1f1b", "gpipe", "1f1b"):
        trainer.schedule = sched
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _zero_counts()
        trainer._fit_batch(batch)
        torch.cuda.synchronize()
        mem_launches.append(_read_counts())
        peaks[sched].append(torch.cuda.max_memory_allocated() - base)
        out.setdefault("mem_runs", {})[sched] = dict(PP.last_run)
    out["peaks"] = peaks
    out["mem_launches"] = mem_launches
    out["resident"] = base
    return out


def _pp_rebalance(spec, rank, device):
    """12b: data=2 x pipe=2, float32: two 1F1B steps, the rebalance, two
    more, the checkpoint."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.models.weights import _flatten, params_from_jax
    from deeplearning4j_tpu_torch.monitoring.costmodel import balance_stages
    from deeplearning4j_tpu_torch.monitoring.registry import get_registry
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.parallel import pipeline as PP
    from deeplearning4j_tpu_torch.parallel.partition import SpecLayout
    from deeplearning4j_tpu_torch.serde.checkpoint import verify_checkpoint

    cfg, tree = _sp_model_tree()
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    batch = _pp_batch(cfg)
    out = {}
    ref = None
    if rank == 0:  # the one-process float32 fit on the same batch
        model = params_from_jax(tree, cfg32, device=device)
        upd = Adam(PP_LR)
        state = upd.init(model)
        step = tfm.make_train_step(cfg32, upd)
        ref_losses, ref_params = [], []
        for it in range(4):
            model, state, loss = step(model, state, batch, it)
            ref_losses.append(loss.item())
            if it in (1, 3):  # before the rebalance and after it
                ref_params.append({k: p.detach().clone() for k, p in model.named_parameters()})
        ref = (ref_losses, ref_params)
        del state
    trainer = PP.PipelineParallelTrainer(tree, cfg32, Adam(PP_LR), SpecLayout(data=2, pipe=2),
                                         n_microbatches=PP_M, schedule="1f1b", device=device)
    losses, launches, splits = [], [], []
    for it in range(4):
        if it == 2:
            out["measured"] = trainer.profile_stages(seq=SP_T, batch_size=4, repeats=5)
            out["predicted"] = trainer.predicted_stage_costs()
            skew = [2.0, 1.0]
            costs = list(trainer._layer_costs)
            pred = trainer.predicted_stage_costs()
            for (a, b), meas, p in zip(trainer.boundaries, skew, pred):
                for i in range(a, b):
                    costs[i] = trainer._layer_costs[i] * meas / p
            out["expected_split"] = balance_stages(costs, 2)
            out["old_split"] = trainer.boundaries
            out["new_split"] = trainer.maybe_rebalance(skew)
        splits.append(trainer.boundaries)
        _zero_counts()
        trainer._fit_batch(batch)
        torch.cuda.synchronize()
        losses.append(trainer.net.score_)
        launches.append(_read_counts())
        if it == 1:
            mid_state = trainer.gather_state()  # a collective: every rank
    out.update(losses=losses, launches=launches, splits=splits,
               fetched=PP.last_run.get("fetched_bytes", 0),
               replicated=PP.last_run.get("replicated_grad_bytes", 0),
               moved=dict(trainer._moved),
               rebalances=sum(s["value"] for s in (get_registry().snapshot().get(
                   "tdl_pipe_rebalances_total") or {}).get("series") or []))
    ckdir = os.path.join(spec["dir"], "..", "pp_ckpt")
    ck = trainer.checkpointer(ckdir, async_write=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(trainer.net)
    out["save_ms"] = (time.perf_counter() - t0) * 1e3
    state = trainer.gather_state()
    out["digests"] = _digests(state)
    if rank == 0:
        t0 = time.perf_counter()
        out["verify_ok"] = verify_checkpoint(ckdir)["ok"]
        out["verify_ms"] = (time.perf_counter() - t0) * 1e3
        before = dict(_flatten(tree))
        D = cfg.d_model
        for when, ref_params, st in (("step2", ref[1][0], mid_state), ("step4", ref[1][1], state)):
            errs, qkv = {}, {}
            for name, want in ref_params.items():
                parts = name.split(".")
                key = (f"params/blocks/{parts[2]}" if parts[0] == "blocks"
                       else f"params/{parts[0]}/{parts[1]}")
                got = st[key][int(parts[1])] if parts[0] == "blocks" else st[key]
                b = torch_from(before[name], device)
                g = torch_from(got, device) - b
                w = want - b
                norm = w.norm().clamp(min=1e-30)
                errs[name] = ((g - w).norm() / norm).item()
                if name.endswith("qkv_b"):
                    # each of the q, k and v slices' error, and its update,
                    # as shares of the whole bias's update norm
                    qkv[name] = [(((g - w)[i * D:(i + 1) * D].norm() / norm).item(),
                                  (w[i * D:(i + 1) * D].norm() / norm).item()) for i in range(3)]
            worst = max(errs, key=errs.get)
            worst_qkv = max(qkv, key=errs.get)
            out[when] = dict(worst=worst, worst_err=errs[worst], n=len(errs),
                             qkv_name=worst_qkv, qkv_err=errs[worst_qkv], qkv=qkv[worst_qkv])
        out.update(ref_losses=ref[0], **out["step4"])
    return out


def _pp_restore(spec, rank, device):
    """12b's restore: a fresh 2-rank gang under PipelinePartitioner(SpecLayout(
    data=1, fsdp=2)), refused without reshard=True, then with it."""
    import torch

    from deeplearning4j_tpu_torch.monitoring.partition import elastic_metrics
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.parallel.partition import PipelinePartitioner, SpecLayout
    from deeplearning4j_tpu_torch.parallel.pipeline import pipeline_net
    from deeplearning4j_tpu_torch.serde.checkpoint import TrainingCheckpointer

    cfg, tree = _sp_model_tree()
    net = pipeline_net(tree, Adam(PP_LR), device=device)
    ck = TrainingCheckpointer(os.path.join(spec["dir"], "..", "pp_ckpt"),
                              partitioner=PipelinePartitioner(SpecLayout(data=1, fsdp=2)))
    out = {}
    try:
        ck.restore(net)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.restore(net, reshard=True)
    torch.cuda.synchronize()
    out["restore_ms"] = (time.perf_counter() - t0) * 1e3
    m = elastic_metrics()
    out["reshard_bytes"] = m.reshard_bytes.value
    out["reshard_seconds"] = m.reshard_seconds.snapshot()["series"][0]["sum"]
    out["rows"] = int(net.params_["blocks"]["qkv_w"].shape[0])
    out["digests"] = _digests(net._partition.gather_state(net))
    out["iteration"] = net.iteration
    return out


def phase_pipeline_flagship(tag, launches, workdir):
    """12a (module docstring)."""
    ranks = _launch_gang(tag, workdir, "pp_flagship", "pp_worker", 4, "TDL_SMOKE_PP",
                         {"phase": "12a"}, phase="12a")
    check(all(r["backend"] == "gloo" and r["device"].startswith("cuda") for r in ranks),
          f"12a: ranks on {[(r['backend'], r['device']) for r in ranks]}")
    r0 = ranks[0]
    check(r0["boundaries"] == [[0, 3], [3, 6], [6, 9], [9, 12]],
          f"12a: cost-model boundaries {r0['boundaries']}")
    for sched in ("gpipe", "1f1b"):
        r = r0[sched]
        losses = [x[sched]["loss"] for x in ranks]
        rel = max(abs(x - r["ref_loss"]) / abs(r["ref_loss"]) for x in losses)
        want = _pp_counts(3, PP_M, sched)
        print(f"{tag} 12a BERT-base pipe=4 {sched} float32 step vs the one-process float32 step: "
              f"loss {r['loss']:.7f} vs {r['ref_loss']:.7f} (worst rank rel {rel:.2e}); largest "
              f"gathered gradient error {r['worst_err']:.2e} of its norm ({r['worst']}, "
              f"{r['n']} tensors); launches per rank {[x[sched]['launches'] for x in ranks]}; "
              f"ticks fwd {r['run']['forward_ticks']} bwd {r['run']['backward_ticks']}, stash "
              f"{r['run']['stash_slots']}", flush=True)
        check(rel <= TRAIN_LOSS_REL, f"12a {sched}: loss differs by {rel:.2e}")
        check(r["worst_err"] <= TRAIN_GRAD_REL,
              f"12a {sched}: gradient {r['worst']} differs by {r['worst_err']:.2e}")
        for x in ranks:
            check(x[sched]["launches"] == want,
                  f"12a {sched}: a rank launched {x[sched]['launches']}, expected {want}")
            for k, v in x[sched]["launches"].items():
                launches[f"{k}_f32"].append(v)
    check(all(x["gpipe"]["loss"] == x["1f1b"]["loss"] for x in ranks),
          "12a: GPipe and 1F1B losses differ")
    b = r0["bf16"]
    want = _pp_counts(3, PP_M, "1f1b")
    for x in ranks:
        for i, counts in enumerate(x["bf16"]["launches"]):
            check(counts == want, f"12a bf16 step {i}: a rank launched {counts}, expected {want}")
        for k in want:
            launches[k].append(sum(c[k] for c in x["bf16"]["launches"])
                               + sum(c[k] for c in x["mem_launches"]))
        check(all(math.isfinite(v) for v in x["bf16"]["losses"]), "12a: non-finite bf16 loss")
    check(b["losses"][-1] < b["losses"][0], f"12a: bf16 loss did not fall: {b['losses']}")
    cfg, tree = _sp_model_tree()
    from deeplearning4j_tpu_torch.models.weights import _flatten

    flat = dict(_flatten(tree))
    expect = 3 * sum(a.nbytes // (4 if n.startswith("blocks.") else 1) for n, a in flat.items())
    whole = 3 * sum(a.nbytes for a in flat.values())
    for x in ranks:
        check(x["bf16"]["held"] == expect,
              f"12a: a rank holds {x['bf16']['held']} B, the specs give {expect}")
    ms = statistics.median(b["times"])
    moved = b["moved"][-1]
    print(f"{tag} 12a bf16 1F1B steps (4 ranks sharing the card over gloo), B={SP_B} T={SP_T}, "
          f"M={PP_M}, Adam: loss {b['losses'][0]:.4f} -> {b['losses'][-1]:.4f}; rank 0 step "
          f"{spread(b['times'])}, {SP_B * SP_T / ms * 1e3:.0f} tokens/s at the median; "
          f"launches per rank per step {want}", flush=True)
    held = [x["bf16"]["held"] for x in ranks]
    print(f"{tag} 12a resident parameters + Adam state per rank: {held} B (spec-derived "
          f"{expect} B: a quarter of the blocks, embed and mlm whole) against "
          f"{whole} B in one process ({expect / whole:.3f}); per rank per step: ring "
          f"{b['run']['ring_bytes'] / 1e6:.2f} MB sent, broadcasts over pipe "
          f"{b['run']['broadcast_bytes'] / 1e6:.2f} MB, replicated gradients "
          f"{b['run']['replicated_grad_bytes'] / 1e6:.2f} MB (data=1); collectives by kind "
          f"{ {k: round(v / 1e6, 2) for k, v in moved.items()} } MB; staged through the host: "
          f"{b['staged'] or 'none'}", flush=True)
    for x in ranks:
        g, f = x["peaks"]["gpipe"][-1], x["peaks"]["1f1b"][-1]
        check(f < g, f"12a: 1F1B's peak {f} B is not below GPipe's {g} B at M={PP_MEM_M}")
    print(f"{tag} 12a peak max_memory_allocated above resident, one bf16 step at M={PP_MEM_M} "
          f"(mb 2), second of two turns, per rank: GPipe "
          f"{[round(x['peaks']['gpipe'][-1] / 2**20, 1) for x in ranks]} MiB, 1F1B "
          f"{[round(x['peaks']['1f1b'][-1] / 2**20, 1) for x in ranks]} MiB (stash "
          f"{r0['mem_runs']['1f1b']['stash_slots']} stage inputs)", flush=True)
    return ms


def phase_pipeline_rebalance(tag, launches, workdir):
    """12b (module docstring)."""
    ranks = _launch_gang(tag, workdir, "pp_rebalance", "pp_worker", 4, "TDL_SMOKE_PP",
                         {"phase": "12b"}, phase="12b")
    r0 = ranks[0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], r0["ref_losses"]))
    print(f"{tag} 12b BERT-base data=2 x pipe=2, float32 1F1B, 4 steps across a rebalance vs "
          f"the one-process fit: losses {[round(v, 7) for v in r0['losses']]} vs "
          f"{[round(v, 7) for v in r0['ref_losses']]} (worst rel {rel:.2e}); largest update "
          f"error {r0['worst_err']:.2e} of its norm ({r0['worst']}, {r0['n']} tensors)",
          flush=True)
    check(rel <= TRAIN_LOSS_REL, f"12b: loss differs by {rel:.2e}")
    for when in ("step2", "step4"):
        e = r0[when]
        check(e["worst_err"] <= TRAIN_GRAD_REL,
              f"12b {when}: update of {e['worst']} differs by {e['worst_err']:.2e}")
        print(f"{tag} 12b after {when[:4]} {when[4:]} ({'before' if when == 'step2' else 'after'} "
              f"the rebalance): largest update error {e['worst_err']:.2e} of its norm "
              f"({e['worst']}); largest qkv_b error {e['qkv_err']:.2e} ({e['qkv_name']}), by "
              f"slice as shares of that bias's update norm: "
              + ", ".join(f"{n} error {er:.2e} update {u:.2e}"
                          for n, (er, u) in zip("qkv", e["qkv"])), flush=True)
    m = [t / sum(r0["measured"]) for t in r0["measured"]]
    p = [c / sum(r0["predicted"]) for c in r0["predicted"]]
    print(f"{tag} 12b profile_stages (seq {SP_T}, batch 4, median of 5): measured "
          f"{[round(t * 1e3, 3) for t in r0['measured']]} ms, fractions "
          f"{[round(v, 3) for v in m]} vs predicted {[round(v, 3) for v in p]}", flush=True)
    check(r0["new_split"] == r0["expected_split"] and r0["new_split"] != r0["old_split"],
          f"12b: rebalance gave {r0['new_split']}, balance_stages gives {r0['expected_split']} "
          f"(was {r0['old_split']})")
    for rank, x in enumerate(ranks):
        check(x["splits"] == ranks[0]["splits"] and x["losses"] == r0["losses"],
              f"12b: rank {rank} disagrees")
        stage = rank // 2  # SpecLayout's mesh: pipe outermost
        for i, counts in enumerate(x["launches"]):
            a, b = x["splits"][i][stage]
            want = _pp_counts(b - a, PP_M, "1f1b")
            check(counts == want, f"12b step {i}: rank {rank} launched {counts}, expected {want}")
            for k, v in counts.items():
                launches[f"{k}_f32"].append(v)
        check(x["rebalances"] == 1, f"12b: tdl_pipe_rebalances_total {x['rebalances']}")
    fetched = [x["fetched"] for x in ranks]
    check(fetched[0] == fetched[1] == 0 and fetched[2] > 0,
          f"12b: bytes fetched per rank {fetched}")
    print(f"{tag} 12b split {r0['old_split']} -> {r0['new_split']} (balance_stages of the "
          f"corrected costs), tdl_pipe_rebalances_total 1 on every rank; bytes fetched from "
          f"another rank's chunk per step {fetched}; replicated gradients summed over data "
          f"{r0['replicated'] / 1e6:.2f} MB per rank per step; collectives by kind "
          f"{ {k: round(v / 1e6, 2) for k, v in r0['moved'].items()} } MB; launches per rank "
          f"per step {[x['launches'][-1] for x in ranks]}", flush=True)
    restore = _launch_gang(tag, workdir, "pp_restore", "pp_worker", 2, "TDL_SMOKE_PP",
                           {"phase": "12b-restore"}, phase="12b")
    for x in restore:
        check(x["digests"] == r0["digests"],
              "12b: the fsdp=2 restore differs from the saved pipe=2 state")
        check(x["rows"] == 6, f"12b: an fsdp rank holds {x['rows']} layers")
        msg = x["refused"] or ""
        check("reshard=True" in msg and "pipe=2" in msg,
              f"12b: the restore without reshard=True was not refused: {msg!r}")
    check(r0.get("verify_ok"), "12b: verify_checkpoint failed on the saved lineage")
    x = restore[0]
    print(f"{tag} 12b checkpoint after step 4: save {r0['save_ms']:.1f} ms (rank 0), verify "
          f"{r0['verify_ms']:.1f} ms, restore onto PipelinePartitioner(SpecLayout(data=1, "
          f"fsdp=2)) with reshard=True {x['restore_ms']:.1f} ms, bit for bit ({len(x['digests'])} "
          f"arrays, both ranks); tdl_reshard_bytes_total {x['reshard_bytes']:.0f}, "
          f"tdl_reshard_seconds {x['reshard_seconds']:.4f} (rank 0); without reshard=True: "
          f"refused", flush=True)


# ----------------------------------------------------------------- phase 13

# Phase 13: unattended operation on 9b's network (6c's attention MLN, Adam,
# dropout 0.9) in float32: (a) a supervised 2-rank gang trained through a
# crash and a loss spike, (b) an elastic resize 2 -> 1, (c) a deploy
# controller gating (a)'s lineage onto a pool of two checkpoint_replica
SUP_STEPS, SUP_EVERY, SUP_KEEP = 12, 3, 4
SUP_FAULTS = "crash@iter=7,rank=1;loss_spike@iter=11,scale=60,restart=1"
EL_STEPS, EL_EVERY = 8, 2
EL_FAULTS = "crash@iter=3,rank=1"
SUP_TIMEOUT = 600.0
# the eval gate: 1 / (1 + held-out cross-entropy) at least DEPLOY_FLOOR, and
# no more than DEPLOY_BAND below the promoted generation's
DEPLOY_FLOOR, DEPLOY_BAND = 0.2, 0.15
DEPLOY_SLO_MS, DEPLOY_LATENCY_S = 1000.0, 0.5
DEPLOY_TRACE = {"duration_s": 3.0, "base_rate": 8.0, "seed": 18}
DEPLOY_REPLAY = {"duration_s": 2.0, "base_rate": 12.0, "seed": 7}


def _restore_generation(net, gendir):
    """Load ONE generation of a lineage into ``net`` (``restore`` loads a
    lineage's newest): through a temporary lineage that holds a link to it,
    so the restore verifies it as usual. Returns restore's answer."""
    from deeplearning4j_tpu_torch.serde import TrainingCheckpointer

    gendir = os.path.abspath(os.path.normpath(gendir))
    name = os.path.basename(gendir)
    root = tempfile.mkdtemp(prefix="tdl_smoke_gen_")
    try:
        os.makedirs(os.path.join(root, "latest"))
        os.symlink(gendir, os.path.join(root, "latest", name))
        with open(os.path.join(root, "latest", "LATEST"), "w") as f:
            f.write(name + "\n")
        return TrainingCheckpointer(root, async_write=False).restore(net)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def sup_worker():
    """Phase 13's supervised rank (``chip_smoke.py:sup_worker``, spawned by
    ``GangSupervisor`` through ``parallel.launcher``, gloo on the card): 9b's
    float32 network fitted on ``_preempt_data``'s global batches with
    ``MultiProcessTrainer``, restoring the lineage's newest generation at
    start and committing one every ``every`` steps. ``elastic``: under
    ``largest_layout(world)`` (every rank feeds the global batch, fsdp splits
    it), restored with ``reshard=True``; ``dead_rank`` exits at boot in every
    incarnation after the first while the world is larger than
    ``survivors``. Each step appends its score and the kernels' launches to
    ``steps.rank<r>.inc<i>.jsonl``; the end writes ``result.rank<r>.json``
    and the parameters."""
    import torch.distributed as dist

    spec = json.loads(os.environ["TDL_SMOKE_SUP"])
    incarnation = int(os.environ.get("TDL_GANG_RESTART_COUNT", "0"))
    rank, world = dist.get_rank(), dist.get_world_size()
    if (spec.get("dead_rank") == rank and incarnation >= 1
            and world > spec["survivors"]):
        os._exit(43)  # the host is gone: it never comes back
    from deeplearning4j_tpu_torch import set_fp32_numerics
    from deeplearning4j_tpu_torch.monitoring.partition import elastic_metrics
    from deeplearning4j_tpu_torch.parallel.partition import Partitioner, largest_layout
    from deeplearning4j_tpu_torch.parallel.trainer import MultiProcessTrainer
    from deeplearning4j_tpu_torch.serde import TrainingCheckpointer

    t_boot = time.perf_counter()
    set_fp32_numerics()
    data = _preempt_data()
    out = os.path.join(spec["dir"], f"steps.rank{rank}.inc{incarnation}.jsonl")
    with float32_policy(), open(out, "a") as log:
        net = _preempt_net("float32")
        if spec["elastic"]:
            part = Partitioner(largest_layout(world))
            trainer = MultiProcessTrainer(net, mesh_layout=part)
            ck = trainer.checkpointer(spec["ckpt"], async_write=False, reshard=True,
                                      keep_last=SUP_KEEP)
        else:
            trainer = MultiProcessTrainer(net)
            ck = TrainingCheckpointer(spec["ckpt"], async_write=False, keep_last=SUP_KEEP)
        t0 = time.perf_counter()
        restored = ck.restore(net)
        restore_ms = (time.perf_counter() - t0) * 1e3
        start = int(net.iteration) if restored else 0
        for step in range(start, spec["steps"]):
            _zero_counts()
            ds = data[step] if spec["elastic"] else _rows(data[step], rank, world)
            trainer.fit([ds])
            log.write(json.dumps({"step": step, "score": float(net.score_),
                                  "launches": _read_counts()}) + "\n")
            log.flush()
            if (step + 1) % spec["every"] == 0:
                dist.barrier()  # every rank at this iteration before the save
                ck.save(net)
                dist.barrier()
        state = net._partition.gather_state(net) if spec["elastic"] else _state(net)
    m = elastic_metrics()
    reshard = m.reshard_seconds.snapshot()["series"]
    result = {"start": start, "iteration": int(net.iteration), "world": world,
              "incarnation": incarnation, "restore_ms": restore_ms,
              "reshard_bytes": m.reshard_bytes.value,
              "reshard_seconds": reshard[0]["sum"] if reshard else 0.0,
              "seconds": time.perf_counter() - t_boot}
    np.savez(os.path.join(spec["dir"], f"state.rank{rank}.npz"), **state)
    with open(os.path.join(spec["dir"], f"result.rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _supervisor(workdir, name, faults, ckroot, **kw):
    """A ``GangSupervisor`` of two ``sup_worker`` ranks sharing the card over
    gloo, recording the monotonic time of each spawn. The ranks load phase
    1's kernel build (``TDL_COMPILE_CACHE_DIR``; the supervisor's own cache
    would run nvcc in the first incarnation)."""
    from deeplearning4j_tpu_torch.kernels import _build
    from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import GangSupervisor

    class Timed(GangSupervisor):
        def _spawn(self, attempt):
            self.spawned_at.append(time.monotonic())
            return super()._spawn(attempt)

    d = os.path.join(workdir, name)
    os.makedirs(d, exist_ok=True)
    spec = {"dir": d, "ckpt": ckroot, **kw.pop("spec")}
    sup = Timed(f"{os.path.abspath(__file__)}:sup_worker", n_processes=2, platform="cuda",
                backend="gloo", extra_env={
                    "TDL_SMOKE_SUP": json.dumps(spec), "TDL_FAULT_SPEC": faults,
                    "TDL_COMPILE_CACHE_DIR": str(_build.build_dir().parent)},
                workdir=os.path.join(d, "gang"), heartbeat_interval=0.0,
                hang_timeout=120.0, startup_grace=300.0, backoff_base=0.1,
                kill_grace=2.0, ckpt_dir=ckroot, registry=MetricsRegistry(), **kw)
    sup.spawned_at = []
    return sup, d


def _run_gang(sup, what, out):
    """``sup.run``; ``out`` gets (results, seconds) or the error."""
    t0 = time.monotonic()
    try:
        out["results"] = sup.run(timeout=SUP_TIMEOUT)
    except Exception as e:  # reported by the caller's check
        out["error"] = f"{what}: {type(e).__name__}: {e}"
    out["end"] = time.monotonic()
    out["seconds"] = out["end"] - t0


def _gang_steps(d):
    """{rank: {step: record}} over every incarnation (a later incarnation's
    record of a step replaces an earlier one), and every record."""
    per_rank, records = {}, []
    for name in sorted(os.listdir(d)):
        if name.startswith("steps.rank") and name.endswith(".jsonl"):
            rank = int(name[len("steps.rank"):].split(".")[0])
            with open(os.path.join(d, name)) as f:
                for line in f:
                    rec = json.loads(line)
                    records.append(rec)
                    per_rank.setdefault(rank, {})[rec["step"]] = rec
    return per_rank, records


def _gang_launches(what, records, launches):
    """One launch of each flash kernel per step per rank (10c's count),
    added to the float32 kernels' counts."""
    _check_dp_counts(what, [r["launches"] for r in records])
    for kname in _counters():
        launches[f"{kname}_f32"].append(sum(r["launches"][kname] for r in records))
    return len(records)


def _reference_fit(steps):
    """The one-process float32 fit of 9b's network on the first ``steps``
    global batches: (network, scores, initial parameters)."""
    with float32_policy():
        net = _preempt_net("float32")
        before = _snapshot(net)
        scores = []
        for ds in _preempt_data()[:steps]:
            net.fit(ds)
            scores.append(net.score_)
    return net, scores, before


def _against_reference(what, state, scores, steps):
    """Loss within 1e-5 relative and each update within 1e-3 of its norm
    (10c's limits) of the one-process fit: the errors' text."""
    ref, ref_scores, before = _reference_fit(steps)
    rel = max(abs(a - b) / abs(b) for a, b in zip(scores, ref_scores))
    errs = _dp_errors(state, ref, before)
    worst = max(errs, key=errs.get)
    check(len(scores) == steps, f"{what}: {len(scores)} scores for {steps} steps")
    check(rel <= TRAIN_LOSS_REL, f"{what}: loss differs by {rel:.2e}")
    check(errs[worst] <= TRAIN_GRAD_REL, f"{what}: update of {worst} differs by "
                                         f"{errs[worst]:.2e}")
    del ref
    return f"worst loss error {rel:.2e}, largest update error {errs[worst]:.2e} ({worst})"


def _timeline_kinds(path):
    with open(path) as f:
        doc = json.load(f)
    return Counter(ev.get("name") for ev in doc["traceEvents"] if ev.get("ph") != "M")


def check_supervised_gang(tag, launches, sup, d, run):
    """13a's checks: one restart classified crash, generations at 3, 6, 9
    and 12, gen-9 within 10c's limits of the one-process fit of 9 steps,
    one launch of each kernel per step per rank, the postmortem and the
    timeline with the crash and the respawn, one recovery observed."""
    from deeplearning4j_tpu_torch.serde.checkpoint import lineage_state

    card = card_line()
    check("error" not in run, run.get("error", ""))
    check(all(r.returncode == 0 for r in run["results"]),
          f"13a: ranks ended with {[r.returncode for r in run['results']]}")
    check(sup.restarts == 1 and [(e.reason, e.iteration) for e in sup.events] == [("crash", 7)],
          f"13a: {sup.restarts} restarts after {[(e.reason, e.iteration) for e in sup.events]}")
    ckroot = sup.ckpt_dir
    lin = lineage_state(ckroot)
    iters = [g["iteration"] for g in lin["committed"]]
    check(iters == [3, 6, 9, 12], f"13a: committed generations at {iters}")
    gens = {g["iteration"]: os.path.join(lin["dir"], g["generation"]) for g in lin["committed"]}
    per_rank, records = _gang_steps(d)
    check(sorted(per_rank) == [0, 1] and all(sorted(s) == list(range(SUP_STEPS))
                                             for s in per_rank.values()),
          f"13a: steps recorded {({r: sorted(s) for r, s in per_rank.items()})}")
    n = _gang_launches("13a", records, launches)
    with float32_policy():
        net9 = _preempt_net("float32")
        check(_restore_generation(net9, gens[9]), "13a: gen-9 did not restore")
    errors = _against_reference("13a gen-9", _state(net9), [per_rank[0][s]["score"]
                                                            for s in range(9)], 9)
    del net9
    with open(sup.postmortem_path) as f:
        pm = json.load(f)
    kinds = Counter(e.get("kind") for e in pm["events"])
    check(pm["classification"] == "crash" and pm["iteration"] == 7 and kinds["gang_failure"],
          f"13a: postmortem {pm['classification']} at {pm['iteration']}, {dict(kinds)}")
    timeline = sup._write_timeline_artifact()  # every incarnation, now the respawn too
    tk = _timeline_kinds(timeline)
    # the crashed incarnation and its respawn each ran step 6 on both lanes
    check(tk["gang_failure"] and tk["restart_decision"] and tk["step 6"] >= 4,
          f"13a: the timeline holds {dict(tk)}")
    rec = sup.registry.get("tdl_gang_recovery_seconds").snapshot()["series"][0]
    check(rec["count"] == 1, f"13a: tdl_gang_recovery_seconds observed {rec['count']} times")
    walls = [sup.events[0].time - sup.spawned_at[0], run["end"] - sup.spawned_at[1]]
    res = [json.load(open(os.path.join(d, f"result.rank{r}.json"))) for r in range(2)]
    print(f"{tag} 13a GangSupervisor, 2 gloo ranks on the card, 9b's network float32, "
          f"global batch 16 (8 rows per rank), {SUP_STEPS} steps, {SUP_FAULTS!r}: 1 restart "
          f"(crash at iteration 7, ranks {list(sup.events[0].ranks)}), the respawn restored "
          f"iteration {res[0]['start']}; generations at {iters}; gen-9 vs the one-process fit "
          f"of 9 steps: {errors}; {n} rank-steps, 1 launch of each flash kernel per step per "
          f"rank; failure detection to gang respawned {rec['sum']:.3f} s; incarnation walls "
          f"{walls[0]:.1f} s and {walls[1]:.1f} s (spawn to the crash's detection, spawn to "
          f"the end); postmortem {pm['classification']} with {len(pm['events'])} events, "
          f"timeline {sum(tk.values())} events [{card}]", flush=True)
    return gens


def check_elastic_gang(tag, launches, sup, d, run):
    """13b's checks: one resize down 2 -> 1 (metric, postmortem), the
    survivor restored the fsdp=2 generation at iteration 2 with
    ``reshard=True`` and finished 8 steps within 10c's limits of the
    one-process fit, one launch of each kernel per step per rank."""
    card = card_line()
    check("error" not in run, run.get("error", ""))
    check(len(run["results"]) == 1 and run["results"][0].returncode == 0,
          f"13b: final gang {[(r.rank, r.returncode) for r in run['results']]}")
    rz = sup.resizes
    check(sup.n_processes == 1 and len(rz) == 1 and rz[0]["from_processes"] == 2
          and rz[0]["to_processes"] == 1 and rz[0]["suspect_ranks"] == [1],
          f"13b: resizes {rz}")
    snap = sup.registry.get("tdl_gang_resizes_total").snapshot()["series"]
    check([(s["labels"], s["value"]) for s in snap] == [({"direction": "down"}, 1.0)],
          f"13b: tdl_gang_resizes_total {snap}")
    with open(sup.postmortem_path) as f:
        pm = json.load(f)
    check(pm["classification"] == "elastic_resize" and pm["resizes"] == rz,
          f"13b: postmortem {pm['classification']}, resizes {pm['resizes']}")
    res = json.load(open(os.path.join(d, "result.rank0.json")))
    check(res["world"] == 1 and res["start"] == 2 and res["iteration"] == EL_STEPS,
          f"13b: the survivor ran {res}")
    check(res["reshard_bytes"] > 0, f"13b: the survivor's restore resharded nothing: {res}")
    per_rank, records = _gang_steps(d)
    n = _gang_launches("13b", records, launches)
    state = dict(np.load(os.path.join(d, "state.rank0.npz")))
    errors = _against_reference("13b", state, [per_rank[0][s]["score"]
                                               for s in range(EL_STEPS)], EL_STEPS)
    print(f"{tag} 13b elastic GangSupervisor (max_restarts 1, min_processes 1), 2 gloo ranks "
          f"under {rz[0]['survivor_layout']['axes']} after fsdp=2, {EL_FAULTS!r} then rank 1 "
          f"dead at boot: {len(sup.events)} failures "
          f"{[(e.reason, list(e.ranks), e.iteration) for e in sup.events]}, resized 2 -> 1 "
          f"(suspects {rz[0]['suspect_ranks']}), tdl_gang_resizes_total{{down}} 1; the "
          f"survivor restored iteration {res['start']} with reshard=True in "
          f"{res['restore_ms']:.1f} ms (tdl_reshard_bytes_total {res['reshard_bytes']:.0f}, "
          f"tdl_reshard_seconds {res['reshard_seconds']:.4f}) and finished {EL_STEPS} steps: "
          f"{errors} vs the one-process fit; {n} rank-steps, 1 launch of each flash kernel per "
          f"step per rank; supervised run {run['seconds']:.1f} s [{card}]", flush=True)


def _gang_logs(sup):
    for name in sorted(os.listdir(sup.workdir)):
        if name.startswith("logs_"):
            for f in sorted(os.listdir(os.path.join(sup.workdir, name))):
                with open(os.path.join(sup.workdir, name, f)) as fh:
                    tail = fh.read().splitlines()[-20:]
                print(f"--- {name}/{f}\n" + "\n".join(tail), flush=True)


def start_elastic_gang(workdir):
    """13b's supervised gang, run on a thread beside 13a and 13c: (the
    supervisor, its directory, the run's record, the thread)."""
    sup, d = _supervisor(workdir, "13b", EL_FAULTS, os.path.join(workdir, "ck_b"),
                         max_restarts=1, elastic=True, min_processes=1, poll_interval=0.05,
                         spec={"steps": EL_STEPS, "every": EL_EVERY, "elastic": True,
                               "dead_rank": 1, "survivors": 1})
    run = {}
    t = threading.Thread(target=_run_gang, args=(sup, "13b", run))
    t.start()
    return sup, d, run, t


def phase_elastic_gang(tag, launches, gang):
    sup, d, run, t = gang
    t.join()
    if "error" in run:
        _gang_logs(sup)
    check_elastic_gang(tag, launches, sup, d, run)


def phase_supervised_gang(tag, launches, workdir):
    """13a: returns the generations {iteration: directory}."""
    sup, d = _supervisor(workdir, "13a", SUP_FAULTS, os.path.join(workdir, "ck_a"),
                         max_restarts=3, spec={"steps": SUP_STEPS, "every": SUP_EVERY,
                                               "elastic": False})
    run = {}
    _run_gang(sup, "13a", run)
    if "error" in run:
        _gang_logs(sup)
    return check_supervised_gang(tag, launches, sup, d, run)


def _flip_byte(shard):
    """Flip one byte in the middle of a committed shard: latent bit rot."""
    raw = bytearray(open(shard, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(bytes(raw))


def _held_out():
    """A held-out seeded batch of 6c's shape with its labels."""
    rs = np.random.RandomState(901)
    return (rs.randn(ATTN_B, ATTN_C, ATTN_T).astype(np.float32),
            np.eye(10, dtype=np.float32)[rs.randint(0, 10, ATTN_B)])


def _deploy_eval(registry, seen):
    """The controller's eval callable: the candidate restored into 9b's
    network on the card, scored on the held-out batch through
    ``Evaluation.to_metrics``; the gate's ``score`` is 1 / (1 + cross-entropy)
    (0 when the cross-entropy is not finite): a spike that keeps the argmax
    still blows up the cross-entropy."""
    from deeplearning4j_tpu_torch.eval import Evaluation

    x, y = _held_out()

    def eval_fn(gendir):
        net = _preempt_net("float32")
        check(_restore_generation(net, gendir), f"13c: {gendir} did not restore")
        p = np.asarray(net.output(x).float().cpu().numpy(), np.float64)
        ev = Evaluation()
        ev.eval(y, p)
        metrics = ev.to_metrics(registry, model=os.path.basename(gendir))
        xent = float(-(y * np.log(np.clip(p, 1e-12, 1.0))).sum(axis=1).mean())
        metrics["score"] = 1.0 / (1.0 + xent) if math.isfinite(xent) else 0.0
        seen[os.path.basename(gendir)] = metrics
        return metrics

    return eval_fn


def start_deploy_pool(workdir, target=None):
    """13c's pool, started ahead of 13a so that its two replicas warm while
    the gangs train: ``checkpoint_replica`` on the untrained network (the
    old fleet), every replica serving gen-9 slowed by ``latency_inject``."""
    from deeplearning4j_tpu_torch.kernels import _build
    from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
    from deeplearning4j_tpu_torch.serde.checkpoint import _gen_name
    from deeplearning4j_tpu_torch.serving import ServingPool

    reg = MetricsRegistry()
    target = target or f"{os.path.abspath(__file__)}:checkpoint_replica"
    pool = ServingPool(target, replicas=2,
                       min_replicas=1, max_replicas=4, workdir=os.path.join(workdir, "pool"),
                       registry=reg, extra_env={
                           "TDL_COMPILE_CACHE_DIR": str(_build.build_dir().parent),
                           "TDL_FAULT_SPEC":
                               f"latency_inject@value={DEPLOY_LATENCY_S},model={_gen_name(9)}"})
    t0, ready = time.monotonic(), {}
    pool.start()
    # notes when each replica is first seen ready while the gangs train
    waiter = threading.Thread(target=_await_ready, args=(pool, (0, 1), 300.0, ready),
                              daemon=True)
    waiter.start()
    return pool, reg, t0, ready, waiter


def phase_unattended_deploy(tag, launches, workdir, gens, pool, reg, t_pool, ready, waiter):
    """13c: gen-6 bit-flipped, a ``FleetController`` run once over 13a's
    lineage with the integrity, eval and canary gates: gen-6 rejected at
    integrity, gen-12 (loss-spiked) at eval, gen-9 (latency-injected) at the
    canary, gen-3 promoted through the canary and swapped into both
    replicas; only 200 and 429 escape the pool; the audit and the
    ``deploy_rollback`` flight events agree; one flash forward per executed
    batch in the canaries and the promoted replicas, whose answers equal
    gen-3's output bit for bit."""
    from deeplearning4j_tpu_torch.deploy import FleetController
    from deeplearning4j_tpu_torch.monitoring import flight
    from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
    from deeplearning4j_tpu_torch.serde.checkpoint import verify_checkpoint
    from deeplearning4j_tpu_torch.serving.loadgen import TraceSpec, replay

    card = card_line()
    g3, g6, g9, g12 = (gens[i] for i in (3, 6, 9, 12))
    _flip_byte(os.path.join(g6, "shard_0.npz"))
    check(verify_checkpoint(g6)["reason"] == "shard_crc", "13c: the flipped gen-6 verifies")
    waiter.join()
    if sorted(ready) != [0, 1]:
        _replica_logs(pool)
        raise SmokeFailure(f"13c: replicas not ready: {pool.replica_states()}")
    pool_ready_s = max(ready.values()) - t_pool
    x_seq = np.random.RandomState(13).randn(1, ATTN_C, ATTN_T).astype(np.float32)
    canaries, canary_ready, swap_s = [], [], []
    start, stop, swap = pool.start_canary, pool.stop_canary, pool.swap_model

    def timed_start(*a, **k):
        t0 = time.monotonic()
        h = start(*a, **k)
        canary_ready.append(time.monotonic() - t0)
        h.smoke_stats = pool.replica_stats()[h.id]  # after the warm-up's launches
        return h

    def stats_then_stop(h):
        after = pool.replica_stats()[h.id]
        canaries.append((h.env_overrides.get("TDL_MODEL_CKPT"),
                         {k: after[k] - h.smoke_stats[k] for k in ("batches",
                                                                   "flash_fwd_launches")}))
        stop(h)

    def timed_swap(*a, **k):  # the promote gate: the rolling swap
        t0 = time.monotonic()
        try:
            return swap(*a, **k)
        finally:
            swap_s.append(round(time.monotonic() - t0, 3))

    pool.start_canary, pool.stop_canary, pool.swap_model = timed_start, stats_then_stop, timed_swap
    seen = {}
    ctl = FleetController(
        os.path.dirname(os.path.dirname(g3)), pool, workdir=os.path.join(workdir, "deploy"),
        eval_fn=_deploy_eval(reg, seen), eval_thresholds={"score": DEPLOY_FLOOR},
        regression_band=DEPLOY_BAND, trace=TraceSpec(**DEPLOY_TRACE),
        payload=x_seq.tolist(), n_clients=4, slo_threshold_ms=DEPLOY_SLO_MS,
        burn_window_s=0.5, canary_ready_timeout=300.0, gate_timeout_s=600.0, retries=1,
        retry_backoff_s=0.1, registry=reg)
    try:
        _zero_counts()
        t0 = time.perf_counter()
        ctl.run_once()
        run_s = time.perf_counter() - t0
        eval_launches = _read_counts()["flash_fwd"]
        cands = ctl.state["candidates"]
        names = {i: os.path.basename(g) for i, g in ((3, g3), (6, g6), (9, g9), (12, g12))}
        verdicts = {i: (cands[n]["status"], (cands[n].get("rejected_by") or {}).get("gate"))
                    for i, n in names.items()}
        check(verdicts == {3: ("promoted", None), 6: ("rejected", "integrity"),
                           9: ("rejected", "canary"), 12: ("rejected", "eval")},
              f"13c: verdicts {verdicts}; {json.dumps(cands, default=str)[:3000]}")
        check(cands[names[6]]["rejected_by"]["reason"] == "shard_crc"
              and cands[names[9]]["rejected_by"]["reason"].startswith("slo:"),
              f"13c: reasons {[cands[names[i]]['rejected_by'] for i in (6, 9)]}")
        check([(v["gate"], v["ok"]) for v in cands[names[3]]["verdicts"]] == [
            ("integrity", True), ("eval", True), ("canary", True), ("promote", True)],
            f"13c: gen-3's verdicts {cands[names[3]]['verdicts']}")
        rows = pool.describe()["replicas"]
        check(len(rows) == 2 and all(r["model"] == g3 and not r["canary"] for r in rows),
              f"13c: the pool after the swap {rows}")
        with open(ctl.audit_path) as f:
            audit = json.load(f)
        rec = ctl._own_recorder or flight.get_flight_recorder()
        rolled = {e["generation"]: (e["gate"], e["reason"]) for e in rec.events()
                  if e["kind"] == "deploy_rollback"}
        audited = {c["generation"]: (c["rejected_by"]["gate"], c["rejected_by"]["reason"])
                   for c in audit["candidates"] if c["status"] == "rejected"}
        check(rolled == audited and len(rolled) == 3,
              f"13c: deploy_rollback events {rolled} against the audit {audited}")
        # the promoted replicas: one flash forward per executed batch, gen-3's answers
        n = CKPT_SERVE_CLIENTS * CKPT_SERVE_REQUESTS
        seqs = list(np.random.RandomState(12).randn(n, 1, ATTN_C, ATTN_T).astype(np.float32))
        before = pool.replica_stats()
        outs, lat, _ = _drive_clients("13c promoted gen-3", pool.port, seqs, CKPT_SERVE_CLIENTS)
        report = replay(TraceSpec(**DEPLOY_REPLAY), pool.port, n_clients=4,
                        payload=x_seq.tolist())
        after = pool.replica_stats()
    finally:
        ctl.close()
        pool.start_canary, pool.stop_canary, pool.swap_model = start, stop, swap
        with pool._lock:
            handles = list(pool._replicas.values())
        pool.stop(drain=True, timeout=60.0)
    codes = [h.proc.returncode for h in handles]
    check(codes == [0, 0], f"13c: replica exit codes {codes}")
    outcomes = report["outcomes"]
    check(set(outcomes) <= {"200", "429"} and outcomes.get("200", 0) > 0,
          f"13c: outcomes escaping the pool {outcomes}")
    check(sorted(before) == sorted(after) and len(after) == 2,
          f"13c: replica stats {sorted(before)} then {sorted(after)}")
    served = {rid: (after[rid]["batches"] - before[rid]["batches"],
                    after[rid]["flash_fwd_launches"] - before[rid]["flash_fwd_launches"])
              for rid in after}
    check(all(b == l and s["iteration"] == 3 for (b, l), s in zip(served.values(),
                                                               after.values())),
          f"13c: promoted replicas (batches, launches) {served}, iterations "
          f"{[s['iteration'] for s in after.values()]}")
    check(len(canaries) == 2 and all(s["batches"] == s["flash_fwd_launches"] > 0
                                     for _, s in canaries),
          f"13c: canaries {canaries}")
    launches["flash_fwd"].append(eval_launches + sum(l for _, l in served.values())
                                 + sum(s["flash_fwd_launches"] for _, s in canaries))
    net3 = _preempt_net("float32")  # as checkpoint_replica builds it
    check(_restore_generation(net3, g3), "13c: gen-3 did not restore")
    pi = ParallelInference(net3, batch_limit=8)
    ref = np.stack([pi.output(x) for x in seqs])
    got = np.asarray(outs, np.float32)
    check(got.shape == ref.shape, f"13c: responses of shape {got.shape}, expected {ref.shape}")
    worst = float(np.abs(got - ref).max())
    gate_s = {f"gen-{i}": [(v["gate"], v.get("seconds", swap_s[0] if swap_s else None))
                           for v in cands[names[i]]["verdicts"]] for i in (3, 6, 9, 12)}
    scores = {k: round(v["score"], 4) for k, v in sorted(seen.items())}
    print(f"{tag} 13c FleetController over 13a's lineage (gen-6 bit-flipped) on a ServingPool "
          f"of 2 checkpoint_replica (ready {pool_ready_s:.1f} s after start, warming while "
          f"13a and 13b trained), latency_inject {DEPLOY_LATENCY_S} s on gen-9: gen-6 rejected at "
          f"integrity (shard_crc), gen-12 at eval (scores {scores}, floor {DEPLOY_FLOOR}, band "
          f"{DEPLOY_BAND}), gen-9 at the canary ({cands[names[9]]['rejected_by']['reason']}), "
          f"gen-3 promoted through the canary and swapped into both replicas; run_once "
          f"{run_s:.1f} s; gate seconds {gate_s}; canary time to ready "
          f"{[round(s, 3) for s in canary_ready]} s; audit and deploy_rollback events agree "
          f"({len(rolled)} rollbacks) [{card}]", flush=True)
    print(f"{tag} 13c promoted fleet: {n} requests from {CKPT_SERVE_CLIENTS} clients all 200, "
          f"latency {_latency_line(lat)}; replay {DEPLOY_REPLAY} outcomes {outcomes}; "
          f"(batches, flash forward launches) per promoted replica {served}, per canary "
          f"{[(os.path.basename(m or ''), s['batches'], s['flash_fwd_launches']) for m, s in canaries]}, "
          f"{eval_launches} in the eval gate; worst |answer - gen-3's float32 output at the "
          f"served batch shape| {worst:.2e} (must be 0) [{card}]", flush=True)
    check(np.array_equal(got, ref), f"13c: an answer differs from gen-3's output by up to "
                                    f"{worst:.2e}")
    del net3, pi
    _free_card()


def phase_unattended(tag, launches, workdir, target=None):
    """Phase 13: 13c's pool and 13b's gang start first and run beside 13a;
    13c's controller then runs on 13a's lineage while 13b finishes."""
    t0 = time.perf_counter()
    pool = start_deploy_pool(workdir, target)
    gang = start_elastic_gang(workdir)
    try:
        gens = phase_supervised_gang(tag, launches, workdir)
        print(f"phase 13a supervised gang: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        t = time.perf_counter()
        phase_unattended_deploy(tag, launches, workdir, gens, *pool)
        print(f"phase 13c unattended deploy: ok ({time.perf_counter() - t:.1f} s)", flush=True)
    finally:
        pool[0].stop(drain=False)  # idempotent: 13c stops it itself
        t = time.perf_counter()
        phase_elastic_gang(tag, launches, gang)
    print(f"phase 13b elastic gang: ok (waited {time.perf_counter() - t:.1f} s after 13c)",
          flush=True)


# ------------------------------------------------------------------ phase 14

# bench.py's word2vec corpus and accelerator shapes (bench.py:156, :758-783)
W2V_SENTENCES = 20000
W2V_VOCAB = 2000
W2V_KW = dict(layer_size=100, window=5, negative=5, epochs=1, batch_size=16384)
# the card against the CPU fit on the same seed, of the table's largest
# magnitude: float32 reassociation only (index_add_'s atomics add a row's
# contributions in another order; the gathers and sigmoids agree to a few
# ulps). Adding the CPU's scatters in shuffled orders moves the tables of
# phase 14 by at most 1.6e-6 of their scale, GloVe's (AdaGrad divides by the
# root of summed squares) by 6.6e-6 (tests/torch_nlp_reorder.py)
TABLE_REL = 1e-4
TSNE_STEPS_CHECKED = 10
TSNE_Y_REL = 1e-4    # the first steps' embedding, of its largest magnitude
TSNE_KL_REL = 1e-5   # the first steps' KL
TSNE_P_ATOL = 1e-6   # the affinities (float32 bisection)
TSNE_FINAL_KL_REL = 0.1  # the trajectories part after ~20 steps (gains, exaggeration)
BI_STEPS = 24        # 14c's bf16 steps (3 passes over 8 batches)


def w2v_corpus():
    """bench.py's corpus: 2,000 words, Zipf, 8-19 words a sentence, seed 0."""
    rs = np.random.RandomState(0)
    vocab = [f"w{i}" for i in range(W2V_VOCAB)]
    zipf = 1.0 / np.arange(1, W2V_VOCAB + 1)
    zipf /= zipf.sum()
    return [" ".join(rs.choice(vocab, size=rs.randint(8, 20), p=zipf))
            for _ in range(W2V_SENTENCES)]


def _table_error(tag, what, card, cpu):
    scale = float(np.abs(cpu).max())
    err = float(np.abs(card - cpu).max())
    print(f"{tag} {what}: card vs CPU max |diff| {err:.3e} (table max {scale:.3e}, "
          f"rel {err / scale:.2e}, bound {TABLE_REL:.0e})", flush=True)
    check(np.isfinite(card).all(), f"{what}: non-finite values on the card")
    check(err <= TABLE_REL * scale, f"{what}: card differs from the CPU by {err:.3e}")


def phase_word2vec(tag):
    """14a: Word2Vec at bench.py's shapes; returns the card's fit."""
    import torch

    from deeplearning4j_tpu_torch.nlp import word2vec as W

    sentences = w2v_corpus()
    total_words = sum(len(s.split()) for s in sentences)
    W.Word2Vec(**W2V_KW).fit(sentences)  # warm: allocator, cuBLAS, first launches
    loops, orig = [], W._w2v_epoch

    def timed_epoch(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the epoch loop must not wait for the card: any synchronising call
        # inside it raises here
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        loops.append((time.perf_counter() - t0, args, kw))
        return out

    W._w2v_epoch = timed_epoch
    try:
        t0 = time.perf_counter()
        card = W.Word2Vec(**W2V_KW).fit(sentences)
        wall = time.perf_counter() - t0
    finally:
        W._w2v_epoch = orig
    (loop_s, args, kw), = loops
    S, B = args[3].shape[:2]
    print(f"{tag} word2vec skip-gram NS, {W2V_SENTENCES} sentences ({total_words} words), "
          f"V={card.vocab.num_words()} layer {W2V_KW['layer_size']} batch {B}: "
          f"{total_words / wall:.1f} words/s ({wall:.3f} s fit: host {wall - loop_s:.3f} s "
          f"[tokenize, subsample, pairs, negatives, upload], device loop {loop_s:.3f} s over "
          f"S={S} batches, {loop_s / S * 1e3:.3f} ms per batch); no host sync in the loop",
          flush=True)
    device_profile(tag, f"word2vec epoch (S={S})", lambda: orig(*args, **kw), reps=1, top=8)
    # the sync debug mode is a prototype that may miss a synchronising call:
    # the profile of one more epoch must show no copy back to the host
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        orig(*args, **kw)
        torch.cuda.synchronize()
    d2h = [e.name for e in prof.events() if "DtoH" in e.name]
    print(f"{tag} word2vec epoch: {len(d2h)} device-to-host copies in its profile", flush=True)
    check(not d2h, f"word2vec epoch: device-to-host copies {d2h[:3]}")
    del args, kw, loops
    t0 = time.perf_counter()
    cpu = W.Word2Vec(device="cpu", **W2V_KW).fit(sentences)
    print(f"{tag} word2vec CPU fit {time.perf_counter() - t0:.3f} s", flush=True)
    _table_error(tag, "word2vec syn0", card.syn0, cpu.syn0)
    _table_error(tag, "word2vec syn1neg", card.syn1neg, cpu.syn1neg)
    check(card.vocab.vocab_words()[0].word == "w0", "word2vec: w0 is not the most frequent word")

    kw = dict(W2V_KW, cbow=True, hs=True)
    t0 = time.perf_counter()
    cb = W.Word2Vec(**kw).fit(sentences)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cb_cpu = W.Word2Vec(device="cpu", **kw).fit(sentences)
    print(f"{tag} word2vec CBOW + HS + NS: card fit {t_card:.3f} s "
          f"({total_words / t_card:.1f} words/s), CPU fit {time.perf_counter() - t0:.3f} s",
          flush=True)
    for name in ("syn0", "syn1neg", "syn1"):
        _table_error(tag, f"word2vec CBOW+HS+NS {name}", getattr(cb, name), getattr(cb_cpu, name))
    return card


def _topic_docs(n_docs=2000, topics=4, words_per_topic=50, seed=3):
    rs = np.random.RandomState(seed)
    vocab = [[f"t{t}w{i}" for i in range(words_per_topic)] for t in range(topics)]
    return [(f"doc{d}_t{d % topics}", " ".join(rs.choice(vocab[d % topics],
                                                          size=rs.randint(10, 30))))
            for d in range(n_docs)]


def _community_graph(n=200, communities=4, seed=5):
    """Nodes in communities: each links to 6 nodes of its own and 1 other."""
    rs = np.random.RandomState(seed)
    size = n // communities
    adj = {}
    for v in range(n):
        c = v // size
        own = rs.choice([u for u in range(c * size, (c + 1) * size) if u != v], 6, replace=False)
        adj[v] = [int(u) for u in own] + [int(rs.randint(n))]
    return adj


def phase_nlp_rest(tag, w2v):
    """14b: GloVe, ParagraphVectors, SequenceVectors and t-SNE on the card,
    each against the port's CPU run on the same seed."""
    import torch

    from deeplearning4j_tpu_torch.nlp import GraphWalkIterator, SequenceVectors
    from deeplearning4j_tpu_torch.nlp import tsne as TS
    from deeplearning4j_tpu_torch.nlp.glove import Glove
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors

    def both(make, fit):
        out = []
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            out.append(fit(make(device)))
            out.append(time.perf_counter() - t0)
        return out

    sentences = w2v_corpus()
    g, tg, gc, tgc = both(lambda d: Glove(layer_size=100, window=5, epochs=2, seed=7, device=d),
                          lambda m: m.fit(sentences))
    print(f"{tag} GloVe, 14a's corpus (V={g.vocab.num_words()}, layer 100, 2 epochs): card "
          f"{tg:.3f} s, CPU {tgc:.3f} s; loss {g.loss_curve} (CPU {gc.loss_curve})", flush=True)
    _table_error(tag, "GloVe w + w~", g.syn0, gc.syn0)
    lrel = max(abs(a - b) / abs(b) for a, b in zip(g.loss_curve, gc.loss_curve))
    check(lrel <= TABLE_REL, f"GloVe: loss curve differs from the CPU by {lrel:.2e}")
    check(g.loss_curve[-1] < g.loss_curve[0], f"GloVe: loss did not fall {g.loss_curve}")

    docs = _topic_docs()
    text = " ".join(f"t1w{i}" for i in range(0, 40, 3))
    pv, tp, pvc, tpc = both(
        lambda d: ParagraphVectors(layer_size=100, window=5, epochs=10, seed=11, device=d),
        lambda m: m.fit(docs))
    inf, inf_c = pv.infer_vector(text, steps=50), pvc.infer_vector(text, steps=50)
    print(f"{tag} ParagraphVectors DM ({len(docs)} documents, 4 topics, layer 100, 10 epochs): "
          f"card {tp:.3f} s, CPU {tpc:.3f} s", flush=True)
    for name in ("doc_vectors", "syn0", "syn1neg"):
        _table_error(tag, f"ParagraphVectors {name}", getattr(pv, name), getattr(pvc, name))
    _table_error(tag, "ParagraphVectors infer_vector", inf, inf_c)
    near = pv.nearest_labels(inf, 10)
    print(f"{tag} infer_vector of a topic-1 text: nearest {near}", flush=True)
    check(sum(label.endswith("_t1") for label in near) >= 7,
          f"ParagraphVectors: inferred topic-1 text nearest to {near}")

    adj = _community_graph()
    walks = lambda: GraphWalkIterator(adj, walk_length=20, walks_per_node=10, seed=2)  # noqa: E731
    sv, ts, svc, tsc = both(
        lambda d: SequenceVectors(layer_size=64, window=5, negative=5, epochs=2,
                                  batch_size=2048, seed=13, device=d),
        lambda m: m.fit(walks()))
    print(f"{tag} SequenceVectors over {len(adj)}-node graph walks (2000 walks of 20, layer 64): "
          f"card {ts:.3f} s, CPU {tsc:.3f} s", flush=True)
    _table_error(tag, "SequenceVectors elements", sv._w2v.syn0, svc._w2v.syn0)

    # t-SNE of 14a's word vectors: the affinities, the first steps from one
    # start, then the whole run's final KL
    x = w2v.syn0
    n = x.shape[0]
    tsne = TS.BarnesHutTsne(seed=17)
    perp = min(tsne.perplexity, max((n - 1) / 3.0, 2.0))
    ps = []
    for device in ("cuda", "cpu"):
        p = TS._cond_probs(TS._pairwise_sq_dists(torch.from_numpy(x).to(device)), perp)
        ps.append(((p + p.T) / (2.0 * n)))
    p_err = float((ps[0].cpu() - ps[1]).abs().max())
    print(f"{tag} t-SNE of {n} word vectors: P card vs CPU max |diff| {p_err:.3e} "
          f"(max P {float(ps[1].max()):.3e}, bound {TSNE_P_ATOL:.0e})", flush=True)
    check(p_err <= TSNE_P_ATOL, f"t-SNE: affinities differ by {p_err:.3e}")
    y0 = tsne._initial_y(n)
    kw = dict(n_iter=TSNE_STEPS_CHECKED, learning_rate=tsne.learning_rate,
              momentum_final=tsne.momentum, exaggeration=tsne.exaggeration,
              exaggeration_iters=min(250, tsne.n_iter // 2))
    y_card, kl_card = TS._tsne_run(ps[1].cuda(), y0.cuda(), **kw)
    y_cpu, kl_cpu = TS._tsne_run(ps[1], y0, **kw)
    y_err = float((y_card.cpu() - y_cpu).abs().max() / y_cpu.abs().max())
    kl_err = float(((kl_card.cpu() - kl_cpu).abs() / kl_cpu.abs()).max())
    print(f"{tag} t-SNE first {TSNE_STEPS_CHECKED} steps from one start: y rel {y_err:.2e} "
          f"(bound {TSNE_Y_REL:.0e}), KL rel {kl_err:.2e} (bound {TSNE_KL_REL:.0e})", flush=True)
    check(y_err <= TSNE_Y_REL and kl_err <= TSNE_KL_REL, "t-SNE: first steps differ")
    t_card, t_cpu, kls = [], [], []
    for device, sink in (("cuda", t_card), ("cpu", t_cpu)):
        t0 = time.perf_counter()
        m = TS.BarnesHutTsne(seed=17, device=device)
        y = m.fit_transform(x)
        sink.append(time.perf_counter() - t0)
        check(np.isfinite(y).all() and y.shape == (n, 2), f"t-SNE on {device}: bad embedding")
        kls.append(m.kl_curve_)
    rel = abs(kls[0][-1] - kls[1][-1]) / kls[1][-1]
    print(f"{tag} t-SNE {tsne.n_iter} steps: card {t_card[0]:.3f} s, CPU {t_cpu[0]:.3f} s; "
          f"final KL {kls[0][-1]:.4f} vs CPU {kls[1][-1]:.4f} (rel {rel:.3f}, bound "
          f"{TSNE_FINAL_KL_REL}); KL at step 0 {kls[0][0]:.4f}", flush=True)
    check(rel <= TSNE_FINAL_KL_REL, f"t-SNE: final KL differs from the CPU by {rel:.3f}")
    check(kls[0][-1] < kls[0][TSNE_STEPS_CHECKED], "t-SNE: KL did not fall")


def wordpiece_vocab(seed=21, n_syllables=400, n_words=12000):
    """A WordPiece vocabulary from a seeded corpus: the five specials, whole
    words, and every syllable as a first piece and as a ``##`` piece (any
    word of syllables then tokenizes without [UNK])."""
    rs = np.random.RandomState(seed)
    cons, vows = "bcdfghjklmnprstvwz", "aeiou"
    sylls = sorted({rs.choice(list(cons)) + rs.choice(list(vows)) + rs.choice(["", "n", "r", "s"])
                    for _ in range(4 * n_syllables)})[:n_syllables]
    words = ["".join(rs.choice(sylls, rs.randint(1, 4))) for _ in range(n_words)]
    whole = sorted(set(words[: n_words // 2]))
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sylls + [f"##{s}" for s in sylls]
    tokens += [w for w in whole if w not in set(tokens)] + [".", ","]
    return {t: i for i, t in enumerate(tokens)}, words


def bert_sentences(words, seed=22, n=128):
    """Sentences and sentence pairs of 3 to 90 words: ~10 to past 128 word
    pieces, so most rows pad and some are cut."""
    rs = np.random.RandomState(seed)

    def sentence():
        return " ".join(rs.choice(words, rs.randint(3, 91))) + " ."

    return [(sentence(), sentence()) if i % 4 == 0 else sentence() for i in range(n)]


def _bert_batch(mds):
    """The MultiDataSet as ``loss_fn``'s batch (this mapping is the
    script's, not a package feature)."""
    return {"tokens": mds.features[0], "segments": mds.features[1],
            "pad_mask": mds.features_masks[0], "labels": mds.labels[0],
            "weights": mds.labels_masks[0]}


def phase_bert_iterator(tag, launches):
    """14c: BertIterator batches train BERT-base through the flash kernels."""
    import torch

    from deeplearning4j_tpu_torch.kernels import attention as A
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.nlp import BertIterator, BertMaskedLMMasker
    from deeplearning4j_tpu_torch.nlp import BertWordPieceTokenizer
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    vocab, words = wordpiece_vocab()
    tok = BertWordPieceTokenizer(vocab)
    sents = bert_sentences(words)
    it = BertIterator(tokenizer=tok, sentences=sents, max_length=128, batch_size=16,
                      task="UNSUPERVISED",
                      masker=BertMaskedLMMasker(mask_token_id=vocab["[MASK]"],
                                                vocab_size=len(vocab), seed=23))
    batches = [_bert_batch(m) for m in it]
    lengths = np.concatenate([b["pad_mask"].sum(1) for b in batches])
    full = [len(tok.tokenize(s if isinstance(s, str) else s[0]))
            + (len(tok.tokenize(s[1])) + 1 if isinstance(s, tuple) else 0) + 2 for s in sents]
    print(f"{tag} BertIterator: WordPiece vocabulary {len(vocab)} ids, {len(sents)} texts "
          f"({sum(isinstance(s, tuple) for s in sents)} pairs) of {min(full)}-{max(full)} "
          f"pieces, {len(batches)} batches [16, 128]: {int((lengths < 128).sum())} rows padded, "
          f"{sum(f > 128 for f in full)} cut; masked positions per batch "
          f"{[int(b['weights'].sum()) for b in batches]}", flush=True)
    check(len(vocab) < 30522, "BertIterator: vocabulary past BERT-base's")
    check((lengths < 128).sum() > len(lengths) // 2 and sum(f > 128 for f in full) > 0,
          "BertIterator: the texts do not both pad and cut")
    check(all(int(b["tokens"].max()) < len(vocab) for b in batches), "BertIterator: id range")

    cfg = tfm.TransformerConfig.bert_base(max_len=128, dropout=0.0)
    dense = []
    orig = A.mha_reference

    def counted_reference(*a, **k):
        dense.append(1)
        return orig(*a, **k)

    # one float32 step with the iterator's key padding: kernels vs dense
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    params = tfm.init_params(31, cfg32, device="cuda")
    A.mha_reference = counted_reference
    try:
        _zero_counts()
        loss, grads = tfm.loss_and_grads(params, batches[0], cfg32)
        counts = _read_counts()
        check(not dense, f"14c float32 step: dense attention ran {len(dense)} times")
    finally:
        A.mha_reference = orig
    _check_step_counts("14c fp32 step", counts, 1, cfg.n_layers)
    launches["flash_fwd_f32"].append(counts["flash_fwd"])
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        launches[f"{name}_f32"].append(counts[name])
    ref_loss, ref_grads = tfm.loss_and_grads(
        params, batches[0], dataclasses.replace(cfg32, attn_impl="xla"))
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    worst_name, worst = "", 0.0
    for name, g in grads.items():
        r = ref_grads[name]
        check(torch.isfinite(g).all().item(), f"14c fp32 step: non-finite gradient {name}")
        rel = ((g - r).norm() / r.norm().clamp(min=1e-30)).item() if r.norm() > 0 \
            else g.norm().item()
        if rel > worst:
            worst_name, worst = name, rel
    print(f"{tag} 14c fp32 step with the iterator's pad_mask, flash kernels vs dense: loss "
          f"{loss.item():.6f} vs {ref_loss.item():.6f} (rel {loss_rel:.2e}); largest gradient "
          f"error {worst:.2e} of its norm ({worst_name})", flush=True)
    check(loss_rel <= TRAIN_LOSS_REL, f"14c fp32 step: loss differs by {loss_rel:.2e}")
    check(worst <= TRAIN_GRAD_REL, f"14c fp32 step: gradient {worst_name} differs by {worst:.2e}")
    del params, grads, ref_grads

    # the main path: bf16 compute, Adam, BI_STEPS steps over the batches
    params = tfm.init_params(31, cfg, device="cuda")
    updater = Adam(1e-4)
    state = updater.init(params)
    step = tfm.make_train_step(cfg, updater)
    losses, times = [], []
    A.mha_reference = counted_reference
    try:
        _zero_counts()
        torch.cuda.synchronize()
        for i in range(BI_STEPS):
            t0 = time.perf_counter()
            params, state, loss = step(params, state, batches[i % len(batches)], i)
            losses.append(loss.item())
            times.append((time.perf_counter() - t0) * 1e3)
        counts = _read_counts()
    finally:
        A.mha_reference = orig
    check(not dense, f"14c bf16 steps: dense attention ran {len(dense)} times")
    _check_step_counts("14c bf16 steps", counts, BI_STEPS, cfg.n_layers)
    for name, n in counts.items():
        launches[name].append(n)
    check(all(math.isfinite(x) for x in losses), f"14c: non-finite loss in {losses}")
    first, last = np.mean(losses[:len(batches)]), np.mean(losses[-len(batches):])
    print(f"{tag} 14c BERT-base bf16 Adam from BertIterator batches: loss " + " ".join(
        f"{x:.4f}" for x in losses), flush=True)
    print(f"{tag} 14c step after the first pass over the batches: "
          f"{spread(times[len(batches):])}; "
          f"{16 * 128 / statistics.median(times[len(batches):]) * 1e3:.0f} "
          f"tokens/s at the median; launches per step "
          f"{', '.join(f'{k} {v // BI_STEPS}' for k, v in counts.items())}; dense attention 0",
          flush=True)
    check(last < first, f"14c: the last pass's mean loss {last:.4f} is not below the "
          f"first's {first:.4f}")


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
        resnet = phase_resnet(tag)
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
        t9 = time.perf_counter()
        workdir = tempfile.mkdtemp(prefix="tdl_smoke_ckpt_")
        try:
            phase_checkpoint_resnet(tag, *resnet, workdir)
            del resnet
            _free_card()
            print(f"phase 9a ResNet-50 checkpoint: ok ({time.perf_counter() - t9:.1f} s)",
                  flush=True)
            t = time.perf_counter()
            roots = phase_preempt_resume(tag, launches, workdir)
            print(f"phase 9b preempt and resume: ok ({time.perf_counter() - t:.1f} s)",
                  flush=True)
            t = time.perf_counter()
            corrupt = phase_torn_and_corrupt(tag, launches, workdir, roots["float32"])
            print(f"phase 9c torn and corrupt generations: ok ({time.perf_counter() - t:.1f} s)",
                  flush=True)
            t = time.perf_counter()
            phase_checkpoint_swap(tag, launches["flash_fwd"], workdir, roots["float32"], corrupt)
            print(f"phase 9d verified swap: ok ({time.perf_counter() - t:.1f} s); phase 9 "
                  f"{time.perf_counter() - t9:.1f} s", flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        _free_card()
        t10 = time.perf_counter()
        workdir = tempfile.mkdtemp(prefix="tdl_smoke_dp_")
        try:
            phase_export(tag, launches, workdir)
            print(f"phase 10a export: ok ({time.perf_counter() - t10:.1f} s)", flush=True)
            t = time.perf_counter()
            phase_one_nccl_rank(tag, launches, workdir)
            print(f"phase 10b one NCCL rank: ok ({time.perf_counter() - t:.1f} s)", flush=True)
            t = time.perf_counter()
            phase_two_gloo_ranks(tag, launches, workdir)
            print(f"phase 10c two gloo ranks: ok ({time.perf_counter() - t:.1f} s)", flush=True)
            t = time.perf_counter()
            phase_master(tag, launches)
            print(f"phase 10d averaging master: ok ({time.perf_counter() - t:.1f} s); phase 10 "
                  f"{time.perf_counter() - t10:.1f} s", flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        _free_card()
        t11 = time.perf_counter()
        workdir = tempfile.mkdtemp(prefix="tdl_smoke_shard_")
        try:
            phase_sharded_flagship(tag, launches, workdir)
            print(f"phase 11a/11b sharded flagship: ok ({time.perf_counter() - t11:.1f} s)",
                  flush=True)
            t = time.perf_counter()
            phase_sharded_mln(tag, launches, workdir)
            print(f"phase 11c networks under mesh_layout: ok ({time.perf_counter() - t:.1f} s); "
                  f"phase 11 {time.perf_counter() - t11:.1f} s", flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        _free_card()
        t12 = time.perf_counter()
        workdir = tempfile.mkdtemp(prefix="tdl_smoke_pp_")
        try:
            phase_pipeline_flagship(tag, launches, workdir)
            print(f"phase 12a pipelined flagship: ok ({time.perf_counter() - t12:.1f} s)",
                  flush=True)
            t = time.perf_counter()
            phase_pipeline_rebalance(tag, launches, workdir)
            print(f"phase 12b data x pipe, rebalance, reshard: ok ({time.perf_counter() - t:.1f} "
                  f"s); phase 12 {time.perf_counter() - t12:.1f} s", flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        _free_card()
        t13 = time.perf_counter()
        workdir = tempfile.mkdtemp(prefix="tdl_smoke_sup_")
        try:
            phase_unattended(tag, launches, workdir)
            print(f"phase 13 {time.perf_counter() - t13:.1f} s", flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        _free_card()
        t14 = time.perf_counter()
        w2v = phase_word2vec(tag)
        print(f"phase 14a Word2Vec: ok ({time.perf_counter() - t14:.1f} s)", flush=True)
        t = time.perf_counter()
        phase_nlp_rest(tag, w2v)
        del w2v
        print(f"phase 14b GloVe, ParagraphVectors, SequenceVectors, t-SNE: ok "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
        t = time.perf_counter()
        phase_bert_iterator(tag, launches)
        print(f"phase 14c BertIterator into BERT-base: ok ({time.perf_counter() - t:.1f} s); "
              f"phase 14 {time.perf_counter() - t14:.1f} s", flush=True)
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
