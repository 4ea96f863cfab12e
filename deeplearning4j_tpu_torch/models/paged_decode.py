"""Block-paged KV cache with copy-on-write prefix sharing and speculative
decoding: the counterpart of ``deeplearning4j_tpu/models/paged_decode.py``.

- **arena**: K/V live in ``[L, n_blocks, block_T, H, hd]``. Block 0 is a
  scratch ("trash") block that absorbs writes from dead slots and from
  prefill blocks that belong to a shared block, so the decode step never
  branches on liveness;
- **block tables**: each slot owns a ``[max_blocks]`` row mapping logical
  block to physical block (0 = unmapped, trash). The decode math reaches its
  keys through ``arena[tables]``, a gather that rebuilds the dense logical
  layout ``[S, max_len, H, hd]``; after it, scale, mask and softmax are the
  dense pool's. Tables change every admission; shapes never do;
- **copy-on-write (CoW) prefix sharing**: an exact-match index keyed on the
  prompt's token bytes (int32, as in the JAX package) maps full prompt-prefix
  blocks and partial prompt tails to physical blocks. A matching admission
  takes a reference instead of a prefill of those blocks; a sharer that
  must write into a joined partial block first copies it into a block
  reserved for it at admission, so CoW cannot fail mid-decode;
- **block-priced admission**: ``admit`` prices a request at
  ``ceil((prompt + max_new [+ spec slack]) / block_T)`` blocks less what the
  prefix index holds, and raises :class:`NoFreeBlocksError`
  (``retry_admission = True``) when the arena cannot hold it now;
- **speculative decoding**: with a small draft model, one step drafts ``k``
  greedy tokens (k+1 chained single-token passes over the draft's own paged
  arena, with the same tables) and verifies them in one target forward over
  the (k+1)-token window. Greedy acceptance (``n_acc = 1 +
  cumprod(match).sum()``) makes the emitted stream the plain greedy one.

The decode step has one fixed signature (static tables, tokens and
positions of the whole pool). On CUDA it is captured once as a CUDA graph
and every step replays it: the counterpart of the JAX step compiled once
with donated buffers. On the CPU the same step function runs eagerly.
Prefill (the bucket ladder gives it several shapes) and the CoW block copy
run eagerly on the same stream, before the replay.

Single-owner object, like the dense pool: one decode loop (or ``generate``)
calls it; there is no locking.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..common.bucketing import bucket_size
from ..common.device import resolve_device
from .transformer import (
    _NEG_INF,
    KvCacheLostError,
    Transformer,
    TransformerConfig,
    _ffn,
    _layer_norm,
    _mlm_head,
    _residual,
    prefill_forward,
)

# eager runs of the step on a side stream before its capture (allocator
# and cuBLAS workspaces settle before the graph records their addresses)
_WARMUP_RUNS = 3


class NoFreeBlocksError(RuntimeError):
    """The paged arena cannot hold this admission now (it would fit an empty
    arena: a request that can never fit is a ``ValueError``).
    ``retry_admission`` is the duck-typed marker serving code keys on to
    re-queue the request rather than fail it."""

    retry_admission = True


class BlockAllocator:
    """Refcounted free-list allocator over the arena's physical blocks.

    Block 0 (trash) is never handed out. ``reserved`` blocks are held back
    from admission so that an admitted sharer's copy-on-write cannot fail; a
    reserve is consumed by decrementing ``reserved`` before ``alloc``. The
    prefix index lives here too, so a block's index keys die with its last
    reference."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 usable + trash), got {n_blocks}")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(1, n_blocks))  # block 0 = trash
        self.refcount = np.zeros(n_blocks, np.int32)
        self.reserved = 0
        self._index: Dict[Any, int] = {}     # prefix key -> physical block
        self._keys_of: Dict[int, list] = {}  # physical block -> [keys]

    @property
    def free_blocks(self) -> int:
        """Blocks available to new admissions (CoW reserves held back)."""
        return len(self._free) - self.reserved

    def alloc(self, count: int) -> List[int]:
        if count > self.free_blocks:
            raise NoFreeBlocksError(
                f"{count} KV blocks needed, {self.free_blocks} free "
                f"({self.reserved} reserved for copy-on-write)")
        out = [self._free.pop(0) for _ in range(count)]
        for b in out:
            self.refcount[b] = 1
        return out

    def ref(self, block: int) -> None:
        self.refcount[block] += 1

    def unref(self, block: int) -> None:
        self.refcount[block] -= 1
        if self.refcount[block] <= 0:
            self.refcount[block] = 0
            for key in self._keys_of.pop(block, ()):
                if self._index.get(key) == block:
                    del self._index[key]
            self._free.append(block)

    def register(self, key, block: int) -> None:
        """Publish ``block`` under ``key`` in the prefix index (the first
        registration wins; identical later prompts share instead)."""
        if key not in self._index:
            self._index[key] = block
            self._keys_of.setdefault(block, []).append(key)

    def lookup(self, key) -> Optional[int]:
        return self._index.get(key)


def _embed_window(params: Transformer, cfg: TransformerConfig, tokens, positions):
    """Decode-step embedding at explicit positions: [S,W] -> [S,W,D]. It runs
    inside the captured step, so it checks nothing on the host: ``admit``
    has checked the ids."""
    e = params.embed
    h = e.tok[tokens] + e.pos[positions]
    if cfg.type_vocab > 0:
        h = h + e.seg[0]
    return _layer_norm(h, e.ln_scale, e.ln_bias).to(cfg.compute_dtype)


def _paged_window_block(cfg: TransformerConfig, p, h, kf, vf, tables, cells, kv_mask,
                        n_blocks: int, block_T: int):
    """One transformer block over a W-token decode window with paged K/V.

    h [S,W,D]; kf/vf [n_blocks*block_T, H, hd] (this layer's flat arena,
    written in place); tables [S, max_blocks] logical -> physical; cells
    [S,W] flat arena cells where this window's K/V land; kv_mask
    [S,W,max_len] over logical key positions. Returns h."""
    S, W, D = h.shape
    H, hd = cfg.n_heads, cfg.head_dim
    cd = cfg.compute_dtype
    scale = 1.0 / math.sqrt(hd)

    def attn_sub(x):
        qkv = x @ p.qkv_w.to(cd) + p.qkv_b.to(cd)
        q, k, v = (t.reshape(S, W, H, hd) for t in qkv.split(D, dim=-1))
        # write before read: this window's K/V land in their cells first, so
        # stale cells at attended positions never survive a step. Only trash
        # cells repeat in ``cells`` (dead slots); no live cell is written twice.
        flat = cells.reshape(-1)
        kf.index_copy_(0, flat, k.reshape(S * W, H, hd).to(kf.dtype))
        vf.index_copy_(0, flat, v.reshape(S * W, H, hd).to(vf.dtype))
        g_k = kf.view(n_blocks, block_T, H, hd)[tables].reshape(S, -1, H, hd)
        g_v = vf.view(n_blocks, block_T, H, hd)[tables].reshape(S, -1, H, hd)
        scores = torch.einsum("swhd,sthd->swht", q, g_k.to(cd)) * scale
        scores = torch.where(kv_mask[:, :, None, :], scores, _NEG_INF)
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("swht,sthd->swhd", w, g_v.to(cd)).reshape(S, W, D)
        return o @ p.out_w.to(cd) + p.out_b.to(cd)

    return _residual(cfg, p, h, attn_sub, lambda x: _ffn(cfg, p, x))


def _paged_forward(params: Transformer, cfg: TransformerConfig, tokens, positions, kfs, vfs,
                   tables, n_blocks: int, block_T: int, *, head: bool = True):
    """Full-model W-token decode window over flat per-layer arenas.

    tokens/positions [S,W] (long); kfs/vfs: per-layer flat arena views,
    updated in place. Returns logits [S,W,V] float32, or None without
    ``head`` (a pass that only writes K/V)."""
    max_len = tables.shape[1] * block_T
    h = _embed_window(params, cfg, tokens, positions)
    phys = torch.gather(tables, 1, positions // block_T)
    cells = phys * block_T + positions % block_T
    kv_mask = torch.arange(max_len, device=h.device)[None, None, :] <= positions[:, :, None]
    for layer in range(cfg.n_layers):
        h = _paged_window_block(cfg, params.blocks[layer], h, kfs[layer], vfs[layer],
                                tables, cells, kv_mask, n_blocks, block_T)
    return _mlm_head(params, h, cfg) if head else None


class PagedDecodeSlotPool:
    """Paged replacement for the dense ``DecodeSlotPool``.

    Same duck interface (``admit``/``step``/``release``, ``free_slots``,
    ``prompt_bucket``, ``KvCacheLostError`` reset) with these additions:

    - ``can_admit``/``request_blocks``/``total_blocks``: block-priced
      admission control;
    - ``block_stats()``: occupancy, CoW sharing and speculative counters;
    - multi-token steps: ``step()`` returns ``{slot: [tokens...]}`` (one
      token per step plain, up to ``spec_tokens + 1`` speculative), each
      list clamped to the slot's remaining ``max_new_tokens`` budget.

    Pass ``draft_params``/``draft_cfg`` (a smaller causal config with the
    same vocab) to decode speculatively with ``spec_tokens`` drafted per
    target step.

    ``decode_traces`` counts builds of the decode step: on CUDA the graph
    captures, on the CPU the builds of its fixed-signature eager step.
    Either way admissions and retirements leave it at 1, as the JAX pool's
    jit trace count. ``graph_replays`` counts the replays (CUDA only).
    ``prefill_traces`` counts the prompt buckets prefilled (the JAX pool
    traces its prefill once per bucket).
    """

    def __init__(self, params: Transformer, cfg: TransformerConfig, *, slots: int = 8,
                 block_T: int = 16, n_blocks: Optional[int] = None,
                 max_len: Optional[int] = None, eos_id: Optional[int] = None,
                 min_prompt_bucket: int = 16, draft_params: Optional[Transformer] = None,
                 draft_cfg: Optional[TransformerConfig] = None, spec_tokens: int = 4,
                 device="cuda"):
        if not cfg.causal:
            raise ValueError(
                "autoregressive decode needs a causal config "
                "(TransformerConfig(causal=True)) — a bidirectional encoder "
                "cannot extend a sequence incrementally")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if block_T < 1 or (block_T & (block_T - 1)):
            raise ValueError(f"block_T must be a power of two, got {block_T}")
        self.max_len = max_len or cfg.max_len
        if self.max_len > cfg.max_len:
            raise ValueError(f"max_len {self.max_len} exceeds the model's "
                             f"positional range max_len={cfg.max_len}")
        if self.max_len % block_T:
            raise ValueError(f"max_len {self.max_len} must be a multiple of "
                             f"block_T {block_T}")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("speculative decoding needs BOTH draft_params "
                             "and draft_cfg (or neither)")
        dev = resolve_device(device)
        for what, prm in (("params", params), ("draft_params", draft_params)):
            if prm is not None and prm.device.type != dev.type:
                raise ValueError(f"{what} live on {prm.device}, the pool on {dev}")
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.block_T = block_T
        self.eos_id = eos_id
        self.device = params.device
        self.max_blocks = self.max_len // block_T  # logical blocks per slot
        self.n_blocks = n_blocks or (1 + slots * self.max_blocks)
        if self.n_blocks < 2:
            raise ValueError("n_blocks must be >= 2 (1 usable + trash)")
        # buckets stay block-aligned so that prefill scatters whole blocks
        self.min_prompt_bucket = max(1, min_prompt_bucket, block_T)

        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_tokens = int(spec_tokens) if draft_cfg is not None else 0
        if draft_cfg is not None:
            if self.spec_tokens < 1:
                raise ValueError(f"spec_tokens must be >= 1, got {spec_tokens}")
            if not draft_cfg.causal:
                raise ValueError("draft model must be causal")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size} — greedy verify compares token ids")
            if draft_cfg.max_len < self.max_len:
                raise ValueError(
                    f"draft positional range {draft_cfg.max_len} < pool "
                    f"max_len {self.max_len}")

        self._alloc = BlockAllocator(self.n_blocks)
        self._kc, self._vc = self._new_arena(cfg)
        self._dkc, self._dvc = (self._new_arena(draft_cfg)
                                if draft_cfg is not None else (None, None))
        # host state; what the step reads is long, as torch indexing wants it
        self._tables = np.zeros((slots, self.max_blocks), np.int64)
        self._active = np.zeros(slots, bool)
        self._positions = np.zeros(slots, np.int64)
        self._tokens = np.zeros(slots, np.int64)
        self._budget = np.zeros(slots, np.int32)    # max_new_tokens per slot
        self._emitted = np.zeros(slots, np.int32)   # tokens handed to the caller
        self._span = np.zeros(slots, np.int32)      # reserved position span
        self._nblocks = np.zeros(slots, np.int32)   # logical blocks owned
        self._cow_reserve = np.zeros(slots, np.int32)
        self._joined: Dict[int, Dict[int, int]] = {}  # slot -> {logical: phys}
        # cumulative speculative counters (0 forever on a plain pool)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.decode_traces = 0
        self.prefill_traces = 0
        self.graph_replays = 0
        self._prefill_buckets = set()
        # the fixed-signature step: static inputs, and on CUDA its graph and
        # static outputs; built at the first step
        self._step_inputs = None
        self._graph = None
        self._step_out = None
        self._decode_fn = self._decode
        self._prefill_fn = self._prefill
        self._copy_fn = self._copy

    def _new_arena(self, cfg: TransformerConfig):
        shape = (cfg.n_layers, self.n_blocks, self.block_T, cfg.n_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=cfg.compute_dtype, device=self.device),
                torch.zeros(shape, dtype=cfg.compute_dtype, device=self.device))

    def _arenas(self):
        if self.draft_cfg is None:
            return (self._kc, self._vc)
        return (self._kc, self._vc, self._dkc, self._dvc)

    # -- the decode step ---------------------------------------------------

    def _flat(self, arena):
        """Per-layer flat views [n_blocks*block_T, H, hd] of an arena."""
        return [arena[layer].view(-1, arena.shape[3], arena.shape[4])
                for layer in range(arena.shape[0])]

    def _step_body(self, tables, tokens, positions):
        """One decode step over the whole pool, on device tensors only: no
        host read, no check and no branch on tensor values, so that CUDA can
        capture it. Returns (nxt [S],) plain, or (ver [S,k+1], n_acc [S])."""
        NB, bT = self.n_blocks, self.block_T
        if self.draft_cfg is None:
            logits = _paged_forward(self.params, self.cfg, tokens[:, None], positions[:, None],
                                    self._flat(self._kc), self._flat(self._vc), tables, NB, bT)
            return (logits[:, 0].argmax(dim=-1),)
        k = self.spec_tokens
        dkf, dvf = self._flat(self._dkc), self._flat(self._dvc)
        # draft: k+1 chained single-token passes. Pass j takes window[j] at
        # position p+j; passes 0..k-1 propose d_1..d_k; pass k only writes
        # the draft's K/V at p+k, so a fully accepted round leaves no hole.
        window = [tokens]
        for j in range(k + 1):
            logits = _paged_forward(self.draft_params, self.draft_cfg, window[j][:, None],
                                    (positions + j)[:, None], dkf, dvf, tables, NB, bT,
                                    head=j < k)
            if j < k:
                window.append(logits[:, 0].argmax(dim=-1))
        win = torch.stack(window, dim=1)                                  # [S, k+1]
        pos_w = positions[:, None] + torch.arange(k + 1, device=positions.device)[None, :]
        # verify: one target forward over the window
        logits = _paged_forward(self.params, self.cfg, win, pos_w, self._flat(self._kc),
                                self._flat(self._vc), tables, NB, bT)
        ver = logits.argmax(dim=-1)                                       # [S, k+1]
        # greedy acceptance: d_i is accepted while it matches the target's
        # own greedy continuation; the emitted tokens are ver[:, :n_acc]
        match = (win[:, 1:] == ver[:, :-1]).long()
        n_acc = 1 + match.cumprod(dim=1).sum(dim=1)
        return ver, n_acc

    def _build_step(self) -> None:
        """Allocate the step's static inputs; on CUDA, warm the step up on a
        side stream and capture it as one graph. The warm-up runs on zero
        inputs: every table row is 0, so its K/V writes land in trash block
        0 and no live cell changes."""
        inputs = (torch.zeros((self.slots, self.max_blocks), dtype=torch.long, device=self.device),
                  torch.zeros(self.slots, dtype=torch.long, device=self.device),
                  torch.zeros(self.slots, dtype=torch.long, device=self.device))
        if self.device.type == "cuda":
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(_WARMUP_RUNS):
                    self._step_body(*inputs)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self._step_body(*inputs)
            self._graph, self._step_out = graph, out
        self._step_inputs = inputs
        self.decode_traces += 1

    @torch.inference_mode()
    def _decode(self, tables: np.ndarray, tokens: np.ndarray, positions: np.ndarray):
        """Run the step on host arrays; returns its outputs as numpy. On
        CUDA only as a replay of the captured graph (no eager fallback)."""
        if self._step_inputs is None:
            self._build_step()
        for buf, host in zip(self._step_inputs, (tables, tokens, positions)):
            buf.copy_(torch.from_numpy(host))
        if self.device.type == "cuda":
            self._graph.replay()
            self.graph_replays += 1
            out = self._step_out
        else:
            out = self._step_body(*self._step_inputs)
        return [t.cpu().numpy() for t in out]

    # -- prefill and copy-on-write (eager) ---------------------------------

    def _blocked(self, ks):
        """[L, 1, H, Tb, hd] -> [L, Tb//block_T, block_T, H, hd], the arena layout."""
        x = ks[:, 0].transpose(1, 2)
        L, Tb, H, hd = x.shape
        return x.reshape(L, Tb // self.block_T, self.block_T, H, hd)

    @torch.inference_mode()
    def _prefill(self, dest: np.ndarray, tokens: np.ndarray, length: int) -> int:
        dest_t = torch.from_numpy(dest).to(self.device)
        h, ks, vs = prefill_forward(self.params, tokens, self.cfg)
        models = [(ks, vs, self._kc, self._vc)]
        if self.draft_cfg is not None:
            _, dks, dvs = prefill_forward(self.draft_params, tokens, self.draft_cfg)
            models.append((dks, dvs, self._dkc, self._dvc))
        for k, v, kc, vc in models:
            kc.index_copy_(1, dest_t, self._blocked(k).to(kc.dtype))
            vc.index_copy_(1, dest_t, self._blocked(v).to(vc.dtype))
        last = h[0, length - 1]  # hidden state at the last real prompt position
        return int(_mlm_head(self.params, last[None], self.cfg)[0].argmax())

    @torch.inference_mode()
    def _copy(self, src: int, dst: int) -> None:
        for arena in self._arenas():
            arena[:, dst].copy_(arena[:, src])

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

    @property
    def total_blocks(self) -> int:
        """Usable arena blocks (trash excluded): the capacity an admission's
        worst-case block price is checked against."""
        return self.n_blocks - 1

    @property
    def admit_overhead_tokens(self) -> int:
        """Extra positions every admission reserves beyond prompt + max_new
        (the speculative lookahead)."""
        return self.spec_tokens

    def request_blocks(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case (no sharing) block price of a request."""
        span = prompt_len + max_new_tokens + self.spec_tokens
        return -(-span // self.block_T)

    def prompt_bucket(self, n: int) -> int:
        return min(self.max_len, bucket_size(n, min_bucket=self.min_prompt_bucket))

    def block_stats(self) -> Dict[str, int]:
        """Occupancy, sharing and speculation counters."""
        rc = self._alloc.refcount[1:]  # the trash block is bookkeeping, not capacity
        return {
            "blocks_total": self.total_blocks,
            "blocks_free": self._alloc.free_blocks,
            "cow_shared_blocks": int((rc > 1).sum()),
            "cow_saved_blocks": int(np.maximum(rc - 1, 0).sum()),
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
        }

    # -- admission planning ------------------------------------------------

    def _plan(self, toks: np.ndarray, max_new_tokens: int):
        """Price an admission: (span, nblocks, shared_full, tail_block,
        new_needed, reserve_needed). Raises ValueError for never-fits."""
        n = toks.shape[0]
        if n < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        span = n + max_new_tokens + self.spec_tokens
        if span > self.max_len:
            slack = (f" + {self.spec_tokens} speculative slack"
                     if self.spec_tokens else "")
            raise ValueError(
                f"prompt of {n} tokens + {max_new_tokens} new tokens{slack} "
                f"exceeds the {self.max_len}-position KV cache")
        bT = self.block_T
        nblocks = -(-span // bT)
        fb = n // bT
        shared_full: List[int] = []
        for i in range(fb):
            b = self._alloc.lookup(("full", toks[:(i + 1) * bT].tobytes()))
            if b is None:
                break
            shared_full.append(b)
        tail = None
        if len(shared_full) == fb and n % bT:
            tail = self._alloc.lookup(("tail", toks.tobytes()))
        new_needed = nblocks - len(shared_full) - (0 if tail is None else 1)
        reserve = 0 if tail is None else 1
        return span, nblocks, shared_full, tail, new_needed, reserve

    def can_admit(self, prompt, max_new_tokens: int = 1) -> bool:
        """Dry-run admission check (slot and blocks, prefix sharing counted).
        False means "not now"; a never-fits request raises the ValueError
        ``admit`` would."""
        toks = np.asarray(prompt, np.int32).reshape(-1)
        _, _, _, _, new_needed, reserve = self._plan(toks, max_new_tokens)
        if not (~self._active).any():
            return False
        return self._alloc.free_blocks >= new_needed + reserve

    # -- lifecycle ---------------------------------------------------------

    def admit(self, prompt, max_new_tokens: int = 1):
        """Prefill ``prompt`` into a free slot, paying only for blocks the
        prefix index does not hold. Returns ``(slot, first_token)``. Raises
        ``ValueError`` (never fits, or an id outside [0, vocab_size)),
        ``RuntimeError`` (no free slot), :class:`NoFreeBlocksError` (no
        blocks now: re-queueable) or ``KvCacheLostError`` (the prefill failed
        part-way; the pool has reset itself)."""
        ids = np.asarray(prompt, np.int64).reshape(-1)
        toks = ids.astype(np.int32)  # prefix keys: int32 bytes, as in JAX
        span, nblocks, shared_full, tail, new_needed, reserve = \
            self._plan(toks, max_new_tokens)
        # JAX clamps such ids; on the card a gather would hit a device-side
        # assert that poisons the CUDA context, so they are refused here
        if ids.min() < 0 or ids.max() >= self.cfg.vocab_size:
            raise ValueError(f"token ids must lie in [0, {self.cfg.vocab_size})")
        n = toks.shape[0]
        free = np.flatnonzero(~self._active)
        if free.size == 0:
            raise RuntimeError("no free decode slot")
        if self._alloc.free_blocks < new_needed + reserve:
            raise NoFreeBlocksError(
                f"admission needs {new_needed} new KV blocks"
                f"{f' (+{reserve} CoW reserve)' if reserve else ''} but only "
                f"{self._alloc.free_blocks} of {self.total_blocks} are free")
        slot = int(free[0])
        bT = self.block_T
        fb = n // bT

        new_blocks = self._alloc.alloc(new_needed)
        for b in shared_full:
            self._alloc.ref(b)
        row = np.zeros(self.max_blocks, np.int64)
        li = 0
        for b in shared_full:
            row[li] = b
            li += 1
        joined: Dict[int, int] = {}
        if tail is not None:
            self._alloc.ref(tail)
            self._alloc.reserved += 1
            self._cow_reserve[slot] = 1
            joined[li] = tail  # the logical tail block: copied before its first write
            row[li] = tail
            li += 1
        for b in new_blocks:
            row[li] = b
            li += 1

        bucket = self.prompt_bucket(n)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = toks
        # prefill scatters whole blocks; shared blocks (and the bucket's
        # overshoot past the reservation) go to trash block 0, so a sharer's
        # prefill cannot overwrite live K/V
        shared_set = set(shared_full) | ({tail} if tail is not None else set())
        dest = np.zeros(bucket // bT, np.int64)
        for j in range(bucket // bT):
            if j < nblocks and row[j] not in shared_set:
                dest[j] = row[j]
        if bucket not in self._prefill_buckets:
            self._prefill_buckets.add(bucket)
            self.prefill_traces += 1
        try:
            first = self._prefill_fn(dest, padded, n)
        except Exception as e:
            self._reset_after_failure()
            raise KvCacheLostError(
                f"prefill failed part-way through the in-place arena update "
                f"({type(e).__name__}: {e}); cache reset, in-flight "
                f"sequences lost") from e

        # publish this prompt's freshly written blocks for later sharers
        for i in range(len(shared_full), fb):
            self._alloc.register(("full", toks[:(i + 1) * bT].tobytes()), int(row[i]))
        if n % bT and tail is None:
            self._alloc.register(("tail", toks.tobytes()), int(row[fb]))

        self._tables[slot] = row
        self._active[slot] = True
        self._positions[slot] = n
        self._tokens[slot] = first
        self._budget[slot] = max_new_tokens
        self._emitted[slot] = 1
        self._span[slot] = span
        self._nblocks[slot] = nblocks
        self._joined[slot] = joined
        return slot, first

    def _cow_before_write(self, slot: int, p_lo: int, p_hi: int) -> None:
        """Copy any joined shared block that this step writes into (positions
        p_lo..p_hi inclusive) into the block reserved at admission. The
        original registrant keeps writing in place: every sharer of a tail
        block has the identical prompt, masks positions past its length, and
        copies before its own first write."""
        bT = self.block_T
        joined = self._joined.get(slot)
        if not joined:
            return
        for lb in range(p_lo // bT, p_hi // bT + 1):
            old = joined.pop(lb, None)
            if old is None:
                continue
            if self._cow_reserve[slot] > 0:
                self._cow_reserve[slot] -= 1
                self._alloc.reserved -= 1
            new = self._alloc.alloc(1)[0]
            try:
                self._copy_fn(old, new)
            except Exception as e:
                self._reset_after_failure()
                raise KvCacheLostError(
                    f"copy-on-write failed part-way through the arena update "
                    f"({type(e).__name__}: {e}); cache reset, in-flight "
                    f"sequences lost") from e
            self._tables[slot, lb] = new
            self._alloc.unref(old)

    def step(self) -> Dict[int, List[int]]:
        """Advance every live slot through one fixed-signature step.

        Returns ``{slot: [tokens...]}``: one token plain, up to
        ``spec_tokens + 1`` speculative, clamped to the slot's remaining
        ``max_new_tokens`` budget. The caller decides retirement (EOS,
        budget) and calls :meth:`release`."""
        live = np.flatnonzero(self._active)
        if live.size == 0:
            return {}
        window = self.spec_tokens + 1 if self.draft_cfg is not None else 1
        if (self._positions[live] + window > self._span[live]).any():
            raise RuntimeError(
                "a live slot is at the end of its reserved block span — the "
                "caller must retire sequences at their token budget")
        for s in live:
            s = int(s)
            self._cow_before_write(s, int(self._positions[s]),
                                   int(self._positions[s]) + window - 1)
        try:
            out_arrays = self._decode_fn(self._tables, self._tokens, self._positions)
        except Exception as e:
            self._reset_after_failure()
            raise KvCacheLostError(
                f"decode step failed part-way through the in-place arena "
                f"update ({type(e).__name__}: {e}); cache reset, in-flight "
                f"sequences lost") from e
        out: Dict[int, List[int]] = {}
        if self.draft_cfg is None:
            (nxt,) = out_arrays
            for slot in live:
                slot = int(slot)
                out[slot] = [int(nxt[slot])]
                self._positions[slot] += 1
                self._tokens[slot] = nxt[slot]
                self._emitted[slot] += 1
            return out
        ver, n_acc = out_arrays
        for slot in live:
            slot = int(slot)
            na = int(n_acc[slot])
            self.spec_proposed += self.spec_tokens
            self.spec_accepted += na - 1
            remaining = int(self._budget[slot] - self._emitted[slot])
            take = min(na, max(remaining, 0))
            out[slot] = [int(t) for t in ver[slot, :take]]
            self._positions[slot] += na
            self._tokens[slot] = ver[slot, na - 1]
            self._emitted[slot] += take
        return out

    def release(self, slot: int) -> None:
        """Free a slot: drop its block references (shared blocks survive
        while another sequence holds them), return any unused CoW reserve,
        and clear its table row."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        for lb in range(int(self._nblocks[slot])):
            self._alloc.unref(int(self._tables[slot, lb]))
        self._alloc.reserved -= int(self._cow_reserve[slot])
        self._cow_reserve[slot] = 0
        self._tables[slot] = 0
        self._active[slot] = False
        self._positions[slot] = 0
        self._tokens[slot] = 0
        self._budget[slot] = 0
        self._emitted[slot] = 0
        self._span[slot] = 0
        self._nblocks[slot] = 0
        self._joined.pop(slot, None)

    def _reset_after_failure(self) -> None:
        """Recover from a failed call: the arenas are updated in place, so a
        call that failed part-way may have left some layers written and
        others not. Zero them in place, build a fresh allocator (the prefix
        index dies with the K/V it pointed at) and free every slot. The
        in-flight sequences are lost; the pool keeps serving.

        A captured graph is kept: the reset changes no address that it
        recorded (arenas zeroed in place, the same static inputs), so the
        next step replays it without a new capture."""
        for arena in self._arenas():
            arena.zero_()
        self._alloc = BlockAllocator(self.n_blocks)
        self._tables[:] = 0
        self._active[:] = False
        self._positions[:] = 0
        self._tokens[:] = 0
        self._budget[:] = 0
        self._emitted[:] = 0
        self._span[:] = 0
        self._nblocks[:] = 0
        self._cow_reserve[:] = 0
        self._joined.clear()
