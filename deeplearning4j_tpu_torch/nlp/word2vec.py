"""Word2Vec: skip-gram or CBOW, with negative sampling and/or hierarchical
softmax (all four combinations train).

Counterpart of ``deeplearning4j_tpu/nlp/word2vec.py``. The host side is
kept as it is there (vocabulary, subsampling, the dynamic windows, the
unigram^0.75 sample table, one ``np.random.RandomState(seed)`` drawing in
the same order), so the same corpus and seed give the same examples,
batches and negatives in both packages. The device side is torch:

- each update rule is a function on the tables (``[V, D]`` float32
  tensors, updated in place): gather the rows of a batch, sigmoid dots,
  then :func:`_mean_scatter` the row updates, ``index_add_`` at every size
  (the JAX package switches to a one-hot matmul below a TPU-measured
  threshold; that threshold is not carried over);
- an epoch is :func:`_w2v_epoch`, a loop over the batches on the device:
  every batch is uploaded once before it, and nothing inside it reads a
  value back to the host;
- ``Word2Vec(mesh=...)`` owns the rows of each table in blocks over the
  mesh's first axis (:class:`RowBlocks`), replicated where that axis does
  not divide the table's rows, as the JAX package places them.
"""

from __future__ import annotations

import functools
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..common.device import DEFAULT_DEVICE, resolve_device
from .tokenization import DefaultTokenizerFactory
from .vocab import Huffman, VocabCache, VocabConstructor


def _upload(a, device) -> torch.Tensor:
    """A host array on ``device``; integer arrays as int64 (the index type)."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _mean_scatter(table, contribs):
    """``table`` += duplicate-averaged row updates, in place (returns
    ``table``). ``contribs`` is a list of (idx [B], val [B, D], weight [B] or
    None): every contribution to a row is divided by the row's total
    (weighted) touch count, and all of them are added in one
    ``index_add_``.

    Averaged, as in the JAX package: a batched scatter-sum applies every
    duplicate at stale values and diverges when the vocabulary is small
    against the batch."""
    idx, val, wt = _concat(table, contribs)
    cnt = torch.zeros(table.shape[0], dtype=table.dtype, device=table.device)
    cnt.index_add_(0, idx, wt).clamp_(min=1.0)
    return table.index_add_(0, idx, val / cnt[idx][:, None])


def _concat(table, contribs):
    """The contributions as one (idx [N], val [N, D], weight [N])."""
    idx = torch.cat([i.reshape(-1) for i, _, _ in contribs])
    val = torch.cat([v for _, v, _ in contribs])
    wt = torch.cat([torch.ones(i.shape[0], dtype=table.dtype, device=table.device)
                    if w is None else w for i, _, w in contribs])
    return idx, val, wt


class RowBlocks:
    """Where each table's rows live: in blocks over ``mesh``'s first axis.

    Rank ``r`` of that axis (size A) holds rows ``[r V/A, (r+1) V/A)`` of a
    table of V rows; a table whose rows the axis does not divide is held
    whole by every rank (replicated, as the JAX package's ``_place_table``
    leaves it). Every rank runs the same update on the same batch:
    :meth:`gather` reads the rows it owns, zeros elsewhere, and one
    all-reduce over the axis completes the rows of every gathered table;
    :meth:`scatter` adds to its own rows only. The adds of zeros and the
    sum with zeros are exact, so the tables are those of one process."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.size = mesh.shape[self.axis]
        self.index = mesh.coords[self.axis]
        self._lo = {}  # id(local table) -> its first global row

    def place(self, table: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``table`` (all of them when replicated)."""
        V = table.shape[0]
        if V % self.size:
            return table
        n = V // self.size
        local = table[self.index * n:(self.index + 1) * n].clone()
        self._lo[id(local)] = self.index * n
        return local

    def _local(self, table, idx):
        n = table.shape[0]
        local = idx - self._lo[id(table)]
        own = (local >= 0) & (local < n)
        return local.clamp(0, n - 1), own

    def gather(self, pairs):
        from ..parallel.collectives import psum
        from ..parallel.mesh import use_mesh

        out, parts = [], []
        for table, idx in pairs:
            if id(table) not in self._lo:
                out.append(table[idx])
                continue
            li, own = self._local(table, idx)
            part = torch.where(own[..., None], table[li], 0.0)
            out.append(None)
            parts.append(part)
        if parts:
            flat = torch.cat([p.reshape(-1) for p in parts])
            with use_mesh(self.mesh):
                flat = psum(flat, self.axis)
            it = iter(parts)
            offset = 0
            for k, got in enumerate(out):
                if got is None:
                    p = next(it)
                    out[k] = flat[offset:offset + p.numel()].view(p.shape)
                    offset += p.numel()
        return out

    def scatter(self, table, contribs):
        if id(table) not in self._lo:
            return _mean_scatter(table, contribs)
        idx, val, wt = _concat(table, contribs)
        li, own = self._local(table, idx)
        cnt = torch.zeros(table.shape[0], dtype=table.dtype, device=table.device)
        cnt.index_add_(0, li, torch.where(own, wt, 0.0)).clamp_(min=1.0)
        return table.index_add_(0, li, torch.where(own[:, None], val, 0.0) / cnt[li][:, None])

    def read(self, table) -> np.ndarray:
        """The whole table on every rank (a collective when sharded)."""
        if id(table) not in self._lo:
            return table.cpu().numpy()
        from ..parallel.collectives import all_gather
        from ..parallel.mesh import use_mesh

        with use_mesh(self.mesh):
            return all_gather(table, self.axis, axis=0).cpu().numpy()


def _gather(rows, *pairs):
    if rows is None:
        return [t[i] for t, i in pairs]
    return rows.gather(pairs)


def _scatter(rows, table, contribs):
    if rows is None:
        return _mean_scatter(table, contribs)
    return rows.scatter(table, contribs)


def _sgns_update(syn0, syn1, targets, contexts, negatives, lr, rows=None):
    """One batched skip-gram negative-sampling update, in place.

    targets/contexts: [B] int64; negatives: [B, neg] int64. Positive pairs
    take label 1 on (context's syn0 row, target's syn1 row), negatives 0."""
    w, pos, negs = _gather(rows, (syn0, contexts), (syn1, targets), (syn1, negatives))
    gp = (1.0 - torch.sigmoid((w * pos).sum(-1))) * lr                  # [B]
    gn = -torch.sigmoid(torch.einsum("bd,bnd->bn", w, negs)) * lr      # [B, neg]
    dw = gp[:, None] * pos + torch.einsum("bn,bnd->bd", gn, negs)
    _scatter(rows, syn0, [(contexts, dw, None)])
    _scatter(rows, syn1, [(targets, gp[:, None] * w, None)] + [
        (negatives[:, n], gn[:, n, None] * w, None) for n in range(negatives.shape[1])])
    return syn0, syn1


def _sg_hs_update(syn0, syn1h, contexts, points, codes, pmask, lr, rows=None):
    """Skip-gram hierarchical-softmax update, in place: the context word's
    syn0 row walks the target's Huffman path (points/codes/pmask [B, L]);
    g = (1 - code - sigmoid(w·syn1h[point])) * lr per path node."""
    w, s = _gather(rows, (syn0, contexts), (syn1h, points))
    f = torch.sigmoid(torch.einsum("bd,bld->bl", w, s))
    g = (1.0 - codes - f) * lr * pmask                                  # [B, L]
    dw = torch.einsum("bl,bld->bd", g, s)
    _scatter(rows, syn0, [(contexts, dw, None)])
    _scatter(rows, syn1h, [(points[:, l], g[:, l, None] * w, pmask[:, l])
                           for l in range(points.shape[1])])
    return syn0, syn1h


def _cbow_hidden(cvecs, cmask):
    """Mean of the gathered context rows [B, C, D] under ``cmask`` [B, C]."""
    cnt = torch.clamp(cmask.sum(-1, keepdim=True), min=1.0)
    return (cvecs * cmask[..., None]).sum(1) / cnt


def _cbow_scatter_ctx(syn0, ctx, cmask, neu1e, rows=None):
    """The accumulated input gradient to every unmasked context row."""
    return _scatter(rows, syn0, [(ctx[:, c], neu1e * cmask[:, c, None], cmask[:, c])
                                 for c in range(ctx.shape[1])])


def _cbow_ns_update(syn0, syn1, targets, ctx, cmask, negatives, lr, rows=None):
    """CBOW negative-sampling update, in place: hidden = mean of the context
    rows; label 1 on the target's syn1neg row, 0 on the negatives."""
    cvecs, pos, negs = _gather(rows, (syn0, ctx), (syn1, targets), (syn1, negatives))
    h = _cbow_hidden(cvecs, cmask)
    gp = (1.0 - torch.sigmoid((h * pos).sum(-1))) * lr
    gn = -torch.sigmoid(torch.einsum("bd,bnd->bn", h, negs)) * lr
    neu1e = gp[:, None] * pos + torch.einsum("bn,bnd->bd", gn, negs)
    _cbow_scatter_ctx(syn0, ctx, cmask, neu1e, rows)
    _scatter(rows, syn1, [(targets, gp[:, None] * h, None)] + [
        (negatives[:, n], gn[:, n, None] * h, None) for n in range(negatives.shape[1])])
    return syn0, syn1


def _cbow_hs_update(syn0, syn1h, targets_points, targets_codes, pmask, ctx, cmask, lr,
                    rows=None):
    """CBOW hierarchical-softmax update, in place: hidden = mean of the
    context rows, walking the target word's Huffman path."""
    cvecs, s = _gather(rows, (syn0, ctx), (syn1h, targets_points))
    h = _cbow_hidden(cvecs, cmask)
    f = torch.sigmoid(torch.einsum("bd,bld->bl", h, s))
    g = (1.0 - targets_codes - f) * lr * pmask
    neu1e = torch.einsum("bl,bld->bd", g, s)
    _cbow_scatter_ctx(syn0, ctx, cmask, neu1e, rows)
    _scatter(rows, syn1h, [(targets_points[:, l], g[:, l, None] * h, pmask[:, l])
                           for l in range(targets_points.shape[1])])
    return syn0, syn1h


def _w2v_epoch(syn0, syn1, syn1h, tj, cj, cmj, negs, points, codes, pmask, lrs, *,
               use_ns: bool, use_hs: bool, cbow: bool, rows=None):
    """One epoch on the device, the tables updated in place.

    tj: [S, B] targets; cj: [S, B] contexts (skip-gram) or [S, B, C] windows
    (CBOW); cmj: [S, B, C] window masks (CBOW); negs: [S, B, neg];
    points/codes/pmask: [V, L] Huffman path tables (HS); lrs: [S]. All on
    the tables' device: the loop launches work and reads nothing back. With
    CBOW and both objectives the HS update reads the syn0 that the NS update
    has just written, as in the JAX package's scan body."""
    for s in range(tj.shape[0]):
        t, cx, lr = tj[s], cj[s], lrs[s]
        if cbow:
            cm = cmj[s]
            if use_ns:
                _cbow_ns_update(syn0, syn1, t, cx, cm, negs[s], lr, rows)
            if use_hs:
                _cbow_hs_update(syn0, syn1h, points[t], codes[t], pmask[t], cx, cm, lr, rows)
        else:
            if use_ns:
                _sgns_update(syn0, syn1, t, cx, negs[s], lr, rows)
            if use_hs:
                _sg_hs_update(syn0, syn1h, cx, points[t], codes[t], pmask[t], lr, rows)
    return syn0, syn1, syn1h


class Word2Vec:
    def __init__(self, layer_size: int = 100, window: int = 5, min_word_frequency: int = 1,
                 negative: int = 5, subsampling: float = 1e-3, learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4, epochs: int = 1, batch_size: int = 512,
                 seed: int = 42, tokenizer_factory=None, cbow: bool = False,
                 hs: bool = False, mesh=None, device=DEFAULT_DEVICE):
        if negative <= 0 and not hs:
            raise ValueError(
                "no training objective: set negative > 0 (negative sampling) "
                "and/or hs=True (hierarchical softmax)")
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.negative = negative
        self.subsampling = subsampling
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.tok = tokenizer_factory or DefaultTokenizerFactory()
        self.cbow = cbow
        self.hs = hs
        self.vocab: Optional[VocabCache] = None
        self.syn0: Optional[np.ndarray] = None
        self.syn1neg: Optional[np.ndarray] = None
        self.syn1: Optional[np.ndarray] = None  # HS inner-node table
        self._sample_table: Optional[np.ndarray] = None
        self._sentences = None
        # a parallel.mesh.Mesh: rows of the tables owned in blocks over its
        # first axis (RowBlocks)
        self.mesh = mesh
        self.device = device

    # ------------------------------------------------------------ builder

    class Builder:
        def __init__(self):
            self._kw = {}
            self._iter = None

        def layer_size(self, n):
            self._kw["layer_size"] = n
            return self

        layerSize = layer_size

        def window_size(self, n):
            self._kw["window"] = n
            return self

        windowSize = window_size

        def min_word_frequency(self, n):
            self._kw["min_word_frequency"] = n
            return self

        minWordFrequency = min_word_frequency

        def negative_sample(self, n):
            self._kw["negative"] = int(n)
            return self

        negativeSample = negative_sample

        def sampling(self, t):
            self._kw["subsampling"] = t
            return self

        def learning_rate(self, lr):
            self._kw["learning_rate"] = lr
            return self

        learningRate = learning_rate

        def epochs(self, n):
            self._kw["epochs"] = n
            return self

        def seed(self, s):
            self._kw["seed"] = s
            return self

        def batch_size(self, n):
            self._kw["batch_size"] = n
            return self

        batchSize = batch_size

        def tokenizer_factory(self, t):
            self._kw["tokenizer_factory"] = t
            return self

        tokenizerFactory = tokenizer_factory

        def cbow(self, flag: bool = True):
            """Train CBOW instead of skip-gram (DL4J: elementsLearningAlgorithm
            CBOW<VocabWord>)."""
            self._kw["cbow"] = bool(flag)
            return self

        def use_hierarchic_softmax(self, flag: bool = True):
            self._kw["hs"] = bool(flag)
            return self

        useHierarchicSoftmax = use_hierarchic_softmax

        def device(self, d):
            self._kw["device"] = d
            return self

        def iterate(self, sentences):
            self._iter = sentences
            return self

        def build(self) -> "Word2Vec":
            w = Word2Vec(**self._kw)
            w._sentences = self._iter
            return w

    # ---------------------------------------------------------------- fit

    def fit(self, sentences: Optional[Iterable[str]] = None) -> "Word2Vec":
        if sentences is None and self._sentences is None:
            raise ValueError("no corpus: pass sentences to fit() or Builder.iterate()")
        dev = resolve_device(self.device)
        sentences = list(sentences if sentences is not None else self._sentences)
        self.vocab = VocabConstructor(self.tok, self.min_word_frequency).build_vocab(sentences)
        V, D = self.vocab.num_words(), self.layer_size
        rs = np.random.RandomState(self.seed)
        rows = RowBlocks(self.mesh) if self.mesh is not None else None

        def place(a):
            t = _upload(a, dev)
            return t if rows is None else rows.place(t)

        up = functools.partial(_upload, device=dev)

        # InMemoryLookupTable.resetWeights: syn0 ~ U(-0.5,0.5)/dim, syn1 zeros
        self.syn0 = ((rs.rand(V, D).astype(np.float32) - 0.5) / D)
        syn0 = place(self.syn0)
        syn1 = syn1h = None
        points = codes = pmask = None
        dummy = torch.zeros((1, 1), dtype=torch.float32, device=dev)
        if self.negative > 0:
            self.syn1neg = np.zeros((V, D), np.float32)
            syn1 = place(self.syn1neg)
            self._build_sample_table()
        if self.hs:
            # Huffman paths → padded [V, L] (points, codes, mask) lookup
            Huffman(self.vocab.vocab_words()).build()
            words = self.vocab.vocab_words()
            L = max((len(w.codes) for w in words), default=1) or 1
            points = np.zeros((V, L), np.int32)
            codes = np.zeros((V, L), np.float32)
            pmask = np.zeros((V, L), np.float32)
            for i, w in enumerate(words):
                n = len(w.codes)
                points[i, :n] = w.points
                codes[i, :n] = w.codes
                pmask[i, :n] = 1.0
            self.syn1 = np.zeros((max(V - 1, 1), D), np.float32)
            syn1h = place(self.syn1)
            points, codes, pmask = up(points), up(codes), up(pmask)

        flat, sent_id = self._corpus_arrays(sentences, rs)
        if self.cbow:
            examples = self._training_examples_cbow_np(flat, sent_id, rs)
            n_raw = len(examples[0])
        else:
            examples = self._training_pairs_np(flat, sent_id, rs)
            n_raw = len(examples)
        total = n_raw * self.epochs
        done = 0
        for ep in range(self.epochs):
            # one permutation of the packed arrays (vectorized numpy)
            perm = rs.permutation(n_raw)
            if self.cbow:
                arr = tuple(a[perm] for a in examples)
            else:
                arr = examples[perm]
            n_ex = n_raw
            B = self.batch_size
            if n_ex % B:
                # pad the tail to the batch size with resampled rows (one
                # batch shape; duplicates are harmless SGD noise)
                pad_idx = rs.randint(0, n_ex, B - n_ex % B)
                if self.cbow:
                    arr = tuple(np.concatenate([a, a[pad_idx]]) for a in arr)
                    n_ex = len(arr[0])
                else:
                    arr = np.concatenate([arr, arr[pad_idx]])
                    n_ex = len(arr)
            # every batch of the epoch goes to the device at once; the epoch
            # loop then reads nothing back
            S = n_ex // B
            lrs = up(np.maximum(
                self.min_learning_rate,
                self.learning_rate
                * (1.0 - (done + np.arange(S) * B) / max(total, 1))).astype(np.float32))
            if self.cbow:
                tj = up(arr[0].reshape(S, B))
                cj = up(arr[1].reshape(S, B, -1))
                cmj = up(arr[2].reshape(S, B, -1))
            else:
                tj = up(arr[:, 0].reshape(S, B))
                cj = up(arr[:, 1].reshape(S, B))
                cmj = dummy
            negs_all = (up(self._sample_negatives(rs, n_ex).reshape(S, B, -1))
                        if syn1 is not None else dummy)
            _w2v_epoch(syn0, syn1 if syn1 is not None else dummy,
                       syn1h if syn1h is not None else dummy,
                       tj, cj, cmj, negs_all,
                       points if points is not None else dummy,
                       codes if codes is not None else dummy,
                       pmask if pmask is not None else dummy,
                       lrs, use_ns=self.negative > 0, use_hs=self.hs, cbow=self.cbow,
                       rows=rows)
            done += S * B
        read = (lambda t: t.cpu().numpy()) if rows is None else rows.read
        self.syn0 = read(syn0)
        if syn1 is not None:
            self.syn1neg = read(syn1)
        if syn1h is not None:
            self.syn1 = read(syn1h)
        return self

    def _corpus_arrays(self, sentences, rs):
        """Tokenize + index + subsample the whole corpus into flat arrays
        (``flat`` vocab indices, ``sent_id`` sentence membership), one
        vectorized keep-mask per sentence."""
        V = self.vocab.num_words()
        t = self.subsampling
        total = max(self.vocab.total_word_count, 1)
        counts = np.asarray([w.count for w in self.vocab.vocab_words()], np.float64)
        freq = np.maximum(counts / total, 1e-12)
        keep_p = (np.where(freq > t, (np.sqrt(freq / t) + 1) * (t / freq), 1.0)
                  if t > 0 else np.ones(V))
        flats, sids = [], []
        for si, s in enumerate(sentences):
            toks = self.tok.create(s).get_tokens()
            idxs = np.fromiter((self.vocab.index_of(tok) for tok in toks),
                               np.int64, count=len(toks))
            idxs = idxs[idxs >= 0]
            if t > 0 and idxs.size:
                idxs = idxs[rs.rand(idxs.size) < keep_p[idxs]]
            if idxs.size:
                flats.append(idxs)
                sids.append(np.full(idxs.size, si, np.int64))
        if not flats:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(flats), np.concatenate(sids)

    def _training_pairs_np(self, flat, sent_id, rs) -> np.ndarray:
        """All (target, context) pairs with a per-position dynamic window, in
        2*window vectorized passes over the whole corpus."""
        N = len(flat)
        if N == 0:
            return np.zeros((0, 2), np.int32)
        b = rs.randint(1, self.window + 1, N)
        tg, cx = [], []
        for off in range(1, self.window + 1):
            same = sent_id[:-off] == sent_id[off:]
            fwd = same & (b[:-off] >= off)   # target at i sees context i+off
            bwd = same & (b[off:] >= off)    # target at i+off sees context i
            tg.append(flat[:-off][fwd]); cx.append(flat[off:][fwd])
            tg.append(flat[off:][bwd]); cx.append(flat[:-off][bwd])
        return np.stack([np.concatenate(tg), np.concatenate(cx)], axis=1).astype(np.int32)

    def _training_examples_cbow_np(self, flat, sent_id, rs):
        """(targets [N], context windows [N, 2w], masks [N, 2w]) with a
        dynamic window, built with one gather over an offset grid."""
        w = self.window
        C = 2 * w
        N = len(flat)
        if N == 0:
            return (np.zeros(0, np.int32), np.zeros((0, C), np.int32),
                    np.zeros((0, C), np.float32))
        b = rs.randint(1, w + 1, N)
        offs = np.concatenate([np.arange(-w, 0), np.arange(1, w + 1)])      # [C]
        pos = np.arange(N)[:, None] + offs[None, :]                          # [N, C]
        clipped = np.clip(pos, 0, N - 1)
        valid = ((pos >= 0) & (pos < N)
                 & (sent_id[clipped] == sent_id[:, None])
                 & (np.abs(offs)[None, :] <= b[:, None]))
        ctx = np.where(valid, flat[clipped], 0).astype(np.int32)
        msk = valid.astype(np.float32)
        keep = msk.sum(axis=1) > 0
        return flat[keep].astype(np.int32), ctx[keep], msk[keep]

    def _build_sample_table(self, size: int = 1 << 20):
        counts = np.asarray([w.count for w in self.vocab.vocab_words()], np.float64)
        probs = counts ** 0.75
        probs /= probs.sum()
        self._sample_table = np.searchsorted(
            np.cumsum(probs), np.linspace(0, 1, size, endpoint=False)).astype(np.int32)

    def _sample_negatives(self, rs, batch: int) -> np.ndarray:
        idx = rs.randint(0, len(self._sample_table), size=(batch, self.negative))
        return self._sample_table[idx]

    # ------------------------------------------------------------ queries

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.syn0[i]

    getWordVectorMatrix = get_word_vector

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        return float(np.dot(va, vb) / (np.linalg.norm(va) * np.linalg.norm(vb) + 1e-12))

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        v = self.get_word_vector(word)
        if v is None:
            return []
        norms = self.syn0 / (np.linalg.norm(self.syn0, axis=1, keepdims=True) + 1e-12)
        sims = norms @ (v / (np.linalg.norm(v) + 1e-12))
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.word_at_index(int(i))
            if w != word:
                out.append(w)
            if len(out) >= n:
                break
        return out

    wordsNearest = words_nearest
