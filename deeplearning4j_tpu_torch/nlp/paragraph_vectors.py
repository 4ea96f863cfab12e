"""ParagraphVectors (doc2vec): PV-DM (the document vector and the context
mean predict the target word) and PV-DBOW (the document vector alone
predicts each word), negative sampling, and ``infer_vector`` for unseen
documents (word tables frozen, a fresh document vector trained).

Counterpart of ``deeplearning4j_tpu/nlp/paragraph_vectors.py``. The host
side (vocabulary, windows, the sample table, one ``RandomState(seed)`` in
the same order) is kept as it is there; the document table is one more row
table updated by Word2Vec's :func:`~.word2vec._mean_scatter`, an epoch is a
loop over the batches on the device with every batch uploaded before it,
and inference is a loop of ``steps`` updates of one vector.
"""

from __future__ import annotations

import functools
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..common.device import DEFAULT_DEVICE, resolve_device
from .tokenization import DefaultTokenizerFactory
from .vocab import VocabCache, VocabConstructor
from .word2vec import Word2Vec, _cbow_scatter_ctx, _mean_scatter, _upload


def _pv_update(doc_table, syn0, syn1, docs, ctx, cmask, targets, negs, lr,
               *, dm: bool, train_words: bool, freeze_words: bool = False):
    """One batched PV step, the tables updated in place. dm: hidden =
    mean(doc row, context rows); dbow: hidden = doc row. Negative sampling
    on the target's syn1 row. Every gather reads the tables from before the
    step."""
    dvec = doc_table[docs]                                    # [B, D]
    if dm:
        cvecs = syn0[ctx] * cmask[..., None]
        cnt = cmask.sum(-1, keepdim=True) + 1.0               # +1 = doc slot
        h = (cvecs.sum(1) + dvec) / cnt
    else:
        h = dvec
    pos = syn1[targets]
    nv = syn1[negs]
    gp = (1.0 - torch.sigmoid((h * pos).sum(-1))) * lr
    gn = -torch.sigmoid(torch.einsum("bd,bnd->bn", h, nv)) * lr
    neu1e = gp[:, None] * pos + torch.einsum("bn,bnd->bd", gn, nv)

    _mean_scatter(doc_table, [(docs, neu1e, None)])
    if dm and train_words and not freeze_words:
        _cbow_scatter_ctx(syn0, ctx, cmask, neu1e)
    if not freeze_words:
        _mean_scatter(syn1, [(targets, gp[:, None] * h, None)] + [
            (negs[:, n], gn[:, n, None] * h, None) for n in range(negs.shape[1])])
    return doc_table, syn0, syn1


def _pv_epoch(doc_table, syn0, syn1, docs_s, ctx_s, cm_s, tgt_s, neg_s, lrs,
              *, dm: bool, train_words: bool):
    """One epoch on the device over [S, B, ...] batches; reads nothing back."""
    for s in range(docs_s.shape[0]):
        _pv_update(doc_table, syn0, syn1, docs_s[s], ctx_s[s], cm_s[s], tgt_s[s], neg_s[s],
                   lrs[s], dm=dm, train_words=train_words)
    return doc_table, syn0, syn1


def _infer_scan(dvec0, syn0, syn1, ctx, cmask, targets, negs, lr, *, steps: int, dm: bool):
    """inferVector: train ONE frozen-word document vector for ``steps``
    passes over the text's windows. ``dm`` must match the trained model: a
    PV-DBOW model's syn0 context rows were never trained."""
    table = dvec0.clone()[None, :]
    docs = torch.zeros((targets.shape[0],), dtype=torch.int64, device=targets.device)
    for _ in range(steps):
        _pv_update(table, syn0, syn1, docs, ctx, cmask, targets, negs, lr, dm=dm,
                   train_words=False, freeze_words=True)
    return table[0]


class ParagraphVectors:
    def __init__(self, layer_size: int = 100, window: int = 5,
                 min_word_frequency: int = 1, negative: int = 5,
                 learning_rate: float = 0.025, min_learning_rate: float = 1e-4,
                 epochs: int = 20, batch_size: int = 256, seed: int = 42,
                 dm: bool = True, train_words: bool = True, tokenizer_factory=None,
                 device=DEFAULT_DEVICE):
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.negative = negative
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.dm = dm                      # PV-DM (False → PV-DBOW)
        self.train_words = train_words
        self.tok = tokenizer_factory or DefaultTokenizerFactory()
        self.device = device
        self.vocab: Optional[VocabCache] = None
        self.labels: List[str] = []
        self.doc_vectors: Optional[np.ndarray] = None
        self.syn0: Optional[np.ndarray] = None
        self.syn1neg: Optional[np.ndarray] = None
        self._sample_table: Optional[np.ndarray] = None

    class Builder:
        def __init__(self):
            self._kw = {}
            self._docs = None

        def layer_size(self, n):
            self._kw["layer_size"] = n; return self  # noqa: E702

        def window_size(self, n):
            self._kw["window"] = n; return self  # noqa: E702

        def min_word_frequency(self, n):
            self._kw["min_word_frequency"] = n; return self  # noqa: E702

        def negative_sample(self, n):
            self._kw["negative"] = int(n); return self  # noqa: E702

        def learning_rate(self, lr):
            self._kw["learning_rate"] = lr; return self  # noqa: E702

        def epochs(self, n):
            self._kw["epochs"] = n; return self  # noqa: E702

        def seed(self, s):
            self._kw["seed"] = s; return self  # noqa: E702

        def sequence_learning_algorithm(self, algo: str):
            self._kw["dm"] = "DM" in algo.upper(); return self  # noqa: E702

        def train_words_vectors(self, flag: bool):
            self._kw["train_words"] = flag; return self  # noqa: E702

        def device(self, d):
            self._kw["device"] = d; return self  # noqa: E702

        def iterate(self, labelled_docs):
            self._docs = labelled_docs; return self  # noqa: E702

        def build(self) -> "ParagraphVectors":
            pv = ParagraphVectors(**self._kw)
            pv._docs = self._docs
            return pv

    # ------------------------------------------------------------------ fit

    def fit(self, documents: Optional[Iterable[Tuple[str, str]]] = None) -> "ParagraphVectors":
        """documents: iterable of (label, text)."""
        docs = list(documents if documents is not None
                    else getattr(self, "_docs", None) or [])
        if not docs:
            raise ValueError("no documents")
        if not self.dm and self.train_words:
            raise ValueError(
                "PV-DBOW does not train word vectors in this implementation "
                "(the reference interleaves a separate skip-gram pass); set "
                "train_words=False, or use dm=True, or train words with "
                "Word2Vec separately")
        dev = resolve_device(self.device)
        self.labels = [l for l, _ in docs]
        texts = [t for _, t in docs]
        rs = np.random.RandomState(self.seed)
        self.vocab = VocabConstructor(self.tok, self.min_word_frequency).build_vocab(texts)
        V, D = self.vocab.num_words(), self.layer_size
        n_docs = len(docs)
        helper = Word2Vec.__new__(Word2Vec)
        helper.vocab = self.vocab
        helper.tok = self.tok
        helper.subsampling = 0.0
        flat, sent_id = helper._corpus_arrays(texts, rs)
        # one document per input text → sent_id IS the document id
        tgt, ctx, cmask, row_doc = self._examples_with_docs(flat, sent_id, rs)

        counts = np.asarray([wd.count for wd in self.vocab.vocab_words()], np.float64)
        probs = counts ** 0.75
        probs /= probs.sum()
        self._sample_table = np.searchsorted(
            np.cumsum(probs), np.linspace(0, 1, 1 << 20, endpoint=False)).astype(np.int32)

        up = functools.partial(_upload, device=dev)
        doc_table = up((rs.rand(n_docs, D).astype(np.float32) - 0.5) / D)
        syn0 = up((rs.rand(V, D).astype(np.float32) - 0.5) / D)
        syn1 = torch.zeros((V, D), dtype=torch.float32, device=dev)

        n = len(tgt)
        B = min(self.batch_size, max(n, 1))
        total = n * self.epochs
        done = 0
        for _ in range(self.epochs):
            perm = rs.permutation(n)
            pad = (-n) % B
            idx = np.concatenate([perm, perm[:pad]]) if pad else perm
            S = len(idx) // B
            lrs = np.maximum(self.min_learning_rate,
                             self.learning_rate
                             * (1.0 - (done + np.arange(S) * B) / max(total, 1))
                             ).astype(np.float32)
            negs = self._sample_table[rs.randint(0, len(self._sample_table),
                                                 (S, B, self.negative))]
            seg = lambda a: up(a[idx].reshape(S, B, *a.shape[1:]))  # noqa: E731
            _pv_epoch(doc_table, syn0, syn1,
                      seg(row_doc.astype(np.int32)), seg(ctx), seg(cmask),
                      seg(tgt), up(negs), up(lrs),
                      dm=self.dm, train_words=self.train_words)
            done += S * B
        self.doc_vectors = doc_table.cpu().numpy()
        self.syn0 = syn0.cpu().numpy()
        self.syn1neg = syn1.cpu().numpy()
        return self

    def _examples_with_docs(self, flat, sent_id, rs):
        """CBOW-style rows + the document id of each row (vectorized)."""
        w = self.window
        C = 2 * w
        N = len(flat)
        if N == 0:
            z = np.zeros
            return (z(0, np.int32), z((0, C), np.int32), z((0, C), np.float32),
                    z(0, np.int32))
        b = rs.randint(1, w + 1, N)
        offs = np.concatenate([np.arange(-w, 0), np.arange(1, w + 1)])
        pos = np.arange(N)[:, None] + offs[None, :]
        clipped = np.clip(pos, 0, N - 1)
        valid = ((pos >= 0) & (pos < N)
                 & (sent_id[clipped] == sent_id[:, None])
                 & (np.abs(offs)[None, :] <= b[:, None]))
        ctx = np.where(valid, flat[clipped], 0).astype(np.int32)
        msk = valid.astype(np.float32)
        keep = msk.sum(axis=1) > 0
        return (flat[keep].astype(np.int32), ctx[keep], msk[keep],
                sent_id[keep].astype(np.int32))

    # ------------------------------------------------------------- queries

    def get_vector(self, label: str) -> Optional[np.ndarray]:
        if label not in self.labels:
            return None
        return self.doc_vectors[self.labels.index(label)]

    getVector = get_vector

    def infer_vector(self, text: str, steps: int = 20,
                     learning_rate: float = 0.05) -> np.ndarray:
        """ParagraphVectors.inferVector: word tables frozen, one fresh doc
        vector trained on the text's windows (on the model's device)."""
        dev = resolve_device(self.device)
        rs = np.random.RandomState(self.seed)
        helper_flat = np.asarray(
            [self.vocab.index_of(t) for t in self.tok.create(text).get_tokens()],
            np.int64)
        helper_flat = helper_flat[helper_flat >= 0]
        if helper_flat.size == 0:
            return np.zeros(self.layer_size, np.float32)
        sent = np.zeros(helper_flat.size, np.int64)
        tgt, ctx, cmask, _ = self._examples_with_docs(helper_flat, sent, rs)
        negs = self._sample_table[rs.randint(0, len(self._sample_table),
                                             (len(tgt), self.negative))]
        up = functools.partial(_upload, device=dev)
        dvec0 = up((rs.rand(self.layer_size).astype(np.float32) - 0.5) / self.layer_size)
        dvec = _infer_scan(dvec0, up(self.syn0), up(self.syn1neg), up(ctx), up(cmask),
                           up(tgt), up(negs), torch.tensor(learning_rate, dtype=torch.float32,
                                                           device=dev),
                           steps=steps, dm=self.dm)
        return dvec.cpu().numpy()

    inferVector = infer_vector

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_vector(a), self.get_vector(b)
        if va is None or vb is None:
            return float("nan")
        return float(np.dot(va, vb) / (np.linalg.norm(va) * np.linalg.norm(vb) + 1e-12))

    def nearest_labels(self, vec: np.ndarray, n: int = 5) -> List[str]:
        norms = self.doc_vectors / (np.linalg.norm(self.doc_vectors, axis=1,
                                                   keepdims=True) + 1e-12)
        sims = norms @ (vec / (np.linalg.norm(vec) + 1e-12))
        return [self.labels[i] for i in np.argsort(-sims)[:n]]
