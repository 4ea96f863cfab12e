"""GloVe embeddings: window-weighted (1/distance) co-occurrence counts, then
AdaGrad weighted least squares on ``w_i·w~_j + b_i + b~_j - log X_ij``.

Counterpart of ``deeplearning4j_tpu/nlp/glove.py``. The counts are host
numpy as there (a dense V² code space, refused above 2^27 codes); an epoch
over the nonzero entries is a loop over the batches on the device, every
batch uploaded before it, the tables and AdaGrad state updated in place by
Word2Vec's :func:`~.word2vec._mean_scatter`.
"""

from __future__ import annotations

import functools
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..common.device import DEFAULT_DEVICE, resolve_device
from .tokenization import DefaultTokenizerFactory
from .vocab import VocabCache, VocabConstructor
from .word2vec import Word2Vec, _mean_scatter, _upload


def _glove_update(tables, wi, wj, logx, fweight, lr):
    """One batched AdaGrad step on the GloVe objective, in place; duplicate
    rows mean-aggregated. Each accumulator is updated before the step that
    reads it, as in the JAX package. Returns (tables, the batch's loss)."""
    w, wc, b, bc, gw, gwc, gb, gbc = tables
    vi, vj = w[wi], wc[wj]                      # [B, D]
    bi, bj = b[wi, 0], bc[wj, 0]                # [B] (bias tables are [V, 1])
    diff = (vi * vj).sum(-1) + bi + bj - logx
    g = fweight * diff                          # [B]

    dvi = g[:, None] * vj
    dvj = g[:, None] * vi
    dbi = g
    dbj = g

    # AdaGrad: accumulate squared grads per row, scale updates
    _mean_scatter(gw, [(wi, torch.square(dvi), None)])
    _mean_scatter(gwc, [(wj, torch.square(dvj), None)])
    _mean_scatter(gb, [(wi, torch.square(dbi)[:, None], None)])
    _mean_scatter(gbc, [(wj, torch.square(dbj)[:, None], None)])
    _mean_scatter(w, [(wi, -lr * dvi / torch.sqrt(gw[wi] + 1e-8), None)])
    _mean_scatter(wc, [(wj, -lr * dvj / torch.sqrt(gwc[wj] + 1e-8), None)])
    _mean_scatter(b, [(wi, (-lr * dbi)[:, None] / torch.sqrt(gb[wi] + 1e-8), None)])
    _mean_scatter(bc, [(wj, (-lr * dbj)[:, None] / torch.sqrt(gbc[wj] + 1e-8), None)])
    loss = 0.5 * torch.mean(fweight * torch.square(diff))
    return tables, loss


def _glove_epoch(tables, wi_s, wj_s, logx_s, fw_s, lr):
    """One epoch on the device over [S, B] batches; returns the [S] losses
    (a device tensor: nothing is read back inside the loop)."""
    losses = []
    for s in range(wi_s.shape[0]):
        _, loss = _glove_update(tables, wi_s[s], wj_s[s], logx_s[s], fw_s[s], lr)
        losses.append(loss)
    return tables, torch.stack(losses)


class Glove:
    """org.deeplearning4j.models.glove.Glove parity surface."""

    def __init__(self, layer_size: int = 100, window: int = 5,
                 min_word_frequency: int = 1, learning_rate: float = 0.05,
                 epochs: int = 5, batch_size: int = 4096, x_max: float = 100.0,
                 alpha: float = 0.75, seed: int = 42, tokenizer_factory=None,
                 device=DEFAULT_DEVICE):
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.x_max = x_max
        self.alpha = alpha
        self.seed = seed
        self.tok = tokenizer_factory or DefaultTokenizerFactory()
        self.device = device
        self.vocab: Optional[VocabCache] = None
        self.syn0: Optional[np.ndarray] = None

    class Builder:
        def __init__(self):
            self._kw = {}
            self._iter = None

        def layer_size(self, n):
            self._kw["layer_size"] = n; return self  # noqa: E702

        def window_size(self, n):
            self._kw["window"] = n; return self  # noqa: E702

        def min_word_frequency(self, n):
            self._kw["min_word_frequency"] = n; return self  # noqa: E702

        def learning_rate(self, lr):
            self._kw["learning_rate"] = lr; return self  # noqa: E702

        def epochs(self, n):
            self._kw["epochs"] = n; return self  # noqa: E702

        def x_max(self, v):
            self._kw["x_max"] = v; return self  # noqa: E702

        def seed(self, s):
            self._kw["seed"] = s; return self  # noqa: E702

        def device(self, d):
            self._kw["device"] = d; return self  # noqa: E702

        def iterate(self, sentences):
            self._iter = sentences; return self  # noqa: E702

        def build(self) -> "Glove":
            g = Glove(**self._kw)
            g._sentences = self._iter
            return g

    # -------------------------------------------------------- cooccurrence

    def _cooccurrences(self, sentences, rs):
        """Window-weighted counts as COO arrays — bincount over fused i*V+j
        codes (AbstractCoOccurrences, vectorized)."""
        w2v_helper = Word2Vec.__new__(Word2Vec)
        w2v_helper.vocab = self.vocab
        w2v_helper.tok = self.tok
        w2v_helper.subsampling = 0.0
        flat, sent_id = w2v_helper._corpus_arrays(sentences, rs)
        V = self.vocab.num_words()
        if V * V > (1 << 27):
            raise ValueError(
                f"vocab {V}: dense cooccurrence code space V^2 exceeds the "
                "bincount budget — raise min_word_frequency")
        acc = np.zeros(V * V, np.float64)
        for off in range(1, self.window + 1):
            same = sent_id[:-off] == sent_id[off:]
            a, bb = flat[:-off][same], flat[off:][same]
            wgt = 1.0 / off
            np.add.at(acc, a * V + bb, wgt)
            np.add.at(acc, bb * V + a, wgt)
        nz = np.nonzero(acc)[0]
        return (nz // V).astype(np.int32), (nz % V).astype(np.int32), acc[nz]

    # ------------------------------------------------------------------ fit

    def fit(self, sentences: Optional[Iterable[str]] = None) -> "Glove":
        sentences = list(sentences if sentences is not None
                         else getattr(self, "_sentences", None) or [])
        if not sentences:
            raise ValueError("no corpus")
        dev = resolve_device(self.device)
        rs = np.random.RandomState(self.seed)
        self.vocab = VocabConstructor(self.tok, self.min_word_frequency).build_vocab(sentences)
        V, D = self.vocab.num_words(), self.layer_size
        wi, wj, x = self._cooccurrences(sentences, rs)
        logx = np.log(x).astype(np.float32)
        fw = np.minimum((x / self.x_max) ** self.alpha, 1.0).astype(np.float32)

        up = functools.partial(_upload, device=dev)

        def t(shape):
            return up((rs.rand(*shape).astype(np.float32) - 0.5) / D)

        def full(shape, value):
            return torch.full(shape, value, dtype=torch.float32, device=dev)

        # bias rows are [V,1] so _mean_scatter's [B,D] contract holds
        tables = (t((V, D)), t((V, D)), full((V, 1), 0.0), full((V, 1), 0.0),
                  full((V, D), 1e-8), full((V, D), 1e-8), full((V, 1), 1e-8), full((V, 1), 1e-8))
        n = len(wi)
        B = min(self.batch_size, max(n, 1))
        self.loss_curve: List[float] = []
        for _ in range(self.epochs):
            perm = rs.permutation(n)
            pad = (-n) % B
            idx = np.concatenate([perm, perm[:pad]]) if pad else perm
            S = len(idx) // B
            seg = lambda a: up(a[idx].reshape(S, B))  # noqa: E731
            tables, losses = _glove_epoch(tables, seg(wi), seg(wj), seg(logx), seg(fw),
                                          float(self.learning_rate))
            self.loss_curve.append(float(losses.mean()))
        # final embedding = w + w~ (GloVe paper §4.2)
        self.syn0 = tables[0].cpu().numpy() + tables[1].cpu().numpy()
        return self

    # -------------------------------------------------------------- queries

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.syn0[i]

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
        return [self.vocab.word_at_index(int(i)) for i in np.argsort(-sims)
                if self.vocab.word_at_index(int(i)) != word][:n]
