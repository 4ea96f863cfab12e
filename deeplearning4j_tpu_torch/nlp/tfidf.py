"""TF-IDF vectorization.

Counterpart of ``deeplearning4j_tpu/nlp/tfidf.py`` (host numpy, as there):
fit a vocabulary and document frequencies over a corpus, transform texts
into tf-idf weighted bag-of-words rows. Smoothed idf = ln((1+N)/(1+df)) + 1,
optional L2 row normalization.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from .tokenization import DefaultTokenizerFactory


class TfidfVectorizer:
    def __init__(self, min_word_frequency: int = 1, max_features: Optional[int] = None,
                 normalize: bool = True, tokenizer_factory=None):
        self.min_word_frequency = min_word_frequency
        self.max_features = max_features
        self.normalize = normalize
        self.tok = tokenizer_factory or DefaultTokenizerFactory()
        self.vocab_: Dict[str, int] = {}
        self.idf_: Optional[np.ndarray] = None

    def _tokens(self, text: str) -> List[str]:
        return self.tok.create(text).get_tokens()

    def fit(self, texts: Iterable[str]) -> "TfidfVectorizer":
        texts = list(texts)
        df: Dict[str, int] = {}
        tf_total: Dict[str, int] = {}
        for t in texts:
            toks = self._tokens(t)
            for w in set(toks):
                df[w] = df.get(w, 0) + 1
            for w in toks:
                tf_total[w] = tf_total.get(w, 0) + 1
        words = [w for w, c in tf_total.items() if c >= self.min_word_frequency]
        words.sort(key=lambda w: (-tf_total[w], w))
        if self.max_features:
            words = words[: self.max_features]
        self.vocab_ = {w: i for i, w in enumerate(sorted(words))}
        n = len(texts)
        self.idf_ = np.asarray(
            [np.log((1 + n) / (1 + df[w])) + 1.0 for w in sorted(words)],
            np.float32)
        return self

    def transform(self, texts: Iterable[str]) -> np.ndarray:
        if self.idf_ is None:
            raise ValueError("fit() first")
        texts = list(texts)
        out = np.zeros((len(texts), len(self.vocab_)), np.float32)
        for i, t in enumerate(texts):
            for w in self._tokens(t):
                j = self.vocab_.get(w)
                if j is not None:
                    out[i, j] += 1.0
        out *= self.idf_[None, :]
        if self.normalize:
            out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
        return out

    def fit_transform(self, texts: Iterable[str]) -> np.ndarray:
        ts = list(texts)  # materialize ONCE: generators must survive both passes
        return self.fit(ts).transform(ts)

    fitTransform = fit_transform
