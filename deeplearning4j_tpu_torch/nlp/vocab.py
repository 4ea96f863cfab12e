"""Vocabulary: cache, constructor, Huffman coding.

Counterpart of ``deeplearning4j_tpu/nlp/vocab.py``, host code kept as it is
there: the same indices (count descending, then the word), counts, and
Huffman codes and points, so that tables trained by either package line up
row for row.
"""

from __future__ import annotations

import heapq
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional


@dataclass
class VocabWord:
    word: str
    count: int = 1
    index: int = -1
    # hierarchical-softmax Huffman path (codes = bits, points = inner nodes)
    codes: List[int] = field(default_factory=list)
    points: List[int] = field(default_factory=list)


class VocabCache:
    """AbstractCache parity: word↔index maps, frequencies, total counts."""

    def __init__(self):
        self.words: Dict[str, VocabWord] = {}
        self._index: List[str] = []
        self.total_word_count = 0

    def add_token(self, word: str, count: int = 1):
        if word in self.words:
            self.words[word].count += count
        else:
            self.words[word] = VocabWord(word, count)
        self.total_word_count += count

    def finalize_vocab(self, min_word_frequency: int = 1, limit: Optional[int] = None):
        kept = [w for w in self.words.values() if w.count >= min_word_frequency]
        kept.sort(key=lambda w: (-w.count, w.word))
        if limit:
            kept = kept[:limit]
        self.words = {w.word: w for w in kept}
        self._index = [w.word for w in kept]
        for i, w in enumerate(kept):
            w.index = i
        return self

    def num_words(self) -> int:
        return len(self._index)

    def word_at_index(self, i: int) -> str:
        return self._index[i]

    def index_of(self, word: str) -> int:
        w = self.words.get(word)
        return -1 if w is None else w.index

    def contains_word(self, word: str) -> bool:
        return word in self.words

    def word_frequency(self, word: str) -> int:
        w = self.words.get(word)
        return 0 if w is None else w.count

    def vocab_words(self) -> List[VocabWord]:
        return [self.words[w] for w in self._index]

    # DL4J naming
    numWords = num_words
    wordAtIndex = word_at_index
    indexOf = index_of
    containsWord = contains_word
    wordFrequency = word_frequency


class VocabConstructor:
    """Corpus scan → VocabCache (VocabConstructor.buildJointVocabulary)."""

    def __init__(self, tokenizer_factory=None, min_word_frequency: int = 1,
                 limit: Optional[int] = None):
        from .tokenization import DefaultTokenizerFactory

        self.tok = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.limit = limit

    def build_vocab(self, sentences: Iterable[str]) -> VocabCache:
        counts = Counter()
        for s in sentences:
            counts.update(self.tok.create(s).get_tokens())
        cache = VocabCache()
        for w, c in counts.items():
            cache.add_token(w, c)
        cache.finalize_vocab(self.min_word_frequency, self.limit)
        return cache

    buildJointVocabulary = build_vocab


class Huffman:
    """Huffman tree over word frequencies → per-word (codes, points) for
    hierarchical softmax (org.deeplearning4j.models.word2vec.Huffman)."""

    def __init__(self, words: List[VocabWord]):
        self.words = words

    def build(self):
        n = len(self.words)
        if n == 0:
            return
        # heap of (count, tiebreak, node_id); leaves are 0..n-1, inner n..2n-2
        heap = [(w.count, i, i) for i, w in enumerate(self.words)]
        heapq.heapify(heap)
        parent = {}
        binary = {}
        next_id = n
        while len(heap) > 1:
            c1, _, a = heapq.heappop(heap)
            c2, _, b = heapq.heappop(heap)
            parent[a], parent[b] = next_id, next_id
            binary[a], binary[b] = 0, 1
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = heap[0][2]
        for i, w in enumerate(self.words):
            codes, points = [], []
            node = i
            while node != root:
                codes.append(binary[node])
                p = parent[node]
                points.append(p - n)  # inner-node index
                node = p
            w.codes = codes[::-1]
            w.points = points[::-1]
        return self

    apply_indexes = build
    applyIndexes = build
