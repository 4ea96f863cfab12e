"""Word-vector serialization.

Counterpart of ``deeplearning4j_tpu/nlp/word_vectors.py``: the classic
word2vec text layout ("<count> <dim>\\n" then "word v1 v2 ..."), byte for
byte the JAX package's, so a file written by either package reads into the
other.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from .vocab import VocabCache

if TYPE_CHECKING:
    from .word2vec import Word2Vec


class WordVectorSerializer:
    @staticmethod
    def write_word_vectors(w2v: "Word2Vec", path: str):
        V, D = w2v.syn0.shape
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{V} {D}\n")
            for i in range(V):
                word = w2v.vocab.word_at_index(i)
                vec = " ".join(f"{x:.6f}" for x in w2v.syn0[i])
                f.write(f"{word} {vec}\n")

    writeWordVectors = write_word_vectors

    @staticmethod
    def read_word_vectors(path: str) -> "Word2Vec":
        from .word2vec import Word2Vec

        from .vocab import VocabWord

        with open(path, encoding="utf-8") as f:
            header = f.readline().split()
            V, D = int(header[0]), int(header[1])
            w2v = Word2Vec(layer_size=D)
            vocab = VocabCache()
            syn0 = np.zeros((V, D), np.float32)
            for i in range(V):
                parts = f.readline().rstrip("\n").split(" ")
                # preserve FILE order as the index order (rows match syn0)
                vocab.words[parts[0]] = VocabWord(parts[0], 1, i)
                vocab._index.append(parts[0])
                vocab.total_word_count += 1
                syn0[i] = np.asarray([float(x) for x in parts[1 : D + 1]], np.float32)
        w2v.vocab = vocab
        w2v.syn0 = syn0
        w2v.syn1neg = np.zeros_like(syn0)
        return w2v

    readWordVectors = read_word_vectors
    loadTxtVectors = read_word_vectors
