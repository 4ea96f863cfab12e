"""The generic SequenceVectors trainer and its element, sequence and
iterator classes.

Counterpart of ``deeplearning4j_tpu/nlp/sequencevectors.py``: any stream
of ``Sequence`` of ``SequenceElement`` trains element embeddings (skip-gram
or CBOW through :class:`~.word2vec.Word2Vec`) and, optionally, one vector
per sequence (PV-DM through :class:`~.paragraph_vectors.ParagraphVectors`).
``GraphWalkIterator`` is the non-text source: DeepWalk-style random walks
over an adjacency map.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence as Seq

import numpy as np

from ..common.device import DEFAULT_DEVICE


@dataclass
class SequenceElement:
    """ref: models.sequencevectors.sequence.SequenceElement (VocabWord's
    base): a label plus bookkeeping counters."""

    label: str
    element_frequency: float = 1.0

    def get_label(self) -> str:
        return self.label

    getLabel = get_label


@dataclass
class Sequence:
    """ref: models.sequencevectors.sequence.Sequence<T>."""

    elements: List[SequenceElement] = field(default_factory=list)
    sequence_label: Optional[SequenceElement] = None

    def add_element(self, e: SequenceElement) -> None:
        self.elements.append(e)

    addElement = add_element

    def set_sequence_label(self, e: SequenceElement) -> None:
        self.sequence_label = e

    setSequenceLabel = set_sequence_label

    def labels(self) -> List[str]:
        return [e.label for e in self.elements]


class SequenceIterator:
    """ref: sequencevectors.iterators.SequenceIterator — restartable stream."""

    def __iter__(self) -> Iterator[Sequence]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class AbstractSequenceIterator(SequenceIterator):
    """In-memory list of sequences (ref: AbstractSequenceIterator over an
    Iterable<Sequence<T>>)."""

    def __init__(self, sequences: Iterable[Sequence]):
        self._seqs = list(sequences)

    def __iter__(self):
        return iter(self._seqs)

    @staticmethod
    def from_token_lists(token_lists: Iterable[Seq[str]],
                         labels: Optional[Seq[str]] = None) -> "AbstractSequenceIterator":
        seqs = []
        for i, toks in enumerate(token_lists):
            s = Sequence([SequenceElement(t) for t in toks])
            if labels is not None:
                s.set_sequence_label(SequenceElement(labels[i]))
            seqs.append(s)
        return AbstractSequenceIterator(seqs)


class GraphWalkIterator(SequenceIterator):
    """DeepWalk-style random-walk sequence source — the canonical non-text
    SequenceVectors input (ref: deeplearning4j-graph RandomWalkIterator +
    DeepWalk, which feeds node sequences into SequenceVectors upstream).

    adjacency: dict node → list of neighbour nodes (labels are str(node)).
    """

    def __init__(self, adjacency: Dict, walk_length: int = 10,
                 walks_per_node: int = 5, seed: int = 0):
        self.adjacency = {k: list(v) for k, v in adjacency.items()}
        self.walk_length = walk_length
        self.walks_per_node = walks_per_node
        self.seed = seed

    def __iter__(self):
        rs = np.random.RandomState(self.seed)
        for _ in range(self.walks_per_node):
            for start in self.adjacency:
                node = start
                walk = [SequenceElement(str(node))]
                for _ in range(self.walk_length - 1):
                    nbrs = self.adjacency.get(node) or [node]
                    node = nbrs[rs.randint(len(nbrs))]
                    walk.append(SequenceElement(str(node)))
                yield Sequence(walk)


class SequenceVectors:
    """The shared trainer (ref: SequenceVectors.fit): vocab over element
    labels → Word2Vec's skip-gram/CBOW epochs on the device; optional PV-DM
    pass for sequence labels. Word2Vec == this over tokenized text;
    ParagraphVectors == this with sequence labels."""

    def __init__(self, layer_size: int = 100, window: int = 5,
                 min_element_frequency: int = 1, negative: int = 5,
                 learning_rate: float = 0.025, epochs: int = 1,
                 batch_size: int = 512, seed: int = 42, cbow: bool = False,
                 train_sequence_vectors: bool = False, device=DEFAULT_DEVICE):
        self.layer_size = layer_size
        self.window = window
        self.min_element_frequency = min_element_frequency
        self.negative = negative
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.cbow = cbow
        self.train_sequence_vectors = train_sequence_vectors
        self.device = device
        self._iterator: Optional[SequenceIterator] = None
        self._w2v = None
        self._pv = None

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

        def min_element_frequency(self, n):
            self._kw["min_element_frequency"] = n
            return self

        minElementFrequency = min_element_frequency

        def negative_sample(self, n):
            self._kw["negative"] = int(n)
            return self

        negativeSample = negative_sample

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

        def elements_learning_algorithm(self, algo: str):
            """'SkipGram' | 'CBOW' (ref: elementsLearningAlgorithm)."""
            self._kw["cbow"] = "CBOW" in algo.upper()
            return self

        elementsLearningAlgorithm = elements_learning_algorithm

        def train_sequences_representation(self, flag: bool = True):
            self._kw["train_sequence_vectors"] = bool(flag)
            return self

        trainSequencesRepresentation = train_sequences_representation

        def device(self, d):
            self._kw["device"] = d
            return self

        def iterate(self, iterator: SequenceIterator):
            self._iter = iterator
            return self

        def build(self) -> "SequenceVectors":
            sv = SequenceVectors(**self._kw)
            sv._iterator = self._iter
            return sv

    # ---------------------------------------------------------------- fit

    def fit(self, iterator: Optional[SequenceIterator] = None) -> "SequenceVectors":
        from .tokenization import DefaultTokenizerFactory
        from .word2vec import Word2Vec

        it = iterator or self._iterator
        if it is None:
            raise ValueError("no sequence iterator (Builder.iterate)")
        seqs = list(it)
        if not seqs:
            raise ValueError("empty sequence stream")
        # The engine consumes whitespace-tokenized text; element labels
        # become tokens 1:1 (labels must not contain whitespace — true for
        # vocab words, node ids, item ids alike)
        sentences = [" ".join(s.labels()) for s in seqs]
        self._w2v = Word2Vec(
            layer_size=self.layer_size, window=self.window,
            min_word_frequency=self.min_element_frequency,
            negative=self.negative, learning_rate=self.learning_rate,
            epochs=self.epochs, batch_size=self.batch_size, seed=self.seed,
            cbow=self.cbow, subsampling=0.0,
            tokenizer_factory=DefaultTokenizerFactory(), device=self.device)
        self._w2v.fit(sentences)

        if self.train_sequence_vectors:
            labels = [s.sequence_label.label if s.sequence_label else str(i)
                      for i, s in enumerate(seqs)]
            from .paragraph_vectors import ParagraphVectors

            self._pv = ParagraphVectors(
                layer_size=self.layer_size, window=self.window,
                min_word_frequency=self.min_element_frequency,
                negative=self.negative, learning_rate=self.learning_rate,
                epochs=max(self.epochs, 1), batch_size=self.batch_size,
                seed=self.seed, dm=True, train_words=False, device=self.device)
            self._pv.fit(list(zip(labels, sentences)))
        return self

    # ------------------------------------------------------------- lookup

    @property
    def vocab(self):
        return self._w2v.vocab if self._w2v else None

    def get_element_vector(self, label: str) -> np.ndarray:
        return self._w2v.get_word_vector(label)

    getElementVector = get_element_vector
    get_word_vector = get_element_vector

    def get_sequence_vector(self, label: str) -> np.ndarray:
        if self._pv is None:
            raise ValueError("train_sequence_vectors was off")
        return self._pv.get_vector(label)

    getSequenceVector = get_sequence_vector

    def similarity(self, a: str, b: str) -> float:
        return self._w2v.similarity(a, b)

    def words_nearest(self, label: str, n: int = 10):
        return self._w2v.words_nearest(label, n)

    wordsNearest = words_nearest
