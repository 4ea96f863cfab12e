"""NLP: tokenization, vocabulary, Word2Vec and the SequenceVectors family,
GloVe, ParagraphVectors, t-SNE, tf-idf, and the BERT input pipeline.

Counterpart of ``deeplearning4j_tpu/nlp`` with the same public names. The
trainers (``Word2Vec``, ``ParagraphVectors``, ``Glove``, ``SequenceVectors``,
``BarnesHutTsne``) take ``device`` (default ``"cuda"``) and return numpy
arrays; ``Word2Vec(mesh=...)`` owns its tables' rows in blocks over a
``parallel.mesh.Mesh``.
"""

from .bert_iterator import BertIterator, BertMaskedLMMasker
from .tokenization import (
    BertWordPieceTokenizer,
    CommonPreprocessor,
    DefaultTokenizerFactory,
    Tokenizer,
)
from .vocab import Huffman, VocabCache, VocabConstructor, VocabWord
from .sequencevectors import (
    AbstractSequenceIterator,
    GraphWalkIterator,
    Sequence,
    SequenceElement,
    SequenceIterator,
    SequenceVectors,
)
from .word2vec import Word2Vec
from .word_vectors import WordVectorSerializer

__all__ = [
    "Tokenizer",
    "DefaultTokenizerFactory",
    "CommonPreprocessor",
    "BertWordPieceTokenizer",
    "VocabWord",
    "VocabCache",
    "VocabConstructor",
    "Huffman",
    "Word2Vec",
    "SequenceVectors",
    "SequenceElement",
    "Sequence",
    "SequenceIterator",
    "AbstractSequenceIterator",
    "GraphWalkIterator",
    "WordVectorSerializer",
    "BertIterator",
    "BertMaskedLMMasker",
]
