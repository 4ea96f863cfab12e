"""How far the port's NLP trainers move when their scatter-adds run in
another order: the sensitivity behind ``chip_smoke.py`` phase 14's bounds
for the card against the CPU (the card's ``index_add_`` adds a row's
contributions with atomics, in no fixed order).

    python3 tests/torch_nlp_reorder.py [sentences]   (default 20000)

Each trainer of phase 14 fits on the CPU at phase 14's settings, once as it
is and then with every ``index_add_`` taking its rows in a shuffled order
(three shuffles, seeds 0-2), and the script prints, for each table, the
largest difference of a shuffled fit from the plain one relative to the
table's largest magnitude (and GloVe's largest relative loss difference).
CPU only; several minutes.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.nlp import GraphWalkIterator, SequenceVectors, Word2Vec  # noqa: E402
from deeplearning4j_tpu_torch.nlp.glove import Glove  # noqa: E402
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors  # noqa: E402

_index_add = torch.Tensor.index_add_


SHUFFLES = (0, 1, 2)


def _fit(make, shuffle_seed=None):
    """``make()`` with ``index_add_`` as it is (``shuffle_seed`` None) or
    taking its rows in an order drawn from ``shuffle_seed``."""
    gen = torch.Generator().manual_seed(0 if shuffle_seed is None else shuffle_seed)

    def index_add(self, dim, index, source, *a, **k):
        p = torch.randperm(index.shape[0], generator=gen)
        return _index_add(self, dim, index[p], source[p], *a, **k)

    torch.Tensor.index_add_ = _index_add if shuffle_seed is None else index_add
    try:
        return make()
    finally:
        torch.Tensor.index_add_ = _index_add


def _spread(make, tables):
    """{table: the largest relative difference of a shuffled fit}."""
    plain = _fit(make)
    out = {t: 0.0 for t in tables}
    fits = [_fit(make, k) for k in SHUFFLES]
    for f in fits:
        for t in tables:
            out[t] = max(out[t], _rel(tables[t](f), tables[t](plain)))
    return out, plain, fits


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def main(n_sentences=cs.W2V_SENTENCES):
    cs.W2V_SENTENCES = n_sentences
    sents = cs.w2v_corpus()
    kw = dict(cs.W2V_KW, device="cpu")
    attr = lambda name: (lambda m: getattr(m, name))  # noqa: E731
    for what, kwargs, tables in (("word2vec skip-gram NS", kw, ("syn0", "syn1neg")),
                                 ("word2vec CBOW+HS+NS", dict(kw, cbow=True, hs=True),
                                  ("syn0", "syn1neg", "syn1"))):
        spread, _, _ = _spread(lambda: Word2Vec(**kwargs).fit(sents),
                               {t: attr(t) for t in tables})
        print(what, spread, flush=True)
    spread, plain, fits = _spread(lambda: Glove(layer_size=100, window=5, epochs=2, seed=7,
                                                device="cpu").fit(sents),
                                  {"w + w~": attr("syn0")})
    loss = max(abs(a - b) / abs(b) for f in fits for a, b in zip(f.loss_curve, plain.loss_curve))
    print("GloVe", spread, "loss", loss, flush=True)
    docs = cs._topic_docs()
    spread, _, _ = _spread(lambda: ParagraphVectors(layer_size=100, window=5, epochs=10,
                                                    seed=11, device="cpu").fit(docs),
                           {t: attr(t) for t in ("doc_vectors", "syn0", "syn1neg")})
    print("ParagraphVectors", spread, flush=True)
    adj = cs._community_graph()
    spread, _, _ = _spread(lambda: SequenceVectors(
        layer_size=64, window=5, negative=5, epochs=2, batch_size=2048, seed=13,
        device="cpu").fit(GraphWalkIterator(adj, walk_length=20, walks_per_node=10, seed=2)),
        {"elements": lambda m: m._w2v.syn0})
    print("SequenceVectors", spread, flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
