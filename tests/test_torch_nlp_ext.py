"""The rest of the port's NLP package against the JAX package, on the CPU:
GloVe, ParagraphVectors, SequenceVectors, tf-idf and t-SNE.

- ``Glove``: the embedding (w + w~) and ``loss_curve`` within 1e-5;
- ``ParagraphVectors``, DM and DBOW: document vectors, syn0, syn1neg and
  ``infer_vector`` within 1e-5, ``nearest_labels`` equal; DBOW with
  ``train_words`` refused as the JAX package refuses it;
- ``SequenceVectors`` over a ``GraphWalkIterator`` (the same walks) with
  sequence vectors: element and sequence vectors within 1e-5; over text, the
  same vectors as the port's ``Word2Vec`` (the JAX package's own
  equivalence, ``tests/test_sequencevectors.py``);
- ``TfidfVectorizer``: the same vocabulary, idf and rows;
- t-SNE: the symmetrised P within 1e-6 absolute (float32 bisection, 50
  steps, exp and log of two libraries), and 10 steps of ``_tsne_run`` from a
  shared start (learning rate 5, exaggeration 12) within 1e-5 of the
  embedding's scale and each step's KL within 1e-5 relative. The bound is
  for a short run: the gains and early exaggeration amplify a rounding
  difference about tenfold per step once the points spread (at learning
  rate 100 the two sides part by 1e-5 after 3 steps and fully by 20).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nlp as J
from deeplearning4j_tpu.nlp import glove as JG
from deeplearning4j_tpu.nlp import paragraph_vectors as JP
from deeplearning4j_tpu.nlp import tfidf as JF
from deeplearning4j_tpu.nlp import tsne as JT
from deeplearning4j_tpu_torch import nlp as T
from deeplearning4j_tpu_torch.nlp import glove as TG
from deeplearning4j_tpu_torch.nlp import paragraph_vectors as TP
from deeplearning4j_tpu_torch.nlp import tfidf as TF
from deeplearning4j_tpu_torch.nlp import tsne as TT
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)
from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-5
ANIMALS = ["cat", "dog", "fox", "wolf", "bear", "lion"]
TOOLS = ["hammer", "wrench", "drill", "saw", "pliers", "chisel"]


def topic_corpus(n=160, seed=0):
    rs = np.random.RandomState(seed)
    return [" ".join(rs.choice(ANIMALS if rs.rand() < 0.5 else TOOLS, size=rs.randint(5, 10)))
            for _ in range(n)]


def topic_docs(n=40, seed=1):
    rs = np.random.RandomState(seed)
    return [(f"{'animal' if i % 2 == 0 else 'tool'}_{i}",
             " ".join(rs.choice(ANIMALS if i % 2 == 0 else TOOLS, size=rs.randint(8, 14))))
            for i in range(n)]


def test_glove_matches_jax():
    sents = topic_corpus()
    kw = dict(layer_size=12, window=4, epochs=6, learning_rate=0.1, batch_size=64, seed=7)
    j = JG.Glove(**kw).fit(sents)
    t = TG.Glove(device="cpu", **kw).fit(sents)
    np.testing.assert_allclose(t.syn0, j.syn0, rtol=0, atol=ATOL)
    np.testing.assert_allclose(t.loss_curve, j.loss_curve, rtol=ATOL, atol=0)
    assert t.loss_curve[-1] < t.loss_curve[0]
    assert t.words_nearest("cat", 3) == j.words_nearest("cat", 3)
    built = (TG.Glove.Builder().layer_size(4).window_size(2).epochs(1).x_max(50.0).seed(1)
             .device("cpu").iterate(sents[:20]).build().fit())
    assert built.get_word_vector("cat").shape == (4,)


@pytest.mark.parametrize("dm", [True, False], ids=["dm", "dbow"])
def test_paragraph_vectors_match_jax(dm):
    docs = topic_docs()
    kw = dict(layer_size=12, window=3, epochs=6, learning_rate=0.05, batch_size=64, seed=5,
              dm=dm, train_words=dm)
    j = JP.ParagraphVectors(**kw).fit(docs)
    t = TP.ParagraphVectors(device="cpu", **kw).fit(docs)
    for name in ("doc_vectors", "syn0", "syn1neg"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name), rtol=0, atol=ATOL,
                                   err_msg=name)
    text = "cat dog wolf bear cat lion dog"
    jv = j.infer_vector(text, steps=30, learning_rate=0.1)
    tv = t.infer_vector(text, steps=30, learning_rate=0.1)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=ATOL)
    assert np.abs(jv - t.infer_vector(text, steps=0)).max() > 50 * ATOL  # trained
    assert t.nearest_labels(tv, 5) == j.nearest_labels(jv, 5)
    assert t.similarity("animal_0", "tool_1") == pytest.approx(
        j.similarity("animal_0", "tool_1"), abs=1e-4)


def test_paragraph_vectors_refuse_dbow_with_word_training():
    for pkg in (JP, TP):
        kw = {} if pkg is JP else {"device": "cpu"}
        with pytest.raises(ValueError, match="PV-DBOW"):
            pkg.ParagraphVectors(dm=False, train_words=True, **kw).fit(topic_docs(4))
    pv = (TP.ParagraphVectors.Builder().sequence_learning_algorithm("PV-DBOW")
          .train_words_vectors(False).layer_size(4).epochs(1).device("cpu").build())
    assert (pv.dm, pv.train_words, pv.device) == (False, False, "cpu")


ADJ = {"cat": ["dog", "pet"], "dog": ["cat", "pet"], "pet": ["cat", "dog"],
       "car": ["bus", "road"], "bus": ["car", "road"], "road": ["car", "bus"]}


def test_sequencevectors_over_graph_walks_match_jax():
    jw = J.GraphWalkIterator(ADJ, walk_length=6, walks_per_node=8, seed=1)
    tw = T.GraphWalkIterator(ADJ, walk_length=6, walks_per_node=8, seed=1)
    walks = [s.labels() for s in tw]
    assert walks == [s.labels() for s in jw] and walks == [s.labels() for s in tw]
    kw = dict(layer_size=12, window=3, negative=4, learning_rate=0.1, epochs=3, seed=42,
              batch_size=128, train_sequence_vectors=True)
    j = J.SequenceVectors(**kw).fit(jw)
    t = T.SequenceVectors(device="cpu", **kw).fit(tw)
    for node in ADJ:
        np.testing.assert_allclose(t.get_element_vector(node), j.get_element_vector(node),
                                   rtol=0, atol=ATOL)
    for i in (0, 5, 17):
        np.testing.assert_allclose(t.get_sequence_vector(str(i)), j.get_sequence_vector(str(i)),
                                   rtol=0, atol=ATOL)
    assert t.words_nearest("cat", 2) == j.words_nearest("cat", 2)


def test_sequencevectors_equal_word2vec_on_text():
    corpus = topic_corpus(120, seed=3)
    it = T.AbstractSequenceIterator.from_token_lists([s.split() for s in corpus],
                                                     labels=[f"S{i}" for i in range(120)])
    sv = (T.SequenceVectors.Builder().layer_size(16).window_size(3).negative_sample(4)
          .epochs(2).seed(7).batch_size(256).elements_learning_algorithm("SkipGram")
          .device("cpu").iterate(it).build().fit())
    w2v = T.Word2Vec(layer_size=16, window=3, negative=4, epochs=2, seed=7, batch_size=256,
                     subsampling=0.0, device="cpu").fit(corpus)
    for w in ("cat", "saw", "lion"):
        np.testing.assert_array_equal(sv.get_element_vector(w), w2v.get_word_vector(w))
    assert sv.vocab.num_words() == 12
    with pytest.raises(ValueError, match="train_sequence_vectors"):
        sv.get_sequence_vector("S0")
    seq = T.Sequence()
    seq.add_element(T.SequenceElement("a"))
    seq.set_sequence_label(T.SequenceElement("L"))
    assert (seq.labels(), seq.sequence_label.get_label()) == (["a"], "L")


def test_tfidf_matches_jax():
    texts = topic_corpus(30, seed=4) + ["cat cat saw", "unknown words only"]
    for kw in (dict(), dict(min_word_frequency=3, max_features=7, normalize=False)):
        j = JF.TfidfVectorizer(**kw)
        t = TF.TfidfVectorizer(**kw)
        want = j.fit_transform(iter(texts))
        got = t.fit_transform(iter(texts))
        assert t.vocab_ == j.vocab_
        np.testing.assert_array_equal(t.idf_, j.idf_)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t.transform(["cat dog", "drill"]),
                                      j.transform(["cat dog", "drill"]))


def _blobs(n_per=20, seed=0):
    rs = np.random.RandomState(seed)
    centers = np.array([[6.0] * 8, [-6.0] * 8, [6.0] * 4 + [-6.0] * 4])
    return np.concatenate([c + rs.randn(n_per, 8) for c in centers]).astype(np.float32)


def test_tsne_affinities_match_jax():
    x = _blobs()
    n = x.shape[0]
    jp = np.asarray(JT._cond_probs(JT._pairwise_sq_dists(jnp.asarray(x)), 10.0))
    tx = torch.from_numpy(x)
    tp = TT._cond_probs(TT._pairwise_sq_dists(tx), 10.0).numpy()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.sum(1), 1.0, atol=1e-5)
    # the entropy of each row matches the perplexity the bisection aimed at
    h = -(tp * np.log(np.maximum(tp, 1e-30))).sum(1)
    np.testing.assert_allclose(np.exp(h), 10.0, rtol=1e-3)
    psym = (tp + tp.T) / (2.0 * n)
    assert np.allclose(psym, psym.T) and abs(psym.sum() - 1.0) < 1e-5


def test_tsne_run_from_shared_start_matches_jax():
    x = _blobs()
    n = x.shape[0]
    p = TT._cond_probs(TT._pairwise_sq_dists(torch.from_numpy(x)), 10.0)
    p_sym = ((p + p.T) / (2.0 * n)).numpy()
    ts = TT.BarnesHutTsne(perplexity=10, n_iter=10, learning_rate=5.0, seed=3, device="cpu")
    y0 = ts._initial_y(n)
    assert torch.equal(y0, TT.BarnesHutTsne(seed=3, device="cpu")._initial_y(n))
    kw = dict(n_iter=10, learning_rate=5.0, momentum_final=0.8, exaggeration=12.0,
              exaggeration_iters=5)
    jy, jkl = JT._tsne_run(jnp.asarray(p_sym), jnp.asarray(y0.numpy()), **kw)
    ty, tkl = TT._tsne_run(torch.from_numpy(p_sym), y0, **kw)
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=ATOL * np.abs(jy).max())
    np.testing.assert_allclose(tkl.numpy(), np.asarray(jkl), rtol=ATOL, atol=0)
    assert np.abs(jy).max() > 100 * np.abs(y0.numpy()).max()  # it moved
    y = ts.fit_transform(x)
    assert y.shape == (n, 2) and ts.kl_curve_.shape == (10,)
    np.testing.assert_allclose(y, ty.numpy(), rtol=0, atol=1e-6 * np.abs(y).max())
