"""The port's NLP core (``deeplearning4j_tpu_torch.nlp``) against the JAX
package's ``deeplearning4j_tpu.nlp``, on the CPU.

- tokenizers, WordPiece (with ``load_vocab`` from a file), the vocabulary
  and its Huffman codes and points: identical;
- ``_mean_scatter`` called directly on both sides in the JAX package's two
  branches (its one-hot matmul for V·B <= 2^27, its scatter-add above, at
  V = B = 2^14): within 1e-6;
- each of the four update rules on one batch with duplicate rows: within
  1e-6;
- ``Word2Vec`` fits in all six objective combinations (skip-gram or CBOW
  × negative sampling, hierarchical softmax or both), 2 epochs at layer 16:
  syn0, syn1neg and syn1 within 1e-5 (float32; the two sides add the same
  terms in another order);
- ``WordVectorSerializer`` files that cross between the packages both ways;
- ``BertIterator`` MultiDataSets equal array for array, for both tasks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nlp as J
from deeplearning4j_tpu.nlp import word2vec as JW
from deeplearning4j_tpu_torch import nlp as T
from deeplearning4j_tpu_torch.nlp import word2vec as TW
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)
from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIT_ATOL = 1e-5
STEP_ATOL = 1e-6


def zipf_corpus(n=300, vocab=60, seed=0):
    rs = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [" ".join(rs.choice(words, size=rs.randint(5, 12), p=p)) for _ in range(n)]


TEXTS = ["Hello, World! 123 foo.bar", "The quick (brown) fox; jumped over: the dog?",
         "it's 5 o'clock / [somewhere] |here|", "  spaced   out\ttabs\nnewline  "]


def test_tokenizers_are_identical(tmp_path):
    for pre in (None, "common"):
        jt = J.DefaultTokenizerFactory(J.CommonPreprocessor() if pre else None)
        tt = T.DefaultTokenizerFactory(T.CommonPreprocessor() if pre else None)
        for text in TEXTS:
            a, b = jt.create(text), tt.create(text)
            assert b.get_tokens() == a.get_tokens()
            assert b.count_tokens() == a.count_tokens()
            while a.has_more_tokens():
                assert b.next_token() == a.next_token()
            assert not b.has_more_tokens()
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "quick", "brown", "fox",
             "jump", "##ed", "##s", "over", "dog", ".", ",", "un", "##aff", "##able", "!"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(words) + "\n", encoding="utf-8")
    jv = J.BertWordPieceTokenizer.load_vocab(str(path))
    tv = T.BertWordPieceTokenizer.load_vocab(str(path))
    assert tv == jv
    for lower in (True, False):
        jw = J.BertWordPieceTokenizer(jv, lower_case=lower, max_input_chars=12)
        tw = T.BertWordPieceTokenizer(tv, lower_case=lower, max_input_chars=12)
        for text in TEXTS + ["The quick fox jumped, unaffable!", "zebra dogs " + "x" * 20]:
            toks = tw.tokenize(text)
            assert toks == jw.tokenize(text)
            assert tw.convert_tokens_to_ids(toks) == jw.convert_tokens_to_ids(toks)
            assert tw.create(text).get_tokens() == jw.create(text).get_tokens()


def test_vocab_and_huffman_are_identical():
    sents = zipf_corpus(200, 40, seed=3) + ["rare words here once", "a a b b c"]
    for mwf, limit in ((1, None), (2, None), (1, 17)):
        jv = J.VocabConstructor(min_word_frequency=mwf, limit=limit).build_vocab(sents)
        tv = T.VocabConstructor(min_word_frequency=mwf, limit=limit).build_vocab(sents)
        assert tv.num_words() == jv.num_words()
        assert tv.total_word_count == jv.total_word_count
        jw, tw = jv.vocab_words(), tv.vocab_words()
        J.Huffman(jw).build()
        T.Huffman(tw).build()
        for a, b in zip(jw, tw):
            assert (b.word, b.count, b.index, b.codes, b.points) == \
                (a.word, a.count, a.index, a.codes, a.points)
        for w in ("w0", "w7", "nope"):
            assert tv.index_of(w) == jv.index_of(w)
            assert tv.word_frequency(w) == jv.word_frequency(w)
            assert tv.contains_word(w) == jv.contains_word(w)


@pytest.mark.parametrize("V,B,D", [(512, 256, 8), (1 << 14, 1 << 14, 4)],
                         ids=["onehot_branch", "scatter_branch"])
def test_mean_scatter_matches_both_jax_branches(V, B, D):
    assert (V * B <= JW._ONEHOT_ELEMS_MAX) == (V == 512)
    rs = np.random.RandomState(V)
    table = rs.randn(V, D).astype(np.float32)
    contribs = [(rs.randint(0, V // 4, B).astype(np.int32), rs.randn(B, D).astype(np.float32),
                 None),
                (rs.randint(0, V, B).astype(np.int32), rs.randn(B, D).astype(np.float32),
                 (rs.rand(B) > 0.3).astype(np.float32))]
    want = np.asarray(JW._mean_scatter(jnp.asarray(table), [
        (jnp.asarray(i), jnp.asarray(v), None if w is None else jnp.asarray(w))
        for i, v, w in contribs]))
    got = TW._mean_scatter(torch.from_numpy(table.copy()), [
        (torch.from_numpy(i).long(), torch.from_numpy(v), None if w is None else
         torch.from_numpy(w)) for i, v, w in contribs]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=STEP_ATOL)
    assert np.abs(got - table).max() > 0.1  # the batch moved rows


def _rule_inputs(seed, V=48, D=12, B=64, neg=4, C=6, L=7):
    rs = np.random.RandomState(seed)
    f = lambda *s: (rs.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    ids = lambda *s: rs.randint(0, V, s).astype(np.int32)  # noqa: E731
    return {"syn0": f(V, D), "syn1": f(V, D), "syn1h": f(V - 1, D), "targets": ids(B),
            "contexts": ids(B), "negatives": ids(B, neg), "ctx": ids(B, C),
            "cmask": (rs.rand(B, C) > 0.3).astype(np.float32),
            "points": rs.randint(0, V - 1, (B, L)).astype(np.int32),
            "codes": (rs.rand(B, L) > 0.5).astype(np.float32),
            "pmask": (rs.rand(B, L) > 0.2).astype(np.float32), "lr": np.float32(0.2)}


RULES = {
    "sgns": (lambda m, a: m._sgns_update(a["syn0"], a["syn1"], a["targets"], a["contexts"],
                                         a["negatives"], a["lr"])),
    "sg_hs": (lambda m, a: m._sg_hs_update(a["syn0"], a["syn1h"], a["contexts"], a["points"],
                                           a["codes"], a["pmask"], a["lr"])),
    "cbow_ns": (lambda m, a: m._cbow_ns_update(a["syn0"], a["syn1"], a["targets"], a["ctx"],
                                               a["cmask"], a["negatives"], a["lr"])),
    "cbow_hs": (lambda m, a: m._cbow_hs_update(a["syn0"], a["syn1h"], a["points"], a["codes"],
                                               a["pmask"], a["ctx"], a["cmask"], a["lr"])),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_update_rule_matches_jax(rule):
    a = _rule_inputs(len(rule))
    want = RULES[rule](JW, {k: jnp.asarray(v) for k, v in a.items()})

    def tensor(v):
        t = torch.from_numpy(np.array(v))
        return t.long() if t.dtype == torch.int32 else t

    ta = {k: tensor(v) for k, v in a.items()}
    got = RULES[rule](TW, ta)
    for g, w, name in zip(got, want, ("syn0", "second table")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=STEP_ATOL, err_msg=name)
    assert np.abs(got[0].numpy() - a["syn0"]).max() > 1e-3


OBJECTIVES = {"sg_ns": (False, 5, False), "sg_hs": (False, 0, True), "sg_both": (False, 3, True),
              "cbow_ns": (True, 5, False), "cbow_hs": (True, 0, True),
              "cbow_both": (True, 3, True)}


@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_word2vec_fit_matches_jax(objective):
    cbow, neg, hs = OBJECTIVES[objective]
    sents = zipf_corpus(200)
    batch = {"sg_ns": 512, "cbow_both": 64}.get(objective, 256)
    kw = dict(layer_size=16, window=3, negative=neg, hs=hs, cbow=cbow, epochs=2,
              batch_size=batch, learning_rate=0.25, subsampling=0.02, seed=4)
    j = J.Word2Vec(**kw).fit(sents)
    t = T.Word2Vec(device="cpu", **kw).fit(sents)
    assert [w.word for w in t.vocab.vocab_words()] == [w.word for w in j.vocab.vocab_words()]
    V, D = j.syn0.shape
    start = {"syn0": (np.random.RandomState(4).rand(V, D).astype(np.float32) - 0.5) / D}
    for name in ("syn0", "syn1neg", "syn1"):
        want = getattr(j, name)
        if want is None:
            assert getattr(t, name) is None, name
            continue
        np.testing.assert_allclose(getattr(t, name), want, rtol=0, atol=FIT_ATOL, err_msg=name)
        # trained: every table moved far beyond the bound
        assert np.abs(want - start.get(name, 0.0)).max() > 50 * FIT_ATOL, name
    assert t.words_nearest("w3", 5) == j.words_nearest("w3", 5)
    assert t.similarity("w1", "w2") == pytest.approx(j.similarity("w1", "w2"), abs=1e-4)


def test_word_vector_files_cross_between_the_packages(tmp_path):
    sents = zipf_corpus(120)
    j = J.Word2Vec(layer_size=8, epochs=1, batch_size=64, seed=3).fit(sents)
    t = T.Word2Vec(layer_size=8, epochs=1, batch_size=64, seed=3, device="cpu").fit(sents)
    jp, tp = tmp_path / "jax.txt", tmp_path / "port.txt"
    J.WordVectorSerializer.write_word_vectors(j, str(jp))
    T.WordVectorSerializer.write_word_vectors(t, str(tp))
    from_jax = T.WordVectorSerializer.read_word_vectors(str(jp))
    from_port = J.WordVectorSerializer.read_word_vectors(str(tp))
    assert from_jax.device == "cuda"  # a read model keeps the port's default device
    np.testing.assert_array_equal(from_jax.syn0, J.WordVectorSerializer.read_word_vectors(
        str(jp)).syn0)
    np.testing.assert_allclose(from_port.syn0, t.syn0, atol=1e-6)
    for word in ("w0", "w5", "w11"):
        np.testing.assert_allclose(from_jax.get_word_vector(word), j.get_word_vector(word),
                                   atol=1e-6)
    # the port writes a model read from the JAX package's file byte for byte
    again = tmp_path / "again.txt"
    T.WordVectorSerializer.write_word_vectors(from_jax, str(again))
    assert again.read_bytes() == jp.read_bytes()


def _wp_vocab():
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "quick", "brown", "fox",
             "jump", "##ed", "##s", "over", "dog", ".", "lazy", "a", "cat"]
    return {w: i for i, w in enumerate(words)}


def _assert_mds_equal(a, b):
    for field in ("features", "labels", "features_masks", "labels_masks"):
        fa, fb = getattr(a, field), getattr(b, field)
        assert len(fa) == len(fb), field
        for x, y in zip(fa, fb):
            assert (x is None) == (y is None), field
            if x is not None:
                assert x.dtype == y.dtype, field
                np.testing.assert_array_equal(x, y, err_msg=field)


def test_bert_iterator_batches_are_identical():
    vocab = _wp_vocab()
    rs = np.random.RandomState(2)
    words = [w for w in vocab if not w.startswith("[") and not w.startswith("##")]
    sents = []
    for i in range(21):  # singles and pairs, short to cut at max_length
        s = " ".join(rs.choice(words, size=rs.randint(2, 14)))
        sents.append((s, " ".join(rs.choice(words, size=rs.randint(1, 9)))) if i % 3 == 0 else s)
    jtok, ttok = J.BertWordPieceTokenizer(vocab), T.BertWordPieceTokenizer(vocab)
    for task in ("UNSUPERVISED", "SEQ_CLASSIFICATION"):
        labels = list(rs.randint(0, 3, len(sents))) if task != "UNSUPERVISED" else None
        its = []
        for pkg, tok in ((J, jtok), (T, ttok)):
            kw = dict(labels=labels, n_classes=3) if labels is not None else dict(
                masker=pkg.BertMaskedLMMasker(mask_token_id=vocab["[MASK]"],
                                              vocab_size=len(vocab), seed=9))
            its.append(pkg.BertIterator(tokenizer=tok, sentences=sents, max_length=12,
                                        batch_size=4, task=task, **kw))
        jb, tb = list(its[0]), list(its[1])
        assert len(tb) == len(jb) == 6
        for a, b in zip(jb, tb):
            _assert_mds_equal(a, b)
        if task == "UNSUPERVISED":
            assert sum(float(m.labels_masks[0].sum()) for m in tb) >= len(sents)
    built = (T.BertIterator.Builder().tokenizer(ttok).sentence_provider(["the dog"])
             .length_handling("FIXED", 8).minibatch_size(2).task("UNSUPERVISED").build())
    assert (built.max_length, built.batch_size, built.task) == (8, 2, "UNSUPERVISED")
