"""BERT input pipeline: masked-LM masking + MultiDataSet iterator.

Counterpart of ``deeplearning4j_tpu/nlp/bert_iterator.py`` (host numpy, as
there, drawing from the masker's ``RandomState`` in the same order): task
UNSUPERVISED (masked LM through ``BertMaskedLMMasker``) or
SEQ_CLASSIFICATION, rows cut or padded to ``max_length``, yielding the
port's ``data.dataset.MultiDataSet`` of token ids, segment ids, the key
padding mask and the labels with their mask.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..data.dataset import MultiDataSet


class BertMaskedLMMasker:
    """BERT masking: mask_prob of positions; of those 80% → [MASK], 10% →
    random token, 10% → unchanged (BertMaskedLMMasker defaults)."""

    def __init__(self, mask_prob: float = 0.15, mask_token_id: int = 103,
                 vocab_size: int = 30522, seed: int = 12345,
                 prob_mask: float = 0.8, prob_random: float = 0.1):
        self.mask_prob = mask_prob
        self.mask_token_id = mask_token_id
        self.vocab_size = vocab_size
        self.rs = np.random.RandomState(seed)
        self.prob_mask = prob_mask
        self.prob_random = prob_random

    def mask_sequence(self, ids: np.ndarray, valid_mask: np.ndarray):
        """Returns (masked_ids, labels, lm_mask): labels = original ids,
        lm_mask = 1 where a prediction is required."""
        ids = ids.copy()
        candidates = np.nonzero(valid_mask)[0]
        n_mask = max(1, int(round(len(candidates) * self.mask_prob))) if len(candidates) else 0
        chosen = self.rs.choice(candidates, size=n_mask, replace=False) if n_mask else np.array([], int)
        labels = ids.copy()
        lm_mask = np.zeros_like(valid_mask, np.float32)
        for p in chosen:
            lm_mask[p] = 1.0
            r = self.rs.rand()
            if r < self.prob_mask:
                ids[p] = self.mask_token_id
            elif r < self.prob_mask + self.prob_random:
                ids[p] = self.rs.randint(0, self.vocab_size)
        return ids, labels, lm_mask


class BertIterator:
    """Builder-parity iterator producing MultiDataSets.

    task: "UNSUPERVISED" (masked LM) | "SEQ_CLASSIFICATION"
    features: [token_ids, segment_ids]; masks: [attention_mask];
    labels: masked-LM targets (+ lm_mask) or class one-hots.
    """

    def __init__(self, tokenizer, sentences: Sequence, max_length: int = 128,
                 batch_size: int = 32, task: str = "UNSUPERVISED",
                 masker: Optional[BertMaskedLMMasker] = None,
                 labels: Optional[Sequence[int]] = None, n_classes: int = 2,
                 pad_token_id: int = 0, cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 mask_token: str = "[MASK]"):
        self.tokenizer = tokenizer
        self.sentences = list(sentences)
        self.max_length = max_length
        self.batch_size = batch_size
        self.task = task
        self.masker = masker or BertMaskedLMMasker(
            vocab_size=len(tokenizer.vocab),
            mask_token_id=tokenizer.vocab.get(mask_token, 103))
        self.labels = list(labels) if labels is not None else None
        self.n_classes = n_classes
        self.pad_id = pad_token_id
        self.cls_id = tokenizer.vocab.get(cls_token, 101)
        self.sep_id = tokenizer.vocab.get(sep_token, 102)
        self._pos = 0

    # -- builder parity ----------------------------------------------------
    class Builder:
        def __init__(self):
            self._kw = {}

        def tokenizer(self, t):
            self._kw["tokenizer"] = t
            return self

        def sentence_provider(self, s):
            self._kw["sentences"] = s
            return self

        sentenceProvider = sentence_provider

        def length_handling(self, mode: str, max_length: int):
            self._kw["max_length"] = max_length
            return self

        lengthHandling = length_handling

        def minibatch_size(self, n: int):
            self._kw["batch_size"] = n
            return self

        minibatchSize = minibatch_size

        def task(self, t: str):
            self._kw["task"] = t
            return self

        def masker(self, m):
            self._kw["masker"] = m
            return self

        def build(self) -> "BertIterator":
            return BertIterator(**self._kw)

    # -- iteration ---------------------------------------------------------

    def reset(self):
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self.sentences)

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> MultiDataSet:
        if not self.has_next():
            raise StopIteration
        batch = self.sentences[self._pos : self._pos + self.batch_size]
        batch_labels = (self.labels[self._pos : self._pos + self.batch_size]
                        if self.labels is not None else None)
        self._pos += len(batch)
        return self._encode(batch, batch_labels)

    def _encode_one(self, text) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if isinstance(text, tuple):  # sentence pair
            t1 = self.tokenizer.convert_tokens_to_ids(self.tokenizer.tokenize(text[0]))
            t2 = self.tokenizer.convert_tokens_to_ids(self.tokenizer.tokenize(text[1]))
            ids = [self.cls_id] + t1 + [self.sep_id] + t2 + [self.sep_id]
            segs = [0] * (len(t1) + 2) + [1] * (len(t2) + 1)
        else:
            t1 = self.tokenizer.convert_tokens_to_ids(self.tokenizer.tokenize(text))
            ids = [self.cls_id] + t1 + [self.sep_id]
            segs = [0] * len(ids)
        ids = ids[: self.max_length]
        segs = segs[: self.max_length]
        valid = np.zeros(self.max_length, np.float32)
        valid[: len(ids)] = 1.0
        out_ids = np.full(self.max_length, self.pad_id, np.int32)
        out_ids[: len(ids)] = ids
        out_segs = np.zeros(self.max_length, np.int32)
        out_segs[: len(segs)] = segs
        return out_ids, out_segs, valid

    def _encode(self, batch, batch_labels) -> MultiDataSet:
        ids, segs, valid = zip(*[self._encode_one(t) for t in batch])
        ids, segs, valid = np.stack(ids), np.stack(segs), np.stack(valid)
        if self.task == "UNSUPERVISED":
            # BERT MLM never masks [CLS]/[SEP]/[PAD]
            special = (ids == self.cls_id) | (ids == self.sep_id) | (ids == self.pad_id)
            cand = valid * (~special)
            masked, labels, lm_mask = zip(*[
                self.masker.mask_sequence(i, c) for i, c in zip(ids, cand)])
            return MultiDataSet(
                features=[np.stack(masked), segs],
                labels=[np.stack(labels)],
                features_masks=[valid, None],
                labels_masks=[np.stack(lm_mask)])
        # SEQ_CLASSIFICATION
        onehot = np.eye(self.n_classes, dtype=np.float32)[np.asarray(batch_labels)]
        return MultiDataSet(features=[ids, segs], labels=[onehot],
                            features_masks=[valid, None], labels_masks=[None])
