"""Tokenizers.

Counterpart of ``deeplearning4j_tpu/nlp/tokenization.py``, host code kept
token for token: ``DefaultTokenizerFactory`` (whitespace split, an optional
``CommonPreprocessor``) and ``BertWordPieceTokenizer`` (BERT's basic split,
then greedy longest-match WordPiece against a vocabulary, ``load_vocab``
reading a ``vocab.txt`` from a local path).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional


class Tokenizer:
    def __init__(self, tokens: List[str]):
        self._tokens = tokens
        self._i = 0

    def has_more_tokens(self) -> bool:
        return self._i < len(self._tokens)

    def next_token(self) -> str:
        t = self._tokens[self._i]
        self._i += 1
        return t

    def get_tokens(self) -> List[str]:
        return list(self._tokens)

    def count_tokens(self) -> int:
        return len(self._tokens)


class CommonPreprocessor:
    """org.deeplearning4j...preprocessor.CommonPreprocessor: lowercase +
    strip punctuation/digits."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class DefaultTokenizerFactory:
    def __init__(self, preprocessor=None):
        self.preprocessor = preprocessor

    def set_token_pre_processor(self, p):
        self.preprocessor = p

    setTokenPreProcessor = set_token_pre_processor

    def create(self, text: str) -> Tokenizer:
        toks = text.split()
        if self.preprocessor is not None:
            toks = [self.preprocessor.pre_process(t) for t in toks]
            toks = [t for t in toks if t]
        return Tokenizer(toks)


class BertWordPieceTokenizer:
    """Greedy longest-match WordPiece against vocab.txt
    (org.deeplearning4j.text.tokenization.tokenizer.BertWordPieceTokenizer).
    """

    def __init__(self, vocab: Dict[str, int], lower_case: bool = True,
                 unk_token: str = "[UNK]", max_input_chars: int = 100):
        self.vocab = vocab
        self.lower_case = lower_case
        self.unk = unk_token
        self.max_input_chars = max_input_chars

    @staticmethod
    def load_vocab(path: str) -> Dict[str, int]:
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return vocab

    def _basic(self, text: str) -> List[str]:
        if self.lower_case:
            text = text.lower()
        # split off punctuation as separate tokens (BERT basic tokenizer)
        text = re.sub(r"([^\w\s])", r" \1 ", text)
        return text.split()

    def _wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_input_chars:
            return [self.unk]
        out, start = [], 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            out.append(cur)
            start = end
        return out

    def tokenize(self, text: str) -> List[str]:
        out = []
        for tok in self._basic(text):
            out.extend(self._wordpiece(tok))
        return out

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(self.tokenize(text))

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        unk = self.vocab.get(self.unk, 0)
        return [self.vocab.get(t, unk) for t in tokens]
