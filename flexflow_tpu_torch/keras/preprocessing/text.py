"""Text preprocessing (reference re-exports keras_preprocessing.text;
native minimal implementation: tokenizer + hashing helpers)."""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np


def text_to_word_sequence(text, filters='!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n',
                          lower=True, split=" "):
    if lower:
        text = text.lower()
    table = str.maketrans({c: split for c in filters})
    return [w for w in text.translate(table).split(split) if w]


def one_hot(text, n, **kwargs):
    return hashing_trick(text, n, hash_function=hash, **kwargs)


def hashing_trick(text, n, hash_function=None,
                  filters='!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n',
                  lower=True, split=" "):
    if hash_function is None:
        hash_function = hash
    elif hash_function == "md5":
        hash_function = lambda w: int(hashlib.md5(w.encode()).hexdigest(), 16)
    seq = text_to_word_sequence(text, filters=filters, lower=lower, split=split)
    return [(hash_function(w) % (n - 1) + 1) for w in seq]


class Tokenizer:
    """Word-index tokenizer (fit_on_texts / texts_to_sequences/matrix)."""

    def __init__(self, num_words=None,
                 filters='!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n',
                 lower=True, split=" ", oov_token=None):
        self.num_words = num_words
        self.filters = filters
        self.lower = lower
        self.split = split
        self.oov_token = oov_token
        self.word_counts = OrderedDict()
        self.word_index = {}
        self.index_word = {}
        self.document_count = 0

    def fit_on_texts(self, texts):
        for text in texts:
            self.document_count += 1
            seq = text if isinstance(text, list) else \
                text_to_word_sequence(text, self.filters, self.lower, self.split)
            for w in seq:
                self.word_counts[w] = self.word_counts.get(w, 0) + 1
        sorted_words = [w for w, _ in sorted(self.word_counts.items(),
                                             key=lambda kv: kv[1], reverse=True)]
        if self.oov_token is not None:
            sorted_words = [self.oov_token] + sorted_words
        self.word_index = {w: i + 1 for i, w in enumerate(sorted_words)}
        self.index_word = {i: w for w, i in self.word_index.items()}

    def texts_to_sequences(self, texts):
        return list(self.texts_to_sequences_generator(texts))

    def texts_to_sequences_generator(self, texts):
        oov_idx = self.word_index.get(self.oov_token) if self.oov_token else None
        for text in texts:
            seq = text if isinstance(text, list) else \
                text_to_word_sequence(text, self.filters, self.lower, self.split)
            out = []
            for w in seq:
                i = self.word_index.get(w)
                if i is not None and (not self.num_words or i < self.num_words):
                    out.append(i)
                elif oov_idx is not None:
                    out.append(oov_idx)
            yield out

    def texts_to_matrix(self, texts, mode="binary"):
        seqs = self.texts_to_sequences(texts)
        n = self.num_words or (len(self.word_index) + 1)
        m = np.zeros((len(seqs), n))
        for row, seq in enumerate(seqs):
            if not seq:
                continue
            counts = {}
            for i in seq:
                counts[i] = counts.get(i, 0) + 1
            for i, c in counts.items():
                if mode == "binary":
                    m[row, i] = 1
                elif mode == "count":
                    m[row, i] = c
                elif mode == "freq":
                    m[row, i] = c / len(seq)
                elif mode == "tfidf":
                    m[row, i] = (1 + np.log(c)) * np.log(
                        1 + self.document_count / (1 + self.word_counts.get(
                            self.index_word.get(i, ""), 0)))
                else:
                    raise ValueError(f"unknown mode {mode}")
        return m
