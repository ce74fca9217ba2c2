"""Sequence preprocessing (reference re-exports keras_preprocessing.sequence;
implemented natively — same semantics, no external dependency)."""

from __future__ import annotations

import numpy as np


def pad_sequences(sequences, maxlen=None, dtype="int32", padding="pre",
                  truncating="pre", value=0.0):
    """Pad/truncate list-of-lists to a (n, maxlen) array."""
    lengths = [len(s) for s in sequences]
    if maxlen is None:
        maxlen = max(lengths) if lengths else 0
    n = len(sequences)
    sample_shape = ()
    for s in sequences:
        if len(s):
            sample_shape = np.asarray(s).shape[1:]
            break
    x = np.full((n, maxlen) + sample_shape, value, dtype=dtype)
    for i, s in enumerate(sequences):
        if not len(s):
            continue
        if truncating == "pre":
            trunc = s[-maxlen:]
        elif truncating == "post":
            trunc = s[:maxlen]
        else:
            raise ValueError(f"unknown truncating {truncating}")
        trunc = np.asarray(trunc, dtype=dtype)
        if padding == "post":
            x[i, :len(trunc)] = trunc
        elif padding == "pre":
            x[i, -len(trunc):] = trunc
        else:
            raise ValueError(f"unknown padding {padding}")
    return x


def make_sampling_table(size, sampling_factor=1e-5):
    """Word-rank → keep-probability table (Zipf approximation)."""
    gamma = 0.577
    rank = np.arange(size)
    rank[0] = 1
    inv_fq = rank * (np.log(rank) + gamma) + 0.5 - 1.0 / (12.0 * rank)
    f = sampling_factor * inv_fq
    return np.minimum(1.0, f / np.sqrt(f))


def skipgrams(sequence, vocabulary_size, window_size=4, negative_samples=1.0,
              shuffle=True, categorical=False, sampling_table=None, seed=None):
    """Generate (couples, labels) skip-gram pairs with negative sampling."""
    couples = []
    labels = []
    for i, wi in enumerate(sequence):
        if not wi:
            continue
        if sampling_table is not None:
            if sampling_table[wi] < np.random.random():
                continue
        window_start = max(0, i - window_size)
        window_end = min(len(sequence), i + window_size + 1)
        for j in range(window_start, window_end):
            if j != i:
                wj = sequence[j]
                if not wj:
                    continue
                couples.append([wi, wj])
                labels.append([0, 1] if categorical else 1)
    if negative_samples > 0:
        num_negative = int(len(labels) * negative_samples)
        words = [c[0] for c in couples]
        np.random.shuffle(words)
        couples += [[words[i % len(words)],
                     np.random.randint(1, vocabulary_size - 1)]
                    for i in range(num_negative)]
        labels += [[1, 0] if categorical else 0] * num_negative
    if shuffle:
        if seed is None:
            seed = np.random.randint(0, 10 ** 6)
        rng = np.random.RandomState(seed)
        idx = rng.permutation(len(couples))
        couples = [couples[i] for i in idx]
        labels = [labels[i] for i in idx]
    return couples, labels


def _remove_long_seq(maxlen, seq, label):
    new_seq, new_label = [], []
    for x, y in zip(seq, label):
        if len(x) < maxlen:
            new_seq.append(x)
            new_label.append(y)
    return new_seq, new_label
