"""Reuters topic-classification loader (reference: datasets/reuters.py).

Same preprocessing contract as the reference (start/oov chars,
index_from offset, num_words cap, test split); synthetic fallback emits
topic-dependent word distributions over the same index space.
"""

from __future__ import annotations

import json

import numpy as np

from ..utils.data_utils import locate_file, warn_synthetic


def _synthetic(n=11228, num_topics=46, seed=113):
    rng = np.random.default_rng(seed)
    xs, labels = [], []
    for _ in range(n):
        y = int(rng.integers(0, num_topics))
        length = int(rng.integers(20, 200))
        # Like real Reuters, discriminative words are frequent (low ids):
        # each topic owns a signature band inside [10, 746) so the signal
        # survives the conventional num_words=1000 vocabulary cap, mixed
        # 50/50 with background words over the full index space.
        sig = 10 + y * 16 + rng.integers(0, 16, size=(length,))
        bg = rng.integers(10, 10000, size=(length,))
        pick = rng.random(length) < 0.5
        words = np.where(pick, sig, bg)
        xs.append(words.tolist())
        labels.append(y)
    return xs, np.array(labels)


def load_data(path="reuters.npz", num_words=None, skip_top=0, maxlen=None,
              test_split=0.2, seed=113, start_char=1, oov_char=2,
              index_from=3):
    """Returns ``(x_train, y_train), (x_test, y_test)`` of index lists."""
    local = locate_file(path)
    if local:
        with np.load(local, allow_pickle=True) as f:
            xs, labels = f["x"], f["y"]
        xs = [list(x) for x in xs]
    else:
        warn_synthetic("reuters.npz")
        xs, labels = _synthetic(seed=seed)

    rng = np.random.RandomState(seed)
    indices = np.arange(len(xs))
    rng.shuffle(indices)
    xs = [xs[i] for i in indices]
    labels = labels[indices]

    if start_char is not None:
        xs = [[start_char] + [w + index_from for w in x] for x in xs]
    elif index_from:
        xs = [[w + index_from for w in x] for x in xs]

    if maxlen:
        keep = [i for i, x in enumerate(xs) if len(x) < maxlen]
        xs = [xs[i] for i in keep]
        labels = labels[keep]

    if not num_words:
        num_words = max(max(x) for x in xs)
    if oov_char is not None:
        xs = [[w if skip_top <= w < num_words else oov_char for w in x]
              for x in xs]
    else:
        xs = [[w for w in x if skip_top <= w < num_words] for x in xs]

    idx = int(len(xs) * (1 - test_split))
    x_train = np.array(xs[:idx], dtype=object)
    y_train = np.array(labels[:idx])
    x_test = np.array(xs[idx:], dtype=object)
    y_test = np.array(labels[idx:])
    return (x_train, y_train), (x_test, y_test)


def get_word_index(path="reuters_word_index.json"):
    local = locate_file(path)
    if local:
        with open(local) as f:
            return json.load(f)
    # Synthetic vocabulary matching the synthetic corpus index space.
    return {f"word{i}": i for i in range(1, 30980)}
