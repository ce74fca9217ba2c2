"""CIFAR-10 loader (reference: python/flexflow/keras/datasets/cifar10.py).

Loads the pickled ``cifar-10-batches-py`` directory when cached locally
(same format the reference parses, datasets/cifar.py); otherwise a
deterministic synthetic stand-in with real shapes (NCHW uint8 3×32×32,
matching the reference's channels-first return layout).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..utils.data_utils import locate_file, warn_synthetic


def _load_batch(fpath, label_key="labels"):
    with open(fpath, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    d = {k.decode("utf8") if isinstance(k, bytes) else k: v for k, v in d.items()}
    data = d["data"].reshape(-1, 3, 32, 32)
    return data, d[label_key]


def _synthetic(n_train=50000, n_test=10000, seed=131):
    rng = np.random.default_rng(seed)

    def make(n):
        y = rng.integers(0, 10, size=(n, 1), dtype=np.uint8)
        # Class-positioned bright patch over noise (see mnist._synthetic).
        x = rng.integers(0, 96, size=(n, 3, 32, 32), dtype=np.int64)
        yy = y[:, 0].astype(np.int64)
        r = (yy % 5) * 6 + 1
        c = (yy // 5) * 14 + 2
        idx = np.arange(32)
        rmask = (idx[None, :] >= r[:, None]) & (idx[None, :] < r[:, None] + 6)
        cmask = (idx[None, :] >= c[:, None]) & (idx[None, :] < c[:, None] + 12)
        x += 140 * (rmask[:, None, :, None] & cmask[:, None, None, :])
        return np.minimum(x, 255).astype(np.uint8), y

    x_train, y_train = make(n_train)
    x_test, y_test = make(n_test)
    return (x_train, y_train), (x_test, y_test)


def load_data():
    """Returns ``(x_train, y_train), (x_test, y_test)``, channels-first."""
    dirname = locate_file("cifar-10-batches-py")
    if dirname and os.path.isdir(dirname):
        x_train = np.empty((50000, 3, 32, 32), dtype="uint8")
        y_train = np.empty((50000,), dtype="uint8")
        for i in range(1, 6):
            data, labels = _load_batch(os.path.join(dirname, f"data_batch_{i}"))
            x_train[(i - 1) * 10000:i * 10000] = data
            y_train[(i - 1) * 10000:i * 10000] = labels
        x_test, y_test = _load_batch(os.path.join(dirname, "test_batch"))
        y_test = np.array(y_test, dtype="uint8")
        return (x_train, y_train.reshape(-1, 1)), (x_test, y_test.reshape(-1, 1))
    warn_synthetic("cifar-10-batches-py")
    return _synthetic()
