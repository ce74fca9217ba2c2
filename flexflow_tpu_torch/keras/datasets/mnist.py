"""MNIST loader (reference: python/flexflow/keras/datasets/mnist.py).

Loads the standard ``mnist.npz`` when cached locally; otherwise returns
a deterministic synthetic stand-in with the real shapes/dtypes (uint8
28×28 images, labels 0-9) so examples and tests run without egress.
"""

from __future__ import annotations

import numpy as np

from ..utils.data_utils import locate_file, warn_synthetic


def _synthetic(n_train=60000, n_test=10000, seed=113):
    rng = np.random.default_rng(seed)

    def make(n):
        y = rng.integers(0, 10, size=(n,), dtype=np.uint8)
        # Class-positioned bright patch over noise: spatially structured
        # and quickly learnable, like the real digits.
        x = rng.integers(0, 64, size=(n, 28, 28), dtype=np.int64)
        r = (y.astype(np.int64) % 5) * 5 + 1
        c = (y.astype(np.int64) // 5) * 12 + 2
        rows = np.arange(28)
        rmask = (rows[None, :] >= r[:, None]) & (rows[None, :] < r[:, None] + 6)
        cmask = (rows[None, :] >= c[:, None]) & (rows[None, :] < c[:, None] + 10)
        x += 160 * (rmask[:, :, None] & cmask[:, None, :])
        return np.minimum(x, 255).astype(np.uint8), y

    x_train, y_train = make(n_train)
    x_test, y_test = make(n_test)
    return (x_train, y_train), (x_test, y_test)


def load_data(path="mnist.npz"):
    """Returns ``(x_train, y_train), (x_test, y_test)``."""
    local = locate_file(path)
    if local:
        with np.load(local, allow_pickle=True) as f:
            return (f["x_train"], f["y_train"]), (f["x_test"], f["y_test"])
    warn_synthetic("mnist.npz")
    return _synthetic()
