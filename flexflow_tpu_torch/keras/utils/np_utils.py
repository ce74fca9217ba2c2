"""Numpy utilities (reference: python/flexflow/keras/utils/np_utils.py)."""

from __future__ import annotations

import numpy as np


def to_categorical(y, num_classes=None, dtype="float32"):
    """Integer class vector → one-hot matrix (reference np_utils.py:9-55)."""
    y = np.array(y, dtype="int")
    input_shape = y.shape
    if input_shape and input_shape[-1] == 1 and len(input_shape) > 1:
        input_shape = tuple(input_shape[:-1])
    y = y.ravel()
    if not num_classes:
        num_classes = int(np.max(y)) + 1
    n = y.shape[0]
    categorical = np.zeros((n, num_classes), dtype=dtype)
    categorical[np.arange(n), y] = 1
    return categorical.reshape(input_shape + (num_classes,))


def normalize(x, axis=-1, order=2):
    """L-``order`` normalize along ``axis`` (reference np_utils.py:58-70)."""
    l2 = np.atleast_1d(np.linalg.norm(x, order, axis))
    l2[l2 == 0] = 1
    return x / np.expand_dims(l2, axis)
