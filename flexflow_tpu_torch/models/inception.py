"""Inception-v3, built exactly as the JAX package builds it
(``flexflow_tpu/models/inception.py``; reference: examples/cpp/InceptionV3/
inception.cc:23-175): input 3x299x299, A-E modules of conv, pool and
concat.  The channel concat takes the reference's NCHW axis 1, which
``FFModel.concat`` maps to the NHWC channel axis.
"""

from __future__ import annotations

from ..model import FFModel
from ..ops.conv2d import ActiMode, PoolType

RELU = ActiMode.RELU


def inception_a(ff: FFModel, x, pool_features: int):
    t1 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, activation=RELU)
    t2 = ff.conv2d(x, 48, 1, 1, 1, 1, 0, 0, activation=RELU)
    t2 = ff.conv2d(t2, 64, 5, 5, 1, 1, 2, 2, activation=RELU)
    t3 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, activation=RELU)
    t3 = ff.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, activation=RELU)
    t3 = ff.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, activation=RELU)
    t4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type=PoolType.AVG)
    t4 = ff.conv2d(t4, pool_features, 1, 1, 1, 1, 0, 0, activation=RELU)
    return ff.concat([t1, t2, t3, t4], axis=1)


def inception_b(ff: FFModel, x):
    t1 = ff.conv2d(x, 384, 3, 3, 2, 2, 0, 0)
    t2 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(t2, 96, 3, 3, 1, 1, 1, 1)
    t2 = ff.conv2d(t2, 96, 3, 3, 2, 2, 0, 0)
    t3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    return ff.concat([t1, t2, t3], axis=1)


def inception_c(ff: FFModel, x, channels: int):
    t1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(x, channels, 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(t2, channels, 1, 7, 1, 1, 0, 3)
    t2 = ff.conv2d(t2, 192, 7, 1, 1, 1, 3, 0)
    t3 = ff.conv2d(x, channels, 1, 1, 1, 1, 0, 0)
    t3 = ff.conv2d(t3, channels, 7, 1, 1, 1, 3, 0)
    t3 = ff.conv2d(t3, channels, 1, 7, 1, 1, 0, 3)
    t3 = ff.conv2d(t3, channels, 7, 1, 1, 1, 3, 0)
    t3 = ff.conv2d(t3, 192, 1, 7, 1, 1, 0, 3)
    t4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type=PoolType.AVG)
    t4 = ff.conv2d(t4, 192, 1, 1, 1, 1, 0, 0)
    return ff.concat([t1, t2, t3, t4], axis=1)


def inception_d(ff: FFModel, x):
    t1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    t1 = ff.conv2d(t1, 320, 3, 3, 2, 2, 0, 0)
    t2 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(t2, 192, 1, 7, 1, 1, 0, 3)
    t2 = ff.conv2d(t2, 192, 7, 1, 1, 1, 3, 0)
    t2 = ff.conv2d(t2, 192, 3, 3, 2, 2, 0, 0)
    t3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    return ff.concat([t1, t2, t3], axis=1)


def inception_e(ff: FFModel, x):
    t1 = ff.conv2d(x, 320, 1, 1, 1, 1, 0, 0)
    t2i = ff.conv2d(x, 384, 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(t2i, 384, 1, 3, 1, 1, 0, 1)
    t3 = ff.conv2d(t2i, 384, 3, 1, 1, 1, 1, 0)
    t3i = ff.conv2d(x, 448, 1, 1, 1, 1, 0, 0)
    t3i = ff.conv2d(t3i, 384, 3, 3, 1, 1, 1, 1)
    t4 = ff.conv2d(t3i, 384, 1, 3, 1, 1, 0, 1)
    t5 = ff.conv2d(t3i, 384, 3, 1, 1, 1, 1, 0)
    t6 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type=PoolType.AVG)
    t6 = ff.conv2d(t6, 192, 1, 1, 1, 1, 0, 0)
    return ff.concat([t1, t2, t3, t4, t5, t6], axis=1)


def build_inception_v3(ff: FFModel, batch_size: int, num_classes: int = 10):
    """Returns (input_tensor, softmax_output)."""
    inp = ff.create_tensor((batch_size, 3, 299, 299), name="input")
    t = ff.conv2d(inp, 32, 3, 3, 2, 2, 0, 0, activation=RELU)
    t = ff.conv2d(t, 32, 3, 3, 1, 1, 0, 0, activation=RELU)
    t = ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation=RELU)
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 80, 1, 1, 1, 1, 0, 0, activation=RELU)
    t = ff.conv2d(t, 192, 3, 3, 1, 1, 1, 1, activation=RELU)
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = inception_a(ff, t, 32)
    t = inception_a(ff, t, 64)
    t = inception_a(ff, t, 64)
    t = inception_b(ff, t)
    t = inception_c(ff, t, 128)
    t = inception_c(ff, t, 160)
    t = inception_c(ff, t, 160)
    t = inception_c(ff, t, 192)
    t = inception_d(ff, t)
    t = inception_e(ff, t)
    t = inception_e(ff, t)
    t = ff.pool2d(t, 8, 8, 1, 1, 0, 0, pool_type=PoolType.AVG)
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    t = ff.softmax(t)
    return inp, t
