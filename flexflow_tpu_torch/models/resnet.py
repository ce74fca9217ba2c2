"""ResNet-50, built exactly as the JAX package builds it
(``flexflow_tpu/models/resnet.py``; reference: examples/cpp/ResNet/
resnet.cc:34-100): bottleneck blocks with element-add skip connections,
input 3x229x229 by default.
"""

from __future__ import annotations

from ..model import FFModel
from ..ops.conv2d import ActiMode, PoolType

RELU = ActiMode.RELU


def bottleneck_block(ff: FFModel, x, out_channels: int, stride: int):
    t = ff.conv2d(x, out_channels, 1, 1, 1, 1, 0, 0, activation=RELU)
    t = ff.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1, activation=RELU)
    t = ff.conv2d(t, 4 * out_channels, 1, 1, 1, 1, 0, 0)
    # project the shortcut when shape changes (resnet.cc:42-45; channel dim
    # is NHWC-last here vs the reference's adim[1])
    if stride > 1 or x.dims[-1] != out_channels * 4:
        x = ff.conv2d(x, 4 * out_channels, 1, 1, stride, stride, 0, 0,
                      activation=RELU)
    return ff.add(x, t)


def build_resnet50(ff: FFModel, batch_size: int, num_classes: int = 10,
                   height: int = 229, width: int = 229):
    """Returns (input_tensor, softmax_output)."""
    inp = ff.create_tensor((batch_size, 3, height, width), name="input")
    t = ff.conv2d(inp, 64, 7, 7, 2, 2, 3, 3)
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1)
    for _ in range(3):
        t = bottleneck_block(ff, t, 64, 1)
    for i in range(4):
        t = bottleneck_block(ff, t, 128, 2 if i == 0 else 1)
    for i in range(6):
        t = bottleneck_block(ff, t, 256, 2 if i == 0 else 1)
    for i in range(3):
        t = bottleneck_block(ff, t, 512, 2 if i == 0 else 1)
    t = ff.pool2d(t, t.dims[1], t.dims[2], 1, 1, 0, 0, pool_type=PoolType.AVG)
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    t = ff.softmax(t)
    return inp, t
