"""AlexNet, built exactly as the JAX package builds it
(``flexflow_tpu/models/alexnet.py``; reference: examples/cpp/AlexNet/
alexnet.cc:54-80): input 3x229x229, five conv blocks, three dense layers,
softmax.
"""

from __future__ import annotations

from ..model import FFModel
from ..ops.conv2d import ActiMode


def build_alexnet(model: FFModel, batch_size: int, num_classes: int = 10,
                  height: int = 229, width: int = 229):
    """Returns (input_tensor, softmax_output)."""
    inp = model.create_tensor((batch_size, 3, height, width), name="input")
    t = model.conv2d(inp, 64, 11, 11, 4, 4, 2, 2, activation=ActiMode.RELU, name="conv1")
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool1")
    t = model.conv2d(t, 192, 5, 5, 1, 1, 2, 2, activation=ActiMode.RELU, name="conv2")
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool2")
    t = model.conv2d(t, 384, 3, 3, 1, 1, 1, 1, activation=ActiMode.RELU, name="conv3")
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation=ActiMode.RELU, name="conv4")
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation=ActiMode.RELU, name="conv5")
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool3")
    t = model.flat(t, name="flat")
    t = model.dense(t, 4096, activation=ActiMode.RELU, name="fc1")
    t = model.dense(t, 4096, activation=ActiMode.RELU, name="fc2")
    t = model.dense(t, num_classes, name="fc3")
    t = model.softmax(t, name="softmax")
    return inp, t
