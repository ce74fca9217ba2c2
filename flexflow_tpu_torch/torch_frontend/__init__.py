"""Torch-like frontend (reference: python/flexflow/torch/nn/)."""

from .nn import (AvgPool2d, BatchNorm2d, Conv2d, Dropout, Flatten, Linear,
                 MaxPool2d, Module, ReLU, Sigmoid, Softmax, Tanh)
