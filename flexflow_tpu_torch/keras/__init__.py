"""Keras-like frontend (reference: python/flexflow/keras/), the JAX
package's ``keras`` on the port's ``FFModel``: models train on CUDA unless
their ``FFConfig`` asks for the CPU."""

from . import backend, callbacks, datasets, layers, optimizers, preprocessing, utils
from .callbacks import (Callback, EpochVerifyMetrics, LearningRateScheduler,
                        VerifyMetrics)
from .layers import (Activation, Add, AveragePooling2D, BatchNormalization,
                     Concatenate, Conv2D, Dense, Dropout, Embedding, Flatten,
                     Input, MaxPooling2D, Multiply, Subtract)
from .models import Model, Sequential
from .optimizers import SGD, Adam, Optax
