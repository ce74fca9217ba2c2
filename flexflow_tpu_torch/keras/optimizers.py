"""Keras-like optimizer wrappers (reference: python/flexflow/keras/optimizers.py)
over the port's ``SGDOptimizer`` and ``AdamOptimizer``.

``set_learning_rate`` writes the core optimizer's ``lr`` (SGD) or ``alpha``
(Adam).  SGD's ``lr`` setter writes the step's device scalar vector in
place, so a captured step reads the new rate at its next replay; Adam's
``alpha`` is read by ``next_epoch``, which publishes the new ``alpha_t``
the same way (the JAX package's schedule: the rate set during an epoch
takes effect at the next one).
"""

from __future__ import annotations

from ..optimizers import AdamOptimizer, SGDOptimizer


class Optimizer:
    def to_core(self):
        raise NotImplementedError

    def set_learning_rate(self, lr: float):
        raise NotImplementedError


class SGD(Optimizer):
    def __init__(self, learning_rate: float = 0.01, lr: float = None,
                 momentum: float = 0.0, nesterov: bool = False, decay: float = 0.0):
        self.learning_rate = lr if lr is not None else learning_rate
        self.momentum = momentum
        self.nesterov = nesterov
        self.decay = decay
        self._core = None

    def to_core(self):
        self._core = SGDOptimizer(lr=self.learning_rate, momentum=self.momentum,
                                  nesterov=self.nesterov, weight_decay=self.decay)
        return self._core

    def set_learning_rate(self, lr: float):
        self.learning_rate = lr
        if self._core is not None:
            self._core.lr = lr


class Adam(Optimizer):
    def __init__(self, learning_rate: float = 0.001, lr: float = None,
                 beta_1: float = 0.9, beta_2: float = 0.999, epsilon: float = 1e-8,
                 decay: float = 0.0):
        self.learning_rate = lr if lr is not None else learning_rate
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.decay = decay
        self._core = None

    def to_core(self):
        self._core = AdamOptimizer(alpha=self.learning_rate, beta1=self.beta_1,
                                   beta2=self.beta_2, epsilon=self.epsilon,
                                   weight_decay=self.decay)
        return self._core

    def set_learning_rate(self, lr: float):
        self.learning_rate = lr
        if self._core is not None:
            self._core.alpha = lr


class Optax(Optimizer):
    """The JAX package's wrapper of an optax chain.  optax is a JAX library
    and has no counterpart in the port: use ``SGD`` or ``Adam``."""

    def __init__(self, tx=None):
        raise NotImplementedError(
            "keras.Optax wraps an optax GradientTransformation; optax is a JAX "
            "library with no counterpart in flexflow_tpu_torch (use keras.SGD "
            "or keras.Adam)")
