"""Keras-like callbacks (reference: python/flexflow/keras/callbacks.py).

``VerifyMetrics``/``EpochVerifyMetrics`` are the reference test suite's
accuracy assertions (thresholds in examples/python/keras/accuracy.py).
``LearningRateScheduler`` sets the rate through the keras optimizer, whose
core optimizer carries it to the step's device scalars
(``keras/optimizers.py``).
"""

from __future__ import annotations

from typing import Dict, Optional


class Callback:
    def set_model(self, model):
        self.model = model

    def on_train_begin(self):
        pass

    def on_train_end(self):
        pass

    def on_epoch_begin(self, epoch: int):
        pass

    def on_epoch_end(self, epoch: int, logs: Optional[Dict[str, float]] = None):
        pass


class LearningRateScheduler(Callback):
    def __init__(self, schedule):
        self.schedule = schedule

    def on_epoch_begin(self, epoch: int):
        self.model._optimizer.set_learning_rate(self.schedule(epoch))


class VerifyMetrics(Callback):
    """Assert the final epoch's accuracy meets a threshold (a fraction, 0.9,
    or a percentage, 90.0)."""

    def __init__(self, accuracy_threshold: float):
        self.threshold = accuracy_threshold
        self.last_logs: Dict[str, float] = {}

    def on_epoch_end(self, epoch, logs=None):
        self.last_logs = logs or {}

    def on_train_end(self):
        acc = self.last_logs.get("accuracy", 0.0) * 100.0
        thr = self.threshold * 100.0 if self.threshold <= 1.0 else self.threshold
        assert acc >= thr, \
            f"VerifyMetrics: accuracy {acc:.2f}% below threshold {thr:.2f}%"


class EpochVerifyMetrics(Callback):
    """Assert the threshold is met by some epoch."""

    def __init__(self, accuracy_threshold: float):
        self.threshold = accuracy_threshold
        self.best = 0.0

    def on_epoch_end(self, epoch, logs=None):
        if logs:
            self.best = max(self.best, logs.get("accuracy", 0.0) * 100.0)

    def on_train_end(self):
        thr = self.threshold * 100.0 if self.threshold <= 1.0 else self.threshold
        assert self.best >= thr, \
            f"EpochVerifyMetrics: best accuracy {self.best:.2f}% below {thr:.2f}%"
