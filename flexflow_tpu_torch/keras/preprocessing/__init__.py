"""Preprocessing (reference: python/flexflow/keras/preprocessing/ — thin
re-exports of keras_preprocessing; implemented natively here)."""

from . import sequence, text
from .sequence import pad_sequences

__all__ = ["sequence", "text", "pad_sequences"]
