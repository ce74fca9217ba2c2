"""Keras-style utils (reference: python/flexflow/keras/utils/)."""

from .data_utils import get_file, locate_file
from .np_utils import normalize, to_categorical

__all__ = ["get_file", "locate_file", "normalize", "to_categorical"]
