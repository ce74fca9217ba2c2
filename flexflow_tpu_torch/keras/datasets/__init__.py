"""Keras-style dataset loaders (reference: python/flexflow/keras/datasets/),
a copy of the JAX package's: the same files, the same synthetic data.

The loaders download nothing, so ``load_data`` resolves in order: (1) a
locally cached file (``~/.keras/datasets`` or ``$FF_DATASET_DIR``) in the
standard format the reference downloads,
(2) a deterministic synthetic dataset with the real shapes/dtypes — the
reference's own synthetic-data fixture pattern (SURVEY §4.3) promoted to
the dataset layer, so every example runs out of the box.
"""

from . import cifar10, mnist, reuters

__all__ = ["cifar10", "mnist", "reuters"]
