"""Graph-time tensor and parameter descriptors (PyTorch port).

Counterpart of ``flexflow_tpu/tensor.py``.  A ``Tensor`` is symbolic: an
edge of the op graph with shape, dtype and producer.  Image tensors are
NHWC, as in the JAX package, so weights and activations carry across
between the two packages as plain copies.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

_guid_counter = itertools.count(100)


class DataType:
    """Dtype tags mirroring the reference enum (include/model.h)."""

    FLOAT = "float32"
    DOUBLE = "float64"
    INT32 = "int32"
    INT64 = "int64"
    BOOL = "bool"
    HALF = "bfloat16"


@dataclasses.dataclass(eq=False)
class Tensor:
    """A symbolic activation in the op graph (batch first, NHWC images)."""

    dims: Tuple[int, ...]
    dtype: str = DataType.FLOAT
    owner_op: Optional[object] = None
    owner_idx: int = 0
    name: str = ""

    def __post_init__(self):
        self.guid = next(_guid_counter)
        self.dims = tuple(int(d) for d in self.dims)

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    def __repr__(self):
        own = type(self.owner_op).__name__ if self.owner_op is not None else "input"
        return f"Tensor(guid={self.guid}, dims={self.dims}, {self.dtype}, from={own})"


@dataclasses.dataclass(eq=False)
class Parameter:
    """A trainable weight owned by an op (reference: include/model.h:169-181).

    ``partition_dims`` maps each weight dim to the op-config dim that
    partitions it (None: replicated)."""

    name: str
    dims: Tuple[int, ...]
    dtype: str = DataType.FLOAT
    initializer: Optional[object] = None
    owner_op: Optional[object] = None
    partition_dims: Tuple[Optional[int], ...] = None  # type: ignore[assignment]

    def __post_init__(self):
        self.guid = next(_guid_counter)
        self.dims = tuple(int(d) for d in self.dims)
        if self.partition_dims is None:
            self.partition_dims = (None,) * len(self.dims)

    def __repr__(self):
        return f"Parameter({self.name}, dims={self.dims}, {self.dtype})"
