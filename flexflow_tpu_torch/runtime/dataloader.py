"""Data loading (PyTorch port of ``flexflow_tpu/runtime/dataloader.py``).

The dataset stays in host numpy; ``next_batch`` slices the next batch
and ``FFModel.set_batch`` copies it to the model's device.  On a mesh
every rank holds the dataset and gathers only its rows of the global
batch (``parallel.distributed.local_batch``): no rank copies the whole
batch to its device.  On one device ``set_batch`` copies into the model's
static batch buffers, which a captured step reads.  Reference (NCHW) image
datasets are converted to NHWC once, on the host.  The JAX package's
prefetch thread is not ported: ``prefetch=True`` raises (ROADMAP A10), and
the argument defaults to False here (True there).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..parallel.distributed import local_batch
from ..tensor import DataType, Tensor


class DataLoader:
    def __init__(self, ff, inputs: Dict[Tensor, np.ndarray], labels: np.ndarray,
                 shuffle: bool = False, seed: int = 0, prefetch: bool = False):
        if prefetch:
            raise NotImplementedError(
                "DataLoader(prefetch=True): overlapping the next batch's copy to the "
                "device is not ported yet (ROADMAP A10)")
        self.ff = ff
        self.inputs = {t: np.ascontiguousarray(self._to_native(t, a))
                       for t, a in inputs.items()}
        self.labels = np.ascontiguousarray(labels)
        sizes = {a.shape[0] for a in self.inputs.values()} | {labels.shape[0]}
        if len(sizes) != 1:
            raise ValueError(f"inconsistent sample counts: {sizes}")
        self.num_samples = labels.shape[0]
        self.batch_size = ff.config.batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(self.num_samples)
        self.next_index = 0

    @staticmethod
    def _to_native(t: Tensor, a: np.ndarray) -> np.ndarray:
        """Accept an NCHW image dataset and convert it to NHWC."""
        if a.ndim == 4 and len(t.dims) == 4 and a.shape[1:] != t.dims[1:]:
            n, c, h, w = a.shape
            if (h, w, c) == tuple(t.dims[1:]):
                return a.transpose(0, 2, 3, 1)
        return a

    @classmethod
    def synthetic(cls, ff, input_tensor: Tensor, label_tensor: Optional[Tensor] = None,
                  num_samples: Optional[int] = None, num_classes: int = 10,
                  seed: int = 17) -> "DataLoader":
        """Random dataset generated once from ``seed`` (the reference's
        synthetic mode); the same numbers as the JAX package's loader."""
        label_tensor = label_tensor or ff.label_tensor
        num_samples = num_samples or ff.config.batch_size
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((num_samples,) + tuple(input_tensor.dims[1:]),
                                dtype=np.float32)
        if label_tensor.dtype == DataType.INT32:
            y = rng.integers(0, num_classes,
                             size=(num_samples,) + tuple(label_tensor.dims[1:]),
                             dtype=np.int32)
        else:
            y = rng.standard_normal((num_samples,) + tuple(label_tensor.dims[1:]),
                                    dtype=np.float32)
        return cls(ff, {input_tensor: x}, y)

    def reset(self) -> None:
        self.next_index = 0
        if self.shuffle:
            self._rng.shuffle(self._order)

    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    def _start_of(self, index: int) -> int:
        return 0 if index + self.batch_size > self.num_samples else index

    def skip_batches(self, n: int) -> None:
        """Advance the epoch's cursor by ``n`` batches without gathering or
        staging them (dataloader.py:101-110 of the JAX package): after
        ``reset()`` has replayed the completed epochs' shuffles, skipping
        the consumed batches lands the next ``next_batch`` on the rows an
        interrupted run would have seen next."""
        for _ in range(max(0, int(n))):
            self.next_index = self._start_of(self.next_index) + self.batch_size

    def next_batch(self, ff=None) -> None:
        """Stage the next batch; with telemetry on, a ``data_wait`` span (the
        host gather and the copy into the model's buffers)."""
        ff = ff or self.ff
        from ..observability.health import write_heartbeat

        # a no-op unless FF_HEARTBEAT_PATH is set: a wedged input gets named
        write_heartbeat("data_wait", step=ff._step_count)
        tel = ff._telemetry
        if tel is None:
            return self._next_batch(ff)
        # no prefetch thread in the port yet (ROADMAP A10)
        with tel.span("data_wait", batch_size=self.batch_size, prefetched=False):
            self._next_batch(ff)

    def _next_batch(self, ff) -> None:
        start = self._start_of(self.next_index)
        sel = self._order[start:start + self.batch_size]
        self.next_index = start + self.batch_size
        if not ff._sharded:
            ff.set_batch({t: a[sel] for t, a in self.inputs.items()}, self.labels[sel])
            return
        ff.set_batch({t: a[local_batch(ff.machine, sel, ff._input_batch_degree(t))]
                      for t, a in self.inputs.items()},
                     self.labels[local_batch(ff.machine, sel, ff._label_degree())])
