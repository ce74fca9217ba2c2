"""Data loading (PyTorch port of ``flexflow_tpu/runtime/dataloader.py``).

The dataset stays in host numpy; ``next_batch`` gathers the next batch's
rows and ``FFModel.set_batch`` stages them on the model's device.  On a
mesh every rank holds the dataset and gathers only its rows of the global
batch (``parallel.distributed.local_batch``): no rank copies the whole
batch to its device.  Reference (NCHW) image datasets are converted to
NHWC once, on the host.

With ``prefetch`` (the default, as in the JAX package) a worker thread
prepares the next batch while the device runs the current step.  On the
CPU and on a mesh it gathers the rows.  For a model on one CUDA device it
also moves them: it gathers (``torch.index_select``, on the host's
threads) into one of two pinned host buffers, copies
that buffer to a device staging tensor on a stream of its own
(``non_blocking``) and records an event; ``next_batch`` makes the current
stream wait for the event and ``set_batch`` copies device to device into
the model's static batch buffers, which the worker never writes (a
captured step reads them).  A pinned buffer is refilled only after its
last copy has finished, and a staging tensor only after the current
stream has read it.  The worker holds ``step_graph.capture_lock`` around
each of its CUDA calls, so none lands in a step being captured.

Prefetching changes when a batch is gathered, never which: ``reset()``
and ``skip_batches`` discard a batch prepared for another position (the
JAX package's ``_order_version`` check, dataloader.py:171-186 there), and
any ``FFModel.recompile`` one gathered under the old machine or strategy
map (``FFModel._compile_version``: a new batch degree splits the rows
anew).  A rank benched by a lost device
(runtime/reconfigure.py) only advances its cursor.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Optional

import numpy as np
import torch

from ..parallel.distributed import local_batch
from ..tensor import DataType, Tensor


class _Slot:
    """One pinned host buffer per array and its device staging tensor,
    with the events that order their reuse."""

    def __init__(self, arrays: Dict[str, np.ndarray], device: torch.device):
        self.key = {k: (a.shape, a.dtype) for k, a in arrays.items()}
        self.host = {k: torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                                    pin_memory=True) for k, a in arrays.items()}
        self.dev = {k: torch.empty_like(h, device=device) for k, h in self.host.items()}
        self.copied = torch.cuda.Event()    # the host -> device copy finished
        self.consumed = torch.cuda.Event()  # the current stream read ``dev``


class _DeviceStager:
    """The worker's half of the device pipeline for one CUDA device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream: Optional[torch.cuda.Stream] = None
        self.slots = [None, None]
        self.next = 0

    def stage(self, sel: np.ndarray, arrays: Dict[str, np.ndarray]):
        """Gather rows ``sel`` of each array into the next slot and start
        its copy; returns (device tensors, the slot)."""
        from .step_graph import capture_lock

        i, self.next = self.next, self.next ^ 1
        shapes = {k: ((len(sel),) + a.shape[1:], a.dtype) for k, a in arrays.items()}
        slot = self.slots[i]
        with capture_lock:
            if self.stream is None:
                self.stream = torch.cuda.Stream(self.device)
            if slot is None or slot.key != shapes:
                slot = self.slots[i] = _Slot(
                    {k: np.empty(s, d) for k, (s, d) in shapes.items()}, self.device)
            else:
                slot.copied.synchronize()  # its pinned buffers are free again
        # torch's gather splits the rows over threads and drops the GIL
        # (np.take into ``out`` buffers its result when it checks bounds)
        rows = torch.from_numpy(sel)
        for k, a in arrays.items():
            torch.index_select(torch.from_numpy(a), 0, rows, out=slot.host[k])
        with capture_lock, torch.cuda.stream(self.stream):
            self.stream.wait_event(slot.consumed)
            for k, h in slot.host.items():
                slot.dev[k].copy_(h, non_blocking=True)
            slot.copied.record(self.stream)
        return slot.dev, slot


class DataLoader:
    def __init__(self, ff, inputs: Dict[Tensor, np.ndarray], labels: np.ndarray,
                 shuffle: bool = False, seed: int = 0, prefetch: bool = True):
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
        self.prefetch = prefetch
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        # (start index, order version, model, its compile version, future)
        # of the batch the worker prepares
        self._pending = None
        self._order_version = 0
        self._stager: Optional[_DeviceStager] = None

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
        self.drain()  # a prefetched batch is for the old order
        self.next_index = 0
        if self.shuffle:
            self._rng.shuffle(self._order)
        self._order_version += 1

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
        self.drain()
        for _ in range(max(0, int(n))):
            self.next_index = self._start_of(self.next_index) + self.batch_size

    def drain(self) -> None:
        """Wait for the batch the worker prepares and discard it (its copy
        to the device included); a preemption save calls it before it
        reads the model."""
        pending, self._pending = self._pending, None
        if pending is not None:
            try:
                pending[-1].result()
            except Exception:  # noqa: BLE001 - a discarded batch's failure
                pass           # shows again when the batch is gathered

    def close(self) -> None:
        """Drain and stop the worker thread."""
        self.drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def next_batch(self, ff=None) -> None:
        """Stage the next batch; with telemetry on, a ``data_wait`` span (the
        wait for the worker, or the gather, and the copy into the model's
        buffers) whose ``prefetched`` says whether the worker had it."""
        ff = ff or self.ff
        if ff._chaos is not None:
            ff._chaos.fire("data", model=ff)
        from ..observability.health import write_heartbeat

        # a no-op unless FF_HEARTBEAT_PATH is set: a wedged input gets named
        write_heartbeat("data_wait", step=ff._step_count)
        tel = ff._telemetry
        if tel is None:
            return self._next_batch(ff)
        with tel.span("data_wait", batch_size=self.batch_size) as at:
            at["prefetched"] = self._ready(ff, self._start_of(self.next_index))
            self._next_batch(ff)

    def _ready(self, ff, start: int) -> bool:
        p = self._pending
        return (p is not None and p[0] == start and p[1] == self._order_version
                and p[2] is ff and p[3] == ff._compile_version)

    def _next_batch(self, ff) -> None:
        start = self._start_of(self.next_index)
        self.next_index = start + self.batch_size
        if ff._benched:  # it computes nothing: only the cursor moves
            self.drain()
            return
        if not self.prefetch:
            xs, ys = self._gather(ff, self._order[start:start + self.batch_size])
            ff.set_batch(xs, ys)
            return
        if self._ready(ff, start):
            batch = self._pending[-1].result()
            self._pending = None
        else:
            self.drain()
            batch = self._prepare(ff, start)
        self._deliver(ff, batch)
        if self._pool is None:
            self._pool = cf.ThreadPoolExecutor(max_workers=1,
                                               thread_name_prefix="ff-dataloader")
        nxt = self._start_of(self.next_index)
        self._pending = (nxt, self._order_version, ff, ff._compile_version,
                         self._pool.submit(self._prepare, ff, nxt))

    def _gather(self, ff, sel: np.ndarray):
        """The rows ``sel`` of each input and of the labels (on a mesh, this
        rank's part of them)."""
        if not ff._sharded:
            return {t: a[sel] for t, a in self.inputs.items()}, self.labels[sel]
        return ({t: a[local_batch(ff.machine, sel, ff._input_batch_degree(t))]
                 for t, a in self.inputs.items()},
                self.labels[local_batch(ff.machine, sel, ff._label_degree())])

    def _prepare(self, ff, start: int):
        """The batch at ``start``: gathered, and for a model on one CUDA
        device on its way to the device (the worker's body)."""
        sel = self._order[start:start + self.batch_size]
        if ff._sharded or ff.device.type != "cuda":
            return self._gather(ff, sel), None
        if self._stager is None or self._stager.device != ff.device:
            self._stager = _DeviceStager(ff.device)
        arrays = {t.guid: a for t, a in self.inputs.items()}
        arrays["label"] = self.labels
        dev, slot = self._stager.stage(sel, arrays)
        return ({t: dev[t.guid] for t in self.inputs}, dev["label"]), slot

    def _deliver(self, ff, batch) -> None:
        (xs, ys), slot = batch
        if slot is None:
            ff.set_batch(xs, ys)
            return
        current = torch.cuda.current_stream(ff.device)
        current.wait_event(slot.copied)
        ff.set_batch(xs, ys)
        slot.consumed.record(current)
