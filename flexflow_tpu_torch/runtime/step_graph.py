"""The compiled training step: one CUDA graph of ``FFModel``'s step per
batch signature.

The JAX package runs each training step as one program,
``jax.jit(step_fn, donate_argnums=(0, 1, 2, 6))`` (model.py:2071-2073
there): the whole step is dispatched once, and the donated parameters,
optimizer state and metric accumulator are updated where they lie.  The
card's counterpart is a CUDA graph: the step's kernels are captured once
and each later step is one ``replay()``, with no Python, autograd or
wrapper call on the host.

What capture requires of the step, and how the model keeps it:

- Everything the step reads or writes lives at a fixed address.  The batch
  is staged in static buffers (``FFModel.set_batch`` copies into them);
  parameters, optimizer state, the metric accumulator and the optimizer's
  scalar vector ``(lr or alpha_t, skip)`` are only ever written in place
  (``reset_metrics``, ``load``, ``set_parameter``, ``next_epoch`` and a
  changed ``lr`` included).  What the step makes (activations, gradients)
  comes from the graph's private memory pool, at the same addresses on
  every replay; that is what keeps the fused SGD launch's leaf table, a
  kernel argument captured once, right.
- Nothing in the step reads the device from the host, synchronizes or
  allocates outside torch's allocator.  The kernels' libraries are loaded
  by the first, eager step, so no ``nvcc`` build runs under capture.
- A capture records and does not execute, so the first step of a new
  signature runs eagerly, as a real step, on a side stream (it also warms
  cuBLAS, cuDNN and the allocator up); the second is captured and then
  replayed at once.  After N steps the weights are the eager path's.

A graph is dropped when its signature changes (batch shapes, dtypes or
addresses, ``grad_accum_steps``, whether the flash kernels run their plain
versions) and when the model is compiled or its layers initialized again.
A failed capture raises; nothing falls back to the eager step.

A graph's ``on_capture(key, wall_s, pool_bytes)`` hook, when set, hears
of each capture: its signature, host wall and the growth of the caching
allocator's reserved bytes over it (the graph's private pool).  The
capture ledger (observability/memplane.py, ``FF_MEMPLANE``) sets it.

``disable_graphs()`` runs steps eagerly, the counterpart of
``jax.disable_jit()``.  The eager step is also the path on the CPU and,
in this version, on a mesh (SOAP, ROADMAP A6).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Hashable, Optional

import torch

_disabled = 0


@contextlib.contextmanager
def disable_graphs():
    """Inside the block ``train_iteration`` runs the eager step: every op,
    autograd node and kernel wrapper called from Python, as on the CPU."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def graphs_enabled() -> bool:
    return _disabled == 0


class StepGraph:
    """One captured step of a model on one CUDA device, for one signature.

    ``run(key, step)`` takes a step: ``step`` is the model's step function
    (its device work only), ``key`` whatever the captured work depends on."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.key: Optional[Hashable] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0  # host seconds spent capturing
        self.on_capture: Optional[Callable[[Hashable, float, Optional[int]], None]] = None

    def drop(self) -> None:
        """Forget the captured graph (and its memory pool)."""
        self.key = None
        self.graph = None

    def run(self, key: Hashable, step: Callable[[], None]) -> str:
        """One step; returns what it was: "eager" (a new signature's first
        step), "capture" (captured, then replayed) or "replay"."""
        if key != self.key:
            self.drop()
            self.key = key
            self._eager_on_side_stream(step)
            return "eager"
        kind = "replay"
        if self.graph is None:
            self._watched_capture(step)
            kind = "capture"
        self.graph.replay()
        self.replays += 1
        return kind

    def _watched_capture(self, step) -> None:
        cuda = self.device.type == "cuda"
        r0 = torch.cuda.memory_reserved(self.device) if cuda and self.on_capture else 0
        t0 = time.perf_counter()
        self._capture(step)
        wall = time.perf_counter() - t0
        self.capture_s += wall
        if self.on_capture is not None:
            pool = torch.cuda.memory_reserved(self.device) - r0 if cuda else None
            self.on_capture(self.key, wall, pool)

    def _eager_on_side_stream(self, step) -> None:
        """The signature's first step: eager, a real step, on a side stream
        ordered after and before the current stream's work."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            step()
        current.wait_stream(side)

    def _capture(self, step) -> None:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(graph):
            step()
        self.graph = graph
        self.captures += 1
