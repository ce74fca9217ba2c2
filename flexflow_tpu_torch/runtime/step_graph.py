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
- Random draws (dropout masks) come from the model's device generator,
  registered with the capture (``CUDAGraph.register_generator_state``):
  a replay reads the generator's seed and offset from the card and
  advances the offset by what the captured draws take, so every replay
  draws anew, and N steps draw what N eager steps draw.  Running
  statistics (BatchNorm's) are static buffers, written in place.
- Nothing in the step reads the device from the host, synchronizes or
  allocates outside torch's allocator, and no graph is destroyed while
  one is captured: the cycle collector, which frees dropped models and
  their graphs, is paused for the capture.  The kernels' libraries are loaded
  by the first, eager step, so no ``nvcc`` build runs under capture.
- A capture records and does not execute, so the first step of a new
  signature runs eagerly, as a real step, on a side stream (it also warms
  cuBLAS, cuDNN and the allocator up); the second is captured and then
  replayed at once.  After N steps the weights are the eager path's.

A graph is dropped when its signature changes (batch shapes, dtypes or
addresses, ``grad_accum_steps``, whether the flash kernels run their plain
versions) and when the model is compiled or its layers initialized again.
A failed capture raises; nothing falls back to the eager step.

Each capture gets the private memory pool ``torch.cuda.graph`` makes
for it, so the segments the caching allocator holds for the graph can be
told from every other graph's (a replica pool's engines share one card):
``pool_bytes()`` sums the ``total_size`` of the
``torch.cuda.memory_snapshot()`` segments whose ``segment_pool_id`` is
``graph.pool()``.  A graph's ``on_capture(key, wall_s, pool_bytes)``
hook, when set, hears of each capture: its signature, host wall and that
pool's size just after it.  The capture ledger
(observability/memplane.py, ``FF_MEMPLANE``) sets it.

cuBLAS keeps a workspace for every (handle, stream) pair that ran a GEMM,
until told to drop them all.  A capture clears them before it starts, so
the workspace its GEMMs use is allocated inside its own pool and lives as
long as the graph, and again after it ends, so no workspace outlives the
graph's pool or piles up from eager steps on short-lived streams (as
``torch._inductor``'s CUDA graph trees do).  A cleared workspace goes
back to the allocator on the stream it was made on, so work queued there
before is not disturbed.

``disable_graphs()`` runs steps eagerly, the counterpart of
``jax.disable_jit()``.  The eager step is also the path on the CPU and,
in this version, on a mesh (SOAP, ROADMAP A6).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Hashable, List, Optional

import torch

_disabled = 0
# one capture at a time in the process: torch.cuda.graph captures on a stream
# its class shares, and synchronizes the card first (replays, and every other
# thread's work, go on meanwhile)
capture_lock = threading.Lock()


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


@contextlib.contextmanager
def _collection_paused():
    """No cyclic garbage collection while a stream captures: a dropped
    model (an op refers to its model, so only the cycle collector frees
    one) may own a graph, and destroying a graph during a capture
    invalidates the capture.  Dead graphs are freed after it."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class StepGraph:
    """One captured step of a model on one CUDA device, for one signature.

    ``run(key, step)`` takes a step: ``step`` is the model's step function
    (its device work only), ``key`` whatever the captured work depends on."""

    capture_error_mode = "global"

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.key: Optional[Hashable] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0  # host seconds spent capturing
        self.pool = None      # the captured graph's memory pool (a handle)
        self.on_capture: Optional[Callable[[Hashable, float, Optional[int]], None]] = None
        # device generators the step draws from, registered at each capture
        self.generators: List[torch.Generator] = []

    def drop(self) -> None:
        """Forget the captured graph (and its memory pool)."""
        self.key = None
        self.graph = None
        self.pool = None

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
        t0 = time.perf_counter()
        self._capture(step)
        wall = time.perf_counter() - t0
        self.capture_s += wall
        if self.on_capture is not None:
            self.on_capture(self.key, wall, self.pool_bytes())

    def pool_bytes(self, segments=None) -> Optional[int]:
        """Bytes the caching allocator holds in this graph's pool (None off
        the card or before a capture).  ``segments``: a
        ``torch.cuda.memory_snapshot()`` already taken."""
        if self.pool is None or self.device.type != "cuda":
            return None
        pid = tuple(self.pool)
        if segments is None:
            segments = torch.cuda.memory_snapshot()
        return sum(seg["total_size"] for seg in segments
                   if seg.get("device", self.device.index) == self.device.index
                   and tuple(seg["segment_pool_id"]) == pid)

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
        for gen in self.generators:
            graph.register_generator_state(gen)
        with capture_lock, torch.cuda.device(self.device), _collection_paused():
            torch._C._cuda_clearCublasWorkspaces()
            try:
                with torch.cuda.graph(graph, capture_error_mode=self.capture_error_mode):
                    step()
            finally:
                torch._C._cuda_clearCublasWorkspaces()
        self.graph = graph
        self.pool = graph.pool()
        self.captures += 1
