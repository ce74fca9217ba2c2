"""Per-step training instrumentation (PyTorch port of the JAX package's
``observability/stepstats.py``).

Computes, per ``update()``:

  * the step's time.  On a CUDA device it is DEVICE time: two
    ``torch.cuda.Event``s recorded on the step's stream around the step
    (a CUDA-graph replay returns at once, so host walls between updates
    would time only how fast the host enqueues).  The events are read one
    step late, and only once they have completed (``query()``), so the
    step gains no host sync; ``flush()`` (``FFModel.sync`` calls it)
    waits for the rest.  ``FF_TELEMETRY_SYNC=1`` adds a
    ``torch.cuda.synchronize()`` inside each timed step instead, as the
    JAX package's ``model.sync()``, and emits each step at once.  On the
    CPU it is the host wall of the step, emitted at once, as in the JAX
    package;
  * the steps that do more than a step are marked ``first``: the first
    step (of a signature, on the compiled path: an eager step on a side
    stream) and the step that captures the CUDA graph (also
    ``capture=true``).  The health monitor keeps them out of its rolling
    median and the reports count them as compile;
  * samples/s and samples/s/device;
  * analytic-FLOP MFU: 3x the graph's forward FLOPs (forward, dgrad and
    wgrad, as the JAX package counts them) times samples/s over the
    H100 machine model's peak (``H100MachineModel.calibrated().peak_flops``,
    989e12 bf16 dense by the spec sheet);
  * the estimated per-step collective bytes from each op's resolved
    ``ParallelConfig``;
  * device memory: ``torch.cuda.memory_stats()`` (``allocated_bytes.all``
    current and peak, and the card's total as the limit); the CPU
    reports none.

Everything here is reached only through a non-None EventLog resolved at
``compile()``: with telemetry off this module is never imported.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Optional

import numpy as np

from .events import EventLog
from .health import write_heartbeat
from .reqtrace import run_trace_id

# Memory gauges are cheap but chatty; sample every N steps.
MEM_GAUGE_EVERY = 8

# Steps whose events may wait unread before the oldest is waited for.
MAX_PENDING = 64


def estimate_collective_bytes(model) -> int:
    """Rough per-step collective traffic implied by the resolved per-op
    strategies (the JAX package's two analytic terms):

      * gradient synchronization: weights replicated across a batch
        degree d all-reduce their f32 grads, ``2 (d-1)/d * bytes``,
      * activation redistribution: an output split on a non-batch dim
        with degree d costs ~``(d-1)/d`` of the output's bytes.
    """
    dt_bytes = 2 if "16" in model.config.compute_dtype else 4
    total = 0.0
    for op in model.ops:
        pc = getattr(op, "pc", None)
        if pc is None or pc.host_placed:
            continue
        d0 = pc.dims[0]
        if d0 > 1 and op.weights:
            wbytes = sum(float(np.prod(w.dims)) for w in op.weights) * 4.0
            total += 2.0 * (d0 - 1) / d0 * wbytes
        obytes = float(np.prod(op.output.dims)) * dt_bytes
        for d in pc.dims[1:]:
            if d > 1:
                total += (d - 1) / d * obytes
    return int(total)


# allocator-stat keys, with the short ``kind`` label they export under on
# /metrics (``ff_hbm_bytes{device,kind}``), as the JAX package names them
MEM_STAT_KINDS = (("bytes_in_use", "in_use"),
                  ("peak_bytes_in_use", "peak"),
                  ("bytes_limit", "limit"))


def device_memory_stats(device) -> Optional[list]:
    """``[{"device": i, "bytes_in_use", "peak_bytes_in_use",
    "bytes_limit"}]`` for a CUDA ``device`` from its caching allocator;
    None on the CPU, which reports none."""
    import torch

    if device.type != "cuda":
        return None
    ms = torch.cuda.memory_stats(device)
    return [{"device": device.index or 0,
             "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
             "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
             "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory)}]


class StepStats:
    """Times ``update()`` calls and folds the numbers into the event log.
    One instance per model, created at ``compile()`` when telemetry is on."""

    def __init__(self, model, log: EventLog):
        self.model = model
        self.log = log
        self.trace_id = run_trace_id(log.run_id)
        self.steps = 0
        self.sync_each_step = bool(os.environ.get("FF_TELEMETRY_SYNC"))
        self._cuda = model.device.type == "cuda"
        self._pending: collections.deque = collections.deque()
        self._fwd_flops_per_sample: Optional[float] = None
        self._peak_flops: Optional[float] = None
        self._collective_bytes: Optional[int] = None

    # -- statics (graph and machine are fixed after compile) -------------
    def _statics(self):
        if self._fwd_flops_per_sample is None:
            from ..simulator.machine import H100MachineModel

            self._fwd_flops_per_sample = float(
                sum(op.flops_per_sample() for op in self.model.ops))
            self._peak_flops = float(
                H100MachineModel.calibrated(num_devices=self._num_devices()).peak_flops)
            self._collective_bytes = estimate_collective_bytes(self.model)
        return self._fwd_flops_per_sample, self._peak_flops

    def _num_devices(self) -> int:
        return self.model.machine.num_devices if self.model.machine else 1

    # -- the step --------------------------------------------------------
    def timed_update(self, fn) -> None:
        """Run one training step and account for it.  ``fn`` returns what
        the step was on the compiled path ("eager", "capture" or "replay",
        ``StepGraph.run``), None off it."""
        step_idx = self.model._step_count
        # heartbeat before dispatch: a wedged step leaves "step" on disk
        write_heartbeat("step", step=step_idx)
        if not self._cuda:
            t0 = time.perf_counter()
            kind = fn()
            dur = time.perf_counter() - t0
            self.steps += 1
            self._emit(step_idx, self.steps, t0, dur, self._first(kind), kind == "capture")
            return
        import torch

        self._emit_ready(block=False)
        stream = torch.cuda.current_stream(self.model.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record(stream)
        kind = fn()
        end.record(stream)
        self.steps += 1
        self._pending.append((step_idx, self.steps, t0, start, end, self._first(kind),
                              kind == "capture"))
        if self.sync_each_step:
            torch.cuda.synchronize(self.model.device)
            self._emit_ready(block=True)
        elif len(self._pending) > MAX_PENDING:
            self._pending[0][4].synchronize()
            self._emit_ready(block=False)

    def _first(self, kind: Optional[str]) -> bool:
        """Whether the step just taken did more than a step: the first one,
        a new signature's eager step or the capture."""
        return self.steps == 1 or kind in ("eager", "capture")

    def flush(self) -> None:
        """Wait for the steps still unread and emit them."""
        self._emit_ready(block=True)

    def _emit_ready(self, block: bool) -> None:
        while self._pending:
            step_idx, ordinal, t0, start, end, first, capture = self._pending[0]
            if block:
                end.synchronize()
            elif not end.query():
                return
            self._pending.popleft()
            self._emit(step_idx, ordinal, t0, start.elapsed_time(end) / 1e3, first,
                       capture)

    def _emit(self, step_idx: int, ordinal: int, t0: float, dur: float,
              first: bool, capture: bool) -> None:
        """Fold one timed step (the ``ordinal``-th this object timed) into
        the log, then drive the health monitor and the op profiler."""
        log = self.log
        fwd_fps, peak = self._statics()
        bs = self.model.config.batch_size
        nd = self._num_devices()
        sps = bs / dur if dur > 0 else 0.0
        mfu = (3.0 * fwd_fps * sps / (nd * peak)) if peak else 0.0
        extra = {"capture": True} if capture else {}
        log.span_at("step", t0, dur, step=step_idx, first=first,
                    trace_id=self.trace_id, batch_size=bs,
                    samples_per_sec=round(sps, 2),
                    samples_per_sec_per_chip=round(sps / nd, 2),
                    mfu=round(mfu, 6), **extra)
        log.counter("samples", float(bs))
        log.gauge("samples_per_sec", round(sps, 2))
        log.gauge("samples_per_sec_per_chip", round(sps / nd, 2))
        log.gauge("mfu", round(mfu, 6))
        if ordinal == 1:
            # the first step includes the compile: eager warm-up on the card
            log.gauge("first_step_wall_s", round(dur, 6))
            log.gauge("est_collective_bytes_per_step", float(self._collective_bytes))
        if ordinal == 1 or ordinal % MEM_GAUGE_EVERY == 0:
            mems = device_memory_stats(self.model.device)
            if mems:
                for rec in mems:
                    dev = str(rec["device"])
                    for k, kind in MEM_STAT_KINDS:
                        log.gauge("hbm_bytes", float(rec[k]), device=dev, kind=kind)
                for k in ("bytes_in_use", "peak_bytes_in_use"):
                    log.gauge(f"device_{k}", float(mems[0][k]))
        log.flush()
        health = getattr(self.model, "_health", None)
        if health is not None:
            health.on_step(step_idx, log.to_rel(t0), dur, first)
        opprof = getattr(self.model, "_opprof", None)
        if opprof is not None:
            opprof.on_step(step_idx)
