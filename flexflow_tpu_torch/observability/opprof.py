"""Measured per-op runtime attribution on a training cadence (PyTorch port
of the JAX package's ``observability/opprof.py``).

Every ``FF_OPPROF`` steps this module times a slice of the model's ops as
standalone forward and backward fragments under a wall-clock budget and

  * emits an ``op_runtime`` event per measured fragment: measured vs the
    non-measuring cost model's prediction, with both sides' provenance
    (``src``: measured-cache hit or roofline; ``measured_src``: "opprof"),
  * emits the matching per-op ``sim_divergence`` rows, so
    ``health_report`` folds in-training measurements into the same
    agreement table as standalone profiles,
  * appends each measured time to the measured corpus
    (``FF_OPPROF_CORPUS``) in the schema ``tools/calibrate.py`` fits from,
    tagged with the device it ran on (a card's name and power limit,
    ``cost_model.card_label()``, or "cpu"): a CPU fragment never stands
    for a card's timing, and no entry is taken for a TPU's.

The fragments are the simulator's own timer, ``CostModel._measure_real``
(simulator/cost_model.py): the op's part at its resolved config, on
inputs and weights of its own drawn from a seeded generator (it never
reads or writes the model's parameters or optimizer state), forward
then backward between CUDA events behind a held stream, so the times
are device times.  ``runtime/profiling.op_profile`` runs the same timer.

Knobs (parsed loudly):

  FF_OPPROF           cadence in steps (int >= 1); unset = disabled
  FF_OPPROF_BUDGET_S  wall budget per pass, default 2.0 s; the pass
                      round-robins across ops and stops mid-list when
                      the budget is spent, resuming there next time
  FF_OPPROF_CORPUS    measured-corpus path (default: the committed
                      ``simulator/measured_h100.json``, as the JAX
                      package defaults to its committed cache)

Disabled, this module costs nothing: ``maybe_profiler`` returns None and
the per-step hook is one ``is not None`` test.  Step 0 is never measured,
and a pass runs between steps (``StepStats`` drives it after a step's
events are read), never inside a CUDA-graph capture.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from . import agreement

DEFAULT_BUDGET_S = 2.0


def cadence_from_env() -> Optional[int]:
    """``FF_OPPROF`` as a step cadence, None when unset/empty."""
    raw = os.environ.get("FF_OPPROF", "")
    if raw == "":
        return None
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"FF_OPPROF={raw!r} is not an integer step cadence") from None
    if n < 1:
        raise ValueError(f"FF_OPPROF={n} must be >= 1")
    return n


def budget_from_env() -> float:
    raw = os.environ.get("FF_OPPROF_BUDGET_S", "")
    if raw == "":
        return DEFAULT_BUDGET_S
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"FF_OPPROF_BUDGET_S={raw!r} is not a number") from None
    if v <= 0:
        raise ValueError(f"FF_OPPROF_BUDGET_S={v} must be > 0")
    return v


def corpus_path_from_env() -> str:
    path = os.environ.get("FF_OPPROF_CORPUS", "")
    if path:
        return path
    from ..simulator.cost_model import MEASURED_CACHE

    return MEASURED_CACHE


def fragment_timer(model, cache_path: str = ""):
    """A measuring ``CostModel`` on the model's device, whose
    ``_measure_real(op, pc)`` times one op's forward and backward
    fragments and whose ``_persist`` appends to ``cache_path`` ('' keeps
    nothing)."""
    from ..simulator.cost_model import CostModel
    from ..simulator.machine import H100MachineModel

    nd = model.machine.num_devices if model.machine else 1
    return CostModel(H100MachineModel.calibrated(num_devices=nd), measure=True,
                     cache_path=cache_path, compute_dtype=model.config.compute_dtype,
                     target_platform=model.device.type, device=model.device)


def maybe_profiler(model, log) -> Optional["OpProfiler"]:
    """Resolve the per-model profiler at ``compile()``: None unless
    ``FF_OPPROF`` is set and telemetry is on."""
    cadence = cadence_from_env()
    if cadence is None or log is None:
        return None
    return OpProfiler(model, log, cadence=cadence, budget_s=budget_from_env(),
                      corpus_path=corpus_path_from_env())


class OpProfiler:
    """Round-robin per-op fragment timer driven by ``StepStats``."""

    def __init__(self, model, log, cadence: int,
                 budget_s: float = DEFAULT_BUDGET_S,
                 corpus_path: str = ""):
        self.model = model
        self.log = log
        self.cadence = int(cadence)
        self.budget_s = float(budget_s)
        self._rr = 0                       # round-robin cursor into ops
        self._corpus_path = corpus_path
        self._timer = None
        self._predicted: Optional[Dict[str, Dict[str, Any]]] = None
        self.passes = 0
        self.measured_total = 0

    def on_step(self, step_idx: int) -> None:
        if step_idx == 0 or step_idx % self.cadence != 0:
            return
        self._run_pass(step_idx)

    def _run_pass(self, step_idx: int) -> None:
        ops = [op for op in self.model.ops
               if getattr(op, "pc", None) is not None and not op.pc.host_placed]
        if not ops:
            return
        if self._timer is None:
            self._timer = fragment_timer(self.model, self._corpus_path)
            self._predicted = agreement.predict_op_times(self.model)
        cm, tag = self._timer, self._timer.measurement_tag()
        t_start = time.perf_counter()
        measured = 0
        for i in range(len(ops)):
            if time.perf_counter() - t_start >= self.budget_s:
                break
            op = ops[(self._rr + i) % len(ops)]
            pred = self._predicted.get(op.name, {})
            for which, t in zip(("forward", "backward"), cm._measure_real(op, op.pc)):
                meas_ms = t * 1e3
                pred_ms = float(pred.get(f"{which}_ms", 0.0))
                src = pred.get(f"{which}_src", "analytic")
                self.log.event("op_runtime", op=op.name, which=which,
                               measured_ms=round(meas_ms, 4),
                               predicted_ms=round(pred_ms, 4),
                               ratio=round(pred_ms / meas_ms, 4) if meas_ms > 0 else 0.0,
                               src=src, step=int(step_idx))
                agreement.emit_op_divergence(self.log, op.name, which, pred_ms, meas_ms,
                                             src=src, measured_src="opprof")
                cm._persist(cm._key(op, op.pc, which), float(t), tag)
            measured += 1
        self._rr = (self._rr + max(1, measured)) % len(ops)
        self.passes += 1
        self.measured_total += measured
        self.log.event("op_runtime_pass", step=int(step_idx),
                       ops_measured=int(measured), ops_total=len(ops),
                       elapsed_s=round(time.perf_counter() - t_start, 4))
        self.log.flush()
