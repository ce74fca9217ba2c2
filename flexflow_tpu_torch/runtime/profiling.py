"""Profiling and tracing hooks (PyTorch port of the JAX package's
``runtime/profiling.py``).

  * ``trace(logdir)``: a ``torch.profiler`` trace of the block (host and,
    on a card, CUDA activity), written as a Chrome trace to
    ``<logdir>/trace.json``;
  * ``annotate(name)``: a named region in that timeline
    (``torch.profiler.record_function``);
  * ``op_profile(model)``: each op's forward and backward device time,
    measured standalone on the model's device with the simulator's timer
    (``CostModel._measure_real``, the fragments ``observability/opprof.py``
    times on its cadence), printed like the reference's per-op
    ``--profiling`` lines by ``print_op_profile``.  With telemetry on,
    each op's times are an ``op_profile`` event, beside a per-op
    ``sim_divergence`` row against the simulator's price.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict


@contextlib.contextmanager
def trace(logdir: str = "ff_torch_trace"):
    """Capture a ``torch.profiler`` trace of the block into
    ``<logdir>/trace.json`` (open it in Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region in the profiler timeline."""
    from torch.profiler import record_function

    return record_function(name)


def op_profile(model, which: str = "both") -> Dict[str, Dict[str, float]]:
    """Measure each op's standalone forward and backward time on the
    model's device, at the sub-shape of its resolved config.  Returns
    ``{op_name: {"forward_ms": x, "backward_ms": y}}``."""
    from ..observability import agreement
    from ..observability.opprof import fragment_timer

    cm = fragment_timer(model)
    out: Dict[str, Dict[str, float]] = {}
    for op in model.ops:
        fwd, bwd = cm._measure_real(op, op.pc)
        entry = {}
        if which in ("both", "forward"):
            entry["forward_ms"] = fwd * 1e3
        if which in ("both", "backward"):
            entry["backward_ms"] = bwd * 1e3
        out[op.name] = entry
    tel = getattr(model, "_telemetry", None)
    if tel is not None:
        # the non-measuring cost model's price for the same shapes: the
        # simulator-agreement side of each measured time
        predicted = agreement.predict_op_times(model)
        for name, t in out.items():
            tel.event("op_profile", op=name,
                      forward_ms=round(t.get("forward_ms", 0.0), 4),
                      backward_ms=round(t.get("backward_ms", 0.0), 4))
            pred = predicted[name]
            for w in ("forward", "backward"):
                if f"{w}_ms" in t:
                    agreement.emit_op_divergence(tel, name, w, pred[f"{w}_ms"], t[f"{w}_ms"],
                                                 src=pred[f"{w}_src"])
        tel.flush()
    return out


def print_op_profile(model) -> None:
    """Reference-style per-op ms printout (conv_2d.cu:448-473 style)."""
    for name, t in op_profile(model).items():
        fwd = t.get("forward_ms", 0.0)
        bwd = t.get("backward_ms", 0.0)
        print(f"[profiling] {name}: forward {fwd:.3f} ms, backward {bwd:.3f} ms")
