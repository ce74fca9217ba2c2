"""Per-device memory under a strategy map: the predicted view (PyTorch
port of ``flexflow_tpu/simulator/memory.py``).

The source paper's search optimizes step time and leaves memory to the
runtime.  This module prices what each device holds under a SOAP strategy
map, term by term:

  * ``params``      - f32 master weights, the op's ``weight_tile`` per
                      part (replicated batch degrees hold full copies),
  * ``grads``       - f32 gradients, same tiling,
  * ``optimizer``   - f32 slot buffers (momentum, Adam m and v), named by
                      the optimizer's class; under ZeRO-1 divided as the
                      runtime shards them (``zero_share``),
  * ``activations`` - stored forward outputs (``output_tile`` per part in
                      the activation dtype), the residuals backward reads,
  * ``staging``     - transient collective buffers: one grad-sized ring
                      buffer per batch-replicated weight and the
                      all-gather/reduce-scatter share of non-batch output
                      splits; an offloaded weight and its gradient, which
                      the step streams through the device.

A host-resident row-sparse table holds no device memory.

Against the machine model's ``hbm_capacity`` (80 GB on an H100) it gives
the headroom.  It is an estimate, not an allocator: the caching allocator
and cuDNN/cuBLAS workspaces add to it, and kernels that recompute or free
early take from it; ``chip_smoke.py`` prints it beside
``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np

from ..config import ParallelConfig
from .simulator import devices_of, host_sparse, resolve_pc

# Shared safety factor: plans predicted to use more than this share of
# HBM leave no room for fragmentation and library workspaces.
HBM_SAFETY = 0.9

# Term order is the presentation order everywhere (report, doctor,
# rejection reasons).
TERMS = ("params", "grads", "optimizer", "activations", "staging")

_F32 = 4.0  # master weights / grads / slots stay f32


def optimizer_slots(optimizer: Any) -> int:
    """f32 slot buffers per parameter element the optimizer keeps on
    device, by the optimizer's class name: Adam-family keeps (m, v); SGD
    keeps momentum iff enabled; unknown optimizers (and ``None``: search
    time, no optimizer yet) price one slot."""
    if optimizer is None:
        return 1
    name = type(optimizer).__name__.lower()
    if "adam" in name or "lamb" in name:
        return 2
    if "sgd" in name:
        return 1 if getattr(optimizer, "momentum", 0.0) > 0.0 else 0
    return 1


def weight_state_terms(w_elems: float, opt_slots: int = 1) -> Dict[str, float]:
    """Weight-state bytes for ``w_elems`` parameter elements: f32 master
    + f32 grad + ``opt_slots`` f32 slot buffers."""
    return {"params": _F32 * w_elems,
            "grads": _F32 * w_elems,
            "optimizer": _F32 * opt_slots * w_elems}


def zero_share(w, pc: ParallelConfig, nd: int) -> int:
    """The number of row slices ZeRO-1 cuts a weight's optimizer state
    into on ``nd`` devices, as ``FFModel._zero_state_placements`` lays it
    out: its leading dim over every device the weight's split leaves free
    (``nd`` over the weight's split degree), where that dim is unsplit and
    divides; else 1 (and a pipe-packed weight's state is never cut).  The
    JAX package's memory model divides by the batch degree instead, the
    same only for a weight split on nothing but the batch under a config
    that fills the machine."""
    degs = [pc.dims[pd] if pd is not None and pd < len(pc.dims) else 1
            for pd in w.partition_dims]
    free = nd // math.prod(degs)
    if nd <= 1 or free <= 1 or degs[0] > 1 or w.dims[0] % free:
        return 1
    return free


def dominant_term(terms: Dict[str, float]) -> str:
    """The largest term's name — what a rejection/divergence names."""
    return max(terms, key=lambda k: terms[k])


def memory_per_device(model, strategies: Optional[Dict[str, ParallelConfig]]
                      = None, machine_model=None,
                      optimizer: Any = None,
                      opt_slots: Optional[int] = None) -> Dict[str, Any]:
    """Predicted HBM bytes per device under ``strategies`` (keyed by op
    name; missing ops fall back to their resolved pc, then data
    parallelism — the same resolution ``Simulator.simulate_runtime``
    uses).  Returns per-device term breakdowns, the peak device and its
    dominant term, per-op attribution, and — when ``machine_model``
    carries ``hbm_capacity`` — the headroom against it."""
    strategies = strategies or {}
    if machine_model is not None:
        nd = machine_model.num_devices
    elif getattr(model, "machine", None) is not None:
        nd = model.machine.num_devices
    else:
        nd = model.config.num_devices
    nd = max(1, int(nd))
    elem_bytes = 2.0 if "16" in model.config.compute_dtype else 4.0
    if opt_slots is None:
        opt_slots = optimizer_slots(
            optimizer if optimizer is not None
            else getattr(model, "optimizer", None))
    zero = bool(getattr(model.config, "zero_optimizer", False))

    per = [{t: 0.0 for t in TERMS} for _ in range(nd)]
    by_op: Dict[str, Dict[str, Any]] = {}

    def vol(ranges) -> float:
        return float(np.prod([hi - lo + 1 for lo, hi in ranges])) \
            if ranges else 1.0

    for op in model.ops:
        pc = resolve_pc(op, strategies, nd)
        op_dev = [0.0] * nd
        if host_sparse(op, pc):
            # a host-resident row-sparse table holds no device memory
            by_op[op.name] = {"bytes": 0, "parts": pc.num_parts(),
                              "dims": "x".join(map(str, pc.dims)), "host": True}
            continue
        devs = devices_of(pc, nd)
        parts = pc.num_parts()
        # allgather/reduce-scatter fraction at non-batch output splits
        stage_frac = sum((d - 1) / d for d in pc.dims[1:] if d > 1)
        for j in range(parts):
            d = devs[j]
            out_b = vol(op.output_tile(pc, j)) * elem_bytes
            per[d]["activations"] += out_b
            op_dev[d] += out_b
            if stage_frac > 0.0:
                per[d]["staging"] += stage_frac * out_b
                op_dev[d] += stage_frac * out_b
        if op.weights:
            d0 = pc.dims[0] if pc.dims else 1
            for wi in range(len(op.weights)):
                w = op.param_weights[wi]
                packed = getattr(model, "_pipeline_plan", None) and \
                    model._pack_entry(op.name, w.name) is not None
                share = zero_share(w, pc, nd) if zero and not packed else 1
                for j in range(parts):
                    d = devs[j]
                    w_elems = vol(op.weight_tile(pc, wi, j))
                    ws = weight_state_terms(w_elems, opt_slots)
                    if pc.host_placed:
                        # offloaded: held on the host, the step streams the
                        # weight and its gradient through the device
                        b = ws["params"] + ws["grads"]
                        per[d]["staging"] += b
                        op_dev[d] += b
                        continue
                    per[d]["params"] += ws["params"]
                    per[d]["grads"] += ws["grads"]
                    opt_b = ws["optimizer"] / share
                    per[d]["optimizer"] += opt_b
                    op_dev[d] += ws["params"] + ws["grads"] + opt_b
                    if d0 > 1:
                        # ring-allreduce staging: one grad-sized buffer
                        per[d]["staging"] += ws["grads"]
                        op_dev[d] += ws["grads"]
        by_op[op.name] = {"bytes": int(max(op_dev)), "parts": parts,
                          "dims": "x".join(map(str, pc.dims)),
                          "host": bool(pc.host_placed)}

    per_device = []
    for d in range(nd):
        row = {t: int(per[d][t]) for t in TERMS}
        row["total"] = sum(row[t] for t in TERMS)
        per_device.append(row)
    peak_device = max(range(nd), key=lambda d: per_device[d]["total"])
    peak_row = per_device[peak_device]
    out: Dict[str, Any] = {
        "num_devices": nd,
        "elem_bytes": elem_bytes,
        "opt_slots": int(opt_slots),
        "zero_optimizer": zero,
        "per_device": per_device,
        "peak_bytes": peak_row["total"],
        "peak_device": peak_device,
        "dominant_term": dominant_term(
            {t: peak_row[t] for t in TERMS}),
        "by_op": by_op,
    }
    cap = getattr(machine_model, "hbm_capacity", None)
    if cap:
        out["capacity_bytes"] = int(cap)
        out["budget_bytes"] = int(HBM_SAFETY * cap)
        out["headroom_bytes"] = int(cap - peak_row["total"])
    return out
