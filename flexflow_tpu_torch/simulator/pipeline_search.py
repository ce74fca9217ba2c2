"""Pipeline (operator-placement) search: make stage assignment part of
the searched space (PyTorch port of
``flexflow_tpu/simulator/pipeline_search.py``, on the H100 node model).

The reference's searched space and its placement mechanism are one
thing — ParallelConfig device lists cover operator placement, so its
MCMC can discover pipeline-ish layouts (nmt/nmt.cc:269-308 encodes them
by hand).  Here the dim-degree search (search.py / ffsearch.cpp) covers
per-op SOAP dims, and this module extends it over the OTHER axis:
contiguous stage assignments executed by ``FFModel.set_pipeline``.

Cost model for a dp×pp plan with S ring slots and M microbatches
(the GPipe schedule of parallel/pipeline.py, priced as the JAX package
prices its scan, so that both packages pick the same plan from the same
costs):

    t_f/t_b  = per-microbatch fwd / bwd time of the slowest slot
               (per-op costs from the measured/calibrated CostModel at
               the dp-sharded, microbatched sub-shape)
    t_comm   = boundary hop per tick, priced at the largest flattened
               boundary; paid in both directions
    t_pipe   = (M + S - 1) · (t_f + t_b [+ t_f if remat] + 2·t_comm)
               + weight-sync allreduce

    mem      = weights·(1 + opt-state factor) + activation residuals:
               non-remat stashes each tick's slot interiors,
               remat stashes only the boundary carries and pays the
               recompute forward in t_pipe — the trade that lets M grow
               and the bubble fraction (S-1)/(M+S-1) shrink.  Plans over
               the HBM budget are rejected.

The searcher sweeps the (S, dp) grid (S·dp = devices) × every divisor
M of the local batch × {remat, no remat}, costs each plan, and returns
the best alongside the pure dim-search baseline so
``suggest_parallelization`` can answer: data-parallel, SOAP dims, or
pipeline?
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from ..config import ParallelConfig
from .cost_model import CostModel

from .machine import H100MachineModel
from .memory import HBM_SAFETY, dominant_term, weight_state_terms

DEFAULT_SEARCH_BUDGET = 8000  # the JAX package's config.DEFAULT_SEARCH_BUDGET


def _intended_host_placed(model, op) -> bool:
    """Will compile place ``op`` host-side?  ``op.pc`` when assigned;
    otherwise the configured strategy — search_pipeline runs BEFORE
    per-op pc resolution (compile calls it first) and offline tools
    search uncompiled models, so reading op.pc alone would make the
    hetero-head hoist dead in every real call path."""
    pc = getattr(op, "pc", None)
    if pc is None:
        pc = model.config.find_parallel_config(op.output.num_dims, op.name, 1)
    return bool(pc is not None and getattr(pc, "host_placed", False))


def _pipeline_segment(model):
    """(segment ops, tail ops, head ops) matching FFModel._plan_pipeline:
    trailing Softmax stays outside, host-placed row-sparse embeddings
    run host-side AHEAD of the ring (hetero head — their outputs feed
    stage 0 like extra inputs).  None when the chain has unsupported
    structure."""
    seg = list(model.ops)
    tail = []
    while seg and seg[-1]._type == "Softmax":
        tail.insert(0, seg.pop())
    # mirror the runtime hoist predicate on INTENDED placement:
    # candidate_ok covers the strategy-independent checks (own table,
    # graph-input index, every index consumer an own-table Embedding),
    # and all of the shared index's consumers must also be host-bound —
    # a device-placed sibling makes the runtime stream table-scaled
    eligible = getattr(model, "_sparse_embed_candidate_ok",
                       lambda _: False)

    def hoists(op):
        if not (op._type == "Embedding" and _intended_host_placed(model, op)
                and eligible(op)):
            return False
        idx_t = op.inputs[0]
        return all(_intended_host_placed(model, o) for o in model.ops
                   if any(t is idx_t for t in o.inputs))

    head = [op for op in seg if hoists(op)]
    head_ids = {id(op) for op in head}
    seg = [op for op in seg if id(op) not in head_ids]
    if len(seg) < 2:
        return None
    for op in seg:
        if op.has_running_stats:
            return None  # running stats unsupported in the ring
    return seg, tail, head


def _stage_prep(model, S: int):
    """M-independent planning for an S-slot ring: the stage split,
    dataflow boundaries, and pad width — hoisted so the divisor-M sweep
    doesn't redo it once per M.  None when no executable partition."""
    from ..parallel.pipeline_plan import balanced_stages, plan_boundaries

    pair = _pipeline_segment(model)
    if pair is None or S < 2:
        return None
    seg, tail, head = pair
    stages = balanced_stages(seg, S)
    if len(stages) != S:
        return None
    try:
        seg_ins, boundaries = plan_boundaries(
            stages, tail, set(model._constants.keys()),
            list(model.input_tensors) + [op.output for op in head])
    except ValueError:
        return None  # non-topological partition
    return stages, seg_ins, boundaries, head


def cost_pipeline_plan(model, machine: H100MachineModel, cost: CostModel,
                       S: int, dp: int, microbatches: int,
                       remat: Optional[bool] = None,
                       prep=None, reject_out: Optional[dict] = None
                       ) -> Optional[dict]:
    """{"t": simulated seconds/iteration, "m": the ADJUSTED microbatch
    count the plan actually uses, "mem": estimated per-device bytes,
    "remat": schedule} for a dp×S GPipe plan, or None when the plan is
    not executable (branching dataflow the ring cannot carry,
    shapes/batch that don't divide — validated with the SAME rules
    FFModel._plan_pipeline enforces) or over the HBM budget.  With
    ``remat=None`` both schedules are derived from ONE costing pass
    (remat only changes two arithmetic terms) and the cheaper in-budget
    one is returned.  ``prep``: a ``_stage_prep(model, S)`` result to
    reuse across an M sweep.  ``reject_out``: a dict the HBM gate fills
    when it rejects a schedule — ``reason`` names the dominant memory
    term (e.g. ``"hbm:activations"``) plus the offending byte counts —
    so the search trace can say WHY a plan died instead of silently
    skipping it."""
    batch = model.ops[0].output.dims[0]
    if batch % dp != 0:
        return None
    local_b = batch // dp
    M = min(microbatches, local_b)
    while local_b % M != 0:
        M -= 1
    mb = local_b // M
    if mb < 1:
        return None
    if prep is None:
        prep = _stage_prep(model, S)
    if prep is None:
        return None
    stages, seg_ins, boundaries, head = prep

    # per-slot per-microbatch compute: cost the op at batch degree
    # batch/mb (so the sub-shape's leading dim is the microbatch size)
    slot_f, slot_b, slot_act = [], [], []
    for g in stages:
        tf = tb = 0.0
        act = 0
        for op in g:
            deg0 = max(1, op.output.dims[0] // mb)
            pc = ParallelConfig(dims=(deg0,) + (1,) * (op.output.num_dims - 1))
            pc = op.legalize_pc(pc)
            tf += cost.op_time(op, pc, "forward")
            tb += cost.op_time(op, pc, "backward")
            # per-microbatch interior activations this slot stashes as
            # scan residuals when NOT remat'd
            act += int(np.prod(op.output.dims)) // max(1, op.output.dims[0]) \
                * mb
        slot_f.append(tf)
        slot_b.append(tb)
        slot_act.append(act)
    t_f, t_b = max(slot_f), max(slot_b)

    # boundary ring: buffers pad to the largest flattened bundle —
    # stage-0's input bundle, each hop's k packed tensors, the final
    # output (exactly what the runtime ships, model._run_pipeline_segment:
    # on a 16-bit payload an int32 tensor bitcasts into TWO lanes)
    two_lane = cost._dtype_bytes == 2.0

    def width(ts):
        return sum((int(np.prod(t.dims[1:])) if len(t.dims) > 1 else 1)
                   * (2 if two_lane and "int" in t.dtype else 1)
                   for t in ts)

    bounds = [width(seg_ins)]
    bounds += [width(hop) for hop in boundaries]
    bounds.append(width([stages[-1][-1].output]))
    pad = max(bounds)
    t_comm = machine.transfer_time(0, 1, cost._dtype_bytes * mb * pad)

    # weight sync: dp-replica grad allreduce of each slot's weights
    # (stage weights live only on their slot — model._plan_pipeline_pack)
    w_elems = max(
        sum(math.prod(w.dims) for op in g for w in op.weights) for g in stages)
    t_sync = (machine.allreduce_time(list(range(dp)), 4.0 * w_elems)
              if dp > 1 else 0.0)

    # hetero head: host tables gather/scatter on the host timeline,
    # which the runtime OVERLAPS with the device ring (async swap-in /
    # scatter-back) — the step costs the slower of the two timelines.
    # Omitting this entirely would report "pipeline beats dims" for
    # host-transfer-bound plans that execute slower.
    t_head = 0.0
    if head:
        t_head = sum(
            cost.op_time(op, hpc, "forward")
            + cost.op_time(op, hpc, "backward")
            for op in head
            for hpc in [ParallelConfig.host_rowsparse(op.output.num_dims)])

    ticks = M + S - 1
    carry_bytes = cost._dtype_bytes * mb * pad
    best = None
    for rm in ((False, True) if remat is None else (remat,)):
        # both scans pay the ring; remat's bwd tick recomputes the fwd
        t_pipe = max(ticks * (t_f + t_b + 2.0 * t_comm
                              + (t_f if rm else 0.0)) + t_sync,
                     t_head)
        # HBM budget: weight state (f32 master + grad + optimizer slot,
        # the shared simulator/memory.py terms) plus scan residuals
        # alive at the fwd->bwd turnaround — every tick's stash
        # (interiors drop out under remat)
        if rm:
            act = ticks * carry_bytes + max(slot_act) * cost._dtype_bytes
        else:
            act = ticks * (max(slot_act) * cost._dtype_bytes + carry_bytes)
        terms = weight_state_terms(w_elems, opt_slots=1)
        terms["activations"] = act
        mem = sum(terms.values())
        if mem > HBM_SAFETY * machine.hbm_capacity:
            if reject_out is not None:
                reject_out.update(
                    reason=f"hbm:{dominant_term(terms)}",
                    mem_bytes=int(mem),
                    budget_bytes=int(HBM_SAFETY * machine.hbm_capacity),
                    terms={k: int(v) for k, v in terms.items()})
            continue
        if best is None or t_pipe < best["t"]:
            best = {"t": t_pipe, "m": M, "mem": mem, "remat": rm}
    return best


def search_pipeline(model, machine_model: Optional[H100MachineModel] = None,
                    microbatches: Optional[int] = None,
                    compute_dtype: Optional[str] = None,
                    cost_model: Optional[CostModel] = None) -> Optional[Dict]:
    """Best (S, dp, M, remat) pipeline plan over the machine, or None
    when no executable plan exists.  Returns {"num_stages", "dp_degree",
    "num_microbatches", "remat", "simulated_s", "mem_bytes"}.  By
    default M sweeps EVERY divisor of the local batch (remat makes the
    large-M, small-bubble corner of the grid memory-feasible); passing
    ``microbatches`` restricts the sweep to {M, 2M} for callers that
    want the legacy behavior.  ``cost_model`` (over ``machine_model``)
    replaces the default one."""
    import contextlib

    from ..observability.events import active_log
    from ..observability.searchtrace import SearchRecorder

    nd = model.machine.num_devices if model.machine is not None \
        else model.config.num_devices
    mm = machine_model or H100MachineModel.calibrated(num_devices=nd)
    dtype = compute_dtype or model.config.compute_dtype
    cost = cost_model or CostModel(mm, measure=False, compute_dtype=dtype)
    batch = model.ops[0].output.dims[0] if model.ops else 0
    best = None
    tel = active_log()
    rec = SearchRecorder.maybe("pipeline", 0, nd, log=tel)
    span = tel.span("pipeline_search", num_devices=nd) \
        if tel is not None else contextlib.nullcontext({})
    with span as span_attrs:
        plans = 0
        for S in [d for d in range(2, nd + 1) if nd % d == 0]:
            dp = nd // S
            if batch <= 0 or batch % dp != 0:
                continue
            local_b = batch // dp
            if microbatches is None:
                Ms = [m for m in range(1, local_b + 1) if local_b % m == 0]
            else:
                Ms = sorted({microbatches, 2 * microbatches})
            prep = _stage_prep(model, S)
            if prep is None:
                continue
            for M in Ms:
                reject: dict = {}
                r = cost_pipeline_plan(model, mm, cost, S, dp, M,
                                       prep=prep, reject_out=reject)
                if r is None:
                    if reject and rec is not None:
                        # over-HBM plans are recorded, not silently
                        # skipped — the reason names the dominant term
                        rec.plan(f"S{S}xdp{dp},M{M}", cost_ms=0.0,
                                 accepted=False, stages=S, dp=dp, m=M,
                                 reason=reject["reason"],
                                 mem_bytes=reject["mem_bytes"],
                                 budget_bytes=reject["budget_bytes"])
                    continue
                plans += 1
                improved = best is None or r["t"] < best["simulated_s"]
                if rec is not None:
                    rec.plan(f"S{S}xdp{dp},M{r['m']}"
                             f"{',remat' if r['remat'] else ''}",
                             cost_ms=r["t"] * 1e3, accepted=improved,
                             stages=S, dp=dp, m=r["m"], remat=r["remat"])
                if improved:
                    # report the ADJUSTED microbatch count the costing
                    # used — the requested one may not divide the batch
                    best = {"num_stages": S, "dp_degree": dp,
                            "num_microbatches": r["m"], "remat": r["remat"],
                            "simulated_s": r["t"], "mem_bytes": r["mem"]}
            if tel is not None:
                tel.event("search_progress", engine="pipeline", iter=S,
                          best_ms=round(best["simulated_s"] * 1e3, 3)
                          if best else 0.0)
        span_attrs["plans"] = plans
        if best is not None:
            span_attrs["best_ms"] = round(best["simulated_s"] * 1e3, 3)
    return best


def suggest_parallelization(model, budget: Optional[int] = None,
                            machine_model: Optional[H100MachineModel] = None,
                            seed: int = 0,
                            microbatches: Optional[int] = None,
                            engine: str = "") -> Dict:
    """Search BOTH spaces — per-op SOAP dims and pipeline stage
    assignment — and return the faster plan:

        {"kind": "dims"|"pipeline", "simulated_s": t,
         "strategies": {...} | "pipeline": {...},
         "alternatives": {"dims_s": t1, "pipeline_s": t2}}

    ``engine`` selects the dim searcher: "" (the C++ annealer, or "mcmc"
    when its library cannot be built), "native" (the annealer, or raise),
    "mcmc" (one Python annealed chain) or "population"
    (simulator/population.py).
    """
    from .native_search import native_mcmc_search, unavailable
    from .search import mcmc_search
    from .simulator import Simulator

    if budget is None:
        budget = DEFAULT_SEARCH_BUDGET
    if engine not in ("", "mcmc", "native", "population"):
        raise ValueError(f"unknown search engine {engine!r} "
                         "(expected '', 'mcmc', 'native' or 'population')")
    nd = model.machine.num_devices if model.machine is not None \
        else model.config.num_devices
    mm = machine_model or H100MachineModel.calibrated(num_devices=nd)
    cost = CostModel(mm, measure=False,
                     compute_dtype=model.config.compute_dtype)
    sim = Simulator(mm, cost)

    best_dims = None
    if engine == "population":
        from .population import population_search

        best_dims = population_search(model, budget=budget,
                                      machine_model=mm, seed=seed,
                                      verbose=False, cost_model=cost)
    elif engine in ("", "native") and unavailable(engine) is None:
        best_dims = native_mcmc_search(model, budget=budget, machine_model=mm, seed=seed,
                                       verbose=False, cost_model=cost)
    if best_dims is None:
        # share this function's CostModel so the anneal reuses the memo
        # caches the pipeline grid pass is about to warm (and vice versa)
        best_dims = mcmc_search(model, budget=budget, machine_model=mm,
                                seed=seed, verbose=False, cost_model=cost)
    # both engines report the simulated cost of the plan they return —
    # re-simulate only for a caller-supplied plain dict
    dims_t = getattr(best_dims, "best_s", None)
    if dims_t is None:
        dims_t = sim.simulate_runtime(model, best_dims)

    pipe = search_pipeline(model, machine_model=mm,
                           microbatches=microbatches)
    out = {"alternatives": {"dims_s": dims_t,
                            "pipeline_s": pipe["simulated_s"] if pipe else None}}
    if pipe is not None and pipe["simulated_s"] < dims_t:
        out.update(kind="pipeline", simulated_s=pipe["simulated_s"],
                   pipeline=pipe)
    else:
        out.update(kind="dims", simulated_s=dims_t, strategies=best_dims)
    return out
