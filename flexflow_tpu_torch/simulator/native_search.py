"""The native (C++) strategy search: candidate enumeration and marshalling
(PyTorch port of ``flexflow_tpu/simulator/native_search.py``).

The annealing loop, the task-graph construction and the event loop run in
``native/ffsearch.cpp`` (the analogue of the reference's pure-C++ offline
searcher, scripts/simulator.cc:1420-1472), over the H100 machine model:
NVSwitch within a node of 8, InfiniBand between nodes.  This module
enumerates each op's candidate configs (``enumerate_candidates``: the
space the MCMC proposals reach, over the port's ``splittable_dims`` and
legalizer, so H/W tiles, the LSTM's hidden split, the experts and host
tables included), prices each with the cost model ``search.search_setup``
builds (the one ``mcmc_search`` prices with, so both engines optimise one
objective, inter-node resharding on the hybrid mesh included), cuts each
into its part rectangles, flattens it all to arrays and runs the engine
through ``ctypes``.

Where the JAX package's ``native_mcmc_search`` returns a tuple, or None
when its library is missing, the port's returns a ``SearchResult`` and
raises when the library cannot be built (``utils/native.py``).
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import ParallelConfig
from ..observability.events import active_log
from ..observability.searchtrace import SearchRecorder
from ..parallel.mesh import assign_axes, hybrid_mesh_shape
from ..utils.native import load
from .cost_model import CostModel
from .machine import GPUS_PER_NODE
from .search import (SearchResult, _divisors, attach_learned_tier, data_parallel_start,
                     learned_flag, search_setup, splittable_dims)
from .simulator import devices_of, host_sparse


def _factorizations(n: int, dims_avail: List[int], out_dims) -> List[Tuple[int, ...]]:
    """All assignments of factor ``n`` over ``dims_avail`` that divide the
    tensor dims, as full-rank degree tuples."""
    rank = len(out_dims)
    results = []

    def rec(rem: int, idx: int, degrees: List[int]):
        if rem == 1:
            results.append(tuple(degrees))
            return
        if idx >= len(dims_avail):
            return
        d = dims_avail[idx]
        for f in _divisors(rem):
            if out_dims[d] % f == 0:
                degrees[d] = f
                rec(rem // f, idx + 1, degrees)
        degrees[d] = 1

    rec(n, 0, [1] * rank)
    return results


def composes(degrees, nd: int) -> bool:
    """Whether a degree vector lowers onto the mesh of ``nd`` GPUs (whole
    nodes of 8 beyond one node: the hybrid mesh), as compile lowers it
    (``parallel/mesh.assign_axes``)."""
    nodes = max(1, -(-nd // GPUS_PER_NODE))
    sizes, names = hybrid_mesh_shape(nd, nodes)
    try:
        assign_axes(names, sizes, degrees)
    except ValueError:
        return False
    return True


def enumerate_candidates(op, nd: int, model=None) -> List[ParallelConfig]:
    """Every config the random proposals can reach, in a fixed order, with
    block-aligned placements for configs of fewer parts than devices (what
    ``tools/calibrate.py`` measures), less those that do not compose over
    the mesh or that the op refuses (``check_config``).  With ``model``, an
    embedding the model can hold as a row-sparse host table also gets a
    host placement (the hetero DLRM strategies' CPU placement, which the
    search can then find)."""
    splittable = list(splittable_dims(op))
    seen = set()
    cands: List[ParallelConfig] = []
    for n in _divisors(nd):
        for degrees in _factorizations(n, splittable, op.output.dims):
            if not composes(degrees, nd) or not _runs(op, ParallelConfig(dims=degrees)):
                continue
            parts = int(np.prod(degrees))
            for off in range(0, nd - parts + 1, parts):
                ids = tuple(range(off, off + parts))
                if (degrees, ids) in seen:
                    continue
                seen.add((degrees, ids))
                cands.append(ParallelConfig(dims=degrees).with_device_ids(ids))
    if model is not None and getattr(model, "_sparse_embed_candidate_ok", lambda _: False)(op):
        cands.append(ParallelConfig.host_rowsparse(op.output.num_dims))
    return cands


def _runs(op, pc: ParallelConfig) -> bool:
    try:
        op.check_config(pc)
    except ValueError:
        return False
    return True


def native_lib() -> ctypes.CDLL:
    """``native/ffsearch.cpp``'s library, built at first use."""
    lib = load("ffsearch.cpp")
    if not getattr(lib, "_ff_configured", False):
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.ffsearch_anneal.restype = ctypes.c_double
        lib.ffsearch_anneal.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, i32p, i32p, i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, i32p, i64p,
            i32p, i32p, i32p, f64p, f64p, i64p, i32p, i64p, i64p, i64p, i64p,
            ctypes.c_int32, ctypes.c_double, ctypes.c_uint64, ctypes.c_int32,
            i32p, i32p, f64p, i64p]
        lib._ff_configured = True
    return lib


def unavailable(engine: str) -> Optional[str]:
    """For ``search_engine`` "" or "native": None when the annealer's
    library builds, else why not (the build error) for "", whose caller
    then runs mcmc as the JAX package does; "native" raises."""
    try:
        native_lib()
    except RuntimeError as e:
        if engine == "native":
            raise
        return str(e)
    return None


def _legal_candidates(model, op, nd: int) -> List[ParallelConfig]:
    """``enumerate_candidates`` legalized by the op, deduplicated on
    (device type, dims, device ids), in order."""
    out, seen = [], set()
    for pc in enumerate_candidates(op, nd, model=model):
        pc = op.legalize_pc(pc)
        key = (pc.device_type, pc.dims, pc.device_ids[:pc.num_parts()])
        if key not in seen:
            seen.add(key)
            out.append(pc)
    return out


def _start_index(cands: List[ParallelConfig], want: ParallelConfig) -> int:
    """The candidate equal to ``want`` (type, dims and device ids); one is
    appended when the enumeration lacks it, so the anneal starts exactly
    at the plan it is given."""
    key = (want.device_type, want.dims, want.device_ids[:want.num_parts()])
    for ci, pc in enumerate(cands):
        if (pc.device_type, pc.dims, pc.device_ids[:pc.num_parts()]) == key:
            return ci
    cands.append(want)
    return len(cands) - 1


class _Pool:
    """A growing int64 pool of rectangles: each call appends a list of
    [parts][rank] (lo, hi) rectangles and returns its offset."""

    def __init__(self):
        self.data: List[int] = []

    def push(self, rects) -> int:
        off = len(self.data)
        for rect in rects:
            for lo, hi in rect:
                self.data += (int(lo), int(hi))
        return off


def _as(a, dtype):
    return np.ascontiguousarray(a, dtype=dtype)


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def native_mcmc_search(model, budget: int, alpha: float = 0.05, machine_model=None,
                       seed: int = 0, overlap_backward_update: Optional[bool] = None,
                       verbose: bool = True, init_strategies: Optional[Dict] = None,
                       cost_model: Optional[CostModel] = None,
                       num_devices: Optional[int] = None) -> SearchResult:
    """The C++ annealer's best strategy map as a ``SearchResult``
    (``engine="native"``), priced as ``mcmc_search`` prices (the same
    arguments mean the same).

    ``init_strategies`` ({op name: ParallelConfig}) starts the anneal from
    that plan instead of data parallelism; ``dp_s`` is then the engine's
    cost of that plan, so with ``budget=0`` it is exactly that plan's
    simulated cost.  ``FF_SEARCH_LEARNED=1`` prices with the learned cost
    tier (off by default, as for ``mcmc_search``)."""
    nd, mm, cost, _ = search_setup(model, machine_model, overlap_backward_update,
                                   num_devices, cost_model)
    overlap = model.config.search_overlap_backward_update \
        if overlap_backward_update is None else overlap_backward_update
    attach_learned_tier(model, mm, cost, learned_flag() is True)
    lib = native_lib()
    ops = model.ops
    L = len(ops)
    index = {id(op): i for i, op in enumerate(ops)}
    max_in = max([1] + [len(op.inputs) for op in ops])
    max_w = max([1] + [len(op.weights) for op in ops])
    max_out = max([1] + [len(op.outputs) for op in ops])
    num_in = np.array([len(op.inputs) for op in ops], np.int32)
    num_w = np.array([len(op.weights) for op in ops], np.int32)
    num_out = np.array([len(op.outputs) for op in ops], np.int32)
    in_rank = np.zeros(L * max_in, np.int32)
    producer = np.full(L * max_in, -1, np.int32)
    producer_out = np.zeros(L * max_in, np.int32)
    w_rank = np.zeros(L * max_w, np.int32)
    # an embedding's gradient touches at most the batch's rows (the
    # simulator's clamp, simulator.weight_groups)
    sync_cap = np.full(L * max_w, -1, np.int64)

    start = data_parallel_start(model, nd)
    if init_strategies is not None:
        start.update(init_strategies)
    cand_lists, choice_init = [], np.zeros(L, np.int32)
    for i, op in enumerate(ops):
        for j, tin in enumerate(op.inputs):
            pre = tin.owner_op
            if pre is not None and id(pre) in index:
                producer[i * max_in + j] = index[id(pre)]
                producer_out[i * max_in + j] = tin.owner_idx
        if op._type == "Embedding":
            sync_cap[i * max_w:i * max_w + len(op.weights)] = int(np.prod(op.inputs[0].dims))
        cands = _legal_candidates(model, op, nd)
        choice_init[i] = _start_index(cands, op.legalize_pc(start[op.name]))
        cand_lists.append(cands)

    rects = _Pool()
    chips: List[int] = []
    parts, host, fwd, bwd, chip_off = [], [], [], [], []
    out_off_l, in_off_l, w_off_l, cand_off = [], [], [], [0]
    for i, op in enumerate(ops):
        for pc in cand_lists[i]:
            P = pc.num_parts()
            parts.append(P)
            host.append(1 if host_sparse(op, pc) else 0)
            fwd.append(cost.op_time(op, pc, "forward"))
            bwd.append(cost.op_time(op, pc, "backward"))
            chip_off.append(len(chips))
            chips += devices_of(pc, nd)
            for k in range(max_out):
                out_off_l.append(rects.push([op.output_tile(pc, p, k) for p in range(P)])
                                 if k < len(op.outputs) else 0)
            for j in range(max_in):
                if j < len(op.inputs):
                    rl = [op.input_ranges(j, pc, p) for p in range(P)]
                    in_rank[i * max_in + j] = len(rl[0])
                    in_off_l.append(rects.push(rl))
                else:
                    in_off_l.append(0)
            for w in range(max_w):
                if w < len(op.weights):
                    tl = [op.weight_tile(pc, w, p) for p in range(P)]
                    w_rank[i * max_w + w] = len(tl[0])
                    w_off_l.append(rects.push(tl))
                else:
                    w_off_l.append(0)
        cand_off.append(cand_off[-1] + len(cand_lists[i]))

    choice_out = np.zeros(L, np.int32)
    init_s = ctypes.c_double(0.0)
    evaluated = ctypes.c_int64(0)
    keep = dict(
        num_in=num_in, num_w=num_w, num_out=num_out, in_rank=in_rank, producer=producer,
        producer_out=producer_out, w_rank=w_rank, sync_cap=sync_cap,
        cand_off=_as(cand_off, np.int32), parts=_as(parts, np.int32),
        host=_as(host, np.int32), fwd=_as(fwd, np.float64), bwd=_as(bwd, np.float64),
        chip_off=_as(chip_off, np.int64), chips=_as(chips or [0], np.int32),
        rects=_as(rects.data or [0], np.int64), out_off=_as(out_off_l, np.int64),
        in_off=_as(in_off_l or [0], np.int64), w_off=_as(w_off_l or [0], np.int64),
        choice_init=choice_init)
    i32, i64, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double

    tel = active_log()
    rec = SearchRecorder.maybe("native", budget, nd, seed, log=tel)
    if rec is not None:
        rec.start(candidates=int(cand_off[-1]))
    t0 = time.perf_counter()
    best_s = lib.ffsearch_anneal(
        nd, GPUS_PER_NODE, float(mm.nvlink_bandwidth), float(mm.ib_bandwidth),
        float(cost._dtype_bytes),
        L, _ptr(keep["num_in"], i32), _ptr(keep["num_w"], i32), _ptr(keep["num_out"], i32),
        max_in, max_w, max_out,
        _ptr(keep["in_rank"], i32), _ptr(keep["producer"], i32),
        _ptr(keep["producer_out"], i32), _ptr(keep["w_rank"], i32),
        _ptr(keep["sync_cap"], i64),
        _ptr(keep["cand_off"], i32), _ptr(keep["parts"], i32), _ptr(keep["host"], i32),
        _ptr(keep["fwd"], f64), _ptr(keep["bwd"], f64), _ptr(keep["chip_off"], i64),
        _ptr(keep["chips"], i32), _ptr(keep["rects"], i64), _ptr(keep["out_off"], i64),
        _ptr(keep["in_off"], i64), _ptr(keep["w_off"], i64),
        int(budget), float(alpha), int(seed) & (2**64 - 1), 1 if overlap else 0,
        _ptr(keep["choice_init"], i32), _ptr(choice_out, i32), ctypes.byref(init_s),
        ctypes.byref(evaluated))
    dt = time.perf_counter() - t0
    if best_s < 0 or init_s.value < 0:
        raise RuntimeError("cycle in the native engine's task graph")
    proposals_per_s = budget / dt if dt > 0 else 0.0
    best = SearchResult({op.name: cand_lists[i][int(choice_out[i])] for i, op in enumerate(ops)},
                        engine="native", budget=budget, seed=seed, num_devices=nd,
                        best_s=float(best_s), dp_s=float(init_s.value),
                        proposals_per_s=proposals_per_s)
    # the engine's own account: candidates enumerated, and proposals that
    # changed a candidate (each costed by one graph rebuild)
    best.candidates, best.evaluated = int(cand_off[-1]), evaluated.value
    if tel is not None:
        # the C++ engine owns the loop: one span for the whole anneal,
        # carrying its summary numbers
        tel.span_at("native_search", t0, dt, budget=budget, candidates=int(cand_off[-1]),
                    dp_ms=round(init_s.value * 1e3, 3), best_ms=round(best_s * 1e3, 3),
                    proposals_per_s=round(proposals_per_s, 1))
        if rec is not None:
            rec.finish(best, best_ms=best_s * 1e3, initial_ms=init_s.value * 1e3,
                       proposals_per_s=proposals_per_s)
        tel.flush()
    if verbose:
        print(f"native search: dp {init_s.value * 1e3:.3f} ms/iter -> best "
              f"{best_s * 1e3:.3f} ms/iter over {cand_off[-1]} candidates, budget {budget}")
    return best
