"""MCMC (simulated annealing) strategy search (PyTorch port of
``flexflow_tpu/simulator/search.py``).

Counterpart of ``FFModel::optimize`` / ``rewrite`` (reference:
src/runtime/model.cc:1046-1107) with its accept rule: start from data
parallelism; each iteration rewrites one random op to a random legal
config; accept when faster, else with probability ``exp(-alpha * (next -
current))``; keep the best ever seen.  Proposals are random factorizations
of a divisor of the device count over the op's partitionable dims, and each
is re-costed incrementally by ``DeltaSimulator``.

The RNG stream, the proposal order and the accept rule are the JAX
package's, so that a seeded search over the same machine model and cost
table returns the same strategy and the same floats.  What is proposed
differs where the port cannot yet compute a split at the cost the
simulator gives it (below): convolutions and pools split only the batch,
attention never splits its sequence, and the LSTM and the experts split
only the batch.
"""

from __future__ import annotations

import contextlib
import functools
import math
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import ParallelConfig
from ..observability.events import active_log
from ..observability.searchtrace import SearchRecorder
from .cost_model import CostModel
from .delta import DeltaSimulator
from .machine import H100MachineModel
from .simulator import Simulator

# A delta cost is checked against a full rebuild every this many accepts.
DELTA_CHECK_EVERY = 200


@functools.lru_cache(maxsize=None)
def _divisors(n: int) -> Tuple[int, ...]:
    return tuple(d for d in range(1, n + 1) if n % d == 0)


# Per-op-type partitionable dims (natural order, batch first, NHWC), as the
# reference ops restrict their Legion task grids.  "last" is the output
# channel dim, whatever the rank.  The simulator prices a part at its
# sub-shape, so a dim is listed only where each part of the port's
# execution computes just its tile.
_SPLITTABLE = {
    # batch only.  The port computes a height or width split of a conv or
    # pool whole on every part and slices the output (``unsplit_dims``),
    # while the simulator would price each part at 1/k of the op: H and W
    # wait for compute-split convs and pools (ROADMAP A6).
    "Conv2D": (0,),
    "Pool2D": (0,),
    "Dense": (0, "last"),      # n, c_out (linear.cu tensor parallelism)
    "Embedding": (0, "last"),  # n, out_dim
    "Concat": (0,),
    "Flat": (0,),
    "Softmax": (0,),           # sample only (softmax.cu asserts)
    "BatchNorm": (0,),
    "Dropout": (0,),
    "ElementUnary": (0,),
    "ElementBinary": (0,),
    # batch only.  The JAX package also splits the LSTM's hidden dim (2;
    # an all-gather of h each step) and ExpertMLP's experts (1; the tokens'
    # all_to_all); the port raises on both until it computes them
    # (ROADMAP A9), so the search never proposes them.
    "LSTM": (0,),
    "MSELoss": (0,),
    "PipelineMLP": (0, 1),     # dim 1 = pipeline (operator-dim) degree
    "ExpertMLP": (0,),
    # batch and heads.  The sequence (dim 1) is left out until ring and
    # Ulysses attention are ported (ROADMAP A7): the port's attention
    # raises on a sequence split, and the search must never propose a plan
    # that training rejects.
    "MultiHeadAttention": (0, 2),
    "LayerNorm": (0, 1),       # batch, seq
}


def splittable_dims(op) -> tuple:
    """_SPLITTABLE resolved for this op's output rank."""
    return _splittable_dims_cached(op._type, op.output.num_dims)


@functools.lru_cache(maxsize=None)
def _splittable_dims_cached(op_type: str, rank: int) -> tuple:
    dims = _SPLITTABLE.get(op_type, (0,))
    out = []
    for d in dims:
        d = rank - 1 if d == "last" else d
        if 0 <= d < rank and d not in out:
            out.append(d)
    return tuple(out)


def in_search_space(op, pc: ParallelConfig) -> bool:
    """Whether ``pc`` splits only dims the search proposes for ``op``."""
    dims = splittable_dims(op)
    return all(deg == 1 or d in dims for d, deg in enumerate(pc.dims))


def random_parallel_config(op, num_devices: int, rng: random.Random,
                           model=None) -> ParallelConfig:
    """A random legal SOAP config for ``op`` over ``num_devices`` GPUs.
    With ``model``, the JAX package draws once to decide a host placement
    of an eligible embedding; the port has no host placement yet (ROADMAP
    A9) but makes the same draw, so that seeded searches stay in step."""
    if model is not None:
        rng.random()
    rank = op.output.num_dims
    splittable = splittable_dims(op)
    num_parts = rng.choice(_divisors(num_devices))
    # randomly factor num_parts across the splittable dims
    degrees = [1] * rank
    remaining = num_parts
    dims_order = list(splittable)
    rng.shuffle(dims_order)
    for d in dims_order:
        if remaining == 1:
            break
        opts = [f for f in _divisors(remaining)
                if d < rank and op.output.dims[d] % (degrees[d] * f) == 0]
        f = rng.choice(opts) if opts else 1
        degrees[d] *= f
        remaining //= f
    if remaining > 1:  # what could not be placed goes to the batch
        if op.output.dims[0] % (degrees[0] * remaining) == 0:
            degrees[0] *= remaining
        # else: fewer parts, still legal
    pc = ParallelConfig(dims=tuple(degrees))
    n = pc.num_parts()
    start = rng.randrange(0, num_devices - n + 1) if num_devices > n else 0
    return pc.with_device_ids(tuple(range(start, start + n)))


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


def enumerate_candidates(op, nd: int) -> List[ParallelConfig]:
    """Every config the random proposals can reach, in a fixed order, with
    block-aligned placements for configs of fewer parts than devices (what
    ``tools/calibrate.py`` measures)."""
    splittable = list(splittable_dims(op))
    seen = set()
    cands: List[ParallelConfig] = []
    for n in _divisors(nd):
        for degrees in _factorizations(n, splittable, op.output.dims):
            parts = int(np.prod(degrees))
            for off in range(0, nd - parts + 1, parts):
                ids = tuple(range(off, off + parts))
                if (degrees, ids) in seen:
                    continue
                seen.add((degrees, ids))
                cands.append(ParallelConfig(dims=degrees).with_device_ids(ids))
    return cands


class SearchResult(Dict[str, ParallelConfig]):
    """The best strategy map found, with the search's account of itself:
    the simulated cost of the best plan (``best_s``) and of the
    data-parallel start (``dp_s``), engine, budget, seed, devices and
    proposals per second.  Population runs add per-chain and run stats."""

    def __init__(self, strategies: Dict[str, ParallelConfig],
                 engine: str = "", budget: int = 0, seed: int = 0,
                 num_devices: int = 0, best_s: Optional[float] = None,
                 dp_s: Optional[float] = None,
                 proposals_per_s: Optional[float] = None,
                 chains: Optional[list] = None,
                 stats: Optional[Dict] = None):
        super().__init__(strategies)
        self.engine = engine
        self.budget = budget
        self.seed = seed
        self.num_devices = num_devices
        self.best_s = best_s
        self.dp_s = dp_s
        self.proposals_per_s = proposals_per_s  # telemetry, never compared
        self.chains = chains
        self.stats = stats


def search_setup(model, machine_model, overlap_backward_update, num_devices,
                 cost_model=None, measure: bool = False):
    """(device count, machine model, cost model, simulator) of a search:
    the model's machine (or ``num_devices``), the calibrated H100 model, and
    a cost model keyed on the model's compute dtype that reads the card's
    measurements (``cost_model`` when it prices this machine model)."""
    nd = int(num_devices) if num_devices is not None else \
        (model.machine.num_devices if model.machine is not None else model.config.num_devices)
    mm = machine_model or H100MachineModel.calibrated(num_devices=nd)
    overlap = model.config.search_overlap_backward_update \
        if overlap_backward_update is None else overlap_backward_update
    cost = cost_model if (cost_model is not None and not measure
                          and cost_model.machine is mm) else \
        CostModel(mm, measure=measure, compute_dtype=model.config.compute_dtype,
                  target_platform="cuda", device=model.device if measure else None)
    return nd, mm, cost, Simulator(mm, cost, overlap_backward_update=overlap)


def data_parallel_start(model, nd: int) -> Dict[str, ParallelConfig]:
    return {op.name: ParallelConfig.data_parallel(op.output.num_dims, nd)
            .with_device_ids(tuple(range(nd))) for op in model.ops}


def mcmc_search(model, budget: int, alpha: float = 0.05,
                machine_model=None, measure: bool = False, seed: int = 0,
                overlap_backward_update: Optional[bool] = None,
                verbose: bool = True,
                cost_model: Optional[CostModel] = None,
                num_devices: Optional[int] = None) -> SearchResult:
    """The best strategy map found (op name -> ParallelConfig) as a
    ``SearchResult``.

    ``measure=True`` times each op config the search meets on the model's
    CUDA device (``CostModel._measure_real``) instead of reading the
    roofline.  ``cost_model`` shares a caller's warmed cost model when it
    prices ``machine_model``.  ``num_devices`` overrides the device count
    of the model's machine.  Every ``DELTA_CHECK_EVERY`` accepts the delta
    cost is held against a full rebuild, and a difference raises."""
    nd, mm, cost, sim = search_setup(model, machine_model, overlap_backward_update,
                                     num_devices, cost_model, measure)
    rng = random.Random(seed)
    delta = DeltaSimulator(sim, model)

    current = data_parallel_start(model, nd)
    current_rt = delta.reset(current)
    best, best_rt = dict(current), current_rt
    dp_rt = current_rt
    # the flight recorder (observability/searchtrace.py): None, and no log
    # call at all, unless telemetry is on
    tel = active_log()
    rec = SearchRecorder.maybe("mcmc", budget, nd, seed, log=tel)
    if rec is not None:
        rec.start(initial_ms=dp_rt * 1e3)
    span = tel.span("mcmc_search", budget=budget, num_devices=nd) \
        if tel is not None else contextlib.nullcontext({})
    accepts = 0
    t0 = time.perf_counter()
    with span as span_attrs:
        for it in range(budget):
            op = rng.choice(model.ops)
            old_pc = current[op.name]
            # legalized through the op's hook before costing
            new_pc = op.legalize_pc(random_parallel_config(op, nd, rng, model=model))
            nxt_rt = delta.propose(op.name, new_pc)
            if it % 100 == 0:
                if verbose:
                    print(f"iter({it}) cur({current_rt * 1e3:.3f}ms) "
                          f"next({nxt_rt * 1e3:.3f}ms) best({best_rt * 1e3:.3f}ms)")
                if tel is not None:
                    tel.event("search_progress", engine="mcmc", iter=it,
                              best_ms=round(best_rt * 1e3, 3))
            if nxt_rt < best_rt:
                best_rt = nxt_rt
                best = dict(current)
                best[op.name] = new_pc
            # downhill always; uphill with the Metropolis probability (the
            # rng is drawn only on uphill moves, so a seeded run proposes
            # the same with telemetry on or off)
            if nxt_rt < current_rt:
                accepted, reason, prob = True, "downhill", None
            else:
                prob = math.exp(-alpha * (nxt_rt - current_rt) * 1e3)
                accepted, reason = rng.random() < prob, "metropolis"
            if rec is not None:
                rec.candidate(it, op.name, old_pc, new_pc, cur_ms=current_rt * 1e3,
                              new_ms=nxt_rt * 1e3, best_ms=best_rt * 1e3,
                              accepted=accepted, reason=reason, prob=prob)
            if accepted:
                current[op.name] = new_pc
                current_rt = nxt_rt
                delta.commit()
                accepts += 1
                if accepts % DELTA_CHECK_EVERY == 0:
                    full_rt = sim.simulate_runtime(model, current)
                    if full_rt != current_rt:
                        if tel is not None:
                            tel.event("sim_delta_divergence", engine="mcmc", iter=it,
                                      delta_s=current_rt, full_s=full_rt)
                            tel.flush()
                        raise RuntimeError(f"delta simulation diverged from the full "
                                           f"rebuild ({current_rt!r} vs {full_rt!r})")
            else:
                delta.rollback()
        dt = time.perf_counter() - t0
        proposals_per_s = budget / dt if dt > 0 else 0.0
        span_attrs["best_ms"] = round(best_rt * 1e3, 3)
        span_attrs["proposals_per_s"] = round(proposals_per_s, 1)
    if rec is not None:
        rec.finish(best, best_ms=best_rt * 1e3, proposals_per_s=proposals_per_s, delta=True)
    if tel is not None:
        tel.flush()
    if verbose:
        print("=========== Best Discovered Strategy ==========")
        for name, pc in best.items():
            print(f"[{name}] dims{list(pc.dims)} parts({pc.num_parts()})")
        print(f"simulated runtime: {best_rt * 1e3:.3f} ms/iter")
    return SearchResult(best, engine="mcmc", budget=budget, seed=seed,
                        num_devices=nd, best_s=best_rt, dp_s=dp_rt,
                        proposals_per_s=proposals_per_s)
