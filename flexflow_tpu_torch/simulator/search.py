"""MCMC (simulated annealing) strategy search (PyTorch port of
``flexflow_tpu/simulator/search.py``).

Counterpart of ``FFModel::optimize`` / ``rewrite`` (reference:
src/runtime/model.cc:1046-1107) with its accept rule: start from data
parallelism; each iteration rewrites one random op to a random legal
config; accept when faster, else with probability ``exp(-alpha * (next -
current))``; keep the best ever seen.  Proposals are random factorizations
of a divisor of the device count over the op's partitionable dims, and each
is re-costed incrementally by ``DeltaSimulator`` (``FF_SIM_DELTA=0``: by a
full rebuild, with the same result bit for bit).

The RNG stream, the proposal order, the accept rule and the space of
proposals (``_SPLITTABLE``, host placement of eligible tables) are the JAX
package's, so that a seeded search over the same machine model and cost
table returns the same strategy and the same floats.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import random
import time
from typing import Dict, Optional, Tuple

from ..config import ParallelConfig
from ..observability.events import active_log
from ..observability.searchtrace import SearchRecorder
from .cost_model import CostModel, LearnedCostTier
from .delta import DeltaSimulator
from .machine import H100MachineModel
from .simulator import Simulator

# A delta cost is checked against a full rebuild every this many accepts
# (FF_SIM_DELTA_CHECK overrides it; 0 turns the check off).
DELTA_CHECK_EVERY = 200


def delta_enabled() -> bool:
    """``FF_SIM_DELTA``: the incremental simulator unless it reads 0,
    false or off (the JAX package's reading)."""
    return os.environ.get("FF_SIM_DELTA", "1").lower() not in ("0", "false", "off")


def delta_check_every() -> int:
    """``FF_SIM_DELTA_CHECK``: accepts between the delta simulator's checks
    against a full rebuild (an integer; empty or 0: no check)."""
    return int(os.environ.get("FF_SIM_DELTA_CHECK", str(DELTA_CHECK_EVERY)) or 0)


def parse_learned_flag(raw: str) -> Optional[bool]:
    """``FF_SEARCH_LEARNED`` tri-state: unset -> the engine's default, 0/1
    -> forced.  Anything else raises."""
    if raw == "":
        return None
    low = raw.lower()
    if low in ("0", "false", "off"):
        return False
    if low in ("1", "true", "on"):
        return True
    raise ValueError(f"FF_SEARCH_LEARNED must be 0 or 1, got {raw!r}")


def learned_flag() -> Optional[bool]:
    """``FF_SEARCH_LEARNED`` as read from the environment."""
    return parse_learned_flag(os.environ.get("FF_SEARCH_LEARNED", ""))


def attach_learned_tier(model, mm, cost: CostModel, use: bool) -> Optional[Dict]:
    """Fit the learned cost tier on the measured cache and attach it to
    ``cost`` when ``use`` and it beats the roofline for some op family out
    of fold; returns its provenance (None when not used).  A caller's
    pre-warmed cost model keeps its costs, and the provenance says so."""
    if not use:
        return None
    tier = LearnedCostTier.fit_default(
        mm, compute_dtype=model.config.compute_dtype,
        measured_cache_path=cost.measured_cache_path, platform=cost.target_platform)
    prov = tier.provenance
    if tier.provenance["used_families"]:
        try:
            cost.attach_learned_tier(tier)
        except AssertionError:
            prov = dict(tier.provenance)
            prov["attached"] = False
    return prov


@functools.lru_cache(maxsize=None)
def _divisors(n: int) -> Tuple[int, ...]:
    return tuple(d for d in range(1, n + 1) if n % d == 0)


# Per-op-type partitionable dims (natural order, batch first, NHWC), as the
# reference ops restrict their Legion task grids; the JAX package's table.
# "last" is the output channel dim, whatever the rank.  The simulator prices
# a part at its sub-shape, and each part of the port's execution computes
# just its tile: a conv or pool tile reads its input rectangle through a
# halo exchange, an LSTM part its H/k slice of the gates, an ExpertMLP
# part its experts.
_SPLITTABLE = {
    "Conv2D": (0, 1, 2),       # n, h, w (conv_2d.cu asserts c unsplit)
    "Pool2D": (0, 1, 2),
    "Dense": (0, "last"),      # n, c_out (linear.cu tensor parallelism)
    "Embedding": (0, "last"),  # n, out_dim
    "Concat": (0,),
    "Flat": (0,),
    "Softmax": (0,),           # sample only (softmax.cu asserts)
    "BatchNorm": (0,),
    "Dropout": (0,),
    "ElementUnary": (0,),
    "ElementBinary": (0,),
    "LSTM": (0, 2),            # batch, hidden (T stays sequential)
    "MSELoss": (0,),
    "PipelineMLP": (0, 1),     # dim 1 = pipeline (operator-dim) degree
    "ExpertMLP": (0, 1),       # dim 1 = expert parallel degree
    # batch, sequence (ring or Ulysses attention over the parts) and heads
    "MultiHeadAttention": (0, 1, 2),
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
    With ``model``, an embedding the model can hold as a row-sparse host
    table (``_sparse_embed_candidate_ok``) goes to the host one draw in
    ten (``ParallelConfig.host_rowsparse``), as in the JAX package, so the
    searched space covers the hetero DLRM placement and seeded searches
    stay in step with the reference's."""
    if model is not None and rng.random() < 0.1 \
            and getattr(model, "_sparse_embed_candidate_ok", lambda _: False)(op):
        return ParallelConfig.host_rowsparse(op.output.num_dims)
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


class SearchResult(Dict[str, ParallelConfig]):
    """The best strategy map found, with the search's account of itself:
    the simulated cost of the best plan (``best_s``) and of the
    data-parallel start (``dp_s``), engine, budget, seed, devices and
    proposals per second, and whether the delta simulator costed it.
    Population runs add per-chain and run stats."""

    def __init__(self, strategies: Dict[str, ParallelConfig],
                 engine: str = "", budget: int = 0, seed: int = 0,
                 num_devices: int = 0, best_s: Optional[float] = None,
                 dp_s: Optional[float] = None,
                 proposals_per_s: Optional[float] = None,
                 delta_sim: Optional[bool] = None,
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
        self.delta_sim = delta_sim  # whether the delta simulator costed it
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
    of the model's machine.

    Proposals are re-costed by ``DeltaSimulator``; ``FF_SIM_DELTA=0`` costs
    each by a full rebuild instead, and a seeded search returns the same
    ``SearchResult`` bit for bit either way.  Every ``FF_SIM_DELTA_CHECK``
    accepts (``DELTA_CHECK_EVERY`` unset, 0: never) the delta cost of the
    committed plan is held against a full rebuild.  Where the JAX package
    then falls back to full rebuilds on a difference, the port raises: the
    two are equal by construction, so a difference is a fault to see.
    ``FF_SEARCH_LEARNED=1`` prices with the learned cost tier (off by
    default here, so that seeded results stay the JAX package's)."""
    nd, mm, cost, sim = search_setup(model, machine_model, overlap_backward_update,
                                     num_devices, cost_model, measure)
    attach_learned_tier(model, mm, cost, learned_flag() is True)
    rng = random.Random(seed)
    delta = DeltaSimulator(sim, model) if delta_enabled() else None
    check_every = delta_check_every()

    current = data_parallel_start(model, nd)
    current_rt = delta.reset(current) if delta is not None \
        else sim.simulate_runtime(model, current)
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
            if delta is not None:
                nxt_rt = delta.propose(op.name, new_pc)
            else:
                current[op.name] = new_pc
                nxt_rt = sim.simulate_runtime(model, current)
                current[op.name] = old_pc
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
                if delta is None:
                    continue
                delta.commit()
                accepts += 1
                if check_every and accepts % check_every == 0:
                    full_rt = sim.simulate_runtime(model, current)
                    if full_rt != current_rt:
                        if tel is not None:
                            tel.event("sim_delta_divergence", engine="mcmc", iter=it,
                                      delta_s=current_rt, full_s=full_rt)
                            tel.flush()
                        raise RuntimeError(f"delta simulation diverged from the full "
                                           f"rebuild ({current_rt!r} vs {full_rt!r})")
            elif delta is not None:
                delta.rollback()
        dt = time.perf_counter() - t0
        proposals_per_s = budget / dt if dt > 0 else 0.0
        span_attrs["best_ms"] = round(best_rt * 1e3, 3)
        span_attrs["proposals_per_s"] = round(proposals_per_s, 1)
    if rec is not None:
        rec.finish(best, best_ms=best_rt * 1e3, proposals_per_s=proposals_per_s,
                   delta=delta is not None)
    if tel is not None:
        tel.flush()
    if verbose:
        print("=========== Best Discovered Strategy ==========")
        for name, pc in best.items():
            print(f"[{name}] dims{list(pc.dims)} parts({pc.num_parts()})")
        print(f"simulated runtime: {best_rt * 1e3:.3f} ms/iter")
    return SearchResult(best, engine="mcmc", budget=budget, seed=seed,
                        num_devices=nd, best_s=best_rt, dp_s=dp_rt,
                        proposals_per_s=proposals_per_s, delta_sim=delta is not None)
