"""Population-based strategy search: parallel-tempered delta chains
(PyTorch port of ``flexflow_tpu/simulator/population.py``).

The paper's search (Jia et al., "Beyond Data and Model Parallelism",
section 5.3) anneals one Markov chain.  This engine spends the same total
proposal budget on a population of communicating chains:

  * N ``DeltaSimulator`` chains, each with its own committed state but all
    sharing the memo caches (fragments, volumes, transfer times, interned
    configs, whole-state results), so N chains cost barely more than one;
  * parallel tempering: chain k anneals at ``alpha * ladder_ratio**k``
    (chain 0 coldest) or at an explicit list of multipliers, with seeded
    replica-exchange swaps between adjacent temperatures every
    ``exchange_every`` rounds, accepted at ``min(1, exp((a_k - a_j) * (E_k
    - E_j)))``; an exchange costs no budget;
  * genetic crossover every ``crossover_every`` rounds: the two best chains
    splice their per-op configs into a child, re-costed one delta patch
    per spliced op (each charged to the budget); the child replaces the
    worst chain only when strictly better;
  * warm starts: chain 0 from data parallelism, the next from the shipped
    ``strategies/*.pb`` whose ``.pb.meta.json`` sidecars match the model's
    op names and device count and that split only dims the search proposes,
    the rest from seeded random configs.

Every draw comes from seeded RNGs in a fixed order, so a seeded run is
reproducible bit for bit, and equals the JAX package's engine on the same
machine model, cost table, search space (``search._SPLITTABLE``) and
knobs.  The knobs come from the environment, validated with the JAX
package's messages (``PopulationKnobs.from_env``), or from an explicit
``PopulationKnobs``.  The learned cost tier is on for this engine unless
``FF_SEARCH_LEARNED=0``: it replaces the roofline only for op families
whose measured corpus beats it out of fold.  ``FF_SIM_DELTA=0`` costs every
proposal by a full rebuild (``_FullChainSim``), with the same result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import random
import time
from typing import Dict, List, Optional, Tuple

from ..config import ParallelConfig
from ..observability.events import active_log
from ..observability.searchtrace import SearchRecorder
from .cost_model import CostModel
from .delta import DeltaSimulator
from .search import (SearchResult, attach_learned_tier, data_parallel_start, delta_enabled,
                     in_search_space, parse_learned_flag, random_parallel_config,
                     search_setup)
from .simulator import Simulator

# The engine's defaults (the JAX package's): chains, the temperature ladder
# (chain k anneals at alpha * ratio**k), and the rounds between replica
# exchanges and between crossovers.
DEFAULT_POPULATION = 8
DEFAULT_LADDER_RATIO = 0.65
DEFAULT_EXCHANGE_EVERY = 50
DEFAULT_CROSSOVER_EVERY = 150


def _env_int(env: Dict[str, str], name: str, default: int, minimum: int) -> int:
    raw = env.get(name, "")
    if raw == "":
        return default
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer >= {minimum}, got {raw!r}") from None
    if v < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {v}")
    return v


@dataclasses.dataclass(frozen=True)
class PopulationKnobs:
    """The engine's settings, each overridable from the environment:

    ``FF_SEARCH_POPULATION``  chains (an integer >= 2; default 8)
    ``FF_SEARCH_LADDER``      the temperature ladder over alpha: one ratio
                              r in (0, 1] (chain k anneals at alpha * r**k)
                              or a comma list of positive multipliers, one
                              a chain
    ``FF_SEARCH_EXCHANGE``    rounds between replica-exchange sweeps (an
                              integer >= 0; 0 turns them off; default 50)
    ``FF_SEARCH_CROSSOVER``   rounds between crossovers (an integer >= 0;
                              0 turns them off; default 150)
    ``FF_SEARCH_LEARNED``     the learned cost tier: unset, the engine's
                              default (on here, off for mcmc and native);
                              0 or 1 forces it
    """

    population: int = DEFAULT_POPULATION
    ladder_ratio: float = DEFAULT_LADDER_RATIO
    ladder: Tuple[float, ...] = ()   # explicit multipliers; (): geometric
    exchange_every: int = DEFAULT_EXCHANGE_EVERY
    crossover_every: int = DEFAULT_CROSSOVER_EVERY
    learned: Optional[bool] = None

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "PopulationKnobs":
        """The knobs from ``env`` (default ``os.environ``); a malformed one
        raises ``ValueError`` with the JAX package's message."""
        env = os.environ if env is None else env
        population = _env_int(env, "FF_SEARCH_POPULATION", DEFAULT_POPULATION, 2)
        ratio = DEFAULT_LADDER_RATIO
        ladder: Tuple[float, ...] = ()
        raw = env.get("FF_SEARCH_LADDER", "")
        if raw:
            try:
                vals = tuple(float(x) for x in raw.split(","))
            except ValueError:
                raise ValueError(
                    "FF_SEARCH_LADDER must be a ratio in (0, 1] or a "
                    f"comma list of positive multipliers, got {raw!r}") from None
            if any(v <= 0 for v in vals):
                raise ValueError(f"FF_SEARCH_LADDER entries must be > 0, got {raw!r}")
            if len(vals) == 1:
                if vals[0] > 1:
                    raise ValueError(f"FF_SEARCH_LADDER ratio must be in (0, 1], got {vals[0]}")
                ratio = vals[0]
            else:
                if len(vals) != population:
                    raise ValueError(f"FF_SEARCH_LADDER lists {len(vals)} multipliers "
                                     f"but FF_SEARCH_POPULATION is {population}")
                ladder = vals
        exchange_every = _env_int(env, "FF_SEARCH_EXCHANGE", DEFAULT_EXCHANGE_EVERY, 0)
        crossover_every = _env_int(env, "FF_SEARCH_CROSSOVER", DEFAULT_CROSSOVER_EVERY, 0)
        learned = parse_learned_flag(env.get("FF_SEARCH_LEARNED", ""))
        return cls(population=population, ladder_ratio=ratio, ladder=ladder,
                   exchange_every=exchange_every, crossover_every=crossover_every,
                   learned=learned)

    def alphas(self, alpha: float) -> Tuple[float, ...]:
        if self.ladder:
            return tuple(alpha * m for m in self.ladder)
        return tuple(alpha * self.ladder_ratio ** k for k in range(self.population))


class _FullChainSim:
    """``DeltaSimulator``'s protocol over full re-simulation
    (``FF_SIM_DELTA=0``): the same reset/propose/commit/rollback, every
    cost a full rebuild."""

    def __init__(self, sim: Simulator, model):
        self.sim = sim
        self.model = model
        self._cur: Dict[str, ParallelConfig] = {}
        self._pending = None

    def reset(self, strategies: Dict[str, ParallelConfig]) -> float:
        self._cur = dict(strategies)
        self._pending = None
        return self.sim.simulate_runtime(self.model, self._cur)

    def propose(self, op_name: str, pc: ParallelConfig) -> float:
        old = self._cur[op_name]
        self._cur[op_name] = pc
        rt = self.sim.simulate_runtime(self.model, self._cur)
        self._cur[op_name] = old
        self._pending = (op_name, pc)
        return rt

    def commit(self) -> None:
        if self._pending is not None:
            self._cur[self._pending[0]] = self._pending[1]
            self._pending = None

    def rollback(self) -> None:
        self._pending = None


class _Chain:
    __slots__ = ("ci", "alpha", "rng", "delta", "cur", "cur_rt",
                 "best_rt", "seed_kind", "proposals", "accepted",
                 "exchanges", "adopted")

    def __init__(self, ci: int, alpha: float, rng: random.Random, delta, seed_kind: str):
        self.ci = ci
        self.alpha = alpha
        self.rng = rng
        self.delta = delta
        self.seed_kind = seed_kind
        self.cur: Dict[str, ParallelConfig] = {}
        self.cur_rt = float("inf")
        self.best_rt = float("inf")
        self.proposals = 0
        self.accepted = 0
        self.exchanges = 0
        self.adopted = 0


def population_search(model, budget: int, alpha: float = 0.05,
                      machine_model=None, seed: int = 0,
                      overlap_backward_update: Optional[bool] = None,
                      verbose: bool = True,
                      cost_model: Optional[CostModel] = None,
                      num_devices: Optional[int] = None,
                      knobs: Optional[PopulationKnobs] = None) -> SearchResult:
    """Population search over the same total proposal budget a single-chain
    ``mcmc_search(budget)`` spends: every chain proposal and every crossover
    patch is charged to ``budget``.  Returns a ``SearchResult`` with
    ``engine="population"``, per-chain stats in ``.chains`` and run stats
    (ladder, exchange acceptance, crossover lineage, learned-tier
    provenance, whether the delta simulator ran) in ``.stats``.  ``knobs``
    default to ``PopulationKnobs.from_env()``."""
    knobs = knobs if knobs is not None else PopulationKnobs.from_env()
    nd, mm, cost, sim = search_setup(model, machine_model, overlap_backward_update,
                                     num_devices, cost_model)
    learned_prov = attach_learned_tier(model, mm, cost,
                                       True if knobs.learned is None else knobs.learned)

    P = knobs.population
    alphas = knobs.alphas(alpha)
    master = random.Random((seed + 1) * 0x9E3779B1)
    delta_on = delta_enabled()
    donor = None
    chains: List[_Chain] = []
    for ci in range(P):
        cs = DeltaSimulator(sim, model, share_caches_from=donor) if delta_on \
            else _FullChainSim(sim, model)
        donor = donor or (cs if delta_on else None)
        chains.append(_Chain(ci, alphas[ci], random.Random((seed + 1) * 1_000_003 + ci),
                             cs, "random"))

    # -- warm starts -----------------------------------------------------
    from ..parallel.strategy import load_warm_starts

    dp = data_parallel_start(model, nd)
    # a shipped strategy seeds a chain only if the search could propose it
    warm = [(label, strategies) for label, strategies in load_warm_starts(model, nd)
            if all(in_search_space(op, strategies[op.name]) for op in model.ops)]
    chains[0].cur = dict(dp)
    chains[0].seed_kind = "dp"
    for i, ch in enumerate(chains[1:]):
        if i < len(warm):
            label, strategies = warm[i]
            ch.cur = dict(dp)
            ch.cur.update(strategies)
            ch.seed_kind = f"sidecar:{label}"
        else:
            ch.cur = {op.name: op.legalize_pc(random_parallel_config(op, nd, ch.rng, model=model))
                      for op in model.ops}
            ch.seed_kind = "random"
    for ch in chains:
        ch.cur_rt = ch.delta.reset(ch.cur)
        ch.best_rt = ch.cur_rt
    dp_rt = chains[0].cur_rt

    best = dict(min(chains, key=lambda c: (c.cur_rt, c.ci)).cur)
    best_rt = min(ch.cur_rt for ch in chains)

    # the flight recorder: None, and no log call at all, unless telemetry is on
    tel = active_log()
    rec = SearchRecorder.maybe("population", budget, nd, seed, log=tel)
    if rec is not None:
        rec.start(initial_ms=dp_rt * 1e3)
    span = tel.span("population_search", budget=budget, num_devices=nd, population=P) \
        if tel is not None else contextlib.nullcontext({})

    exchange_stats: Dict[str, Dict[str, int]] = {}
    cross_stats = {"attempts": 0, "adopted": 0, "patches": 0}
    lineage: List[Dict] = []
    spent = 0
    round_idx = 0
    t0 = time.perf_counter()

    def note_best(state: Dict[str, ParallelConfig], rt: float):
        nonlocal best, best_rt
        if rt < best_rt:
            best_rt = rt
            best = dict(state)

    with span as span_attrs:
        while spent < budget:
            for ch in chains:
                if spent >= budget:
                    break
                op = ch.rng.choice(model.ops)
                old_pc = ch.cur[op.name]
                new_pc = op.legalize_pc(random_parallel_config(op, nd, ch.rng, model=model))
                nxt_rt = ch.delta.propose(op.name, new_pc)
                spent += 1
                ch.proposals += 1
                if nxt_rt < best_rt:
                    nxt_state = dict(ch.cur)
                    nxt_state[op.name] = new_pc
                    note_best(nxt_state, nxt_rt)
                if nxt_rt < ch.cur_rt:
                    accepted, reason, prob = True, "downhill", None
                else:
                    prob = math.exp(-ch.alpha * (nxt_rt - ch.cur_rt) * 1e3)
                    accepted, reason = ch.rng.random() < prob, "metropolis"
                if rec is not None:
                    rec.candidate(spent - 1, op.name, old_pc, new_pc, cur_ms=ch.cur_rt * 1e3,
                                  new_ms=nxt_rt * 1e3, best_ms=best_rt * 1e3,
                                  accepted=accepted, reason=reason, prob=prob, chain=ch.ci)
                if accepted:
                    ch.cur[op.name] = new_pc
                    ch.cur_rt = nxt_rt
                    ch.best_rt = min(ch.best_rt, nxt_rt)
                    ch.accepted += 1
                    ch.delta.commit()
                else:
                    ch.delta.rollback()
            round_idx += 1
            if verbose and round_idx % 100 == 0:
                print(f"round({round_idx}) spent({spent}/{budget}) "
                      f"best({best_rt * 1e3:.3f}ms) "
                      f"chains({', '.join(f'{c.cur_rt * 1e3:.2f}' for c in chains)})")
            if tel is not None and round_idx % 100 == 0:
                tel.event("search_progress", engine="population", iter=spent,
                          best_ms=round(best_rt * 1e3, 3))

            # -- replica exchange (free: both states are memoized) ----------
            if knobs.exchange_every and round_idx % knobs.exchange_every == 0:
                for k in range(P - 1):
                    a, b = chains[k], chains[k + 1]
                    # the colder chain has the larger alpha, so a hotter chain
                    # holding a better state always swaps down
                    log_p = (a.alpha - b.alpha) * (a.cur_rt - b.cur_rt) * 1e3
                    prob = 1.0 if log_p >= 0 else math.exp(log_p)
                    ok = log_p >= 0 or master.random() < prob
                    st = exchange_stats.setdefault(f"{k}<->{k + 1}", {"attempts": 0, "accepts": 0})
                    st["attempts"] += 1
                    if rec is not None:
                        rec.exchange(spent, (a.ci, b.ci), a.cur_rt * 1e3, b.cur_rt * 1e3,
                                     accepted=ok, prob=prob)
                    if ok:
                        st["accepts"] += 1
                        a.cur, b.cur = b.cur, a.cur
                        a.cur_rt = a.delta.reset(a.cur)
                        b.cur_rt = b.delta.reset(b.cur)
                        a.best_rt = min(a.best_rt, a.cur_rt)
                        b.best_rt = min(b.best_rt, b.cur_rt)
                        a.exchanges += 1
                        b.exchanges += 1

            # -- genetic crossover (a child costs exactly K patches) -------
            if knobs.crossover_every and P >= 3 and \
                    round_idx % knobs.crossover_every == 0 and spent < budget:
                ranked = sorted(chains, key=lambda c: (c.cur_rt, c.ci))
                pa, pb, worst = ranked[0], ranked[1], ranked[-1]
                if rec is not None:
                    rec.elite(spent, [(c.ci, c.cur_rt * 1e3) for c in ranked])
                diff = [name for name in pa.cur if pa.cur[name] != pb.cur[name]]
                splice = [name for name in diff if master.random() < 0.5]
                if splice and spent + len(splice) <= budget:
                    cross_stats["attempts"] += 1
                    saved_cur, saved_rt = worst.cur, worst.cur_rt
                    child = dict(pa.cur)
                    rt = worst.delta.reset(pa.cur)  # memoized: free
                    for name in splice:
                        rt = worst.delta.propose(name, pb.cur[name])
                        worst.delta.commit()
                        spent += 1
                        child[name] = pb.cur[name]
                        note_best(child, rt)
                    cross_stats["patches"] += len(splice)
                    adopted = rt < saved_rt
                    if adopted:
                        cross_stats["adopted"] += 1
                        worst.cur, worst.cur_rt = child, rt
                        worst.best_rt = min(worst.best_rt, rt)
                        worst.adopted += 1
                        lineage.append({"iter": spent, "parents": [pa.ci, pb.ci],
                                        "chain": worst.ci, "patches": len(splice),
                                        "child_ms": round(rt * 1e3, 3)})
                    else:
                        worst.cur = saved_cur
                        worst.cur_rt = worst.delta.reset(saved_cur)
                    if rec is not None:
                        rec.crossover(spent, (pa.ci, pb.ci), worst.ci, len(splice), rt * 1e3,
                                      adopted=adopted)

        dt = time.perf_counter() - t0
        proposals_per_s = spent / dt if dt > 0 else 0.0
        span_attrs["best_ms"] = round(best_rt * 1e3, 3)
        span_attrs["proposals_per_s"] = round(proposals_per_s, 1)
    if rec is not None:
        rec.finish(best, best_ms=best_rt * 1e3, proposals_per_s=proposals_per_s,
                   delta=delta_on)
    if tel is not None:
        tel.flush()
    winner = min(chains, key=lambda c: (c.best_rt, c.ci))
    chain_stats = [{
        "chain": ch.ci, "alpha": round(ch.alpha, 6), "seed": ch.seed_kind,
        "proposals": ch.proposals, "accepted": ch.accepted,
        "exchanges": ch.exchanges, "crossovers_adopted": ch.adopted,
        "best_ms": round(ch.best_rt * 1e3, 4), "cur_ms": round(ch.cur_rt * 1e3, 4),
    } for ch in chains]
    stats = {
        "population": P,
        "ladder": [round(a, 6) for a in alphas],
        "exchange_every": knobs.exchange_every,
        "crossover_every": knobs.crossover_every,
        "spent": spent,
        "winner_chain": winner.ci,
        "exchange": exchange_stats,
        "crossover": cross_stats,
        "lineage": lineage,
        "learned": learned_prov,
        "delta_sim": delta_on,
    }
    if verbose:
        print("=========== Best Discovered Strategy (population) ======")
        for name, pc in best.items():
            print(f"[{name}] dims{list(pc.dims)} parts({pc.num_parts()})")
        print(f"simulated runtime: {best_rt * 1e3:.3f} ms/iter "
              f"(dp {dp_rt * 1e3:.3f} ms; {P} chains, {spent} proposals)")
    return SearchResult(best, engine="population", budget=budget, seed=seed,
                        num_devices=nd, best_s=best_rt, dp_s=dp_rt,
                        proposals_per_s=proposals_per_s, delta_sim=delta_on,
                        chains=chain_stats, stats=stats)
