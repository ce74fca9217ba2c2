"""Population-based strategy search: parallel-tempered delta chains
(PyTorch port of ``flexflow_tpu/simulator/population.py``).

The paper's search (Jia et al., "Beyond Data and Model Parallelism",
section 5.3) anneals one Markov chain.  This engine spends the same total
proposal budget on a population of communicating chains:

  * N ``DeltaSimulator`` chains, each with its own committed state but all
    sharing the memo caches (fragments, volumes, transfer times, interned
    configs, whole-state results), so N chains cost barely more than one;
  * parallel tempering: chain k anneals at ``alpha * LADDER_RATIO**k``
    (chain 0 coldest), with seeded replica-exchange swaps between adjacent
    temperatures every ``EXCHANGE_EVERY`` rounds, accepted at
    ``min(1, exp((a_k - a_j) * (E_k - E_j)))``; an exchange costs no budget;
  * genetic crossover every ``CROSSOVER_EVERY`` rounds: the two best chains
    splice their per-op configs into a child, re-costed one delta patch
    per spliced op (each charged to the budget); the child replaces the
    worst chain only when strictly better;
  * warm starts: chain 0 from data parallelism, the next from the shipped
    ``strategies/*.pb`` whose ``.pb.meta.json`` sidecars match the model's
    op names and device count and that split only dims the search proposes,
    the rest from seeded random configs.

Every draw comes from seeded RNGs in a fixed order, so a seeded run is
reproducible bit for bit, and equals the JAX package's engine on the same
machine model, cost table and search space (``search._SPLITTABLE``).
The learned cost tier is always on for this engine: it replaces the
roofline only for op families whose measured corpus beats it out of fold.
"""

from __future__ import annotations

import contextlib
import math
import random
import time
from typing import Dict, List, Optional

from ..config import ParallelConfig
from ..observability.events import active_log
from ..observability.searchtrace import SearchRecorder
from .cost_model import CostModel, LearnedCostTier
from .delta import DeltaSimulator
from .search import (SearchResult, data_parallel_start, in_search_space,
                     random_parallel_config, search_setup)


# The engine's settings (the JAX package's defaults; its FF_SEARCH_*
# environment overrides are not ported): chains, the temperature ladder
# (chain k anneals at alpha * LADDER_RATIO**k), and the rounds between
# replica exchanges and between crossovers.
POPULATION = 8
LADDER_RATIO = 0.65
EXCHANGE_EVERY = 50
CROSSOVER_EVERY = 150


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
                      num_devices: Optional[int] = None) -> SearchResult:
    """Population search over the same total proposal budget a single-chain
    ``mcmc_search(budget)`` spends: every chain proposal and every crossover
    patch is charged to ``budget``.  Returns a ``SearchResult`` with
    ``engine="population"``, per-chain stats in ``.chains`` and run stats
    (ladder, exchange acceptance, crossover lineage, learned-tier
    provenance) in ``.stats``."""
    nd, mm, cost, sim = search_setup(model, machine_model, overlap_backward_update,
                                     num_devices, cost_model)
    tier = LearnedCostTier.fit_default(
        mm, compute_dtype=model.config.compute_dtype,
        measured_cache_path=cost.measured_cache_path, platform=cost.target_platform)
    learned_prov = tier.provenance
    if tier.provenance["used_families"]:
        try:
            cost.attach_learned_tier(tier)
        except AssertionError:
            # a caller's pre-warmed cost model keeps its costs
            learned_prov = dict(tier.provenance)
            learned_prov["attached"] = False

    P = POPULATION
    alphas = tuple(alpha * LADDER_RATIO ** k for k in range(P))
    master = random.Random((seed + 1) * 0x9E3779B1)
    donor = None
    chains: List[_Chain] = []
    for ci in range(P):
        cs = DeltaSimulator(sim, model, share_caches_from=donor)
        donor = donor or cs
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
            if EXCHANGE_EVERY and round_idx % EXCHANGE_EVERY == 0:
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
            if CROSSOVER_EVERY and P >= 3 and \
                    round_idx % CROSSOVER_EVERY == 0 and spent < budget:
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
        rec.finish(best, best_ms=best_rt * 1e3, proposals_per_s=proposals_per_s, delta=True)
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
        "exchange_every": EXCHANGE_EVERY,
        "crossover_every": CROSSOVER_EVERY,
        "spent": spent,
        "winner_chain": winner.ci,
        "exchange": exchange_stats,
        "crossover": cross_stats,
        "lineage": lineage,
        "learned": learned_prov,
    }
    if verbose:
        print("=========== Best Discovered Strategy (population) ======")
        for name, pc in best.items():
            print(f"[{name}] dims{list(pc.dims)} parts({pc.num_parts()})")
        print(f"simulated runtime: {best_rt * 1e3:.3f} ms/iter "
              f"(dp {dp_rt * 1e3:.3f} ms; {P} chains, {spent} proposals)")
    return SearchResult(best, engine="population", budget=budget, seed=seed,
                        num_devices=nd, best_s=best_rt, dp_s=dp_rt,
                        proposals_per_s=proposals_per_s, chains=chain_stats, stats=stats)
