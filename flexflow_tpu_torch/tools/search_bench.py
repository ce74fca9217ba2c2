"""Search benchmark: throughput (delta against full rebuild) and quality
(population against a single chain at equal budget) (PyTorch port of
``flexflow_tpu/tools/search_bench.py``).

``--mode throughput`` (default) runs the same seeded ``mcmc_search``
with ``FF_SIM_DELTA=1`` and then ``FF_SIM_DELTA=0``, requires the two
``SearchResult``s to be identical (strategy map, best_s, dp_s: the delta
simulator's bitwise contract), prints a JSON line with both proposals/s
and their ratio, and appends a ``search_throughput`` entry to the port's
perf ledger (``tools/perf_ledger.py``).

``--mode quality`` runs ``mcmc_search`` and ``population_search`` at the
same proposal budget (both charge every costed candidate to it),
re-simulates both winners under one fresh ``Simulator`` (roofline and
measured table only: the population may have priced with the learned
tier, so the search-time bests do not compare), and appends a
``search_quality`` entry whose value is ``single_ms / population_ms``
(higher is better, so the ledger's drop rule flags a regression).

Both entries are host metrics, ``backend: "cpu"``, ``proxy: false``.
The graphs are built on the CPU; no card is used.

    python -m flexflow_tpu_torch.tools.search_bench alexnet --devices 16 \\
        --budget 1000 --seed 0 --ledger /tmp/ledger.jsonl
    python -m flexflow_tpu_torch.tools.search_bench transformer --devices 8 \\
        --budget 4000 --mode quality --no-ledger

Exit code 1 if the throughput runs disagree.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional


def _run_search(model_name: str, batch_size: int, devices: int,
                budget: int, seed: int, delta: bool):
    from ..simulator.machine import H100MachineModel
    from ..simulator.search import mcmc_search
    from .offline_search import build_model

    before = os.environ.get("FF_SIM_DELTA")
    os.environ["FF_SIM_DELTA"] = "1" if delta else "0"
    try:
        # a fresh model per run: op ids must not leak between the two
        # runs' caches, and graph construction is not what is timed
        model = build_model(model_name, batch_size, devices, device="cpu")
        mm = H100MachineModel.calibrated(num_devices=devices)
        return mcmc_search(model, budget=budget, machine_model=mm,
                           seed=seed, verbose=False)
    finally:
        if before is None:
            del os.environ["FF_SIM_DELTA"]
        else:
            os.environ["FF_SIM_DELTA"] = before


def _quality(args) -> int:
    """population vs single chain at equal budget, judged by ONE fresh
    reference simulator; appends a ratio-valued search_quality entry."""
    from ..simulator.cost_model import CostModel
    from ..simulator.machine import H100MachineModel
    from ..simulator.population import population_search
    from ..simulator.search import mcmc_search
    from ..simulator.simulator import Simulator
    from .offline_search import build_model

    def cpu_model(name, batch, devices):
        return build_model(name, batch, devices, device="cpu")

    mm = H100MachineModel.calibrated(num_devices=args.devices)
    # a fresh model per engine: neither search may warm the other's
    # memo caches, and shared op identities would let it
    t0 = time.perf_counter()
    single = mcmc_search(cpu_model(args.model, args.batch_size, args.devices),
                         budget=args.budget, machine_model=mm,
                         seed=args.seed, verbose=False)
    t1 = time.perf_counter()
    pop = population_search(cpu_model(args.model, args.batch_size, args.devices),
                            budget=args.budget, machine_model=mm,
                            seed=args.seed, verbose=False)
    t2 = time.perf_counter()

    # judge both winners under one fresh analytic simulator — the
    # population run may have priced ops with the learned tier, so the
    # search-time best_s numbers are not mutually comparable
    ref_model = cpu_model(args.model, args.batch_size, args.devices)
    ref_sim = Simulator(mm, CostModel(
        mm, measure=False, compute_dtype=ref_model.config.compute_dtype))
    single_ms = ref_sim.simulate_runtime(ref_model, dict(single)) * 1e3
    pop_ms = ref_sim.simulate_runtime(ref_model, dict(pop)) * 1e3
    ratio = single_ms / pop_ms if pop_ms > 0 else 0.0

    stats = pop.stats or {}
    out = {
        "metric": "search_quality",
        "model": args.model,
        "devices": args.devices,
        "budget": args.budget,
        "seed": args.seed,
        "single_ms": round(single_ms, 4),
        "population_ms": round(pop_ms, 4),
        "ratio": round(ratio, 4),
        "population_wins": pop_ms < single_ms,
        "winner_chain": stats.get("winner_chain"),
        "single_secs": round(t1 - t0, 1),
        "population_secs": round(t2 - t1, 1),
    }
    print(json.dumps(out))
    if not args.no_ledger:
        from . import perf_ledger

        perf_ledger.append_entry({
            "kind": "bench",
            "metric": "search_quality",
            "value": round(ratio, 4),
            "unit": "x",
            "backend": "cpu",
            "proxy": False,
            "status": "ok",
            "batch": args.batch_size,
            "provenance": {
                "model": args.model,
                "devices": args.devices,
                "budget": args.budget,
                "seed": args.seed,
                "single_ms": round(single_ms, 4),
                "population_ms": round(pop_ms, 4),
                "winner_chain": stats.get("winner_chain"),
                "population": stats.get("population"),
                "learned": (stats.get("learned") or {}).get(
                    "used_families"),
            },
        }, path=args.ledger)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model", nargs="?", default="alexnet",
                   help="model zoo name (see offline_search)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--devices", type=int, default=16)
    p.add_argument("--budget", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", choices=["throughput", "quality"],
                   default="throughput",
                   help="throughput: delta vs full-rebuild proposals/s; "
                        "quality: population vs single-chain best cost "
                        "at equal budget (ledger value = single_ms / "
                        "population_ms, higher is better)")
    p.add_argument("--repeats", type=int, default=3,
                   help="time each engine this many times, report the "
                        "fastest (results must agree across repeats; "
                        "throughput mode only)")
    p.add_argument("--ledger", default=None,
                   help="perf-ledger path (default: the port's, tools/perf_ledger.py)")
    p.add_argument("--no-ledger", action="store_true",
                   help="measure + compare only, append nothing")
    args = p.parse_args(argv)

    if args.mode == "quality":
        return _quality(args)

    # best-of-N timing on each engine: the searches are deterministic
    # (every repeat must return the same result — checked below), so max
    # throughput is the measurement least polluted by scheduler noise on
    # a shared host.
    runs_a = [_run_search(args.model, args.batch_size, args.devices,
                          args.budget, args.seed, delta=True)
              for _ in range(args.repeats)]
    runs_b = [_run_search(args.model, args.batch_size, args.devices,
                          args.budget, args.seed, delta=False)
              for _ in range(args.repeats)]
    a = max(runs_a, key=lambda r: r.proposals_per_s)
    b = max(runs_b, key=lambda r: r.proposals_per_s)

    identical = all(dict(r) == dict(a) and r.best_s == a.best_s
                    and r.dp_s == a.dp_s for r in runs_a + runs_b)
    ratio = (a.proposals_per_s / b.proposals_per_s
             if b.proposals_per_s else 0.0)
    out = {
        "metric": "search_throughput",
        "model": args.model,
        "devices": args.devices,
        "budget": args.budget,
        "seed": args.seed,
        "repeats": args.repeats,
        "identical": identical,
        "delta_proposals_per_s": round(a.proposals_per_s, 1),
        "full_proposals_per_s": round(b.proposals_per_s, 1),
        "ratio": round(ratio, 1),
        "best_ms": round((a.best_s or 0.0) * 1e3, 3),
    }
    print(json.dumps(out))
    if not identical:
        diff = [k for k in set(a) | set(b) if a.get(k) != b.get(k)]
        print(f"search_bench: MISMATCH delta vs full "
              f"(best_s {a.best_s!r} vs {b.best_s!r}; ops {sorted(diff)})",
              file=sys.stderr)
        return 1
    if not args.no_ledger:
        from . import perf_ledger

        perf_ledger.append_entry({
            "kind": "bench",
            "metric": "search_throughput",
            "value": round(a.proposals_per_s, 1),
            "unit": "proposals/s",
            "backend": "cpu",
            "proxy": False,
            "status": "ok",
            "batch": args.batch_size,
            "provenance": {
                "model": args.model,
                "devices": args.devices,
                "budget": args.budget,
                "seed": args.seed,
                "full_proposals_per_s": round(b.proposals_per_s, 1),
                "ratio": round(ratio, 1),
            },
        }, path=args.ledger)
    return 0


if __name__ == "__main__":
    sys.exit(main())
