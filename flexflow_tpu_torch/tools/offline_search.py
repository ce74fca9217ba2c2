"""Offline strategy search for an H100 node: no card needed.

Counterpart of the JAX package's ``tools/offline_search.py`` (reference:
scripts/simulator.cc, a cost model that needs no GPU).  Builds a model of
the port's zoo, searches it over an H100 node of ``--devices`` GPUs with
the simulator (the card's measurements from ``measured_h100.json`` where it
has them, the fitted or spec roofline elsewhere), prints the data-parallel
and the best simulated ms/step and the proposals per second, and exports
the best strategy as a ``.pb`` (with its ``.meta.json`` sidecar) that
``--import-strategy`` / ``FFConfig.import_strategy_file`` load.  Every
model of the zoo builds (``MODELS``), at the full width of its cell.

    python -m flexflow_tpu_torch.tools.offline_search alexnet --devices 8 \\
        --budget 2000 --export /tmp/alexnet_8.pb --device cpu
    python -m flexflow_tpu_torch.tools.offline_search transformer --devices 8 \\
        --engine population --device cpu

``--device`` only names where the graph is built (no tensor is made);
it defaults to "cuda" like every entry point of the port.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

# The full-width configurations of the port's cells (PERF.md section 4).
TRANSFORMER = dict(seq_length=512, num_layers=4, embed_dim=512, num_heads=8,
                   vocab_size=32000)
# name -> (builder module, builder, default global batch, builder arguments)
MODELS = {
    "alexnet": ("alexnet", "build_alexnet", 256, {}),
    "resnet": ("resnet", "build_resnet50", 64, {}),
    "inception": ("inception", "build_inception_v3", 128, {}),
    "dlrm": ("dlrm", "build_dlrm", 256, {}),
    "candle_uno": ("candle_uno", "build_candle_uno", 256, {}),
    "nmt": ("nmt", "build_nmt", 64, {}),
    "transformer": ("transformer", "build_transformer", 16, TRANSFORMER),
    "transformer_moe": ("transformer", "build_transformer", 16,
                        dict(TRANSFORMER, moe_every=2, num_experts=8)),
}


def build_model(name: str, batch_size: int, num_devices: int = 1, device: str = "cuda",
                compute_dtype: str = "float32"):
    """The named model of the port's zoo (``MODELS``) at full width, its
    machine sized ``num_devices`` (``workers_per_node``) for a search that
    runs before any machine exists."""
    import importlib

    import flexflow_tpu_torch as ft

    if name not in MODELS:
        raise ValueError(f"unknown model {name!r} (expected one of {', '.join(MODELS)})")
    module, builder, _, kwargs = MODELS[name]
    model = ft.FFModel(ft.FFConfig(batch_size=batch_size, workers_per_node=num_devices,
                                   device=device, compute_dtype=compute_dtype))
    build = getattr(importlib.import_module(f"..models.{module}", __package__), builder)
    build(model, batch_size, **kwargs)
    return model


def run(model, devices: int, budget: int, seed: int = 0, engine: str = "mcmc",
        alpha: float = 0.05, machine_model=None, verbose: bool = False, cost_model=None):
    """Search ``model`` over ``devices`` GPUs; returns the ``SearchResult``.
    ``cost_model`` (over ``machine_model``) replaces the default one, which
    reads the committed measurements."""
    from ..simulator.machine import H100MachineModel

    mm = machine_model or H100MachineModel.calibrated(num_devices=devices)
    kw = dict(budget=budget, alpha=alpha, machine_model=mm, seed=seed, verbose=verbose,
              num_devices=devices, cost_model=cost_model)
    if engine == "population":
        from ..simulator.population import population_search
        return population_search(model, **kw)
    if engine == "native":
        raise NotImplementedError("the native annealer over an NVSwitch topology is not "
                                  "ported yet (ROADMAP A8b)")
    from ..simulator.search import mcmc_search
    return mcmc_search(model, **kw)


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", choices=sorted(MODELS))
    p.add_argument("--batch-size", type=int, default=None,
                   help="global batch (default: the model's cell, MODELS)")
    p.add_argument("--devices", type=int, default=8, choices=range(1, 9), metavar="1-8",
                   help="GPUs of the H100 node")
    p.add_argument("--nvlink-bw", type=float, default=None,
                   help="NVLink bytes/s per direction (default: the spec's 450e9)")
    p.add_argument("--peak-flops", type=float, default=None)
    p.add_argument("--hbm-bw", type=float, default=None)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--budget", type=int, default=2000)
    p.add_argument("--alpha", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--engine", choices=["mcmc", "population", "native"], default="mcmc")
    p.add_argument("--export", default=None, help="strategy .pb output path")
    p.add_argument("--device", default="cuda", help="where the graph is built (cuda or cpu)")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    from ..parallel.strategy import save_strategies_to_file, sidecar_path
    from ..simulator.machine import H100MachineModel

    batch = args.batch_size or MODELS[args.model][2]
    model = build_model(args.model, batch, args.devices, args.device, args.compute_dtype)
    overrides = {k: v for k, v in (("peak_flops", args.peak_flops),
                                   ("hbm_bandwidth", args.hbm_bw),
                                   ("nvlink_bandwidth", args.nvlink_bw)) if v is not None}
    mm = H100MachineModel.calibrated(num_devices=args.devices, **overrides)
    best = run(model, args.devices, args.budget, args.seed, args.engine, args.alpha, mm,
               verbose=not args.quiet)
    print(f"data-parallel: {best.dp_s * 1e3:.3f} ms/iter; searched: {best.best_s * 1e3:.3f} "
          f"ms/iter; speedup {best.dp_s / best.best_s:.2f}x on {args.devices} H100(s); "
          f"{best.proposals_per_s:.0f} proposals/s ({best.engine}; machine {mm.source})")
    if args.export:
        from ..observability.searchtrace import build_provenance, search_stats_extra

        extra = {"model": args.model, "tool": "offline_search", **search_stats_extra(best.stats)}
        save_strategies_to_file(args.export, dict(best), provenance=build_provenance(
            model, dict(best), engine=best.engine, budget=args.budget, seed=args.seed,
            best_s=best.best_s, dp_s=best.dp_s, machine_model=mm, extra=extra))
        print(f"exported strategy -> {args.export} (+ {sidecar_path(args.export)})")
    return best


if __name__ == "__main__":
    main()
