"""SOAP-vs-data-parallel report for H100 nodes (PyTorch port of the JAX
package's ``tools/soap_report.py``).

Runs the strategy search for a model over a simulated machine of H100s
(``H100MachineModel``: nodes of 8 GPUs behind NVSwitch, InfiniBand
between nodes) with the cost model the search uses (the card's
measurements from ``measured_h100.json`` where it has them, the fitted
roofline of ``machine_h100.json`` elsewhere), and writes

  * a strategy file (``--export``) that ``--import-strategy`` loads,
  * a markdown report (``--out``, default ``REPORT_SOAP_H100.md``): data
    parallelism against the searched plan's simulated step, the GPipe and
    hetero host-table plans where the model has them, the per-op strategy
    table, the cost model's provenance (op times measured on a card
    against roofline-priced ones), and the single-card simulated-vs-
    measured agreement when a measured ms/step is given,
  * at the canonical report scale and dtype only (``report_configs``), the
    cache keys the report priced into ``report_keys.json`` (or
    ``FF_REPORT_KEYS_PATH``), which calibrate measures first.

The tool runs on the host, on any machine: it builds the graph on the CPU
(no tensor is made) and never initializes CUDA.  The search is the native
annealer (``simulator/native_search.py``); where its library cannot be
built it falls back to the Python mcmc at a capped budget, and the report
says so.

    python -m flexflow_tpu_torch.tools.soap_report alexnet --devices 16 \\
        --export /tmp/alexnet_16.pb --out /tmp/REPORT_SOAP_H100.md \\
        --measured-single-chip-ms 8.2
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

DEFAULT_OUT = "REPORT_SOAP_H100.md"
# The fitted-roofline fields whose difference from the spec defaults makes
# the machine model "fitted".
FIT_FIELDS = ("matmul_efficiency", "hbm_bandwidth", "kernel_launch_overhead",
              "backward_multiplier")


def _write_report_keys(model, args, best, dp, cost) -> None:
    """Merge the keys this report priced (the searched and the
    data-parallel plans, both directions) into the report-keys file under
    ``args.model``, written to a temporary file and renamed, so that a kill
    mid-write never drops the other models' keys."""
    from .report_configs import report_keys_path

    keys_path = report_keys_path()
    try:
        with open(keys_path) as f:
            report_keys = json.load(f)
    except (OSError, ValueError):
        report_keys = {}
    wanted = set()
    for op in model.ops:
        for cfg in (best[op.name], dp[op.name]):
            if cfg.host_placed:
                # a host-placed table is never priced from the measured
                # cache (CostModel._host_embedding_time)
                continue
            for which in ("forward", "backward"):
                wanted.add(cost._key(op, cfg, which))
    report_keys[args.model] = {"devices": args.devices, "batch": args.batch_size,
                               "keys": sorted(wanted)}
    tmp = f"{keys_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(report_keys, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, keys_path)


def main(argv: Optional[List[str]] = None):
    from .report_configs import (BENCH_SINGLE_CHIP_BATCH, REPORT_COMPUTE_DTYPE,
                                 REPORT_DEVICES, REPORT_GLOBAL_BATCH, SEARCH_BUDGET,
                                 SEARCH_BUDGET_DEFAULT, SEARCH_RESTARTS, THIN_FIT_OP_TYPES,
                                 THIN_FIT_POINTS)

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", default="alexnet", nargs="?")
    p.add_argument("--devices", type=int, default=None,
                   help="H100s: up to 8 on one node, or whole nodes of 8 (default: the "
                        "model's entry in report_configs.py, else 16)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="global batch (default: the model's entry in report_configs.py, "
                        "shared with calibrate so that measured keys match priced shapes)")
    p.add_argument("--budget", type=int, default=None,
                   help="annealing proposals per restart (default: report_configs.py)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--restarts", type=int, default=None,
                   help="independent restarts (seeds seed..seed+N-1), the best plan kept "
                        "(default: report_configs.SEARCH_RESTARTS)")
    p.add_argument("--compute-dtype", default=REPORT_COMPUTE_DTYPE)
    p.add_argument("--export", default=None, help="strategy .pb output path")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--measured-single-chip-ms", type=float, default=None,
                   help="measured ms/step of the model on one card at --single-chip-batch, "
                        "for the agreement line")
    p.add_argument("--single-chip-batch", type=int, default=BENCH_SINGLE_CHIP_BATCH)
    args = p.parse_args(argv)
    if args.devices is None:
        args.devices = REPORT_DEVICES.get(args.model, 16)
    if args.batch_size is None:
        args.batch_size = REPORT_GLOBAL_BATCH.get(args.model, 1024)
    if args.budget is None:
        args.budget = SEARCH_BUDGET.get(args.model, SEARCH_BUDGET_DEFAULT)
    args.restarts = max(1, SEARCH_RESTARTS if args.restarts is None else args.restarts)

    from ..config import DeviceType, ParallelConfig
    from ..parallel.strategy import save_strategies_to_file
    from ..simulator.cost_model import CostModel
    from ..simulator.machine import CALIBRATION_PATH, H100MachineModel
    from ..simulator.native_search import native_mcmc_search, unavailable
    from ..simulator.pipeline_search import search_pipeline
    from ..simulator.search import mcmc_search
    from ..simulator.simulator import Simulator
    from .offline_search import build_model

    def graph(batch, nd):  # on the host: no tensor is made, CUDA is never touched
        return build_model(args.model, batch, nd, "cpu", args.compute_dtype)

    model = graph(args.batch_size, args.devices)
    mm = H100MachineModel.calibrated(num_devices=args.devices)
    cost = CostModel(mm, measure=False, compute_dtype=args.compute_dtype)
    sim = Simulator(mm, cost)
    dp = {op.name: ParallelConfig.data_parallel(op.output.num_dims, args.devices)
          .with_device_ids(tuple(range(args.devices))) for op in model.ops}
    dp_rt = sim.simulate_runtime(model, dp)

    # restarts: independent seeds reach different basins; the best is kept
    why_not = unavailable("")
    if why_not is None:
        engine = "native (C++ annealer)"
    else:
        py_budget = min(args.budget, 4 * SEARCH_BUDGET_DEFAULT)
        engine = f"python mcmc (budget capped at {py_budget}; native unavailable)"
        print(f"soap_report: the native annealer cannot be built ({why_not.splitlines()[0]}); "
              f"running mcmc at budget {py_budget}")
    best, best_rt = None, float("inf")
    for rs in range(args.restarts):
        if why_not is None:
            cand = native_mcmc_search(model, budget=args.budget, machine_model=mm,
                                      seed=args.seed + rs, verbose=False,
                                      num_devices=args.devices)
        else:
            cand = mcmc_search(model, budget=py_budget, machine_model=mm, seed=args.seed + rs,
                               verbose=False, num_devices=args.devices)
        cand = dict(cand)
        cand_rt = sim.simulate_runtime(model, cand)
        if cand_rt < best_rt:
            best, best_rt = cand, cand_rt
    speedup = dp_rt / best_rt if best_rt > 0 else float("inf")

    # the other searched space: GPipe stage assignment
    pipe_plan = search_pipeline(model, machine_model=mm)

    # the hetero host-table plan (reference dlrm_strategy_hetero.cc): the
    # eligible tables host-resident row-sparse, the rest data-parallel
    het_rt = het_pipe = None
    elig = {op.name for op in model.ops
            if op._type == "Embedding" and model._sparse_embed_candidate_ok(op)}
    if elig:
        het = {op.name: (ParallelConfig.host_rowsparse(op.output.num_dims)
                         if op.name in elig else dp[op.name]) for op in model.ops}
        het_rt = sim.simulate_runtime(model, het)
        # host tables ahead of a GPipe ring over the dense rest, on a twin
        # whose config carries the host placements
        mh = graph(args.batch_size, args.devices)
        for op in model.ops:
            if op.name in elig:
                mh.config.strategies[op.name] = ParallelConfig.host_rowsparse(
                    op.output.num_dims)
        het_pipe = search_pipeline(mh, machine_model=mm)
        if het_pipe is not None and het_pipe == pipe_plan:
            het_pipe = None  # no table hoisted: not a plan of its own

    # provenance: how many of the compared plans' op times are measured
    prov_cost = CostModel(mm, measure=False, compute_dtype=args.compute_dtype)
    for op in model.ops:
        for which in ("forward", "backward"):
            prov_cost.op_time(op, best[op.name], which)
            prov_cost.op_time(op, dp[op.name], which)
    measured = prov_cost.stats["measured_hits"]
    analytic = prov_cost.stats["analytic"]

    # only the canonical report configuration publishes its keys: a run at
    # another scale or dtype prices keys calibrate's job space never forms
    canonical = (args.devices == REPORT_DEVICES.get(args.model)
                 and args.batch_size == REPORT_GLOBAL_BATCH.get(args.model)
                 and args.compute_dtype == REPORT_COMPUTE_DTYPE)
    if canonical:
        try:
            _write_report_keys(model, args, best, dp, prov_cost)
        except OSError as e:  # a hint file never fails the report
            print(f"soap_report: report_keys.json not written ({e})")

    agree = None
    if args.measured_single_chip_ms:
        m1 = graph(args.single_chip_batch, 1)
        mm1 = H100MachineModel.calibrated(num_devices=1)
        sim1 = Simulator(mm1, CostModel(mm1, measure=False, compute_dtype=args.compute_dtype))
        dp1 = {op.name: ParallelConfig.data_parallel(op.output.num_dims, 1) for op in m1.ops}
        sim_ms = sim1.simulate_runtime(m1, dp1) * 1e3
        agree = (sim_ms, args.measured_single_chip_ms, sim_ms / args.measured_single_chip_ms)

    if args.export:
        save_strategies_to_file(args.export, best)

    # "fitted" only when the calibration really overrode the spec constants
    defaults = H100MachineModel(num_devices=args.devices)
    fitted = any(getattr(mm, f) != getattr(defaults, f) for f in FIT_FIELDS)
    roofline = ("fitted roofline (machine_h100.json: constants fitted to measurements on "
                f"a card; {mm.source})" if fitted else
                "unfitted roofline (the H100 data sheet's constants: machine_h100.json "
                "absent; run tools/calibrate.py on a card)")
    if fitted:
        try:
            with open(CALIBRATION_PATH) as f:
                meta = json.load(f)
            pts, fams = meta.get("fit_points"), meta.get("fit_op_types")
            if pts:
                basis = f"fit basis: {pts} measured points"
                if fams:
                    basis += f" over {len(fams)} op type(s) ({', '.join(fams)})"
                if pts < THIN_FIT_POINTS or (fams and len(fams) < THIN_FIT_OP_TYPES):
                    basis += " -- THIN: constants extrapolate to unmeasured op families"
                roofline += f"; {basis}"
        except (OSError, ValueError):
            pass
    nodes = f"{mm.num_nodes} node(s) of up to 8 behind NVSwitch" + (
        ", InfiniBand between nodes" if mm.num_nodes > 1 else "")
    lines = [
        f"# SOAP search vs data parallel -- {args.model}",
        "",
        f"Machine: simulated H100s, {args.devices} GPUs ({nodes}), {roofline} "
        f"(matmul_eff={mm.matmul_efficiency:.2f}, hbm={mm.hbm_bandwidth / 1e9:.0f} GB/s, "
        f"ovh={mm.kernel_launch_overhead * 1e6:.1f} us, "
        f"bwd_mult={mm.backward_multiplier:.2f}); global batch {args.batch_size}, "
        f"{args.compute_dtype}.",
        f"Cost provenance over the compared strategies: {measured} op times measured on a "
        f"card (measured_h100.json), {analytic} from the "
        f"{'fitted' if fitted else 'unfitted'} roofline.",
        f"Search engine: {engine}, budget {args.budget} x {args.restarts} restarts, best "
        "kept (reference: FFModel::optimize MCMC, model.cc:1056-1107).",
    ]
    if any(op._type == "Embedding" for op in model.ops):
        lines += [
            "Assumption: a data-parallel embedding's gradient sync is priced by the rows "
            "touched (a sparse-aware all-reduce); the port's data-parallel step all-reduces "
            "the dense table gradient, so the simulated data-parallel step is a lower bound "
            "on its cost.",
        ]
    lines += [
        "",
        "| strategy | simulated step | speedup |",
        "|---|---|---|",
        f"| data parallel ({args.devices}-way batch) | {dp_rt * 1e3:.3f} ms | 1.00x |",
        f"| SOAP searched | {best_rt * 1e3:.3f} ms | {speedup:.2f}x |",
    ]
    if pipe_plan is not None:
        lines.append(
            f"| pipeline plan ({pipe_plan['num_stages']} stages x dp{pipe_plan['dp_degree']}, "
            f"M={pipe_plan['num_microbatches']}{', remat' if pipe_plan.get('remat') else ''}) "
            f"| {pipe_plan['simulated_s'] * 1e3:.3f} ms | "
            f"{dp_rt / pipe_plan['simulated_s']:.2f}x |")
    else:
        lines.append("| pipeline plan | n/a (branching graph or no executable partition) | |")
    if het_rt is not None:
        lines.append(f"| hetero host-embedding (row-sparse tables, dlrm_strategy_hetero) | "
                     f"{het_rt * 1e3:.3f} ms | {dp_rt / het_rt:.2f}x |")
    if het_pipe is not None:
        lines.append(
            f"| hetero head + pipeline ({het_pipe['num_stages']} stages x "
            f"dp{het_pipe['dp_degree']}, M={het_pipe['num_microbatches']}"
            f"{', remat' if het_pipe.get('remat') else ''}; host tables ahead of the ring) | "
            f"{het_pipe['simulated_s'] * 1e3:.3f} ms | "
            f"{dp_rt / het_pipe['simulated_s']:.2f}x |")
    lines.append("")
    if agree:
        lines += [
            "## Simulated-vs-measured agreement (single card)",
            "",
            f"{args.model} at batch {args.single_chip_batch} on 1 card: simulated "
            f"{agree[0]:.2f} ms/step vs measured {agree[1]:.2f} ms/step -- ratio "
            f"{agree[2]:.2f}.",
            "",
        ]
    lines += ["## Searched per-op strategies", "", "| op | dims | parts |", "|---|---|---|"]
    for op in model.ops:
        pc = best[op.name]
        if pc.device_type == DeviceType.CPU:
            mark = " **(HOST row-sparse)**"
        else:
            mark = "" if pc.dims == dp[op.name].dims else " **(non-DP)**"
        lines.append(f"| {op.name} | {list(pc.dims)}{mark} | {pc.num_parts()} |")
    lines.append("")
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"dp {dp_rt * 1e3:.3f} ms, soap {best_rt * 1e3:.3f} ms ({speedup:.2f}x), "
          f"measured entries {measured}, -> {args.out}")
    return {"dp_ms": dp_rt * 1e3, "soap_ms": best_rt * 1e3, "speedup": speedup,
            "measured": measured, "analytic": analytic, "engine": engine,
            "canonical": canonical}


if __name__ == "__main__":
    main()
