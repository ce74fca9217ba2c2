"""Cost-model calibration on an H100.

Counterpart of the JAX package's ``tools/calibrate.py`` (reference:
simulator.cc:235-273, where every candidate's per-op time comes from
running the real kernels, cached by (op, config) hash).  This tool times
the forward and backward of each op config of the chosen models on the
card up front (``CostModel._measure_real``: the part's sub-shape and weight
slice, CUDA events behind a held stream, the median of several
iterations), writes the measured cache, and fits the roofline constants
(matmul efficiency, HBM bandwidth, per-op overhead, backward multiplier,
per-family refinements) to the measurements, so that what stays unmeasured
is priced by a fitted roofline too.

    python -m flexflow_tpu_torch.tools.calibrate                 # on a card
    python -m flexflow_tpu_torch.tools.calibrate --full --devices 8
    python -m flexflow_tpu_torch.tools.calibrate --fit-only      # any host

Writes ``flexflow_tpu_torch/simulator/measured_h100.json`` (the measured
cache, each entry tagged with the card's name) and ``machine_h100.json``
(the fit, with the card's name and power limit), or the ``--out`` and
``--fit-out`` paths, and prints both as JSON lines.  Without them the
simulator runs on the spec constants and says "unfitted".
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Below these many points or op families a fit extrapolates (it says so).
THIN_FIT_POINTS = 16
THIN_FIT_OP_TYPES = 3


def candidate_jobs(model, nd: int, cost, full: bool,
                   dp_parts: Optional[Sequence[int]] = None) -> List[Tuple]:
    """(op, pc, which, key) jobs, deduplicated by cache key and without the
    keys the cache holds.  ``full`` enumerates every config the search can
    propose over ``nd`` devices; otherwise the data-parallel configs of
    ``dp_parts`` parts (default: ``nd`` and 1)."""
    from ..config import ParallelConfig
    from ..simulator.search import enumerate_candidates

    jobs, seen = [], set()

    def add(op, pc):
        pc = op.legalize_pc(pc)
        for which in ("forward", "backward"):
            key = cost._key(op, pc, which)
            if key not in seen and key not in cost._measured:
                seen.add(key)
                jobs.append((op, pc, which, key))

    for op in model.ops:
        if full:
            for pc in enumerate_candidates(op, nd):
                add(op, pc)
        else:
            for parts in (dp_parts or sorted({nd, 1})):
                pc = ParallelConfig.data_parallel(op.output.num_dims, parts)
                add(op, pc.with_device_ids(tuple(range(parts))))
    return jobs


def run_measurements(jobs, cost, max_seconds: float = 3600.0, verbose: bool = True) -> int:
    """Cost every job with a measuring cost model (each measurement is
    persisted as it lands; a failed one raises); returns the number of jobs
    done."""
    done = 0
    t_start = time.time()
    for i, (op, pc, which, key) in enumerate(jobs):
        if time.time() - t_start > max_seconds:
            print(f"[calibrate] time budget hit after {done}/{len(jobs)} jobs", flush=True)
            break
        t = cost.op_time(op, pc, which)
        done += 1
        if verbose:
            print(f"[{i + 1}/{len(jobs)}] {key} -> {t * 1e6:.1f} us", flush=True)
    return done


def collect_fit_records(models, nds, cost) -> List[Dict]:
    """(flops, bytes, measured forward and backward seconds) per measured
    key of the models' candidate configs."""
    import numpy as np

    from ..simulator.search import enumerate_candidates

    recs, seen = [], set()
    for model, nd in zip(models, nds):
        for op in model.ops:
            for pc in enumerate_candidates(op, nd):
                pc = op.legalize_pc(pc)
                sub = cost._sub_output_shape(op, pc)
                kf = cost._key(op, pc, "forward")
                kb = cost._key(op, pc, "backward")
                if kf in seen or kf not in cost._measured:
                    continue
                seen.add(kf)
                scale = np.prod(sub) / max(1, np.prod(op.outputs[0].dims))
                flops = op.flops_per_sample() * op.outputs[0].dims[0] * scale
                in_vol = sum(int(np.prod([hi - lo + 1 for lo, hi in op.input_ranges(j, pc, 0)]))
                             for j in range(len(op.inputs)))
                w_vol = sum(int(np.prod([hi - lo + 1 for lo, hi in op.weight_tile(pc, wi, 0)]))
                            for wi in range(len(op.param_weights)))
                out_vol = int(np.prod(sub))
                recs.append({
                    "key": kf,
                    "op": type(op).__name__,
                    "flops": float(flops),
                    "bytes": cost._dtype_bytes * (in_vol + w_vol + out_vol),
                    "t_fwd": cost._measured[kf],
                    "t_bwd": cost._measured.get(kb),
                })
    return recs


def fit_machine(recs: List[Dict], machine) -> Dict:
    """Grid-fit the roofline constants minimizing the squared log-ratio of
    ``max(flops / (peak * eff), bytes / (hbm * hbm_eff)) + ovh`` to the
    measured forward times; the backward multiplier is the median measured
    backward/forward ratio.  Families of 3 points or more get their own
    efficiency and backward multiplier where the grid identifies one."""
    import numpy as np

    if not recs:
        return {}
    flops = np.array([r["flops"] for r in recs])
    byts = np.array([r["bytes"] for r in recs])
    meas = np.array([r["t_fwd"] for r in recs])

    best = (None, math.inf)
    for eff in np.arange(0.05, 1.001, 0.01):
        for hbm_eff in np.arange(0.3, 1.001, 0.05):
            for ovh in (1e-6, 2e-6, 4e-6, 8e-6, 16e-6, 32e-6, 64e-6):
                pred = np.maximum(flops / (machine.peak_flops * eff),
                                  byts / (machine.hbm_bandwidth * hbm_eff)) + ovh
                err = float(np.mean(np.log(pred / meas) ** 2))
                if err < best[1]:
                    best = ((float(eff), float(hbm_eff), float(ovh)), err)
    (eff, hbm_eff, ovh), err = best
    ratios = [r["t_bwd"] / r["t_fwd"] for r in recs if r["t_bwd"] and r["t_fwd"] > 0]
    bwd_mult = float(np.median(ratios)) if ratios else 2.0
    op_eff: Dict[str, float] = {}
    op_bwd: Dict[str, float] = {}
    fams: Dict[str, List[Dict]] = {}
    for r in recs:
        fams.setdefault(r["op"], []).append(r)
    for fam, rs in fams.items():
        if len(rs) < 3:
            continue
        ff = np.array([r["flops"] for r in rs])
        fb = np.array([r["bytes"] for r in rs])
        fm = np.array([r["t_fwd"] for r in rs])

        def fam_err(e):
            pred = np.maximum(ff / (machine.peak_flops * e),
                              fb / (machine.hbm_bandwidth * hbm_eff)) + ovh
            return float(np.mean(np.log(pred / fm) ** 2))

        # seeded with the global efficiency, so that a family whose points
        # are all memory-bound (a flat error surface) keeps the global one
        fbest = (eff, fam_err(eff))
        for e in np.arange(0.05, 1.001, 0.01):
            e_err = fam_err(e)
            if e_err < fbest[1]:
                fbest = (float(e), e_err)
        if fbest[0] != eff:
            op_eff[fam] = fbest[0]
        fr = [r["t_bwd"] / r["t_fwd"] for r in rs if r["t_bwd"] and r["t_fwd"] > 0]
        if len(fr) >= 3:
            op_bwd[fam] = float(np.median(fr))
    op_types = sorted(fams)
    if len(recs) < THIN_FIT_POINTS or len(op_types) < THIN_FIT_OP_TYPES:
        print(f"[calibrate] WARNING: thin fit basis, {len(recs)} points over op types "
              f"{op_types}; constants extrapolate to unmeasured op families", flush=True)
    return {
        "matmul_efficiency": eff,
        "hbm_bandwidth": machine.hbm_bandwidth * hbm_eff,
        "kernel_launch_overhead": ovh,
        "backward_multiplier": bwd_mult,
        "op_efficiency": op_eff,
        "op_backward_multiplier": op_bwd,
        "fit_log_rmse": math.sqrt(err),
        "fit_points": len(recs),
        "fit_op_types": op_types,
    }


def _read_json(path: str) -> Dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _write_json(path: str, data) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def calibrate(models_batches: Sequence[Tuple[str, int]], devices: int = 8,
              full: bool = False, dp_parts: Optional[Sequence[int]] = None,
              compute_dtype: str = "bfloat16", out: Optional[str] = None,
              fit_out: Optional[str] = None, fit_only: bool = False,
              max_seconds: float = 3600.0, device: str = "cuda",
              verbose: bool = True) -> Dict:
    """Measure (unless ``fit_only``) and fit; writes the measured cache to
    ``out`` and the fit to ``fit_out`` and returns ``{"jobs", "measured",
    "seconds", "fit"}``.  The cost model reads ``out`` first, so keys it
    holds are not measured again."""
    from ..simulator import cost_model as cm
    from ..simulator.machine import CALIBRATION_PATH, H100MachineModel
    from .offline_search import build_model

    out = out or cm.MEASURED_CACHE
    fit_out = fit_out or CALIBRATION_PATH
    mm = H100MachineModel(num_devices=devices)
    import torch

    # measurements are tagged with the device's platform; a refit reads the card's
    platform = "cuda" if fit_only else torch.device(device).type
    cost = cm.CostModel(mm, measure=not fit_only, cache_path=out, measured_cache_path=out,
                        compute_dtype=compute_dtype, target_platform=platform,
                        device=None if fit_only else device)
    models = [build_model(name, batch, devices, device, compute_dtype)
              for name, batch in models_batches]
    jobs = [] if fit_only else [j for m in models
                                for j in candidate_jobs(m, devices, cost, full, dp_parts)]
    t0 = time.perf_counter()
    if jobs:
        print(f"[calibrate] {len(jobs)} measurement jobs, {len(cost._measured)} entries "
              f"already in {out}", flush=True)
        run_measurements(jobs, cost, max_seconds, verbose)
    seconds = time.perf_counter() - t0
    fit = fit_machine(collect_fit_records(models, [devices] * len(models), cost), mm)
    if fit:
        if fit_only:  # the cards the cache's entries name
            tags = [v for v in _read_json(out).values()
                    if isinstance(v, dict) and v.get("platform") == "cuda"]
            fit.update(device=" / ".join(sorted({v.get("device", "?") for v in tags})),
                       power_limit=" / ".join(sorted({v.get("power_limit", "not recorded")
                                                      for v in tags})))
        else:
            name, limit = cm.card_label()
            fit.update(device=name, power_limit=limit)
        _write_json(fit_out, fit)
    return {"jobs": len(jobs), "measured": len(cost._measured), "seconds": seconds,
            "fit": fit, "out": out, "fit_out": fit_out}


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models", default="alexnet:256,transformer:16",
                   help="comma list of model:global_batch")
    p.add_argument("--devices", type=int, default=8, help="GPUs of the node searched (1-8)")
    p.add_argument("--full", action="store_true",
                   help="measure every config the search can propose over --devices, not "
                        "only the data-parallel ones")
    p.add_argument("--dp-parts", default="1,2,4,8",
                   help="part counts of the data-parallel configs measured without --full")
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--out", default=None, help="measured cache (default: measured_h100.json)")
    p.add_argument("--fit-out", default=None, help="fit (default: machine_h100.json)")
    p.add_argument("--fit-only", action="store_true",
                   help="refit from the measured cache without measuring (any host)")
    p.add_argument("--max-seconds", type=float, default=3600.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)
    import torch

    torch.backends.cudnn.benchmark = False
    models = [(m.split(":")[0], int(m.split(":")[1])) for m in args.models.split(",") if m]
    parts = [int(x) for x in args.dp_parts.split(",") if x and int(x) <= args.devices]
    r = calibrate(models, args.devices, args.full, parts, args.compute_dtype, args.out,
                  args.fit_out, args.fit_only, args.max_seconds, args.device,
                  verbose=not args.quiet)
    fit = r["fit"]
    if fit:
        print(f"[calibrate] fitted over {fit['fit_points']} points (log-rmse "
              f"{fit['fit_log_rmse']:.3f}): matmul_eff={fit['matmul_efficiency']:.2f} "
              f"hbm={fit['hbm_bandwidth'] / 1e9:.0f}GB/s "
              f"ovh={fit['kernel_launch_overhead'] * 1e6:.0f}us "
              f"bwd_mult={fit['backward_multiplier']:.2f} -> {r['fit_out']}")
    print(f"[calibrate] measured cache: {r['measured']} entries -> {r['out']} "
          f"(cudnn.benchmark False)")
    print(json.dumps({"measured_h100": _read_json(r["out"])}, sort_keys=True))
    print(json.dumps({"machine_h100": fit}, sort_keys=True))
    return r


if __name__ == "__main__":
    main()
