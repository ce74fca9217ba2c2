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

Before the op jobs it times a ladder of pinned host<->device copies (1, 8
and 64 MiB, ``measure_host_transfer``) and fits the host link's rate and
latency (``fit_host_transfer``), which price host-resident tables.

Writes ``flexflow_tpu_torch/simulator/measured_h100.json`` (the measured
cache, each entry tagged with the card's name) and ``machine_h100.json``
(the fit, with the card's name and power limit), or the ``--out`` and
``--fit-out`` paths, and prints both as JSON lines.  Without them the
simulator runs on the spec constants and says "unfitted".  The fit is
merged over the file's previous one, per key and per op family
(``merge_fit``), so a partial window erases nothing it did not fit; a fit
of entries measured off a card (``--device cpu``) is written only where
``--fit-out`` names a file.

Job order: the cache keys the SOAP reports price (``report_keys.json``,
written by ``tools/soap_report.py``; ``FF_REPORT_KEYS_PATH`` overrides
it) come first, cheapest by the roofline first, so that a short window
raises the reports' measured provenance; a model whose report scale the
enumeration does not cover gets targeted jobs for exactly those keys.
The rest follows in enumeration order.  Without the file the order is
the enumeration's.

Per-job supervision (the JAX package's, calibrate.py:144-260 there): by
default the measuring runs in a worker subprocess (``--worker``) that
writes a heartbeat (``--heartbeat``) before each job; this process
watches it and kills the worker when a job's beat is older than
``--job-timeout`` or its first beat never comes, writes the stuck key to
the skip file (``--skip-keys-file``) and starts the worker again, which
resumes from the durable cache (every measurement is persisted as it
lands), at most ``--max-restarts`` times.  So a CUDA call that hangs
costs one job, not the run; the fit then runs here, from the cache.
``--no-supervise`` measures in this process.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .report_configs import (REPORT_DEVICES, REPORT_GLOBAL_BATCH, THIN_FIT_OP_TYPES,
                             THIN_FIT_POINTS, report_keys_path)


def candidate_jobs(model, nd: int, cost, full: bool,
                   dp_parts: Optional[Sequence[int]] = None) -> List[Tuple]:
    """(op, pc, which, key) jobs, deduplicated by cache key and without the
    keys the cache holds.  ``full`` enumerates every config the search can
    propose over ``nd`` devices; otherwise the data-parallel configs of
    ``dp_parts`` parts (default: ``nd`` and 1)."""
    from ..config import ParallelConfig
    from ..simulator.native_search import enumerate_candidates

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


def read_report_keys() -> Dict[str, Dict]:
    """``{model: {"devices", "batch", "keys"}}`` from the report-keys file
    (``report_keys_path()``); {} when it cannot be read, and then the
    fallback line is printed."""
    path = report_keys_path()
    try:
        with open(path) as f:
            raw = json.load(f)
        return {name: (e if isinstance(e, dict) else
                       {"devices": REPORT_DEVICES.get(name), "batch": None, "keys": e})
                for name, e in raw.items()}
    except Exception as e:  # noqa: BLE001 -- a hint file never stops a calibration
        print(f"[calibrate] no report-key priority hints ({path}: {e!r}) -- job order "
              "falls back to the enumeration order", flush=True)
        return {}


def build_job_list(models_batches: Sequence[Tuple[str, int]], models, devices: int, cost,
                   full: bool, dp_parts: Optional[Sequence[int]], build, fit_only: bool = False):
    """(jobs, [(model, devices)] the fit also reads).  The enumerated jobs
    of ``models``, with the keys of the report-keys file first, cheapest by
    the roofline first.  A report model whose
    keys the enumeration does not hold is built at its report scale by
    ``build(name, batch, devices)`` (or taken from ``models`` when it is one
    of them at that scale) and gets targeted jobs for exactly those keys;
    the models built for it join the fit's records."""
    from ..simulator.native_search import enumerate_candidates

    jobs = [] if fit_only else [j for m in models
                                for j in candidate_jobs(m, devices, cost, full, dp_parts)]
    hints = read_report_keys()
    extra, targeted = [], []
    seen = {j[3] for j in jobs}
    enumerated = {(name, batch): m for (name, batch), m in zip(models_batches, models)}
    for name, entry in sorted(hints.items()):
        nd_r = entry.get("devices") or REPORT_DEVICES.get(name, devices)
        b_r = entry.get("batch") or REPORT_GLOBAL_BATCH.get(name, 1024)
        kset = set(entry.get("keys") or [])
        if nd_r == devices and (name, b_r) in enumerated:
            mt = enumerated[name, b_r]
        else:
            try:
                mt = build(name, b_r, nd_r)
            except Exception as e:  # noqa: BLE001 -- a model this version cannot build
                print(f"[calibrate] report keys of {name!r} skipped: {e}", flush=True)
                continue
            extra.append((mt, nd_r))
        if fit_only:
            continue
        for op in mt.ops:
            for pc in enumerate_candidates(op, nd_r):
                pc = op.legalize_pc(pc)
                for which in ("forward", "backward"):
                    key = cost._key(op, pc, which)
                    if key in kset and key not in seen and key not in cost._measured:
                        seen.add(key)
                        targeted.append((op, pc, which, key))
    prio = set()
    for entry in hints.values():
        prio.update(entry.get("keys") or [])
    first = [j for j in jobs if j[3] in prio] + targeted
    first.sort(key=lambda j: cost._analytic(j[0], j[1], j[2]))
    return first + [j for j in jobs if j[3] not in prio], extra


def beat(heartbeat_path: Optional[str], key, i: int) -> None:
    """Write the worker's heartbeat ``{"key", "i", "t"}`` (replaced
    atomically: the supervisor reads it meanwhile).  ``key`` None is the
    end of the measuring loop, after which no stale beat kills the worker."""
    if not heartbeat_path:
        return
    try:
        tmp = heartbeat_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"key": key, "i": i, "t": time.time()}, f)
        os.replace(tmp, heartbeat_path)
    except OSError:
        pass


def run_measurements(jobs, cost, max_seconds: float = 3600.0, verbose: bool = True,
                     heartbeat_path: Optional[str] = None,
                     skip_keys: Optional[set] = None) -> int:
    """Cost every job with a measuring cost model (each measurement is
    persisted as it lands; a failed one raises), writing a heartbeat before
    each (``beat``) and skipping the keys a previous attempt hung on;
    returns the number of jobs done."""
    done = 0
    t_start = time.time()
    skip_keys = skip_keys or set()
    for i, (op, pc, which, key) in enumerate(jobs):
        if time.time() - t_start > max_seconds:
            print(f"[calibrate] time budget hit after {done}/{len(jobs)} jobs", flush=True)
            break
        if key in skip_keys:
            print(f"[{i + 1}/{len(jobs)}] {key} SKIPPED (hung a previous attempt)", flush=True)
            continue
        beat(heartbeat_path, key, i)
        t = cost.op_time(op, pc, which)
        done += 1
        if verbose:
            print(f"[{i + 1}/{len(jobs)}] {key} -> {t * 1e6:.1f} us", flush=True)
    beat(heartbeat_path, None, len(jobs))
    return done


# The host<->device ladder: bytes a copy (1, 8 and 64 MiB) and timed round
# trips of each.
HOST_XFER_SIZES = (1 << 20, 8 << 20, 64 << 20)
HOST_XFER_ITERS = 5


def measure_host_transfer(cost, verbose: bool = True, heartbeat_path: Optional[str] = None,
                          skip_keys: Optional[set] = None) -> int:
    """Time pinned host<->device copies over HOST_XFER_SIZES on the cost
    model's card (the JAX package's ``measure_host_transfer``): each
    round trip (a host-to-device then a device-to-host copy between pinned
    host buffers and the card, bracketed by ``torch.cuda.synchronize``), the
    median of HOST_XFER_ITERS after one warm-up, halved, is stored as
    ``host_xfer:<bytes>`` in the measured cache.  These are the rates the
    host-resident tables' cost path prices (``pcie_bandwidth``,
    ``host_xfer_latency``; ``fit_host_transfer``).  A device that is not a
    card has no such link: nothing is measured.  Returns the sizes timed."""
    import torch

    if cost.device is None or cost.device.type != "cuda":
        return 0
    skip_keys = skip_keys or set()
    done = 0
    for nbytes in HOST_XFER_SIZES:
        key = f"host_xfer:{nbytes}"
        if key in cost._measured or key in skip_keys:
            continue
        beat(heartbeat_path, key, -1)
        host = torch.ones(nbytes // 4, dtype=torch.float32).pin_memory()
        back = torch.empty_like(host).pin_memory()
        dev = torch.empty_like(host, device=cost.device)
        ts = []
        for _ in range(HOST_XFER_ITERS + 1):
            torch.cuda.synchronize(cost.device)
            t0 = time.perf_counter()
            dev.copy_(host, non_blocking=True)
            back.copy_(dev, non_blocking=True)
            torch.cuda.synchronize(cost.device)
            ts.append(time.perf_counter() - t0)
        t = sorted(ts[1:])[HOST_XFER_ITERS // 2] / 2.0  # seconds a direction
        cost._measured[key] = t
        cost._persist(key, t, cost.measurement_tag())
        done += 1
        if verbose:
            print(f"[calibrate] {key} -> {t * 1e3:.3f} ms a direction "
                  f"({nbytes / t / 1e9:.2f} GB/s)", flush=True)
    # the end of the ladder: no stale beat may kill the worker before its
    # op jobs beat again
    beat(heartbeat_path, None, -1)
    return done


def fit_host_transfer(cost) -> Dict:
    """Least squares ``t = latency + bytes / bandwidth`` over the
    ``host_xfer`` entries of the cost model's cache (the JAX package's
    ``fit_host_transfer``); returns the machine model's ``pcie_bandwidth``
    and ``host_xfer_latency``, or {} with fewer than two sizes or a slope
    that is not positive."""
    import numpy as np

    pts = sorted((int(k.split(":")[1]), t) for k, t in cost._measured.items()
                 if k.startswith("host_xfer:"))
    if len(pts) < 2:
        return {}
    x = np.array([p[0] for p in pts], float)
    y = np.array([p[1] for p in pts], float)
    a = np.vstack([np.ones_like(x), x]).T
    (lat, slope), *_ = np.linalg.lstsq(a, y, rcond=None)
    if slope <= 0:
        return {}
    return {"pcie_bandwidth": float(1.0 / slope), "host_xfer_latency": float(max(0.0, lat))}


def supervise_worker(argv: List[str], job_timeout: float, max_restarts: int = 2,
                     max_seconds: float = 3600.0, startup_timeout: float = 420.0,
                     poll: float = 1.0, worker_cmd: Optional[List[str]] = None) -> int:
    """Run the measuring in ``calibrate --worker`` subprocesses and watch
    their heartbeat: a job whose beat is older than ``job_timeout``, or a
    worker with no first beat after ``max(job_timeout, startup_timeout)``
    (CUDA's initialization hung), is killed, its key appended to the skip
    file, and the worker started again (it resumes from the durable
    cache), at most ``max_restarts`` times; ``max_seconds`` bounds the
    whole supervision.  ``worker_cmd`` replaces the worker's command line
    (before ``argv``; tests pass a stand-in).  Returns the last worker's
    exit code, or 1 when a worker was killed for the last time."""
    import subprocess
    import tempfile

    fd, hb = tempfile.mkstemp(prefix="ffcal_hb_", suffix=".json")
    os.close(fd)
    fd, skipfile = tempfile.mkstemp(prefix="ffcal_skip_", suffix=".txt")
    os.close(fd)
    base = worker_cmd or [sys.executable, "-m", "flexflow_tpu_torch.tools.calibrate"]
    cmd = base + ["--worker", "--heartbeat", hb, "--skip-keys-file", skipfile] + list(argv)
    startup = max(job_timeout, startup_timeout)
    t_global = time.time()
    try:
        for attempt in range(max_restarts + 1):
            with open(hb, "w"):  # no stale beat of the last attempt
                pass
            t_spawn = time.time()
            proc = subprocess.Popen(cmd)
            stuck, finished = None, False
            while True:
                try:
                    rc = proc.wait(timeout=poll)
                    if rc != 0:
                        print(f"[calibrate] worker exited rc={rc}", flush=True)
                    return rc
                except subprocess.TimeoutExpired:
                    pass
                if time.time() - t_global > max_seconds:
                    print("[calibrate] wall budget spent: killing the worker, keeping the "
                          "measurements so far", flush=True)
                    proc.kill()
                    proc.wait()
                    return 1
                try:
                    with open(hb) as f:
                        last = json.load(f)
                except (OSError, ValueError):
                    last = None
                if last and last.get("key"):
                    if time.time() - last["t"] > job_timeout:
                        stuck = last["key"]
                        print(f"[calibrate] job hung > {job_timeout:.0f} s ({stuck}): killing "
                              f"the worker (attempt {attempt + 1}/{max_restarts + 1})",
                              flush=True)
                elif last is not None and "key" in last:
                    finished = True  # the loop ended; its teardown is never killed
                elif not finished and time.time() - t_spawn > startup:
                    print(f"[calibrate] the worker wrote no heartbeat in {startup:.0f} s: "
                          f"killing it (attempt {attempt + 1}/{max_restarts + 1})",
                          flush=True)
                    stuck = ""
                if stuck is not None:
                    proc.kill()
                    proc.wait()
                    break
            if stuck:
                with open(skipfile, "a") as f:
                    f.write(stuck + "\n")
            if attempt == max_restarts:
                print("[calibrate] restart budget spent: keeping the measurements persisted "
                      "so far", flush=True)
        return 1
    finally:
        for path in (hb, hb + ".tmp", skipfile):
            try:
                os.unlink(path)
            except OSError:
                pass


def collect_fit_records(models, nds, cost) -> List[Dict]:
    """(flops, bytes, measured forward and backward seconds) per measured
    key of the models' candidate configs."""
    import numpy as np

    from ..simulator.native_search import enumerate_candidates

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
    """Write ``data`` to ``path`` atomically: a kill mid-write leaves the
    previous file whole."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# the fit's per-family entries, merged per family
FAMILY_KEYS = ("op_efficiency", "op_backward_multiplier")


def merge_fit(prev: Dict, new: Dict) -> Dict:
    """``new`` over ``prev``, per key and, for FAMILY_KEYS, per family (the
    JAX package's rule): a partial fit, a ladder alone or a window that
    measured fewer op families, never erases what it did not fit."""
    merged = {**prev, **new}
    for k in FAMILY_KEYS:
        if k in prev or k in new:
            merged[k] = {**prev.get(k, {}), **new.get(k, {})}
    return merged


def _read_fit(path: str) -> Dict:
    try:
        return _read_json(path)
    except (OSError, ValueError):
        return {}


def calibrate(models_batches: Sequence[Tuple[str, int]], devices: int = 8,
              full: bool = False, dp_parts: Optional[Sequence[int]] = None,
              compute_dtype: str = "bfloat16", out: Optional[str] = None,
              fit_out: Optional[str] = None, fit_only: bool = False,
              max_seconds: float = 3600.0, device: str = "cuda",
              verbose: bool = True, heartbeat: Optional[str] = None,
              skip_keys: Optional[set] = None, do_fit: bool = True,
              platform: Optional[str] = None) -> Dict:
    """Measure (unless ``fit_only``: the host-transfer ladder, then the op
    jobs) and fit (unless not ``do_fit``: a supervised worker leaves the
    fit to its supervisor); writes the measured cache to ``out`` and the
    fit to ``fit_out``, merged over that file's previous fit
    (``merge_fit``), and returns ``{"jobs", "measured", "seconds", "fit",
    "written"}``.  The cost model reads ``out`` first, so keys it holds are
    not measured again.  A refit (``fit_only``) reads the entries of
    ``platform`` (default: the card's, "cuda") and labels the fit with the
    cards they name.  A fit of entries taken off a CUDA device is written
    only to a ``fit_out`` the caller names: the packaged
    ``machine_h100.json``, which every search reads, holds a card's fit."""
    from ..simulator import cost_model as cm
    from ..simulator.machine import CALIBRATION_PATH, H100MachineModel
    from .offline_search import build_model

    out = out or cm.MEASURED_CACHE
    fit_out_named = fit_out is not None
    fit_out = fit_out or CALIBRATION_PATH
    mm = H100MachineModel(num_devices=devices)
    import torch

    # measurements are tagged with the device's platform; a refit reads the card's
    platform = platform or ("cuda" if fit_only else torch.device(device).type)
    cost = cm.CostModel(mm, measure=not fit_only, cache_path=out, measured_cache_path=out,
                        compute_dtype=compute_dtype, target_platform=platform,
                        device=None if fit_only else device)
    models = [build_model(name, batch, devices, device, compute_dtype)
              for name, batch in models_batches]
    jobs, extra = build_job_list(
        models_batches, models, devices, cost, full, dp_parts,
        lambda name, batch, nd: build_model(name, batch, nd, device, compute_dtype), fit_only)
    t0 = time.perf_counter()
    if not fit_only:
        # seconds of work, and the only measurement of the host link: before
        # the op jobs, so that a window cut short still lands it
        measure_host_transfer(cost, verbose, heartbeat, skip_keys)
    if jobs:
        print(f"[calibrate] {len(jobs)} measurement jobs, {len(cost._measured)} entries "
              f"already in {out}", flush=True)
        run_measurements(jobs, cost, max_seconds, verbose, heartbeat, skip_keys)
    seconds = time.perf_counter() - t0
    result = {"jobs": len(jobs), "measured": len(cost._measured), "seconds": seconds,
              "fit": {}, "written": False, "out": out, "fit_out": fit_out}
    if not do_fit:
        return result
    fit = fit_machine(collect_fit_records(models + [m for m, _ in extra],
                                          [devices] * len(models) + [nd for _, nd in extra],
                                          cost), mm)
    # the host link fits apart from the roofline: a window that measured
    # the ladder and no op still lands it
    fit.update(fit_host_transfer(cost))
    if not fit:
        if fit_only:
            print(f"[calibrate] nothing to fit: {out} holds no measured {platform!r} entry "
                  f"of these models", flush=True)
        return result
    if platform != "cuda" and not fit_out_named:
        print(f"[calibrate] NOT writing the machine fit: its entries were measured on "
              f"{platform!r}, not a card, and {fit_out} holds a card's fit; name a file "
              f"with --fit-out to keep it", flush=True)
        return dict(result, fit=fit)
    if fit_only:  # the cards the cache's entries name
        tags = [v for v in _read_json(out).values()
                if isinstance(v, dict) and v.get("platform") == platform]
        fit.update(device=" / ".join(sorted({v.get("device", "?") for v in tags})),
                   power_limit=" / ".join(sorted({v.get("power_limit", "not recorded")
                                                  for v in tags})))
    elif platform == "cuda":
        name, limit = cm.card_label()
        fit.update(device=name, power_limit=limit)
    else:
        fit.update(device=platform, power_limit="not a card")
    _write_json(fit_out, merge_fit(_read_fit(fit_out), fit))
    return dict(result, fit=fit, written=True)


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
    p.add_argument("--device", default=None,
                   help="the device measured on (default cuda); with --fit-only, the one "
                        "the models' shapes are built on (default cpu)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--job-timeout", type=float, default=240.0,
                   help="the supervisor kills the measuring worker when one job's heartbeat "
                        "is older than this")
    p.add_argument("--max-restarts", type=int, default=2)
    p.add_argument("--no-supervise", action="store_true",
                   help="measure in this process (a hung CUDA call then holds the run)")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--heartbeat", default=None, help=argparse.SUPPRESS)
    p.add_argument("--skip-keys-file", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    supervised = not (args.fit_only or args.worker or args.no_supervise)
    measure_on = args.device or "cuda"
    if supervised:
        # every device call in a worker this process can kill; then the fit
        # here, from the cache the worker wrote
        fwd = ["--models", args.models, "--devices", str(args.devices), "--dp-parts",
               args.dp_parts, "--compute-dtype", args.compute_dtype, "--max-seconds",
               str(args.max_seconds), "--device", measure_on]
        fwd += (["--full"] if args.full else []) + (["--quiet"] if args.quiet else [])
        fwd += ["--out", args.out] if args.out else []
        supervise_worker(fwd, args.job_timeout, args.max_restarts,
                         max_seconds=args.max_seconds + 900.0)
    # a fit reads measured entries of one platform: the worker's after a
    # supervised run, the card's under --fit-only; its models are only
    # shapes, so any host refits
    if supervised:
        fit_only, platform, device = True, measure_on.split(":")[0], "cpu"
    elif args.fit_only:
        fit_only, platform, device = True, "cuda", args.device or "cpu"
    else:
        fit_only, platform, device = False, None, measure_on
    skip = set()
    if args.skip_keys_file and os.path.exists(args.skip_keys_file):
        with open(args.skip_keys_file) as f:
            skip = {ln.strip() for ln in f if ln.strip()}
    import torch

    torch.backends.cudnn.benchmark = False
    models = [(m.split(":")[0], int(m.split(":")[1])) for m in args.models.split(",") if m]
    parts = [int(x) for x in args.dp_parts.split(",") if x and int(x) <= args.devices]
    r = calibrate(models, args.devices, args.full, parts, args.compute_dtype, args.out,
                  args.fit_out, fit_only, args.max_seconds, device,
                  verbose=not args.quiet, heartbeat=args.heartbeat, skip_keys=skip,
                  do_fit=not args.worker, platform=platform)
    if args.worker:
        print(f"[calibrate] worker done: {r['measured']} entries -> {r['out']}", flush=True)
        return r
    fit = r["fit"]
    dest = f"-> {r['fit_out']}" if r["written"] else "(not written)"
    if "fit_points" in fit:
        print(f"[calibrate] fitted over {fit['fit_points']} points (log-rmse "
              f"{fit['fit_log_rmse']:.3f}): matmul_eff={fit['matmul_efficiency']:.2f} "
              f"hbm={fit['hbm_bandwidth'] / 1e9:.0f}GB/s "
              f"ovh={fit['kernel_launch_overhead'] * 1e6:.0f}us "
              f"bwd_mult={fit['backward_multiplier']:.2f} {dest}")
    if "pcie_bandwidth" in fit:
        print(f"[calibrate] host link: {fit['pcie_bandwidth'] / 1e9:.2f} GB/s, latency "
              f"{fit['host_xfer_latency'] * 1e6:.1f} us {dest}")
    print(f"[calibrate] measured cache: {r['measured']} entries -> {r['out']} "
          f"(cudnn.benchmark False)")
    print(json.dumps({"measured_h100": _read_json(r["out"])}, sort_keys=True))
    print(json.dumps({"machine_h100": fit}, sort_keys=True))
    return r


if __name__ == "__main__":
    main()
