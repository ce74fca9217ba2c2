#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on from):
  1. environment: versions, the card, its power limit;
  2. build the CUDA kernels from flexflow_tpu_torch/kernels/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card, at
     AlexNet's largest leaf, a ragged size and a misaligned view, then
     timed over one step's worth of AlexNet leaves beside its bound, the
     plain version and the library call;
  4. the main path: full-width AlexNet (3x229x229, batch 256, bf16,
     fused optimizer) trained with SGD then Adam through FFModel, with the
     kernels' launch counts checked per step;
  5. path parity: f32 AlexNet at batch 8, two steps with the fused kernels
     and two with the plain update, every weight compared.
The last lines are the card's name and power limit, one JSON object with
a row per kernel, and {"ok": true, "device": {...}}.  Needs one card; it
imports nothing of jax or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

BATCH = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KERNEL_TOL = dict(rtol=1e-6, atol=1e-6)
PARITY_TOL = dict(rtol=1e-6, atol=1e-7)
# Adam's first step is uncorrected (alpha_t = alpha, as in the reference):
# every weight moves by about 3*alpha, and at alpha 1e-3 the loss leaps
# into the thousands before it recovers.  1e-4 keeps the run near its
# starting loss, so a finite loss on every step means something.
ADAM_ALPHA = 1e-4
SOURCE = "flexflow_tpu_torch/kernels/csrc/fused_optimizer.cu"


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_time_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 3

def kernel_cases(fo):
    """One dict per case: label, bytes moved per element, the SGD settings
    (None for Adam), a caller taking (update, w, g, m, v), and the kernel
    wrapper and plain version it is run with."""
    def sgd(mu, nesterov):
        def call(update, w, g, m, v):
            update(w, g, m if mu > 0 else None, 1e-3, 1e-4, mu, nesterov)
        return call

    def adam(update, w, g, m, v):
        update(w, g, m, v, 1e-3, 1e-4, 0.9, 0.999, 1e-8)

    cases = [dict(label=f"fused_sgd_update mu={mu}{' nesterov' if nest else ''}",
                  bpe=20 if mu else 12, sgd=(mu, nest), call=sgd(mu, nest),
                  kernel=fo.fused_sgd_update, plain=fo.fused_sgd_update_ref)
             for mu, nest in ((0.9, False), (0.9, True), (0.0, False))]
    cases.append(dict(label="fused_adam_update", bpe=28, sgd=None, call=adam,
                      kernel=fo.fused_adam_update, plain=fo.fused_adam_update_ref))
    return cases


def operands(n, gen):
    """w, g, m, v of n elements on the card (v >= 0)."""
    return tuple(torch.randn(n, device="cuda", generator=gen).abs_() if i == 3
                 else torch.randn(n, device="cuda", generator=gen) for i in range(4))


def copy_at(t, offset):
    """A copy of ``t``; with offset 1 a view 4 bytes off 16-byte alignment."""
    return torch.cat([t.new_zeros(offset), t])[offset:] if offset else t.clone()


def check_kernels(fo):
    gen = torch.Generator(device="cuda").manual_seed(0)
    sizes = {"fc1_kernel_9216x4096": (9216 * 4096, 0), "ragged_1000003": (1_000_003, 0),
             "misaligned_view": (1_000_003, 1)}
    max_err = {}
    for case in kernel_cases(fo):
        for sname, (n, off) in sizes.items():
            ops = operands(n, gen)
            ka = [copy_at(t, off) for t in ops]
            check(ka[0].data_ptr() % 16 == 4 * off, f"{sname}: unexpected alignment")
            pa = [t.clone() for t in ops]
            case["call"](case["kernel"], *ka)
            case["call"](case["plain"], *pa)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(ka, pa))
            for a, b in zip(ka, pa):
                torch.testing.assert_close(a, b, **KERNEL_TOL)
            name = case["kernel"].__name__
            max_err[name] = max(max_err.get(name, 0.0), err)
            log(f"  check {case['label']:36s} {sname:22s} max_abs_err {err:.3e}")
    return max_err


def time_kernels(fo, leaf_shapes, copy_gbps):
    """Per-step times over AlexNet's 16 leaves (one launch per leaf)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    leaves = [operands(math.prod(s), gen) for s in leaf_shapes]
    n_total = sum(math.prod(s) for s in leaf_shapes)
    rows = {}
    for case in kernel_cases(fo):
        def run(update):
            return lambda: [case["call"](update, *leaf) for leaf in leaves]
        k_ms = cuda_time_ms(run(case["kernel"]), 20)
        p_ms = cuda_time_ms(run(case["plain"]), 5)
        nbytes = n_total * case["bpe"]
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        params = [torch.nn.Parameter(leaf[0]) for leaf in leaves]
        for p, leaf in zip(params, leaves):
            p.grad = leaf[1]
        if case["sgd"] is not None:
            mu, nesterov = case["sgd"]
            opt = torch.optim.SGD(params, lr=1e-3, momentum=mu, weight_decay=1e-4,
                                  nesterov=nesterov, fused=True)
            lib_ms = cuda_time_ms(opt.step, 20)
            lib_note = "torch.optim.SGD(fused=True)"
        else:
            # eps sits after the bias correction there: not the same function
            opt = torch.optim.Adam(params, lr=1e-3, weight_decay=1e-4, fused=True)
            lib_ms = None
            lib_note = ("(torch.optim.Adam(fused=True), an approximate yardstick: "
                        f"{cuda_time_ms(opt.step, 20):.4f} ms)")
        rows[case["label"]] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                                   library_ms=lib_ms)
        log(f"  time  {case['label']:36s} kernel_ms {k_ms:.4f}  bound_ms {bound_ms:.4f} "
            f"({case['bpe']} B/elem x {n_total} elem at 3.35 TB/s; "
            f"{nbytes / copy_gbps / 1e6:.4f} ms at the measured copy rate)  "
            f"ref_ms {p_ms:.4f}  library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} {lib_note}  "
            f"kernel rate {nbytes / k_ms / 1e6:.1f} GB/s")
    return rows


def launch_diagnostics(fo, leaf_shapes):
    """Separate kernel efficiency from per-launch cost: each kernel on the
    largest leaf alone, and the host time of one wrapper call on a leaf
    small enough that the device is never the limit."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    big = operands(max(math.prod(s) for s in leaf_shapes), gen)
    tiny = operands(64, gen)
    for case in kernel_cases(fo):
        ms = cuda_time_ms(lambda: case["call"](case["kernel"], *big), 20)
        nbytes = big[0].numel() * case["bpe"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            case["call"](case["kernel"], *tiny)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        log(f"  leaf  {case['label']:36s} fc1 kernel alone {ms:.4f} ms "
            f"(bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s); "
            f"host {host_us:.1f} us per wrapper call")


def profile_steps(ft, build_alexnet, step_ms, steps=3):
    """Device time by kernel family over a few steady SGD steps of the main
    path, and its share of the unprofiled step time ``step_ms``."""
    model = main_model(ft, build_alexnet, sgd_optimizer(ft))
    for _ in range(2):
        model.train_iteration()
    model.sync()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.train_iteration()
        model.sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: the aten ops above them carry the same time
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"[profile] {steps} SGD steps: device kernels {busy / steps / 1e3:.3f} ms/step, "
        f"{100 * busy / steps / 1e3 / step_ms:.1f}% of the unprofiled {step_ms:.3f} ms step "
        f"(wall under the profiler {wall_us / steps / 1e3:.3f} ms/step)")
    groups = {}
    for key, us, _ in rows:
        groups[kernel_group(key)] = groups.get(kernel_group(key), 0.0) + us
    for group, us in sorted(groups.items(), key=lambda g: -g[1]):
        log(f"[profile]   {us / steps / 1e3:8.4f} ms/step  {group}")
    for key, us, count in rows[:12]:
        log(f"[profile]   {us / steps / 1e3:8.4f} ms/step {count // steps:4d}x/step  {key[:100]}")


def kernel_group(name):
    """Coarse kernel families for the step breakdown (cuDNN's convolution
    kernels are implicit GEMMs, so they are matched before GEMM)."""
    low = name.lower()
    if "sgd_kernel" in low or "adam_kernel" in low:
        return "optimizer (this repo's CUDA kernels)"
    if any(k in low for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad", "padding")):
        return "convolution (cuDNN)"
    if "gemm" in low or "nvjet" in low:
        return "GEMM (cuBLAS)"
    if "pool" in low:
        return "pooling"
    return "elementwise, reductions, casts and copies"


def copy_bandwidth_gbps():
    src = torch.empty(256 * 2**20, device="cuda")  # 1 GiB
    dst = torch.empty_like(src)
    ms = cuda_time_ms(lambda: dst.copy_(src), 10)
    return 2 * src.numel() * 4 / ms / 1e6


# ------------------------------------------------------------------ phase 4

def sgd_optimizer(ft):
    return lambda m: ft.SGDOptimizer(m, lr=0.001, momentum=0.9)


def adam_optimizer(ft):
    return lambda m: ft.AdamOptimizer(m, alpha=ADAM_ALPHA)


def main_model(ft, build_alexnet, make_opt, batch=BATCH, **cfg):
    """AlexNet 3x229x229 through the user-facing entry points, with its
    synthetic batch staged (bf16 and the fused optimizer unless ``cfg``
    says otherwise)."""
    cfg = {"compute_dtype": "bfloat16", "fused_optimizer": True, **cfg}
    model = ft.FFModel(ft.FFConfig(batch_size=batch, **cfg))
    inp, _ = build_alexnet(model, batch)
    model.compile(make_opt(model), ft.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                  [ft.MetricsType.ACCURACY])
    model.init_layers(seed=0)
    ft.DataLoader.synthetic(model, inp, num_samples=batch).next_batch(model)
    return model


def train_main_path(ft, build_alexnet, fo, make_opt, steps, timed_from):
    """Take ``steps`` steps of full-width AlexNet, checking 16 launches of
    the optimizer's kernel per step and a finite loss on every step."""
    from flexflow_tpu_torch.model import METRIC_KEYS

    model = main_model(ft, build_alexnet, make_opt)
    opt = model.optimizer
    n_leaves = sum(len(op.weights) for op in model.ops)
    check(n_leaves == 16, f"AlexNet has {n_leaves} leaves, expected 16")
    n_params = sum(w.numel() for ws in model._params.values() for w in ws.values())
    check(n_params == 57_044_810, f"AlexNet has {n_params} parameters")
    kern = fo.fused_sgd_update if isinstance(opt, ft.SGDOptimizer) else fo.fused_adam_update
    loss_sums, t0 = [], None
    for step in range(steps):
        if step == timed_from:
            model.sync()
            t0 = time.perf_counter()
        before = kern.launches
        model.train_iteration()
        check(kern.launches - before == n_leaves,
              f"step {step}: {kern.launches - before} launches of {kern.__name__}")
        # cumulative loss sum on the device: no host transfer inside the loop
        loss_sums.append(model._metric_acc[METRIC_KEYS.index("loss")].clone())
    model.sync()
    seconds = time.perf_counter() - t0
    sums = torch.stack(loss_sums).tolist()
    losses = [b - a for a, b in zip([0.0] + sums[:-1], sums)]
    check(all(math.isfinite(x) for x in sums), f"non-finite loss: {losses}")
    probs = model.predict_batch()
    check(probs.shape == (BATCH, 10), f"predict_batch shape {probs.shape}")
    check(bool((abs(probs.sum(-1) - 1) < 2e-2).all()), "softmax rows do not sum to 1")
    timed = steps - timed_from
    return dict(losses=losses, ms_per_step=seconds / timed * 1e3,
                samples_per_s=timed * BATCH / seconds,
                metrics=model.get_metrics().to_string())


# ------------------------------------------------------------------ phase 5

def parity(ft, build_alexnet, make_opt):
    def run(fused):
        model = main_model(ft, build_alexnet, make_opt, batch=8,
                           compute_dtype="float32", fused_optimizer=fused)
        for _ in range(2):
            model.train_iteration()
        model.sync()
        return {(op.name, w.name): model._params[op.name][w.name].detach().clone()
                for op in model.ops for w in op.weights}

    fused, plain = run(True), run(False)
    worst = 0.0
    for key in fused:
        torch.testing.assert_close(fused[key], plain[key], **PARITY_TOL)
        worst = max(worst, (fused[key] - plain[key]).abs().max().item())
    return worst


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import fused_optimizer as fo
    from flexflow_tpu_torch.models.alexnet import build_alexnet

    t_start = time.perf_counter()
    # phase 1 ------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {name} capability {cap} count "
        f"{torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {smi}")
    check(cap == (9, 0), f"expected a Hopper card (capability (9, 0)), got {cap}")

    # phase 2 ------------------------------------------------------------
    info = fo.build(force=True)
    log(f"[build] nvcc {SOURCE} -> {info['path']} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")
    fo._lib()

    # phase 3 ------------------------------------------------------------
    graph = ft.FFModel(ft.FFConfig(batch_size=BATCH, device="cpu"))
    build_alexnet(graph, BATCH)
    leaf_shapes = [w.dims for op in graph.ops for w in op.weights]
    log("[kernels] kernel vs plain PyTorch version, tolerance rtol=atol=1e-6 "
        "(both run the same rounded f32 operations; built with -fmad=false)")
    max_err = check_kernels(fo)
    copy_gbps = copy_bandwidth_gbps()
    log(f"[kernels] measured device copy rate {copy_gbps:.1f} GB/s (1 GiB copy_)")
    rows = time_kernels(fo, leaf_shapes, copy_gbps)
    launch_diagnostics(fo, leaf_shapes)

    # phase 4 ------------------------------------------------------------
    fo.fused_sgd_update.launches = 0
    fo.fused_adam_update.launches = 0
    torch.cuda.reset_peak_memory_stats()
    sgd_run = train_main_path(ft, build_alexnet, fo, sgd_optimizer(ft), steps=7, timed_from=2)
    torch.cuda.empty_cache()
    adam_run = train_main_path(ft, build_alexnet, fo, adam_optimizer(ft), steps=3, timed_from=1)
    launches = {"fused_sgd_update": fo.fused_sgd_update.launches,
                "fused_adam_update": fo.fused_adam_update.launches}
    check(launches == {"fused_sgd_update": 16 * 7, "fused_adam_update": 16 * 3},
          f"launch counts {launches}")
    peak = torch.cuda.max_memory_allocated()
    for label, r in (("SGD momentum 0.9", sgd_run), ("Adam", adam_run)):
        log(f"[main] AlexNet 3x229x229 batch {BATCH} bf16 fused, {label}: "
            f"losses {['%.4f' % x for x in r['losses']]}  "
            f"{r['samples_per_s']:.1f} samples/s  {r['ms_per_step']:.2f} ms/step  "
            f"{r['metrics']}")
    log(f"[main] max_memory_allocated {peak / 2**30:.2f} GiB; launches {launches}; "
        f"card {smi}")

    profile_steps(ft, build_alexnet, sgd_run["ms_per_step"])
    torch.cuda.empty_cache()

    # phase 5 ------------------------------------------------------------
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for label, make_opt in (("SGD", sgd_optimizer(ft)), ("Adam", adam_optimizer(ft))):
        worst = parity(ft, build_alexnet, make_opt)
        log(f"[parity] f32 AlexNet batch 8, 2 {label} steps, fused kernels vs plain "
            f"update: max |dw| {worst:.3e} (tolerance rtol 1e-6, atol 1e-7; cuDNN "
            "deterministic, TF32 off)")

    # result -------------------------------------------------------------
    kernels = []
    for kname, label, replaces in (
            ("fused_sgd_update", "fused_sgd_update mu=0.9",
             "flexflow_tpu/kernels/fused_optimizer.py:63"),
            ("fused_adam_update", "fused_adam_update",
             "flexflow_tpu/kernels/fused_optimizer.py:110")):
        r = rows[label]
        kernels.append({"name": kname, "route": "cuda", "source": SOURCE,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": max_err[kname], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": "bytes", "library_ms": r["library_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
