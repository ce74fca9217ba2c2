#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on from):
  1. environment: versions, the card, its power limit;
  2. build the CUDA kernels from flexflow_tpu_torch/kernels/csrc with nvcc,
     one nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card: the
     optimizer updates at AlexNet's largest leaf, a ragged size and a
     misaligned view, and the multi-tensor SGD step over a ragged list of
     leaves aligned differently and over 130 leaves (three launches); then
     timed per step: SGD as one launch over AlexNet's 16 leaves and over
     the transformer's 54, Adam one launch per AlexNet leaf; the
     flash-attention forward, dK/dV and dQ kernels causal and not, bf16
     and f32, at the transformer's shape (16, 8, 512, 64), ragged S (1, 65,
     300, 1000), Sq != Sk and head dims 16, 32 and 128, with a non-zero lse
     cotangent (f32 once; bf16 causal at S 300, at Sq != Sk both ways and
     at head dims 16, 32 and 128), then timed at the transformer's shape
     (and at head dim 16); each beside its bound, the plain version and the
     library call; the optimizer kernels read lr/alpha_t from a scalar
     vector on the card, and a set skip flag leaves their operands bitwise;
  4. the main paths: full-width AlexNet (3x229x229, batch 256, bf16, fused
     optimizer) trained with SGD then Adam, and the full-width decoder
     transformer (batch 16, S 512, 4 layers, E 512, 8 heads, vocab 32000,
     bf16, fused SGD) trained through FFModel's compiled step (one CUDA
     graph: the first step eager, the second captured, then replays), the
     wrappers' launches checked at the eager step and the capture, and a
     device-time breakdown of each with the launches per step that the
     profiler's kernel events show (one SGD launch per step);
  5. path parity: f32 AlexNet at batch 8, two steps with the fused kernels
     and two with the plain update; an f32 transformer (batch 2, S 128, 2
     layers), two steps through the flash kernels and two through their
     plain versions; every weight compared;
  6. SOAP: an NCCL process group of one rank per visible card (this
     script started again as each helper rank; world size 1 on a machine
     of one card), and on its mesh (DTensor parameters, ops on local
     shards) full-width AlexNet under strategies/alexnet_16.pb legalized
     onto the mesh (SGD momentum 0.9, then Adam) and the full-width
     transformer under data parallelism, each
     2 warm-up and 5 timed steps beside the single-device path in the same
     run, with the kernels' launches checked per step (1 K1; 16 K2 with
     Adam; 4 each of K3-K5), the device busy share of both paths, and the
     weights after 2 f32 steps held against the single-device path's
     (the single-device runs on the lead rank's card), both paths eager;
  7. the compiled step: for full-width AlexNet (SGD, Adam) and the
     transformer, the compiled and the eager step in turns (ms/step,
     device ms/step, busy share, launches per step from the profiler);
     remat against plain (weights, max_memory_allocated); f32 state after
     3 steps compiled vs eager (Adam with next_epoch() between replays);
     grad_accum_steps 4 vs 1; a batch with an inf through the guard on a
     replay (w, m, v bitwise unchanged); save after 2 steps, load into a
     fresh model and 2 more steps against 4 uninterrupted;
  8. the strategy search: (a) the calibration tool times every op of both
     cells, forward and backward, at their data-parallel sub-shapes of 1,
     2, 4 and 8 parts on the card (the attention measurements launch K3-K5,
     checked by count) and fits the roofline; (b) each cell's
     data-parallel step on one card simulated from that table and from the
     fit alone, beside phase 7's compiled step and phase 6's eager SOAP
     step, and the predicted memory beside phase 4's peak; (c) full-width
     AlexNet through compile(search_budget=...) with the mcmc and the
     population engine on the default machine (one card, no process group,
     so that its steps are the compiled ones), 3 compiled steps, the
     exported strategy loaded back; (d) the offline search of both cells for an
     8-GPU node, every config composable over the port's 8-device mesh and
     no attention sequence split.  ``--calibration-out DIR`` keeps the
     measured cache and the fit (measured_h100.json, machine_h100.json);
  9. the rest of the zoo at full width through the compiled step
     ([models] lines): ResNet-50 (batch 64, 229x229), Inception-v3 (batch
     128, 299x299), DLRM (batch 256, 8 tables of 1,000,000 x 64 on the
     card), CANDLE-Uno (batch 256), NMT (batch 64, seq 20, hidden 2048,
     vocab 20480, Adam) and the MoE transformer (phase 4's transformer
     with 8 experts every 2nd layer), bf16: the wrappers' launches at the
     eager step and the capture, compiled and eager ms/step in turns,
     profiled device ms, busy share and launches per step, the optimizer
     kernel's time against its byte bound, max_memory_allocated, the rate;
     f32 weights after 2 steps compiled vs eager and kernels vs plain
     versions (the MoE transformer at 2 layers); then [search] lines:
     each model's DP-1 step simulated from its own ops measured on the
     card against the compiled step, and an 8-GPU offline search whose
     configs the training path must accept;
 10. decoding and serving ([decode] and [serve] lines), bf16 unless
     said: (a) the transformer's greedy generate (B16, P 256, N 256)
     through its captured decode graph against the eager steps (equal),
     ms a step, tokens/s, capture ms, profiled device ms and launches a
     step; (b) beam_search (K4, B4, P 64, N 64) and sampled generate
     (B16, P 64, N 64, T 0.8, top-k 50, top-p 0.9, a fixed seed) graphed
     against eager, every
     sampled token within its step's top-k; (c) the MoE transformer (B16, P
     128, N 128) and NMT greedy_translate (B64, 20 tokens) graphed against
     eager; (d) the InferenceEngine dense then paged (max_batch 16, max_seq
     512, block 16), warmed up, serving 64 random requests and 8 sharing a
     128-token prefix, all submitted at once: generated tokens/s, TTFT and
     TPOT p50/p99, prefix hits, graphs captured (none after the warm-up),
     the KV pool's bytes, peak memory; dense == paged for every request;
     (e) the ServingAPI on an ephemeral port before an engine that captures
     in its worker thread (8 POST /generate equal the engine's tokens,
     /healthz and /readyz 200); no kernel launches on these
     paths; then the f32 oracle: one full-sequence forward (K3) over (a)'s
     prompt and f32-generated tokens, whose argmax must be each decoded
     token or within F32_GAP_TOL of it; every token of (a)'s bf16 generate
     and of each engine request against the f32 model's full forward over
     the same tokens, within BF16_GAP_TOL at every generated position; and
     each engine request against generate, a differing one within
     BF16_GAP_TOL at its first difference;
 11. observability ([obs] lines): phase 4's transformer, 20 compiled steps
     untraced, then with FF_TELEMETRY=1 FF_HEALTH=1 FF_MEMPLANE=1
     FF_OPPROF=10 and FF_METRICS_PORT (a temporary trace and opprof corpus):
     (a) losses and every weight bitwise equal, ms/step by CUDA events on
     and off (not gated); (b) the median step span and samples/s within
     10% of that ms/step, MFU in (0, 1), hbm_bytes in (0, 80e9]; (c) one
     capture at train_step in the ledger, no retrace; (d) opprof measured
     every attention op, K3-K5 each launched 7 times more per op than
     untraced; (e) GET /metrics 200 with ff_ lines; (f) trace_report folds
     one step span per step; (g) full-width AlexNet under
     FF_SKIP_NONFINITE, a NaN batch replayed: one health nonfinite_loss and
     one step_skipped event, every weight bitwise unchanged; (h) phase
     10's engine, 16 requests untraced then traced (FF_TRACE_SAMPLE=1,
     FF_MEMPLANE=1): equal tokens, a trace id and one serve_request_done
     per request, no capture after warmup(), the API's /metrics 200.
The last lines are the card's name and power limit, one JSON object with
a row per kernel, and {"ok": true, "device": {...}}.  Needs one card
(phase 6 uses every visible card); it imports nothing of jax or of the
JAX package.
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

BATCH = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12   # H100 SXM data sheet, dense tensor cores
KERNEL_TOL = dict(rtol=1e-6, atol=1e-6)
PARITY_TOL = dict(rtol=1e-6, atol=1e-7)
# Adam's first step is uncorrected (alpha_t = alpha, as in the reference):
# every weight moves by about 3*alpha, and at alpha 1e-3 the loss leaps
# into the thousands before it recovers.  1e-4 keeps the run near its
# starting loss, so a finite loss on every step means something.
ADAM_ALPHA = 1e-4
SOURCE = "flexflow_tpu_torch/kernels/csrc/fused_optimizer.cu"
FLASH_SOURCE = "flexflow_tpu_torch/kernels/csrc/flash_attention.cu"
# the transformer of bench.py's transformer workload, at full width
LM = dict(batch=16, seq_length=512, num_layers=4, embed_dim=512, num_heads=8,
          vocab_size=32000)
LM_STEPS, LM_TIMED_FROM = 7, 2
# launches of each of this repo's kernels in one step of each main path
NO_LAUNCH = dict.fromkeys(("fused_sgd_update", "fused_adam_update", "flash_fwd",
                           "flash_bwd_dkdv", "flash_bwd_dq"), 0)
ALEX_SGD_STEP = {**NO_LAUNCH, "fused_sgd_update": 1}
ALEX_ADAM_STEP = {**NO_LAUNCH, "fused_adam_update": 16}
LM_SGD_STEP = {**NO_LAUNCH, "fused_sgd_update": 1, "flash_fwd": LM["num_layers"],
               "flash_bwd_dkdv": LM["num_layers"], "flash_bwd_dq": LM["num_layers"]}
# Flash kernels vs their plain versions on the same inputs.  f32: both sum
# the same f32 products in another order (FMA chains in the kernel, cuBLAS
# tiles with TF32 off in the plain version), about 1e-6 relative on sums
# of up to 512 terms.  bf16: both compute in f32 from the same bf16 inputs
# (the kernels' f32 P and dS enter the tensor cores as bf16 hi + lo pairs,
# about 2**-16 relative) and round the result to bf16 once, so they differ
# by at most one bf16 step (2**-8 relative) where the f32 values straddle
# a rounding boundary; lse stays f32 and keeps the f32 tolerance.
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}
# f32 transformer, kernel path vs plain path after 2 SGD steps: the
# gradients differ only by the attention kernels' summation order.
LM_PARITY_TOL = dict(rtol=1e-4, atol=1e-5)
# SOAP path vs single-device path after 2 f32 steps, one rank: the same
# kernels on the same tensors (DTensor adds only wrapping), so the same
# rounded operations, held at the fused-update parity tolerance.
SOAP_TOL = PARITY_TOL
# Over several cards the gradients' sums over ranks are taken in another
# order than one card's: the transformer parity tolerance of phase 5.
SOAP_MULTI_TOL = LM_PARITY_TOL
# Adam moves each weight by about alpha * 0.1 / sqrt(0.001) = 3.16 alpha
# a step whatever its gradient's size, so a gradient element near zero
# whose sign the other summation order flips can move the other way.  Four
# H100s read max |dw| 3.04e-5 = 0.3 alpha after 2 steps; atol 2 alpha sits
# under the 3.16 alpha by which one skipped update moves a weight.
SOAP_MULTI_ADAM_TOL = dict(rtol=1e-4, atol=2 * ADAM_ALPHA)
SOAP_HELPER = "FF_CHIP_SMOKE_SOAP_HELPER"  # set in the helper ranks' environment
# A rank that waits this long in the rendezvous or a collective fails the
# run instead of holding it (the lead rank's single-device runs, which the
# helpers wait through, take seconds).
SOAP_TIMEOUT = datetime.timedelta(seconds=300)
ALEXNET_STRATEGY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "strategies",
                                "alexnet_16.pb")


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


_sleep_cycles_per_ms = None


def hold_stream(ms):
    """Keep the current stream busy for about ``ms`` milliseconds (a
    spinning kernel), so that what the host queues behind it runs back to
    back."""
    global _sleep_cycles_per_ms
    if _sleep_cycles_per_ms is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10**7)
        end.record()
        end.synchronize()
        _sleep_cycles_per_ms = 10**7 / start.elapsed_time(end)
    torch.cuda._sleep(int(_sleep_cycles_per_ms * ms))


def cuda_time_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    one warm-up.  A sleeping kernel holds the stream while the host queues
    the calls, so a call whose host side is slower than its device side (a
    wrapper over many leaves, a plain version of many small operations) is
    timed on the device, not paced by the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    hold_stream(2 * host_ms * iters + 1)
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

def kernel_cases(fo, skip=False):
    """One dict per case: label, bytes moved per element, the SGD settings
    (None for Adam), a caller taking (update, w, g, m, v) with the kernel
    wrapper and plain version it is run with, and ``step(plain, leaves)``,
    one optimizer step over a list of (w, g, m, v) as the optimizer takes
    it: SGD one multi-tensor call, Adam one call per leaf.  lr and alpha_t
    come from a scalar vector on the card, as the optimizers pass them;
    with ``skip`` its skip flag is set."""
    scalars = fo.scalar_vector(1e-3, "cuda", skip=skip)

    def sgd(mu, nesterov):
        def call(update, w, g, m, v):
            update(w, g, m if mu > 0 else None, scalars, 1e-4, mu, nesterov)

        def step(plain, leaves):
            update = fo.fused_sgd_update_multi_ref if plain else fo.fused_sgd_update_multi
            ws, gs, ms, _ = (list(x) for x in zip(*leaves))
            update(ws, gs, ms if mu > 0 else None, scalars, 1e-4, mu, nesterov)
        return call, step

    def adam(update, w, g, m, v):
        update(w, g, m, v, scalars, 1e-4, 0.9, 0.999, 1e-8)

    def adam_step(plain, leaves):
        for leaf in leaves:
            adam(fo.fused_adam_update_ref if plain else fo.fused_adam_update, *leaf)

    cases = []
    for mu, nest in ((0.9, False), (0.9, True), (0.0, False)):
        call, step = sgd(mu, nest)
        cases.append(dict(label=f"fused_sgd_update mu={mu}{' nesterov' if nest else ''}",
                          bpe=20 if mu else 12, sgd=(mu, nest), call=call, step=step,
                          kernel=fo.fused_sgd_update, plain=fo.fused_sgd_update_ref))
    cases.append(dict(label="fused_adam_update", bpe=28, sgd=None, call=adam, step=adam_step,
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
    # a skipped step (the guard's flag in the scalar vector): the kernel and
    # the plain version leave every operand bitwise as it was
    n = 9216 * 4096
    for case in kernel_cases(fo, skip=True):
        ops = operands(n, gen)
        for update in (case["kernel"], case["plain"]):
            got = [t.clone() for t in ops]
            case["call"](update, *got)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, ops)),
                  f"{case['label']}: a skipped step changed its operands")
        log(f"  check {case['label']:36s} skip flag set: w, m, v bitwise unchanged "
            f"(kernel and plain version)")
    return max_err


def main_path_leaves(ft, build_alexnet, build_transformer):
    """The parameter leaf shapes of both main paths' models, from their
    graphs built on the CPU (no parameter is allocated)."""
    alex = ft.FFModel(ft.FFConfig(batch_size=BATCH, device="cpu"))
    build_alexnet(alex, BATCH)
    lm = ft.FFModel(ft.FFConfig(batch_size=LM["batch"], device="cpu"))
    build_transformer(lm, LM["batch"], **{k: v for k, v in LM.items() if k != "batch"})
    return {name: [w.dims for op in g.ops for w in op.weights]
            for name, g in (("AlexNet", alex), ("transformer", lm))}


def check_sgd_multi(fo):
    """The multi-tensor SGD step against its plain version on the card: one
    launch over ragged leaves whose pointers are aligned differently (views
    at an odd offset beside aligned leaves, a zero-size leaf), and 130
    leaves, which take three launches."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    ragged = [(1, 0), (7, 0), (165, 1), (0, 0), (108, 0), (1_000_003, 1), (65_536, 0),
              (16_385, 1), (9216 * 4096, 0)]
    many = [(1 + 977 * i, i % 2) for i in range(130)]
    worst = 0.0
    for lname, sizes in (("ragged, mixed alignment", ragged), ("130 leaves", many)):
        want = -(-sum(1 for n, _ in sizes if n) // fo.SGD_TABLE_CAPACITY)
        for case in kernel_cases(fo)[:3]:
            ops = [operands(n, gen) for n, _ in sizes]
            ka = [tuple(copy_at(t, off) for t in leaf) for leaf, (_, off) in zip(ops, sizes)]
            pa = [tuple(t.clone() for t in leaf) for leaf in ops]
            before = fo.fused_sgd_update.launches
            case["step"](False, ka)
            launches = fo.fused_sgd_update.launches - before
            case["step"](True, pa)
            torch.cuda.synchronize()
            check(launches == want, f"{lname}: {launches} launches, expected {want}")
            err = 0.0
            for kl, pl in zip(ka, pa):
                for a, b in zip(kl, pl):
                    torch.testing.assert_close(a, b, **KERNEL_TOL)
                    if a.numel():
                        err = max(err, (a - b).abs().max().item())
            worst = max(worst, err)
            log(f"  check {case['label']:36s} multi, {lname:24s} {len(sizes)} leaves, "
                f"{launches} launch(es)  max_abs_err {err:.3e}")
    return worst


def time_kernels(fo, leaf_sets, copy_gbps):
    """Per-step times over a main path's leaves, as the optimizer runs
    them: SGD one multi-tensor launch over all leaves (AlexNet's 16 in
    every setting, the transformer's 54 without momentum, as its main path
    trains), Adam one launch per AlexNet leaf."""
    rows = {}
    for set_name, leaf_shapes in leaf_sets.items():
        gen = torch.Generator(device="cuda").manual_seed(1)
        leaves = [operands(math.prod(s), gen) for s in leaf_shapes]
        for case in kernel_cases(fo):
            if set_name == "AlexNet" or case["sgd"] == (0.0, False):
                label = case["label"] + ("" if set_name == "AlexNet" else f" {set_name}")
                rows[label] = time_case(case, label, leaves, copy_gbps)
        del leaves
        torch.cuda.empty_cache()
    return rows


def time_case(case, label, leaves, copy_gbps):
    """One optimizer step of ``case`` over ``leaves``: kernel, plain version
    and library times beside the byte bound."""
    n_total = sum(leaf[0].numel() for leaf in leaves)
    k_ms = cuda_time_ms(lambda: case["step"](False, leaves), 20)
    p_ms = cuda_time_ms(lambda: case["step"](True, leaves), 5)
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
    log(f"  time  {label:48s} {len(leaves)} leaves  kernel_ms {k_ms:.4f}  "
        f"bound_ms {bound_ms:.4f} ({case['bpe']} B/elem x {n_total} elem at 3.35 TB/s; "
        f"{nbytes / copy_gbps / 1e6:.4f} ms at the measured copy rate)  "
        f"ref_ms {p_ms:.4f}  library_ms "
        f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} {lib_note}  "
        f"kernel rate {nbytes / k_ms / 1e6:.1f} GB/s")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, library_ms=lib_ms)


def host_us(fn, iters=200):
    """Host microseconds per call of ``fn`` (work the device is never the
    limit of)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def launch_diagnostics(fo, leaf_counts, biggest):
    """Separate kernel efficiency from per-launch cost: each kernel on the
    largest leaf alone; the host time of one wrapper call on a leaf small
    enough that the device is never the limit; and for SGD the host time
    of a whole optimizer step (one multi-tensor call) over as many such
    leaves as each main path has."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    big = operands(biggest, gen)
    tiny = [operands(64, gen) for _ in range(max(leaf_counts.values()))]
    for case in kernel_cases(fo):
        ms = cuda_time_ms(lambda: case["call"](case["kernel"], *big), 20)
        nbytes = big[0].numel() * case["bpe"]
        per_call = host_us(lambda: case["call"](case["kernel"], *tiny[0]))
        steps = "; ".join(
            f"host {host_us(lambda: case['step'](False, tiny[:n])):.1f} us per {name} step "
            f"({n} leaves, {'one launch' if case['sgd'] else f'{n} launches'})"
            for name, n in leaf_counts.items() if case["sgd"] or name == "AlexNet")
        log(f"  leaf  {case['label']:36s} fc1 kernel alone {ms:.4f} ms "
            f"(bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s); "
            f"host {per_call:.1f} us per wrapper call on one leaf; {steps}")


# This repo's kernels by a piece of their compiled names (the profiler's
# kernel events), and the wrapper that launches each.
KERNEL_NAMES = (("sgd_kernel", "fused_sgd_update"), ("adam_kernel", "fused_adam_update"),
                ("flash_fwd", "flash_fwd"), ("flash_bwd_dkdv", "flash_bwd_dkdv"),
                ("flash_bwd_dq", "flash_bwd_dq"))


def kernel_of(event_name):
    return next((k for sub, k in KERNEL_NAMES if sub in event_name), None)


def profile_steps(model, label, step_ms, steps=3, per_step=None, kernel_ms=None):
    """Device time by kernel family over a few steady steps of a main path's
    model, and its share of the unprofiled step time ``step_ms``; returns
    (device ms per step, busy share in %).  With ``per_step`` (launches of
    each of this repo's kernels a step), the launches the profiler saw
    must equal it: on the graph path the wrappers' counters tick only at
    the eager first step and at the capture, so the kernels' own events
    are what count a replay's launches.  ``kernel_ms``, a dict, receives
    each of this repo's kernels' device ms per step."""
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
    if kernel_ms is not None:
        for key, us, _ in rows:
            if kernel_of(key) is not None:
                kernel_ms[kernel_of(key)] = kernel_ms.get(kernel_of(key), 0.0) + us / steps / 1e3
    if per_step is not None:
        seen = dict.fromkeys(per_step, 0)
        for key, _, count in rows:
            if kernel_of(key) is not None:
                seen[kernel_of(key)] += count
        got = {k: c / steps for k, c in seen.items()}
        check(got == per_step, f"{label}: launches per step from the profiler {got}, "
                               f"expected {per_step}")
        log(f"[profile] {label}: launches per step from the profiler's kernel events "
            f"{ {k: int(c) for k, c in got.items()} }")
    log(f"[profile] {label}, {steps} steps: device kernels {busy / steps / 1e3:.3f} ms/step, "
        f"{100 * busy / steps / 1e3 / step_ms:.1f}% of the unprofiled {step_ms:.3f} ms step "
        f"(wall under the profiler {wall_us / steps / 1e3:.3f} ms/step)")
    groups = {}
    for key, us, _ in rows:
        groups[kernel_group(key)] = groups.get(kernel_group(key), 0.0) + us
    for group, us in sorted(groups.items(), key=lambda g: -g[1]):
        log(f"[profile]   {us / steps / 1e3:8.4f} ms/step  {group}")
    for key, us, count in rows[:12]:
        log(f"[profile]   {us / steps / 1e3:8.4f} ms/step {count // steps:4d}x/step  {key[:100]}")
    return busy / steps / 1e3, 100 * busy / steps / 1e3 / step_ms


def kernel_group(name):
    """Coarse kernel families for the step breakdown (cuDNN's convolution
    kernels are implicit GEMMs, so they are matched before GEMM)."""
    low = name.lower()
    if "sgd_kernel" in low or "adam_kernel" in low:
        return "optimizer (this repo's CUDA kernels)"
    if "flash_" in low:
        return "attention (this repo's CUDA flash kernels)"
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


def ptxas_summary(log_text):
    """One line per compiled kernel: its name, registers and spill bytes."""
    out, name = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"(flash_(?:fwd|bwd)\w*?_kernel|sgd_kernel|adam_kernel)", mangled)
            tmpl = "bf16" if "bfloat16" in mangled else ("f32" if "flash" in mangled else "")
            dim = re.search(r"Li(\d+)E", mangled)
            name = " ".join(x for x in ((base.group(1) if base else mangled), tmpl,
                                        (f"D={dim.group(1)}" if dim and tmpl else "")) if x)
            if "sgd_kernel" in mangled:
                name += " " + "".join(re.findall(r"Lb([01])E", mangled))
        elif name and "spill" in line:
            out.append([name, line.strip()])
        elif name and "registers" in line and out and out[-1][0] == name:
            out[-1].append(re.search(r"Used \d+ registers", line).group(0))
    return [" | ".join(x) for x in out] or [
        line.strip() for line in log_text.splitlines() if "registers" in line or "spill" in line]


def build_kernels(fo, fa):
    """Both sources, one nvcc each, started together."""
    with ThreadPoolExecutor(2) as pool:
        jobs = {src: pool.submit(mod.build, force=True)
                for src, mod in ((SOURCE, fo), (FLASH_SOURCE, fa))}
        infos = {src: job.result() for src, job in jobs.items()}
    for src, info in infos.items():
        log(f"[build] nvcc {src} -> {info['path']} in {info['seconds']:.2f} s")
        for line in ptxas_summary(info["log"]):
            log(f"[build]   {line}")
    fo._lib()
    fa._lib()


# ------------------------------------------------------------------ phase 3, attention

def attn_inputs(shape, dtype, gen, sk=None):
    """q, k, v, dO of ``shape`` (B, H, S, D) on the card; k and v with
    ``sk`` rows when given."""
    kv = shape if sk is None else shape[:2] + (sk,) + shape[3:]
    return tuple(torch.randn(s, device="cuda", generator=gen).to(dtype)
                 for s in (shape, kv, kv, shape))


def worst_err(got, ref, tol, what):
    torch.testing.assert_close(got.float(), ref.float(), **tol, msg=lambda m: f"{what}: {m}")
    return (got.float() - ref.float()).abs().max().item()


def check_flash(fa):
    """Each flash kernel against its plain version on the same inputs.  The
    backward kernels get the plain version's lse and delta, so each kernel
    is held alone."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, h, s, d = LM["batch"], LM["num_heads"], LM["seq_length"], \
        LM["embed_dim"] // LM["num_heads"]
    # (q shape, k/v rows (None: as q), dtype, causal, a random lse cotangent)
    cases = [((b, h, s, d), None, torch.bfloat16, True, False),
             ((b, h, s, d), None, torch.bfloat16, False, False),
             ((b, h, s, d), None, torch.float32, True, False),
             ((2, 4, 300, 64), None, torch.bfloat16, True, False),
             ((2, 4, 300, 64), None, torch.float32, False, False),
             ((2, 4, 300, 64), None, torch.float32, True, True),
             ((2, 4, 300, 64), None, torch.bfloat16, True, True),
             ((2, 4, 150, 64), 260, torch.bfloat16, False, False),
             ((2, 4, 200, 64), 330, torch.float32, True, False),
             ((2, 4, 256, 128), None, torch.bfloat16, True, False),
             ((2, 4, 256, 128), None, torch.float32, False, False),
             ((2, 4, 200, 32), None, torch.float32, True, False),
             ((2, 4, 200, 32), None, torch.bfloat16, False, False),
             # the bf16 backward's transposed masks (K4) with Sq != Sk both
             # ways, and its D = 128 and D = 32 layouts, with the lse term
             ((2, 4, 200, 64), 330, torch.bfloat16, True, True),
             ((2, 4, 330, 64), 200, torch.bfloat16, True, True),
             ((2, 4, 256, 128), None, torch.bfloat16, True, True),
             ((2, 4, 200, 32), None, torch.bfloat16, True, True),
             # head dim 16 (the JAX package's transformer_4d and
             # transformer_generate examples): bf16 and f32, causal and
             # not, ragged S, Sq != Sk, with and without the lse term
             ((2, 4, 300, 16), None, torch.bfloat16, True, True),
             ((2, 4, 300, 16), None, torch.bfloat16, False, False),
             ((2, 4, 300, 16), None, torch.float32, True, True),
             ((2, 4, 300, 16), None, torch.float32, False, False),
             ((2, 4, 200, 16), 330, torch.bfloat16, True, True),
             ((2, 4, 330, 16), 200, torch.float32, False, True),
             ((2, 4, 65, 16), None, torch.bfloat16, True, False),
             ((16, 8, 512, 16), None, torch.bfloat16, True, True)]
    # the bf16 forward's edges: one row, one key tile and a row, more key
    # tiles than its double buffer
    cases += [((2, 4, s_, 64), None, torch.bfloat16, causal, False)
              for s_ in (1, 65, 1000) for causal in (True, False)]
    max_err = {"flash_fwd": 0.0, "flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0}
    for shape, sk, dtype, causal, with_glse in cases:
        q, k, v, do = attn_inputs(shape, dtype, gen, sk)
        scale = 1.0 / math.sqrt(shape[-1])
        tol, f32 = FLASH_TOL[dtype], FLASH_TOL[torch.float32]
        label = (f"{str(dtype)[6:]:8s} {str(shape):18s} Sk={k.shape[2]:<4d} "
                 f"causal={int(causal)} g_lse={'randn' if with_glse else 'None '}")
        o, lse = fa.flash_fwd(q, k, v, scale, causal)
        o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, scale, causal)
        torch.cuda.synchronize()
        errs = [worst_err(o, o_ref, tol, f"O {label}"),
                worst_err(lse, lse_ref, f32, f"lse {label}")]
        delta = (o_ref.float() * do.float()).sum(-1)
        g_lse = (torch.randn(shape[:3], device="cuda", generator=gen) if with_glse
                 else None)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, g_lse, scale, causal)
        dk_ref, dv_ref = fa.flash_bwd_dkdv_ref(q, k, v, do, lse_ref, delta, g_lse, scale,
                                               causal)
        dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, g_lse, scale, causal)
        dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta, g_lse, scale, causal)
        torch.cuda.synchronize()
        errs += [worst_err(dk, dk_ref, tol, f"dK {label}"),
                 worst_err(dv, dv_ref, tol, f"dV {label}"),
                 worst_err(dq, dq_ref, tol, f"dQ {label}")]
        if with_glse:
            # the lse term must matter: without it the kernel's dQ misses the tolerance
            dq0 = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, None, scale, causal)
            check(not torch.allclose(dq0.float(), dq_ref.float(), **tol),
                  f"dQ without g_lse still within tolerance ({label})")
        max_err["flash_fwd"] = max(max_err["flash_fwd"], *errs[:2])
        max_err["flash_bwd_dkdv"] = max(max_err["flash_bwd_dkdv"], *errs[2:4])
        max_err["flash_bwd_dq"] = max(max_err["flash_bwd_dq"], errs[4])
        log(f"  check {label}  max_abs_err O {errs[0]:.3e} lse {errs[1]:.3e} "
            f"dK {errs[2]:.3e} dV {errs[3]:.3e} dQ {errs[4]:.3e}")
    return max_err


def flash_bounds(shape, causal):
    """(ms bound, 'bytes' or 'operations', flops, bytes) of each kernel at a
    bf16 ``shape``: matrix-product flops of the (q, k) pairs this mask
    keeps (2 per multiply-add) over the bf16 tensor-core rate, and bytes
    with each input read once and each output written once over 3.35 TB/s."""
    b, h, s, d = shape
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    mat, row = b * h * s * d * 2, b * h * s * 4  # one (B,H,S,D) bf16, one (B,H,S) f32
    # products: fwd QK^T, PV; dK/dV QK^T, dO V^T, P^T dO, dS^T Q; dQ QK^T, dO V^T, dS K
    work = {"flash_fwd": (2 * 2 * d * pairs, 4 * mat + row),
            "flash_bwd_dkdv": (4 * 2 * d * pairs, 6 * mat + 2 * row),
            "flash_bwd_dq": (3 * 2 * d * pairs, 5 * mat + 2 * row)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
                     flops, nbytes)
    return out


def time_flash(fa, head_dim=None):
    """Each kernel, its plain version and SDPA at the transformer's shape
    (bf16, causal; at ``head_dim`` instead of its 64 when given).  SDPA is
    a yardstick only: the port never calls it."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    shape = (LM["batch"], LM["num_heads"], LM["seq_length"],
             head_dim or LM["embed_dim"] // LM["num_heads"])
    q, k, v, do = attn_inputs(shape, torch.bfloat16, gen)
    scale = 1.0 / math.sqrt(shape[-1])
    o, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = (o.float() * do.float()).sum(-1)
    bwd_args = (q, k, v, do, lse, delta, None, scale, True)
    calls = {"flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale, True),
                           lambda: fa.flash_fwd_ref(q, k, v, scale, True)),
             "flash_bwd_dkdv": (lambda: fa.flash_bwd_dkdv(*bwd_args),
                                lambda: fa.flash_bwd_dkdv_ref(*bwd_args)),
             "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd_args),
                              lambda: fa.flash_bwd_dq_ref(*bwd_args))}
    sdpa_fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), 20)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, scale=scale).backward(do)

    sdpa_fwd_bwd = cuda_time_ms(fwd_bwd, 20)
    # SDPA's flash backward (dQ, dK, dV in one call) called directly: one
    # dispatch per launch, so unlike the autograd loop above the device,
    # not the host, sets its time
    out, lse_s, cq, ck, mq, mk, seed, offset = \
        torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True, False,
                                                           scale=scale)[:8]
    sdpa_bwd = cuda_time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, out, lse_s, cq, ck, mq, mk, 0.0, True, seed, offset, scale=scale), 20)
    bounds = flash_bounds(shape, True)
    rows = {}
    for name, (kern, plain) in calls.items():
        k_ms, p_ms = cuda_time_ms(kern, 20), cuda_time_ms(plain, 5)
        bound_ms, bound_by, flops, nbytes = bounds[name]
        lib_ms = sdpa_fwd if name == "flash_fwd" else None
        rows[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib_ms)
        log(f"  time  {name:16s} {shape} bf16 causal  kernel_ms {k_ms:.4f}  "
            f"bound_ms {bound_ms:.4f} (by {bound_by}: {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB)  ref_ms {p_ms:.4f}  kernel rate "
            f"{flops / k_ms / 1e9:.2f} TFLOP/s ({100 * bound_ms / k_ms:.1f}% of the bound)")
    log("  host  " + ", ".join(f"{name} {host_us(kern, 100):.1f} us"
                               for name, (kern, _) in calls.items())
        + " of host time per wrapper call")
    log(f"  time  SDPA (library yardstick, never called by the port) forward "
        f"{sdpa_fwd:.4f} ms, forward+backward through autograd {sdpa_fwd_bwd:.4f} ms, "
        f"flash backward alone (aten, one call) {sdpa_bwd:.4f} ms; this repo's kernels forward "
        f"{rows['flash_fwd']['ms']:.4f} ms, backward (dK/dV + dQ + delta excluded) "
        f"{rows['flash_bwd_dkdv']['ms'] + rows['flash_bwd_dq']['ms']:.4f} ms")
    return rows


# ------------------------------------------------------------------ phase 4

def sgd_optimizer(ft):
    return lambda m: ft.SGDOptimizer(m, lr=0.001, momentum=0.9)


def adam_optimizer(ft):
    return lambda m: ft.AdamOptimizer(m, alpha=ADAM_ALPHA)


def main_model(ft, build_alexnet, make_opt, batch=BATCH, machine=None, **cfg):
    """AlexNet 3x229x229 through the user-facing entry points, with its
    synthetic batch staged (bf16 and the fused optimizer unless ``cfg``
    says otherwise; the default machine unless ``machine`` is given)."""
    cfg = {"compute_dtype": "bfloat16", "fused_optimizer": True, **cfg}
    model = ft.FFModel(ft.FFConfig(batch_size=batch, **cfg))
    inp, _ = build_alexnet(model, batch)
    model.compile(make_opt(model), ft.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                  [ft.MetricsType.ACCURACY], machine=machine)
    model.init_layers(seed=0)
    ft.DataLoader.synthetic(model, inp, num_samples=batch).next_batch(model)
    return model


def check_graph_run(model, steps, label):
    """The run went through the compiled step: the first step eager, the
    second captured and replayed, every later one a replay."""
    g = model._step_graph
    check(g is not None and g.captures == 1 and g.replays == steps - 1,
          f"{label}: {steps} steps gave "
          f"{None if g is None else (g.captures, g.replays)} (captures, replays)")


def train_main_path(ft, build_alexnet, fo, make_opt, steps, timed_from):
    """Take ``steps`` steps of full-width AlexNet through the compiled step,
    checking a finite loss on every step and the optimizer's launches (SGD
    one a step, Adam one per leaf, 16): the wrapper runs at the eager first
    step and at the capture, the replays run the captured launches."""
    from flexflow_tpu_torch.model import METRIC_KEYS

    model = main_model(ft, build_alexnet, make_opt)
    opt = model.optimizer
    n_leaves = sum(len(op.weights) for op in model.ops)
    check(n_leaves == 16, f"AlexNet has {n_leaves} leaves, expected 16")
    n_params = sum(w.numel() for ws in model._params.values() for w in ws.values())
    check(n_params == 57_044_810, f"AlexNet has {n_params} parameters")
    sgd = isinstance(opt, ft.SGDOptimizer)
    kern = fo.fused_sgd_update if sgd else fo.fused_adam_update
    per_step = 1 if sgd else n_leaves
    loss_sums, t0 = [], None
    before = kern.launches
    for step in range(steps):
        if step == timed_from:
            model.sync()
            t0 = time.perf_counter()
        model.train_iteration()
        # cumulative loss sum on the device: no host transfer inside the loop
        loss_sums.append(model._metric_acc[METRIC_KEYS.index("loss")].clone())
    model.sync()
    seconds = time.perf_counter() - t0
    check_graph_run(model, steps, "AlexNet")
    check(kern.launches - before == 2 * per_step,
          f"{kern.launches - before} wrapper launches of {kern.__name__} (eager step and "
          f"capture), expected {2 * per_step}")
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


def kernel_wrappers(fo, fa):
    """Each kernel's wrapper, which counts its launches."""
    return {"fused_sgd_update": fo.fused_sgd_update,
            "fused_adam_update": fo.fused_adam_update,
            "flash_fwd": fa.flash_fwd, "flash_bwd_dkdv": fa.flash_bwd_dkdv,
            "flash_bwd_dq": fa.flash_bwd_dq}


def reset_launches(kernels):
    for fn in kernels.values():
        fn.launches = 0


def read_launches(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def lm_model(ft, build_transformer, synthetic_lm_batch, make_opt, batch, seq_length,
             num_layers, embed_dim, num_heads, vocab_size, machine=None, **cfg):
    """The decoder transformer through the user-facing entry points, with a
    synthetic batch (numpy seed 0) staged."""
    cfg = {"compute_dtype": "bfloat16", "fused_optimizer": True, **cfg}
    model = ft.FFModel(ft.FFConfig(batch_size=batch, **cfg))
    tok, pos, _ = build_transformer(model, batch, seq_length=seq_length,
                                    num_layers=num_layers, embed_dim=embed_dim,
                                    num_heads=num_heads, vocab_size=vocab_size)
    model.compile(make_opt(model), ft.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                  [ft.MetricsType.ACCURACY], machine=machine)
    model.init_layers(seed=0)
    toks, posa, labels = synthetic_lm_batch(batch, seq_length, vocab_size, seed=0)
    model.set_batch({tok: toks, pos: posa}, labels)
    return model


def train_transformer(ft, build_transformer, synthetic_lm_batch, kernels):
    """Full-width transformer steps through the compiled step: exactly one
    launch of each flash kernel per layer and one fused SGD launch over all
    54 leaves at the eager step and at the capture, a finite loss on every
    step, and a loss that falls."""
    from flexflow_tpu_torch.model import METRIC_KEYS

    model = lm_model(ft, build_transformer, synthetic_lm_batch,
                     lambda m: ft.SGDOptimizer(m, lr=0.001), **LM)
    n_leaves = sum(len(op.weights) for op in model.ops)
    n_params = sum(w.numel() for ws in model._params.values() for w in ws.values())
    check(n_leaves == 54 and n_params == 45_664_512,
          f"transformer has {n_params} parameters in {n_leaves} leaves")
    per_step = {"flash_fwd": LM["num_layers"], "flash_bwd_dkdv": LM["num_layers"],
                "flash_bwd_dq": LM["num_layers"], "fused_sgd_update": 1,
                "fused_adam_update": 0}
    loss_sums, t0 = [], None
    before = read_launches(kernels)
    for step in range(LM_STEPS):
        if step == LM_TIMED_FROM:
            model.sync()
            t0 = time.perf_counter()
        model.train_iteration()
        loss_sums.append(model._metric_acc[METRIC_KEYS.index("loss")].clone())
    model.sync()
    seconds = time.perf_counter() - t0
    check_graph_run(model, LM_STEPS, "transformer")
    got = {n: c - before[n] for n, c in read_launches(kernels).items()}
    check(got == {n: 2 * c for n, c in per_step.items()},
          f"wrapper launches {got} (eager step and capture), expected twice {per_step}")
    sums = torch.stack(loss_sums).tolist()
    losses = [b - a for a, b in zip([0.0] + sums[:-1], sums)]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss does not fall: {losses}")
    probs = model.predict_batch()
    shape = (LM["batch"], LM["seq_length"], LM["vocab_size"])
    check(probs.shape == shape, f"predict_batch shape {probs.shape}")
    check(bool((abs(probs.sum(-1) - 1) < 2e-2).all()), "softmax rows do not sum to 1")
    timed = LM_STEPS - LM_TIMED_FROM
    return model, dict(losses=losses, ms_per_step=seconds / timed * 1e3,
                       samples_per_s=timed * LM["batch"] / seconds,
                       tokens_per_s=timed * LM["batch"] * LM["seq_length"] / seconds,
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


def lm_parity(ft, build_transformer, synthetic_lm_batch, fa, kernels):
    """f32 transformer (batch 2, S 128, 2 layers, E 128, 2 heads: head dim
    64), 2 SGD steps through the flash kernels and 2 through their plain
    versions, from the same weights and batch; every weight compared."""
    shape = dict(batch=2, seq_length=128, num_layers=2, embed_dim=128, num_heads=2,
                 vocab_size=512)

    def run(plain):
        model = lm_model(ft, build_transformer, synthetic_lm_batch,
                         lambda m: ft.SGDOptimizer(m, lr=0.01, momentum=0.9),
                         compute_dtype="float32", **shape)
        before = read_launches(kernels)
        with fa.plain_versions() if plain else contextlib.nullcontext():
            for _ in range(2):
                model.train_iteration()
        model.sync()
        flash = {n: c - before[n] for n, c in read_launches(kernels).items()
                 if n.startswith("flash")}
        want = 0 if plain else 2 * shape["num_layers"]
        check(all(c == want for c in flash.values()),
              f"{'plain' if plain else 'kernel'} path flash launches {flash}")
        return {(op.name, w.name): model._params[op.name][w.name].detach().clone()
                for op in model.ops for w in op.weights}

    kern, plain = run(False), run(True)
    worst = 0.0
    for key in kern:
        torch.testing.assert_close(kern[key], plain[key], **LM_PARITY_TOL,
                                   msg=lambda m: f"{key}: {m}")
        worst = max(worst, (kern[key] - plain[key]).abs().max().item())
    return worst


# ------------------------------------------------------------------ phase 6

def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def timed_steps(model, kernels, per_step, steps=7, timed_from=2):
    """``steps`` training steps, the first ``timed_from`` a warm-up, each
    checked to launch ``per_step`` of every kernel and to give a finite
    loss; returns the losses and the timed steps' ms/step."""
    from flexflow_tpu_torch.model import METRIC_KEYS

    loss_sums, t0 = [], None
    for step in range(steps):
        if step == timed_from:
            model.sync()
            t0 = time.perf_counter()
        before = read_launches(kernels)
        model.train_iteration()
        got = {n: c - before[n] for n, c in read_launches(kernels).items()}
        check(got == per_step, f"step {step}: launches {got}, expected {per_step}")
        loss_sums.append(model._metric_acc[METRIC_KEYS.index("loss")].clone())
    model.sync()
    seconds = time.perf_counter() - t0
    # each rank holds its batch part's share of the loss: one sum over the
    # parts (a collective on a mesh of several devices) gives the loss
    sums = model._sum_over_parts(torch.stack(loss_sums)).tolist()
    losses = [b - a for a, b in zip([0.0] + sums[:-1], sums)]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    return dict(losses=losses, ms_per_step=seconds / (steps - timed_from) * 1e3)


def soap_vs_single(label, make_model, single_machine, kernels, per_step, samples, tokens=0,
                   lead=True, cell=None):
    """One model trained on the SOAP path and on the single-device path in
    turns (single, SOAP, SOAP, single), 2 warm-up and 5 timed steps each,
    then one more model of each path profiled (after the timed runs, so
    that no timed run follows a profiled one).  Every rank runs the SOAP
    models; only the lead rank runs the single-device ones, profiles and
    prints.  Returns the SOAP runs' launches (counts set to 0 just before
    each SOAP run, read just after)."""
    soap_launches = dict.fromkeys(kernels, 0)
    runs = {"single": [], "soap": []}
    for i, path in enumerate(("single", "soap", "soap", "single", "single", "soap")):
        if path == "single" and not lead:
            continue
        model = make_model(single_machine if path == "single" else None)
        check((model.machine.mesh is None) == (path == "single"),
              f"{label}: the {path} path's machine is {model.machine}")
        if path == "soap":
            check(all(type(w).__name__ == "DTensor" for ws in model._params.values()
                      for w in ws.values()), f"{label}: SOAP parameters are not DTensors")
            reset_launches(kernels)
        if i < 4:
            runs[path].append(timed_steps(model, kernels, per_step))
        elif lead:
            runs[path].append(profile_steps(model, f"{label}, {path} path",
                                            runs[path][0]["ms_per_step"]))
        else:  # the profiled run's steps, in step with the lead rank
            for _ in range(5):
                model.train_iteration()
            model.sync()
        if path == "soap":
            soap_launches = {n: soap_launches[n] + c for n, c in read_launches(kernels).items()}
        if i == 1 and lead:
            log(f"[soap] {label}: configs on the mesh "
                f"{ {op.name: op.pc.dims for op in model.ops} }")
        del model
        torch.cuda.empty_cache()
    if not lead:
        return soap_launches
    for path, (r1, r2, (device_ms, busy)) in runs.items():
        ms = [r1["ms_per_step"], r2["ms_per_step"]]
        rate = (f"{' / '.join(f'{tokens * 1e3 / m:.0f}' for m in ms)} tokens/s" if tokens else
                f"{' / '.join(f'{samples * 1e3 / m:.1f}' for m in ms)} samples/s")
        log(f"[soap] {label}, {path:6s} path: {' / '.join(f'{m:.3f}' for m in ms)} ms/step, "
            f"{rate}, device {device_ms:.3f} ms/step, busy {busy:.1f}% of the first run's "
            f"step, losses {['%.4f' % x for x in r1['losses']]}")
    log(f"[soap] {label}: launches per step on the SOAP path {per_step}")
    if cell is not None:
        MEASURED[cell]["soap_ms"] = sum(r["ms_per_step"] for r in runs["soap"][:2]) / 2
    return soap_launches


def soap_parity(ft, build_alexnet, build_transformer, synthetic_lm_batch, single_machine,
                lead, tol):
    """f32 weights after 2 steps, SOAP path vs single-device path: AlexNet
    at batch 8 (SGD, then Adam) under alexnet_16.pb, and the transformer
    of ``lm_parity`` under data parallelism.  Every rank trains the SOAP
    models and gathers their weights; the lead rank compares."""
    def weights(model):
        for _ in range(2):
            model.train_iteration()
        model.sync()
        return {(op.name, w.name): torch.from_numpy(model.get_parameter(op.name, w.name))
                for op in model.ops for w in op.weights}

    shape = dict(batch=2, seq_length=128, num_layers=2, embed_dim=128, num_heads=2,
                 vocab_size=512)
    cases = [("AlexNet batch 8 SGD", lambda m: main_model(
                 ft, build_alexnet, sgd_optimizer(ft), batch=8, machine=m,
                 compute_dtype="float32", import_strategy_file=ALEXNET_STRATEGY)),
             ("AlexNet batch 8 Adam", lambda m: main_model(
                 ft, build_alexnet, adam_optimizer(ft), batch=8, machine=m,
                 compute_dtype="float32", import_strategy_file=ALEXNET_STRATEGY)),
             ("transformer batch 2 S 128 2x128 SGD", lambda m: lm_model(
                 ft, build_transformer, synthetic_lm_batch,
                 lambda mm: ft.SGDOptimizer(mm, lr=0.01, momentum=0.9), machine=m,
                 compute_dtype="float32", **shape))]
    for label, make in cases:
        soap = weights(make(None))
        if not lead:
            continue
        single = weights(make(single_machine))
        case_tol = SOAP_MULTI_ADAM_TOL if "Adam" in label and tol is not SOAP_TOL else tol
        worst = 0.0
        for key in single:
            torch.testing.assert_close(soap[key], single[key], **case_tol,
                                       msg=lambda m: f"{label} {key}: {m}")
            worst = max(worst, (soap[key] - single[key]).abs().max().item())
        log(f"[soap] parity f32 {label}, 2 steps, SOAP path vs single-device path: "
            f"max |dw| {worst:.3e} (tolerance rtol {case_tol['rtol']:g}, atol "
            f"{case_tol['atol']:g}; cuDNN deterministic, TF32 off)")


def soap_runs(ft, build_alexnet, build_transformer, synthetic_lm_batch, kernels, dev, lead):
    """Phase 6's training on this rank: AlexNet (SGD, then Adam) under
    alexnet_16.pb and the transformer under data parallelism, SOAP beside
    single-device, then the f32 parity runs.  The SOAP path has no
    compiled step yet, so the single-device path it is set beside runs its
    eager step too (``disable_graphs``): the comparison is of what DTensor
    adds.  Returns the SOAP launches."""
    with ft.disable_graphs():
        return _soap_runs(ft, build_alexnet, build_transformer, synthetic_lm_batch, kernels,
                          dev, lead)


def _soap_runs(ft, build_alexnet, build_transformer, synthetic_lm_batch, kernels, dev, lead):
    world = torch.distributed.get_world_size()
    single_machine = ft.Machine(devices=[dev])
    # phase 4's settings for the timed runs
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    soap_launches = dict.fromkeys(kernels, 0)
    none = dict.fromkeys(kernels, 0)
    for label, make_opt, per_step, cell in (
            ("AlexNet SGD momentum 0.9", sgd_optimizer(ft), {**none, "fused_sgd_update": 1},
             "alexnet"),
            ("AlexNet Adam", adam_optimizer(ft), {**none, "fused_adam_update": 16}, None)):
        got = soap_vs_single(
            f"{label} batch {BATCH} bf16 alexnet_16.pb, world {world}",
            lambda m, make_opt=make_opt: main_model(ft, build_alexnet, make_opt, machine=m,
                                                    import_strategy_file=ALEXNET_STRATEGY),
            single_machine, kernels, per_step, BATCH, lead=lead, cell=cell)
        soap_launches = {n: soap_launches[n] + c for n, c in got.items()}
    lm_per_step = {**none, "fused_sgd_update": 1, "flash_fwd": LM["num_layers"],
                   "flash_bwd_dkdv": LM["num_layers"], "flash_bwd_dq": LM["num_layers"]}
    got = soap_vs_single(
        f"transformer batch {LM['batch']} S {LM['seq_length']} bf16 data parallel, "
        f"world {world}",
        lambda m: lm_model(ft, build_transformer, synthetic_lm_batch,
                           lambda mm: ft.SGDOptimizer(mm, lr=0.001), machine=m, **LM),
        single_machine, kernels, lm_per_step, LM["batch"], LM["batch"] * LM["seq_length"],
        lead=lead, cell="transformer")
    soap_launches = {n: soap_launches[n] + c for n, c in got.items()}
    check(all(c > 0 for c in soap_launches.values()),
          f"a kernel never launched on the SOAP path: {soap_launches}")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    soap_parity(ft, build_alexnet, build_transformer, synthetic_lm_batch, single_machine,
                lead, SOAP_TOL if world == 1 else SOAP_MULTI_TOL)
    return soap_launches


def soap_phase(ft, build_alexnet, build_transformer, synthetic_lm_batch, kernels, smi):
    """Phase 6 on the lead rank: an NCCL group of one rank per visible card
    (the others are this script started again as helper ranks), the SOAP
    runs, and the helpers' exit codes.  Returns the lead rank's SOAP
    launches."""
    from flexflow_tpu_torch.parallel import distributed as dist
    from flexflow_tpu_torch.parallel.mesh import mesh_shape
    from flexflow_tpu_torch.parallel.strategy import load_strategies_from_file

    world, port = torch.cuda.device_count(), free_port()
    helpers = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)], stdout=subprocess.DEVNULL,
        env=dict(os.environ, **{SOAP_HELPER: "1", "RANK": str(r), "LOCAL_RANK": str(r),
                                "WORLD_SIZE": str(world), "MASTER_ADDR": "localhost",
                                "MASTER_PORT": str(port)}))
        for r in range(1, world)]
    try:
        dev = dist.initialize("cuda", init_method=f"tcp://localhost:{port}",
                              world_size=world, rank=0, local_rank=0, timeout=SOAP_TIMEOUT)
        # (no Machine here: a mesh of several dims is made by a collective)
        log(f"[soap] process group: backend {torch.distributed.get_backend()}, world size "
            f"{dist.process_count()} (one rank per card; {torch.cuda.device_count()} card(s) "
            f"visible), mesh dims {mesh_shape(world)}; alexnet_16.pb holds "
            f"{len(load_strategies_from_file(ALEXNET_STRATEGY))} configs of up to 8 parts, "
            "legalized onto the mesh")
        launches = soap_runs(ft, build_alexnet, build_transformer, synthetic_lm_batch,
                             kernels, dev, lead=True)
        dist.shutdown()
        for r, p in enumerate(helpers, 1):
            check(p.wait(timeout=300) == 0, f"SOAP helper rank {r} exited {p.returncode}")
    finally:
        for p in helpers:  # a failed or hung rank must not outlive the script
            if p.poll() is None:
                p.kill()
    log(f"[soap] launches on the lead rank's SOAP path (2 runs each of AlexNet SGD, AlexNet "
        f"Adam and the transformer, 7 steps a run, and a profiled run of 5 each): "
        f"{launches}; card {smi}")
    return launches


def soap_helper():
    """A helper rank of phase 6 (rank, world size and rendezvous from the
    environment the lead rank set): the same SOAP runs, printing nothing."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_optimizer as fo
    from flexflow_tpu_torch.models.alexnet import build_alexnet
    from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch
    from flexflow_tpu_torch.parallel import distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dist.initialize("cuda", timeout=SOAP_TIMEOUT)
    kernels = kernel_wrappers(fo, fa)
    soap_runs(ft, build_alexnet, build_transformer, synthetic_lm_batch, kernels, dev,
              lead=False)
    dist.shutdown()
    return 0


# ------------------------------------------------------------------ phase 7

# f32 weights, compiled step vs eager step, on the same inputs: the same
# kernels in the same order on the same data, so the two should agree to
# the bit; 1e-6 is the limit stated for them (the fused update's).
GRAPH_TOL = dict(rtol=1e-6, atol=1e-6)
# grad_accum_steps 4 vs 1 after 2 f32 steps: the JAX package's own
# accumulation test's tolerance (tests/test_grad_accum.py)
ACCUM_TOL = dict(rtol=2e-5, atol=2e-6)
# remat vs plain: the same forward recomputed, the JAX package's remat
# test's tolerance
REMAT_TOL = dict(rtol=1e-6, atol=1e-7)


def free_models():
    """Free the models no name holds any more (an op refers to its model, so
    a dropped model waits for the cycle collector) and their cached blocks,
    so that a peak-memory reading counts one model."""
    gc.collect()
    torch.cuda.empty_cache()


def state_of(model):
    """Every weight and optimizer slot of a single-device model, cloned."""
    out = {("w", o, n): t.detach().clone() for o, ws in model._params.items()
           for n, t in ws.items()}
    for slot, tree in (model._opt_state or {}).items():
        out.update({(slot, o, n): t.clone() for o, ws in tree.items() for n, t in ws.items()})
    return out


def compare_states(a, b, tol, what):
    """Max |difference| over every leaf, after holding each at ``tol``;
    returns (max abs difference, whether every leaf is bitwise equal)."""
    worst, bitwise = 0.0, True
    for key in a:
        torch.testing.assert_close(a[key], b[key], **tol, msg=lambda m: f"{what} {key}: {m}")
        bitwise = bitwise and torch.equal(a[key], b[key])
        worst = max(worst, (a[key] - b[key]).abs().max().item())
    return worst, bitwise


def steps_ms(model, steps=7, timed_from=2):
    """Host ms per step over the steps after ``timed_from``, ending in a
    synchronize, and the cumulative loss sums (no host read in the loop)."""
    from flexflow_tpu_torch.model import METRIC_KEYS

    sums, t0 = [], None
    for step in range(steps):
        if step == timed_from:
            model.sync()
            t0 = time.perf_counter()
        model.train_iteration()
        sums.append(model._metric_acc[METRIC_KEYS.index("loss")].clone())
    model.sync()
    ms = (time.perf_counter() - t0) / (steps - timed_from) * 1e3
    sums = torch.stack(sums).tolist()
    losses = [b - a for a, b in zip([0.0] + sums[:-1], sums)]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    return ms, losses


def graph_vs_eager(ft, label, make_model, per_step, samples, tokens=0):
    """One model's compiled step and eager step in turns (graph, eager,
    eager, graph), 2 warm-up and 5 timed steps each, then one more model of
    each profiled: device ms per step, busy share and launches per step
    from the profiler's kernel events."""
    times = {"graph": [], "eager": []}
    for path in ("graph", "eager", "eager", "graph"):
        model = make_model()
        with contextlib.nullcontext() if path == "graph" else ft.disable_graphs():
            ms, losses = steps_ms(model)
        if path == "graph":
            check_graph_run(model, 7, label)
        else:
            check(model._step_graph is None, f"{label}: the eager run captured a graph")
        times[path].append(ms)
        del model
        torch.cuda.empty_cache()
    prof = {}
    for path in ("graph", "eager"):
        model = make_model()
        with contextlib.nullcontext() if path == "graph" else ft.disable_graphs():
            prof[path] = profile_steps(model, f"{label}, {path} step", times[path][0],
                                       per_step=per_step)
        del model
        torch.cuda.empty_cache()
    for path, ms in times.items():
        device_ms, busy = prof[path]
        rate = (f"{' / '.join(f'{tokens * 1e3 / m:.0f}' for m in ms)} tokens/s (device "
                f"ceiling {tokens * 1e3 / device_ms:.0f})" if tokens else
                f"{' / '.join(f'{samples * 1e3 / m:.1f}' for m in ms)} samples/s (device "
                f"ceiling {samples * 1e3 / device_ms:.1f})")
        log(f"[graph] {label}, {path:5s} step: {' / '.join(f'{m:.3f}' for m in ms)} ms/step, "
            f"{rate}, device {device_ms:.3f} ms/step, busy {busy:.1f}% of the first run's step")
    return times, prof


def graph_eager_parity(ft, label, make_model, steps=3, between=None):
    """f32 state after ``steps`` steps, compiled vs eager, from the same
    weights and batch: the eager first step, the captured second and a
    replay.  ``between(model, i)`` runs before step i on both paths."""
    def run(graph):
        model = make_model()
        with contextlib.nullcontext() if graph else ft.disable_graphs():
            for i in range(steps):
                if between is not None:
                    between(model, i)
                model.train_iteration()
        model.sync()
        if graph:
            check_graph_run(model, steps, label)
        return state_of(model)

    worst, bitwise = compare_states(run(True), run(False), GRAPH_TOL, label)
    log(f"[graph] parity f32 {label}, {steps} steps, compiled vs eager: max |d| {worst:.3e} "
        f"over weights and optimizer state ({'bitwise equal' if bitwise else 'not bitwise'}; "
        f"limit rtol 1e-6, atol 1e-6)")
    return worst


def guard_check(ft, build_alexnet, make_opt, label):
    """FF_SKIP_NONFINITE on the compiled step: two good steps (the eager
    one and the captured one), then the same batch with an inf staged into
    the static buffers and replayed: w, m and v bitwise unchanged and
    skipped_steps 1; a good step after it trains again."""
    import numpy as np

    os.environ["FF_SKIP_NONFINITE"] = "3"
    try:
        model = main_model(ft, build_alexnet, make_opt)
    finally:
        os.environ.pop("FF_SKIP_NONFINITE")
    inp = model.input_tensors[0]
    x = np.random.default_rng(1).standard_normal((BATCH,) + inp.dims[1:], dtype=np.float32)
    y = model._batch["label"].cpu().numpy()
    for _ in range(2):
        model.train_iteration()
    before = state_of(model)
    bad = x.copy()
    bad[3, 7, 11, 0] = np.inf
    model.set_batch({inp: bad}, y)
    model.train_iteration()
    model.sync()
    check_graph_run(model, 3, label)
    _, bitwise = compare_states(before, state_of(model), dict(rtol=0, atol=0), label)
    keys = model._metric_keys()
    acc = dict(zip(keys, model._metric_acc.tolist()))
    check(acc["skipped_steps"] == 1 and acc["consec_skipped"] == 1 and acc["steps"] == 2,
          f"{label}: guard entries {acc}")
    model.set_batch({inp: x}, y)
    model.train_iteration()
    model.sync()
    after = state_of(model)
    check(not torch.equal(after[("w", "fc1", "kernel")], before[("w", "fc1", "kernel")]),
          f"{label}: the good step after the skipped one did not train")
    acc = dict(zip(keys, model._metric_acc.tolist()))
    check(acc["consec_skipped"] == 0 and acc["skipped_steps"] == 1,
          f"{label}: guard entries after a good step {acc}")
    log(f"[graph] guard {label}: a batch with an inf replayed through the captured step left "
        f"every weight and slot ({len(before)} leaves) bitwise unchanged; skipped_steps "
        f"{acc['skipped_steps']:.0f}, nonfinite_loss {acc['nonfinite_loss']:.0f}; the next good "
        "step trained and reset consec_skipped")


def save_load_check(ft, build_alexnet, label):
    """save after 2 compiled steps, load into a fresh model, 2 more steps:
    equal to 4 uninterrupted steps."""
    import tempfile

    straight = main_model(ft, build_alexnet, sgd_optimizer(ft))
    for _ in range(4):
        straight.train_iteration()
    want = state_of(straight)
    del straight
    first = main_model(ft, build_alexnet, sgd_optimizer(ft))
    for _ in range(2):
        first.train_iteration()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "alexnet")
        t0 = time.perf_counter()
        first.save(path)
        save_s = time.perf_counter() - t0
        del first
        fresh = main_model(ft, build_alexnet, sgd_optimizer(ft))
        t0 = time.perf_counter()
        fresh.load(path)
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path + ".npz")
    check(fresh._step_count == 2, f"{label}: loaded step {fresh._step_count}")
    for _ in range(2):
        fresh.train_iteration()
    fresh.sync()
    check_graph_run(fresh, 2, label)
    worst, bitwise = compare_states(want, state_of(fresh), GRAPH_TOL, label)
    log(f"[graph] checkpoint {label}: save after 2 steps ({size / 2**20:.1f} MiB .npz, save "
        f"{save_s:.2f} s, load {load_s:.2f} s), load into a fresh model, 2 more steps vs 4 "
        f"uninterrupted: max |d| {worst:.3e} ({'bitwise equal' if bitwise else 'not bitwise'})")


def compiled_step_phase(ft, build_alexnet, build_transformer, synthetic_lm_batch, smi):
    """Phase 7: the compiled step against the eager step on both main paths,
    and the step's options on the card."""
    lm_make = lambda **cfg: lm_model(  # noqa: E731
        ft, build_transformer, synthetic_lm_batch, lambda m: ft.SGDOptimizer(m, lr=0.001),
        **{**LM, **cfg})
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    for label, make, per_step, samples, tokens, cell in (
            (f"AlexNet batch {BATCH} bf16 SGD momentum 0.9",
             lambda: main_model(ft, build_alexnet, sgd_optimizer(ft)), ALEX_SGD_STEP,
             BATCH, 0, "alexnet"),
            (f"AlexNet batch {BATCH} bf16 Adam",
             lambda: main_model(ft, build_alexnet, adam_optimizer(ft)), ALEX_ADAM_STEP,
             BATCH, 0, None),
            (f"transformer batch {LM['batch']} S {LM['seq_length']} bf16 SGD", lm_make,
             LM_SGD_STEP, LM["batch"], LM["batch"] * LM["seq_length"], "transformer")):
        times, prof = graph_vs_eager(ft, label, make, per_step, samples, tokens)
        if cell is not None:
            MEASURED[cell].update(graph_ms=sum(times["graph"]) / len(times["graph"]),
                                  graph_device_ms=prof["graph"][0])

    # remat against plain on the bf16 main path: weights (compiled step) and
    # peak memory on both paths
    peaks, states = {}, {}
    for remat in (False, True):
        for path in ("graph", "eager"):
            free_models()
            torch.cuda.reset_peak_memory_stats()
            model = lm_make(remat=remat)
            with contextlib.nullcontext() if path == "graph" else ft.disable_graphs():
                steps_ms(model, steps=2, timed_from=1)
            peaks[remat, path] = torch.cuda.max_memory_allocated() / 2**30
            if path == "graph":
                check_graph_run(model, 2, f"transformer remat={remat}")
                states[remat] = state_of(model)
            del model
    worst, bitwise = compare_states(states[True], states[False], REMAT_TOL, "remat")
    log(f"[graph] remat transformer bf16, 2 steps: max_memory_allocated plain "
        f"{peaks[False, 'graph']:.2f} GiB compiled / {peaks[False, 'eager']:.2f} GiB eager, "
        f"remat {peaks[True, 'graph']:.2f} / {peaks[True, 'eager']:.2f} GiB; weights after 2 "
        f"compiled steps max |d| {worst:.3e} ({'bitwise equal' if bitwise else 'not bitwise'}; "
        f"limit rtol 1e-6, atol 1e-7); card {smi}")
    del states
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    f32 = dict(compute_dtype="float32")
    graph_eager_parity(ft, f"AlexNet batch {BATCH} SGD momentum 0.9",
                       lambda: main_model(ft, build_alexnet, sgd_optimizer(ft), **f32))

    def epochs(model, i):  # alpha_t changes between replays
        if i >= 2:
            model.optimizer.next_epoch()
    graph_eager_parity(ft, f"AlexNet batch {BATCH} Adam, next_epoch() before steps 3 and 4",
                       lambda: main_model(ft, build_alexnet, adam_optimizer(ft), **f32),
                       steps=4, between=epochs)
    lm_sgd = lambda **cfg: lm_model(  # noqa: E731
        ft, build_transformer, synthetic_lm_batch,
        lambda m: ft.SGDOptimizer(m, lr=0.01, momentum=0.9), **{**LM, **f32, **cfg})
    graph_eager_parity(ft, f"transformer batch {LM['batch']} S {LM['seq_length']} SGD "
                       "momentum 0.9", lm_sgd)

    # gradient accumulation: K = 4 against K = 1, 2 compiled f32 steps
    states = {}
    for k in (1, 4):
        model = lm_sgd(grad_accum_steps=k)
        for _ in range(2):
            model.train_iteration()
        model.sync()
        check_graph_run(model, 2, f"transformer grad_accum_steps={k}")
        states[k] = state_of(model)
        del model
        torch.cuda.empty_cache()
    worst, _ = compare_states(states[4], states[1], ACCUM_TOL, "grad_accum_steps")
    log(f"[graph] grad_accum_steps f32 transformer, 4 micro-batches of "
        f"{LM['batch'] // 4} vs the whole batch, 2 compiled steps: max |d| {worst:.3e} over "
        "weights and momentum (limit rtol 2e-5, atol 2e-6)")
    del states
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    guard_check(ft, build_alexnet, sgd_optimizer(ft), f"AlexNet batch {BATCH} bf16 SGD")
    guard_check(ft, build_alexnet, adam_optimizer(ft), f"AlexNet batch {BATCH} bf16 Adam")
    torch.cuda.empty_cache()
    save_load_check(ft, build_alexnet, f"AlexNet batch {BATCH} bf16 SGD")
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 8

# Part counts of the data-parallel configs the calibration measures, and the
# node the offline search plans for.
CAL_PARTS = (1, 2, 4, 8)
NODE_GPUS = 8
SEARCH_BUDGET = 300    # compile(search_budget=...) on this machine
OFFLINE_BUDGET = 1000  # the offline search for an 8-GPU node
# What phases 4, 6 and 7 measured on each cell, for phase 8's agreement lines.
MEASURED = {"alexnet": {}, "transformer": {}}


def calibration_files(directory):
    """Paths of this run's measured cache and fit in ``directory``, emptied,
    so that the run measures afresh."""
    os.makedirs(directory, exist_ok=True)
    paths = (os.path.join(directory, "measured_h100.json"),
             os.path.join(directory, "machine_h100.json"))
    for path in paths:
        if os.path.exists(path):
            os.remove(path)
    return paths


def calibration_cost(mm, measured_path):
    """A cost model over this run's measured cache and nothing else."""
    from flexflow_tpu_torch.simulator.cost_model import CostModel

    return CostModel(mm, compute_dtype="bfloat16", cache_path=None,
                     measured_cache_path=measured_path)


def calibrate_on_card(kernels, smi, measured_path, fit_path):
    """8a: every op of both cells, forward and backward, at their
    data-parallel sub-shapes of 1, 2, 4 and 8 parts, timed on the card; the
    roofline fitted to them.  The attention measurements must have launched
    K3-K5 (7 times per measurement: 2 warm-up and 5 timed iterations)."""
    from flexflow_tpu_torch.simulator import cost_model
    from flexflow_tpu_torch.tools import calibrate

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    reset_launches(kernels)
    r = calibrate.calibrate([("alexnet", BATCH), ("transformer", LM["batch"])],
                            devices=NODE_GPUS, dp_parts=CAL_PARTS, compute_dtype="bfloat16",
                            out=measured_path, fit_out=fit_path, device="cuda",
                            verbose=False)
    launches = read_launches(kernels)
    with open(measured_path) as f:
        entries = json.load(f)
    mha = sum(1 for k in entries if k.startswith("MultiHeadAttention:") and k.endswith(":forward"))
    per = cost_model.MEASURE_WARMUP + cost_model.MEASURE_ITERS
    check(mha == len(CAL_PARTS), f"{mha} attention configs measured, expected {len(CAL_PARTS)}")
    check(r["jobs"] == len(entries) and all(v["platform"] == "cuda" for v in entries.values()),
          f"{r['jobs']} jobs gave {len(entries)} measured entries")
    check(launches == {**dict.fromkeys(kernels, 0), "flash_fwd": mha * per,
                       "flash_bwd_dkdv": mha * per, "flash_bwd_dq": mha * per},
          f"calibration launches {launches}, expected {mha * per} of each flash kernel")
    fit = r["fit"]
    log(f"[search] calibration: {len(entries)} measured points ({r['jobs']} jobs: every op of "
        f"AlexNet batch {BATCH} and the transformer B{LM['batch']} S{LM['seq_length']} bf16, "
        f"forward and backward, data-parallel parts {CAL_PARTS}) in {r['seconds']:.1f} s; "
        f"cudnn.benchmark False, TF32 on; flash launches {launches}")
    log(f"[search] fit over {fit['fit_points']} points: log-rmse {fit['fit_log_rmse']:.4f}, "
        f"matmul_efficiency {fit['matmul_efficiency']:.2f}, hbm_bandwidth "
        f"{fit['hbm_bandwidth'] / 1e9:.0f} GB/s, kernel_launch_overhead "
        f"{fit['kernel_launch_overhead'] * 1e6:.0f} us, backward_multiplier "
        f"{fit['backward_multiplier']:.3f}, op_efficiency {fit['op_efficiency']}, "
        f"op_backward_multiplier "
        f"{ {k: round(v, 3) for k, v in fit['op_backward_multiplier'].items()} }; "
        f"card {fit['device']}, {fit['power_limit']} ({smi})")
    return launches


def cell_model(name, ft, nd=1):
    """A cell's graph (``tools/offline_search.py`` builds the tools' models:
    the same full widths as phases 4-7), its machine sized ``nd``."""
    from flexflow_tpu_torch.tools import offline_search

    check(offline_search.TRANSFORMER == {k: v for k, v in LM.items() if k != "batch"},
          f"the tools' transformer {offline_search.TRANSFORMER} is not the cell's {LM}")
    return offline_search.build_model(name, BATCH if name == "alexnet" else LM["batch"], nd,
                                      "cuda", "bfloat16")


def simulated_agreement(ft, smi, measured_path, fit_path):
    """8b: each cell's data-parallel step on one card, simulated from the
    measured table and from the fitted roofline alone, beside what phases
    4, 6 and 7 measured; the predicted memory beside the measured peak."""
    from flexflow_tpu_torch.simulator.machine import H100MachineModel
    from flexflow_tpu_torch.simulator.memory import memory_per_device
    from flexflow_tpu_torch.simulator.simulator import Simulator

    mm = H100MachineModel.calibrated(path=fit_path, num_devices=1)
    check(mm.fitted, f"the machine model is not this run's fit: {mm.source}")
    for name in ("alexnet", "transformer"):
        model = cell_model(name, ft)
        dp = {op.name: ft.ParallelConfig.data_parallel(op.output.num_dims, 1)
              for op in model.ops}
        table = Simulator(mm, calibration_cost(mm, measured_path))
        roof = Simulator(mm, calibration_cost(mm, os.devnull))
        sim_ms = table.simulate_runtime(model, dp) * 1e3
        roof_ms = roof.simulate_runtime(model, dp) * 1e3
        check(table.cost.stats["analytic"] == 0, f"{name}: a DP-1 op was not measured")
        per_op = sorted(((table.cost.op_time(op, dp[op.name], "forward")
                          + table.cost.op_time(op, dp[op.name], "backward")) * 1e3, op.name)
                        for op in model.ops)[::-1]
        log(f"[search] {name} DP-1 table, largest ops (forward + backward ms): "
            f"{', '.join(f'{n} {t:.3f}' for t, n in per_op[:6])}")
        got = MEASURED[name]
        log(f"[search] {name} DP-1 simulated {sim_ms:.3f} ms/step from the measured table "
            f"({roof_ms:.3f} from the fitted roofline alone); measured: compiled step "
            f"{got['graph_ms']:.3f} ms/step (device {got['graph_device_ms']:.3f}), eager SOAP "
            f"step {got['soap_ms']:.3f} ms/step; simulated/measured {sim_ms / got['graph_ms']:.3f} "
            f"compiled, {sim_ms / got['graph_device_ms']:.3f} device, "
            f"{sim_ms / got['soap_ms']:.3f} SOAP-eager; roofline/compiled "
            f"{roof_ms / got['graph_ms']:.3f}; card {smi}")
        opts = ([("SGD momentum 0.9", ft.SGDOptimizer(lr=0.001, momentum=0.9)),
                 ("Adam", ft.AdamOptimizer(alpha=ADAM_ALPHA))] if name == "alexnet" else
                [("SGD", ft.SGDOptimizer(lr=0.001))])
        preds = {label: memory_per_device(model, dp, machine_model=mm, optimizer=opt)
                 for label, opt in opts}
        peak = max(p["peak_bytes"] for p in preds.values()) / 2**30
        log(f"[search] {name} memory: predicted "
            f"{', '.join(k + ' %.2f GiB' % (p['peak_bytes'] / 2**30) for k, p in preds.items())} "
            f"(dominant {[p['dominant_term'] for p in preds.values()]}) against phase 4's "
            f"max_memory_allocated {got['peak_gib']:.2f} GiB: predicted/measured "
            f"{peak / got['peak_gib']:.3f}")


def search_entry_point(ft, build_alexnet, kernels, out_dir):
    """8c: full-width AlexNet through compile(search_budget=...) with each
    engine on the default machine (one card without a process group, whose
    steps are compiled) and the committed calibration (what a user's
    compile reads), init_layers and 3 compiled steps; the exported strategy
    loads back equal."""
    from flexflow_tpu_torch.parallel.strategy import load_strategies_from_file, read_provenance

    launches = dict.fromkeys(kernels, 0)
    for engine in ("mcmc", "population"):
        free_models()
        pb = os.path.join(out_dir, f"alexnet_searched_{engine}.pb")
        reset_launches(kernels)
        t0 = time.perf_counter()
        model = main_model(ft, build_alexnet, sgd_optimizer(ft), search_budget=SEARCH_BUDGET,
                           search_engine=engine, export_strategy_file=pb)
        seconds = time.perf_counter() - t0
        ms, losses = steps_ms(model, steps=3, timed_from=1)
        got = read_launches(kernels)
        check_graph_run(model, 3, f"AlexNet searched by {engine}")
        # the eager first step and the capture call the wrapper; the replay does not
        check(got == {**dict.fromkeys(kernels, 0), "fused_sgd_update": 2},
              f"{engine}: launches {got}")
        launches = {n: launches[n] + got[n] for n in kernels}
        check(load_strategies_from_file(pb) == {op.name: op.pc for op in model.ops},
              f"{engine}: the exported strategy does not load back equal")
        meta = read_provenance(pb)
        log(f"[search] compile(search_budget={SEARCH_BUDGET}, search_engine={engine!r}) on "
            f"{model.machine.num_devices} GPU(s): DP {meta['dp_ms']:.3f} ms, best "
            f"{meta['best_ms']:.3f} ms simulated; compile {seconds:.2f} s; 3 compiled "
            f"steps, losses {['%.4f' % x for x in losses]}, {ms:.3f} ms/step over the capture "
            f"and a replay; "
            f"configs {sorted({op.pc.dims for op in model.ops})}; launches {got}; "
            f"{meta['machine_model']}")
        del model
    return launches


def offline_node_search(ft, measured_path, fit_path):
    """8d: the offline search for an 8-GPU node on this run's calibration;
    every config of the best strategy composes over the port's 8-device mesh,
    no attention splits its sequence and no conv or pool its height or
    width."""
    from flexflow_tpu_torch.parallel.mesh import axes_for_degrees, mesh_shape
    from flexflow_tpu_torch.simulator.machine import H100MachineModel
    from flexflow_tpu_torch.tools import offline_search

    sizes, names = mesh_shape(NODE_GPUS)
    for name in ("alexnet", "transformer"):
        for engine in ("mcmc", "population"):
            model = cell_model(name, ft, NODE_GPUS)
            mm = H100MachineModel.calibrated(path=fit_path, num_devices=NODE_GPUS)
            best = offline_search.run(model, NODE_GPUS, OFFLINE_BUDGET, seed=0, engine=engine,
                                      machine_model=mm,
                                      cost_model=calibration_cost(mm, measured_path))
            for op in model.ops:
                dims = best[op.name].dims
                axes_for_degrees(names, sizes, dims)  # raises if it cannot
                if op._type == "MultiHeadAttention":
                    check(dims[1] == 1, f"{op.name} splits its sequence: {dims}")
                if op._type in ("Conv2D", "Pool2D"):
                    check(dims[1:3] == (1, 1), f"{op.name} splits its height or width: {dims}")
            split = {op.name: best[op.name].dims for op in model.ops
                     if best[op.name].dims != (NODE_GPUS,) + (1,) * (op.output.num_dims - 1)}
            log(f"[search] offline {engine} search, {name}, {NODE_GPUS} H100s, budget "
                f"{OFFLINE_BUDGET}: DP {best.dp_s * 1e3:.3f} ms, best {best.best_s * 1e3:.3f} "
                f"ms simulated ({best.dp_s / best.best_s:.2f}x), "
                f"{best.proposals_per_s:.0f} proposals/s; configs off data parallel {split}")


def search_phase(ft, build_alexnet, kernels, smi, out_dir):
    """Phase 8: calibration, agreement, the search through compile, the
    offline search for a node.  Returns the kernels' launches on its two
    paths, the calibration's measurements and the searched model's steps."""
    t0 = time.perf_counter()
    measured_path, fit_path = calibration_files(out_dir)
    cal = calibrate_on_card(kernels, smi, measured_path, fit_path)
    simulated_agreement(ft, smi, measured_path, fit_path)
    entry = search_entry_point(ft, build_alexnet, kernels, out_dir)
    offline_node_search(ft, measured_path, fit_path)
    log(f"[search] phase 8 took {time.perf_counter() - t0:.1f} s; calibration written to "
        f"{measured_path} and {fit_path}")
    return {n: cal[n] + entry[n] for n in kernels}


# ------------------------------------------------------------------ phase 9

# The rest of the zoo at full width (PERF.md section 4): per
# model the builder's module and function, its arguments, the global batch,
# the loss, the optimizer (kind, lr or alpha, momentum), the input the
# rate counts (samples, or tokens per sample), and its weight leaves.
ZOO = {
    "resnet50": dict(module="resnet", build="build_resnet50", kw={}, batch=64,
                     loss="sparse_categorical_crossentropy", opt=("sgd", 0.001, 0.9),
                     tokens=0, leaves=108,
                     label="ResNet-50 3x229x229 batch 64 bf16, SGD momentum 0.9"),
    "inception_v3": dict(module="inception", build="build_inception_v3", kw={}, batch=128,
                         loss="sparse_categorical_crossentropy", opt=("sgd", 0.001, 0.9),
                         tokens=0, leaves=190,
                         label="Inception-v3 3x299x299 batch 128 bf16, SGD momentum 0.9"),
    "dlrm": dict(module="dlrm", build="build_dlrm", kw={}, batch=256,
                 loss="mean_squared_error", opt=("sgd", 0.01, 0.0), tokens=0, leaves=22,
                 label="DLRM batch 256, 8 tables x 1,000,000 x 64 on the card, bot "
                       "64-512-512-64, top 576-1024-1024-1024-1, bf16, SGD"),
    "candle_uno": dict(module="candle_uno", build="build_candle_uno", kw={}, batch=256,
                       loss="mean_squared_error", opt=("sgd", 0.001, 0.0), tokens=0,
                       leaves=26, label="CANDLE-Uno batch 256, 3x1000 towers and trunk, "
                                        "bf16, SGD"),
    "nmt": dict(module="nmt", build="build_nmt", kw={}, batch=64,
                loss="sparse_categorical_crossentropy", opt=("adam", ADAM_ALPHA, 0.0),
                tokens=20, leaves=15,
                label="NMT batch 64, seq 20, 2+2 LSTM layers, hidden = embed 2048, vocab "
                      "20480, bf16, Adam"),
    "transformer_moe": dict(module="transformer", build="build_transformer",
                            kw=dict(moe_every=2, num_experts=8,
                                    **{k: v for k, v in LM.items() if k != "batch"}),
                            batch=LM["batch"], loss="sparse_categorical_crossentropy",
                            opt=("sgd", 0.001, 0.0), tokens=LM["seq_length"], leaves=56,
                            label=f"MoE transformer batch {LM['batch']} S {LM['seq_length']} "
                                  f"{LM['num_layers']}x{LM['embed_dim']}, 8 experts every 2nd "
                                  "layer, bf16, SGD"),
}
# Smaller depth for the f32 parity runs of phase 9 (the MoE transformer:
# 2 layers, one of them MoE); the other models run whole.
ZOO_PARITY_KW = {"transformer_moe": dict(num_layers=2)}
# The offline search of each new model for an 8-GPU node (simulation only).
ZOO_SEARCH_BUDGET = 300


def zoo_model(ft, name, kw=None, **cfg):
    """A model of the zoo through the user-facing entry points (bf16 and
    the fused optimizer unless ``cfg`` says otherwise), its synthetic batch
    (made from a seed, the JAX package's recipes) staged."""
    import importlib

    import numpy as np

    z = ZOO[name]
    batch = z["batch"]
    mod = importlib.import_module(f"flexflow_tpu_torch.models.{z['module']}")
    cfg = {"compute_dtype": "bfloat16", "fused_optimizer": True, **cfg}
    model = ft.FFModel(ft.FFConfig(batch_size=batch, **cfg))
    built = getattr(mod, z["build"])(model, batch, **{**z["kw"], **(kw or {})})
    kind, lr, momentum = z["opt"]
    opt = (ft.SGDOptimizer(model, lr=lr, momentum=momentum) if kind == "sgd"
           else ft.AdamOptimizer(model, alpha=lr))
    metrics = (["accuracy"] if z["loss"] == "sparse_categorical_crossentropy"
               else ["mean_squared_error"])
    model.compile(opt, z["loss"], metrics)
    model.init_layers(seed=0)
    if name in ("resnet50", "inception_v3"):
        ft.DataLoader.synthetic(model, built[0], num_samples=batch).next_batch(model)
    elif name == "dlrm":
        rows = [op.num_entries for op in model.ops if op._type == "Embedding"]
        sparse, dense, labels = mod.synthetic_batch(batch, rows, 1, built[1].dims[1], seed=11)
        model.set_batch({**dict(zip(built[0], sparse)), built[1]: dense}, labels)
    elif name == "candle_uno":
        rng = np.random.default_rng(0)
        model.set_batch({t: rng.standard_normal(t.dims, dtype=np.float32)
                         for t in built[0].values()},
                        rng.standard_normal((batch, 1), dtype=np.float32))
    elif name == "nmt":
        vocab = model.ops[0].num_entries  # embed_src's rows
        src, dst, labels = mod.synthetic_batch(batch, built[0].dims[1], vocab, seed=5)
        model.set_batch({built[0]: src, built[1]: dst}, labels)
    else:
        toks, posa, labels = mod.synthetic_lm_batch(batch, built[0].dims[1],
                                                    z["kw"]["vocab_size"], seed=0)
        model.set_batch({built[0]: toks, built[1]: posa}, labels)
    return model


def zoo_per_step(fo, model, name):
    """Launches of each of this repo's kernels in one step of a zoo model:
    SGD one per 64 leaves (``sgd_launch_plan``), Adam one per leaf, the
    flash kernels one per attention layer."""
    numels = [w.numel() for ws in model._params.values() for w in ws.values()]
    attn = sum(op._type == "MultiHeadAttention" for op in model.ops)
    kind = ZOO[name]["opt"][0]
    return {**NO_LAUNCH, "fused_sgd_update": len(fo.sgd_launch_plan(numels)) if kind == "sgd"
            else 0, "fused_adam_update": len(numels) if kind == "adam" else 0,
            "flash_fwd": attn, "flash_bwd_dkdv": attn, "flash_bwd_dq": attn}


def zoo_train(ft, fo, kernels, name, smi):
    """One zoo model at full width: the wrappers' launches at the eager step
    and the capture, the compiled and eager steps in turns, the profiled
    compiled step (device ms, busy share, launches per step from the
    profiler, top families), max_memory_allocated, the rate, the predict
    output's shape; the measured numbers for the search lines."""
    z = ZOO[name]
    free_models()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    model = zoo_model(ft, name)
    n_leaves = sum(len(ws) for ws in model._params.values())
    n_params = sum(w.numel() for ws in model._params.values() for w in ws.values())
    check(n_leaves == z["leaves"], f"{name} has {n_leaves} leaves, expected {z['leaves']}")
    per_step = zoo_per_step(fo, model, name)
    ms, losses = steps_ms(model)
    check_graph_run(model, 7, name)
    got = read_launches(kernels)
    check(got == {n: 2 * c for n, c in per_step.items()},
          f"{name}: wrapper launches {got} (eager step and capture), expected twice {per_step}")
    probs = model.predict_batch()  # the MoE transformer's forward launches K3 per layer
    launches = read_launches(kernels)
    out_dims = model.final_tensor().dims
    check(tuple(probs.shape) == tuple(out_dims) and bool(torch.isfinite(
        torch.from_numpy(probs)).all()), f"{name}: predict_batch {probs.shape} vs {out_dims}")
    # the optimizer kernel's byte bound: w read and written, g read, and
    # each slot read and written (SGD momentum one, Adam two), f32
    kind, _, momentum = z["opt"]
    slots = 2 if kind == "adam" else int(momentum > 0)
    opt_bound_ms = n_params * 4 * (3 + 2 * slots) / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    metrics = model.get_metrics().to_string()
    del model
    times = {"graph": [ms], "eager": []}
    for path in ("eager", "eager", "graph"):
        free_models()
        model = zoo_model(ft, name)
        with contextlib.nullcontext() if path == "graph" else ft.disable_graphs():
            times[path].append(steps_ms(model)[0])
        del model
    free_models()
    model = zoo_model(ft, name)
    kernel_ms = {}
    device_ms, busy = profile_steps(model, f"{name}, compiled step", times["graph"][0],
                                    per_step=per_step, kernel_ms=kernel_ms)
    del model
    free_models()
    samples = z["batch"]
    unit = (lambda m: f"{samples * z['tokens'] * 1e3 / m:.0f} tokens/s") if z["tokens"] else \
        (lambda m: f"{samples * 1e3 / m:.1f} samples/s")
    log(f"[models] {z['label']}: {n_params:,} parameters in {n_leaves} leaves; losses "
        f"{['%.5f' % x for x in losses]}; {metrics}")
    for path in ("graph", "eager"):
        log(f"[models] {name} {'compiled' if path == 'graph' else 'eager'} step: "
            f"{' / '.join(f'{m:.3f}' for m in times[path])} ms/step, "
            f"{' / '.join(unit(m) for m in times[path])}")
    log(f"[models] {name}: device {device_ms:.3f} ms/step, busy {busy:.1f}% of the first "
        f"compiled run's step (device ceiling {unit(device_ms)}); max_memory_allocated "
        f"{peak:.2f} GiB; launches per step {per_step}; card {smi}")
    opt_kernel = "fused_adam_update" if kind == "adam" else "fused_sgd_update"
    log(f"[models] {name}: {opt_kernel} {kernel_ms.get(opt_kernel, 0.0):.4f} ms/step over "
        f"{per_step[opt_kernel]} launch(es) and {n_params * 4 / 2**30:.2f} GiB of f32 "
        f"weights, against its byte bound {opt_bound_ms:.4f} ms; flash kernels "
        f"{ {k: round(v, 4) for k, v in kernel_ms.items() if k.startswith('flash')} } ms/step")
    return launches, dict(graph_ms=sum(times["graph"]) / len(times["graph"]),
                          graph_device_ms=device_ms)


def zoo_parity(ft, fa, kernels, name):
    """f32 weights and optimizer state after 2 steps of three runs from the
    same weights and batch: compiled with the kernels, eager with the
    kernels, eager with the plain versions (the plain update and, for the
    MoE transformer, the flash kernels' plain versions).  Compiled vs eager
    is held at GRAPH_TOL; kernel vs plain at the fused update's tolerance,
    and at the transformer's where attention's summation order differs."""
    kw = ZOO_PARITY_KW.get(name)

    def run(graph, fused):
        free_models()
        model = zoo_model(ft, name, kw=kw, compute_dtype="float32", fused_optimizer=fused)
        before = read_launches(kernels)
        plain = contextlib.nullcontext() if fused else fa.plain_versions()
        with contextlib.nullcontext() if graph else ft.disable_graphs(), plain:
            for _ in range(2):
                model.train_iteration()
        model.sync()
        used = {n: c - before[n] for n, c in read_launches(kernels).items()}
        check(fused or not any(used.values()), f"{name}: the plain path launched {used}")
        check(not fused or any(used.values()), f"{name}: the kernel path launched nothing")
        if graph:
            check_graph_run(model, 2, f"{name} f32")
        return state_of(model)

    compiled, eager, plain = run(True, True), run(False, True), run(False, False)
    g_worst, g_bitwise = compare_states(compiled, eager, GRAPH_TOL, f"{name} compiled/eager")
    tol = LM_PARITY_TOL if name == "transformer_moe" else PARITY_TOL
    p_worst, _ = compare_states(eager, plain, tol, f"{name} kernel/plain")
    log(f"[models] parity f32 {name}{' ' + str(kw) if kw else ''}, 2 steps: compiled vs eager "
        f"max |d| {g_worst:.3e} ({'bitwise equal' if g_bitwise else 'not bitwise'}; limit "
        f"rtol 1e-6, atol 1e-6); kernels vs plain versions max |d| {p_worst:.3e} (limit rtol "
        f"{tol['rtol']:g}, atol {tol['atol']:g})")


def zoo_search(ft, measured, smi, out_dir):
    """Each new model's data-parallel step on one card simulated from a
    table of its own ops measured on the card here (calibrate, one part),
    beside the compiled step measured above; then the offline search for an
    8-GPU node, whose configs must all be ones the port's training path
    runs (check_config) and compose over its 8-device mesh."""
    from flexflow_tpu_torch.parallel.mesh import axes_for_degrees, mesh_shape
    from flexflow_tpu_torch.simulator.machine import H100MachineModel
    from flexflow_tpu_torch.simulator.simulator import Simulator
    from flexflow_tpu_torch.tools import calibrate, offline_search

    measured_path = os.path.join(out_dir, "zoo_measured_h100.json")
    fit_path = os.path.join(out_dir, "zoo_machine_h100.json")
    for path in (measured_path, fit_path):
        if os.path.exists(path):
            os.remove(path)
    names = {"resnet50": "resnet", "inception_v3": "inception"}
    for name, z in ZOO.items():
        _, _, batch, kw = offline_search.MODELS[names.get(name, name)]
        check((batch, kw) == (z["batch"], z["kw"]),
              f"the tools' {name} {batch, kw} is not phase 9's {z['batch'], z['kw']}")
    t0 = time.perf_counter()
    r = calibrate.calibrate([(names.get(n, n), ZOO[n]["batch"]) for n in ZOO], devices=1,
                            dp_parts=(1,), compute_dtype="bfloat16", out=measured_path,
                            fit_out=fit_path, device="cuda", verbose=False)
    log(f"[search] zoo calibration: {r['measured']} measured points, every op of the six "
        f"models at one part, forward and backward, in {time.perf_counter() - t0:.1f} s")
    mm = H100MachineModel.calibrated(path=fit_path, num_devices=1)
    for name in ZOO:
        model = offline_search.build_model(names.get(name, name), ZOO[name]["batch"], 1,
                                           "cuda", "bfloat16")
        dp = {op.name: ft.ParallelConfig.data_parallel(op.output.num_dims, 1)
              for op in model.ops}
        table = Simulator(mm, calibration_cost(mm, measured_path))
        sim_ms = table.simulate_runtime(model, dp) * 1e3
        check(table.cost.stats["analytic"] == 0, f"{name}: a DP-1 op was not measured")
        got = measured[name]
        log(f"[search] {name} DP-1 simulated {sim_ms:.3f} ms/step from its measured table; "
            f"measured compiled step {got['graph_ms']:.3f} ms/step (device "
            f"{got['graph_device_ms']:.3f}): simulated/measured {sim_ms / got['graph_ms']:.3f} "
            f"compiled, {sim_ms / got['graph_device_ms']:.3f} device; card {smi}")
    sizes, axes = mesh_shape(NODE_GPUS)
    node = H100MachineModel.calibrated(num_devices=NODE_GPUS)
    for name in ZOO:
        model = offline_search.build_model(names.get(name, name), ZOO[name]["batch"],
                                           NODE_GPUS, "cuda", "bfloat16")
        best = offline_search.run(model, NODE_GPUS, ZOO_SEARCH_BUDGET, seed=0, machine_model=node)
        for op in model.ops:
            op.check_config(best[op.name])  # raises on a split training rejects
            axes_for_degrees(axes, sizes, best[op.name].dims)
        log(f"[search] offline mcmc search, {name}, {NODE_GPUS} H100s, budget "
            f"{ZOO_SEARCH_BUDGET}: DP {best.dp_s * 1e3:.3f} ms, best {best.best_s * 1e3:.3f} ms "
            f"simulated ({best.dp_s / best.best_s:.2f}x; {node.source})")


def models_phase(ft, fo, fa, kernels, smi, out_dir):
    """Phase 9: the rest of the zoo at full width through the compiled
    step, f32 parity on the card, and the search lines.  Returns the
    kernels' wrapper launches of the main-path runs (the eager first steps
    and the captures)."""
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    launches = dict.fromkeys(kernels, 0)
    measured = {}
    for name in ZOO:
        got, measured[name] = zoo_train(ft, fo, kernels, name, smi)
        launches = {n: launches[n] + got[n] for n in kernels}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    for name in ZOO:
        zoo_parity(ft, fa, kernels, name)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    free_models()
    zoo_search(ft, measured, smi, out_dir)
    log(f"[models] phase 9 took {time.perf_counter() - t0:.1f} s; wrapper launches {launches}")
    return launches


# ------------------------------------------------------------------ phase 10

GEN = dict(P=256, N=256)       # (a): LM["batch"] rows, P + N = LM["seq_length"]
BEAM = dict(B=4, K=4, P=64, N=64)
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9, seed=1234)
SAMPLED = dict(P=64, N=64)     # sampled generate: LM["batch"] rows
MOE_GEN = dict(P=128, N=128)
NMT_GEN = dict(batch=64, seq_length=20, max_len=20)
ENGINE = dict(max_batch=16, max_seq=512, kv_block=16, max_new_tokens=128)
TRAFFIC = dict(requests=64, prompt=(16, 256), new=(16, 128), shared=8, prefix=128, tail=64)
# The f32 oracle: where a full-sequence forward's argmax differs from a
# decoded token, the two tokens' probabilities under that forward must lie
# within this share of the top one (f32 sums in another order, TF32 off).
F32_GAP_TOL = 1e-4
# bf16 decoding has no exact reference: every token that bf16 generate or
# the engine chose must have an f32 probability (the f32 model with the
# same weights, full forward over the same tokens) within this share of
# the top one, a few bf16 roundings of a logit.  The same bound holds the
# engine (decode steps of max_batch rows, B = 1 prefill) against generate
# (B rows) at their first differing token: the card's GEMMs round
# differently at different batch shapes, so a near-tie may break the
# other way.
BF16_GAP_TOL = 2.0 ** -5


def decode_lm(ft, build_transformer, dtype, **kw):
    """The bench transformer (LM) for decoding: random weights from seed
    0, so the bf16 and the f32 model hold the same weights."""
    shape = {k: v for k, v in LM.items() if k != "batch"}
    shape.update(kw)
    model = ft.FFModel(ft.FFConfig(batch_size=LM["batch"], compute_dtype=dtype))
    tok, pos, _ = build_transformer(model, LM["batch"], **shape)
    model.compile(ft.SGDOptimizer(lr=0.001), "sparse_categorical_crossentropy", ["accuracy"])
    model.init_layers(seed=0)
    return model, tok, pos


def timed_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def graphed_vs_eager(ft, label, call, steps, tokens):
    """``call`` through the decode graphs (a first call of the signature:
    eager first step and capture; then a replayed call) and eagerly;
    returns (outputs, replayed call ms), having checked them equal."""
    def parts(x):
        return x if isinstance(x, tuple) else (x,)

    first, first_ms = timed_ms(call)
    out, ms = timed_ms(call)
    with ft.disable_graphs():
        eager, eager_ms = timed_ms(call)
    for got in (first, out):
        check(all(np.array_equal(a, b) for a, b in zip(parts(got), parts(eager))),
              f"{label}: graphed and eager outputs differ")
    log(f"[decode] {label}: graphed {ms:.1f} ms a call ({ms / steps:.4f} ms a step, "
        f"{tokens / ms * 1e3:,.0f} tokens/s), first call {first_ms:.1f} ms (eager first step "
        f"and capture), eager {eager_ms:.1f} ms ({eager_ms / steps:.4f} ms a step); graphed == "
        "eager: True")
    return out, ms


def profile_decode(model, label, call, steps):
    """Device ms and kernel launches per decode step of one replayed call."""
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows if not r[0].startswith("Memcpy"))
    log(f"[decode] {label}, profiled: device {busy_us / steps / 1e3:.4f} ms a step, "
        f"{launches / steps:.1f} kernel launches a step ({len(rows)} kernel names)")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:6]:
        log(f"[decode]   {us / steps / 1e3:8.4f} ms/step {count / steps:5.1f}x/step  {key[:90]}")
    return busy_us / steps / 1e3, launches / steps


def f32_probs(model, tok, pos, seqs):
    """Full-sequence forward probabilities (float32, on the card) of up to
    LM["batch"] token rows, zero-padded to the model's sequence length."""
    B, S = LM["batch"], LM["seq_length"]
    toks = np.zeros((B, S), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    posa = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    model.set_batch({tok: toks, pos: posa}, np.zeros((B, S), np.int32))
    return model._eval()[model.final_tensor().guid]


def gap(probs_row, a, b):
    """The probabilities of tokens a and b, as a share of the top one."""
    top = float(probs_row.max())
    return abs(float(probs_row[a]) - float(probs_row[b])) / top


def oracle_check(ft, build_transformer, kernels, prompt, smi):
    """(a), f32: generate, then one full-sequence forward (K3) over prompt +
    generated tokens; its argmax at every decoded position must be the
    generated token, or within F32_GAP_TOL of it.  Returns the kernels'
    launches in that forward."""
    P, N = GEN["P"], GEN["N"]
    model, tok, pos = decode_lm(ft, build_transformer, "float32")
    out = model.generate(prompt, N)
    model._gen_cache.clear()
    reset_launches(kernels)
    probs = f32_probs(model, tok, pos, np.concatenate([prompt, out], axis=1))
    launches = read_launches(kernels)
    check(launches == {**NO_LAUNCH, "flash_fwd": LM["num_layers"]},
          f"oracle forward launches {launches}")
    dec = probs[:, P - 1:P + N - 1]                     # predicts tokens P..P+N-1
    arg = dec.argmax(-1).cpu().numpy()
    diff = np.argwhere(arg != out)
    worst = 0.0
    for b, t in diff:
        g = gap(dec[b, t], arg[b, t], out[b, t])
        worst = max(worst, g)
        log(f"[decode]   oracle: row {b} position {P + t}: forward argmax {arg[b, t]}, "
            f"decoded {out[b, t]}, gap {g:.3e} of the top probability")
    check(worst <= F32_GAP_TOL, f"f32 oracle gap {worst:.3e} > {F32_GAP_TOL}")
    log(f"[decode] (a) f32 oracle: {LM['batch']}x{P + N} full forward through K3 "
        f"({launches['flash_fwd']} launches) against f32 generate: {arg.size - len(diff)} of "
        f"{arg.size} argmaxes equal the decoded tokens, the rest within gap {worst:.3e} "
        f"(tolerance {F32_GAP_TOL:g} of the top probability; TF32 off); card {smi}")
    return launches, model, tok, pos


def bf16_oracle(f32, label, seqs, starts, smi):
    """Every token a bf16 path generated (``seqs[i][starts[i]:]``) against
    the f32 model's full forward over the same token rows, 16 rows a
    forward: the token's f32 probability lies within BF16_GAP_TOL of the
    forward's top one at every generated position."""
    model, tok, pos = f32
    worst, count, differ = 0.0, 0, 0
    for j in range(0, len(seqs), LM["batch"]):
        chunk = seqs[j:j + LM["batch"]]
        probs = f32_probs(model, tok, pos, chunk)
        for row, s in enumerate(chunk):
            st = starts[j + row]
            p = probs[row, st - 1:len(s) - 1]                # predicts s[st:]
            want = torch.as_tensor(s[st:], dtype=torch.long, device=p.device)
            top = p.max(-1).values
            g = (top - p.gather(1, want[:, None])[:, 0]) / top
            worst = max(worst, float(g.max()))
            differ += int((g > 0).sum())
            count += want.numel()
    check(worst <= BF16_GAP_TOL, f"{label}: bf16 tokens against the f32 forward: gap "
                                 f"{worst:.3e} > {BF16_GAP_TOL}")
    log(f"[serve] {label} against the f32 full forward at every generated position: "
        f"{count - differ} of {count} tokens are its argmax, the rest within gap {worst:.3e} "
        f"(tolerance {BF16_GAP_TOL:g} of the top probability; TF32 off); card {smi}")


def traffic():
    """TRAFFIC from numpy seed 0: random prompts and lengths, then requests
    that share one prefix."""
    rng = np.random.default_rng(0)
    T = TRAFFIC
    reqs = [(rng.integers(0, LM["vocab_size"], size=int(rng.integers(T["prompt"][0],
                                                                     T["prompt"][1] + 1)),
                          dtype=np.int32), int(rng.integers(T["new"][0], T["new"][1] + 1)))
            for _ in range(T["requests"])]
    prefix = rng.integers(0, LM["vocab_size"], size=T["prefix"], dtype=np.int32)
    for _ in range(T["shared"]):
        tail = rng.integers(0, LM["vocab_size"], size=int(rng.integers(1, T["tail"] + 1)),
                            dtype=np.int32)
        reqs.append((np.concatenate([prefix, tail]),
                     int(rng.integers(T["new"][0], T["new"][1] + 1))))
    return reqs


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) * 1e3


def serve(ft, lm, paged, reqs, smi):
    """(d): one engine, warmed up, serving every request submitted at once;
    returns (tokens per request, the engine)."""
    from flexflow_tpu_torch.runtime.decode_graph import cache_leaves
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    free_models()
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine(lm, paged=paged, **ENGINE)
    check(eng._paged == (paged == "on"), f"engine paged={paged}: {eng._paged}")
    t0 = time.perf_counter()
    warm = eng.warmup()
    warm_s = time.perf_counter() - t0
    hs = [eng.submit(p, n, timeout_s=0) for p, n in reqs]
    t0 = time.perf_counter()
    with eng:
        outs = [h.result(600) for h in hs]
    wall = time.perf_counter() - t0
    st = eng.stats()
    check(st["completed"] == len(reqs), f"engine paged={paged}: {st}")
    check(st["graphs_captured"] == warm, f"engine paged={paged}: {st['graphs_captured']} "
                                         f"graphs captured, {warm} in the warm-up")
    kv_bytes = sum(c.numel() * c.element_size() for c in cache_leaves(eng._caches))
    ttft = [h.ttft_s for h in hs]
    tpot = [h.tpot_s for h in hs if h.tpot_s is not None]
    kv = st.get("kv", {})
    log(f"[serve] (d) engine {'paged' if eng._paged else 'dense'}: {len(reqs)} requests, "
        f"{st['tokens_out']} tokens in {wall:.3f} s = {st['tokens_out'] / wall:,.1f} generated "
        f"tokens/s; TTFT p50 {pct(ttft, 50):.1f} ms p99 {pct(ttft, 99):.1f} ms; TPOT p50 "
        f"{pct(tpot, 50):.2f} ms p99 {pct(tpot, 99):.2f} ms; mean occupancy "
        f"{st['mean_occupancy']:.2f} of {ENGINE['max_batch']}, {st['step_iterations']} token "
        f"boundaries; card {smi}")
    log(f"[serve]   graphs captured {warm} in the warm-up ({warm_s:.2f} s), "
        f"{st['graphs_captured'] - warm} after it; prefill signatures "
        f"{st['prefill_compiles']}; prefix hits {kv.get('prefix_hits', 0)} "
        f"({kv.get('prefill_tokens_saved', 0)} prefill tokens saved, "
        f"{kv.get('cow_copies', 0)} copy-on-write tails); KV pool {kv_bytes / 2**20:.1f} MiB; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return outs, eng


def engine_vs_generate(lm, f32, reqs, outs, smi):
    """(d): each request against generate(prompt[None], n) of the bf16
    model; a request that differs is reported with the f32 gap at its first
    differing token, which must be within BF16_GAP_TOL."""
    model, tok, pos = f32
    diffs = []
    t0 = time.perf_counter()
    for i, ((p, n), got) in enumerate(zip(reqs, outs)):
        want = lm.generate(p[None], n)[0]
        if not np.array_equal(got, want):
            k = int(np.argmax(got != want))  # no eos: both are n long
            diffs.append((i, k, int(got[k]), int(want[k])))
    gen_s = time.perf_counter() - t0
    lm._gen_cache.clear()
    worst = 0.0
    for j in range(0, len(diffs), LM["batch"]):
        chunk = diffs[j:j + LM["batch"]]
        seqs = [np.concatenate([reqs[i][0], outs[i][:k]]) for i, k, _, _ in chunk]
        probs = f32_probs(model, tok, pos, seqs)
        for row, (i, k, a, b) in enumerate(chunk):
            g = gap(probs[row, len(seqs[row]) - 1], a, b)
            worst = max(worst, g)
            log(f"[serve]   request {i}: first differs at token {k} (engine {a}, generate "
                f"{b}); f32 gap {g:.3e} of the top probability")
    check(worst <= BF16_GAP_TOL, f"engine vs generate: gap {worst:.3e} > {BF16_GAP_TOL}")
    log(f"[serve] (d) engine vs generate (bf16, B = 1 signatures, {gen_s:.1f} s): "
        f"{len(reqs) - len(diffs)} of {len(reqs)} requests equal; {len(diffs)} differ at a "
        f"near-tie, worst f32 gap {worst:.3e} (tolerance {BF16_GAP_TOL:g}); card {smi}")


def http_check(ft, lm, reqs):
    """(e): the ServingAPI on an ephemeral port in front of a paged engine
    that was not warmed up, so that it captures its graphs in its worker
    thread."""
    import urllib.request

    from flexflow_tpu_torch.serving.api import ServingAPI
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    picks = sorted(reqs, key=lambda r: r[0].size + r[1])[:8]
    eng = InferenceEngine(lm, paged="on", **ENGINE)
    with eng, ServingAPI(eng, port=0) as api:
        port = api.port
        for path in ("/healthz", "/readyz"):
            with urllib.request.urlopen(f"{api.url}{path}", timeout=60) as r:
                check(r.status == 200, f"{path}: {r.status}")
        t0 = time.perf_counter()
        for p, n in picks:
            body = json.dumps({"prompt": [int(t) for t in p], "max_new_tokens": n}).encode()
            req = urllib.request.Request(f"{api.url}/generate", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                got = np.asarray(json.loads(r.read())["tokens"], np.int32)
            # the same request straight to the engine, alone as it was
            check(np.array_equal(got, eng.submit(p, n).result(300)),
                  "HTTP and engine tokens differ")
        ms = (time.perf_counter() - t0) * 1e3
    log(f"[serve] (e) ServingAPI on port {port}: 8 POST /generate equal the engine's tokens "
        f"for the same requests ({ms:.0f} ms for both, one at a time); /healthz and /readyz "
        f"200; {eng.graphs_captured()} graphs captured in the engine's worker thread")


def serving_phase(ft, kernels, smi):
    """Phase 10: decoding and serving at full width.  Returns the kernels'
    wrapper launches: none on the decode paths (checked), K3 in the f32
    oracle's forward."""
    from flexflow_tpu_torch.models import nmt
    from flexflow_tpu_torch.models.transformer import build_transformer

    t_phase = t_lap = time.perf_counter()

    def lap(what):
        nonlocal t_lap
        now = time.perf_counter()
        log(f"[serve] {what} took {now - t_lap:.1f} s")
        t_lap = now

    free_models()
    rng = np.random.default_rng(0)
    B, V = LM["batch"], LM["vocab_size"]
    P, N = GEN["P"], GEN["N"]
    prompt = rng.integers(0, V, size=(B, P), dtype=np.int32)
    reset_launches(kernels)
    # (a) -----------------------------------------------------------------
    lm, _, _ = decode_lm(ft, build_transformer, "bfloat16")
    out, ms = graphed_vs_eager(ft, f"(a) transformer B{B} P{P} N{N} bf16 greedy generate",
                               lambda: lm.generate(prompt, N), P + N - 1, B * N)
    run = next(iter(lm._gen_cache.values()))
    log(f"[decode] (a) {ms / N:.4f} ms per generated token position ({B} rows), capture "
        f"{run.capture_s * 1e3:.1f} ms, {run.captures} graph; card {smi}")
    profile_decode(lm, "(a) generate", lambda: lm.generate(prompt, N), P + N - 1)
    lap("(a)")
    # (b) -----------------------------------------------------------------
    bp = prompt[:BEAM["B"], :BEAM["P"]]
    (seqs, scores), _ = graphed_vs_eager(
        ft, f"(b) beam_search K{BEAM['K']} B{BEAM['B']} P{BEAM['P']} N{BEAM['N']}",
        lambda: lm.beam_search(bp, BEAM["N"], beam_size=BEAM["K"]),
        BEAM["P"] + BEAM["N"] - 1, BEAM["B"] * BEAM["N"])
    check(bool(np.isfinite(scores).all()) and bool((np.diff(scores, axis=1) <= 0).all()),
          f"beam scores not finite and best first: {scores}")
    kw = dict(SAMPLING)
    sp, sn = SAMPLED["P"], SAMPLED["N"]
    sampled, _ = graphed_vs_eager(ft, f"(b) sampled generate B{B} P{sp} N{sn} {kw}",
                                  lambda: lm.generate(prompt[:, :sp], sn, **kw), sp + sn - 1,
                                  B * sn)
    # every token within its step's top-k: the probabilities the step saw,
    # recomputed by eager decode steps at the same shapes
    tok_t, pos_t = lm.resolve_decode_inputs()
    caches = lm.init_decode_caches(B, sp + sn)
    seq = torch.tensor(np.concatenate([prompt[:, :sp], sampled], axis=1), device=lm.device)
    outside = 0
    for t in range(sp + sn - 1):
        probs, _ = lm.decode_step(lm._params, caches, seq[:, t], t, tok_t, pos_t)
        if t >= sp - 1:  # step t drew token t + 1
            kth = torch.sort(probs, dim=-1, descending=True).values[:, kw["top_k"] - 1]
            outside += int((probs.gather(1, seq[:, t + 1:t + 2])[:, 0] < kth).sum())
    check(outside == 0, f"{outside} sampled tokens outside their step's top-{kw['top_k']}")
    log(f"[decode] (b) sampled: every one of the {B * sn} tokens within its step's top-"
        f"{kw['top_k']} (eager decode steps recompute the probabilities)")
    del caches
    lm._gen_cache.clear()
    lap("(b)")
    # (c) -----------------------------------------------------------------
    moe, _, _ = decode_lm(ft, build_transformer, "bfloat16", moe_every=2, num_experts=8)
    mp = prompt[:, :MOE_GEN["P"]]
    _, ms = graphed_vs_eager(ft, f"(c) MoE transformer B{B} P{MOE_GEN['P']} N{MOE_GEN['N']}",
                             lambda: moe.generate(mp, MOE_GEN["N"]),
                             MOE_GEN["P"] + MOE_GEN["N"] - 1, B * MOE_GEN["N"])
    log(f"[decode] (c) MoE {ms / MOE_GEN['N']:.4f} ms per generated token position; card {smi}")
    del moe
    free_models()
    nm = ft.FFModel(ft.FFConfig(batch_size=NMT_GEN["batch"], compute_dtype="bfloat16"))
    src, dst, _ = nmt.build_nmt(nm, NMT_GEN["batch"], seq_length=NMT_GEN["seq_length"])
    nm.compile(ft.AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy", ["accuracy"])
    nm.init_layers(seed=0)
    src_toks = rng.integers(0, 20 * 1024, size=(NMT_GEN["batch"], NMT_GEN["seq_length"]),
                            dtype=np.int32)

    def translate():
        return nmt.greedy_translate(nm, src, dst, src_toks, NMT_GEN["max_len"])

    _, ms = graphed_vs_eager(ft, f"(c) NMT greedy_translate B{NMT_GEN['batch']} seq "
                                 f"{NMT_GEN['seq_length']} hidden 2048 vocab 20480",
                             translate, NMT_GEN["max_len"], NMT_GEN["batch"] * NMT_GEN["max_len"])
    log(f"[decode] (c) NMT {ms / NMT_GEN['max_len']:.4f} ms per generated token position; "
        f"card {smi}")
    profile_decode(nm, "(c) NMT", translate, NMT_GEN["max_len"])
    del nm
    lap("(c)")
    # (d) -----------------------------------------------------------------
    reqs = traffic()
    outs = {}
    for paged in ("off", "on"):
        outs[paged], eng = serve(ft, lm, paged, reqs, smi)
    same = sum(np.array_equal(a, b) for a, b in zip(outs["off"], outs["on"]))
    check(same == len(reqs), f"dense and paged engines differ on {len(reqs) - same} requests")
    log(f"[serve] (d) dense == paged: all {len(reqs)} requests equal")
    lap("(d)")
    del eng
    # (e) -----------------------------------------------------------------
    http_check(ft, lm, reqs)
    lap("(e)")
    decode_launches = read_launches(kernels)
    check(decode_launches == NO_LAUNCH, f"decode paths launched {decode_launches}")
    # the f32 oracle and the engine's gaps ---------------------------------
    oracle_launches, model, tok, pos = oracle_check(ft, build_transformer, kernels, prompt,
                                                    smi)
    lap("the f32 oracle")
    bf16_oracle((model, tok, pos), "(a) bf16 generate",
                list(np.concatenate([prompt, out], axis=1)), [P] * B, smi)
    bf16_oracle((model, tok, pos), "(d) engine",
                [np.concatenate([p, o]) for (p, _), o in zip(reqs, outs["on"])],
                [p.size for p, _ in reqs], smi)
    lap("the bf16 oracle")
    engine_vs_generate(lm, (model, tok, pos), reqs, outs["on"], smi)
    lap("engine vs generate")
    del lm, model
    free_models()
    log(f"[serve] phase 10 took {time.perf_counter() - t_phase:.1f} s; wrapper launches on "
        f"the decode paths {decode_launches}, in the oracle's forward {oracle_launches}")
    return oracle_launches


# ------------------------------------------------------------------ phase 11

OBS_STEPS = 20
OBS_WINDOW = (2, 10)    # steps timed by CUDA events: after the capture, before a drain
OBS_DRAINS = (9, 19)    # get_metrics after these steps: the losses compared bitwise
OBS_ENV = {"FF_TELEMETRY": "1", "FF_HEALTH": "1", "FF_HEALTH_SAMPLE_EVERY": "10",
           "FF_MEMPLANE": "1", "FF_OPPROF": "10", "FF_OPPROF_BUDGET_S": "30",
           "FF_METRICS_HOST": "127.0.0.1"}
OBS_REQUESTS = 16
# the step spans' median (device time of each replay) against the phase's
# own CUDA-event ms/step over the window (replays back to back)
OBS_SPAN_TOL = 0.10


@contextlib.contextmanager
def environ(env):
    """``env`` set for the block; the telemetry singletons closed after it."""
    from flexflow_tpu_torch.observability import events, metrics

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
        events.reset_active()
        metrics.stop()


def obs_lm_run(ft, build_transformer, synthetic_lm_batch, label):
    """OBS_STEPS compiled steps of the full-width transformer: (mean losses
    at OBS_DRAINS, CUDA-event ms/step over OBS_WINDOW, every weight, model)."""
    model = lm_model(ft, build_transformer, synthetic_lm_batch,
                     lambda m: ft.SGDOptimizer(m, lr=0.001), **LM)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    losses = []
    for step in range(OBS_STEPS):
        if step == OBS_WINDOW[0]:
            model.sync()
            start.record()
        model.train_iteration()
        if step == OBS_WINDOW[1] - 1:
            end.record()
        if step in OBS_DRAINS:
            model.get_metrics()
            losses.append(model.last_loss)
    model.sync()
    check_graph_run(model, OBS_STEPS, label)
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite losses {losses}")
    ms = start.elapsed_time(end) / (OBS_WINDOW[1] - OBS_WINDOW[0])
    return losses, ms, state_of(model), model


def obs_trace_gates(model, trace, ms, launches_off, launches_on, smi):
    """Gates (b)-(f) on the traced run's records."""
    import urllib.request

    from flexflow_tpu_torch.observability import metrics
    from flexflow_tpu_torch.simulator.cost_model import MEASURE_ITERS, MEASURE_WARMUP
    from flexflow_tpu_torch.tools import trace_report

    recs = trace_report.parse_trace(trace)
    steps = [r for r in recs if r.get("t") == "span" and r["name"] == "step"]
    # (f) one step span per step, folded by the port's reader
    report = trace_report.render_report(recs)
    check(len(steps) == OBS_STEPS, f"(f) {len(steps)} step spans for {OBS_STEPS} steps")
    firsts = [s["attrs"]["step"] for s in steps if s["attrs"]["first"]]
    check(firsts == [0, 1] and steps[1]["attrs"].get("capture") is True,
          f"(f) first/capture steps {firsts}")
    check(f"steady-state over {OBS_STEPS - 2} steps" in report, "(f) trace_report: "
          + report[:600])
    # (b) the step spans against the phase's own events
    steady = [s for s in steps if not s["attrs"]["first"]]
    span_ms = float(np.median([s["dur"] for s in steady])) * 1e3
    sps = float(np.median([s["attrs"]["samples_per_sec"] for s in steady]))
    want_sps = LM["batch"] / ms * 1e3
    mfu = [s["attrs"]["mfu"] for s in steady]
    check(abs(span_ms - ms) <= OBS_SPAN_TOL * ms,
          f"(b) median step span {span_ms:.4f} ms vs {ms:.4f} ms/step by CUDA events")
    check(abs(sps - want_sps) <= OBS_SPAN_TOL * want_sps,
          f"(b) samples_per_sec {sps:.2f} vs {want_sps:.2f}")
    check(all(0.0 < x < 1.0 for x in mfu), f"(b) MFU {min(mfu)}..{max(mfu)}")
    hbm = [r for r in recs if r.get("name") == "hbm_bytes"
           and r["attrs"]["kind"] in ("in_use", "peak")]
    check(hbm and all(0 < r["v"] <= 80e9 for r in hbm),
          f"(b) hbm_bytes {[r['v'] for r in hbm]}")
    log(f"[obs] (b) median step span {span_ms:.4f} ms (device time of one replay) vs "
        f"{ms:.4f} ms/step by the phase's CUDA events over steps {OBS_WINDOW[0]}-"
        f"{OBS_WINDOW[1] - 1}: {abs(span_ms - ms) / ms:.2%} apart (tolerance "
        f"{OBS_SPAN_TOL:.0%}); samples_per_sec {sps:.2f} vs {want_sps:.2f}; MFU "
        f"{float(np.median(mfu)):.4f} of 989e12 bf16 dense; hbm_bytes in use "
        f"{max(r['v'] for r in hbm if r['attrs']['kind'] == 'in_use') / 2**30:.2f} GiB, "
        f"peak {max(r['v'] for r in hbm if r['attrs']['kind'] == 'peak') / 2**30:.2f} GiB; "
        f"card {smi}")
    # (c) one capture at train_step, no retrace
    done = [r["attrs"] for r in recs if r.get("name") == "compile_done"]
    check([a["site"] for a in done] == ["train_step"] and not done[0]["retrace"]
          and (model._memplane.compiles, model._memplane.retraces) == (1, 0),
          f"(c) captures {done}")
    log(f"[obs] (c) capture ledger: 1 capture at train_step ({done[0]['wall_s'] * 1e3:.1f} "
        f"ms host, graph pool {done[0]['graph_pool_bytes'] / 2**20:.1f} MiB), 0 "
        f"compile_retraces over {OBS_STEPS} steps")
    # (d) opprof measured every attention op, through K3-K5
    rt = [r["attrs"] for r in recs if r.get("name") == "op_runtime"]
    attn = sorted({a["op"] for a in rt if a["op"].startswith("attn")})
    check(len(attn) == LM["num_layers"] and all(
        a["measured_ms"] > 0 for a in rt if a["op"] in attn), f"(d) op_runtime {rt}")
    per_op = MEASURE_WARMUP + MEASURE_ITERS
    for k in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        check(launches_on[k] - launches_off[k] == per_op * len(attn),
              f"(d) {k}: {launches_on[k]} launches traced, {launches_off[k]} untraced; "
              f"expected {per_op} more per measured attention op")
    (passes,) = [r["attrs"] for r in recs if r.get("name") == "op_runtime_pass"]
    log(f"[obs] (d) opprof pass at step {passes['step']}: {passes['ops_measured']} of "
        f"{passes['ops_total']} ops in {passes['elapsed_s']:.2f} s; "
        + "; ".join(f"{a['op']} {a['which']} {a['measured_ms']:.4f} ms (predicted "
                    f"{a['predicted_ms']:.4f} ms, {a['src']})"
                    for a in rt if a["op"] == attn[0])
        + f"; K3-K5 each {per_op * len(attn)} more launches than untraced; card {smi}")
    top = sorted(rt, key=lambda a: -a["measured_ms"])[:6]
    for a in top:
        log(f"[obs]   {a['op']:>12s} {a['which']:8s} measured {a['measured_ms']:.4f} ms, "
            f"predicted {a['predicted_ms']:.4f} ms ({a['src']})")
    # (e) the live /metrics plane
    port = metrics.server_port()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
        status, text = r.status, r.read().decode()
    ff_lines = [ln for ln in text.splitlines() if ln.startswith("ff_")]
    check(status == 200 and ff_lines, f"(e) /metrics {status}: {text[:300]}")
    log(f"[obs] (e) GET /metrics on :{port}: 200, {len(ff_lines)} ff_ series lines "
        f"(e.g. {[ln for ln in ff_lines if ln.startswith('ff_samples_total')]})")


def obs_guard(ft, build_alexnet, trace):
    """(g): full-width AlexNet under the guard, traced: a batch with a NaN
    replayed through the captured step gives one health nonfinite_loss and
    one step_skipped event, and leaves every weight bitwise as it was."""
    from flexflow_tpu_torch.tools import trace_report

    model = main_model(ft, build_alexnet, sgd_optimizer(ft), batch=BATCH)
    inp = model.input_tensors[0]
    x = np.random.default_rng(1).standard_normal((BATCH,) + inp.dims[1:], dtype=np.float32)
    y = model._batch["label"].cpu().numpy()
    model.set_batch({inp: x}, y)
    for _ in range(2):
        model.train_iteration()
    before = state_of(model)
    x[1, 3, 2, 1] = np.nan
    model.set_batch({inp: x}, y)
    model.train_iteration()
    model.get_metrics()
    model.sync()
    check_graph_run(model, 3, "(g) AlexNet")
    _, bitwise = compare_states(before, state_of(model), dict(rtol=0, atol=0), "(g)")
    recs = trace_report.parse_trace(trace)
    health = [r["attrs"] for r in recs if r.get("name") == "health"
              and r["attrs"]["kind"] == "nonfinite_loss"]
    skipped = [r["attrs"] for r in recs if r.get("name") == "step_skipped"]
    check(bitwise and len(health) == 1 and health[0]["count"] == 1
          and len(skipped) == 1 and skipped[0]["count"] == 1,
          f"(g) bitwise {bitwise}, health {health}, step_skipped {skipped}")
    log(f"[obs] (g) AlexNet batch {BATCH}, a NaN batch replayed under FF_SKIP_NONFINITE: one "
        f"health nonfinite_loss event ({health[0]}), one step_skipped event ({skipped[0]}); "
        f"every weight and slot ({len(before)} leaves) bitwise unchanged")


def obs_serving(ft, build_transformer, tmp, smi):
    """(h): phase 10's engine configuration, OBS_REQUESTS of its requests,
    without telemetry and then traced with FF_TRACE_SAMPLE=1 and the
    capture ledger: the same tokens, a trace id on every request, one
    serve_request_done each, no capture after warmup(), and /metrics on
    the API server."""
    import urllib.request

    from flexflow_tpu_torch.observability.events import EventLog
    from flexflow_tpu_torch.serving.api import ServingAPI
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.tools import trace_report

    lm, _, _ = decode_lm(ft, build_transformer, "bfloat16")
    reqs = traffic()[:OBS_REQUESTS]
    out = {}
    for traced in (False, True):
        path = os.path.join(tmp, "serve.jsonl")
        log_ = EventLog(path) if traced else None
        env = {"FF_TRACE_SAMPLE": "1", "FF_MEMPLANE": "1"} if traced else {}
        with environ(env):
            eng = InferenceEngine(lm, telemetry=log_, **ENGINE)
            warm = eng.warmup()
            hs = [eng.submit(p, n, timeout_s=0) for p, n in reqs]
            t0 = time.perf_counter()
            with eng, ServingAPI(eng, port=0) as api:
                toks = [h.result(600) for h in hs]
                wall = time.perf_counter() - t0
                with urllib.request.urlopen(f"{api.url}/metrics", timeout=60) as r:
                    status, text = r.status, r.read().decode()
        st = eng.stats()
        check(status == 200 and any(ln.startswith("ff_") for ln in text.splitlines()),
              f"(h) API /metrics {status}: {text[:300]}")
        check(st["graphs_captured"] == warm, f"(h) {st['graphs_captured']} captures, {warm} "
                                             "in the warm-up")
        out[traced] = toks
        log(f"[obs] (h) engine {'traced' if traced else 'untraced'}: {len(reqs)} requests, "
            f"{st['tokens_out']} tokens in {wall:.3f} s ({st['tokens_out'] / wall:,.1f} "
            f"tokens/s); API /metrics 200; card {smi}")
        if not traced:
            continue
        log_.close()
        recs = trace_report.parse_trace(path)
        done = [r["attrs"] for r in recs if r.get("name") == "serve_request_done"]
        ids = {h.trace.trace_id for h in hs if h.trace is not None}
        check(len(ids) == len(reqs) and len(done) == len(reqs)
              and {a["trace_id"] for a in done} == ids,
              f"(h) {len(ids)} trace ids, {len(done)} serve_request_done records")
        check(eng._memplane.retraces == 0 and eng._memplane.compiles == warm,
              f"(h) ledger {eng._memplane.compiles} captures, {eng._memplane.retraces} "
              f"retraces; {warm} in the warm-up")
        chunks = sum(r.get("name") == "serve_decode_chunk" for r in recs)
        log(f"[obs] (h) every request traced and sampled: {len(done)} serve_request_done, "
            f"{chunks} serve_decode_chunk spans; ledger {warm} captures in warmup(), 0 "
            "retraces")
    same = all(np.array_equal(a, b) for a, b in zip(out[False], out[True]))
    check(same, "(h) the traced engine's tokens differ from the untraced one's")
    log(f"[obs] (h) the traced engine's tokens equal the untraced engine's on all "
        f"{len(reqs)} requests")
    del lm, eng
    free_models()


def observability_phase(ft, build_alexnet, build_transformer, synthetic_lm_batch, kernels,
                        smi):
    """Phase 11: telemetry on the card.  Returns the kernels' launches."""
    t0 = time.perf_counter()
    reset_launches(kernels)
    free_models()
    off_losses, off_ms, off_state, _ = obs_lm_run(ft, build_transformer, synthetic_lm_batch,
                                                  "(a) untraced")
    launches_off = read_launches(kernels)
    free_models()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "ff_trace.jsonl")
        env = dict(OBS_ENV, FF_TELEMETRY_FILE=trace, FF_METRICS_PORT=str(free_port()),
                   # opprof's measurements go to a temporary corpus, never the
                   # committed measured_h100.json
                   FF_OPPROF_CORPUS=os.path.join(tmp, "corpus.json"))
        with environ(env):
            on_losses, on_ms, on_state, model = obs_lm_run(
                ft, build_transformer, synthetic_lm_batch, "(a) traced")
            launches_on = {k: v - launches_off[k] for k, v in read_launches(kernels).items()}
            _, bitwise = compare_states(off_state, on_state, dict(rtol=0, atol=0), "(a)")
            check(on_losses == off_losses and bitwise,
                  f"(a) losses {on_losses} traced vs {off_losses} untraced; weights bitwise "
                  f"{bitwise}")
            log(f"[obs] (a) transformer (phase 4's, B{LM['batch']} S{LM['seq_length']}), "
                f"{OBS_STEPS} compiled steps, telemetry off then FF_TELEMETRY=1 FF_HEALTH=1 "
                f"FF_MEMPLANE=1 FF_OPPROF=10 FF_METRICS_PORT: losses {on_losses} bitwise equal, "
                f"every weight ({len(on_state)} leaves) bitwise equal; ms/step by CUDA events "
                f"off {off_ms:.4f}, on {on_ms:.4f} ({on_ms / off_ms - 1:+.2%}, not gated); "
                f"card {smi}")
            obs_trace_gates(model, trace, on_ms, launches_off, launches_on, smi)
            del model
            free_models()
            with environ({"FF_SKIP_NONFINITE": "3"}):
                obs_guard(ft, build_alexnet, trace)
        free_models()
        obs_serving(ft, build_transformer, tmp, smi)
    launches = read_launches(kernels)
    log(f"[obs] phase 11 took {time.perf_counter() - t0:.1f} s; wrapper launches {launches}")
    return launches


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    # --calibration-out DIR keeps phase 8's measured cache and fit (else a
    # temporary directory holds them)
    calibration_out = argv[argv.index("--calibration-out") + 1] \
        if "--calibration-out" in argv else None
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if os.environ.get(SOAP_HELPER):
        return soap_helper()
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_optimizer as fo
    from flexflow_tpu_torch.models.alexnet import build_alexnet
    from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch

    kernels = kernel_wrappers(fo, fa)
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
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products

    # phase 2 ------------------------------------------------------------
    build_kernels(fo, fa)

    # phase 3 ------------------------------------------------------------
    leaf_sets = main_path_leaves(ft, build_alexnet, build_transformer)
    log("[kernels] kernel vs plain PyTorch version, tolerance rtol=atol=1e-6 "
        "(both run the same rounded f32 operations; built with -fmad=false)")
    max_err = check_kernels(fo)
    max_err["fused_sgd_update"] = max(max_err["fused_sgd_update"], check_sgd_multi(fo))
    copy_gbps = copy_bandwidth_gbps()
    log(f"[kernels] measured device copy rate {copy_gbps:.1f} GB/s (1 GiB copy_)")
    rows = time_kernels(fo, leaf_sets, copy_gbps)
    launch_diagnostics(fo, {name: len(shapes) for name, shapes in leaf_sets.items()},
                       max(math.prod(s) for s in leaf_sets["AlexNet"]))
    log("[kernels] flash kernels vs plain PyTorch versions on the same inputs, "
        "tolerance f32 rtol=atol=1e-4 (summation order), bf16 rtol=2**-7 atol=1e-3 "
        "(one bf16 rounding of f32 results; lse f32)")
    max_err.update(check_flash(fa))
    flash_rows = time_flash(fa)
    time_flash(fa, head_dim=16)

    # phase 4 ------------------------------------------------------------
    reset_launches(kernels)
    free_models()
    torch.cuda.reset_peak_memory_stats()
    sgd_run = train_main_path(ft, build_alexnet, fo, sgd_optimizer(ft), steps=7, timed_from=2)
    torch.cuda.empty_cache()
    adam_run = train_main_path(ft, build_alexnet, fo, adam_optimizer(ft), steps=5, timed_from=2)
    alex_launches = read_launches(kernels)
    # the eager first step and the capture call the wrappers; replays do not
    check(alex_launches == {"fused_sgd_update": 2, "fused_adam_update": 16 * 2,
                            "flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0},
          f"AlexNet launch counts {alex_launches}")
    peak = torch.cuda.max_memory_allocated()
    for label, r in (("SGD momentum 0.9", sgd_run), ("Adam", adam_run)):
        log(f"[main] AlexNet 3x229x229 batch {BATCH} bf16 fused, {label}: "
            f"losses {['%.4f' % x for x in r['losses']]}  "
            f"{r['samples_per_s']:.1f} samples/s  {r['ms_per_step']:.2f} ms/step  "
            f"{r['metrics']}")
    MEASURED["alexnet"]["peak_gib"] = peak / 2**30
    log(f"[main] max_memory_allocated {peak / 2**30:.2f} GiB; launches {alex_launches}; "
        f"card {smi}")
    profile_steps(main_model(ft, build_alexnet, sgd_optimizer(ft)), "AlexNet SGD",
                  sgd_run["ms_per_step"], per_step=ALEX_SGD_STEP)
    torch.cuda.empty_cache()

    reset_launches(kernels)
    free_models()
    torch.cuda.reset_peak_memory_stats()
    lm, lm_run = train_transformer(ft, build_transformer, synthetic_lm_batch, kernels)
    lm_launches = read_launches(kernels)
    per_layer = 2 * LM["num_layers"]  # the eager first step and the capture
    # predict_batch's forward adds one flash_fwd launch per layer
    check(lm_launches == {"fused_sgd_update": 2, "fused_adam_update": 0,
                          "flash_fwd": per_layer + LM["num_layers"],
                          "flash_bwd_dkdv": per_layer, "flash_bwd_dq": per_layer},
          f"transformer launch counts {lm_launches}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] transformer batch {LM['batch']} S {LM['seq_length']} {LM['num_layers']}x"
        f"{LM['embed_dim']} {LM['num_heads']} heads vocab {LM['vocab_size']} bf16 fused SGD "
        f"lr 0.001: losses {['%.5f' % x for x in lm_run['losses']]}  "
        f"{lm_run['samples_per_s']:.2f} samples/s  {lm_run['tokens_per_s']:.0f} tokens/s  "
        f"{lm_run['ms_per_step']:.2f} ms/step  {lm_run['metrics']}")
    MEASURED["transformer"]["peak_gib"] = peak / 2**30
    log(f"[main] transformer max_memory_allocated {peak / 2**30:.2f} GiB; launches "
        f"{lm_launches}; card {smi}")
    profile_steps(lm, "transformer SGD", lm_run["ms_per_step"], per_step=LM_SGD_STEP)
    del lm
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
    worst = lm_parity(ft, build_transformer, synthetic_lm_batch, fa, kernels)
    log(f"[parity] f32 transformer batch 2 S 128 2x128 2 heads, 2 SGD steps, flash "
        f"kernels vs plain versions: max |dw| {worst:.3e} (tolerance rtol 1e-4, atol 1e-5; "
        "TF32 off)")

    # phase 6 ------------------------------------------------------------
    soap_launches = soap_phase(ft, build_alexnet, build_transformer, synthetic_lm_batch,
                               kernels, smi)

    # phase 7 ------------------------------------------------------------
    compiled_step_phase(ft, build_alexnet, build_transformer, synthetic_lm_batch, smi)

    # phase 8 ------------------------------------------------------------
    with contextlib.ExitStack() as stack:
        out_dir = calibration_out or stack.enter_context(tempfile.TemporaryDirectory())
        search_launches = search_phase(ft, build_alexnet, kernels, smi, out_dir)

        # phase 9 ----------------------------------------------------------
        zoo_launches = models_phase(ft, fo, fa, kernels, smi, out_dir)

    # phase 10 -----------------------------------------------------------
    serve_launches = serving_phase(ft, kernels, smi)

    # phase 11 -----------------------------------------------------------
    obs_launches = observability_phase(ft, build_alexnet, build_transformer,
                                       synthetic_lm_batch, kernels, smi)

    # result -------------------------------------------------------------
    main_launches = {n: alex_launches[n] + lm_launches[n] + soap_launches[n]
                     + search_launches[n] + zoo_launches[n] + serve_launches[n]
                     + obs_launches[n] for n in kernels}
    table = []
    for kname, source, replaces in (
            ("fused_sgd_update", SOURCE, "flexflow_tpu/kernels/fused_optimizer.py:63"),
            ("fused_adam_update", SOURCE, "flexflow_tpu/kernels/fused_optimizer.py:110"),
            ("flash_fwd", FLASH_SOURCE, "flexflow_tpu/kernels/flash_attention.py:53"),
            ("flash_bwd_dkdv", FLASH_SOURCE, "flexflow_tpu/kernels/flash_attention.py:145"),
            ("flash_bwd_dq", FLASH_SOURCE, "flexflow_tpu/kernels/flash_attention.py:195")):
        r = flash_rows.get(kname) or dict(
            rows["fused_sgd_update mu=0.9" if kname == "fused_sgd_update" else kname],
            bound_by="bytes")
        table.append({"name": kname, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": main_launches[kname],
                      "max_abs_err": max_err[kname], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s; launches on the main paths: "
        f"AlexNet {alex_launches}, transformer {lm_launches}, SOAP {soap_launches}, "
        f"search {search_launches}, models {zoo_launches}, serving {serve_launches}, "
        f"observability {obs_launches}")
    log(smi)
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
