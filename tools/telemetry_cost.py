#!/usr/bin/env python3
"""What telemetry costs the transformer's compiled step on one NVIDIA H100.

    python3 tools/telemetry_cost.py [--rounds N]

chip_smoke.py's transformer (batch 16, S 512, 4x512, 8 heads, vocab
32000, bf16, fused SGD) through the compiled step in four settings, in
turns, N rounds: untraced; FF_TELEMETRY=1; FF_TELEMETRY=1 FF_HEALTH=1
(its sampled drain pushed past the window); FF_SKIP_NONFINITE=3 untraced
(the guard's device half, the same gradient-norm reduction).  For each:
ms/step by CUDA events over 10 replays back to back (after 4 warm-up
steps, three windows), and the profiler's device ms and kernel launches
per step over 5 replays.  Prints one line per setting and round, then the
medians, beside the card's name and power limit.  The trace goes to a
temporary directory.  Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import flexflow_tpu_torch as ft  # noqa: E402
from flexflow_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from flexflow_tpu_torch.kernels import fused_optimizer as fo  # noqa: E402
from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch  # noqa: E402

SETTINGS = (("untraced", {}),
            ("FF_TELEMETRY", {"FF_TELEMETRY": "1"}),
            ("FF_TELEMETRY+FF_HEALTH", {"FF_TELEMETRY": "1", "FF_HEALTH": "1",
                                        "FF_HEALTH_SAMPLE_EVERY": "1000"}),
            ("FF_SKIP_NONFINITE", {"FF_SKIP_NONFINITE": "3"}))


def measure(env):
    """(event-timed ms/step of three 10-step windows, profiled device ms
    and launches per step)."""
    with cs.environ(env):
        model = cs.lm_model(ft, build_transformer, synthetic_lm_batch,
                            lambda m: ft.SGDOptimizer(m, lr=0.001), **cs.LM)
        for _ in range(4):
            model.train_iteration()
        model.sync()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        windows = []
        for _ in range(3):
            start.record()
            for _ in range(10):
                model.train_iteration()
            end.record()
            end.synchronize()
            windows.append(start.elapsed_time(end) / 10)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(5):
                model.train_iteration()
            model.sync()
        rows = [(e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        model.sync()
    del model
    cs.free_models()
    return windows, sum(r[0] for r in rows) / 5e3, sum(r[1] for r in rows) / 5


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_kernels(fo, fa)
    smi = cs.nvidia_smi_line()
    got = {name: [] for name, _ in SETTINGS}
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(args.rounds):
            order = SETTINGS if r % 2 == 0 else SETTINGS[::-1]
            for name, env in order:
                env = dict(env, FF_TELEMETRY_FILE=os.path.join(tmp, "t.jsonl"))
                windows, dev_ms, launches = measure(env)
                got[name].append((windows, dev_ms, launches))
                print(f"[cost] round {r} {name}: {' '.join('%.4f' % w for w in windows)} "
                      f"ms/step by CUDA events; profiled device {dev_ms:.4f} ms and "
                      f"{launches:.0f} launches a step", flush=True)
    base = statistics.median(w for ws, _, _ in got["untraced"] for w in ws)
    for name, _ in SETTINGS:
        ms = statistics.median(w for ws, _, _ in got[name] for w in ws)
        dev = statistics.median(d for _, d, _ in got[name])
        launches = statistics.median(n for _, _, n in got[name])
        print(f"[cost] {name}: median {ms:.4f} ms/step ({ms / base - 1:+.2%} on untraced), "
              f"device {dev:.4f} ms, {launches:.0f} launches a step; card {smi}")


if __name__ == "__main__":
    main()
