#!/usr/bin/env python3
"""Where a hetero DLRM step goes on a mesh of NVIDIA H100s.

    python3 tools/hetero_dlrm_profile.py

chip_smoke.py's DLRM (batch 256, 8 tables of 1,000,000 x 64, bf16, fused
SGD) on an NCCL mesh of one rank per visible card (up to 4; a one-rank
mesh on a machine of one card, which runs the same several-rank host-table
path: the ids' all-gather, the owned rows' all-reduce): first with its
tables in pinned host memory (``tools/dlrm_strategy.py --hetero``,
row-sparse), then on the card.  For each, after 3 warm-up steps: ms/step
over 5 eager mesh steps ending in a synchronize, the host ms a step spent
in the host tables' methods (``HostTables.swap_in``, ``_unique``,
``_rows``, ``scatter_back``, ``join``), and on the lead rank the
profiler's table of the 25 costliest ops by host time over 2 steps.  The
card's name and power limit lead the output.  Needs the cards and nvcc.
"""

from __future__ import annotations

import collections
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TIMED = ("swap_in", "scatter_back", "join", "_unique", "_rows")


def run(rank: int, world: int, port: int) -> None:
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.models.dlrm import build_dlrm
    from flexflow_tpu_torch.parallel import distributed as dist
    from flexflow_tpu_torch.runtime import host_tables as ht

    dist.initialize("cuda", init_method=f"tcp://localhost:{port}", world_size=world,
                    rank=rank, local_rank=rank)
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    spent = collections.defaultdict(float)
    for name in TIMED:
        orig = getattr(ht.HostTables, name)

        def timed(self, *a, _orig=orig, _name=name, **k):
            t0 = time.perf_counter()
            try:
                return _orig(self, *a, **k)
            finally:
                spent[_name] += time.perf_counter() - t0
        setattr(ht.HostTables, name, timed)
    with tempfile.TemporaryDirectory() as tmp:
        for label, strategy in (("host rows", cs.hetero_strategy(tmp)), ("on the card", None)):
            m = ft.FFModel(ft.FFConfig(batch_size=256, compute_dtype="bfloat16",
                                       fused_optimizer=True,
                                       import_strategy_file=strategy or "",
                                       import_strategy_reference_order=bool(strategy)))
            sparse, dense, _ = build_dlrm(m, 256)
            m.compile(ft.SGDOptimizer(m, lr=0.01), "mean_squared_error", ["mean_squared_error"])
            m.init_layers(seed=0)
            cs.dlrm_batch(m, sparse + [dense], 0)
            for _ in range(3):
                m.train_iteration()
            m.sync()
            spent.clear()
            t0 = time.perf_counter()
            for _ in range(5):
                m.train_iteration()
            m.sync()
            ms = (time.perf_counter() - t0) / 5 * 1e3
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(2):
                    m.train_iteration()
                m.sync()
            if rank == 0:
                cs.log(f"[profile] {label}, {world} rank(s): {ms:.2f} ms/step; host ms a step in "
                       + ", ".join(f"{k} {v / 5 * 1e3:.2f}" for k, v in spent.items()))
                cs.log(prof.key_averages().table(sort_by="cpu_time_total", row_limit=25))
            del m
            cs.free_models()
    dist.shutdown()


def main() -> int:
    if len(sys.argv) > 1:
        run(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
        return 0
    if not torch.cuda.is_available():
        print("hetero_dlrm_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    cs.log(cs.nvidia_smi_line())
    world = min(4, torch.cuda.device_count())
    port = cs.free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               str(port)]) for r in range(world)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
