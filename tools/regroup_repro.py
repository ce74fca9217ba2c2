#!/usr/bin/env python3
"""Re-forming the process group in one process, on NVIDIA GPUs: a one-rank
NCCL group that decodes on a mesh, shut down, then a group over several
cards that builds its mesh.

    python3 tools/regroup_repro.py [--cards N]

A reproducer for an open fault of the port: a process that had run a
one-rank NCCL mesh (phase 17 (a) of chip_smoke.py, profiled) and then
joined a four-rank group died of a segmentation fault while the new
mesh split its communicators.  Each variant starts a lead process (rank
0, card 0) and N - 1 helpers (one a card).  The lead

1. initializes a one-rank NCCL group, builds chip_smoke.py's transformer
   (4x512, 8 heads, vocab 32000, f32) on the mesh over it, builds an
   InferenceEngine on it (its gloo plan group) and generates 4 tokens
   eagerly on the mesh; the variant ``profile`` generates under
   torch.profiler (CPU and CUDA activities), as phase 17 (a) does;
2. shuts the group down (``distributed.shutdown``);
3. initializes the N-rank group with the helpers, and every rank builds
   ``Machine.from_process_group`` (the mesh's communicators split from the
   default group's) and all-reduces a one.

It prints a line a variant: its name, the lead's exit code (-11 is
SIGSEGV) and seconds, and exits 0 when every variant's lead got through
step 3.  Needs N cards (default: every visible one, at least 2), and
about 90 s a variant.
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

VARIANTS = ("mesh", "profile")
TIMEOUT = datetime.timedelta(seconds=120)


def regroup(cards: int, rank: int, port: int) -> None:
    """Step 3 on this rank."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel import distributed as dist

    dev = dist.initialize("cuda", init_method=f"tcp://localhost:{port}", world_size=cards,
                          rank=rank, local_rank=rank, timeout=TIMEOUT)
    machine = ft.Machine.from_process_group(dev)
    one = torch.ones(1, device=dev)
    torch.distributed.all_reduce(one)
    assert machine.num_devices == cards and one.item() == cards, (machine, one)
    dist.shutdown()


def lead(variant: str, cards: int, port1: int, port2: int) -> None:
    """Steps 1-3 on rank 0."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.models.transformer import build_transformer
    from flexflow_tpu_torch.parallel import distributed as dist
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    dist.initialize("cuda", init_method=f"tcp://localhost:{port1}", world_size=1, rank=0,
                    local_rank=0, timeout=TIMEOUT)
    model, _, _ = cs.decode_lm(ft, build_transformer, "float32")
    assert model._sharded
    InferenceEngine(model, max_batch=2, max_seq=64)
    prompt = np.random.default_rng(0).integers(0, cs.LM["vocab_size"],
                                               size=(cs.LM["batch"], 8), dtype=np.int32)
    if variant == "profile":
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            model.generate(prompt, 4)
    else:
        model.generate(prompt, 4)
    torch.cuda.synchronize()
    del model
    dist.shutdown()
    regroup(cards, 0, port2)


def main(argv) -> int:
    faulthandler.enable()  # a crash in a native library prints the Python stack
    if "--lead" in argv:
        i = argv.index("--lead")
        lead(argv[i + 1], *(int(a) for a in argv[i + 2:i + 5]))
        return 0
    if "--helper" in argv:
        i = argv.index("--helper")
        regroup(*(int(a) for a in argv[i + 1:i + 4]))
        return 0
    cards = int(argv[argv.index("--cards") + 1]) if "--cards" in argv \
        else torch.cuda.device_count()
    if cards < 2:
        print(f"regroup_repro: needs at least 2 cards ({cards} visible)", file=sys.stderr)
        return 2
    print(cs.nvidia_smi_line(), flush=True)
    ok = True
    for variant in VARIANTS:
        port1, port2 = cs.free_port(), cs.free_port()
        me = os.path.abspath(__file__)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, me, "--lead", variant, str(cards),
                                   str(port1), str(port2)])]
        procs += [subprocess.Popen([sys.executable, me, "--helper", str(cards), str(r),
                                    str(port2)]) for r in range(1, cards)]
        rc, helpers = "timeout", []
        try:
            rc = procs[0].wait(timeout=240)
            for p in procs[1:]:
                helpers.append(p.wait(timeout=60))
        except subprocess.TimeoutExpired:
            helpers.append("timeout")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        ok = ok and rc == 0
        print(f"[regroup] variant {variant}: lead exit {rc}, helpers {helpers}, "
              f"{time.perf_counter() - t0:.1f} s on {cards} cards", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
