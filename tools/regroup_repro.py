#!/usr/bin/env python3
"""Re-forming the process group in one living process, on NVIDIA GPUs,
through the port's own API (ROADMAP C10's check).

    python3 tools/regroup_repro.py [--cards N]

A process that had run a one-rank NCCL mesh and then joined a four-rank
group died of a segmentation fault in ``split_group`` while the new mesh
split its communicators from the re-formed default group.  The port now
binds no NCCL group to its device (``parallel/distributed.py``): every
group's communicator is made on first use, never split.  Each variant
starts a lead process
(rank 0, card 0) and N - 1 helpers (one a card):

* ``mesh``: the lead initializes a one-rank NCCL group, builds
  chip_smoke.py's transformer (4x512, 8 heads, vocab 32000, f32) on the
  mesh over it, builds an InferenceEngine on it (its gloo plan group) and
  generates 4 tokens eagerly on the mesh; shuts the group down; then the
  N ranks initialize a group and build ``Machine.from_process_group``
  (the prime-factored mesh: (2, 2) on four cards) and all-reduce a one;
* ``profile``: the same, the lead generating under torch.profiler (CPU
  and CUDA activities), as chip_smoke.py's phase 17 (a) once did;
* ``for_ranks``: as ``mesh``, then every rank builds
  ``Machine.for_ranks`` over ranks 0 and 1, all-reduces on it, shuts the
  group down, forms it again and asks for the same ranks: a new machine
  (``distributed.shutdown`` forgot the old one), whose all-reduce meets;
* ``abort``: as ``mesh``, then rank 0 all-reduces on its mesh dim's group
  while its peers there skip it; rank 0 aborts its machine's
  communicators after 3 s (what the serving engine's step guard does,
  ROADMAP C11) and its pending all-reduce ends; every rank shuts down and
  forms the group again, whose mesh all-reduces.

It prints a line a variant: its name, the lead's exit code (-11 is
SIGSEGV), the helpers' and seconds, and exits 0 when every process of
every variant exited 0.  Needs N cards (default: every visible one, at
least 2), about 30-90 s a variant.
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

VARIANTS = ("mesh", "profile", "for_ranks", "abort")
TIMEOUT = datetime.timedelta(seconds=120)


def regroup(variant: str, cards: int, rank: int, port: int, port3: int) -> None:
    """The N-rank group on this rank (and, by variant, what follows)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel import distributed as dist

    def form(p):
        dev = dist.initialize("cuda", init_method=f"tcp://localhost:{p}", world_size=cards,
                              rank=rank, local_rank=rank, timeout=TIMEOUT)
        machine = ft.Machine.from_process_group(dev)
        one = torch.ones(1, device=dev)
        torch.distributed.all_reduce(one, group=machine.mesh.get_group(0))
        torch.cuda.synchronize()
        assert machine.num_devices == cards and one.item() == machine.mesh.size(0), (machine,
                                                                                     one)
        return dev, machine

    dev, machine = form(port)
    if variant == "for_ranks":
        first = ft.Machine.for_ranks(dev, [0, 1])
        if not first.benched:
            one = torch.ones(1, device=dev)
            torch.distributed.all_reduce(one, group=first.process_group)
            assert one.item() == 2, one
        dist.shutdown()
        dev, _ = form(port3)
        again = ft.Machine.for_ranks(dev, [0, 1])
        assert again is not first, "for_ranks kept a machine of the old group"
        if not again.benched:
            one = torch.ones(1, device=dev)
            torch.distributed.all_reduce(one, group=again.process_group)
            torch.cuda.synchronize()
            assert one.item() == 2, one
    elif variant == "abort":
        group = machine.mesh.get_group(0)
        x = torch.ones(1 << 20, device=dev)
        t0 = time.perf_counter()
        if rank == 0:
            timer = threading.Timer(3.0, machine.abort)
            timer.start()
            torch.distributed.all_reduce(x, group=group)
            x.sum().item()  # returns once the abort ended the collective
            assert machine.aborted and time.perf_counter() - t0 < 60
        elif rank == 1:
            machine.abort()  # the rank that "failed" skips the collective
        dist.shutdown()
        dev, machine = form(port3)
    dist.shutdown()


def lead(variant: str, cards: int, port1: int, port2: int, port3: int) -> None:
    """The one-rank mesh on rank 0, then ``regroup``."""
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
    regroup(variant, cards, 0, port2, port3)


def main(argv) -> int:
    faulthandler.enable()  # a crash in a native library prints the Python stack
    if "--lead" in argv:
        i = argv.index("--lead")
        lead(argv[i + 1], *(int(a) for a in argv[i + 2:i + 6]))
        return 0
    if "--helper" in argv:
        i = argv.index("--helper")
        regroup(argv[i + 1], *(int(a) for a in argv[i + 2:i + 6]))
        return 0
    cards = int(argv[argv.index("--cards") + 1]) if "--cards" in argv \
        else torch.cuda.device_count()
    if cards < 2:
        print(f"regroup_repro: needs at least 2 cards ({cards} visible)", file=sys.stderr)
        return 2
    print(cs.nvidia_smi_line(), flush=True)
    ok = True
    for variant in VARIANTS:
        port1, port2, port3 = cs.free_port(), cs.free_port(), cs.free_port()
        me = os.path.abspath(__file__)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, me, "--lead", variant, str(cards),
                                   str(port1), str(port2), str(port3)])]
        procs += [subprocess.Popen([sys.executable, me, "--helper", variant, str(cards),
                                    str(r), str(port2), str(port3)]) for r in range(1, cards)]
        rc, helpers = "timeout", []
        try:
            rc = procs[0].wait(timeout=120)
            for p in procs[1:]:
                helpers.append(p.wait(timeout=60))
        except subprocess.TimeoutExpired:
            helpers.append("timeout")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        ok = ok and rc == 0 and all(h == 0 for h in helpers)
        print(f"[regroup] variant {variant}: lead exit {rc}, helpers {helpers}, "
              f"{time.perf_counter() - t0:.1f} s on {cards} cards", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
