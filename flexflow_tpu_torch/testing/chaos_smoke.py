"""Chaos smoke: the acceptance scenarios for the robustness layer, as a CLI
(PyTorch port of ``flexflow_tpu/testing/chaos_smoke.py``).

Four scenarios, selected with ``--scenario``, on ``--device`` (``cuda``
unless ``cpu`` is asked for):

``recovery`` (default) — one seeded ``FF_CHAOS`` run injects a NaN step,
a mid-epoch SIGTERM, and a failing checkpoint write; the resumed run
must finish with parameters BITWISE-equal to an uninterrupted baseline,
leave no partial checkpoint file behind, and the trace must narrate
every recovery (``fault_injected`` / ``step_skipped`` /
``preemption_save`` / ``ckpt_retry``).  ``recovery()`` takes the function
that makes the model, so ``chip_smoke.py`` runs the same drill on
full-width AlexNet.

``reshard`` — ``--ranks`` processes (one per card on cuda, four gloo
ranks on the CPU by default) train one model on a mesh over all of them;
a chaos-injected loss of half the ranks after step 4 makes the
reconfiguration controller re-search on the survivors and hot-swap at a
deterministic step boundary (6), the lost ranks benched, and a gain
after step 7 takes them back (at step 9).  Training must finish finite
on the whole mesh, every rank's parameters must equal those of the same
job on one device with no swap, leave diffable swap ``.pb`` records
behind, and two independent runs must end with bitwise-identical
parameters.

``serve_failover`` — a chaos-injected replica crash (``replica_kill``)
in a 3-replica ``ReplicaPool`` mid-load; every request — including the
ones in flight on the killed replica — must still complete with tokens
BITWISE-equal to one-shot ``FFModel.generate()``, the monitor must
restart the dead replica, the trace must narrate the lifecycle
(``replica_down`` / ``request_failover`` / ``replica_restart``), and
the goodput headline lands in ``BENCH_SERVE.json``.

``zone_outage`` — a chaos-injected loss of a WHOLE ZONE (``zone_outage``
fault) in a 4-replica, 2-zone pool with the autoscaler running; every
request must still complete with tokens BITWISE-equal to
``FFModel.generate()``, the autoscaler must backfill the surviving zone
back to ``min_replicas``, and the trace must narrate the incident
(``zone_down`` / ``request_failover`` / ``scale_event``).

Both serve scenarios serve ``testing/fleet.py``'s tiny transformer.

Usage:
    python -m flexflow_tpu_torch.testing.chaos_smoke --workdir /tmp/chaos
    python -m flexflow_tpu_torch.testing.chaos_smoke --workdir /tmp/rs \\
        --scenario reshard --device cpu --ranks 4
    python -m flexflow_tpu_torch.testing.chaos_smoke --workdir /tmp/sf \\
        --scenario serve_failover
    python -m flexflow_tpu_torch.testing.chaos_smoke --workdir /tmp/zo \\
        --scenario zone_outage
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

# Both trajectories (baseline AND victim) carry the NaN injection: the
# guard's skip is deterministic, so the runs stay bitwise-comparable —
# only the preemption + checkpoint fault are exclusive to the victim.
NAN_SPEC = "step:2=nan_loss"
VICTIM_SPEC = NAN_SPEC + ";step:4=sigterm;ckpt_save:1=io_error"
EPOCHS = 3
RESHARD_EPOCHS = 4
RESHARD_TIMEOUT_S = 600


def build_mlp(device: str = "cuda", n_samples: int = 48, seed: int = 9,
              weights: Optional[Dict[str, "object"]] = None):
    """The JAX package's chaos model: 8 -> 16 (relu) -> 4, Adam 0.01,
    batch 16, a seeded dataset of 48 rows; ``weights`` (``params_of``'s
    entries) replace the seeded initial weights."""
    import numpy as np

    import flexflow_tpu_torch as ft
    from ..runtime.checkpoint import load_arrays

    m = ft.FFModel(ft.FFConfig(batch_size=16, device=device))
    inp = m.create_tensor((16, 8), nchw=False, name="input")
    t = m.dense(inp, 16, activation="relu", name="fc1")
    t = m.dense(t, 4, name="fc2")
    m.softmax(t, name="sm")
    m.compile(ft.AdamOptimizer(alpha=0.01), "sparse_categorical_crossentropy",
              ["accuracy"])
    m.init_layers(seed=seed)
    if weights is not None:
        load_arrays(m, weights)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n_samples, 8), dtype=np.float32)
    y = rng.integers(0, 4, size=(n_samples, 1), dtype=np.int32)
    return m, ft.DataLoader(m, {inp: x}, y, seed=5)


def _phase(env: dict):
    """Reset the telemetry singleton and apply this phase's env."""
    from ..observability import events

    events.reset_active()
    for k in ("FF_CHAOS", "FF_TELEMETRY", "FF_TELEMETRY_FILE",
              "FF_RECONFIGURE", "FF_RECONFIG_BUDGET",
              "FF_RECONFIG_LAG_STEPS"):
        os.environ.pop(k, None)
    os.environ.update(env)


def params_of(model) -> Dict[str, "object"]:
    """Every parameter of ``model`` as numpy (a collective on a mesh)."""
    from ..runtime.checkpoint import state_arrays

    return {k: v for k, v in state_arrays(model).items() if k.startswith("params/")}


def recovery(wd: str, build: Callable, epochs: int = EPOCHS, max_to_keep: int = 3) -> dict:
    """The recovery drill on the model ``build()`` returns (a model and
    its loader): an uninterrupted baseline, a victim preempted by SIGTERM
    with a failing checkpoint write, its resume in a fresh model (each
    keeping ``max_to_keep`` checkpoints).  Raises on any failed check;
    returns the three models and what the drill measured: the seconds of
    each run and of the victim's saves, and the preemption checkpoint's
    bytes."""
    import numpy as np

    from ..observability import events
    from ..runtime.elastic import elastic_train
    from ..runtime.resilience import Preempted, read_resume_meta

    os.environ["FF_SKIP_NONFINITE"] = "5"
    os.environ["FF_CKPT_BACKOFF_S"] = "0.01"
    trace = os.path.join(wd, "victim_trace.jsonl")
    out: dict = {"trace": trace}

    # -- baseline: uninterrupted, same NaN injection ---------------------
    _phase({"FF_CHAOS": NAN_SPEC})
    mb, dlb = build()
    t0 = time.perf_counter()
    elastic_train(mb, dlb, epochs=epochs, checkpoint_dir=os.path.join(wd, "base"),
                  max_to_keep=max_to_keep)
    out["base_s"] = time.perf_counter() - t0
    dlb.close()
    base = params_of(mb)
    assert mb._guard.total_skipped == 1, "baseline skip missing"
    print(f"baseline: {mb._step_count} steps, 1 NaN step skipped", flush=True)

    # -- victim: + SIGTERM mid-epoch + failing checkpoint write ----------
    _phase({"FF_CHAOS": VICTIM_SPEC, "FF_TELEMETRY": "1", "FF_TELEMETRY_FILE": trace})
    ck = os.path.join(wd, "ck")
    mv, dlv = build()
    t0 = time.perf_counter()
    try:
        elastic_train(mv, dlv, epochs=epochs, checkpoint_dir=ck, max_to_keep=max_to_keep)
        raise AssertionError("victim was not preempted")
    except Preempted as e:
        out["preempted_at"] = e.step
        print(f"victim: preempted cleanly at step {e.step}", flush=True)
    out["victim_s"] = time.perf_counter() - t0
    dlv.close()
    assert mv._guard.total_skipped == 1, "victim skip missing"
    meta = read_resume_meta(ck)
    assert meta and meta["step"] == mv._step_count, meta

    # -- resume: chaos off, finish the job -------------------------------
    _phase({})
    mr, dlr = build()
    t0 = time.perf_counter()
    elastic_train(mr, dlr, epochs=epochs, checkpoint_dir=ck, max_to_keep=max_to_keep)
    out["resume_s"] = time.perf_counter() - t0
    dlr.close()
    events.reset_active()
    got = params_of(mr)
    assert mr._step_count == mb._step_count, (mr._step_count, mb._step_count)
    differ = [k for k in base if not np.array_equal(got[k], base[k])]
    assert not differ, f"resumed params differ from baseline: {differ}"
    print(f"resume: finished at step {mr._step_count}, every parameter "
          "bitwise-equal to the uninterrupted baseline", flush=True)

    # -- no corrupt/partial checkpoint artifacts -------------------------
    stray = glob.glob(os.path.join(wd, "**", "*.tmp-*"), recursive=True)
    assert not stray, f"partial checkpoint files left behind: {stray}"

    # -- the trace narrates every recovery -------------------------------
    recs = [json.loads(line) for line in open(trace) if line.strip()]
    names = [r.get("name") for r in recs]
    for ev in ("fault_injected", "step_skipped", "preemption_save", "ckpt_retry"):
        assert ev in names, f"{ev} missing from trace (saw {set(names)})"
    out["save_s"] = [r["dur"] for r in recs
                     if r.get("t") == "span" and r.get("name") == "checkpoint_save"]
    # every checkpoint of a model has the same size
    out["ckpt_bytes"] = os.path.getsize(sorted(glob.glob(os.path.join(ck, "ckpt_*.npz")))[-1])
    print(f"trace: {names.count('fault_injected')} faults injected, all recovery "
          f"events present ({trace})", flush=True)
    out.update(base=mb, victim=mv, resumed=mr)
    return out


def _scenario_recovery(wd: str, device: str) -> int:
    recovery(wd, lambda: build_mlp(device))
    print("CHAOS SMOKE OK")
    return 0


# ----------------------------------------------------------------------
# reshard: one process per rank
# ----------------------------------------------------------------------

def reshard_spec(world: int) -> str:
    """Half the ranks lost after step 4, regained after step 7."""
    k = world // 2
    return f"resharding:4=device_loss:{k};resharding:7=device_gain:{k}"


def reshard_run(wd: str, device: str, world: int, weights: Optional[dict] = None):
    """One seeded failover run on this rank (the process group is up),
    from ``weights`` when given.  Returns (model, the swaps as ``(step,
    trigger, outcome)``, the swap events of this rank's trace)."""
    from ..runtime.elastic import elastic_train

    rank = _rank()
    trace = os.path.join(wd, f"trace_{rank}.jsonl")
    _phase({"FF_CHAOS": reshard_spec(world), "FF_RECONFIGURE": "1",
            "FF_RECONFIG_BUDGET": "40", "FF_RECONFIG_LAG_STEPS": "2",
            "FF_TELEMETRY": "1", "FF_TELEMETRY_FILE": trace})
    m, dl = build_mlp(device, weights=weights)
    elastic_train(m, dl, epochs=RESHARD_EPOCHS, checkpoint_dir=os.path.join(wd, "ckpt"))
    dl.close()
    from ..observability import events

    events.reset_active()
    swaps = [json.loads(line)["attrs"] for line in open(trace)
             if line.strip() and '"strategy_swap"' in line]
    return m, list(m._reconfig.swaps), swaps


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def reference_run(wd: str, device: str, weights: Optional[dict] = None) -> dict:
    """The reshard scenario's job on one device in this process, with no
    chaos and no controller: the same data, steps and initial weights.
    Data parallelism computes the same global batch, so every rank of a
    reshard run must end at these parameters (up to summation order)."""
    from ..runtime.elastic import elastic_train

    _phase({})
    m, dl = build_mlp(device, weights=weights)
    elastic_train(m, dl, epochs=RESHARD_EPOCHS, checkpoint_dir=os.path.join(wd, "reference"))
    dl.close()
    return params_of(m)


def _reshard_rank(wd: str, device: str, world: int, rank: int, init: str) -> int:
    """A rank of the reshard scenario: two runs from the weights in
    ``wd/init.npz`` when the lead wrote one, each rank's parameters and
    swaps written to ``wd`` for the lead to compare."""
    import faulthandler

    import numpy as np

    from ..parallel import distributed

    # the lead dumps every rank's stacks (SIGUSR1) before it kills a hung job
    faulthandler.register(signal.SIGUSR1)
    distributed.initialize(device, init_method=init, world_size=world, rank=rank)
    out = {}
    weights = None
    if os.path.exists(os.path.join(wd, "init.npz")):
        with np.load(os.path.join(wd, "init.npz")) as data:
            weights = {k: data[k] for k in data.files}
    for run in ("run1", "run2"):
        os.makedirs(os.path.join(wd, run), exist_ok=True)
        m, swaps, events_ = reshard_run(os.path.join(wd, run), device, world, weights)
        params = params_of(m)
        out[run] = dict(swaps=swaps, events=events_, devices=m.machine.num_devices,
                        steps=m._step_count,
                        finite=bool(all(np.isfinite(v).all() for v in params.values())))
        # each rank's own copy: a replicated leaf's gather reads the local one
        np.savez(os.path.join(wd, f"{run}_params_{rank}.npz"), **params)
    with open(os.path.join(wd, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    if device == "cuda":
        # no destroy_process_group: under NCCL it hung on four cards after
        # the survivors' groups were split (every rank tears its
        # communicators down in its own order); the record is written
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    distributed.shutdown()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def reshard_job(wd: str, device: str, world: int, timeout: float = RESHARD_TIMEOUT_S,
                weights: Optional[dict] = None) -> dict:
    """Run the reshard scenario's two runs on ``world`` ranks
    (subprocesses, one per card on cuda), from ``weights`` (``params_of``'s
    entries) when given, then ``reference_run`` in this process; returns
    what each rank recorded (``ranks``), every rank's parameters after each
    run (``run1_params``/``run2_params``, one dict a rank), the reference's
    (``reference_params``) and the ranks' wall seconds.  Checks nothing but
    the ranks' exit codes; a job still running after ``timeout`` seconds
    has its ranks' stacks dumped, then is killed."""
    import numpy as np

    os.makedirs(wd, exist_ok=True)
    if weights is not None:
        np.savez(os.path.join(wd, "init.npz"), **weights)
    init = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "flexflow_tpu_torch.testing.chaos_smoke", "--workdir", wd,
         "--scenario", "reshard", "--device", device, "--ranks", str(world),
         "--rank", str(r), "--init", init], env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
        for r in range(world)]
    t0 = time.perf_counter()
    try:
        for r, p in enumerate(procs):
            left = max(1.0, timeout - (time.perf_counter() - t0))
            assert p.wait(timeout=left) == 0, f"reshard rank {r} exited {p.returncode}"
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:  # a failed or hung sibling must not outlive the run
            p.send_signal(signal.SIGUSR1)
        time.sleep(2.0 if hung else 0.0)
        for p in hung:
            p.kill()
            p.wait()
    out = dict(wall_s=time.perf_counter() - t0, world=world,
               ranks=[json.load(open(os.path.join(wd, f"rank_{r}.json")))
                      for r in range(world)])
    for run in ("run1", "run2"):
        out[f"{run}_params"] = []
        for r in range(world):
            with np.load(os.path.join(wd, f"{run}_params_{r}.npz")) as data:
                out[f"{run}_params"].append({k: data[k] for k in data.files})
    out["reference_params"] = reference_run(wd, device, weights)
    return out


RESHARD_SWAPS = [(6, "device_loss", "applied"), (9, "device_gain", "applied")]
# a reshard run against the unswapped reference: the same global batches,
# summed in another order
RESHARD_TOL = dict(rtol=1e-5, atol=1e-6)


def check_reshard(job: dict) -> int:
    """The reshard scenario's checks on ``reshard_job``'s record: on every
    rank and in both runs the loss applies at step 6 onto half the ranks
    and the gain at step 9 onto all, training ends finite on the whole
    mesh after every step, every rank's parameters equal the unswapped
    one-device reference's within ``RESHARD_TOL`` (the survivors kept the
    right rows, the benched ranks took the current weights back), the
    two runs' parameters are bitwise equal, and the swap records render
    as a diff.  Returns the diff's line count."""
    import numpy as np

    world = job["world"]
    for run in ("run1", "run2"):
        for r, rec in enumerate(job["ranks"]):
            got = [tuple(s) for s in rec[run]["swaps"]]
            assert got == RESHARD_SWAPS, f"rank {r} {run}: swaps {got}"
            assert rec[run]["devices"] == world and rec[run]["finite"], (r, run, rec[run])
            assert rec[run]["steps"] == 3 * RESHARD_EPOCHS, (r, run, rec[run]["steps"])
        ev = job["ranks"][0][run]["events"]
        assert [e["new_devices"] for e in ev] == [world - world // 2, world], ev
    ref = job["reference_params"]
    for r, (p1, p2) in enumerate(zip(job["run1_params"], job["run2_params"])):
        assert p1.keys() == ref.keys(), (r, sorted(p1), sorted(ref))
        for n in ref:
            np.testing.assert_allclose(p1[n], ref[n], **RESHARD_TOL,
                                       err_msg=f"rank {r} {n} against the unswapped run")
        assert all(np.array_equal(p1[n], p2[n]) for n in p1), \
            f"rank {r}: failover runs are not bitwise-reproducible"
    from ..tools.search_report import render_diff

    first = job["ranks"][0]["run1"]["events"][0]
    diff = render_diff(first["old_pb"], first["new_pb"])
    assert "reconfig-mcmc" in diff, "diff lost the new side's engine"
    return len(diff.splitlines())


def _scenario_reshard(wd: str, device: str, world: int) -> int:
    job = reshard_job(wd, device, world)
    lines = check_reshard(job)
    ev = job["ranks"][0]["run1"]["events"]
    print(f"reshard: {world} ranks, swaps at steps {[e['step'] for e in ev]} "
          f"({world} -> {ev[0]['new_devices']} -> {ev[1]['new_devices']} devices), "
          f"every rank equal to the unswapped run, both runs bitwise-equal, "
          f"{job['wall_s']:.1f} s; search_report --diff "
          f"renders the first swap ({lines} lines)", flush=True)
    print("RESHARD SMOKE OK")
    return 0


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------

def _scenario_serve_failover(wd: str, device: str) -> int:
    import numpy as np

    from ..observability import events
    from ..serving import ServeConfig
    from ..serving.pool import ReplicaPool
    from .fleet import build_serve_model

    NEW = 8        # tokens per request
    N_REQ = 10
    trace = os.path.join(wd, "serve_trace.jsonl")
    # 5th pool-wide admission raises ChaosReplicaKill inside one
    # replica's decode loop: that thread dies with a request mid-admit
    # and (max_batch=2) possibly one more in a live slot
    _phase({"FF_CHAOS": "serve:5=replica_kill", "FF_TELEMETRY": "1",
            "FF_TELEMETRY_FILE": trace})
    m = build_serve_model(device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 32, size=int(rng.integers(3, 11))).astype(np.int32)
               for _ in range(N_REQ)]
    # ground truth first: the chaos spec only matches the serve site,
    # so one-shot generate() is uninstrumented
    want = [m.generate(p[None], NEW)[0] for p in prompts]

    cfg = ServeConfig(max_batch=2, max_seq=64, max_new_tokens=NEW,
                      replicas=3, replica_timeout_s=120.0,
                      restart_backoff_s=0.05, restart_cap_s=0.2)
    pool = ReplicaPool(m, config=cfg)
    pool.start()
    t0 = time.perf_counter()
    reqs = [pool.submit(p, NEW) for p in prompts]
    outs = [r.result(180) for r in reqs]
    wall = time.perf_counter() - t0

    bad = [i for i, (got, w) in enumerate(zip(outs, want))
           if not np.array_equal(np.asarray(got, np.int32), w)]
    assert not bad, f"failover broke greedy equivalence for {bad}"
    st = pool.stats()
    assert st["replica_downs"] >= 1, f"chaos kill never landed: {st}"
    assert st["failovers"] >= 1, f"no in-flight request failed over: {st}"

    # the monitor must bring the dead replica back (backoff is tiny)
    deadline = time.perf_counter() + 30
    while time.perf_counter() < deadline:
        hz = pool.healthz()
        if (pool.stats()["replica_restarts"] >= 1
                and all(r["state"] == "ready" for r in hz["replicas"])):
            break
        time.sleep(0.05)
    hz = pool.healthz()
    assert pool.stats()["replica_restarts"] >= 1, pool.stats()
    assert all(r["state"] == "ready" for r in hz["replicas"]), hz
    st = pool.stats()
    pool.stop()
    events.reset_active()
    print(f"pool: {st['completed']}/{N_REQ} completed bitwise-equal · "
          f"{st['replica_downs']} down, {st['failovers']} failovers, "
          f"{st['replica_restarts']} restarts", flush=True)

    names = [json.loads(line).get("name") for line in open(trace) if line.strip()]
    for ev in ("replica_down", "request_failover", "replica_restart"):
        assert ev in names, f"{ev} missing from trace (saw {set(names)})"
    print(f"trace: replica lifecycle narrated ({trace})", flush=True)

    bench = {"bench": "serve_failover_smoke", "requests": N_REQ,
             "replicas": 3, "n_ok": len(outs), "n_fail": 0,
             "wall_s": round(wall, 3),
             "goodput_rps": round(len(outs) / wall, 3) if wall > 0 else 0.0,
             "pool": {k: st[k] for k in ("completed", "failovers", "replica_downs",
                                         "replica_restarts", "shed", "hedged")}}
    out = os.path.join(wd, "BENCH_SERVE.json")
    with open(out, "w") as f:
        json.dump(bench, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"bench: goodput {bench['goodput_rps']:.2f} req/s -> {out}", flush=True)
    print("SERVE FAILOVER SMOKE OK")
    return 0


def _scenario_zone_outage(wd: str, device: str) -> int:
    import numpy as np

    from ..observability import events
    from ..serving import Autoscaler, ScaleConfig, ServeConfig
    from ..serving.pool import ReplicaPool
    from .fleet import build_serve_model

    NEW = 8
    N_REQ = 12
    trace = os.path.join(wd, "zone_trace.jsonl")
    # 6th pool-wide admission downs zone index 1 ("zone-b"): BOTH of its
    # replicas go dark at once, stranding whatever they hold in flight
    _phase({"FF_CHAOS": "serve:6=zone_outage:1", "FF_TELEMETRY": "1",
            "FF_TELEMETRY_FILE": trace})
    m = build_serve_model(device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 32, size=int(rng.integers(3, 11))).astype(np.int32)
               for _ in range(N_REQ)]
    want = [m.generate(p[None], NEW)[0] for p in prompts]

    cfg = ServeConfig(max_batch=2, max_seq=64, max_new_tokens=NEW,
                      replicas=4, zones=("zone-a", "zone-b"),
                      replica_timeout_s=120.0,
                      restart_backoff_s=0.05, restart_cap_s=0.2)
    scale = ScaleConfig(min_replicas=4, max_replicas=6, interval_s=0.05,
                        streak=2, up_cooldown_s=0.1, down_cooldown_s=30.0)
    pool = ReplicaPool(m, config=cfg)
    pool.start()
    scaler = Autoscaler(pool, scale)
    scaler.start()
    t0 = time.perf_counter()
    reqs = [pool.submit(p, NEW) for p in prompts]
    outs = [r.result(180) for r in reqs]
    wall = time.perf_counter() - t0

    bad = [i for i, (got, w) in enumerate(zip(outs, want))
           if not np.array_equal(np.asarray(got, np.int32), w)]
    assert not bad, f"zone failover broke greedy equivalence for {bad}"
    st = pool.stats()
    assert st["zone_outages"] >= 1, f"chaos zone_outage never landed: {st}"
    assert st["replica_downs"] >= 2, f"a whole zone (2 replicas) should be down: {st}"
    assert st["failovers"] >= 1, f"no stranded request failed over: {st}"
    assert "zone-b" in pool.zones_down(), pool.zones_down()

    deadline = time.perf_counter() + 30
    while time.perf_counter() < deadline:
        if pool.ready_replicas >= scale.min_replicas:
            break
        time.sleep(0.05)
    hz = pool.healthz()
    assert pool.ready_replicas >= scale.min_replicas, hz
    assert hz["zones"]["zone-b"]["down"], hz["zones"]
    assert hz["zones"]["zone-b"]["ready"] == 0, hz["zones"]
    assert hz["zones"]["zone-a"]["ready"] >= scale.min_replicas, hz["zones"]
    st = pool.stats()
    assert st["replicas_added"] >= 2, st
    sst = scaler.stats()
    scaler.stop()
    pool.stop()
    events.reset_active()
    print(f"pool: {st['completed']}/{N_REQ} completed bitwise-equal · "
          f"zone-b down ({st['replica_downs']} replicas), "
          f"{st['failovers']} failovers, {st['replicas_added']} backfills "
          f"({sst['scale_ups']} scale-ups)", flush=True)

    names = [json.loads(line).get("name") for line in open(trace) if line.strip()]
    for ev in ("zone_down", "request_failover", "scale_event", "replica_added"):
        assert ev in names, f"{ev} missing from trace (saw {set(names)})"
    print(f"trace: zone incident narrated ({trace})", flush=True)
    print(f"wall: {wall:.2f}s for {N_REQ} requests through the outage", flush=True)
    print("ZONE OUTAGE SMOKE OK")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True, help="scratch dir for checkpoints + traces")
    p.add_argument("--scenario", choices=("recovery", "reshard", "serve_failover",
                                          "zone_outage"), default="recovery")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--ranks", type=int, default=None,
                   help="reshard: processes (default: every visible card on cuda, "
                        "4 on the CPU)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    if args.scenario == "reshard":
        if args.rank is not None:
            return _reshard_rank(args.workdir, args.device, args.ranks, args.rank, args.init)
        world = args.ranks
        if world is None:
            import torch

            world = torch.cuda.device_count() if args.device == "cuda" else 4
        if world < 2:
            print(f"reshard needs at least 2 ranks, got {world}", file=sys.stderr)
            return 2
        return _scenario_reshard(args.workdir, args.device, world)
    if args.scenario == "serve_failover":
        return _scenario_serve_failover(args.workdir, args.device)
    if args.scenario == "zone_outage":
        return _scenario_zone_outage(args.workdir, args.device)
    return _scenario_recovery(args.workdir, args.device)


if __name__ == "__main__":
    sys.exit(main())
