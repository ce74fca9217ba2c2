"""Environment doctor: one command to sanity-check an install of the port
(PyTorch port of the JAX package's ``tools/doctor.py``).

    python -m flexflow_tpu_torch.tools.doctor [--skip-accelerator]

Reports versions, the CUDA devices (in a subprocess with a kill deadline:
a hung device or driver hangs any device op inside a C call, which this
tool must survive), the port's native libraries and whether ``nvcc`` can
build its kernels, the effective environment knobs of every plane, and
runs a tiny training loop on the CPU end to end.  The checks and their
names are the JAX package's, in its order.  Exit code 0 iff every
required check passes.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Tuple

ACCELERATOR_TIMEOUT_S = 90
PERF_PROBE_TIMEOUT_S = 10.0


def _check(name: str, fn, required: bool = True) -> Tuple[str, str, str]:
    try:
        detail = fn()
        return name, "ok", str(detail)
    except Exception as e:  # noqa: BLE001 — report, don't crash the doctor
        return (name, "FAIL" if required else "warn", f"{type(e).__name__}: {e}")


def _versions():
    import numpy as np
    import torch

    return (f"python {sys.version.split()[0]}, torch {torch.__version__} "
            f"(CUDA {torch.version.cuda or 'none: a CPU build'}), numpy {np.__version__}")


# run in a subprocess: the count and name of the CUDA devices, and one
# matmul's checksum through device 0
_ACCEL_CODE = (
    "import sys, torch\n"
    "if not torch.cuda.is_available():\n"
    "    sys.exit('no CUDA device found (torch.cuda.is_available() is False)')\n"
    "x = torch.ones((128, 128), dtype=torch.float32, device='cuda:0')\n"
    "s = float((x @ x).sum())\n"
    "torch.cuda.synchronize()\n"
    "print(torch.cuda.device_count(), s, torch.cuda.get_device_name(0))\n")


def _accelerator():
    # A SUBPROCESS with a kill timeout: a hung device op sits inside a C
    # call, where an in-process SIGALRM handler can never run (CPython
    # delivers signals only between bytecodes).
    import subprocess

    try:
        r = subprocess.run([sys.executable, "-c", _ACCEL_CODE], capture_output=True,
                           text=True, timeout=ACCELERATOR_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"no response in {ACCELERATOR_TIMEOUT_S}s — the device or its "
                           "driver is unresponsive") from None
    if r.returncode != 0:
        raise RuntimeError(r.stderr.strip().splitlines()[-1] if r.stderr.strip()
                           else f"rc={r.returncode}")
    n, s, name = r.stdout.strip().splitlines()[-1].split(" ", 2)
    assert float(s) == 128.0 * 128 * 128, s
    return f"{n} CUDA device(s), [0]={name}, matmul ok"


def _native_libs():
    # the port's own libraries (flexflow_tpu_torch/native/*.cpp, g++ into
    # _build/ at first use); never the JAX package's native/*.so
    from ..kernels import _build as kbuild
    from ..utils import native

    built = []
    for source in ("ffsim.cpp", "ffsearch.cpp"):
        info = native.build_info(source)
        how = f"built in {info['seconds']:.1f}s" if info["seconds"] else "built"
        built.append(f"{os.path.splitext(source)[0]} {how}")
    try:
        nvcc = f"nvcc {kbuild.nvcc()} (kernels/csrc/*.cu build at first use)"
    except RuntimeError:
        nvcc = "nvcc not found (the CUDA kernels cannot be built on this host)"
    return f"{len(built)}/2 ({', '.join(built)} -> {native.BUILD_DIR}); {nvcc}"


def _optional_deps():
    import importlib.util

    mods = [m for m in ("triton", "scipy", "einops", "hypothesis")
            if importlib.util.find_spec(m) is not None]
    return ", ".join(mods) or "none"


def _observability():
    # Effective config as events.py/health.py will see it, plus a write
    # probe of the configured trace sink: a read-only sink otherwise fails
    # silently at flush time, long after launch.
    from ..observability import events

    tel = os.environ.get("FF_TELEMETRY", "")
    sink = events.default_path()
    health = os.environ.get("FF_HEALTH", "")
    hb = os.environ.get("FF_HEARTBEAT_PATH", "")
    bits = [f"FF_TELEMETRY={'on' if events._env_enabled() else tel or 'off'}",
            f"sink={sink}",
            f"FF_HEALTH={health or 'off'}",
            f"FF_HEARTBEAT_PATH={hb or 'off'}"]
    d = os.path.dirname(os.path.abspath(sink)) or "."
    if not os.path.isdir(d):
        bits.append(f"sink dir missing: {d}")
    elif not os.access(d, os.W_OK):
        raise PermissionError(f"trace sink dir not writable: {d} ({', '.join(bits)})")
    else:
        bits.append("sink writable")
    return ", ".join(bits)


def _metrics():
    # Effective live-metrics env as observability/metrics.py and opprof.py
    # will see it (a typo'd port or cadence raises here, not at launch),
    # plus a bind probe of the configured exporter port.
    import socket

    from ..observability import events, metrics, opprof

    port = metrics.metrics_port_from_env()    # ValueError on garbage
    cadence = opprof.cadence_from_env()       # ValueError on garbage
    bits = []
    if port is None:
        bits.append("FF_METRICS_PORT=off")
    else:
        bits.append(f"FF_METRICS_PORT={port}")
        host = os.environ.get("FF_METRICS_HOST", "")
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, port))
            bits.append(f"bind {host or '0.0.0.0'}:{s.getsockname()[1]} ok")
        finally:
            s.close()
        if not events._env_enabled():
            bits.append("WARN: FF_METRICS_PORT set but FF_TELEMETRY off — the registry "
                        "would see no events (training series empty; serving state "
                        "still scrapes)")
    if cadence is None:
        bits.append("FF_OPPROF=off")
    else:
        bits.append(f"FF_OPPROF={cadence} (budget {opprof.budget_from_env()}s, "
                    f"corpus {opprof.corpus_path_from_env()})")
        if not events._env_enabled():
            bits.append("WARN: FF_OPPROF set but FF_TELEMETRY off — op attribution emits "
                        "nothing without a log")
    return ", ".join(bits)


def _tracing():
    # Effective request-tracing + SLO env as reqtrace.py/slo.py will see it
    # (a typo'd sample rate or SLO target raises here, not at admission),
    # then a synthetic traced request round-tripped through
    # tools/timeline_export.py, so a broken exporter is a launch-time finding.
    import tempfile

    from ..observability import events, reqtrace, slo
    from . import timeline_export
    from .trace_report import parse_trace

    rate = reqtrace.sample_rate_from_env()    # ValueError on garbage
    chunk = reqtrace.chunk_tokens_from_env()  # ValueError on garbage
    targets = slo.targets_from_env()          # ValueError on garbage
    windows = slo.windows_from_env()
    bits = [f"FF_TRACE_SAMPLE={rate:g}", f"FF_TRACE_CHUNK={chunk or 'off'}"]
    if rate > 0 and not events._env_enabled():
        bits.append("WARN: FF_TRACE_SAMPLE set but FF_TELEMETRY off — no log exists, so "
                    "no trace is ever recorded")
    if targets:
        bits.append("SLOs: " + ", ".join(
            t.name + (f"<{t.threshold_s * 1e3:g}ms" if t.threshold_s is not None else "")
            for t in targets)
            + f" @ {targets[0].objective:g} over "
            + "/".join(f"{int(w)}s" for w in windows))
    else:
        bits.append("SLOs: all disabled")

    with tempfile.TemporaryDirectory() as d:
        log = events.EventLog(os.path.join(d, "probe.jsonl"))
        ctx = reqtrace.TraceContext(reqtrace.new_trace_id(), reqtrace.new_span_id(), None,
                                    True)
        att = ctx.child()
        log.span_at("serve_request", 0.0, 0.01, request_id="probe-0", status="done",
                    **ctx.ids())
        log.span_at("serve_attempt", 0.001, 0.009, request_id="probe-0#a1", **att.ids())
        log.span_at("serve_prefill", 0.002, 0.003, request_id="probe-0#a1",
                    **reqtrace.tag(att))
        log.span_at("serve_decode", 0.005, 0.004, request_id="probe-0#a1",
                    **reqtrace.tag(att))
        log.close()
        doc = timeline_export.export_records(parse_trace(os.path.join(d, "probe.jsonl")))
    s = timeline_export.summarize(doc)
    if s["request_tracks"] < 1 or s["spans"] < 4:
        raise RuntimeError(f"timeline round trip lost the synthetic request: {s}")
    bits.append(f"timeline round trip ok ({s['spans']} spans, "
                f"{s['request_tracks']} request tracks)")
    return ", ".join(bits)


def _memory():
    # The memory plane at a glance: the effective FF_MEMPLANE state,
    # whether this host's device reports allocator stats (a card: yes; the
    # CPU: no, so live hbm_bytes gauges will be absent), and an analytic
    # headroom check of the default transformer against the H100 machine
    # model.  WARN when the serving KV-block budget plus the model's state
    # cannot fit the card: that otherwise surfaces as an OOM at the first
    # full-load prefill.
    import torch

    import flexflow_tpu_torch as ft
    from ..models.transformer import build_transformer
    from ..observability import events, memplane
    from ..observability.stepstats import device_memory_stats
    from ..serving.config import ServeConfig
    from ..simulator.machine import H100MachineModel
    from ..simulator.memory import memory_per_device

    mp = os.environ.get("FF_MEMPLANE", "")
    bits = [f"FF_MEMPLANE={'on' if memplane.enabled_from_env() else mp or 'off'}"]
    if memplane.enabled_from_env() and not events._env_enabled():
        bits.append("WARN: FF_MEMPLANE set but FF_TELEMETRY off — capture and memory "
                    "events have no log to land in (inert)")
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    mems = device_memory_stats(dev)
    if mems:
        bits.append(f"allocator stats: {len(mems)} device(s) report")
    else:
        bits.append("allocator stats: unavailable (the CPU reports none)")

    # graph build only: memory_per_device needs no compile
    m = ft.FFModel(ft.FFConfig(batch_size=8, device="cpu"))
    layers, embed = 4, 512
    build_transformer(m, 8, seq_length=128, num_layers=layers, embed_dim=embed, num_heads=8)
    mem = memory_per_device(m, machine_model=H100MachineModel.calibrated(num_devices=8))
    peak, cap = mem["peak_bytes"], mem["capacity_bytes"]
    bits.append(f"predicted peak (default transformer, 8 GPUs): {peak / 2**20:.0f} MiB of "
                f"{cap / 2**30:.0f} GiB HBM ({100.0 * (cap - peak) / cap:.1f}% headroom, "
                f"dominant {mem['dominant_term']})")

    scfg = ServeConfig.from_env()
    # per-position KV state of the headroom model: K + V, all layers, f32
    kv_bytes_per_block = scfg.kv_block * 2 * embed * layers * 4
    kv_budget = scfg.kv_blocks_resolved() * kv_bytes_per_block
    if kv_budget + peak > cap:
        bits.append(f"WARN: serving KV budget ({scfg.kv_blocks_resolved()} blocks ~ "
                    f"{kv_budget / 2**30:.1f} GiB) + model state ({peak / 2**30:.1f} GiB) "
                    f"exceeds HBM capacity ({cap / 2**30:.0f} GiB) — expect serving OOM at "
                    "full load")
    else:
        bits.append(f"serving KV budget fits: {scfg.kv_blocks_resolved()} blocks ~ "
                    f"{kv_budget / 2**20:.0f} MiB on top of model state")
    return ", ".join(bits)


def _resilience():
    # Effective chaos/recovery env as chaos.py/resilience.py will see it: an
    # invalid FF_CHAOS spec fails here, not silently at train time; the
    # checkpoint dir gets a writability probe.
    from ..runtime import resilience
    from ..testing import chaos

    spec = os.environ.get("FF_CHAOS", "")
    bits = []
    if spec:
        bits.append(f"FF_CHAOS={chaos.ChaosMonkey(spec).describe()}, "
                    f"seed={os.environ.get('FF_CHAOS_SEED', '0')}")
    else:
        bits.append("FF_CHAOS=off")
    nf = resilience.nonfinite_limit()
    bits.append(f"FF_SKIP_NONFINITE={nf if nf else 'off'}")
    bits.append(f"FF_CKPT_RETRIES={resilience.ckpt_retries()}")
    ckpt_dir = os.environ.get("FF_CKPT_DIR", "")
    if ckpt_dir:
        d = os.path.abspath(ckpt_dir)
        probe = d if os.path.isdir(d) else (os.path.dirname(d) or ".")
        if not os.path.isdir(probe):
            raise FileNotFoundError(f"FF_CKPT_DIR parent missing: {probe}")
        if not os.access(probe, os.W_OK):
            raise PermissionError(f"FF_CKPT_DIR not writable: {d}")
        bits.append(f"FF_CKPT_DIR={d} (writable)")
    return ", ".join(bits)


def _toy_model(batch: int, width: int, hidden: int, classes: int, **cfg):
    """A dense -> dense -> softmax graph on the CPU; (model, input)."""
    import flexflow_tpu_torch as ft

    m = ft.FFModel(ft.FFConfig(batch_size=batch, device="cpu", **cfg))
    inp = m.create_tensor((batch, width), nchw=False, name="x")
    t = m.dense(inp, hidden, activation="relu", name="fc1")
    t = m.dense(t, classes, name="fc2")
    m.softmax(t, name="sm")
    return m, inp


def _reconfiguration():
    # Effective FF_RECONFIG_* env as reconfigure.py will see it; when armed,
    # a tiny seeded mcmc over a toy graph on the host, so that a broken
    # simulator stack is a launch-time finding, not a mid-swap error.
    import flexflow_tpu_torch as ft
    from ..runtime.reconfigure import ReconfigPolicy
    from ..simulator.search import mcmc_search

    policy = ReconfigPolicy.from_env()  # ValueError on a bad knob
    if policy is None:
        return "FF_RECONFIGURE=off"
    bits = [f"FF_RECONFIGURE=on, {policy.describe()}"]
    m, _ = _toy_model(16, 8, 16, 4)
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    res = mcmc_search(m, num_devices=4, budget=4, seed=0, verbose=False)
    bits.append(f"search probe: best {res.best_s * 1e3:.3f} ms (budget 4, 4 devices)")
    return ", ".join(bits)


def _serving():
    # Effective FF_SERVE_* env as serving/config.py will see it (a bad
    # value raises here, not at server startup), plus a bind probe of the
    # configured HTTP endpoint.
    import socket

    from ..serving.config import ServeConfig

    cfg = ServeConfig.from_env()  # ValueError on a typo'd env var
    bits = [cfg.describe()]
    if cfg.hedge_ms and cfg.replicas < 2:
        bits.append("WARN: FF_SERVE_HEDGE_MS set but FF_SERVE_REPLICAS<2 — hedging needs a "
                    "second replica (inert)")
    if cfg.restart_backoff_s > cfg.restart_cap_s > 0:
        bits.append("WARN: FF_SERVE_RESTART_BACKOFF_S exceeds FF_SERVE_RESTART_CAP_S "
                    "(every restart waits the cap)")
    if cfg.paged != "off":
        if cfg.max_seq % cfg.kv_block:
            bits.append(f"ERROR: FF_SERVE_KV_BLOCK={cfg.kv_block} does not divide "
                        f"max_seq={cfg.max_seq} — paged KV falls back to dense "
                        "(FF_SERVE_PAGED=on would refuse to start)")
        else:
            worst = cfg.max_batch * cfg.blocks_per_seq()
            bits.append(f"paged kv: block={cfg.kv_block} budget={cfg.kv_blocks_resolved()} "
                        "blocks " + ("(FF_SERVE_KV_BLOCKS)" if cfg.kv_blocks
                                     else "(dense worst case)"))
            if cfg.kv_blocks_resolved() < worst:
                bits.append(f"WARN: FF_SERVE_KV_BLOCKS={cfg.kv_blocks} cannot hold "
                            f"max_batch={cfg.max_batch} worst-case sequences (need {worst}) "
                            "— expect admission sheds at full load")
    probe_port = cfg.port if os.environ.get("FF_SERVE_PORT") else 0
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((cfg.host, probe_port))
        bound = s.getsockname()[1]
        bits.append(f"bind {cfg.host}:{bound} ok" + ("" if probe_port else " (ephemeral probe)"))
    finally:
        s.close()
    return ", ".join(bits)


def _autoscaler():
    # Effective FF_SCALE_* env as serving/autoscaler.py will see it, plus
    # the fleet-shape cross-checks.
    from ..serving.autoscaler import ScaleConfig
    from ..serving.config import ServeConfig

    cfg = ScaleConfig.from_env()   # ValueError on a typo'd env var
    bits = [cfg.describe()]
    if not cfg.enabled:
        bits.append("pool size is static")
        return ", ".join(bits)
    serve = ServeConfig.from_env()
    if serve.zones and cfg.max_replicas < 2 * len(serve.zones):
        bits.append(f"WARN: FF_SCALE_MAX={cfg.max_replicas} < 2x {len(serve.zones)} zones — "
                    "after a zone outage the survivors cannot rebuild full redundancy")
    if not os.environ.get("FF_TELEMETRY") and not os.environ.get("FF_METRICS_PORT"):
        bits.append("WARN: autoscaler enabled without FF_TELEMETRY or FF_METRICS_PORT — "
                    "scale decisions and burn-rate inputs will be invisible")
    return ", ".join(bits)


def _search():
    # Effective FF_SEARCH_* env as simulator/population.py will see it,
    # plus a learned-tier corpus probe over the card's measurements.
    from ..simulator.cost_model import LEARNED_MIN_POINTS, LearnedCostTier
    from ..simulator.machine import H100MachineModel
    from ..simulator.population import PopulationKnobs

    knobs = PopulationKnobs.from_env()  # ValueError on a bad knob
    ladder = (",".join(f"{m:g}" for m in knobs.ladder) if knobs.ladder
              else f"ratio {knobs.ladder_ratio:g}")
    bits = [f"FF_SEARCH_POPULATION={knobs.population}",
            f"ladder {ladder}",
            f"exchange every {knobs.exchange_every or 'off'}",
            f"crossover every {knobs.crossover_every or 'off'}",
            "FF_SEARCH_LEARNED=" + ("auto (population only)" if knobs.learned is None
                                    else "on" if knobs.learned else "off")]
    if knobs.learned is not False:
        tier = LearnedCostTier.fit_default(H100MachineModel.calibrated(num_devices=8))
        prov = tier.provenance
        if not prov["used_families"]:
            bits.append(f"WARN: learned tier {'forced on' if knobs.learned else 'enabled'} "
                        f"but no family clears it (corpus {prov['corpus_points']} points, "
                        f"need {LEARNED_MIN_POINTS}/family AND a CV win) — searches price "
                        "analytically")
        else:
            bits.append(f"learned tier: {', '.join(prov['used_families'])} win CV "
                        f"(corpus {prov['corpus_points']} points)")
    return ", ".join(bits)


def _perf(probe: bool):
    # The measurement state at a glance: is a card reachable right now
    # (subprocess, 10 s cap — never hangs the doctor), how much of the cost
    # model is grounded in the card's measurements, and the last good card
    # number in the port's perf ledger.
    import time as _time

    from ..observability import chipwatch
    from ..simulator import cost_model as cm
    from . import perf_ledger
    from .report_configs import CALIBRATION_TARGET_ENTRIES

    bits = []
    if probe:
        res = chipwatch.probe_once(timeout=PERF_PROBE_TIMEOUT_S)
        bits.append(f"chip probe: ok [{res.device_kind}] in {res.latency_s:.1f}s" if res.ok
                    else f"chip probe: unreachable ({res.detail})")
    else:
        bits.append("chip probe: skipped")

    fams = {}
    for k in cm.read_measured(cm.MEASURED_CACHE, "cuda"):
        fam = k.split(":", 1)[0]
        fams[fam] = fams.get(fam, 0) + 1
    n_measured = sum(fams.values())
    if n_measured:
        by_fam = ", ".join(f"{k}:{fams[k]}" for k in sorted(fams, key=fams.get, reverse=True))
        cov = n_measured / CALIBRATION_TARGET_ENTRIES
        bits.append(f"measured cache: {n_measured} cuda entries ({by_fam}; {cov:.0%} of the "
                    f"{CALIBRATION_TARGET_ENTRIES}-entry target — the rest costs by the "
                    "roofline)")
    else:
        bits.append("measured cache: EMPTY — every op costs by the roofline")

    lg = perf_ledger.last_good()
    if lg:
        age = (_time.time() - lg.get("unix_time", 0)) / 86400.0
        bits.append(f"last good card number: {lg.get('value'):.0f} {lg.get('unit', '')} @ "
                    f"{lg.get('commit') or '?'} ({age:.1f}d ago)")
    else:
        bits.append(f"last good card number: none in ledger ({perf_ledger.default_path()})")
    return ", ".join(bits)


def _lowering_check():
    # Whole-graph lowering (parallel/lowering.py): the strict FF_LOWERED
    # parse, a one-step probe of a tiny seeded model on the CPU lowered
    # against per-op dispatch (bitwise: aot_eager), a warning when its plan
    # puts a non-sample dim on a hybrid mesh's ``dcn`` dim, and the shipped
    # strategies audited against the mesh shadow of their device count.
    import numpy as np

    import flexflow_tpu_torch as ft
    from ..parallel import lowering as low
    from ..parallel.distributed import host_count

    env = low.lowered_from_env()  # ValueError on a bad value: required-loud
    eff = low.resolve_lowered(None, 1, host_count())
    bits = [f"FF_LOWERED={'auto' if env is None else env} "
            f"(effective {'on' if eff else 'off'} on this host)"]

    def probe(flag):
        m, inp = _toy_model(8, 8, 16, 4, lowered=flag)
        m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
        m.init_layers(seed=0)
        rng = np.random.default_rng(1)
        m.set_batch({inp: rng.standard_normal((8, 8), dtype=np.float32)},
                    rng.integers(0, 4, size=(8, 1), dtype=np.int32))
        m.train_iteration()
        m.sync()
        return m

    ml = probe(True)
    assert ml._lowering is not None, "probe model did not lower"
    md = probe(False)
    assert np.array_equal(ml.get_parameter("fc2", "kernel"), md.get_parameter("fc2", "kernel")), \
        "lowered probe diverged from per-op dispatch"
    bits.append("probe-lower: 1-step train bitwise == per-op dispatch")
    spill = ml._lowering.dcn_spill
    if spill:
        bits.append(f"WARN: dcn axis carries non-sample dims here: {spill}")

    # shipped strategies against the mesh shadow of their recorded device
    # count (nodes of 8 GPUs)
    from ..parallel.strategy import (DEFAULT_STRATEGY_DIR, load_strategies_from_file,
                                     read_provenance)
    from ..simulator.machine import H100MachineModel

    warns = []
    if os.path.isdir(DEFAULT_STRATEGY_DIR):
        for fn in sorted(os.listdir(DEFAULT_STRATEGY_DIR)):
            if not fn.endswith(".pb"):
                continue
            path = os.path.join(DEFAULT_STRATEGY_DIR, fn)
            try:
                nd = int((read_provenance(path) or {}).get("num_devices", 0))
                strategies = load_strategies_from_file(path)
                mm = H100MachineModel(num_devices=nd) if nd > 0 else None
            except Exception:  # noqa: BLE001 — an unreadable file is not this check's
                continue
            if mm is None:
                continue
            spilled = [op for op, pc in sorted(strategies.items()) if mm.dcn_spill(pc.dims)]
            if spilled:
                warns.append(f"{fn}: {', '.join(spilled)}")
    if warns:
        bits.append("WARN: non-sample dims would land on the dcn axis (a lowered multi-node "
                    "run reshards these over InfiniBand every step): " + "; ".join(warns))
    else:
        bits.append("shipped strategies: no non-sample dcn placement")
    return ", ".join(bits)


def _cpu_train():
    import numpy as np

    import flexflow_tpu_torch as ft

    m, inp = _toy_model(16, 8, 32, 4)
    m.compile(ft.SGDOptimizer(lr=0.5), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 8), dtype=np.float32)
    y = np.argmax(x[:, :4], 1).astype(np.int32)[:, None]
    losses = []
    for _ in range(20):
        m.set_batch({inp: x}, y)
        m.train_iteration()
        m.sync()
        m.get_metrics()
        losses.append(m.last_loss)
        m.reset_metrics()
    assert losses[-1] < losses[0] * 0.5, f"loss did not drop: {losses}"
    return f"loss {losses[0]:.3f} -> {losses[-1]:.3f} in 20 steps"


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--skip-accelerator", action="store_true",
                   help="skip the CUDA device probes (e.g. on a CPU-only host, or when the "
                        "card is known bad)")
    args = p.parse_args(argv)

    plan = [("versions", _versions, True)]
    if not args.skip_accelerator:
        plan.append(("accelerator", _accelerator, False))
    plan += [("native libs", _native_libs, False),
             ("optional deps", _optional_deps, False),
             ("observability", _observability, False),
             ("metrics", _metrics, False),
             ("tracing", _tracing, False),
             ("memory", _memory, False),
             ("perf", lambda: _perf(probe=not args.skip_accelerator), False),
             ("search", _search, False),
             ("resilience", _resilience, False),
             ("reconfiguration", _reconfiguration, False),
             ("serving", _serving, False),
             ("autoscaler", _autoscaler, False),
             ("lowering", _lowering_check, False),
             ("cpu training", _cpu_train, True)]

    # print each line as its check completes: the slow checks (the 90 s
    # device probe, the training loop) show live progress
    width = max(len(n) for n, _, _ in plan)
    failed = False
    for name, fn, required in plan:
        _, status, detail = _check(name, fn, required)
        print(f"[{status:<4}] {name:<{width}}  {detail}", flush=True)
        failed |= status == "FAIL"
    print("doctor:", "FAIL" if failed else "all required checks passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
