"""Deterministic fleet-scale incident scenarios (SLO goodput through chaos):
the PyTorch port of the JAX package's ``testing/fleet.py``.

A seeded traffic shape replays against a LIVE pool+autoscaler and is
scored by what an SRE would score —

  * offered vs attained RPS, where "attained" means the request
    finished within its end-to-end SLO AND matched (below),
  * shed vs failed split (admission control refusing politely is not
    the same failure as a lost response),
  * the replica-count timeline and, for incident scenarios,
    time-to-recover (zone goes dark -> ready count restored).

"Matches" is the caller's rule, applied after the run to every finished
request (``matches(prompts, new_tokens, outputs) -> [bool]``).  The
default is the JAX package's: bitwise equal to ``FFModel.generate()`` of
the same prompt, which holds on the CPU.  On the card in bf16 it is no
promise across batch compositions (the GEMMs round differently at other
shapes, so a near-tie may break the other way), and ``chip_smoke.py``
passes its gap rule instead: equal to ``generate``, or differing first
at a token whose f32 probability lies within ``BF16_GAP_TOL`` of the
top one.

Scenarios (all driven by one seed; same seed => same arrivals, same
prompts, same chaos trigger):

  diurnal       sinusoidal rate ramp — the autoscaler should follow
                the wave up and (cooldown permitting) back down
  flash_crowd   steady trickle, then 40% of all traffic lands in a
                ~7% window — shedding + scale-up under burst
  long_tail     lognormal prompt/decode mix — a few huge requests
                head-of-line-block the small ones; hedging territory
  zone_outage   steady load, then chaos kills a whole zone mid-run —
                failover is exactly-once, the autoscaler backfills the
                surviving zone, goodput dips but correctness never does

``run_scenario`` builds the port's tiny serving transformer
(``build_serve_model``, on ``cuda`` unless ``device="cpu"``) or serves
the model it is given (the card's, at full width), injects the scenario's chaos on that model's monkey,
replays the trace and returns the score dict ``tools/fleet_bench.py``
writes.  Given ``slices`` (serving/remote.py), the pool's replicas are
those slices of cards instead, one a replica, the autoscaler's adds their
hub's spares, and each slice's leader gets the chaos spec: its serve site
counts that slice's admissions, so the trigger is the pool-wide one
divided among the slices.
"""

from __future__ import annotations

import dataclasses
import math
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..serving.autoscaler import ScaleConfig

DEFAULT_SLO_MS = 3000.0
_SAMPLE_IV_S = 0.02       # replica-timeline sampler period


# ----------------------------------------------------------------------
# arrival shapes (deterministic: seeded, or closed-form in i/n)
# ----------------------------------------------------------------------
def _offsets_diurnal(n: int, duration: float, rng: random.Random) \
        -> List[float]:
    """Inverse-CDF sample of rate(t) = 1 + 0.8*sin(2*pi*(t/D - 0.25)):
    a trough at t=0 rising to a peak at D/2 and back — one 'day'."""
    grid = 512
    dens = [1.0 + 0.8 * math.sin(2 * math.pi * (k / grid - 0.25))
            for k in range(grid + 1)]
    cum = [0.0]
    for k in range(grid):
        cum.append(cum[-1] + (dens[k] + dens[k + 1]) / 2.0)
    total = cum[-1]
    out = []
    for i in range(n):
        target = (i + 0.5) / n * total
        k = next(j for j in range(grid + 1) if cum[j] >= target)
        out.append((k / grid) * duration)
    return out


def _offsets_flash(n: int, duration: float, rng: random.Random) \
        -> List[float]:
    """60% trickle over the first 55%, then 40% crammed into [0.55D,
    0.62D] — the flash crowd."""
    n_base = max(1, int(n * 0.6))
    out = sorted(rng.uniform(0.0, 0.55 * duration)
                 for _ in range(n_base))
    out += sorted(rng.uniform(0.55 * duration, 0.62 * duration)
                  for _ in range(n - n_base))
    return out


def _offsets_poisson(n: int, duration: float, rng: random.Random) \
        -> List[float]:
    rate = n / duration
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate)
        out.append(min(t, duration))
    return out


def _offsets_uniform(n: int, duration: float, rng: random.Random) \
        -> List[float]:
    return [duration * (i + 0.5) / n for i in range(n)]


# ----------------------------------------------------------------------
# prompt mixes
# ----------------------------------------------------------------------
def _mix_uniform(n: int, rng: random.Random) -> List[Tuple[int, int]]:
    """(prompt_len, new_tokens) per request."""
    return [(rng.randint(3, 10), 6) for _ in range(n)]


def _mix_long_tail(n: int, rng: random.Random) -> List[Tuple[int, int]]:
    out = []
    for _ in range(n):
        plen = min(24, max(3, int(rng.lognormvariate(1.6, 0.7))))
        new = min(12, max(3, int(rng.lognormvariate(1.7, 0.5))))
        out.append((plen, new))
    return out


@dataclasses.dataclass
class Scenario:
    name: str
    description: str
    duration_s: float
    offsets: Callable[[int, float, random.Random], List[float]]
    mix: Callable[[int, random.Random], List[Tuple[int, int]]]
    replicas: int = 1
    zones: Tuple[str, ...] = ()
    max_queue: int = 0
    scale: Optional[Dict[str, Any]] = None      # ScaleConfig overrides
    # chaos spec as a function of (n, n_warm) — the warmup admissions
    # shift the serve-site trigger index (None: no incident)
    chaos: Optional[Callable[[int, int], str]] = None


def _zone_chaos(n: int, n_warm: int) -> str:
    # outage fires mid-load: at roughly the n/3rd SCORED admission
    # (warmup admissions hit the same chaos site counter, so offset),
    # zone index 1 ("zone-b") goes dark
    return f"serve:{n_warm + max(2, n // 3)}=zone_outage:1"


SCENARIOS: Dict[str, Scenario] = {
    "diurnal": Scenario(
        "diurnal", "sinusoidal rate ramp; scaler follows the wave",
        duration_s=3.0, offsets=_offsets_diurnal, mix=_mix_uniform,
        replicas=1,
        scale=dict(min_replicas=1, max_replicas=3, interval_s=0.05,
                   up_queue=2.0, down_queue=0.25, streak=2,
                   up_cooldown_s=0.2, down_cooldown_s=1.0)),
    "flash_crowd": Scenario(
        "flash_crowd", "steady trickle then a burst; shed + scale up",
        duration_s=3.0, offsets=_offsets_flash, mix=_mix_uniform,
        replicas=1, max_queue=12,
        scale=dict(min_replicas=1, max_replicas=4, interval_s=0.05,
                   up_queue=2.0, down_queue=0.25, streak=2,
                   up_cooldown_s=0.2, down_cooldown_s=2.0)),
    "long_tail": Scenario(
        "long_tail", "lognormal prompt/decode mix; head-of-line blocking",
        duration_s=3.0, offsets=_offsets_poisson, mix=_mix_long_tail,
        replicas=2,
        scale=dict(min_replicas=1, max_replicas=3, interval_s=0.05,
                   up_queue=2.0, down_queue=0.25, streak=2,
                   up_cooldown_s=0.2, down_cooldown_s=2.0)),
    "zone_outage": Scenario(
        "zone_outage", "chaos kills a whole zone mid-run; backfill",
        duration_s=3.0, offsets=_offsets_uniform, mix=_mix_uniform,
        replicas=4, zones=("zone-a", "zone-b"), chaos=_zone_chaos,
        scale=dict(min_replicas=4, max_replicas=6, interval_s=0.05,
                   up_queue=4.0, down_queue=0.25, streak=2,
                   up_cooldown_s=0.1, down_cooldown_s=30.0)),
}


def build_serve_model(device: str = "cuda"):
    """The tiny decoder transformer the JAX package's fleet scenarios serve
    (seq 64, one layer, E 16, two heads, vocab 32, weights from seed 3),
    built with the port."""
    import flexflow_tpu_torch as ft
    from ..models.transformer import build_transformer

    m = ft.FFModel(ft.FFConfig(batch_size=4, device=device))
    build_transformer(m, 4, seq_length=64, num_layers=1, embed_dim=16, num_heads=2,
                      vocab_size=32)
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=3)
    return m


def generate_matches(model) -> Callable[[Sequence, Sequence, Sequence], List[bool]]:
    """The default rule: each output bitwise equal to ``model.generate``."""
    import numpy as np

    def matches(prompts, news, outs):
        return [bool(np.array_equal(out, model.generate(p[None], n)[0]))
                for p, n, out in zip(prompts, news, outs)]
    return matches


def run_scenario(name: str, requests: int = 16, seed: int = 0,
                 slo_ms: float = DEFAULT_SLO_MS,
                 telemetry_file: Optional[str] = None, model=None,
                 serve: Optional[Dict[str, Any]] = None,
                 matches: Optional[Callable] = None,
                 traffic: Optional[Sequence[Tuple[Any, int]]] = None,
                 pool_warmup: bool = False,
                 device: str = "cuda",
                 slices: Optional[Sequence[Any]] = None) -> Dict[str, Any]:
    """Replay one scenario against a live pool+autoscaler and score it.
    Deterministic traffic under a fixed seed; wall-clock latencies vary
    with the host, which is why the SLO is a knob.

    ``model``: the compiled model to serve (default: ``build_serve_model``
    on ``device``); ``serve``: ``ServeConfig`` fields over the scenario's
    (max_batch 2, max_seq 64, max_new_tokens 16); ``matches``: the
    correctness rule (default ``generate_matches``); ``traffic``: the
    requests to send, ``(prompt, new_tokens)`` pairs in arrival order, in
    place of the scenario's mix (their count replaces ``requests``; the
    default mix draws prompt tokens below 32, the tiny model's
    vocabulary); ``pool_warmup``: capture every replica's decode graphs
    before it serves (``ReplicaPool(warmup=True)``), else the JAX
    package's unscored warm-up waves run first, one per prompt bucket
    sized to fill every replica; ``slices``: serve over these slices of
    cards (``RemoteSlice``), one a replica, in place of the scenario's
    replicas of ``model`` (the model, or ``matches``, is then only the
    reference)."""
    import numpy as np

    from ..observability import events
    from ..serving import Autoscaler, ReplicaPool, ServeConfig
    from ..serving.queue import ServeOverload, ServeTimeout
    from .chaos import ChaosMonkey

    sc = SCENARIOS[name]
    n = int(requests) if traffic is None else len(traffic)
    # str-seeded Random hashes via sha512 — stable across processes
    # (unlike hash(), which is salted)
    rng = random.Random(f"{seed}:{name}")
    offsets = sc.offsets(n, sc.duration_s, rng)
    mix = sc.mix(n, rng) if traffic is None else [(len(p), nt) for p, nt in traffic]

    if slices is not None and model is None and matches is None:
        raise ValueError("run_scenario over slices needs matches= or a reference model=")
    if model is None and slices is None:
        model = build_serve_model(device)
    replicas = sc.replicas if slices is None else len(slices)
    saved_chaos = getattr(model, "_chaos", None)
    log = events.EventLog(telemetry_file) if telemetry_file else None
    try:
        kw = dict(max_batch=2, max_seq=64, max_new_tokens=16)
        kw.update(serve or {})
        cfg = ServeConfig(
            replicas=replicas, zones=sc.zones,
            max_queue=sc.max_queue, queue_timeout_s=60.0,
            replica_timeout_s=120.0,
            restart_backoff_s=0.05, restart_cap_s=0.2, **kw)
        # warmup plan: one wave per distinct prompt bucket, sized so
        # every replica admits a full batch — the first admissions of each
        # bucket run before the scored window.  Deterministic given the seed.
        buckets = sorted({b for b in (cfg.bucket_for(p) for p, _ in mix)
                          if b is not None}) if not pool_warmup else []
        warm_plen = {b: max(p for p, _ in mix if cfg.bucket_for(p) == b)
                     for b in buckets}
        warm_new = {b: max(nt for p, nt in mix if cfg.bucket_for(p) == b)
                    for b in buckets}
        n_warm = len(buckets) * replicas * cfg.max_batch
        # the chaos trigger counts admissions on this model's monkey, which
        # every replica's engine shares; over slices, on each slice's
        # leader, which counts its own share
        spec = sc.chaos(n, n_warm) if sc.chaos is not None else None
        if slices is None:
            model._chaos = ChaosMonkey(spec) if spec is not None else None
        else:
            for sl in slices:
                sl.set_chaos(None if spec is None else _divided(spec, len(slices)))
        prng = np.random.default_rng(seed)
        prompts = [prng.integers(0, 32, size=plen) for plen, _ in mix] \
            if traffic is None else [np.asarray(p) for p, _ in traffic]
        news = [new for _, new in mix]

        scale_cfg = ScaleConfig(**(sc.scale or
                                   dict(min_replicas=1, max_replicas=2)))
        pool = ReplicaPool(model if slices is None else list(slices), cfg, telemetry=log,
                           warmup=pool_warmup)
        scaler = Autoscaler(pool, scale_cfg)

        rows: List[Dict[str, Any]] = [dict() for _ in range(n)]
        outs: List[Any] = [None] * n
        timeline: List[Tuple[float, int, int]] = []
        incident = {"t_down": None, "ready_before": None,
                    "ready_min": None, "t_recovered": None}
        stop_sampler = threading.Event()
        t0 = time.perf_counter()

        def sample():
            while not stop_sampler.wait(_SAMPLE_IV_S):
                t = time.perf_counter() - t0
                ready = pool.ready_replicas
                total = pool.num_replicas
                if not timeline or timeline[-1][1:] != (ready, total):
                    timeline.append((round(t, 3), ready, total))
                if pool.zones_down() and incident["t_down"] is None:
                    incident["t_down"] = round(t, 3)
                    incident["ready_before"] = timeline[0][1] \
                        if timeline else ready
                    incident["ready_min"] = ready
                elif incident["t_down"] is not None \
                        and incident["t_recovered"] is None:
                    incident["ready_min"] = min(
                        incident["ready_min"], ready)
                    if ready >= incident["ready_before"]:
                        incident["t_recovered"] = round(t, 3)

        def serve_one(i, handle):
            try:
                outs[i] = handle.result(timeout=120.0)
                rows[i]["status"] = "done"
                rows[i]["e2e_s"] = handle.t_done - handle.t_submit
            except ServeTimeout:
                rows[i]["status"] = "timeout"
            except Exception as e:  # noqa: BLE001 — scored, not raised
                rows[i]["status"] = "failed"
                rows[i]["error"] = f"{type(e).__name__}: {e}"

        waiters = []
        with pool:
            # warmup waves (unscored, before the scaler and the clock)
            for b in buckets:
                wave = [pool.submit(np.zeros(warm_plen[b], np.int32),
                                    warm_new[b])
                        for _ in range(replicas * cfg.max_batch)]
                for h in wave:
                    try:
                        h.result(timeout=120.0)
                    except Exception:   # noqa: BLE001 — best-effort
                        pass
            with scaler:
                sampler = threading.Thread(target=sample, daemon=True)
                sampler.start()
                t0 = time.perf_counter()
                for i, off in enumerate(offsets):
                    dt = t0 + off - time.perf_counter()
                    if dt > 0:
                        time.sleep(dt)
                    try:
                        h = pool.submit(prompts[i], mix[i][1])
                    except ServeOverload:
                        rows[i]["status"] = "shed"
                        continue
                    w = threading.Thread(target=serve_one, args=(i, h),
                                         daemon=True)
                    w.start()
                    waiters.append(w)
                for w in waiters:
                    w.join(180.0)
                wall = time.perf_counter() - t0
                # let the scaler see the quiet tail briefly (scale-down
                # evidence for the diurnal scenario)
                time.sleep(0.3)
                stop_sampler.set()
                sampler.join(2.0)
                scaler_stats = scaler.stats()
                pool_stats = pool.stats()

        done = [i for i, r in enumerate(rows) if r.get("status") == "done"]
        check = matches if matches is not None else generate_matches(model)
        for i, ok in zip(done, check([prompts[i] for i in done], [news[i] for i in done],
                                     [outs[i] for i in done])):
            rows[i]["correct"] = bool(ok)
        n_done = len(done)
        n_good = sum(r.get("status") == "done" and r.get("correct")
                     and r.get("e2e_s", 1e9) * 1000.0 <= slo_ms
                     for r in rows)
        n_incorrect = sum(r.get("status") == "done"
                          and not r.get("correct") for r in rows)
        n_shed = sum(r.get("status") == "shed" for r in rows)
        n_failed = sum(r.get("status") in ("failed", "timeout")
                       for r in rows)
        n_lost = sum("status" not in r for r in rows)
        ttr = None
        if incident["t_down"] is not None \
                and incident["t_recovered"] is not None:
            ttr = round(incident["t_recovered"] - incident["t_down"], 3)
        return dict(
            scenario=name, seed=int(seed), requests=n,
            slo_ms=float(slo_ms), duration_s=round(wall, 3),
            offered_rps=round(n / wall, 3),
            attained_rps=round(n_good / wall, 3),
            goodput_rps=round(n_good / wall, 3),
            slo_attainment=round(n_good / n, 4),
            n_done=n_done, n_good=n_good, n_shed=n_shed,
            n_failed=n_failed, n_incorrect=n_incorrect, n_lost=n_lost,
            time_to_recover_s=ttr,
            incident=incident if incident["t_down"] is not None else None,
            replica_timeline=timeline[:200],
            scale_events=dict(ups=scaler_stats["scale_ups"],
                              downs=scaler_stats["scale_downs"]),
            pool=dict(failovers=pool_stats["failovers"],
                      replica_downs=pool_stats["replica_downs"],
                      replicas_added=pool_stats["replicas_added"],
                      replicas_retired=pool_stats["replicas_retired"],
                      shed=pool_stats["shed"],
                      ready_replicas=pool_stats["ready_replicas"]),
        )
    finally:
        if model is not None:
            model._chaos = saved_chaos
        for sl in slices or ():
            sl.set_chaos(None)
        if log is not None:
            log.close()


def _divided(spec: str, parts: int) -> str:
    """A serve-site spec whose triggers count ``parts`` slices' admissions
    in all, as each slice's own (its share, at least 1)."""
    out = []
    for entry in spec.split(";"):
        left, right = entry.split("=", 1)
        site, trigger = left.split(":", 1)
        if not trigger.startswith("p"):
            trigger = str(max(1, int(trigger) // parts))
        out.append(f"{site}:{trigger}={right}")
    return ";".join(out)
