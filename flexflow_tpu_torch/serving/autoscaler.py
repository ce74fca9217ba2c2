"""Metrics-driven autoscaler for the replica pool: a copy of the JAX
package's ``serving/autoscaler.py`` (stdlib only; the port imports nothing
of that package).

The pool (pool.py) makes a FIXED fleet survive failures; this module
makes the fleet SIZE follow load.  One daemon thread samples the pool's
own signals every ``FF_SCALE_INTERVAL_S``:

  * admission-queue depth per ready replica (the backlog signal),
  * the submit->done service-time EWMA (how long that backlog takes),
  * the SLO burn rate (``slo_burn_rate`` gauges from observability/slo.py,
    observed straight off the telemetry EventLog — no scrape needed),

and turns them into ``pool.add_replica()`` / ``pool.drain_replica()``
calls bounded by ``FF_SCALE_MIN``/``FF_SCALE_MAX``.  Policy, in order:

  1. BACKFILL — ready replicas below ``FF_SCALE_MIN`` (a zone outage
     just took half the fleet): add immediately, no hysteresis, only the
     up-cooldown paces consecutive adds.  Placement picks the
     least-populated zone NOT marked down, so capacity returns in
     surviving zones.
  2. SCALE UP — queue depth per ready replica above ``FF_SCALE_UP_QUEUE``
     or burn rate above ``FF_SCALE_UP_BURN`` for ``FF_SCALE_STREAK``
     consecutive ticks (hysteresis), outside the up-cooldown, below
     ``FF_SCALE_MAX``.
  3. SCALE DOWN — queue per replica below ``FF_SCALE_DOWN_QUEUE`` AND
     burn quiet (< half the up threshold) for the streak, outside the
     (longer) down-cooldown, above ``FF_SCALE_MIN``.  The drain is
     GRACEFUL: the victim stops popping new work, finishes its in-flight
     slots (or fails them over if it wedges), then the incarnation is
     retired and its gauge series disappears from ``healthz``.

Every action emits a ``scale_event`` telemetry event and appends to
``Autoscaler.timeline`` — the replica-count-over-time record
fleet_bench and serve_report's "## Fleet" section render.

Knobs (loud ValueError on garbage, naming the variable):

  FF_SCALE_MIN            min ready replicas        (default 1)
  FF_SCALE_MAX            max replicas; 0 DISABLES the autoscaler
                          (default 0 — opt-in)
  FF_SCALE_INTERVAL_S     tick interval seconds     (default 0.25)
  FF_SCALE_UP_QUEUE       queued-per-ready-replica scale-up threshold
                          (default 4)
  FF_SCALE_UP_BURN        slo burn-rate scale-up threshold; 0 ignores
                          burn (default 2)
  FF_SCALE_DOWN_QUEUE     queued-per-ready-replica scale-down threshold
                          (default 0.5)
  FF_SCALE_STREAK         consecutive ticks a signal must persist
                          (default 2)
  FF_SCALE_UP_COOLDOWN_S  min seconds between adds   (default 2)
  FF_SCALE_DOWN_COOLDOWN_S min seconds between drains (default 15)

STDLIB-ONLY: the knobs parse on hosts with no card, and the policy is
unit-tested against a stub pool with a fake clock.  On one card the
replicas it adds share that card (serving/pool.py); over slices of cards
(serving/remote.py) ``add_replica`` claims one of the hub's spare slices
and ``drain_replica`` returns it, under the same rules.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


def _env_int(name: str, default: int, lo: int = 0) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer")
    if v < lo:
        raise ValueError(f"{name}={v} must be >= {lo}")
    return v


def _env_float(name: str, default: float, lo: float = 0.0) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number")
    if v < lo:
        raise ValueError(f"{name}={v} must be >= {lo}")
    return v


@dataclasses.dataclass
class ScaleConfig:
    min_replicas: int = 1
    max_replicas: int = 0          # 0: autoscaler disabled
    interval_s: float = 0.25
    up_queue: float = 4.0          # queued per ready replica
    up_burn: float = 2.0           # slo burn rate; 0 ignores burn
    down_queue: float = 0.5
    streak: int = 2                # hysteresis: consecutive ticks
    up_cooldown_s: float = 2.0
    down_cooldown_s: float = 15.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"FF_SCALE_MIN={self.min_replicas} must be >= 1")
        if self.max_replicas < 0:
            raise ValueError(
                f"FF_SCALE_MAX={self.max_replicas} must be >= 0 "
                f"(0 disables)")
        if self.max_replicas and self.max_replicas < self.min_replicas:
            raise ValueError(
                f"FF_SCALE_MAX={self.max_replicas} must be >= "
                f"FF_SCALE_MIN={self.min_replicas}")
        if self.interval_s <= 0:
            raise ValueError(
                f"FF_SCALE_INTERVAL_S={self.interval_s} must be > 0")
        if self.streak < 1:
            raise ValueError(f"FF_SCALE_STREAK={self.streak} must be >= 1")
        if self.down_queue > self.up_queue:
            raise ValueError(
                f"FF_SCALE_DOWN_QUEUE={self.down_queue} must be <= "
                f"FF_SCALE_UP_QUEUE={self.up_queue} (hysteresis band)")
        for name in ("up_queue", "up_burn", "down_queue",
                     "up_cooldown_s", "down_cooldown_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, "
                                 f"got {getattr(self, name)}")

    @property
    def enabled(self) -> bool:
        return self.max_replicas > 0

    @classmethod
    def from_env(cls, **overrides) -> "ScaleConfig":
        """Build from ``FF_SCALE_*``; explicit kwargs win.  Raises
        ValueError naming the offending variable."""
        kw = dict(
            min_replicas=_env_int("FF_SCALE_MIN", cls.min_replicas, lo=1),
            max_replicas=_env_int("FF_SCALE_MAX", cls.max_replicas, lo=0),
            interval_s=_env_float("FF_SCALE_INTERVAL_S", cls.interval_s),
            up_queue=_env_float("FF_SCALE_UP_QUEUE", cls.up_queue),
            up_burn=_env_float("FF_SCALE_UP_BURN", cls.up_burn),
            down_queue=_env_float("FF_SCALE_DOWN_QUEUE", cls.down_queue),
            streak=_env_int("FF_SCALE_STREAK", cls.streak, lo=1),
            up_cooldown_s=_env_float("FF_SCALE_UP_COOLDOWN_S",
                                     cls.up_cooldown_s),
            down_cooldown_s=_env_float("FF_SCALE_DOWN_COOLDOWN_S",
                                       cls.down_cooldown_s),
        )
        kw.update(overrides)
        return cls(**kw)

    def describe(self) -> str:
        if not self.enabled:
            return "disabled (FF_SCALE_MAX=0)"
        return (f"replicas=[{self.min_replicas},{self.max_replicas}] "
                f"interval={self.interval_s:g}s "
                f"up_queue={self.up_queue:g}/replica "
                f"up_burn={self.up_burn:g} "
                f"down_queue={self.down_queue:g}/replica "
                f"streak={self.streak} "
                f"cooldown={self.up_cooldown_s:g}s up"
                f"/{self.down_cooldown_s:g}s down")


class Autoscaler:
    """One policy thread over a ``ReplicaPool``.

    Usage::

        scaler = Autoscaler(pool, ScaleConfig(min_replicas=2,
                                              max_replicas=6))
        scaler.start()
        ...
        scaler.stop()    # before pool.stop()

    The policy lives in ``_tick(now)`` — deterministic given the pool
    snapshot and the clock, so tests drive it directly against a stub
    pool with a fake clock and never sleep.
    """

    def __init__(self, pool, config: Optional[ScaleConfig] = None,
                 telemetry=None):
        self.pool = pool
        self.config = config if config is not None \
            else ScaleConfig.from_env()
        self._telemetry = telemetry if telemetry is not None \
            else getattr(pool, "_telemetry", None)
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._up_streak = 0
        self._down_streak = 0
        self._last_up = float("-inf")
        self._last_down = float("-inf")
        # latest slo_burn_rate per (slo, window) — fed by the EventLog
        # observer below; no metrics scrape in the loop
        self._burns: Dict[Tuple[str, str], float] = {}
        self._burn_lock = threading.Lock()
        self._observing = False
        # (t, ready_replicas, total_replicas) after every action + tick
        # where the count changed — the fleet timeline
        self.timeline: List[Tuple[float, int, int]] = []
        self._stats = dict(ticks=0, scale_ups=0, scale_downs=0,
                           blocked_max=0, blocked_min=0)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "Autoscaler":
        assert self._thread is None, "autoscaler already started"
        if not self.config.enabled:
            raise ValueError(
                "autoscaler disabled: set FF_SCALE_MAX >= FF_SCALE_MIN "
                "(or pass ScaleConfig(max_replicas=...))")
        log = self._telemetry
        if log is not None and not self._observing:
            # EventLog has no remove_observer: attach once, gate on a flag
            self._observing = True
            log.add_observer(self._observe)
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="ff-autoscaler", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 60.0) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.config.interval_s):
            try:
                self._tick(time.perf_counter())
            except Exception as e:  # noqa: BLE001 — policy must not die
                if self._telemetry is not None:
                    self._telemetry.event(
                        "scale_error", error=f"{type(e).__name__}: {e}")
                    self._telemetry.flush()

    # -- burn-rate tap ---------------------------------------------------
    def _observe(self, rec: Dict[str, Any]) -> None:
        if not self._observing or rec.get("t") != "gauge" \
                or rec.get("name") != "slo_burn_rate":
            return
        attrs = rec.get("attrs") or {}
        key = (str(attrs.get("slo", "")), str(attrs.get("window", "")))
        with self._burn_lock:
            self._burns[key] = float(rec.get("v", 0.0))

    def burn_rate(self) -> float:
        """Worst current burn across SLOs (max over windows too: the
        short window is the 'happening NOW' signal we scale on)."""
        with self._burn_lock:
            return max(self._burns.values(), default=0.0)

    # -- the policy ------------------------------------------------------
    def _tick(self, now: float) -> None:
        cfg = self.config
        pool = self.pool
        self._stats["ticks"] += 1
        ready = pool.ready_replicas
        total = pool.num_replicas
        queued = pool.num_queued
        per_replica = queued / max(1, ready)
        burn = self.burn_rate()

        # 1. backfill below min: immediate, paced only by the up-cooldown
        if ready < cfg.min_replicas:
            if total < cfg.max_replicas \
                    and now - self._last_up >= cfg.up_cooldown_s:
                self._scale_up(now, ready, queued,
                               f"ready {ready} < FF_SCALE_MIN="
                               f"{cfg.min_replicas}")
            elif total >= cfg.max_replicas:
                self._stats["blocked_max"] += 1
            self._down_streak = 0
            return

        # 2. pressure up / 3. quiet down, with hysteresis streaks
        want_up = per_replica > cfg.up_queue \
            or (cfg.up_burn > 0 and burn > cfg.up_burn)
        want_down = per_replica < cfg.down_queue \
            and (cfg.up_burn <= 0 or burn < cfg.up_burn * 0.5)
        self._up_streak = self._up_streak + 1 if want_up else 0
        self._down_streak = self._down_streak + 1 if want_down else 0

        if self._up_streak >= cfg.streak:
            if total >= cfg.max_replicas:
                self._stats["blocked_max"] += 1
            elif now - self._last_up >= cfg.up_cooldown_s:
                reason = (f"queue {per_replica:.1f}/replica > "
                          f"FF_SCALE_UP_QUEUE={cfg.up_queue:g}"
                          if per_replica > cfg.up_queue else
                          f"burn {burn:.2f} > FF_SCALE_UP_BURN="
                          f"{cfg.up_burn:g}")
                self._scale_up(now, ready, queued, reason)
        elif self._down_streak >= cfg.streak:
            if ready <= cfg.min_replicas:
                self._stats["blocked_min"] += 1
            elif now - self._last_down >= cfg.down_cooldown_s:
                self._scale_down(now, ready, queued,
                                 f"queue {per_replica:.2f}/replica < "
                                 f"FF_SCALE_DOWN_QUEUE="
                                 f"{cfg.down_queue:g}")

    def _scale_up(self, now: float, ready: int, queued: int,
                  reason: str) -> None:
        name = self.pool.add_replica()
        if name is None:
            return
        self._last_up = now
        self._up_streak = 0
        self._stats["scale_ups"] += 1
        self._record(now, "up", name, reason, ready, queued)

    def _scale_down(self, now: float, ready: int, queued: int,
                    reason: str) -> None:
        name = self.pool.drain_replica()
        if name is None:
            return
        self._last_down = now
        self._down_streak = 0
        self._stats["scale_downs"] += 1
        self._record(now, "down", name, reason, ready, queued)

    def _record(self, now: float, direction: str, name: str,
                reason: str, ready: int, queued: int) -> None:
        ready_after = self.pool.ready_replicas
        self.timeline.append((now, ready_after, self.pool.num_replicas))
        log = self._telemetry
        if log is not None:
            log.event("scale_event", direction=direction, replica=name,
                      reason=reason, ready_before=ready,
                      ready_after=ready_after, queued=queued)
            log.counter("serve_scale_events", 1, which=direction)
            log.flush()

    def stats(self) -> Dict[str, Any]:
        s = dict(self._stats)
        s["burn_rate"] = self.burn_rate()
        s["up_streak"] = self._up_streak
        s["down_streak"] = self._down_streak
        return s
