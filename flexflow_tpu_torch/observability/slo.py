"""Declarative serving SLOs with multi-window burn-rate alerts.

Dashboards answer "what is the p99 right now"; an on-call needs the
other question — "at this error rate, how fast am I spending the
month's budget".  This module folds the serving plane's
``serve_request_done`` events into classic SRE burn rates:

  * each SLO names a per-request predicate (TTFT under X ms, TPOT under
    X ms, queue wait under X ms, or plain availability = the request
    finished ``done``) and an objective (default 99% of requests good),
  * over each window W the burn rate is ``bad_fraction / (1 -
    objective)`` — burn 1.0 spends budget exactly as fast as the
    objective allows, burn 2.0 spends a month's budget in half a month,
  * an alert fires only when EVERY window burns above the threshold
    (the standard multi-window guard: the short window proves it is
    happening NOW, the long window proves it is not a blip) and clears
    with hysteresis at half the threshold.

The evaluator is an ``EventLog`` observer (same tap as
``MetricsRegistry``): it reacts ONLY to ``serve_request_done`` records,
uses the RECORD's relative timestamp as its clock (deterministic under
test and in post-hoc replays), and publishes its verdicts back through
the same log —

  gauge ``slo_burn_rate{slo,window}``     -> ``ff_slo_burn_rate``
  gauge ``slo_budget_remaining{slo}``     -> ``ff_slo_budget_remaining``
  event ``slo_alert{slo,state}``          firing / cleared

so the registry, the trace file, and ``tools/timeline_export.py`` all
see them with zero extra plumbing.  Re-entry is safe: observers run
outside the EventLog lock, and gauge/event records never trigger the
evaluator again.

Knobs (all loud on garbage, per the serving/config.py convention):

  FF_SLO_TTFT_MS         TTFT target in ms      (default 500; 0 disables)
  FF_SLO_TPOT_MS         TPOT target in ms      (default 100; 0 disables)
  FF_SLO_QUEUE_WAIT_MS   queue-wait target      (default 1000; 0 disables)
  FF_SLO_AVAILABILITY    0 disables the availability SLO (default on)
  FF_SLO_OBJECTIVE       good-fraction objective (default 0.99)
  FF_SLO_WINDOWS         comma list of window seconds (default "60,300")
  FF_SLO_BURN_ALERT      burn threshold for the alert (default 2.0)

Zero-cost when telemetry is off: nothing attaches without an EventLog.
STDLIB-ONLY, like everything else in observability/.  A copy of the JAX
package's ``observability/slo.py``.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import events

DEFAULT_TTFT_MS = 500.0
DEFAULT_TPOT_MS = 100.0
DEFAULT_QUEUE_WAIT_MS = 1000.0
DEFAULT_OBJECTIVE = 0.99
DEFAULT_WINDOWS = (60.0, 300.0)
DEFAULT_BURN_ALERT = 2.0


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not a number") from None


def windows_from_env() -> Tuple[float, ...]:
    raw = os.environ.get("FF_SLO_WINDOWS", "")
    if raw == "":
        return DEFAULT_WINDOWS
    try:
        out = tuple(sorted(float(p) for p in raw.split(",") if p.strip()))
    except ValueError:
        raise ValueError(
            f"FF_SLO_WINDOWS={raw!r} is not a comma list of seconds"
        ) from None
    if not out or any(w <= 0 for w in out):
        raise ValueError(
            f"FF_SLO_WINDOWS={raw!r} must name positive window seconds")
    return out


class SLOTarget:
    """One objective: ``field`` is the latency key on the
    ``serve_request_done`` record (None = availability — the request's
    terminal status must be ``done``); a request missing its latency
    field counts BAD (a shed or timed-out request certainly missed
    TTFT)."""

    __slots__ = ("name", "field", "threshold_s", "objective")

    def __init__(self, name: str, field: Optional[str],
                 threshold_s: Optional[float], objective: float):
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"SLO {name!r} objective {objective} must be in (0, 1)")
        self.name = name
        self.field = field
        self.threshold_s = threshold_s
        self.objective = objective

    def good(self, attrs: Dict[str, Any]) -> bool:
        if self.field is None:
            return attrs.get("status") == "done"
        v = attrs.get(self.field)
        if v is None:
            return False
        return float(v) <= self.threshold_s

    def describe(self) -> Dict[str, Any]:
        d = {"slo": self.name, "objective": self.objective}
        if self.threshold_s is not None:
            d["threshold_ms"] = round(self.threshold_s * 1e3, 3)
        return d


def targets_from_env() -> List[SLOTarget]:
    """The declarative SLO set: sensible defaults out of the box,
    ``FF_SLO_*_MS=0`` switches an SLO off, ``FF_SLO_OBJECTIVE``
    applies to all of them.  Raises ``ValueError`` on garbage."""
    obj = _env_float("FF_SLO_OBJECTIVE", DEFAULT_OBJECTIVE)
    if not 0.0 < obj < 1.0:
        raise ValueError(
            f"FF_SLO_OBJECTIVE={obj} must be in (0, 1) exclusive")
    out: List[SLOTarget] = []
    for name, env, field, dflt in (
            ("ttft", "FF_SLO_TTFT_MS", "ttft_s", DEFAULT_TTFT_MS),
            ("tpot", "FF_SLO_TPOT_MS", "tpot_s", DEFAULT_TPOT_MS),
            ("queue_wait", "FF_SLO_QUEUE_WAIT_MS", "queue_wait_s",
             DEFAULT_QUEUE_WAIT_MS)):
        ms = _env_float(env, dflt)
        if ms < 0:
            raise ValueError(f"{env}={ms} must be >= 0 (0 disables)")
        if ms > 0:
            out.append(SLOTarget(name, field, ms / 1e3, obj))
    if _env_float("FF_SLO_AVAILABILITY", 1.0) != 0.0:
        out.append(SLOTarget("availability", None, None, obj))
    return out


class BurnRateEvaluator:
    """EventLog observer computing per-SLO multi-window burn rates.

    Keeps one rolling sample deque of ``(ts, goods)`` rows (``goods``
    aligned to the target list) bounded by the longest window, so
    memory is O(requests in the long window).  All verdicts go back
    through ``log`` — see the module docstring for the series."""

    def __init__(self, log: events.EventLog,
                 targets: Optional[Sequence[SLOTarget]] = None,
                 windows: Optional[Sequence[float]] = None,
                 burn_alert: Optional[float] = None):
        self.log = log
        self.targets = list(targets if targets is not None
                            else targets_from_env())
        self.windows = tuple(sorted(windows if windows is not None
                                    else windows_from_env()))
        self.burn_alert = float(burn_alert if burn_alert is not None
                                else _env_float("FF_SLO_BURN_ALERT",
                                                DEFAULT_BURN_ALERT))
        if self.burn_alert <= 0:
            raise ValueError(
                f"FF_SLO_BURN_ALERT={self.burn_alert} must be > 0")
        self._lock = threading.Lock()
        self._samples: deque = deque()  # (ts, tuple-of-good-bools)
        self._firing = [False] * len(self.targets)

    # -- the observer ---------------------------------------------------
    def observe(self, rec: Dict[str, Any]) -> None:
        if rec.get("t") != "event" \
                or rec.get("name") != "serve_request_done" \
                or not self.targets:
            return
        attrs = rec.get("attrs") or {}
        now = float(rec.get("ts", 0.0))
        emits: List[Tuple[str, float, Dict[str, Any]]] = []
        alerts: List[Dict[str, Any]] = []
        with self._lock:
            self._samples.append(
                (now, tuple(t.good(attrs) for t in self.targets)))
            horizon = now - self.windows[-1]
            while self._samples and self._samples[0][0] < horizon:
                self._samples.popleft()
            for i, target in enumerate(self.targets):
                burns: List[float] = []
                for w in self.windows:
                    burn = self._burn(i, target, now, w)
                    burns.append(burn)
                    emits.append(("slo_burn_rate", round(burn, 4),
                                  {"slo": target.name,
                                   "window": str(int(w))}))
                # budget over the LONG window: 1 - burn, floored at 0 —
                # "how much of the allowance is left at this rate"
                emits.append(("slo_budget_remaining",
                              round(max(0.0, 1.0 - burns[-1]), 4),
                              {"slo": target.name}))
                firing = self._firing[i]
                if not firing and all(b > self.burn_alert for b in burns):
                    self._firing[i] = True
                    alerts.append(self._alert(target, "firing", burns))
                elif firing and all(b < self.burn_alert * 0.5
                                    for b in burns):
                    self._firing[i] = False
                    alerts.append(self._alert(target, "cleared", burns))
        # publish OUTSIDE our lock: the log fans these records back to
        # every observer (registry included); none react to gauges
        for name, v, labels in emits:
            self.log.gauge(name, v, **labels)
        for a in alerts:
            self.log.event("slo_alert", **a)

    def _burn(self, i: int, target: SLOTarget, now: float,
              window: float) -> float:
        total = bad = 0
        lo = now - window
        for ts, goods in self._samples:
            if ts >= lo:
                total += 1
                if not goods[i]:
                    bad += 1
        if total == 0:
            return 0.0
        return (bad / total) / (1.0 - target.objective)

    def _alert(self, target: SLOTarget, state: str,
               burns: Sequence[float]) -> Dict[str, Any]:
        a = {"slo": target.name, "state": state,
             "threshold": self.burn_alert}
        for w, b in zip(self.windows, burns):
            a[f"burn_{int(w)}s"] = round(b, 4)
        return a

    # -- introspection (doctor / tests) ---------------------------------
    def describe(self) -> Dict[str, Any]:
        return {"targets": [t.describe() for t in self.targets],
                "windows": list(self.windows),
                "burn_alert": self.burn_alert}


# ----------------------------------------------------------------------
# process-wide wiring (mirrors metrics.py's attach bookkeeping)
# ----------------------------------------------------------------------
_lock = threading.Lock()
_attached: List[Tuple[events.EventLog, BurnRateEvaluator]] = []


def maybe_attach(log: Optional[events.EventLog]) \
        -> Optional[BurnRateEvaluator]:
    """Attach a burn-rate evaluator to ``log`` (idempotent per log —
    identity-matched, like ``metrics._attached_logs``).  None log
    (telemetry off) or an empty target set (every SLO disabled via env)
    attaches nothing — the zero-cost path."""
    if log is None:
        return None
    targets = targets_from_env()
    if not targets:
        return None
    with _lock:
        for attached_log, ev in _attached:
            if attached_log is log:
                return ev
        ev = BurnRateEvaluator(log, targets=targets)
        _attached.append((log, ev))
    log.add_observer(ev.observe)
    return ev


def reset() -> None:
    """Forget attached evaluators (test hook; ``metrics.stop`` calls
    this alongside clearing its own attach list)."""
    with _lock:
        _attached.clear()
