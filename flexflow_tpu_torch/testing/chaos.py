"""Deterministic, seeded fault injection (``FF_CHAOS``): a copy of the JAX
package's ``testing/chaos.py`` (the port imports nothing of that package).

Every site is wired as in the JAX package: ``FFModel.update`` fires
``step`` with the global step before the step runs, ``FFModel.sync`` fires
``sync``, ``DataLoader.next_batch`` fires ``data``, each checkpoint attempt
fires ``ckpt_save`` or ``ckpt_restore`` (runtime/resilience.py), the
reconfiguration controller fires ``resharding`` at each step boundary
(runtime/reconfigure.py), and the serving engine fires ``serve`` at
admission (serving/engine.py), the replica pool polling ``zones_down``
(serving/pool.py).  ``FFModel.compile`` resolves the monkey.

``nan_loss`` multiplies the staged batch's float leaves in place, so a
model whose inputs are all integers (the transformer's token ids) is not
poisoned by it: its step stays finite.  A rank benched by a lost device
(runtime/reconfigure.py) stages no batch, and the fault leaves it alone.

The reference FlexFlow is strictly fail-stop: any device error aborts
the process (FatalError, cuda_helper.h:6-36) and there is no way to
*provoke* a failure short of yanking hardware, so its (nonexistent)
recovery paths were never testable.  This module is the other half of
``runtime/resilience.py``: a fault injector precise enough that every
recovery path — skip-step, preemption save, checkpoint retry — is
exercised by a seeded spec and asserted bitwise in CI.

Spec grammar (``FF_CHAOS`` environment variable)::

    FF_CHAOS   = entry (";" entry)*
    entry      = site ":" trigger "=" fault [":" arg]
    site       = "step" | "data" | "ckpt_save" | "ckpt_restore" | "sync"
               | "serve" | "resharding"
    trigger    = INT          exact trigger (fires once, then is spent)
               | "p" FLOAT    per-call probability (seeded, repeatable)
    fault      = "nan_loss"   poison the staged batch's float leaves with
                              NaN (step site: the step's loss and grads
                              go non-finite)
               | "hang"       sleep ``arg`` seconds (default 3600) —
                              a wedged device/tunnel for watchdog tests
               | "io_error"   raise ChaosIOError (an OSError: retried by
                              the checkpoint retry wrapper)
               | "sigterm"    os.kill(self, SIGTERM) — a preemption
               | "sigint"     os.kill(self, SIGINT)
               | "error"      raise ChaosError (generic failure)
               | "device_loss"   ``arg`` (default 1) devices vanish from
                              the mesh — recorded on ``lost_device_count``
                              and observed by the reconfiguration
                              controller's probe at its ``resharding``
                              choke point (the controller re-searches
                              over the survivors and hot-swaps)
               | "device_gain"   ``arg`` (default 1) lost devices
                              reappear (clamped at a whole mesh)
               | "divergence" inflate every SUBSEQUENT measured step by
                              ``arg`` seconds (default 0.05) — a planted
                              perf regression for probation/rollback and
                              sim-divergence tests; persistent, not
                              one-shot
               | "replica_kill"  (serve site) raise ChaosReplicaKill out
                              of the admitting engine's decode loop —
                              the replica crashes; the pool fails over
               | "replica_hang"  (serve site) wedge the admitting
                              replica's loop thread for ``arg`` seconds
                              (default 3600) so the pool's heartbeat
                              monitor declares it stalled
               | "zone_outage"   (serve site) zone ``arg`` (an index
                              into FF_SERVE_ZONES, default 0) goes dark
                              — recorded on ``zones_down``; the pool's
                              monitor marks EVERY replica in that zone
                              down at once, fails their in-flight
                              attempts over to surviving zones, and the
                              autoscaler backfills capacity there.
                              Recorded state like device_loss: the
                              admitting request itself is unharmed.
    arg        = FLOAT        fault parameter (hang seconds, lost/regained
                              device count, per-step inflation seconds,
                              zone index)

For the ``step`` site the trigger is the model's GLOBAL step index
(``model._step_count`` at ``update()`` entry) — resume-aware, so an
injected fault does not re-fire after a checkpoint restore past it.
For every other site it is the 1-based count of calls to that site's
choke point *in this process*; checkpoint retry attempts each count,
so ``ckpt_save:1=io_error`` fails the first attempt and lets the retry
succeed.

The ``serve`` site fires at the serving engine's per-request ADMISSION
choke point (trigger = 1-based admission count), before the prefill —
so ``serve:2=error`` fails exactly the second admitted request, which
must NOT kill the batch loop or any other request (the engine's
per-request error isolation, tests/test_serving.py); ``serve:3=hang:2``
wedges the loop thread for 2s, stalling every in-flight request.  Two
faults target the REPLICA, not the request: ``serve:3=replica_kill``
throws ``ChaosReplicaKill`` out of the admitting engine's decode loop —
the whole replica crashes, the pool marks it UNHEALTHY, fails its
in-flight requests over to survivors, and restarts it with backoff;
``serve:3=replica_hang:5`` wedges the replica's loop thread for 5s so
the pool's heartbeat monitor (``FF_SERVE_REPLICA_TIMEOUT``) declares it
stalled.  Under a pool the admission counter is SHARED across replicas
(the monkey serializes ``fire`` with a lock), so triggers stay a
deterministic 1-based admission count regardless of which replica
admits.  A remote replica's leader (a slice of cards, serving/remote.py)
fires the site on its own model's monkey, in its own process, where it
admits: its counter is that slice's, as each model's monkey on one card
counts its own engines' admissions, and ``RemoteSlice.set_chaos`` plants
a spec there; its ``zones_down`` reaches the pool in the leader's beat.

The ``resharding`` site fires from the reconfiguration controller's
per-step-boundary hook (``runtime/reconfigure.py``), with the GLOBAL
step index as trigger domain (resume-aware, like ``step``) — so
``resharding:4=device_loss:4`` makes 4 devices vanish after step 4
and the controller re-parallelizes over the 4 survivors.  Device
loss/gain is *recorded state* (``lost_device_count``): on a virtual
CPU mesh a chip cannot physically vanish, so the controller's probe
reads the monkey instead of the hardware.

Examples::

    FF_CHAOS="step:23=nan_loss;step:40=hang:2;ckpt_save:2=io_error"
    FF_CHAOS="step:57=sigterm"            # deterministic preemption
    FF_CHAOS="step:p0.01=nan_loss" FF_CHAOS_SEED=7   # 1% of steps, seeded

Zero overhead when unset: ``from_env()`` returns None and every choke
point guards on a plain ``is not None`` attribute test — no parsing, no
dict lookups, no extra device dispatches (asserted by
tests/test_chaos.py).

STDLIB-ONLY at import time: the one fault that touches arrays
(``nan_loss``) works on the staged batch's torch tensors in place, and
imports nothing.
"""

from __future__ import annotations

import os
import signal
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

SITES = ("step", "data", "ckpt_save", "ckpt_restore", "sync", "serve",
         "resharding")
FAULTS = ("nan_loss", "hang", "io_error", "sigterm", "sigint", "error",
         "device_loss", "device_gain", "divergence",
         "replica_kill", "replica_hang", "zone_outage")


class ChaosError(RuntimeError):
    """Generic injected failure (``fault=error``)."""


class ChaosIOError(OSError):
    """Injected I/O failure (``fault=io_error``) — an OSError so the
    checkpoint retry wrapper treats it exactly like a real filesystem
    error."""


class ChaosReplicaKill(RuntimeError):
    """Injected replica crash (``fault=replica_kill``).  The serving
    engine deliberately does NOT isolate this one per-request: it
    propagates out of the decode loop, the replica thread dies, and the
    pool's health monitor must notice and fail over."""


def parse_spec(spec: str) -> Tuple[Dict[Tuple[str, int], Tuple[str, Optional[float]]],
                                   List[Tuple[str, float, str, Optional[float]]]]:
    """Parse an ``FF_CHAOS`` spec into (exact, probabilistic) entries.

    Raises ValueError naming the offending entry — a typo'd chaos spec
    silently injecting nothing is worse than no chaos at all.
    """
    exact: Dict[Tuple[str, int], Tuple[str, Optional[float]]] = {}
    prob: List[Tuple[str, float, str, Optional[float]]] = []
    for raw in spec.split(";"):
        entry = raw.strip()
        if not entry:
            continue
        try:
            left, right = entry.split("=", 1)
            site, trigger = left.split(":", 1)
        except ValueError:
            raise ValueError(
                f"FF_CHAOS entry {entry!r}: expected 'site:trigger=fault'")
        site = site.strip()
        if site not in SITES:
            raise ValueError(f"FF_CHAOS entry {entry!r}: unknown site "
                             f"{site!r} (one of {', '.join(SITES)})")
        fault, _, argstr = right.partition(":")
        fault = fault.strip()
        if fault not in FAULTS:
            raise ValueError(f"FF_CHAOS entry {entry!r}: unknown fault "
                             f"{fault!r} (one of {', '.join(FAULTS)})")
        arg: Optional[float] = None
        if argstr:
            try:
                arg = float(argstr)
            except ValueError:
                raise ValueError(f"FF_CHAOS entry {entry!r}: fault arg "
                                 f"{argstr!r} is not a number")
        trigger = trigger.strip()
        if trigger.startswith("p"):
            try:
                p = float(trigger[1:])
            except ValueError:
                raise ValueError(f"FF_CHAOS entry {entry!r}: probability "
                                 f"trigger {trigger!r} is not 'p<float>'")
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"FF_CHAOS entry {entry!r}: probability "
                                 f"{p} outside [0, 1]")
            prob.append((site, p, fault, arg))
        else:
            try:
                t = int(trigger)
            except ValueError:
                raise ValueError(f"FF_CHAOS entry {entry!r}: trigger "
                                 f"{trigger!r} is not an int or 'p<float>'")
            if t < 0:
                raise ValueError(f"FF_CHAOS entry {entry!r}: negative "
                                 f"trigger {t}")
            exact[(site, t)] = (fault, arg)
    if not exact and not prob:
        raise ValueError(f"FF_CHAOS={spec!r}: no entries")
    return exact, prob


def _uniform(seed: int, site: str, idx: int) -> float:
    """Deterministic uniform in [0, 1) keyed by (seed, site, index) —
    the same spec + seed injects the same faults on every run."""
    h = zlib.crc32(f"{seed}:{site}:{idx}".encode())
    return (h % 1_000_000) / 1_000_000.0


class ChaosMonkey:
    """One parsed ``FF_CHAOS`` spec + per-site call counters.

    A model resolves its monkey ONCE at ``compile()`` (``from_env``) and
    every choke point is ``if self._chaos is not None: self._chaos.fire(..)``
    — identical to the telemetry-handle pattern, so the disabled hot
    path pays a single attribute test.
    """

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self._exact, self._prob = parse_spec(spec)
        self._counts: Dict[str, int] = {}
        # replica-pool engines fire the shared ``serve`` counter from N
        # loop threads; the lock keeps counts and exact-pops atomic
        # (single-threaded sites pay one uncontended acquire)
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, int, str]] = []  # (site, trigger, fault)
        # resharding-site state, read by the reconfiguration controller
        self.lost_device_count = 0
        # serve-site state, read by the replica pool's monitor: indices
        # into FF_SERVE_ZONES whose replicas went dark all at once
        self.zones_down: List[int] = []
        # persistent per-step wall inflation (``divergence`` fault)
        self.inflate_step_s = 0.0

    def describe(self) -> str:
        parts = [f"{s}:{t}={f}" for (s, t), (f, _) in sorted(self._exact.items())]
        parts += [f"{s}:p{p:g}={f}" for (s, p, f, _) in self._prob]
        return f"{len(parts)} entr{'y' if len(parts) == 1 else 'ies'} " \
               f"({'; '.join(parts)})"

    # -- the choke point ------------------------------------------------
    def fire(self, site: str, index: Optional[int] = None,
             model: Any = None) -> Optional[str]:
        """Called from an instrumented site.  ``index`` is the site's
        own trigger domain (the global step for ``step``); when None the
        per-site call counter supplies it.  Returns the fault name when
        one fired (after executing its side effect), else None."""
        if site == "step" and self.inflate_step_s:
            # a previously fired ``divergence`` fault: every step pays
            # the planted inflation from here on
            time.sleep(self.inflate_step_s)
        with self._lock:
            if index is None:
                idx = self._counts.get(site, 0) + 1
                self._counts[site] = idx
            else:
                idx = int(index)
            hit = self._exact.pop((site, idx), None)
            if hit is None:
                for (s, p, fault, arg) in self._prob:
                    if s == site and _uniform(self.seed, site, idx) < p:
                        hit = (fault, arg)
                        break
            if hit is None:
                return None
            fault, arg = hit
            self.fired.append((site, idx, fault))
        self._emit(model, site, idx, fault)
        self._execute(fault, arg, site, idx, model)
        return fault

    # -- internals ------------------------------------------------------
    def _emit(self, model, site: str, idx: int, fault: str) -> None:
        # Before the side effect (a sigterm may end the process; the
        # sink is line-buffered so the record survives).
        log = getattr(model, "_telemetry", None) if model is not None else None
        if log is None:
            from ..observability import events

            log = events.active_log()
        if log is not None:
            log.event("fault_injected", site=site, trigger=idx, fault=fault)
            log.flush()

    def _execute(self, fault: str, arg: Optional[float], site: str,
                 idx: int, model) -> None:
        where = f"{site}:{idx}"
        if fault == "nan_loss":
            self._poison_batch(model, where)
        elif fault == "hang":
            time.sleep(arg if arg is not None else 3600.0)
        elif fault == "io_error":
            raise ChaosIOError(f"chaos-injected io_error at {where}")
        elif fault == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        elif fault == "sigint":
            os.kill(os.getpid(), signal.SIGINT)
        elif fault == "error":
            raise ChaosError(f"chaos-injected error at {where}")
        elif fault == "device_loss":
            self.lost_device_count += int(arg) if arg else 1
        elif fault == "device_gain":
            self.lost_device_count = max(
                0, self.lost_device_count - (int(arg) if arg else 1))
        elif fault == "divergence":
            self.inflate_step_s = float(arg) if arg is not None else 0.05
        elif fault == "replica_kill":
            raise ChaosReplicaKill(
                f"chaos-injected replica crash at {where}")
        elif fault == "replica_hang":
            time.sleep(arg if arg is not None else 3600.0)
        elif fault == "zone_outage":
            # recorded state (like device_loss): the pool monitor polls
            # ``zones_down`` and downs every replica of the zone; the
            # admitting request itself proceeds unharmed
            zi = int(arg) if arg is not None else 0
            if zi not in self.zones_down:
                self.zones_down.append(zi)

    @staticmethod
    def _poison_batch(model, where: str) -> None:
        """Multiply every float leaf of the staged batch by NaN, in place
        (a captured step reads the same buffers), so this step's loss AND
        grads go non-finite.  Int leaves (labels, indices) stay."""
        if getattr(model, "_benched", False):
            return
        batch = getattr(model, "_batch", None)
        if not batch:
            raise ChaosError(
                f"chaos nan_loss at {where}: no staged batch to poison "
                "(inject at a step that follows next_batch)")
        for v in batch.values():
            if getattr(v, "is_floating_point", lambda: False)():
                v.mul_(float("nan"))


def from_env() -> Optional[ChaosMonkey]:
    """The process's chaos config: None when ``FF_CHAOS`` is unset (the
    common case — zero cost), else a fresh monkey.  Each model compile
    gets its own instance so per-site counters are per-run."""
    spec = os.environ.get("FF_CHAOS", "")
    if not spec:
        return None
    seed = int(os.environ.get("FF_CHAOS_SEED", "0") or 0)
    return ChaosMonkey(spec, seed=seed)
