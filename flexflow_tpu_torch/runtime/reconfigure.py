"""Online re-parallelization: observe → search → act, during training
(PyTorch port of ``flexflow_tpu/runtime/reconfigure.py``).

The source paper's thesis is that the best parallelization strategy is a
function of the machine — but the machine changes mid-run: cards wedge,
pods shrink, measured op costs drift from the analytic model.  The
reference (and PRs 1-7 here) could only *detect* that: agreement.py
emits ``sim_divergence`` when the simulator's prediction stops matching
measured step time, and the elastic loop resumes after a crash.  This
module closes the loop — the runtime-reconfigurable-dataflow idea of
Flex-TPU (PAPERS.md, arXiv 2407.08700) applied to the SOAP search:

  * **triggers** — (a) sustained ``sim_divergence`` beyond
    ``FF_RECONFIG_DIVERGENCE`` for ``FF_RECONFIG_SUSTAIN`` consecutive
    health windows (the controller rides the existing FF_HEALTH metric
    vector as an EventLog observer), and (b) device-set changes: a card
    vanishing from the mesh (chaos ``resharding`` site, or a real
    watchdog probe via the ``probe`` hook) or reappearing,
  * **background re-search** — on trigger, the MCMC search re-runs on a
    daemon thread against the *measured* machine model (the calibrated
    roofline refit by the observed predicted/measured ratio) and the
    *surviving* device set; the delta simulator keeps it to a few
    training steps' wall time,
  * **hot swap at a step boundary** — the winning strategy is applied
    by driving the elastic checkpoint/resume path: drain in-flight
    work, save at the current global step, ``recompile()`` under the
    new ParallelConfig map (and degraded/expanded mesh), restore, and
    continue.  Device loss degrades gracefully — training continues
    slower on the smaller mesh instead of aborting; regaining the card
    re-expands,
  * **acceptance gate + probation** — a divergence-triggered swap must
    simulate ``FF_RECONFIG_GAIN`` better than the active strategy
    (device-set changes swap unconditionally: the old strategy names
    devices that no longer exist); after the swap a probation window of
    ``FF_RECONFIG_PROBATION`` steps compares measured step time against
    the pre-swap median and ROLLS BACK to the old strategy when it
    regressed past ``FF_RECONFIG_REGRESS``,
  * **flight recorder** — every swap writes the old and new strategy as
    ``.pb`` + provenance sidecar pairs (``swap_NNN_{old,new}.pb`` under
    ``<checkpoint_dir>/reconfig``, diffable with
    ``tools/search_report.py --diff``) and emits a ``strategy_swap``
    event carrying trigger / simulated gain / probation outcome —
    rendered by ``tools/health_report.py`` "## Reconfiguration".

Determinism: background-search *completion* is wall-clock-dependent,
so the swap step must not be.  The controller always applies exactly
``FF_RECONFIG_LAG_STEPS`` step boundaries after launching the search —
a result that lands early is held, a straggler is joined at the
boundary — so a seeded chaos run swaps at the same global step every
time (pinned by tests/test_reconfigure.py and the test.sh reshard
smoke).  The machine-model refit quantizes the measured/predicted
ratio to power-of-two buckets for the same reason: per-run wall noise
must not make the searched strategy a coin flip.

Zero overhead when ``FF_RECONFIGURE`` is unset: ``maybe_controller``
returns None and the elastic loop pays one ``is not None`` test per
step — the same handle pattern as telemetry/chaos.

The re-search prices configs from the committed H100 calibration
(``CostModel(measure=False)``): it launches no work on the card, and it
reads the model's graph without writing any op's config.

Over several processes (one per device) every rank runs the loop and its
own controller.  The chaos sites' triggers fire at the same global step
on every rank; a device loss takes the last ranks, which the swap leaves
benched (``Machine.for_ranks``, ``FFModel._benched``): they keep the
loop's step count, batch cursor and epoch schedule and compute nothing,
so a later device gain finds them in step and takes them back (the
survivors' lead broadcasts the state, ``FFModel.recompile``).  Only rank
0, which a loss never takes, runs the search; its result, and at the end
of a probation its step-time medians, are broadcast to every rank before
use, so all ranks decide alike.  A divergence request (``request``, or the
``sim_divergence`` observer over each rank's own telemetry) must reach
every rank at the same step: over several ranks a caller requests it on
each (an ``on_epoch`` hook does).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import statistics
import threading
import time
from typing import Any, Callable, Dict, FrozenSet, Optional

_TRUTHY = ("1", "true", "on", "yes")


def enabled() -> bool:
    """``FF_RECONFIGURE`` is set truthy (one dict lookup)."""
    return os.environ.get("FF_RECONFIGURE", "").lower() in _TRUTHY


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected a number")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected an integer")


@dataclasses.dataclass
class ReconfigPolicy:
    """Parsed ``FF_RECONFIG_*`` knobs (docs/robustness.md)."""

    gain: float = 0.03          # FF_RECONFIG_GAIN: min simulated gain
    probation: int = 8          # FF_RECONFIG_PROBATION: post-swap window
    divergence: float = 1.5     # FF_RECONFIG_DIVERGENCE: trigger ratio
    sustain: int = 2            # FF_RECONFIG_SUSTAIN: consecutive windows
    budget: int = 1500          # FF_RECONFIG_BUDGET: re-search proposals
    lag_steps: int = 2          # FF_RECONFIG_LAG_STEPS: apply boundary
    regress: float = 1.3        # FF_RECONFIG_REGRESS: rollback factor
    seed: int = 0               # FF_RECONFIG_SEED: re-search seed
    out_dir: str = ""           # FF_RECONFIG_DIR: swap-record directory

    @classmethod
    def from_env(cls) -> Optional["ReconfigPolicy"]:
        """None when ``FF_RECONFIGURE`` is unset (the common case — zero
        cost); else the parsed policy.  A typo'd knob raises ValueError
        naming it (doctor.py surfaces this pre-flight)."""
        if not enabled():
            return None
        pol = cls(gain=_env_float("FF_RECONFIG_GAIN", cls.gain),
                  probation=_env_int("FF_RECONFIG_PROBATION", cls.probation),
                  divergence=_env_float("FF_RECONFIG_DIVERGENCE",
                                        cls.divergence),
                  sustain=max(1, _env_int("FF_RECONFIG_SUSTAIN", cls.sustain)),
                  budget=max(1, _env_int("FF_RECONFIG_BUDGET", cls.budget)),
                  lag_steps=max(1, _env_int("FF_RECONFIG_LAG_STEPS",
                                            cls.lag_steps)),
                  regress=_env_float("FF_RECONFIG_REGRESS", cls.regress),
                  seed=_env_int("FF_RECONFIG_SEED", cls.seed),
                  out_dir=os.environ.get("FF_RECONFIG_DIR", ""))
        if pol.divergence < 1.0:
            raise ValueError(f"FF_RECONFIG_DIVERGENCE={pol.divergence}: "
                             "a predicted/measured ratio threshold must "
                             "be >= 1")
        if pol.regress <= 1.0:
            raise ValueError(f"FF_RECONFIG_REGRESS={pol.regress}: the "
                             "rollback factor must be > 1")
        return pol

    def describe(self) -> str:
        return (f"gain>={self.gain:g}, probation={self.probation} steps, "
                f"divergence>={self.divergence:g}x{self.sustain}, "
                f"budget={self.budget}, lag={self.lag_steps}, "
                f"regress>{self.regress:g}")


def refit_machine_model(num_devices: int,
                        predicted_s: Optional[float] = None,
                        measured_s: Optional[float] = None):
    """The *measured* machine model a re-search runs against: the
    calibrated H100 roofline (the committed fit and measurements ride in
    through CostModel) over the SURVIVING device count, with compute
    efficiency rescaled by the observed predicted/measured step ratio.
    The scale is clamped to [1/4, 4] and quantized to powers of two:
    divergence attribution to compute is a heuristic, and per-run wall
    noise must not flip which strategy the seeded search returns."""
    from ..simulator.machine import H100MachineModel

    mm = H100MachineModel.calibrated(num_devices=int(num_devices))
    if predicted_s and measured_s and predicted_s > 0 and measured_s > 0:
        scale = min(4.0, max(0.25, measured_s / predicted_s))
        scale = 2.0 ** round(math.log2(scale))
        if scale != 1.0:
            mm = dataclasses.replace(
                mm, matmul_efficiency=mm.matmul_efficiency / scale,
                op_efficiency={k: v / scale
                               for k, v in mm.op_efficiency.items()})
    return mm


class ReconfigurationController:
    """Watches the trigger streams and drives the re-search + hot swap.

    Owned by ``elastic_train`` (one per loop invocation); the loop calls
    ``on_step()`` at every step boundary and ``close()`` on exit.  The
    controller publishes itself as ``model._reconfig`` so callbacks and
    tests can ``request()`` a reconfiguration explicitly.
    """

    def __init__(self, model, manager, checkpoint_dir: str,
                 policy: Optional[ReconfigPolicy] = None,
                 save_fn: Optional[Callable[..., None]] = None,
                 sync_fn: Optional[Callable[[], None]] = None,
                 probe: Optional[Callable[[], FrozenSet[int]]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.model = model
        self.manager = manager
        self.checkpoint_dir = checkpoint_dir
        self.policy = policy or ReconfigPolicy.from_env() or ReconfigPolicy()
        self.out_dir = self.policy.out_dir or os.path.join(
            checkpoint_dir, "reconfig")
        os.makedirs(self.out_dir, exist_ok=True)
        self._save = save_fn or (lambda step, force=False: None)
        self._sync = sync_fn or model.sync
        self._probe_fn = probe
        self._clock = clock
        # the rank roster at construction — the "whole" mesh a regained
        # device re-expands back to
        self._full_ranks = list(model.machine.ranks)
        self._full_machine = model.machine
        self._lost: FrozenSet[int] = frozenset()
        self._pending: Optional[tuple] = None
        self._search: Optional[tuple] = None
        self._launch_step = 0
        self._probation: Optional[Dict[str, Any]] = None
        self._walls: collections.deque = collections.deque(maxlen=64)
        self._last_t: Optional[float] = None
        self._skip_wall = False
        self._div_hits = 0
        self._seq = 0
        self._closed = False
        self.swaps: list = []  # (step, trigger, outcome) — for tests/tools
        log = getattr(model, "_telemetry", None)
        if log is not None:
            log.add_observer(self._observe)
        model._reconfig = self

    # -- trigger stream 1: sim divergence (EventLog observer) -----------
    def _observe(self, rec: Dict[str, Any]) -> None:
        """Rides the FF_HEALTH vector: agreement.py's step-scope
        ``sim_divergence`` events arrive here once per sampling window.
        Sustained divergence past the threshold arms a re-search; a
        single bad window does not (warmup/GC noise)."""
        if self._closed or rec.get("name") != "sim_divergence":
            return
        attrs = rec.get("attrs") or {}
        if attrs.get("scope") != "step":
            return
        ratio = attrs.get("ratio")
        if not ratio or ratio <= 0:
            return
        off = max(float(ratio), 1.0 / float(ratio))
        if off >= self.policy.divergence:
            self._div_hits += 1
            if self._div_hits >= self.policy.sustain:
                self._div_hits = 0
                self.request("divergence", ratio=float(ratio))
        else:
            self._div_hits = 0

    # -- trigger stream 2: device-set changes ----------------------------
    def _probe(self) -> FrozenSet[int]:
        """The set of device indices currently missing from the mesh.
        Default probe reads the chaos monkey's simulated losses (loss is
        recorded state: the last ranks are lost); a deployment passes
        ``probe=`` wrapping per-device calls in a StepWatchdog deadline."""
        if self._probe_fn is not None:
            return frozenset(self._probe_fn())
        chaos = getattr(self.model, "_chaos", None)
        k = int(getattr(chaos, "lost_device_count", 0) or 0) \
            if chaos is not None else 0
        n = len(self._full_ranks)
        k = min(max(0, k), n - 1)  # always keep at least one device
        return frozenset(range(n - k, n))

    def request(self, trigger: str, force: bool = False, **info) -> None:
        """Arm a reconfiguration.  Divergence requests are dropped while
        a search/probation is already in flight; device-set changes
        (``force=True``) replace any pending request — the old strategy
        may name devices that no longer exist."""
        if self._closed:
            return
        if not force and (self._pending is not None
                          or self._search is not None
                          or self._probation is not None):
            return
        self._pending = (str(trigger), dict(info))

    # -- the per-step-boundary hook --------------------------------------
    def on_step(self) -> None:
        model = self.model
        step = model._step_count  # steps completed so far
        now = self._clock()
        wall = None
        if self._last_t is not None and not self._skip_wall:
            wall = now - self._last_t
            self._walls.append(wall)
        self._skip_wall = False
        self._last_t = now

        # chaos resharding site: the controller IS the probe choke point
        # (trigger domain = the global step index, resume-aware like the
        # step site)
        chaos = getattr(model, "_chaos", None)
        if chaos is not None:
            chaos.fire("resharding", index=step, model=model)

        lost = self._probe()
        if lost != self._lost:
            trig = "device_loss" if len(lost) > len(self._lost) \
                else "device_gain"
            self._lost = lost
            self.request(trig, force=True, lost=sorted(lost))

        if self._search is None and self._pending is not None:
            self._launch()
        elif self._search is not None \
                and step - self._launch_step >= self.policy.lag_steps:
            self._finish_and_apply()

        if self._probation is not None and wall is not None \
                and self._search is None:
            self._tick_probation(wall)

    # -- background re-search --------------------------------------------
    def _launch(self) -> None:
        trigger, info = self._pending
        self._pending = None
        if trigger.startswith("device"):
            # the probation comparison is against a mesh that no longer
            # exists — the device swap supersedes it
            self._probation = None
        model = self.model
        survivors = [r for i, r in enumerate(self._full_ranks)
                     if i not in self._lost]
        nd = max(1, len(survivors))
        old = dict(model._all_strategies())
        measured = statistics.median(self._walls) \
            if len(self._walls) >= 3 else None
        mm = refit_machine_model(
            nd, predicted_s=getattr(model, "_predicted_step_s", None),
            measured_s=measured)
        policy = self.policy
        self._launch_step = model._step_count
        box: Dict[str, Any] = {}

        def worker():
            if not _searches():  # rank 0 searches for every rank
                return
            try:
                from ..simulator.cost_model import CostModel
                from ..simulator.search import mcmc_search
                from ..simulator.simulator import Simulator

                res = mcmc_search(model, budget=policy.budget,
                                  machine_model=mm, seed=policy.seed,
                                  verbose=False, num_devices=nd)
                old_s = None
                try:
                    cm = CostModel(mm, measure=False,
                                   compute_dtype=model.config.compute_dtype)
                    old_s = Simulator(mm, cm).simulate_runtime(model, old)
                except Exception:  # noqa: BLE001 — gate degrades to no-gate
                    pass
                box["result"] = (res, old_s)
            except BaseException as e:  # noqa: BLE001 — surfaced at apply
                box["error"] = e

        t = threading.Thread(target=worker, daemon=True,
                             name=f"ff-reconfig-search-{self._seq}")
        self._search = (t, box, trigger, info, survivors, nd, old, mm)
        t.start()
        self._emit("reconfig_search", trigger=trigger,
                   step=self._launch_step, num_devices=nd,
                   budget=policy.budget, seed=policy.seed, **info)

    def _finish_and_apply(self) -> None:
        t, box, trigger, info, survivors, nd, old, mm = self._search
        # the deterministic boundary: a result that landed early was
        # held until now; a straggler is joined here (budget-bounded)
        t.join()
        self._search = None
        self._skip_wall = True  # this interval contains the swap, not a step
        box = _from_rank0(box)
        if "error" in box:
            self._emit("reconfig_error", trigger=trigger,
                       step=self.model._step_count,
                       error=repr(box["error"]))
            return
        res, old_s = box["result"]
        self._apply(trigger, info, res, old_s, survivors, nd, old, mm)

    # -- the hot swap -----------------------------------------------------
    def _apply(self, trigger, info, res, old_s, survivors, nd, old,
               mm) -> None:
        model = self.model
        step = model._step_count
        best_s = getattr(res, "best_s", None)
        gain = None
        if best_s is not None and old_s:
            gain = 1.0 - float(best_s) / float(old_s)
        device_change = trigger.startswith("device")
        old_devices = model.machine.num_devices
        if not device_change and (gain is None or gain < self.policy.gain):
            # acceptance gate: only for divergence swaps — a device-set
            # change must reshard regardless (the old strategy names
            # devices that are gone)
            self._record_outcome(step, trigger, "rejected_gain",
                                 gain=gain, threshold=self.policy.gain,
                                 sim_old_ms=_ms(old_s), sim_new_ms=_ms(best_s))
            return
        seq = self._seq
        self._seq += 1
        old_pb = os.path.join(self.out_dir, f"swap_{seq:03d}_old.pb")
        new_pb = os.path.join(self.out_dir, f"swap_{seq:03d}_new.pb")
        # flight recorder, old half: the strategy being replaced, under
        # the machine model the decision was made against
        self._write_pb(old_pb, old, engine="active", best_s=old_s, mm=mm,
                       trigger=trigger)
        # drain in-flight work (queued replays of the captured step) and
        # save at the current global step: the recompile below replaces
        # the parameters the save reads
        self._sync()
        self.manager.wait_until_finished()
        self._save(step, force=True)
        self.manager.wait_until_finished()
        new_machine = None
        if device_change or nd != model.machine.num_devices:
            new_machine = self._machine_for(survivors)
        # recompile() migrates the live state itself (host snapshot →
        # re-place under the new placements); the checkpoint above is the
        # durability record, not the migration path
        model.recompile(strategies=dict(res), machine=new_machine)
        self._write_pb(new_pb, dict(res), engine="reconfig-mcmc",
                       best_s=best_s, mm=mm, trigger=trigger,
                       budget=getattr(res, "budget", self.policy.budget),
                       seed=getattr(res, "seed", self.policy.seed))
        model._active_strategy_file = new_pb
        self._record_outcome(
            step, trigger, "applied", gain=gain,
            sim_old_ms=_ms(old_s), sim_new_ms=_ms(best_s),
            old_devices=old_devices, new_devices=nd, old_pb=old_pb, new_pb=new_pb,
            probation=("skipped_device_change" if device_change
                       else self.policy.probation), **info)
        if not device_change:
            pre = statistics.median(self._walls) \
                if len(self._walls) >= 3 else None
            self._probation = {"old": old, "old_pb": old_pb,
                               "new_pb": new_pb, "trigger": trigger,
                               "swap_step": step, "pre_p50": pre,
                               "post": []}
        self._walls.clear()
        self._last_t = None  # next interval spans the swap — don't count it

    def _machine_for(self, ranks) -> Any:
        """The machine over ``ranks``: the one the loop started on for the
        whole roster, else the survivors' (``Machine.for_ranks``, a
        collective over every rank of the process group)."""
        if list(ranks) == self._full_ranks:
            return self._full_machine
        from ..parallel.mesh import Machine

        return Machine.for_ranks(self.model.device, ranks)

    # -- probation / rollback ---------------------------------------------
    def _tick_probation(self, wall: float) -> None:
        p = self._probation
        p["post"].append(wall)
        if len(p["post"]) < self.policy.probation:
            return
        self._probation = None
        # rank 0's medians decide for every rank
        pre, post_p50 = _from_rank0((p["pre_p50"], statistics.median(p["post"])))
        step = self.model._step_count
        if pre and post_p50 > pre * self.policy.regress:
            self._rollback(p, pre, post_p50, step)
        else:
            self._record_outcome(
                step, p["trigger"], "probation_ok",
                swap_step=p["swap_step"], measured_pre_ms=_ms(pre),
                measured_post_ms=_ms(post_p50), new_pb=p["new_pb"])

    def _rollback(self, p, pre, post_p50, step) -> None:
        model = self.model
        self._sync()
        self.manager.wait_until_finished()  # see _apply: no overlap with
        self._save(step, force=True)        # the recompile below
        self.manager.wait_until_finished()
        model.recompile(strategies=p["old"])  # migrates live state in place
        model._active_strategy_file = p["old_pb"]
        self._record_outcome(
            step, p["trigger"], "rolled_back", swap_step=p["swap_step"],
            measured_pre_ms=_ms(pre), measured_post_ms=_ms(post_p50),
            regress_factor=round(post_p50 / pre, 3),
            threshold=self.policy.regress,
            old_pb=p["new_pb"], new_pb=p["old_pb"])
        self._walls.clear()
        self._last_t = None
        self._skip_wall = True

    # -- recording ---------------------------------------------------------
    def _write_pb(self, path: str, strategies, engine: str, best_s, mm,
                  trigger: str, budget: int = 0, seed: int = 0) -> None:
        """One half of a swap record: the strategy ``.pb`` plus its
        provenance sidecar, diffable with ``search_report --diff``.
        Best-effort — a full disk must not abort the swap itself."""
        if not self.model.machine.leads:
            return
        try:
            from ..observability.searchtrace import build_provenance
            from ..parallel.strategy import save_strategies_to_file

            prov = build_provenance(
                self.model, dict(strategies), engine=engine,
                budget=int(budget), seed=int(seed), best_s=best_s,
                machine_model=mm, extra={"reconfig_trigger": trigger})
            save_strategies_to_file(path, dict(strategies), provenance=prov)
        except Exception as e:  # noqa: BLE001 — recorder is advisory
            self._emit("reconfig_record_error", path=path, error=repr(e))

    def _record_outcome(self, step: int, trigger: str, outcome: str,
                        **attrs) -> None:
        self.swaps.append((step, trigger, outcome))
        clean = {k: v for k, v in attrs.items() if v is not None}
        self._emit("strategy_swap", step=step, trigger=trigger,
                   outcome=outcome, **clean)

    def _emit(self, name: str, **attrs) -> None:
        log = getattr(self.model, "_telemetry", None)
        if log is None:
            from ..observability.events import active_log
            log = active_log()
        if log is not None:
            from ..observability.reqtrace import run_trace_id

            # run-level trace id: reconfig events land on the same
            # timeline track family as step/compile spans
            log.event(name, trace_id=run_trace_id(log.run_id), **attrs)
            log.flush()

    def close(self) -> None:
        """End-of-loop teardown: stop reacting to observer events and
        let any in-flight search thread die with the process (daemon —
        it holds no locks the trainer needs)."""
        self._closed = True
        self._pending = None


def _searches() -> bool:
    """Whether this process runs the re-search (rank 0, or the only one)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _from_rank0(obj):
    """``obj`` as rank 0 holds it, on every rank of the process group (a
    collective; ``obj`` itself without one)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _ms(seconds) -> Optional[float]:
    return round(float(seconds) * 1e3, 4) if seconds else None


def maybe_controller(model, manager, checkpoint_dir: str,
                     save_fn=None, sync_fn=None) -> \
        Optional[ReconfigurationController]:
    """The elastic loop's hook: None (zero overhead) unless
    ``FF_RECONFIGURE`` is set."""
    policy = ReconfigPolicy.from_env()
    if policy is None:
        return None
    return ReconfigurationController(model, manager, checkpoint_dir,
                                     policy=policy, save_fn=save_fn,
                                     sync_fn=sync_fn)
