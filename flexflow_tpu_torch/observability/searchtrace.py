"""Search flight recorder: candidate-level tracing of the strategy search
(PyTorch port of the JAX package's ``observability/searchtrace.py``; the
recorder is a copy, the provenance helpers price with the port's H100
cost model).

The simulator+MCMC search is the paper's core mechanism (Jia et al.,
"Beyond Data and Model Parallelism"), yet a strategy file tells you
nothing about HOW it was found.  This module records the search itself
through the structured event log (``events.py``):

  ``search_start``       engine, budget, devices, seed, initial cost
  ``search_candidate``   one per proposal: mutated op, old/new config,
                         simulated cost + delta, accept/reject with the
                         reason ("downhill" vs "metropolis", including
                         the Metropolis acceptance probability), and the
                         best-so-far
  ``search_op_summary``  one per op at the end: final config, proposal/
                         accept counts, cumulative improvement won by
                         mutating this op, and the BEST REJECTED
                         ALTERNATIVE — the cheapest proposal that lost,
                         which is what lets ``tools/search_report.py``
                         answer "why THIS config and not that one?"
  ``search_summary``     totals: proposals, accepted, initial→best cost,
                         iteration of the last improvement

Engines: ``mcmc`` (simulator/search.py) and ``population``
(simulator/population.py) record every proposal.

ZERO COST WHEN DISABLED: ``SearchRecorder.maybe()`` returns ``None``
unless a telemetry log is active, and every call site guards on that —
a search without ``FF_TELEMETRY`` makes no event-log calls at all
(asserted by tests/test_torch_telemetry.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .events import EventLog, active_log


def pc_str(pc) -> str:
    """Compact one-token ParallelConfig rendering for event attrs and
    report tables: partition degrees joined by 'x', host placement and
    a non-zero device offset marked explicitly ("4x1x2x1", "host[1x1]",
    "2x1@4")."""
    if pc is None:
        return "?"
    dims = "x".join(str(d) for d in pc.dims)
    if getattr(pc, "host_placed", False):
        return f"host[{dims}]"
    ids = pc.device_ids[:pc.num_parts()]
    if ids and ids[0] != 0:
        return f"{dims}@{ids[0]}"
    return dims


def _r3(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(float(v), 3)


class SearchRecorder:
    """Per-search event emitter + per-op accounting.

    Costs are milliseconds of SIMULATED step time (the search
    objective); ``gain_ms`` is the cumulative step-time reduction from
    accepted proposals that mutated an op — the attribution the
    "most-improved ops" report section ranks by.
    """

    def __init__(self, log: EventLog, engine: str, budget: int,
                 num_devices: int, seed: int = 0):
        self.log = log
        self.engine = engine
        self.budget = budget
        self.num_devices = num_devices
        self.seed = seed
        self._ops: Dict[str, Dict[str, Any]] = {}
        self._proposals = 0
        self._accepted = 0
        self._initial_ms: Optional[float] = None
        self._best_ms: Optional[float] = None
        self._last_improve: Optional[int] = None

    @classmethod
    def maybe(cls, engine: str, budget: int, num_devices: int,
              seed: int = 0,
              log: Optional[EventLog] = None) -> Optional["SearchRecorder"]:
        """The recorder, or None when telemetry is off (the one branch
        every engine guards on — disabled searches make zero log calls)."""
        log = log if log is not None else active_log()
        if log is None:
            return None
        return cls(log, engine, budget, num_devices, seed)

    # -- lifecycle ------------------------------------------------------
    def start(self, initial_ms: Optional[float] = None,
              candidates: Optional[int] = None) -> None:
        self._initial_ms = initial_ms
        self._best_ms = initial_ms
        attrs: Dict[str, Any] = {"engine": self.engine,
                                 "budget": self.budget,
                                 "num_devices": self.num_devices,
                                 "seed": self.seed}
        if initial_ms is not None:
            attrs["initial_ms"] = _r3(initial_ms)
        if candidates is not None:
            attrs["candidates"] = int(candidates)
        self.log.event("search_start", **attrs)

    def _op(self, name: str) -> Dict[str, Any]:
        st = self._ops.get(name)
        if st is None:
            st = self._ops[name] = {"proposals": 0, "accepted": 0,
                                    "gain_ms": 0.0, "alt": None,
                                    "alt_ms": None}
        return st

    def candidate(self, it: int, op_name: str, old_pc, new_pc,
                  cur_ms: float, new_ms: float, best_ms: float,
                  accepted: bool, reason: str,
                  prob: Optional[float] = None,
                  **extra: Any) -> None:
        """One MCMC proposal.  ``reason``: "downhill" (new < current) or
        "metropolis" (uphill — accepted with probability ``prob``).
        ``best_ms`` is the best-so-far AFTER this proposal.  ``extra``
        attrs ride along verbatim (the population engine tags each
        proposal with its ``chain``)."""
        self._proposals += 1
        st = self._op(op_name)
        st["proposals"] += 1
        if accepted:
            self._accepted += 1
            st["accepted"] += 1
            st["gain_ms"] += cur_ms - new_ms
        elif st["alt_ms"] is None or new_ms < st["alt_ms"]:
            st["alt"] = pc_str(new_pc)
            st["alt_ms"] = new_ms
        if self._best_ms is None or best_ms < self._best_ms:
            self._best_ms = best_ms
            self._last_improve = it
        attrs = {"engine": self.engine, "iter": int(it), "op": op_name,
                 "old": pc_str(old_pc), "new": pc_str(new_pc),
                 "cur_ms": _r3(cur_ms), "new_ms": _r3(new_ms),
                 "delta_ms": _r3(new_ms - cur_ms), "best_ms": _r3(best_ms),
                 "accepted": bool(accepted), "reason": reason}
        if prob is not None:
            attrs["prob"] = round(float(prob), 6)
        attrs.update(extra)
        self.log.event("search_candidate", **attrs)

    # -- population-engine events ---------------------------------------
    def exchange(self, it: int, pair: tuple, low_ms: float, high_ms: float,
                 accepted: bool, prob: Optional[float] = None) -> None:
        """One replica-exchange attempt between the adjacent-temperature
        chains ``pair`` (colder chain first); ``low_ms``/``high_ms`` are
        their current simulated costs before the swap."""
        attrs = {"engine": self.engine, "iter": int(it),
                 "chain_a": int(pair[0]), "chain_b": int(pair[1]),
                 "a_ms": _r3(low_ms), "b_ms": _r3(high_ms),
                 "accepted": bool(accepted)}
        if prob is not None:
            attrs["prob"] = round(float(prob), 6)
        self.log.event("search_exchange", **attrs)

    def crossover(self, it: int, parents: tuple, child_chain: int,
                  patches: int, child_ms: Optional[float],
                  adopted: bool) -> None:
        """One genetic-crossover attempt: the elite ``parents`` spliced
        into a child costed on ``child_chain`` via ``patches`` delta
        patches; ``adopted`` marks whether the child replaced that
        chain's state (the lineage the report reconstructs)."""
        self.log.event("search_crossover", engine=self.engine,
                       iter=int(it), parent_a=int(parents[0]),
                       parent_b=int(parents[1]), chain=int(child_chain),
                       patches=int(patches), child_ms=_r3(child_ms),
                       adopted=bool(adopted))

    def elite(self, it: int, ranking: list) -> None:
        """Current population ranking at a crossover point:
        ``ranking`` = [(chain, cur_ms)] best first."""
        self.log.event("search_elite", engine=self.engine, iter=int(it),
                       chains=[int(c) for c, _ in ranking],
                       cur_ms=[_r3(m) for _, m in ranking])

    def plan(self, desc: str, cost_ms: float, accepted: bool, **attrs: Any) -> None:
        """One pipeline-grid plan (simulator/pipeline_search.py), recorded
        as a candidate on the synthetic op ``<pipeline>`` (``desc`` e.g.
        "S4xdp2,M8,remat"); ``accepted`` marks a new grid best."""
        self._proposals += 1
        if accepted:
            self._accepted += 1
            if self._best_ms is None or cost_ms < self._best_ms:
                self._best_ms = cost_ms
                self._last_improve = self._proposals - 1
        self.log.event("search_candidate", engine=self.engine, iter=self._proposals - 1,
                       op="<pipeline>", new=desc, new_ms=_r3(cost_ms),
                       best_ms=_r3(self._best_ms), accepted=bool(accepted), reason="grid",
                       **attrs)

    def finish(self, best: Optional[Dict[str, Any]] = None,
               best_ms: Optional[float] = None,
               initial_ms: Optional[float] = None,
               proposals_per_s: Optional[float] = None,
               delta: Optional[bool] = None) -> None:
        """Emit the per-op summaries (one per op in the FINAL strategy,
        including ops the proposal stream never touched — the report's
        "why" table must cover every op) and the run summary.
        ``proposals_per_s``/``delta`` record search throughput and
        whether the incremental (delta) simulator was active at the end
        of the run — the numbers behind the ``search_throughput`` perf-
        ledger metric."""
        if initial_ms is not None:
            self._initial_ms = initial_ms
        if best_ms is not None:
            self._best_ms = best_ms
        names = list(best.keys()) if best else list(self._ops.keys())
        for name in names:
            st = self._ops.get(name) or {"proposals": 0, "accepted": 0,
                                         "gain_ms": 0.0, "alt": None,
                                         "alt_ms": None}
            attrs = {"engine": self.engine, "op": name,
                     "proposals": st["proposals"],
                     "accepted": st["accepted"],
                     "gain_ms": _r3(st["gain_ms"])}
            if best is not None:
                attrs["final"] = pc_str(best.get(name))
            if st["alt"] is not None:
                attrs["alt"] = st["alt"]
                attrs["alt_ms"] = _r3(st["alt_ms"])
                if self._best_ms is not None:
                    attrs["alt_delta_ms"] = _r3(st["alt_ms"] - self._best_ms)
            self.log.event("search_op_summary", **attrs)
        attrs = {"engine": self.engine, "budget": self.budget,
                 "num_devices": self.num_devices, "seed": self.seed,
                 "proposals": self._proposals, "accepted": self._accepted,
                 "num_ops": len(names)}
        if self._initial_ms is not None:
            attrs["initial_ms"] = _r3(self._initial_ms)
        if self._best_ms is not None:
            attrs["best_ms"] = _r3(self._best_ms)
        if self._last_improve is not None:
            attrs["last_improve_iter"] = int(self._last_improve)
        if proposals_per_s is not None:
            attrs["proposals_per_s"] = round(proposals_per_s, 1)
        if delta is not None:
            attrs["delta"] = bool(delta)
        self.log.event("search_summary", **attrs)


# ----------------------------------------------------------------------
# provenance helpers (used by the sidecar stampers, not the hot path)
# ----------------------------------------------------------------------

def per_op_attribution(model, strategies, machine_model=None,
                       compute_dtype: Optional[str] = None
                       ) -> Dict[str, Dict[str, Any]]:
    """Per-op cost attribution for a strategy map: ``{op: {dims, parts,
    host, spec, fwd_ms, bwd_ms}}`` priced by the non-measuring H100 cost
    model, the rows a ``.pb.meta.json`` sidecar carries.  ``spec`` is the
    whole-graph lowering's placement of the op's output on the mesh this
    device count gets (``parallel/lowering.py``'s pure shadow: nodes of
    the machine model's GPUs, a ``dcn`` dim leading when there are
    several), so a sidecar a search tool wrote carries it without a model
    compiled on that mesh."""
    from ..config import ParallelConfig
    from ..parallel import lowering as _lowering
    from ..simulator.cost_model import CostModel
    from ..simulator.machine import H100MachineModel

    nd = model.machine.num_devices if getattr(model, "machine", None) \
        is not None else model.config.num_devices
    mm = machine_model or H100MachineModel.calibrated(num_devices=nd)
    cm = CostModel(mm, measure=False,
                   compute_dtype=compute_dtype or model.config.compute_dtype)
    names, sizes = _lowering.hybrid_axis_layout(nd, mm.num_nodes)
    rows: Dict[str, Dict[str, Any]] = {}
    for op in model.ops:
        pc = strategies.get(op.name) or getattr(op, "pc", None) \
            or ParallelConfig.data_parallel(op.output.num_dims, nd)
        pc = op.legalize_pc(pc)
        try:
            groups, _ = _lowering.assign_axes(names, sizes, pc.dims,
                                              _lowering.dim_roles(op, len(pc.dims)))
            spec = _lowering.spec_string(groups)
        except ValueError:
            spec = "?"  # a degree the mesh cannot express; advisory only
        rows[op.name] = {
            "dims": "x".join(str(d) for d in pc.dims),
            "parts": pc.num_parts(),
            "host": bool(pc.host_placed),
            "spec": spec,
            "fwd_ms": round(cm.op_time(op, pc, "forward") * 1e3, 4),
            "bwd_ms": round(cm.op_time(op, pc, "backward") * 1e3, 4),
        }
    return rows


def search_stats_extra(stats: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """What a sidecar keeps of a population search's run stats."""
    if not stats:
        return {}
    out: Dict[str, Any] = {"population": {k: stats[k] for k in
                                          ("population", "ladder", "spent", "winner_chain",
                                           "exchange", "crossover") if k in stats}}
    if stats.get("learned"):
        out["learned_tier"] = stats["learned"]
    return out


def build_provenance(model, strategies, engine: str, budget: int,
                     seed: int, best_s: Optional[float] = None,
                     dp_s: Optional[float] = None,
                     machine_model=None,
                     extra: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The provenance dict a strategy sidecar records (content hash and
    timestamps are stamped by ``parallel.strategy.write_provenance``).
    When a telemetry log is active its run id is included, so a training
    trace that loads this strategy links back to the search trace that
    produced it."""
    from ..simulator.machine import H100MachineModel
    from ..simulator.memory import memory_per_device

    nd = model.machine.num_devices if getattr(model, "machine", None) \
        is not None else model.config.num_devices
    mm = machine_model or H100MachineModel.calibrated(num_devices=nd)
    meta: Dict[str, Any] = {
        "engine": engine,
        "budget": int(budget),
        "seed": int(seed),
        "num_devices": int(nd),
        "batch_size": int(model.config.batch_size),
        "compute_dtype": model.config.compute_dtype,
        "machine_model": mm.source,
    }
    if best_s is not None:
        meta["best_ms"] = round(float(best_s) * 1e3, 4)
    if dp_s is not None:
        meta["dp_ms"] = round(float(dp_s) * 1e3, 4)
    # the whole-graph lowering stamp: was this strategy compiled into one
    # step (parallel/lowering.py), and where did each op's spec land
    low = getattr(model, "_lowering", None)
    meta["lowered"] = low is not None
    if low is not None:
        try:
            meta["lowering"] = low.plan()
        except Exception as e:  # noqa: BLE001 — advisory; never block export
            meta["lowering_error"] = repr(e)
    log = active_log()
    if log is not None:
        meta["search_run_id"] = log.run_id
    meta["ops"] = per_op_attribution(model, strategies, machine_model=mm)
    # predicted per-device HBM under this strategy map
    mem = memory_per_device(model, strategies, machine_model=mm)
    meta["hbm_per_device_bytes"] = [row["total"] for row in mem["per_device"]]
    meta["hbm_peak_bytes"] = mem["peak_bytes"]
    meta["hbm_dominant_term"] = mem["dominant_term"]
    if "capacity_bytes" in mem:
        meta["hbm_capacity_bytes"] = mem["capacity_bytes"]
    if extra:
        meta.update(extra)
    return meta
