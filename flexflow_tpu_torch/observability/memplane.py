"""Memory & compile plane: the CUDA-graph capture ledger and the
predicted memory view (PyTorch port of the JAX package's
``observability/memplane.py``).

Two jobs, both riding an enabled telemetry log:

* **Predicted** (always on with telemetry): ``emit_memory_prediction``
  runs the analytic per-device memory model (``simulator/memory.py``)
  over the model's resolved strategies at compile and emits one
  ``memory_predicted`` event: the peak device, the per-term breakdown,
  the headroom against the H100 machine model's ``hbm_capacity``.

* **Captured** (``FF_MEMPLANE=1``): the JAX package owns each XLA
  compile through AOT lowering.  The card's counterpart of a compile is
  a CUDA-graph capture (``runtime/step_graph.py``,
  ``runtime/decode_graph.py``), and ``MemPlane.watch`` observes each one
  at its site: the training step (``train_step``), each ``generate`` and
  ``beam_search`` signature, each serving window and the prefill step.
  Every capture emits ``compile_done`` (site, fingerprint of the graph's
  signature, the capture's host wall, and ``graph_pool_bytes``: the
  bytes the caching allocator holds in the graph's own memory pool,
  ``StepGraph.pool_bytes``), counts in ``compiles``, and a second
  capture at a site that already captured (a new signature, or the same
  one captured again after a drop) counts in ``compile_retraces``, which
  ``/metrics`` renders as ``ff_compile_retraces_total``.  A lowered model
  (parallel/lowering.py) also compiles its regions with ``torch.compile``:
  each graph compiled at a site (``train_step``, ``eval_step``,
  ``decode_step``) emits ``compile_done`` with ``stage="compile"`` (a
  capture's says ``stage="capture"``), counted the same way, a second
  compile at a site a retrace.  XLA's
  ``memory_analysis``/``cost_analysis`` have no counterpart on the card,
  so their records (``xla_memory``, ``xla_cost``) are absent, and
  ``aot`` is false: no capture is compiled ahead of its first run.

Disabled is free: ``maybe_plane`` returns None unless ``FF_MEMPLANE`` is
set and a telemetry log exists, and every call site guards on it.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

# Events carry at most this many per-op rows.
MAX_OP_ROWS = 32


def enabled_from_env() -> bool:
    """``FF_MEMPLANE`` truthy (any non-empty value but "0")."""
    return os.environ.get("FF_MEMPLANE", "") not in ("", "0")


def maybe_plane(log) -> Optional["MemPlane"]:
    """Resolve the capture ledger at ``compile()`` (or an engine's
    construction): None unless ``FF_MEMPLANE`` is set and telemetry is on."""
    if log is None or not enabled_from_env():
        return None
    return MemPlane(log)


def _fingerprint(site: str, key) -> str:
    return hashlib.sha1(repr((site, key)).encode()).hexdigest()[:12]


class MemPlane:
    """Per-model (or per-engine) capture ledger.  Every graph it watches
    shares its cumulative ``compiles``/``retraces`` counts."""

    def __init__(self, log):
        self.log = log
        self.compiles = 0
        self.retraces = 0
        self._sites: set = set()

    def watch(self, site: str, graph):
        """Have ``graph`` (a ``StepGraph``) report each capture at ``site``."""
        graph.on_capture = lambda key, wall_s, pool_bytes: self.on_capture(
            site, key, wall_s, pool_bytes)
        return graph

    def on_capture(self, site: str, key, wall_s: float,
                   pool_bytes: Optional[int]) -> None:
        attrs = {}
        if pool_bytes is not None:
            attrs["graph_pool_bytes"] = int(pool_bytes)
        self._done(site, key, wall_s, "capture", attrs)

    def on_compile(self, site: str, wall_s: float) -> None:
        """A lowered region's graph compiled at ``site``
        (``GraphLowering.on_compile``)."""
        self._done(site, None, wall_s, "compile", {})

    def _done(self, site: str, key, wall_s: float, stage: str, attrs: dict) -> None:
        retrace = (site, stage) in self._sites
        self._sites.add((site, stage))
        self.compiles += 1
        if retrace:
            self.retraces += 1
        log = self.log
        log.event("compile_done", site=site, fingerprint=_fingerprint(site, key),
                  wall_s=round(wall_s, 4), retrace=retrace, aot=False, stage=stage,
                  total_compiles=self.compiles, total_retraces=self.retraces, **attrs)
        log.counter("compiles", 1, site=site)
        # 0-increments keep the series alive (and scrapeable) from the
        # first capture, so "flat" is observable, not just absent
        log.counter("compile_retraces", 1 if retrace else 0, site=site)
        log.flush()


def emit_memory_prediction(model, log) -> None:
    """Run the analytic memory model over the model's resolved strategies
    and fold one ``memory_predicted`` event into ``log``."""
    if log is None:
        return
    from ..simulator.machine import H100MachineModel
    from ..simulator.memory import memory_per_device

    nd = model.machine.num_devices if model.machine is not None \
        else model.config.num_devices
    mem = memory_per_device(model, None,
                            machine_model=H100MachineModel.calibrated(num_devices=nd))
    peak = mem["per_device"][mem["peak_device"]]
    ops = sorted(mem["by_op"].items(), key=lambda kv: -kv[1]["bytes"])
    by_op = {name: row["bytes"] for name, row in ops[:MAX_OP_ROWS]}
    if len(ops) > MAX_OP_ROWS:
        by_op["<other>"] = sum(row["bytes"] for _, row in ops[MAX_OP_ROWS:])
    log.event("memory_predicted",
              num_devices=mem["num_devices"],
              peak_bytes=mem["peak_bytes"],
              peak_device=mem["peak_device"],
              dominant_term=mem["dominant_term"],
              terms={k: peak[k] for k in
                     ("params", "grads", "optimizer", "activations", "staging")},
              capacity_bytes=mem.get("capacity_bytes"),
              headroom_bytes=mem.get("headroom_bytes"),
              opt_slots=mem["opt_slots"],
              by_op=by_op)
