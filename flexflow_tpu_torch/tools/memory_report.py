"""Fold a telemetry JSONL trace into a markdown memory report (PyTorch port
of the JAX package's ``tools/memory_report.py``).

Cross-checks the three device-memory views the memory plane records:

  * **predicted**: the analytic per-device model (``simulator/memory.py``)
    stamped as a ``memory_predicted`` event at compile: params + grads +
    optimizer slots + live activations + collective staging, per device
    under the resolved strategies;
  * **captured**: the port's counterpart of the JAX package's XLA
    executables is a CUDA-graph capture (``observability/memplane.py``,
    ``FF_MEMPLANE=1``).  Per site, from its ``compile_done`` records: the
    captures, the retraces, the host wall of the last capture and
    ``graph_pool_bytes``, the bytes the caching allocator holds in the
    graph's own pool.  The train step's pool holds the step's activations
    and temporaries, not the parameters, gradients or optimizer state
    (those live outside the graph, at fixed addresses), so the pool is held
    against the predicted activations + staging, not the predicted peak.
    The port writes no ``xla_memory``/``xla_cost`` record;
  * **live**: the allocator's truth, the last ``hbm_bytes{device,kind}``
    gauges sampled from ``torch.cuda.memory_stats`` (absent on the CPU,
    which reports none) and the serving KV pool's block bytes.

Any two views disagreeing by more than the divergence band (a factor of 2
either way) get a loud ``!!`` row: either the analytic model or the
deployment assumption is wrong.  The checks are "predicted activations +
staging / largest graph pool" and "live(peak) / predicted peak".
Records the reader does not know, and corrupt lines, are skipped.

STDLIB-ONLY: a trace from a GPU machine must fold on any laptop.

    python -m flexflow_tpu_torch.tools.memory_report ff_trace.jsonl
    python -m flexflow_tpu_torch.tools.memory_report ff_trace.jsonl -o mem.md
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional

from .trace_report import _fmt_bytes, parse_trace

# ratios outside [1/BAND, BAND] are flagged
DIVERGENCE_BAND = 2.0

__all__ = ["DIVERGENCE_BAND", "fold", "main", "parse_trace", "render"]


def fold(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Reduce the record stream to the three views and the capture ledger."""
    predicted: Optional[Dict[str, Any]] = None
    # site -> row from its compile_done records; the last capture's wall
    # and pool win (a recapture supersedes)
    sites: Dict[str, Dict[str, Any]] = {}
    compiles: Dict[str, int] = {}
    retraces: Dict[str, int] = {}
    live: Dict[tuple, float] = {}  # (device, kind) -> last gauge value
    for r in records:
        if not isinstance(r, dict):
            continue
        t, name = r.get("t"), r.get("name")
        at = r.get("attrs", {}) or {}
        if t == "event" and name == "memory_predicted":
            predicted = at  # last wins: a recompile stamps it again
        elif t == "event" and name == "compile_done" and at.get("stage") != "compile":
            # a lowered region's torch.compile is no capture: no pool of its own
            row = sites.setdefault(str(at.get("site", "?")), {"captures": 0})
            row["captures"] += 1
            row["wall_s"] = at.get("wall_s")
            if at.get("graph_pool_bytes") is not None:
                row["graph_pool_bytes"] = at.get("graph_pool_bytes")
        elif t == "counter" and name == "compiles":
            s = str(at.get("site", "?"))
            compiles[s] = compiles.get(s, 0) + int(r.get("v", 0))
        elif t == "counter" and name == "compile_retraces":
            s = str(at.get("site", "?"))
            retraces[s] = retraces.get(s, 0) + int(r.get("v", 0))
        elif t == "gauge" and name == "hbm_bytes":
            live[(str(at.get("device", "?")), str(at.get("kind", "?")))] = \
                float(r.get("v", 0.0))
    return {"predicted": predicted, "sites": sites, "compiles": compiles,
            "retraces": retraces, "live": live}


def _ratio_line(label: str, r: float, detail: str = "") -> str:
    flag = "!! " if not (1.0 / DIVERGENCE_BAND <= r <= DIVERGENCE_BAND) else ""
    return f"- {flag}{label} = {r:.2f}{detail}"


def render(f: Dict[str, Any], path: str) -> str:
    out: List[str] = [f"# Memory report — `{path}`", ""]
    pred = f["predicted"]

    # -- predicted ------------------------------------------------------
    out.append("## Predicted (analytic model)")
    out.append("")
    if pred:
        out.append(f"- devices: {pred.get('num_devices')}, peak on device "
                   f"{pred.get('peak_device')}: "
                   f"**{_fmt_bytes(pred.get('peak_bytes', 0))}** "
                   f"(dominant term: {pred.get('dominant_term')})")
        terms = pred.get("terms") or {}
        if terms:
            out.append("")
            out.append("| term | bytes (peak device) |")
            out.append("|---|---|")
            for k, v in terms.items():
                out.append(f"| {k} | {_fmt_bytes(v)} |")
        by_op = pred.get("by_op") or {}
        if by_op:
            out.append("")
            out.append("| op | bytes (max over devices) |")
            out.append("|---|---|")
            for opn, b in sorted(by_op.items(), key=lambda kv: -kv[1]):
                out.append(f"| {opn} | {_fmt_bytes(b)} |")
    else:
        out.append("(no `memory_predicted` event in trace — run with "
                   "FF_TELEMETRY=1 and recompile)")
    out.append("")

    # -- headroom -------------------------------------------------------
    out.append("## Headroom")
    out.append("")
    if pred and pred.get("capacity_bytes"):
        cap = float(pred["capacity_bytes"])
        peak = float(pred.get("peak_bytes", 0))
        head = cap - peak
        pct = 100.0 * head / cap if cap else 0.0
        out.append(f"- headroom: **{_fmt_bytes(head)}** of "
                   f"{_fmt_bytes(cap)} HBM free after predicted peak "
                   f"({pct:.1f}%)")
    else:
        out.append("- headroom: unknown (no machine capacity in trace)")
    out.append("")

    # -- CUDA-graph captures --------------------------------------------
    out.append("## CUDA-graph captures")
    out.append("")
    sites = f["sites"]
    if sites:
        out.append("| site | captures | retraces | capture wall | graph pool |")
        out.append("|---|---|---|---|---|")
        for s in sorted(sites):
            row = sites[s]
            pool = row.get("graph_pool_bytes")
            out.append("| {} | {} | {} | {} | {} |".format(
                s, f["compiles"].get(s, row["captures"]), f["retraces"].get(s, 0),
                f"{row['wall_s']:.3f}s" if row.get("wall_s") is not None else "-",
                _fmt_bytes(pool) if pool is not None else "-"))
        total_retraces = sum(f["retraces"].values())
        if total_retraces:
            out.append("")
            out.append(f"- **{total_retraces} retrace(s)** — a site captured again for "
                       "a new signature; on a serving ladder this means a bucket leak")
    else:
        out.append("(no capture events in trace — run with FF_MEMPLANE=1)")
    out.append("")

    # -- live -----------------------------------------------------------
    out.append("## Live HBM")
    out.append("")
    live = f["live"]
    if live:
        out.append("| device | kind | bytes |")
        out.append("|---|---|---|")
        for (dev, kind), v in sorted(live.items()):
            out.append(f"| {dev} | {kind} | {_fmt_bytes(v)} |")
    else:
        out.append("(no `hbm_bytes` gauges in trace — CPU backend reports "
                   "no allocator stats)")
    out.append("")

    # -- divergence -----------------------------------------------------
    out.append("## Divergence")
    out.append("")
    checks: List[str] = []
    pool_peak = max((row.get("graph_pool_bytes") or 0 for row in sites.values()),
                    default=0)
    terms = (pred or {}).get("terms") or {}
    act = float(terms.get("activations", 0) or 0) + float(terms.get("staging", 0) or 0)
    if pred and pool_peak and act:
        checks.append(_ratio_line(
            "predicted activations + staging / largest graph pool", act / pool_peak,
            f" ({_fmt_bytes(act)} vs {_fmt_bytes(pool_peak)})"))
    live_peak = max((v for (_, kind), v in live.items() if kind == "peak"), default=0.0)
    if live_peak and pred:
        checks.append(_ratio_line("live(peak) / predicted peak",
                                  live_peak / max(float(pred.get("peak_bytes", 0)), 1.0),
                                  f" ({_fmt_bytes(live_peak)} vs "
                                  f"{_fmt_bytes(pred.get('peak_bytes', 0))})"))
    if checks:
        out.extend(checks)
        if any(c.startswith("- !! ") for c in checks):
            out.append("")
            out.append(f"`!!` marks a ratio outside [1/{DIVERGENCE_BAND:g}, "
                       f"{DIVERGENCE_BAND:g}] — the analytic model or the "
                       "deployment assumption is wrong")
    else:
        out.append("(fewer than two views in trace — nothing to cross-check)")
    out.append("")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(
        description="Fold a telemetry trace into a markdown memory report")
    p.add_argument("trace", help="telemetry JSONL file (FF_TELEMETRY_FILE)")
    p.add_argument("-o", "--output", help="write report here (default stdout)")
    args = p.parse_args(argv)

    report = render(fold(parse_trace(args.trace)), args.trace)
    if args.output:
        with open(args.output, "w") as f:
            f.write(report)
    else:
        sys.stdout.write(report)
    return report


if __name__ == "__main__":
    main()
