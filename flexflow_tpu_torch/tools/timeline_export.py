"""Fold a telemetry JSONL trace into Chrome trace-event JSON (Perfetto)
(PyTorch port of the JAX package's ``tools/timeline_export.py``; the port
writes that package's record schema, so the fold is the same).

``trace_report``/``serve_report`` aggregate; this tool keeps TIME: every
span becomes a matched B/E pair and every interesting event an instant
marker, laid out on tracks so a whole incident (flash crowd + replica
kill + reconfig swap) reads as one timeline in https://ui.perfetto.dev
(or chrome://tracing).

Track layout (process -> threads):

  requests   one track per SAMPLED request trace (FF_TRACE_SAMPLE),
             ``<trace8>`` for the client root span and ``<trace8>/aN``
             per pool attempt — a failover/hedge race renders as
             sibling attempt tracks under one trace, with queue-wait /
             prefill / decode-chunk spans nested inside each attempt
             and KV block events as instant markers
  serving    one track per replica engine (``replica-0``, ... — plus
             ``/slotN`` when a span names its decode slot), carrying
             untraced serve spans, pool lifecycle events
             (replica_down / restart / shed / drain), and counter
             tracks for batch occupancy, KV block residency, and SLO
             burn rate
  training   the step/compile/recompile/checkpoint/data-wait spans and
             reconfig events (all tagged with the run-level trace id)
  search     strategy-search spans + search_*/sim_* progress events
  compile    the memory plane: each CUDA-graph capture's
             ``compile_done`` (retrace markers, graph pool bytes) and
             ``memory_predicted``.  The ``xla_*`` names stay in
             ``COMPILE_EVENTS`` so a JAX package trace folds the same;
             the port writes none of them
  chips      chip-session records of ``observability/chipwatch.py``
             (chip_probe / chip_window / measurement_progress)

STDLIB-ONLY like every reader in tools/: a trace from a GPU machine must
fold on any laptop.  Timestamps are the log's relative seconds scaled
to integer microseconds; B/E pairs are emitted stack-safe per track
(children clamp into their enclosing span), so any Chrome-trace
consumer accepts the output.

Usage:
    python -m flexflow_tpu_torch.tools.timeline_export ff_trace.jsonl \
        -o timeline.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

from .trace_report import parse_trace

# span names per subsystem track (anything unknown lands on training —
# new training-side phases appear there without a tool change)
SEARCH_SPANS = frozenset((
    "mcmc_search", "population_search", "pipeline_search",
    "native_search"))
COMPILE_EVENTS = frozenset((
    "compile_done", "xla_memory", "xla_memory_error", "xla_cost",
    "xla_cost_error", "memory_predicted", "memory_predicted_error"))
CHIP_EVENTS = frozenset((
    "chip_probe", "chip_window", "measurement_progress"))
SERVE_EVENT_PREFIXES = ("serve_", "request_", "replica_", "pool_",
                        "slo_", "kv_")

# gauge name -> (process, counter-name template); {replica}/{slo} etc.
# are filled from the record's attrs
COUNTER_GAUGES = {
    "serve_batch_occupancy": ("serving", "occupancy {replica}"),
    "serve_kv_blocks_used": ("serving", "kv_blocks {replica}"),
    "slo_burn_rate": ("serving", "burn_rate {slo}/{window}"),
    "slo_budget_remaining": ("serving", "slo_budget {slo}"),
    "samples_per_sec": ("training", "samples_per_sec"),
    "mfu": ("training", "mfu"),
}

_US = 1_000_000


def _us(ts: float) -> int:
    return max(0, int(round(float(ts) * _US)))


def sampled_traces(records: List[Dict[str, Any]]) -> set:
    """Trace ids with SPAN-LEVEL detail: sampled requests carry span
    ids (reqtrace.TraceContext.ids/tag); unsampled ones and the
    training run-trace stamp only the bare trace_id and stay on their
    subsystem tracks."""
    out = set()
    for r in records:
        attrs = r.get("attrs") or {}
        tid = attrs.get("trace_id")
        if tid and ("span_id" in attrs or "parent_span_id" in attrs):
            out.add(tid)
    return out


def _request_tid(attrs: Dict[str, Any]) -> str:
    """Track name inside the requests process: one per attempt so
    racing attempts never interleave on one stack."""
    t8 = str(attrs.get("trace_id", ""))[:8]
    rid = str(attrs.get("request_id", ""))
    if "#" in rid:
        return f"{t8}/{rid.rsplit('#', 1)[1]}"
    return t8


def _classify_span(rec: Dict[str, Any],
                   sampled: set) -> Tuple[str, str]:
    name = rec.get("name", "?")
    attrs = rec.get("attrs") or {}
    if attrs.get("trace_id") in sampled:
        return "requests", _request_tid(attrs)
    if name in SEARCH_SPANS:
        return "search", "search"
    if name.startswith("serve_"):
        tid = str(attrs.get("replica", "engine"))
        if "slot" in attrs:
            tid = f"{tid}/slot{attrs['slot']}"
        return "serving", tid
    return "training", "train"


def _classify_event(rec: Dict[str, Any],
                    sampled: set) -> Optional[Tuple[str, str]]:
    name = rec.get("name", "?")
    attrs = rec.get("attrs") or {}
    if attrs.get("trace_id") in sampled:
        return "requests", _request_tid(attrs)
    if name in COMPILE_EVENTS:
        return "compile", "compile"
    if name in CHIP_EVENTS:
        return "chips", "chips"
    if name.startswith(("search_", "sim_")):
        return "search", "search"
    if name.startswith(SERVE_EVENT_PREFIXES) or name == "fault_injected":
        return "serving", str(attrs.get("replica", "pool"))
    return "training", "train"


def _fold_spans(spans: List[Tuple[int, int, str, Dict[str, Any]]],
                pid: int, tid: int) -> List[Dict[str, Any]]:
    """Stack-safe B/E fold of one track's (ts_us, dur_us, name, args)
    spans: sorted by start, children clamped into the enclosing open
    span so every B has a matching E and nesting is well-formed even
    when producer clocks overlap (a failover attempt's queue-wait span
    starts on the caller's clock, before the attempt span opened)."""
    out: List[Dict[str, Any]] = []
    stack: List[int] = []          # open spans' end timestamps
    for ts, dur, name, args in sorted(spans,
                                      key=lambda s: (s[0], -s[1])):
        while stack and stack[-1] <= ts:
            out.append({"ph": "E", "pid": pid, "tid": tid,
                        "ts": stack.pop()})
        end = ts + max(0, dur)
        if stack and end > stack[-1]:
            end = stack[-1]        # clamp child into parent
        out.append({"ph": "B", "pid": pid, "tid": tid, "ts": ts,
                    "name": name, "args": args})
        stack.append(end)
    while stack:
        out.append({"ph": "E", "pid": pid, "tid": tid,
                    "ts": stack.pop()})
    return out


def export_records(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The Chrome trace-event document (a JSON-serializable dict) for
    one event-log record list."""
    sampled = sampled_traces(records)
    # (process, track) -> list of (ts_us, dur_us, name, args)
    spans: Dict[Tuple[str, str], List] = {}
    instants: List[Tuple[str, str, int, str, Dict[str, Any]]] = []
    counters: List[Tuple[str, int, str, float]] = []
    meta: Dict[str, Any] = {}
    for rec in records:
        t = rec.get("t")
        attrs = rec.get("attrs") or {}
        if t == "meta":
            meta = rec
        elif t == "span":
            key = _classify_span(rec, sampled)
            spans.setdefault(key, []).append(
                (_us(rec.get("ts", 0.0)), _us(rec.get("dur", 0.0)),
                 rec.get("name", "?"), attrs))
        elif t == "event":
            key = _classify_event(rec, sampled)
            if key is not None:
                instants.append((key[0], key[1], _us(rec.get("ts", 0.0)),
                                 rec.get("name", "?"), attrs))
        elif t == "gauge":
            route = COUNTER_GAUGES.get(rec.get("name", ""))
            if route is not None:
                proc, tmpl = route
                try:
                    cname = tmpl.format(**{k: attrs.get(k, "?")
                                           for k in ("replica", "slo",
                                                     "window")})
                except Exception:  # noqa: BLE001 — label gaps are fine
                    cname = tmpl
                counters.append((proc, _us(rec.get("ts", 0.0)), cname,
                                 float(rec.get("v", 0.0))))

    # stable integer ids per process/track, in first-seen order
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}

    def pid_of(proc: str) -> int:
        return pids.setdefault(proc, len(pids) + 1)

    def tid_of(proc: str, track: str) -> int:
        return tids.setdefault((proc, track),
                               len([k for k in tids if k[0] == proc]) + 1)

    events: List[Dict[str, Any]] = []
    for (proc, track), rows in sorted(spans.items()):
        events.extend(_fold_spans(rows, pid_of(proc),
                                  tid_of(proc, track)))
    for proc, track, ts, name, args in instants:
        events.append({"ph": "i", "pid": pid_of(proc),
                       "tid": tid_of(proc, track), "ts": ts,
                       "name": name, "s": "t", "args": args})
    for proc, ts, cname, v in counters:
        events.append({"ph": "C", "pid": pid_of(proc), "tid": 0,
                       "ts": ts, "name": cname,
                       "args": {"value": v}})
    events.sort(key=lambda e: e["ts"])

    head: List[Dict[str, Any]] = []
    for proc, p in pids.items():
        head.append({"ph": "M", "pid": p, "tid": 0, "ts": 0,
                     "name": "process_name", "args": {"name": proc}})
    for (proc, track), t in tids.items():
        head.append({"ph": "M", "pid": pids[proc], "tid": t, "ts": 0,
                     "name": "thread_name", "args": {"name": track}})
    return {
        "traceEvents": head + events,
        "displayTimeUnit": "ms",
        "otherData": {"run_id": meta.get("run_id", ""),
                      "schema_version": meta.get("version", 0),
                      "request_tracks": sorted(
                          {k[1] for k in tids if k[0] == "requests"})},
    }


def summarize(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Counts for smoke checks and the one-line CLI summary."""
    evs = doc.get("traceEvents", [])
    begins = sum(1 for e in evs if e.get("ph") == "B")
    return {
        "events": len(evs),
        "spans": begins,
        "instants": sum(1 for e in evs if e.get("ph") == "i"),
        "counters": sum(1 for e in evs if e.get("ph") == "C"),
        "request_tracks": len(doc.get("otherData", {})
                              .get("request_tracks", [])),
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Fold a flexflow_tpu_torch telemetry JSONL trace into "
                    "Chrome trace-event JSON loadable in Perfetto.")
    ap.add_argument("trace", help="path to the ff_trace.jsonl file")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: <trace>.timeline.json)")
    args = ap.parse_args(argv)
    records = parse_trace(args.trace)
    if not records:
        print(f"timeline_export: no records in {args.trace}",
              file=sys.stderr)
        return 1
    doc = export_records(records)
    out = args.out or (args.trace.rsplit(".jsonl", 1)[0]
                       + ".timeline.json")
    with open(out, "w") as f:
        json.dump(doc, f)
    s = summarize(doc)
    print(f"timeline_export: {s['spans']} spans, {s['instants']} "
          f"instants, {s['counters']} counter samples, "
          f"{s['request_tracks']} request track(s) -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
