"""Fold a serving telemetry trace into a markdown latency report (a copy
of the JAX package's ``tools/serve_report.py``; the records are the same).

Reads the records the serving engine emits (``serve_queue_wait`` /
``serve_prefill`` / ``serve_decode`` spans, ``serve_request_done``
events, the per-token-boundary ``serve_batch_occupancy`` gauge) and
renders the standard serving lens: request outcomes, queue-wait / TTFT /
TPOT percentiles, achieved tokens/s, and batch occupancy over time —
the metric that says whether continuous batching actually batched.
Replica-pool runs additionally get "## Replicas": per-replica occupancy
and completions plus the pool lifecycle (``replica_down`` /
``replica_restart`` / ``request_failover`` / ``request_hedged`` /
``request_shed`` / ``pool_drain`` events).

Fleet runs (pool + autoscaler, ``tools/fleet_bench.py``) additionally
get "## Fleet": the ready-replica-count timeline
(``pool_ready_replicas`` / per-zone ``pool_zone_ready`` gauges), every
``scale_event`` with its reason, zone incidents (``zone_down``), the
``replica_added`` / ``replica_retired`` churn, and per-zone batch
occupancy (the ``zone`` attr the engines stamp on their gauges).

Traced runs (records stamped with ``trace_id`` — any telemetry run
since reqtrace landed) also get "## Slow requests": the top-5 traces by
end-to-end latency, each as a queue-wait -> prefill -> decode waterfall
per attempt, with failover/hedge narration.

STDLIB-ONLY, like every report CLI here: a trace from a serving card
must be foldable on any laptop.

Usage:
    python -m flexflow_tpu_torch.tools.serve_report ff_trace.jsonl
    python -m flexflow_tpu_torch.tools.serve_report ff_trace.jsonl -o report.md
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional

from .trace_report import parse_trace, percentile

_LAT_ROWS = (  # (label, key into serve_request_done attrs)
    ("queue wait", "queue_wait_s"),
    ("TTFT", "ttft_s"),
    ("TPOT", "tpot_s"),
    ("end-to-end", "e2e_s"),
)


def _lat_line(label: str, vals: List[float]) -> str:
    vals = sorted(vals)
    mean = sum(vals) / len(vals)
    cells = [f"{percentile(vals, q) * 1e3:.1f}" for q in (50, 95, 99)]
    return (f"| {label} | {len(vals)} | " + " | ".join(cells)
            + f" | {mean * 1e3:.1f} | {vals[-1] * 1e3:.1f} |")


def render_report(records: List[Dict[str, Any]],
                  occupancy_windows: int = 12) -> str:
    meta: Dict[str, Any] = {}
    done_events: List[Dict[str, Any]] = []
    occ: List[tuple] = []          # (ts, active)
    admits: List[float] = []       # serve_prefill span start times
    ends: List[float] = []         # serve_decode span end times
    counters: Dict[str, float] = {}
    pool_events: List[Dict[str, Any]] = []   # replica pool lifecycle
    occ_by_rep: Dict[str, List[float]] = {}  # replica -> gauge values
    kv_used: List[float] = []                # serve_kv_blocks_used gauge
    window_mix: Dict[int, float] = {}        # decode window -> steps
    _POOL_EVENTS = ("replica_down", "replica_restart", "request_failover",
                    "request_hedged", "request_shed", "pool_drain")
    _FLEET_EVENTS = ("scale_event", "zone_down", "replica_added",
                     "replica_retired", "replica_add_failed")
    fleet_events: List[Dict[str, Any]] = []  # autoscaler/zone lifecycle
    ready_tl: List[tuple] = []               # (ts, pool_ready_replicas)
    zone_ready: Dict[str, List[tuple]] = {}  # zone -> (ts, ready)
    occ_by_zone: Dict[str, List[float]] = {}  # zone -> gauge values
    _TRACE_SPANS = ("serve_request", "serve_attempt", "serve_queue_wait",
                    "serve_prefill", "serve_decode", "serve_decode_chunk")
    trace_spans: Dict[str, List[dict]] = {}   # trace_id -> its spans
    trace_narr: Dict[str, List[dict]] = {}    # trace_id -> failover/hedge
    for r in records:
        t, name = r.get("t"), r.get("name")
        tid = (r.get("attrs") or {}).get("trace_id")
        if tid:
            if t == "span" and name in _TRACE_SPANS:
                trace_spans.setdefault(tid, []).append(r)
            elif t == "event" and name in ("request_failover",
                                           "request_hedged"):
                trace_narr.setdefault(tid, []).append(r)
        if t == "meta":
            meta = r
        elif t == "event" and name == "serve_request_done":
            done_events.append(r)
        elif t == "event" and name in _POOL_EVENTS:
            pool_events.append(r)
        elif t == "event" and name in _FLEET_EVENTS:
            fleet_events.append(r)
        elif t == "gauge" and name == "pool_ready_replicas":
            ready_tl.append((float(r.get("ts", 0.0)),
                             float(r.get("v", 0.0))))
        elif t == "gauge" and name == "pool_zone_ready":
            z = r.get("attrs", {}).get("zone")
            if z:
                zone_ready.setdefault(z, []).append(
                    (float(r.get("ts", 0.0)), float(r.get("v", 0.0))))
        elif t == "gauge" and name == "serve_batch_occupancy":
            v = float(r.get("v", 0.0))
            occ.append((float(r.get("ts", 0.0)), v))
            a = r.get("attrs", {})
            rep = a.get("replica")
            if rep:
                occ_by_rep.setdefault(rep, []).append(v)
            z = a.get("zone")
            if z:
                occ_by_zone.setdefault(z, []).append(v)
        elif t == "span" and name == "serve_prefill":
            admits.append(float(r.get("ts", 0.0)))
        elif t == "span" and name == "serve_decode":
            ends.append(float(r.get("ts", 0.0)) + float(r.get("dur", 0.0)))
        elif t == "gauge" and name == "serve_kv_blocks_used":
            kv_used.append(float(r.get("v", 0.0)))
        elif t == "counter" and name == "serve_decode_window":
            w = int(r.get("attrs", {}).get("window", 0))
            window_mix[w] = window_mix.get(w, 0.0) + float(r.get("v", 1.0))
        elif t == "counter" and name and name.startswith("serve_"):
            counters[name] = r.get("total", r.get("v", 0.0))

    lines = ["# flexflow_tpu serving report", ""]
    if meta:
        lines += [f"run `{meta.get('run_id', '?')}` · pid "
                  f"{meta.get('pid', '?')} · {len(records)} records", ""]
    if not done_events and not occ:
        lines += ["_(no serving records in trace — was the engine run "
                  "with telemetry enabled?)_", ""]
        return "\n".join(lines)

    # ---- requests -----------------------------------------------------
    by_status: Dict[str, int] = {}
    prompt_toks = gen_toks = 0
    for e in done_events:
        a = e.get("attrs", {})
        by_status[a.get("status", "?")] = \
            by_status.get(a.get("status", "?"), 0) + 1
        prompt_toks += int(a.get("prompt_len", 0))
        if a.get("status") == "done":
            gen_toks += int(a.get("new_tokens", 0))
    lines += ["## Requests", "",
              "| status | count |", "|---|---|"]
    for status in sorted(by_status):
        lines.append(f"| {status} | {by_status[status]} |")
    lines += ["",
              f"- prompt tokens in: {prompt_toks} · tokens generated "
              f"(completed): {gen_toks}", ""]

    # ---- latency ------------------------------------------------------
    series: Dict[str, List[float]] = {k: [] for _, k in _LAT_ROWS}
    for e in done_events:
        a = e.get("attrs", {})
        for _, key in _LAT_ROWS:
            if key == "e2e_s":
                continue
            if a.get(key) is not None:
                series[key].append(float(a[key]))
        if a.get("ttft_s") is not None:
            tp = float(a.get("tpot_s") or 0.0)
            series["e2e_s"].append(
                float(a["ttft_s"]) + tp * max(0, int(a.get("new_tokens", 1)) - 1))
    rows = [(lbl, series[key]) for lbl, key in _LAT_ROWS if series[key]]
    if rows:
        lines += ["## Latency (ms)", "",
                  "| metric | n | p50 | p95 | p99 | mean | max |",
                  "|---|---|---|---|---|---|---|"]
        lines += [_lat_line(lbl, vals) for lbl, vals in rows]
        lines.append("")

    # ---- throughput ---------------------------------------------------
    if admits and ends:
        wall = max(ends) - min(admits)
        lines += ["## Throughput", ""]
        if wall > 0 and gen_toks:
            lines.append(f"- {gen_toks} tokens in {wall:.3f}s serving "
                         f"window -> {gen_toks / wall:.1f} tokens/s")
        n_done = by_status.get("done", 0)
        if wall > 0 and n_done:
            lines.append(f"- {n_done / wall:.2f} completed requests/s")
        for name in sorted(counters):
            lines.append(f"- counter {name}: {counters[name]:g}")
        lines.append("")

    # ---- batch occupancy ----------------------------------------------
    if occ:
        vals = [v for _, v in occ]
        mean = sum(vals) / len(vals)
        lines += ["## Batch occupancy", "",
                  f"- mean {mean:.2f} active slots over {len(occ)} token "
                  f"boundaries (max {max(vals):g})", ""]
        t0, t1 = occ[0][0], occ[-1][0]
        if t1 > t0 and len(occ) > 1:
            width = (t1 - t0) / occupancy_windows
            lines += ["| window | mean active | |", "|---|---|---|"]
            for w in range(occupancy_windows):
                lo = t0 + w * width
                hi = lo + width if w < occupancy_windows - 1 else t1 + 1e-9
                wv = [v for ts, v in occ if lo <= ts < hi]
                if not wv:
                    continue
                m = sum(wv) / len(wv)
                bar = "#" * max(1, round(m * 2))
                lines.append(f"| {lo:.2f}-{hi:.2f}s | {m:.2f} | `{bar}` |")
            lines.append("")

    # ---- paged KV cache -----------------------------------------------
    if kv_used or window_mix or "serve_prefix_hits" in counters \
            or "serve_prefix_misses" in counters:
        lines += ["## KV cache", ""]
        if kv_used:
            steady = sorted(kv_used)[len(kv_used) // 2]
            lines.append(f"- block occupancy: peak {max(kv_used):g} · "
                         f"median {steady:g} over {len(kv_used)} token "
                         f"boundaries")
        hits = counters.get("serve_prefix_hits", 0.0)
        misses = counters.get("serve_prefix_misses", 0.0)
        if hits or misses:
            rate = hits / (hits + misses) if hits + misses else 0.0
            lines.append(f"- prefix cache: {hits:g} hits / {misses:g} "
                         f"misses ({rate:.0%} hit rate) · "
                         f"{counters.get('serve_prefill_tokens_saved', 0):g}"
                         f" prefill tokens skipped")
        if window_mix:
            total = sum(window_mix.values())
            lines += ["", "| decode window (positions) | steps | share |",
                      "|---|---|---|"]
            for w in sorted(window_mix):
                n = window_mix[w]
                lines.append(f"| {w} | {n:g} | {n / total:.0%} |")
        lines.append("")

    # ---- replicas (pool runs only) ------------------------------------
    if occ_by_rep or pool_events:
        def _pool_count(name: str, rep: Optional[str] = None,
                        key: str = "replica") -> int:
            return sum(1 for e in pool_events
                       if e.get("name") == name
                       and (rep is None
                            or e.get("attrs", {}).get(key) == rep))

        done_by_rep: Dict[str, Dict[str, int]] = {}
        for e in done_events:
            a = e.get("attrs", {})
            rep = a.get("replica")
            if not rep:
                continue
            d = done_by_rep.setdefault(rep, {"done": 0, "other": 0})
            d["done" if a.get("status") == "done" else "other"] += 1
        reps = sorted(set(occ_by_rep) | set(done_by_rep)
                      | {e.get("attrs", {}).get("replica")
                         for e in pool_events
                         if e.get("attrs", {}).get("replica")})
        lines += ["## Replicas", "",
                  "| replica | boundaries | mean occupancy | done | "
                  "failed | downs | restarts | failovers off |",
                  "|---|---|---|---|---|---|---|---|"]
        for rep in reps:
            ov = occ_by_rep.get(rep, [])
            d = done_by_rep.get(rep, {"done": 0, "other": 0})
            mean_o = sum(ov) / len(ov) if ov else 0.0
            lines.append(
                f"| {rep} | {len(ov)} | {mean_o:.2f} | {d['done']} | "
                f"{d['other']} | {_pool_count('replica_down', rep)} | "
                f"{_pool_count('replica_restart', rep)} | "
                f"{_pool_count('request_failover', rep, 'from_replica')} |")
        lines.append("")
        shed = _pool_count("request_shed")
        hedged = _pool_count("request_hedged")
        fo = _pool_count("request_failover")
        lines.append(f"- shed {shed} · hedged {hedged} · failovers {fo}")
        drains = [e for e in pool_events if e.get("name") == "pool_drain"]
        for e in drains:
            a = e.get("attrs", {})
            lines.append(f"- pool drained at t={float(e.get('ts', 0)):.2f}s"
                         f" ({a.get('reason', '?')}; "
                         f"{a.get('inflight', 0)} in flight, "
                         f"{a.get('queued', 0)} queued)")
        lines.append("")

    # ---- fleet (pool + autoscaler runs) -------------------------------
    if ready_tl or fleet_events:
        lines += ["## Fleet", ""]
        if ready_tl:
            vals = [v for _, v in ready_tl]
            lines.append(f"- ready replicas: start {vals[0]:g} · "
                         f"min {min(vals):g} · max {max(vals):g} · "
                         f"end {vals[-1]:g} "
                         f"({len(ready_tl)} transitions)")
            for z in sorted(zone_ready):
                zv = [v for _, v in zone_ready[z]]
                lines.append(f"- zone `{z}` ready: min {min(zv):g} · "
                             f"max {max(zv):g} · end {zv[-1]:g}")
            lines.append("")
            shown = ready_tl[:20]
            lines += ["| t (s) | ready | |", "|---|---|---|"]
            for ts, v in shown:
                bar = "#" * max(1, int(v))
                lines.append(f"| {ts:.2f} | {v:g} | `{bar}` |")
            if len(ready_tl) > len(shown):
                lines.append(f"| ... | ({len(ready_tl) - len(shown)} "
                             "more) | |")
            lines.append("")
        churn = {n: sum(1 for e in fleet_events if e.get("name") == n)
                 for n in ("scale_event", "zone_down", "replica_added",
                           "replica_retired", "replica_add_failed")}
        if any(churn.values()):
            lines.append(
                f"- {churn['scale_event']} scale events · "
                f"{churn['replica_added']} added / "
                f"{churn['replica_retired']} retired"
                + (f" / {churn['replica_add_failed']} add-failed"
                   if churn["replica_add_failed"] else "")
                + (f" · {churn['zone_down']} zone outage"
                   f"{'s' if churn['zone_down'] != 1 else ''}"
                   if churn["zone_down"] else ""))
            lines.append("")
        for e in sorted(fleet_events,
                        key=lambda e: float(e.get("ts", 0.0)))[:30]:
            a = e.get("attrs", {})
            ts = float(e.get("ts", 0.0))
            n = e.get("name")
            if n == "scale_event":
                lines.append(
                    f"- t={ts:.2f}s scale {a.get('direction', '?')} -> "
                    f"`{a.get('replica', '?')}` "
                    f"({a.get('reason', '?')}; ready "
                    f"{a.get('ready_before', '?')}->"
                    f"{a.get('ready_after', '?')}, "
                    f"queued {a.get('queued', '?')})")
            elif n == "zone_down":
                lines.append(
                    f"- t={ts:.2f}s **zone `{a.get('zone', '?')}` DOWN** "
                    f"(replicas: "
                    f"{', '.join(a.get('replicas', []) or ['?'])})")
            elif n == "replica_add_failed":
                lines.append(f"- t={ts:.2f}s replica add FAILED "
                             f"({a.get('error', '?')})")
            else:
                verb = "added" if n == "replica_added" else "retired"
                lines.append(f"- t={ts:.2f}s replica "
                             f"`{a.get('replica', '?')}` {verb}"
                             + (f" (zone `{a['zone']}`)"
                                if a.get("zone") else ""))
        if fleet_events:
            lines.append("")
        if occ_by_zone:
            lines += ["| zone | boundaries | mean occupancy |",
                      "|---|---|---|"]
            for z in sorted(occ_by_zone):
                zv = occ_by_zone[z]
                lines.append(f"| {z} | {len(zv)} | "
                             f"{sum(zv) / len(zv):.2f} |")
            lines.append("")

    # ---- slow requests (traced runs) ----------------------------------
    done_by_trace: Dict[str, List[dict]] = {}
    for e in done_events:
        tid = e.get("attrs", {}).get("trace_id")
        if tid:
            done_by_trace.setdefault(tid, []).append(e)
    if done_by_trace:
        def _e2e(e: dict) -> float:
            a = e.get("attrs", {})
            if a.get("ttft_s") is None:   # shed/timed out before a token
                return float(a.get("queue_wait_s") or 0.0)
            return (float(a["ttft_s"]) + float(a.get("tpot_s") or 0.0)
                    * max(0, int(a.get("new_tokens", 1)) - 1))

        ranked = sorted(done_by_trace.items(),
                        key=lambda kv: -max(_e2e(e) for e in kv[1]))[:5]
        lines += ["## Slow requests", "",
                  "Top traces by end-to-end latency.  Sampled requests "
                  "(FF_TRACE_SAMPLE) carry the full per-attempt "
                  "waterfall; `tools/timeline_export.py` renders the "
                  "same spans as a Perfetto timeline.", ""]
        for rank, (tid, dones) in enumerate(ranked, 1):
            worst = max(dones, key=_e2e)
            a = worst.get("attrs", {})
            rid = str(a.get("request_id", "?")).split("#")[0]
            statuses = ",".join(sorted({d.get("attrs", {})
                                        .get("status", "?")
                                        for d in dones}))
            lines.append(
                f"### {rank}. trace `{str(tid)[:8]}` · `{rid}` · "
                f"{statuses} · {_e2e(worst) * 1e3:.1f} ms "
                f"({len(dones)} attempt{'s' if len(dones) != 1 else ''})")
            spans = sorted(trace_spans.get(tid, []),
                           key=lambda s: float(s.get("ts", 0.0)))
            if spans:
                t0 = min(float(s.get("ts", 0.0)) for s in spans)
                lines += ["", "| attempt | phase | start ms | dur ms |",
                          "|---|---|---|---|"]
                for s in spans:
                    sa = s.get("attrs", {})
                    srid = str(sa.get("request_id", ""))
                    att = srid.rsplit("#", 1)[1] if "#" in srid else "-"
                    ph = str(s.get("name", "?")).replace("serve_", "", 1)
                    if ph == "decode_chunk":
                        ph = (f"decode {sa.get('token_from', '?')}-"
                              f"{sa.get('token_to', '?')}")
                    lines.append(
                        f"| {att} | {ph} | "
                        f"{(float(s.get('ts', 0.0)) - t0) * 1e3:.1f} | "
                        f"{float(s.get('dur', 0.0)) * 1e3:.1f} |")
            for ev in sorted(trace_narr.get(tid, []),
                             key=lambda e: float(e.get("ts", 0.0))):
                ea = ev.get("attrs", {})
                ts = float(ev.get("ts", 0.0))
                if ev.get("name") == "request_failover":
                    lines.append(
                        f"- failover off `{ea.get('from_replica', '?')}`"
                        f" at t={ts:.2f}s -> attempt "
                        f"`{ea.get('attempt', '?')}` "
                        f"({ea.get('reason', '?')})")
                else:
                    lines.append(
                        f"- hedged at t={ts:.2f}s after "
                        f"{ea.get('age_ms', '?')}ms -> attempt "
                        f"`{ea.get('hedge_attempt', '?')}`")
            lines.append("")

    # ---- failures -----------------------------------------------------
    bad = [e for e in done_events
           if e.get("attrs", {}).get("status") != "done"]
    if bad:
        lines += ["## Failures", ""]
        for e in bad:
            a = e.get("attrs", {})
            lines.append(f"- `{a.get('request_id', '?')}`: "
                         f"{a.get('status', '?')} "
                         f"(t={float(e.get('ts', 0.0)):.2f}s)")
        lines.append("")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(
        description="Fold a flexflow_tpu serving trace into a markdown "
                    "latency/occupancy report.")
    p.add_argument("trace", help="path to the JSONL trace "
                                 "(FF_TELEMETRY_FILE / ff_trace.jsonl)")
    p.add_argument("-o", "--out", default=None,
                   help="write report to this file instead of stdout")
    p.add_argument("--windows", type=int, default=12,
                   help="occupancy timeline buckets (default 12)")
    args = p.parse_args(argv)

    records = parse_trace(args.trace)
    report = render_report(records, occupancy_windows=args.windows)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report)
        print(f"{len(records)} records -> {args.out}")
    else:
        sys.stdout.write(report)
    return report


if __name__ == "__main__":
    main()
