"""Explain a strategy search: fold a search trace into a markdown report,
or diff two strategy ``.pb`` files via their provenance sidecars.

The MCMC search is the paper's core mechanism, but its output — a
``.pb`` mapping op names to parallel configs — says nothing about HOW it
chose.  ``observability/searchtrace.py`` records the search itself
(``search_start`` / ``search_candidate`` / ``search_op_summary`` /
``search_summary`` events); this CLI folds that trace into the questions
an operator actually asks:

  * did the search converge, or was the budget too small? (best-cost
    curve, windowed acceptance rate, plateau detection)
  * which ops did the search improve most?
  * WHY this config for each op — what was the best rejected
    alternative, and how much worse was it?

``--diff a.pb b.pb`` compares two strategies instead: which ops changed
and — when ``.meta.json`` provenance sidecars are present — the
simulated per-op and total cost impact.  A missing/corrupt/stale sidecar
degrades the diff to config-only, never fails it.

A copy of the JAX package's ``tools/search_report.py`` (stdlib only, so
the port imports nothing of that package); its reports are the same, word
for word.  It embeds a minimal strategy-``.pb`` reader instead of
importing the package's codec, so a trace or a swap record
(runtime/reconfigure.py's ``swap_NNN_{old,new}.pb``) is explainable on
any machine.

Usage:
    python -m flexflow_tpu_torch.tools.search_report ff_trace.jsonl
    python -m flexflow_tpu_torch.tools.search_report ff_trace.jsonl -o report.md
    python -m flexflow_tpu_torch.tools.search_report --diff old.pb new.pb
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple


def parse_trace(path: str) -> List[Dict[str, Any]]:
    """Load JSONL records, skipping blank/corrupt lines (a watchdog kill
    can truncate the final line mid-write)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


# ----------------------------------------------------------------------
# minimal strategy-.pb reader (wire-compatible subset of
# parallel/strategy.py — kept dependency-free on purpose)
# ----------------------------------------------------------------------

def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _decode_op(data: bytes) -> Tuple[str, Dict[str, Any]]:
    pos = 0
    name = ""
    dims: List[int] = []
    ids: List[int] = []
    host = False
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:  # varint
            val, pos = _read_varint(data, pos)
            if field == 3:
                dims.append(val)
            elif field == 4:
                ids.append(val)
            elif field == 5 and val == 1:
                host = True
            elif field == 2 and val == 1:  # CPU device type
                host = True  # mirrors ParallelConfig.host_placed
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(data, pos)
            payload = data[pos:pos + ln]
            pos += ln
            if field == 1:
                name = payload.decode("utf-8")
            elif field in (3, 4, 5):  # packed repeated ints
                p = 0
                while p < len(payload):
                    v, p = _read_varint(payload, p)
                    if field == 3:
                        dims.append(v)
                    elif field == 4:
                        ids.append(v)
                    elif field == 5 and v == 1:
                        host = True
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return name, {"dims": dims or [1], "ids": ids, "host": host}


def read_strategy_pb(path: str) -> Dict[str, Dict[str, Any]]:
    """op name -> {dims, ids, host} from a strategy ``.pb``."""
    with open(path, "rb") as f:
        data = f.read()
    out: Dict[str, Dict[str, Any]] = {}
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire != 2:
            raise ValueError(f"malformed strategy file {path}")
        ln, pos = _read_varint(data, pos)
        payload = data[pos:pos + ln]
        pos += ln
        if field == 1:
            name, rec = _decode_op(payload)
            out[name] = rec
    return out


def config_str(rec: Dict[str, Any]) -> str:
    """Same compact rendering as ``searchtrace.pc_str`` so trace events
    and diff rows read identically."""
    dims = "x".join(str(d) for d in rec["dims"])
    if rec.get("host"):
        return f"host[{dims}]"
    ids = rec.get("ids") or []
    if ids and ids[0] != 0:
        return f"{dims}@{ids[0]}"
    return dims


def read_sidecar(pb_path: str) -> Tuple[Optional[Dict[str, Any]], str]:
    """(metadata, status) for ``<pb_path>.meta.json``; status is one of
    ok / stale (content hash no longer matches the .pb) / corrupt /
    missing.  Never raises — sidecars are advisory."""
    path = pb_path + ".meta.json"
    if not os.path.exists(path):
        return None, "missing"
    try:
        with open(path) as f:
            meta = json.load(f)
        if not isinstance(meta, dict):
            raise ValueError("not a JSON object")
    except Exception:  # noqa: BLE001 — advisory metadata only
        return None, "corrupt"
    try:
        with open(pb_path, "rb") as f:
            digest = "sha256:" + hashlib.sha256(f.read()).hexdigest()
        status = "ok" if meta.get("content_hash") == digest else "stale"
    except OSError:
        status = "stale"
    return meta, status


# ----------------------------------------------------------------------
# trace mode
# ----------------------------------------------------------------------

def _ms(v: Any) -> str:
    return "?" if v is None else f"{float(v):.3f}"


def _op_ms(meta: Optional[Dict[str, Any]], op: str) -> Optional[float]:
    ops = (meta or {}).get("ops")
    if not isinstance(ops, dict) or op not in ops:
        return None
    row = ops[op]
    try:
        return float(row.get("fwd_ms", 0.0)) + float(row.get("bwd_ms", 0.0))
    except (TypeError, ValueError):
        return None


def _op_spec(meta: Optional[Dict[str, Any]], op: str) -> Optional[str]:
    """Resolved sharding spec for an op: the attribution row's ``spec``
    (stamped by every new sidecar), else the lowering plan's entry when
    the sidecar came from a lowered compile."""
    for section in ("ops", "lowering"):
        rows = (meta or {}).get(section)
        if isinstance(rows, dict) and isinstance(rows.get(op), dict):
            s = rows[op].get("spec")
            if isinstance(s, str):
                return s
    return None


def _engine_order(events: Dict[str, List[Dict[str, Any]]]) -> List[str]:
    order: List[str] = []
    for kind in ("search_start", "search_summary", "search_candidate"):
        for e in events.get(kind, []):
            eng = e.get("attrs", {}).get("engine", "?")
            if eng not in order:
                order.append(eng)
    return order


def _render_engine(engine: str, events: Dict[str, List[Dict[str, Any]]],
                   top_k: int) -> List[str]:
    def of(kind: str) -> List[Dict[str, Any]]:
        return [e.get("attrs", {}) for e in events.get(kind, [])
                if e.get("attrs", {}).get("engine") == engine]

    starts = of("search_start")
    summaries = of("search_summary")
    cands = of("search_candidate")
    opsums = of("search_op_summary")
    start = starts[0] if starts else {}
    summ = summaries[-1] if summaries else {}

    lines = [f"## Search: {engine}", ""]
    hdr = []
    for key, label in (("budget", "budget"), ("num_devices", "devices"),
                       ("seed", "seed"), ("candidates", "candidates")):
        v = summ.get(key, start.get(key))
        if v is not None:
            hdr.append(f"{label} {v}")
    if hdr:
        lines.append("- " + " · ".join(hdr))
    initial = summ.get("initial_ms", start.get("initial_ms"))
    best = summ.get("best_ms")
    if initial is not None and best is not None and float(initial) > 0:
        speedup = float(initial) / float(best) if float(best) > 0 \
            else float("inf")
        lines.append(f"- simulated step time: {_ms(initial)} ms -> "
                     f"{_ms(best)} ms ({speedup:.2f}x vs starting point)")
    elif best is not None:
        lines.append(f"- simulated step time: best {_ms(best)} ms")
    proposals = summ.get("proposals")
    if proposals:
        acc = summ.get("accepted", 0)
        lines.append(f"- proposals {proposals} · accepted {acc} "
                     f"({100.0 * acc / proposals:.0f}%)")
    pps = summ.get("proposals_per_s")
    if pps:
        sim_kind = ""
        if "delta" in summ:
            sim_kind = (" (delta simulation)" if summ["delta"]
                        else " (full re-simulation)")
        lines.append(f"- throughput {pps:g} proposals/s{sim_kind}")
    lines.append("")

    # -- convergence ----------------------------------------------------
    if cands:
        lines.append("### Convergence")
        lines.append("")
        n = len(cands)
        rows = min(8, n)
        lines.append("| iter | proposed op | best ms |")
        lines.append("|---|---|---|")
        for i in range(rows):
            c = cands[(i * (n - 1)) // (rows - 1)] if rows > 1 else cands[0]
            lines.append(f"| {c.get('iter', '?')} | {c.get('op', '?')} | "
                         f"{_ms(c.get('best_ms'))} |")
        lines.append("")
        # acceptance rate by quarter: a healthy anneal starts accepting
        # freely and cools; flat-high means alpha too low, flat-zero
        # means the walk is stuck.
        windows = []
        for w in range(4):
            chunk = cands[w * n // 4:(w + 1) * n // 4]
            if chunk:
                rate = sum(1 for c in chunk if c.get("accepted")) / len(chunk)
                windows.append(f"{100.0 * rate:.0f}%")
        if windows:
            lines.append("- acceptance rate by quarter: "
                         + " / ".join(windows))
        last_improve = summ.get("last_improve_iter")
        if last_improve is not None and proposals:
            tail = proposals - 1 - int(last_improve)
            if tail > max(10, proposals // 2):
                lines.append(f"- plateau: last improvement at iter "
                             f"{last_improve}; the final {tail} proposals "
                             f"found nothing better (budget could be "
                             f"smaller)")
            else:
                lines.append(f"- last improvement at iter {last_improve} "
                             f"of {proposals} — still improving late; a "
                             f"larger budget may help")
        lines.append("")
    elif engine == "native":
        lines.append("_(native engine: the C++ anneal owns its loop — "
                     "per-candidate events are not recorded; see the "
                     "per-op summaries below)_")
        lines.append("")

    # -- population engine: chains / exchanges / crossovers ---------------
    # These sections render ONLY when population events are present, so
    # single-chain reports stay byte-identical to what they were before
    # the population engine existed (golden-checked by the tests).
    chain_cands = [c for c in cands if c.get("chain") is not None]
    exchanges = of("search_exchange")
    crossovers = of("search_crossover")
    if chain_cands:
        by_chain: Dict[Any, List[Dict[str, Any]]] = {}
        for c in chain_cands:
            by_chain.setdefault(c["chain"], []).append(c)
        lines.append("### Per-chain convergence")
        lines.append("")
        lines.append("| chain | proposals | accepted | best ms |")
        lines.append("|---|---|---|---|")
        for ci in sorted(by_chain):
            cs = by_chain[ci]
            acc = [c for c in cs if c.get("accepted")]
            best_c = min((float(c["new_ms"]) for c in acc
                          if c.get("new_ms") is not None), default=None)
            lines.append(f"| {ci} | {len(cs)} | {len(acc)} "
                         f"({100.0 * len(acc) / len(cs):.0f}%) | "
                         f"{_ms(best_c) if best_c is not None else '—'} |")
        lines.append("")
    if exchanges:
        pairs: Dict[str, List[Dict[str, Any]]] = {}
        for e in exchanges:
            pairs.setdefault(f"{e.get('chain_a', '?')}<->"
                             f"{e.get('chain_b', '?')}", []).append(e)
        lines.append("### Replica exchange (by temperature pair)")
        lines.append("")
        lines.append("| pair | attempts | accepted |")
        lines.append("|---|---|---|")
        for pair in sorted(pairs):
            es = pairs[pair]
            acc = sum(1 for e in es if e.get("accepted"))
            lines.append(f"| {pair} | {len(es)} | {acc} "
                         f"({100.0 * acc / len(es):.0f}%) |")
        lines.append("")
    if crossovers:
        lines.append("### Crossover lineage")
        lines.append("")
        lines.append("| iter | parents | child chain | patches | "
                     "child ms | adopted |")
        lines.append("|---|---|---|---|---|---|")
        for e in crossovers:
            lines.append(f"| {e.get('iter', '?')} | "
                         f"{e.get('parent_a', '?')}+{e.get('parent_b', '?')}"
                         f" | {e.get('chain', '?')} | "
                         f"{e.get('patches', '?')} | "
                         f"{_ms(e.get('child_ms'))} | "
                         f"{'yes' if e.get('adopted') else ''} |")
        lines.append("")

    # -- most-improved ops ----------------------------------------------
    gains = [o for o in opsums if float(o.get("gain_ms") or 0.0) > 0.0
             and o.get("op") != "<pipeline>"]
    gains.sort(key=lambda o: -float(o.get("gain_ms") or 0.0))
    if gains:
        lines.append(f"### Most-improved ops (top {min(top_k, len(gains))})")
        lines.append("")
        lines.append("| op | gain ms | proposals | accepted |")
        lines.append("|---|---|---|---|")
        for o in gains[:top_k]:
            lines.append(f"| {o.get('op', '?')} | "
                         f"{_ms(o.get('gain_ms'))} | "
                         f"{o.get('proposals', 0)} | "
                         f"{o.get('accepted', 0)} |")
        lines.append("")

    # -- why this config -------------------------------------------------
    why = [o for o in opsums if o.get("op") != "<pipeline>"]
    if why:
        lines.append("## Why this config")
        lines.append("")
        lines.append("Final config per op, with the best REJECTED "
                     "alternative the search tried (and how much worse "
                     "it simulated than the final plan).")
        lines.append("")
        lines.append("| op | final | proposals | accepted | "
                     "best rejected alt | alt Δ ms |")
        lines.append("|---|---|---|---|---|---|")
        for o in why:
            alt = o.get("alt")
            alt_cell = f"{alt} ({_ms(o.get('alt_ms'))} ms)" if alt else "—"
            delta = o.get("alt_delta_ms")
            delta_cell = f"+{_ms(delta)}" if delta is not None else "—"
            lines.append(f"| {o.get('op', '?')} | {o.get('final', '?')} | "
                         f"{o.get('proposals', 0)} | "
                         f"{o.get('accepted', 0)} | {alt_cell} | "
                         f"{delta_cell} |")
        lines.append("")

    # -- pipeline plans ---------------------------------------------------
    plans = [c for c in cands if c.get("op") == "<pipeline>"]
    if plans:
        lines.append("### Pipeline plans")
        lines.append("")
        lines.append("| plan | cost ms | new best |")
        lines.append("|---|---|---|")
        for c in plans:
            lines.append(f"| {c.get('new', '?')} | {_ms(c.get('new_ms'))} | "
                         f"{'yes' if c.get('accepted') else ''} |")
        lines.append("")
    return lines


def render_search_report(records: List[Dict[str, Any]],
                         top_k: int = 10) -> str:
    events: Dict[str, List[Dict[str, Any]]] = {}
    for r in records:
        if r.get("t") == "event":
            events.setdefault(r.get("name", "?"), []).append(r)

    lines = ["# flexflow_tpu search report", ""]
    engines = _engine_order(events)
    for engine in engines:
        lines.extend(_render_engine(engine, events, top_k))

    prov = events.get("strategy_provenance", [])
    if prov:
        lines.append("## Strategy provenance")
        lines.append("")
        for e in prov:
            a = e.get("attrs", {})
            bits = [f"`{a.get('file', '?')}`",
                    f"provenance {a.get('provenance', '?')}"]
            for key in ("engine", "budget", "seed", "num_devices"):
                if key in a:
                    bits.append(f"{key} {a[key]}")
            if "best_ms" in a:
                bits.append(f"best {_ms(a['best_ms'])} ms")
            if "search_run_id" in a:
                bits.append(f"search run `{a['search_run_id']}`")
            lines.append("- " + " · ".join(bits))
        lines.append("")

    if not engines and not prov:
        lines.append("_(no search events in trace — run with "
                     "FF_TELEMETRY=1 and a search budget)_")
        lines.append("")
    return "\n".join(lines)


# ----------------------------------------------------------------------
# diff mode
# ----------------------------------------------------------------------

def render_diff(a_path: str, b_path: str) -> str:
    a = read_strategy_pb(a_path)
    b = read_strategy_pb(b_path)
    a_meta, a_status = read_sidecar(a_path)
    b_meta, b_status = read_sidecar(b_path)

    lines = ["# Strategy diff", "",
             f"`{a_path}` ({len(a)} ops) vs `{b_path}` ({len(b)} ops)", ""]
    for label, meta, status in (("a", a_meta, a_status),
                                ("b", b_meta, b_status)):
        if meta is None:
            lines.append(f"- {label} sidecar: {status} — no simulated "
                         f"costs for this side")
            continue
        bits = [f"{label} sidecar: {status}"]
        for key in ("engine", "budget", "seed", "num_devices", "model"):
            if key in meta:
                bits.append(f"{key} {meta[key]}")
        if "best_ms" in meta:
            bits.append(f"best {_ms(meta['best_ms'])} ms")
        if meta.get("lowered"):
            bits.append("lowered")
        lines.append("- " + " · ".join(bits))
    lines.append("")

    only_a = sorted(set(a) - set(b))
    only_b = sorted(set(b) - set(a))
    common = [k for k in a if k in b]
    changed = [k for k in common
               if config_str(a[k]) != config_str(b[k])]
    if only_a:
        lines.append(f"- ops only in a: {', '.join(only_a)}")
    if only_b:
        lines.append(f"- ops only in b: {', '.join(only_b)}")
    lines.append(f"- {len(changed)} changed / "
                 f"{len(common) - len(changed)} unchanged ops")
    lines.append("")

    if changed:
        lines.append("## Changed ops")
        lines.append("")
        lines.append("| op | a | b | a ms | b ms | Δ ms |")
        lines.append("|---|---|---|---|---|---|")
        total_a = total_b = 0.0
        priced = 0
        for op in changed:
            am = _op_ms(a_meta, op)
            bm = _op_ms(b_meta, op)
            if am is not None and bm is not None:
                total_a += am
                total_b += bm
                priced += 1
                delta = f"{bm - am:+.3f}"
            else:
                delta = "—"
            lines.append(f"| {op} | {config_str(a[op])} | "
                         f"{config_str(b[op])} | "
                         f"{_ms(am) if am is not None else '—'} | "
                         f"{_ms(bm) if bm is not None else '—'} | "
                         f"{delta} |")
        lines.append("")
        if priced:
            lines.append(f"- simulated per-op impact of the {priced} "
                         f"priced changed ops: {total_a:.3f} ms -> "
                         f"{total_b:.3f} ms ({total_b - total_a:+.3f} ms; "
                         f"per-op sums ignore overlap — totals below are "
                         f"the authority)")
        spec_rows = []
        for op in changed:
            sa, sb = _op_spec(a_meta, op), _op_spec(b_meta, op)
            if sa is not None or sb is not None:
                spec_rows.append((op, sa or "—", sb or "—"))
        if spec_rows:
            lines.append("")
            lines.append("## Sharding-spec changes (lowered mesh axes)")
            lines.append("")
            for op, sa, sb in spec_rows:
                lines.append(f"- {op}: `{sa}` -> `{sb}`")
    best_a = (a_meta or {}).get("best_ms")
    best_b = (b_meta or {}).get("best_ms")
    if best_a is not None and best_b is not None:
        lines.append(f"- simulated end-to-end step: {_ms(best_a)} ms (a) "
                     f"vs {_ms(best_b)} ms (b) "
                     f"({float(best_b) - float(best_a):+.3f} ms)")
    lines.append("")
    return "\n".join(lines)


# ----------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(
        description="Explain a flexflow_tpu strategy search (trace -> "
                    "markdown) or diff two strategy .pb files.")
    p.add_argument("trace", nargs="?", default=None,
                   help="JSONL search trace (FF_TELEMETRY_FILE)")
    p.add_argument("--diff", nargs=2, metavar=("A_PB", "B_PB"),
                   default=None,
                   help="compare two strategy .pb files (uses "
                        ".meta.json sidecars for cost impact when "
                        "present)")
    p.add_argument("-o", "--out", default=None,
                   help="write report to this file instead of stdout")
    p.add_argument("--top-k", type=int, default=10,
                   help="rows in the most-improved-ops table (default 10)")
    args = p.parse_args(argv)

    if args.trace is None and args.diff is None:
        p.error("nothing to do: pass a trace file and/or --diff a.pb b.pb")

    parts = []
    if args.trace is not None:
        parts.append(render_search_report(parse_trace(args.trace),
                                          top_k=args.top_k))
    if args.diff is not None:
        parts.append(render_diff(args.diff[0], args.diff[1]))
    report = "\n".join(parts)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report)
        print(f"report -> {args.out}")
    else:
        sys.stdout.write(report)
    return report


if __name__ == "__main__":
    main()
