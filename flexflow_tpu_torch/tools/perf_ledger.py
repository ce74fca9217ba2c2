"""Continuous perf ledger: an append-only JSONL trajectory of benchmark
and calibration results (PyTorch port of ``flexflow_tpu/tools/
perf_ledger.py``, stdlib only).

Each measured-ok entry is compared with the previous entry of its
``(metric, backend, proxy, batch, model)`` group, and ``report`` flags a
drop by more than the threshold (default 10%).  Appends are
crash-tolerant: if a previous writer died mid-line, the next append starts
on a fresh line, and readers skip lines that do not parse.

The port's ledger is a file of its own, ``perf_ledger_torch.jsonl`` at the
repo root (git-ignored), or ``FF_TORCH_PERF_LEDGER``; it never writes the
JAX package's ledger.  ``tools/search_bench.py`` appends its search
throughput and quality entries here, stamped ``backend: "cpu"`` (host
metrics); a card's measurement is ``backend: "cuda"``, and only those
count as the last good card number.

Entry fields (``schema`` 1):
    kind        "bench" | "calibration"
    unix_time   seconds since epoch (stamped at append if absent)
    commit      short git rev at append time (None outside a checkout)
    metric, value, unit, mfu, batch      what was measured
    backend     "cuda" | "cpu"
    proxy       true when the value is a CPU stand-in, not a card's number
    status      "ok" | "killed" | "error"
    stranded_phase, error, provenance    how/where a bad run died

CLI::

    python -m flexflow_tpu_torch.tools.perf_ledger report [--ledger P] [-o OUT]
    python -m flexflow_tpu_torch.tools.perf_ledger append --json '{...}'
    python -m flexflow_tpu_torch.tools.perf_ledger last-good
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

SCHEMA_VERSION = 1
LEDGER_BASENAME = "perf_ledger_torch.jsonl"
REGRESSION_THRESHOLD = 0.10


def repo_root() -> str:
    # tools/ -> flexflow_tpu_torch/ -> repo root
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_path() -> str:
    return os.environ.get("FF_TORCH_PERF_LEDGER") or os.path.join(
        repo_root(), LEDGER_BASENAME)


def git_commit() -> Optional[str]:
    try:
        r = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                           capture_output=True, text=True, timeout=5,
                           cwd=repo_root())
        if r.returncode != 0:
            return None
        return r.stdout.strip() or None
    except Exception:  # noqa: BLE001 — ledger writes must never kill a bench
        return None


def append_entry(entry: Dict, path: Optional[str] = None) -> Dict:
    """Append one entry, stamping schema/unix_time/commit when absent.

    Returns the stamped entry.  Raises OSError only for unwritable
    paths — callers on a dying-process path should wrap in try/except.
    """
    path = path or default_path()
    entry = dict(entry)
    entry.setdefault("schema", SCHEMA_VERSION)
    entry.setdefault("unix_time", round(time.time(), 3))
    entry.setdefault("commit", git_commit())
    # If a previous writer was killed mid-line, start fresh: a leading
    # newline costs one blank line; a glued-on half record costs the
    # whole tail of the file to naive parsers.
    prefix = b""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            if f.tell() > 0:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    prefix = b"\n"
    except OSError:
        pass  # no file yet
    with open(path, "ab") as f:
        f.write(prefix + (json.dumps(entry) + "\n").encode("utf-8"))
        f.flush()
        os.fsync(f.fileno())
    return entry


def read_entries(path: Optional[str] = None) -> List[Dict]:
    """All parseable entries, in file order.  Corrupt lines are skipped."""
    path = path or default_path()
    out: List[Dict] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


def _is_bench(e: Dict) -> bool:
    return e.get("kind", "bench") == "bench"


def measured_ok(e: Dict) -> bool:
    """A real (non-proxy) card measurement that completed with a value.
    Backend-gated to "cuda": host-side metrics like search_throughput are
    real (proxy: false) but never the "last good card number"."""
    return (_is_bench(e) and e.get("status") == "ok"
            and not e.get("proxy") and (e.get("value") or 0) > 0
            and e.get("backend", "cuda") == "cuda")


def last_good(entries: Optional[List[Dict]] = None,
              path: Optional[str] = None,
              metric: Optional[str] = None) -> Optional[Dict]:
    """The most recent measured-ok entry (optionally for one metric)."""
    if entries is None:
        entries = read_entries(path)
    for e in reversed(entries):
        if measured_ok(e) and (metric is None or e.get("metric") == metric):
            return e
    return None


def _group_key(e: Dict) -> Tuple:
    # Entries are only comparable within the same metric/backend/mode and
    # benchmark config: a batch-256 number dropping below a batch-1024
    # number is a config change, not a regression — and neither is a
    # transformer search_quality ratio sitting below a DLRM one, so the
    # benchmarked model (when provenance names one) splits groups too.
    prov = e.get("provenance") or {}
    return (e.get("metric"), e.get("backend"), bool(e.get("proxy")),
            e.get("batch", prov.get("batch")), prov.get("model"))


def detect_regressions(entries: List[Dict],
                       threshold: float = REGRESSION_THRESHOLD) -> List[Dict]:
    """Flag each ok entry that drops > threshold vs the previous ok entry
    in its group.  Killed/error/zero-value entries never participate —
    a watchdog kill is an availability event, not a 100% perf loss."""
    prev: Dict[Tuple, Dict] = {}
    out: List[Dict] = []
    for e in entries:
        if not _is_bench(e) or e.get("status") != "ok":
            continue
        v = e.get("value") or 0
        if v <= 0:
            continue
        k = _group_key(e)
        p = prev.get(k)
        if p and v < p["value"] * (1.0 - threshold):
            out.append({"metric": k[0], "backend": k[1], "proxy": k[2],
                        "batch": k[3],
                        "prev_value": p["value"], "value": v,
                        "drop_frac": round(1.0 - v / p["value"], 4),
                        "prev_commit": p.get("commit"),
                        "commit": e.get("commit"),
                        "unix_time": e.get("unix_time")})
        prev[k] = e
    return out


def _when(e: Dict) -> str:
    t = e.get("unix_time")
    if not t:
        return "?"
    return time.strftime("%Y-%m-%d %H:%M", time.gmtime(t))


def _age_days(e: Dict, now: Optional[float] = None) -> Optional[float]:
    t = e.get("unix_time")
    if not t:
        return None
    return round(((now if now is not None else time.time()) - t) / 86400.0, 1)


def render_report(entries: List[Dict],
                  threshold: float = REGRESSION_THRESHOLD,
                  path: str = "") -> str:
    bench = [e for e in entries if _is_bench(e)]
    calib = [e for e in entries if e.get("kind") == "calibration"]
    regressions = detect_regressions(entries, threshold)
    reg_times = {r.get("unix_time") for r in regressions}
    lg = last_good(entries)

    lines = [f"# Perf ledger — {path or default_path()}", ""]
    n_ok = sum(1 for e in bench if measured_ok(e))
    n_proxy = sum(1 for e in bench if e.get("proxy"))
    head = (f"{len(entries)} entries · {n_ok} measured-ok · "
            f"{n_proxy} proxy · {len(calib)} calibration session(s)")
    if lg:
        age = _age_days(lg)
        head += (f" · last good: {lg['value']:.2f} {lg.get('unit', '')}"
                 f" @ {lg.get('commit') or '?'}"
                 + (f" ({age}d ago)" if age is not None else ""))
    else:
        head += " · last good: none"
    lines += [head, ""]

    if bench:
        lines += ["## Trajectory", "",
                  "| when (UTC) | backend | proxy | batch | value | unit "
                  "| mfu | status | commit | Δ vs prev |",
                  "|---|---|---|---|---|---|---|---|---|---|"]
        prev: Dict[Tuple, Dict] = {}
        for e in bench:
            k = _group_key(e)
            delta = ""
            v = e.get("value") or 0
            if e.get("status") == "ok" and v > 0:
                p = prev.get(k)
                if p:
                    delta = f"{(v / p['value'] - 1.0) * 100:+.1f}%"
                    if e.get("unix_time") in reg_times:
                        delta += " **REGRESSION**"
                prev[k] = e
            mfu = e.get("mfu")
            lines.append(
                "| {} | {} | {} | {} | {} | {} | {} | {} | {} | {} |".format(
                    _when(e), e.get("backend") or "?",
                    "yes" if e.get("proxy") else "no",
                    e.get("batch", (e.get("provenance") or {}).get("batch",
                                                                   "")) or "",
                    f"{v:.2f}" if v else "0",
                    e.get("unit") or "", f"{mfu:.3f}" if mfu else "",
                    e.get("status") or "?", e.get("commit") or "",
                    delta))
        lines.append("")

    lines.append(f"## Regressions (threshold {threshold * 100:.0f}%)")
    lines.append("")
    if regressions:
        for r in regressions:
            lines.append(
                "- {} [{}{}]: {:.2f} -> {:.2f} ({:+.1f}%) at {}".format(
                    r["metric"], r["backend"],
                    ", proxy" if r["proxy"] else "",
                    r["prev_value"], r["value"], -r["drop_frac"] * 100,
                    r.get("commit") or "?"))
    else:
        lines.append("- none detected")
    lines.append("")

    if calib:
        lines += ["## Calibration sessions", "",
                  "| when (UTC) | platform | entries | fit points "
                  "| fit log-RMSE | commit |",
                  "|---|---|---|---|---|---|"]
        for e in calib:
            rmse = e.get("fit_log_rmse")
            lines.append("| {} | {} | {} | {} | {} | {} |".format(
                _when(e), e.get("backend") or e.get("platform") or "?",
                e.get("entries", ""), e.get("fit_points", ""),
                f"{rmse:.4f}" if isinstance(rmse, (int, float)) else "",
                e.get("commit") or ""))
        lines.append("")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd")
    rp = sub.add_parser("report", help="render the trajectory report")
    rp.add_argument("--ledger", default=None)
    rp.add_argument("--threshold", type=float, default=REGRESSION_THRESHOLD)
    rp.add_argument("-o", "--out", default=None)
    ap = sub.add_parser("append", help="append one entry (JSON object)")
    ap.add_argument("--json", required=True)
    ap.add_argument("--ledger", default=None)
    lp = sub.add_parser("last-good",
                        help="print the last measured-ok entry (rc 1 if none)")
    lp.add_argument("--ledger", default=None)
    lp.add_argument("--metric", default=None)
    args = p.parse_args(argv)

    cmd = args.cmd or "report"
    if cmd == "append":
        obj = json.loads(args.json)
        if not isinstance(obj, dict):
            p.error("--json must be a JSON object")
        print(json.dumps(append_entry(obj, path=args.ledger)))
        return 0
    if cmd == "last-good":
        lg = last_good(path=args.ledger, metric=args.metric)
        if lg is None:
            return 1
        print(json.dumps(lg))
        return 0
    ledger = getattr(args, "ledger", None) or default_path()
    report = render_report(read_entries(ledger),
                           threshold=getattr(args, "threshold",
                                             REGRESSION_THRESHOLD),
                           path=ledger)
    out = getattr(args, "out", None)
    if out:
        with open(out, "w", encoding="utf-8") as f:
            f.write(report + "\n")
        print(f"wrote {out}")
    else:
        print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
