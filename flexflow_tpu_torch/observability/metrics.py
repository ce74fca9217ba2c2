"""Live metrics plane: in-process aggregation + ``/metrics`` exporter.

The trace file (``events.py``) is post-hoc: nothing reads it until the
run exits.  This module is the LIVE half — a ``MetricsRegistry`` that
taps ``EventLog.add_observer`` and folds every record into counters,
gauges, and rolling-window histograms as it is written, plus a stdlib
HTTP server exposing them as Prometheus text format at ``/metrics`` and
expvar-style JSON at ``/debug/vars``.

A copy of the JAX package's ``observability/metrics.py``.  STDLIB-ONLY
on purpose, like ``events.py``: the serving ``api.py`` mounts the same
renderer without new dependencies, and ``render_backend`` reads only a
backend's ``stats()``.

Record folding:

  counter  -> per-(name, labels) running sum of deltas; at attach time
              the log's per-name ``totals`` seed the label-free series,
              so a registry attached mid-run still reports full totals
              (summing a name across its label sets == the log total)
  gauge    -> last value per (name, labels)
  span     -> rolling-window histogram of ``dur`` keyed by span name
              (p50/p95/p99 via the same linear-interpolation percentile
              as ``tools/trace_report.py``), plus monotonic count/sum
  event    -> ``ff_events_total{event="<name>"}``; ``serve_request_done``
              additionally feeds ``serve_ttft``/``serve_tpot`` histograms

Attrs become Prometheus labels only through an allowlist — request ids
and shapes would otherwise explode series cardinality.

Enablement: ``FF_METRICS_PORT=<port>`` starts the standalone exporter
(port 0 binds ephemerally; read ``server_port()``).  Unset, the module
is zero-cost: ``maybe_start()`` returns None without registering any
observer and the hot path never sees it (the established None-handle
pattern).  Scrapes are safe under concurrent writers: rendering
snapshots under the registry lock; observers already run outside the
EventLog lock.

Serving backends (``ReplicaPool``/``InferenceEngine``) additionally
register a *provider* — a callable rendering scrape-time series
(per-replica up/incarnation, queue depth) that have no event stream.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import events

# attr keys that may become Prometheus labels; everything else is
# dropped from the label set (NOT from the trace) to bound cardinality
LABEL_KEYS = ("device", "event", "kind", "op", "outcome", "phase", "reason",
              "replica", "scope", "site", "slo", "src", "status", "which",
              "window", "zone")

# histogram quantiles exposed on every summary series
QUANTILES = (50.0, 95.0, 99.0)

DEFAULT_WINDOW = 1024


def percentile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolation percentile on an already-sorted list (the
    same math as ``tools/trace_report.py`` — tests cross-check them)."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q / 100.0 * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def metrics_port_from_env() -> Optional[int]:
    """``FF_METRICS_PORT`` as an int port, None when unset/empty.
    Loud ``ValueError`` on garbage — a silently-ignored typo would
    leave an operator scraping nothing."""
    raw = os.environ.get("FF_METRICS_PORT", "")
    if raw == "":
        return None
    try:
        port = int(raw)
    except ValueError:
        raise ValueError(
            f"FF_METRICS_PORT={raw!r} is not an integer port") from None
    if not 0 <= port <= 65535:
        raise ValueError(
            f"FF_METRICS_PORT={port} is outside 0..65535")
    return port


def _san(name: str) -> str:
    """Sanitize to a Prometheus metric-name fragment."""
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _esc(v: Any) -> str:
    """Escape a label value per the text exposition format."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _labels(attrs: Optional[Dict[str, Any]]) -> Tuple[Tuple[str, str], ...]:
    if not attrs:
        return ()
    return tuple(sorted((k, str(attrs[k])) for k in attrs
                        if k in LABEL_KEYS))


def _label_str(labels: Tuple[Tuple[str, str], ...],
               extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = labels + extra
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in pairs) + "}"


class _Hist:
    """Rolling-window values for quantiles + monotonic count/sum."""

    __slots__ = ("window", "count", "total")

    def __init__(self, maxlen: int):
        self.window: deque = deque(maxlen=maxlen)
        self.count = 0
        self.total = 0.0

    def add(self, v: float) -> None:
        self.window.append(v)
        self.count += 1
        self.total += v

    def snapshot(self) -> Dict[str, float]:
        vals = sorted(self.window)
        out = {"count": self.count, "sum": round(self.total, 6)}
        for q in QUANTILES:
            out[f"p{q:g}"] = round(percentile(vals, q), 6)
        return out


class MetricsRegistry:
    """In-process aggregation of EventLog records.

    ``observe`` is the ``EventLog`` observer; it runs on whatever
    thread wrote the record (outside the log's lock), so every mutation
    holds the registry's own lock.  Rendering snapshots under the same
    lock — a scrape mid-burst sees a consistent point-in-time view.
    """

    def __init__(self, window: Optional[int] = None):
        if window is None:
            raw = os.environ.get("FF_METRICS_WINDOW", "")
            window = int(raw) if raw else DEFAULT_WINDOW
        self._window = max(8, int(window))
        self._lock = threading.Lock()
        # (name, labels) -> running sum / last value
        self._counters: Dict[Tuple[str, tuple], float] = {}
        self._gauges: Dict[Tuple[str, tuple], float] = {}
        # name -> _Hist (span durations + request-latency fields)
        self._hists: Dict[str, _Hist] = {}
        self._records_seen = 0

    # -- ingestion ------------------------------------------------------
    def attach(self, log: events.EventLog) -> None:
        """Register as an observer and seed counter totals accumulated
        before attach (``log.totals`` is per-name, label-free)."""
        with log._lock:
            seed = dict(log.totals)
        with self._lock:
            for name, total in seed.items():
                key = (name, ())
                self._counters[key] = self._counters.get(key, 0.0) + total
        log.add_observer(self.observe)

    def observe(self, rec: Dict[str, Any]) -> None:
        t = rec.get("t")
        name = rec.get("name", "?")
        attrs = rec.get("attrs")
        with self._lock:
            self._records_seen += 1
            if t == "counter":
                key = (name, _labels(attrs))
                self._counters[key] = (self._counters.get(key, 0.0)
                                       + float(rec.get("v", 0.0)))
            elif t == "gauge":
                self._gauges[(name, _labels(attrs))] = \
                    float(rec.get("v", 0.0))
            elif t == "span":
                self._hist(name).add(float(rec.get("dur", 0.0)))
            elif t == "event":
                key = ("events", (("event", name),))
                self._counters[key] = self._counters.get(key, 0.0) + 1.0
                if name == "serve_request_done" and attrs:
                    for field, series in (("ttft_s", "serve_ttft"),
                                          ("tpot_s", "serve_tpot")):
                        v = attrs.get(field)
                        if v is not None:
                            self._hist(series).add(float(v))
                elif name == "op_runtime" and attrs:
                    mm = attrs.get("measured_ms")
                    if mm is not None:
                        self._hist("op_runtime_ms").add(float(mm))

    def _hist(self, name: str) -> _Hist:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = _Hist(self._window)
        return h

    def has_series(self, name: str) -> bool:
        """True when this registry already carries the series — backend
        providers use it to avoid emitting a duplicate metric name in
        the same scrape body."""
        with self._lock:
            return any(k[0] == name for k in self._counters) \
                or any(k[0] == name for k in self._gauges)

    # -- rendering ------------------------------------------------------
    def _snapshot(self):
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: h.snapshot() for k, h in self._hists.items()}
            seen = self._records_seen
        return counters, gauges, hists, seen

    def render_prom(self) -> str:
        counters, gauges, hists, seen = self._snapshot()
        out: List[str] = []
        by_name: Dict[str, List[Tuple[tuple, float]]] = {}
        for (name, labels), v in sorted(counters.items()):
            by_name.setdefault(name, []).append((labels, v))
        for name, rows in by_name.items():
            m = f"ff_{_san(name)}_total"
            out.append(f"# TYPE {m} counter")
            for labels, v in rows:
                out.append(f"{m}{_label_str(labels)} {v:g}")
        gby: Dict[str, List[Tuple[tuple, float]]] = {}
        for (name, labels), v in sorted(gauges.items()):
            gby.setdefault(name, []).append((labels, v))
        for name, rows in gby.items():
            m = f"ff_{_san(name)}"
            out.append(f"# TYPE {m} gauge")
            for labels, v in rows:
                out.append(f"{m}{_label_str(labels)} {v:g}")
        for name in sorted(hists):
            snap = hists[name]
            base = _san(name)
            unit = "ms" if base.endswith("_ms") else "seconds"
            if base.endswith(("_s", "_ms")):
                base = base.rsplit("_", 1)[0]
            m = f"ff_{base}_{unit}"
            out.append(f"# TYPE {m} summary")
            for q in QUANTILES:
                out.append(f'{m}{{quantile="{q / 100.0:g}"}} '
                           f'{snap[f"p{q:g}"]:g}')
            out.append(f"{m}_sum {snap['sum']:g}")
            out.append(f"{m}_count {snap['count']:g}")
        out.append("# TYPE ff_metrics_records_seen_total counter")
        out.append(f"ff_metrics_records_seen_total {seen}")
        return "\n".join(out) + "\n"

    def render_vars(self) -> Dict[str, Any]:
        """expvar-style dict for ``/debug/vars``."""
        counters, gauges, hists, seen = self._snapshot()

        def keyed(d):
            return {name + _label_str(labels): v
                    for (name, labels), v in sorted(d.items())}

        return {"records_seen": seen,
                "counters": keyed(counters),
                "gauges": keyed(gauges),
                "histograms": {k: hists[k] for k in sorted(hists)}}


# ----------------------------------------------------------------------
# scrape-time backend providers (serving state with no event stream)
# ----------------------------------------------------------------------
_providers: List[Callable[[], str]] = []
_providers_lock = threading.Lock()


def register_provider(fn: Callable[[], str]) -> None:
    with _providers_lock:
        if fn not in _providers:
            _providers.append(fn)


def unregister_provider(fn: Callable[[], str]) -> None:
    with _providers_lock:
        if fn in _providers:
            _providers.remove(fn)


def _kv_lines(used: int, free: int, hits: int) -> List[str]:
    """Paged-KV scrape lines from backend *state*.  The engine also
    streams ``serve_kv_blocks_used``/``serve_prefix_hits`` through its
    telemetry log; when an attached registry already renders those
    series the state-side copy is suppressed so one scrape body never
    carries a duplicate metric name (``blocks_free`` is state-only —
    always emitted)."""
    reg = global_registry()
    out: List[str] = []
    if reg is None or not reg.has_series("serve_kv_blocks_used"):
        out.append("# TYPE ff_serve_kv_blocks_used gauge")
        out.append(f"ff_serve_kv_blocks_used {used}")
    out.append("# TYPE ff_serve_kv_blocks_free gauge")
    out.append(f"ff_serve_kv_blocks_free {free}")
    if reg is None or not reg.has_series("serve_prefix_hits"):
        out.append("# TYPE ff_serve_prefix_hits_total counter")
        out.append(f"ff_serve_prefix_hits_total {hits}")
    return out


def render_backend(backend) -> str:
    """Prometheus lines for a serving backend's live state: per-replica
    health/incarnation (pool) or engine queue/active depth — values that
    exist as *state*, not as an event stream, so the registry can't see
    them.  Failures render as a comment, never break a scrape."""
    out: List[str] = []
    try:
        if hasattr(backend, "healthz"):            # ReplicaPool
            hz = backend.healthz()
            out.append("# TYPE ff_serve_queue_depth gauge")
            out.append(f"ff_serve_queue_depth {hz.get('queued', 0)}")
            out.append("# TYPE ff_serve_inflight gauge")
            out.append(f"ff_serve_inflight {hz.get('inflight', 0)}")
            out.append("# TYPE ff_replica_up gauge")
            ups, incs, rsts, ranks = [], [], [], []
            for r in hz.get("replicas", []):
                name = str(r.get("name"))
                pairs = [("replica", name),
                         ("state", str(r.get("state")))]
                if r.get("zone") is not None:
                    pairs.append(("zone", str(r["zone"])))
                if r.get("slice") is not None:
                    # a remote replica (serving/remote.py): its slice,
                    # and how many ranks (cards) it spans
                    pairs.append(("slice", str(r["slice"])))
                    ranks.append("ff_replica_ranks%s %d" % (_label_str(
                        (("replica", name), ("slice", str(r["slice"])))),
                        int(r.get("world_size", 1))))
                lab = _label_str(tuple(sorted(pairs)))
                ups.append(f"ff_replica_up{lab} "
                           f"{1 if r.get('state') == 'ready' else 0}")
                inc = r.get("incarnation")
                if inc is not None:
                    # uid is a string ("replica-0#1") — expose it
                    # info-style (value 1, uid as a label), the
                    # build_info idiom
                    incs.append("ff_replica_incarnation%s 1" % _label_str(
                        (("incarnation", str(inc)), ("replica", name))))
                rsts.append("ff_replica_restarts%s %d" % (
                    _label_str((("replica", name),)),
                    int(r.get("restarts", 0) or 0)))
            out.extend(ups)
            if incs:
                out.append("# TYPE ff_replica_incarnation gauge")
                out.extend(incs)
            if rsts:
                out.append("# TYPE ff_replica_restarts gauge")
                out.extend(rsts)
            if ranks:
                out.append("# TYPE ff_replica_ranks gauge")
                out.extend(ranks)
            zones = hz.get("zones") or {}
            if zones:
                out.append("# TYPE ff_zone_ready_replicas gauge")
                for z, zd in zones.items():
                    out.append("ff_zone_ready_replicas%s %d" % (
                        _label_str((("zone", str(z)),)),
                        int(zd.get("ready", 0))))
                out.append("# TYPE ff_zone_down gauge")
                for z, zd in zones.items():
                    out.append("ff_zone_down%s %d" % (
                        _label_str((("zone", str(z)),)),
                        1 if zd.get("down") else 0))
            # fold paged-KV occupancy across live replica engines
            kvs = [r["engine"]["kv"]
                   for r in backend.stats().get("replicas", {}).values()
                   if r.get("engine") and r["engine"].get("kv")]
            if kvs:
                out.extend(_kv_lines(
                    sum(k["blocks_used"] for k in kvs),
                    sum(k["blocks_free"] for k in kvs),
                    sum(k["prefix_hits"] for k in kvs)))
        elif hasattr(backend, "stats"):            # bare InferenceEngine
            st = backend.stats()
            out.append("# TYPE ff_serve_queue_depth gauge")
            out.append(f"ff_serve_queue_depth {st.get('queued', 0)}")
            out.append("# TYPE ff_serve_active gauge")
            out.append(f"ff_serve_active {st.get('active', 0)}")
            kv = st.get("kv")
            if kv:
                out.extend(_kv_lines(kv["blocks_used"], kv["blocks_free"],
                                     kv["prefix_hits"]))
    except Exception as e:  # noqa: BLE001 — scrape must not 500
        out.append(f"# backend render failed: {type(e).__name__}: {e}")
    return "\n".join(out) + ("\n" if out else "")


def scrape_text(backend=None) -> str:
    """One scrape body: registry series (when enabled) + provider
    lines + an optional backend's live state."""
    parts: List[str] = []
    reg = global_registry()
    if reg is not None:
        parts.append(reg.render_prom())
    else:
        parts.append("# ff metrics registry disabled "
                     "(set FF_METRICS_PORT)\n")
    with _providers_lock:
        provs = tuple(_providers)
    for fn in provs:
        try:
            parts.append(fn())
        except Exception:
            pass  # a dead provider never breaks a scrape
    if backend is not None:
        parts.append(render_backend(backend))
    return "".join(p if p.endswith("\n") else p + "\n"
                   for p in parts if p)


# ----------------------------------------------------------------------
# standalone exporter (env-gated process singleton)
# ----------------------------------------------------------------------
class _MetricsHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: scrapes are periodic
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        path = self.path.split("?")[0]
        if path == "/metrics":
            self._send(200, scrape_text().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/debug/vars":
            reg = global_registry()
            body = reg.render_vars() if reg is not None \
                else {"disabled": True}
            self._send(200, json.dumps(body).encode(), "application/json")
        else:
            self._send(404, b'{"error": "no such endpoint"}',
                       "application/json")


_state_lock = threading.Lock()
_registry: Optional[MetricsRegistry] = None
_server: Optional[ThreadingHTTPServer] = None
_attached_logs: list = []


def global_registry() -> Optional[MetricsRegistry]:
    return _registry


def server_port() -> Optional[int]:
    with _state_lock:
        return _server.server_address[1] if _server is not None else None


def maybe_start(log: Optional[events.EventLog] = None) \
        -> Optional[MetricsRegistry]:
    """Start the process-wide registry + exporter iff ``FF_METRICS_PORT``
    is set; idempotent (later calls attach any newly-created EventLog
    and return the existing registry).  Returns None — and registers NO
    observer — when the knob is unset.  Raises ``ValueError`` on a
    malformed port and ``OSError`` if the bind fails."""
    global _registry, _server
    port = metrics_port_from_env()
    if port is None:
        return None
    with _state_lock:
        if _registry is None:
            _registry = MetricsRegistry()
        if _server is None:
            host = os.environ.get("FF_METRICS_HOST", "")
            _server = ThreadingHTTPServer((host, port), _MetricsHandler)
            _server.daemon_threads = True
            threading.Thread(target=_server.serve_forever,
                             name="ff-metrics-http", daemon=True).start()
            print(f"flexflow_tpu_torch: metrics exporter on "
                  f":{_server.server_address[1]} (/metrics, /debug/vars)")
        reg = _registry
    tap = log if log is not None else events.active_log()
    if tap is not None:
        with _state_lock:
            fresh = tap not in _attached_logs
            if fresh:
                _attached_logs.append(tap)
        if fresh:
            reg.attach(tap)
            # the SLO burn-rate evaluator rides the same tap: its
            # verdicts come back through the log as slo_* gauges, which
            # the registry just attached to this log will fold
            from . import slo

            slo.maybe_attach(tap)
    return reg


def stop() -> None:
    """Shut down the exporter and forget the registry (test hook)."""
    global _registry, _server
    with _state_lock:
        if _server is not None:
            _server.shutdown()
            _server.server_close()
            _server = None
        _registry = None
        _attached_logs.clear()
    from . import slo

    slo.reset()  # the evaluators attached alongside the registry
