"""The port's copies of the JAX package's host-side telemetry planes
(flexflow_tpu_torch/observability/: events, health, slo, metrics,
reqtrace) and readers (tools/trace_report.py, tools/health_report.py),
held against the originals on the CPU.

The same synthetic record stream, on an injected clock, goes through both
packages: the JSONL lines, the health findings, the SLO burn rates and
alerts, and the Prometheus scrape must be equal exactly.  The readers
must print identical reports of the same trace, for a trace of each
package's own training run and for a synthetic one.
"""

import json
import urllib.request

import numpy as np
import pytest

import jax

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.observability import events as j_events
from flexflow_tpu.observability import health as j_health
from flexflow_tpu.observability import metrics as j_metrics
from flexflow_tpu.observability import reqtrace as j_reqtrace
from flexflow_tpu.observability import slo as j_slo
from flexflow_tpu.tools import health_report as j_health_report
from flexflow_tpu.tools import trace_report as j_trace_report
from flexflow_tpu_torch.observability import events as t_events
from flexflow_tpu_torch.observability import health as t_health
from flexflow_tpu_torch.observability import metrics as t_metrics
from flexflow_tpu_torch.observability import reqtrace as t_reqtrace
from flexflow_tpu_torch.observability import slo as t_slo
from flexflow_tpu_torch.tools import health_report as t_health_report
from flexflow_tpu_torch.tools import trace_report as t_trace_report

PKGS = {"jax": (j_events, j_health, j_metrics, j_slo),
        "torch": (t_events, t_health, t_metrics, t_slo)}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for var in ("FF_TELEMETRY", "FF_TELEMETRY_FILE", "FF_HEALTH", "FF_HEALTH_SAMPLE_EVERY",
                "FF_METRICS_PORT", "FF_METRICS_HOST", "FF_HEARTBEAT_PATH", "FF_TRACE_SAMPLE",
                "FF_TRACE_CHUNK", "FF_SLO_TTFT_MS", "FF_SLO_TPOT_MS", "FF_SLO_QUEUE_WAIT_MS",
                "FF_SLO_AVAILABILITY", "FF_SLO_OBJECTIVE", "FF_SLO_WINDOWS",
                "FF_SLO_BURN_ALERT"):
        monkeypatch.delenv(var, raising=False)
    for ev, _, met, _ in PKGS.values():
        ev.reset_active()
        met.stop()
    yield
    for ev, _, met, _ in PKGS.values():
        ev.reset_active()
        met.stop()


def _lines(path):
    """The trace's records without the meta line (pid and wall time)."""
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()][1:]


def _log(pkg, path):
    ticks = iter(i * 0.001 for i in range(100000))
    return PKGS[pkg][0].EventLog(str(path), run_id="run-1", clock=lambda: next(ticks))


# ---------------------------------------------------------------------------
# the event log
# ---------------------------------------------------------------------------

def _stream(log):
    """Spans (nested), counters with attributes, gauges, events."""
    with log.span("compile", num_ops=3) as at:
        with log.span("inner"):
            log.counter("compiles", 1, site="train_step")
        at["num_devices"] = 1
    for i in range(5):
        log.span_at("step", 0.01 * i, 0.008 + 0.001 * i, step=i, first=i == 0)
        log.counter("samples", 4.0)
        log.gauge("mfu", 0.1 * i)
        log.gauge("hbm_bytes", 1e9 + i, device="0", kind="in_use")
    log.event("health", kind="straggler", step=4)
    log.flush()
    log.close()


def test_event_log_writes_the_same_records(tmp_path):
    for pkg in PKGS:
        _stream(_log(pkg, tmp_path / f"{pkg}.jsonl"))
    assert _lines(tmp_path / "torch.jsonl") == _lines(tmp_path / "jax.jsonl")
    with open(tmp_path / "torch.jsonl") as f:
        meta = json.loads(f.readline())
    assert (meta["t"], meta["version"], meta["run_id"]) == ("meta", 1, "run-1")


def test_for_config_and_active_log_follow_the_flag(monkeypatch, tmp_path):
    for pkg, (ev, *_) in PKGS.items():
        assert ev.for_config(ft.FFConfig(device="cpu")) is None and ev.active_log() is None
        cfg = ft.FFConfig(device="cpu", telemetry=True,
                          telemetry_file=str(tmp_path / f"{pkg}.jsonl"))
        log = ev.for_config(cfg)
        assert log is ev.active_log() and log.path == cfg.telemetry_file
        ev.reset_active()


# ---------------------------------------------------------------------------
# the health monitor and the heartbeat
# ---------------------------------------------------------------------------

def _straggler(log, health):
    hm = health.HealthMonitor(None, log, sample_every=0, straggler_k=3.0, min_window=4)
    log.add_observer(hm.observe)
    t = 0.0
    for i in range(6):
        hm.on_step(i, t, 0.010, first=i == 0)
        t += 0.012
    log.span_at("data_wait", t + 0.001, 0.08, batch_size=4)
    hm.on_step(6, t + 0.002, 0.1, first=False)
    hm.on_step(7, t + 0.2, 0.1, first=False)  # no overlap: "unknown"


def _starvation(log, health):
    hm = health.HealthMonitor(None, log, sample_every=4, wait_ratio=0.3, min_window=99)
    log.add_observer(hm.observe)
    t = 0.0
    for i in range(9):
        log.span_at("data_wait", t, 0.008 if i < 5 else 0.0005, batch_size=4)
        hm.on_step(i, t + 0.008, 0.010, first=i == 0)
        t += 0.02


def _drains(log, health):
    hm = health.HealthMonitor(None, log, sample_every=0)
    hm.on_drain({"nonfinite_loss": 2.0, "nonfinite_grad": 1.0, "grad_norm": 7.5}, 4.0, 4)
    hm.on_drain({"nonfinite_loss": 0.0, "nonfinite_grad": 0.0, "grad_norm": 3.0}, 3.0, 7)


def _cap(log, health):
    hm = health.HealthMonitor(None, log, sample_every=0)
    for i in range(health.MAX_EVENTS_PER_KIND + 20):
        hm._emit("nonfinite_loss", step=i)


@pytest.mark.parametrize("scenario", [_straggler, _starvation, _drains, _cap],
                         ids=lambda f: f.__name__.strip("_"))
def test_health_findings_equal(scenario, tmp_path):
    for pkg in PKGS:
        log = _log(pkg, tmp_path / f"{pkg}.jsonl")
        scenario(log, PKGS[pkg][1])
        log.close()
    got, want = _lines(tmp_path / "torch.jsonl"), _lines(tmp_path / "jax.jsonl")
    assert got == want and any(r["name"] in ("health", "grad_global_norm") for r in got)


def test_heartbeats_are_read_across_packages(monkeypatch, tmp_path):
    monkeypatch.setenv("FF_HEARTBEAT_PATH", str(tmp_path / "hb.json"))
    t_health.write_heartbeat("step", step=12, note="x")
    hb = j_health.read_heartbeat()
    assert (hb["phase"], hb["step"], hb["note"]) == ("step", 12, "x")
    j_health.write_heartbeat("data_wait")
    assert t_health.describe_heartbeat(t_health.read_heartbeat(), now=hb["unix_time"]) \
        .startswith("phase 'data_wait'")


# ---------------------------------------------------------------------------
# SLO burn rates
# ---------------------------------------------------------------------------

class _FakeLog:
    def __init__(self):
        self.out = []

    def gauge(self, name, v, **attrs):
        self.out.append(("gauge", name, v, attrs))

    def event(self, name, **attrs):
        self.out.append(("event", name, attrs))

    def add_observer(self, fn):
        pass


def _done(ts, **attrs):
    attrs.setdefault("status", "done")
    return {"t": "event", "name": "serve_request_done", "ts": ts, "attrs": attrs}


def _serve_stream():
    rng = np.random.default_rng(5)
    recs = []
    for i in range(60):
        bad = 20 <= i < 40
        recs.append(_done(0.5 * i, ttft_s=float(0.9 if bad else rng.uniform(0.01, 0.3)),
                          tpot_s=float(rng.uniform(0.01, 0.2)),
                          queue_wait_s=float(rng.uniform(0.0, 2.0)),
                          status="timeout" if i % 17 == 0 else "done"))
    return recs


@pytest.mark.parametrize("windows,alert", [((2.0, 8.0), 2.0), ((5.0, 30.0), 1.5)])
def test_slo_burn_rates_and_alerts_equal(windows, alert):
    outs = {}
    for pkg, (_, _, _, slo) in PKGS.items():
        log = _FakeLog()
        ev = slo.BurnRateEvaluator(log, targets=slo.targets_from_env(), windows=windows,
                                   burn_alert=alert)
        for rec in _serve_stream():
            ev.observe(rec)
        outs[pkg] = log.out
    assert outs["torch"] == outs["jax"]
    assert any(o[1] == "slo_alert" for o in outs["torch"])


# ---------------------------------------------------------------------------
# the metrics registry, the scrape and the exporter
# ---------------------------------------------------------------------------

class _Engine:
    """The scrape-time surface of an InferenceEngine."""

    def stats(self):
        return {"queued": 3, "active": 2,
                "kv": {"blocks_used": 5, "blocks_free": 11, "prefix_hits": 4}}


def test_scrape_text_equal(monkeypatch, tmp_path):
    """The same records through each package's live registry (started by
    FF_METRICS_PORT, with the SLO evaluator on its tap) give the same
    Prometheus text and /debug/vars, over HTTP too."""
    monkeypatch.setenv("FF_METRICS_PORT", "0")
    monkeypatch.setenv("FF_METRICS_HOST", "127.0.0.1")
    scrapes = {}
    for pkg, (ev, _, met, _) in PKGS.items():
        log = _log(pkg, tmp_path / f"{pkg}.jsonl")
        log.counter("samples", 8.0)   # before the registry: seeded from the totals
        reg = met.maybe_start(log)
        _stream_serve(log)
        with urllib.request.urlopen(f"http://127.0.0.1:{met.server_port()}/metrics",
                                    timeout=30) as r:
            http = r.read().decode()
        scrapes[pkg] = (met.scrape_text(backend=_Engine()), json.dumps(reg.render_vars()),
                        http)
        log.close()
        met.stop()
    assert scrapes["torch"] == scrapes["jax"]
    text = scrapes["torch"][0]
    assert "ff_samples_total 24" in text and "ff_serve_queue_depth 3" in text
    assert "ff_slo_burn_rate" in text


def _stream_serve(log):
    for i in range(4):
        log.span_at("step", 0.01 * i, 0.008 + 0.002 * i, step=i)
        log.counter("samples", 4.0)
        log.gauge("hbm_bytes", 2e9, device="0", kind="in_use")
        log.counter("compile_retraces", 0, site="train_step")
    for rec in _serve_stream()[:10]:
        log.event("serve_request_done", **rec["attrs"])


# ---------------------------------------------------------------------------
# request tracing
# ---------------------------------------------------------------------------

def test_sampling_decisions_and_ids_equal():
    rng = np.random.default_rng(0)
    ids = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)).hex() for _ in range(300)]
    for rate in (0.0, 0.1, 0.5, 0.9, 1.0):
        assert [t_reqtrace.decide(i, rate) for i in ids] == \
            [j_reqtrace.decide(i, rate) for i in ids]
    assert t_reqtrace.run_trace_id("run-7") == j_reqtrace.run_trace_id("run-7")
    ctx = t_reqtrace.TraceContext(ids[0], "00ff00ff00ff00ff", None, True)
    jctx = j_reqtrace.TraceContext(ids[0], "00ff00ff00ff00ff", None, True)
    assert t_reqtrace.tag(ctx) == j_reqtrace.tag(jctx)
    child = ctx.child()
    assert (child.trace_id, child.parent_span_id, child.sampled) == (ids[0], ctx.span_id, True)
    assert t_reqtrace.begin(None) is None and t_reqtrace.tag(None) == {}


@pytest.mark.parametrize("var,value,match", [("FF_TRACE_SAMPLE", "lots", "not a number"),
                                             ("FF_TRACE_SAMPLE", "1.5", "outside"),
                                             ("FF_TRACE_CHUNK", "-1", ">= 0")])
def test_trace_knobs_are_parsed_loudly(var, value, match, monkeypatch):
    monkeypatch.setenv(var, value)
    for mod in (t_reqtrace, j_reqtrace):
        parse = mod.sample_rate_from_env if var == "FF_TRACE_SAMPLE" \
            else mod.chunk_tokens_from_env
        with pytest.raises(ValueError, match=match):
            parse()


# ---------------------------------------------------------------------------
# the readers: one report of one trace, whichever package reads it
# ---------------------------------------------------------------------------

def _train_trace(pkg, path, monkeypatch):
    """A traced run of a small MLP in ``pkg``, with the health monitor and
    a non-finite batch."""
    monkeypatch.setenv("FF_TELEMETRY", "1")
    monkeypatch.setenv("FF_TELEMETRY_FILE", str(path))
    monkeypatch.setenv("FF_HEALTH", "1")
    monkeypatch.setenv("FF_HEALTH_SAMPLE_EVERY", "2")
    extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
    m = pkg.FFModel(pkg.FFConfig(batch_size=4, search_budget=40, **extra))
    inp = m.create_tensor((4, 12), nchw=False)
    t = m.dense(inp, 16, activation="relu", name="fc1")
    m.softmax(m.dense(t, 5, name="fc2"), name="sm")
    args = (pkg.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    if pkg is ff:
        m.compile(*args, machine=ff.Machine(devices=jax.devices()[:1]))
    else:
        m.compile(*args)
    m.init_layers(seed=1)
    rng = np.random.default_rng(3)
    for i in range(6):
        x = rng.standard_normal((4, 12), dtype=np.float32)
        if i == 3:
            x[0, 0] = np.inf
        m.set_batch({inp: x}, rng.integers(0, 5, (4, 1)).astype(np.int32))
        m.train_iteration()
    m.get_metrics()
    m.sync()
    (j_events if pkg is ff else t_events).reset_active()


def _synthetic(path):
    recs = [{"t": "meta", "version": 1, "run_id": "syn", "pid": 1, "unix_time": 0.0}]
    for i in range(6):
        recs.append({"t": "span", "name": "step", "id": i + 1, "parent": None,
                     "ts": 0.1 * i, "dur": 0.02 + 0.01 * (i == 4),
                     "attrs": {"step": i, "first": i == 0, "samples_per_sec": 100.0 + i,
                               "mfu": 0.05}})
    recs.append({"t": "event", "name": "health", "ts": 0.5,
                 "attrs": {"kind": "straggler", "step": 4, "dur_ms": 30.0, "p50_ms": 20.0,
                           "ratio": 1.5, "attribution": "data_wait"}})
    recs.append({"t": "event", "name": "op_runtime", "ts": 0.6,
                 "attrs": {"op": "attn_0", "which": "forward", "measured_ms": 0.5,
                           "predicted_ms": 0.4, "ratio": 0.8, "src": "measured", "step": 4}})
    recs.append({"t": "event", "name": "search_progress", "ts": 0.0,
                 "attrs": {"iter": 0, "best_ms": 3.0}})
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


@pytest.mark.parametrize("source", ["jax", "torch", "synthetic"])
@pytest.mark.parametrize("reader", ["trace_report", "health_report"])
def test_readers_print_identical_reports(reader, source, monkeypatch, tmp_path):
    path = tmp_path / "t.jsonl"
    if source == "synthetic":
        _synthetic(path)
    else:
        _train_trace(ff if source == "jax" else ft, path, monkeypatch)
    mods = {"trace_report": (t_trace_report, j_trace_report),
            "health_report": (t_health_report, j_health_report)}[reader]
    got, want = (mod.render_report(mod.parse_trace(str(path))) for mod in mods)
    assert got == want
    assert "## " in got
    if source != "synthetic" and reader == "trace_report":
        assert "steady-state over 5 steps" in got
    if source != "synthetic" and reader == "health_report":
        assert "nonfinite" in got
