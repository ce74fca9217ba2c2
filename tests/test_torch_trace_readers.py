"""The port's trace readers on the CPU: ``tools/timeline_export.py`` and
``tools/memory_report.py`` held against the JAX package's on the same
records (the port writes that package's record schema), the port's
memory report with its CUDA-graph captures section (golden), and a CPU
run of two traced replica engines exported with request tracks."""

import collections
import json
import os
import sys

import numpy as np
import pytest

import flexflow_tpu_torch as ft
from flexflow_tpu.tools import memory_report as jax_memory_report
from flexflow_tpu.tools import timeline_export as jax_timeline_export
from flexflow_tpu_torch.models.transformer import build_transformer
from flexflow_tpu_torch.observability import events
from flexflow_tpu_torch.serving.config import ServeConfig
from flexflow_tpu_torch.serving.pool import ReplicaPool
from flexflow_tpu_torch.tools import memory_report, timeline_export
from flexflow_tpu_torch.tools.trace_report import parse_trace

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "memory_report_torch.md")
V = 32
MAX_SEQ = 64


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("FF_TELEMETRY", "FF_TELEMETRY_FILE", "FF_TRACE_SAMPLE", "FF_TRACE_CHUNK"):
        monkeypatch.delenv(var, raising=False)
    events.reset_active()
    yield
    events.reset_active()


def write_trace(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def check_wellformed(doc):
    """Perfetto's ground rules: monotone timestamps, every B matched by an E
    on the same track, named processes."""
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    for a, b in zip(evs, evs[1:]):
        assert a["ts"] <= b["ts"], (a, b)
    depth = collections.Counter()
    for e in evs:
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            depth[key] += 1
        elif e["ph"] == "E":
            depth[key] -= 1
            assert depth[key] >= 0, f"E without B on {key}"
    assert all(v == 0 for v in depth.values()), depth
    assert any(m["name"] == "process_name" for m in doc["traceEvents"] if m["ph"] == "M")


def tracks(doc):
    """(process name, thread name) -> [events]."""
    procs = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    threads = {(e["pid"], e["tid"]): e["args"]["name"] for e in doc["traceEvents"]
               if e["ph"] == "M" and e["name"] == "thread_name"}
    out = collections.defaultdict(list)
    for e in doc["traceEvents"]:
        if e["ph"] in ("B", "E", "i"):
            out[(procs[e["pid"]], threads.get((e["pid"], e["tid"]), "?"))].append(e)
    return out


# -- timeline_export ---------------------------------------------------------

def test_fold_clamps_overlap_to_matched_pairs():
    # a child claiming to outlive its parent (overlapping producer clocks)
    spans = [(0, 100, "parent", {}), (50, 100, "child", {})]
    out = timeline_export._fold_spans(spans, pid=1, tid=1)
    assert [e["ph"] for e in out] == ["B", "B", "E", "E"]
    assert out[2]["ts"] == 100 and out[3]["ts"] == 100
    assert out == jax_timeline_export._fold_spans(spans, pid=1, tid=1)


def test_fold_sequential_spans_close_in_order():
    spans = [(0, 10, "a", {}), (20, 10, "b", {})]
    out = timeline_export._fold_spans(spans, pid=1, tid=1)
    assert [(e["ph"], e.get("name")) for e in out] == [
        ("B", "a"), ("E", None), ("B", "b"), ("E", None)]


def test_sampled_traces_needs_span_ids():
    recs = [
        {"t": "span", "name": "step", "ts": 0.0, "dur": 1.0,
         "attrs": {"trace_id": "run" * 8}},
        {"t": "span", "name": "serve_prefill", "ts": 0.0, "dur": 0.1,
         "attrs": {"trace_id": "aa" * 16}},
        {"t": "span", "name": "serve_attempt", "ts": 0.0, "dur": 0.2,
         "attrs": {"trace_id": "bb" * 16, "span_id": "cc" * 8}},
    ]
    assert timeline_export.sampled_traces(recs) == {"bb" * 16}


def synthetic_log(path):
    """The JAX package's synthetic track-layout trace, written by the port's
    EventLog, with a sampled request, a capture and a chipwatch window."""
    from flexflow_tpu_torch.observability import reqtrace

    log = events.EventLog(path, run_id="synthetic")
    log.span_at("step", 0.0, 0.5, step=0, trace_id="run" * 8)
    log.span_at("mcmc_search", 0.0, 0.2, budget=10)
    log.event("compile_done", site="train_step", graph_pool_bytes=2**20)
    log.event("memory_predicted", peak_bytes=2**30)
    log.event("chip_probe", ok=True)
    log.event("measurement_progress", entries=3, new_entries=3, elapsed_s=1.0)
    log.gauge("serve_batch_occupancy", 1.5, replica="replica-0")
    log.gauge("mfu", 0.3)
    ctx = reqtrace.TraceContext("ab" * 16, "cd" * 8, None, True)
    att = ctx.child()
    log.span_at("serve_request", 0.1, 0.3, request_id="r0", **ctx.ids())
    log.span_at("serve_attempt", 0.11, 0.25, request_id="r0#a1", **att.ids())
    log.span_at("serve_prefill", 0.12, 0.05, request_id="r0#a1", **reqtrace.tag(att))
    log.span_at("serve_decode", 0.2, 0.4, request_id="r0#a1", **reqtrace.tag(att))
    log.close()
    return path


def test_export_equals_the_jax_package(tmp_path):
    path = synthetic_log(str(tmp_path / "t.jsonl"))
    recs = parse_trace(path)
    doc = timeline_export.export_records(recs)
    assert doc == jax_timeline_export.export_records(recs)
    check_wellformed(doc)
    tr = tracks(doc)
    assert ("training", "train") in tr
    assert ("search", "search") in tr
    assert [e["name"] for e in tr[("compile", "compile")]] == ["compile_done",
                                                                 "memory_predicted"]
    assert [e["name"] for e in tr[("chips", "chips")]] == ["chip_probe",
                                                           "measurement_progress"]
    assert {e["name"] for e in doc["traceEvents"] if e["ph"] == "C"} \
        == {"occupancy replica-0", "mfu"}
    assert doc["otherData"]["request_tracks"] == ["abababab", "abababab/a1"]
    assert doc["otherData"]["run_id"] == "synthetic"
    assert timeline_export.summarize(doc) == jax_timeline_export.summarize(doc)


def test_cli_writes_loadable_json_and_fails_loud_on_empty(tmp_path, capsys):
    path = synthetic_log(str(tmp_path / "t.jsonl"))
    out = str(tmp_path / "timeline.json")
    assert timeline_export.main([path, "-o", out]) == 0
    with open(out) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    check_wellformed(doc)
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert timeline_export.main([str(empty)]) == 1
    assert "no records" in capsys.readouterr().err


@pytest.fixture(scope="module")
def lm():
    m = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu"))
    build_transformer(m, 4, seq_length=MAX_SEQ, num_layers=1, embed_dim=16, num_heads=2,
                      vocab_size=V)
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=3)
    return m


def test_two_traced_replica_engines_export_request_tracks(lm, tmp_path, monkeypatch):
    """Two replica engines of the port's pool on the CPU, every request
    sampled (FF_TRACE_SAMPLE=1): the export has a request track per trace
    root and per attempt, each attempt nesting its prefill and decode
    spans, and the replica gauges as counter tracks; the JAX package's
    exporter folds the same trace into the same document."""
    monkeypatch.setenv("FF_TRACE_SAMPLE", "1")
    monkeypatch.setenv("FF_TRACE_CHUNK", "4")
    log = events.EventLog(str(tmp_path / "serve.jsonl"))
    cfg = ServeConfig(max_batch=2, max_seq=MAX_SEQ, replicas=2, replica_timeout_s=120.0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, size=int(rng.integers(3, 12))).astype(np.int32)
               for _ in range(6)]
    with ReplicaPool(lm, config=cfg, telemetry=log) as pool:
        for h in [pool.submit(p, 8) for p in prompts]:
            h.result(120)
    log.close()
    out = str(tmp_path / "timeline.json")
    assert timeline_export.main([log.path, "-o", out]) == 0
    with open(out) as f:
        doc = json.load(f)
    check_wellformed(doc)
    assert doc == json.loads(json.dumps(
        jax_timeline_export.export_records(parse_trace(log.path))))
    assert len(doc["otherData"]["request_tracks"]) >= 6
    tr = tracks(doc)
    attempts = [k for k in tr if k[0] == "requests" and "/a" in k[1]]
    assert len(attempts) >= 6
    for key in attempts:
        begins = [e["name"] for e in tr[key] if e["ph"] == "B"]
        assert begins[0] == "serve_attempt", begins
        assert "serve_prefill" in begins and "serve_decode" in begins
    for key in [k for k in tr if k[0] == "requests" and "/" not in k[1]]:
        assert [e["name"] for e in tr[key] if e["ph"] == "B"] == ["serve_request"]
    counters = {e["name"] for e in doc["traceEvents"] if e["ph"] == "C"}
    assert any(c.startswith("occupancy replica-") for c in counters)


# -- memory_report -----------------------------------------------------------

def predicted_live_records():
    """memory_predicted, hbm_bytes gauges from two devices and the serving
    KV pool's block bytes: the records both packages write alike."""
    recs = [{"t": "meta", "version": 1, "run_id": "golden-run", "pid": 7,
             "unix_time": 1700000000.0}]
    recs.append({"t": "event", "name": "memory_predicted", "ts": 0.5,
                 "attrs": {"num_devices": 8, "peak_bytes": 480 * 2**20, "peak_device": 3,
                           "dominant_term": "params",
                           "terms": {"params": 220 * 2**20, "grads": 220 * 2**20,
                                     "optimizer": 0, "activations": 30 * 2**20,
                                     "staging": 10 * 2**20},
                           "capacity_bytes": 80 * 10**9,
                           "headroom_bytes": 80 * 10**9 - 480 * 2**20, "opt_slots": 0,
                           "by_op": {"fc1": 300 * 2**20, "conv1": 120 * 2**20,
                                     "sm": 2**20}}})
    for dev, kind, v in [("0", "in_use", 1800 * 2**20), ("0", "peak", 2048 * 2**20),
                         ("0", "limit", 80 * 10**9), ("1", "in_use", 500 * 2**20),
                         ("pool", "kv_blocks", 24 * 2**20)]:
        recs.append({"t": "gauge", "name": "hbm_bytes", "v": float(v), "ts": 5.0,
                     "attrs": {"device": dev, "kind": kind, "replica": "replica-0"}})
    return recs


def capture_records():
    """The port's capture ledger: a train_step capture and a serving
    prefill captured twice (one retrace)."""
    recs = [{"t": "event", "name": "compile_done", "ts": 1.0,
             "attrs": {"site": "train_step", "fingerprint": "aa11", "wall_s": 0.42,
                       "retrace": False, "aot": False, "total_compiles": 1,
                       "total_retraces": 0, "graph_pool_bytes": 36 * 2**20}},
            {"t": "counter", "name": "compiles", "v": 1, "total": 1, "ts": 1.0,
             "attrs": {"site": "train_step"}},
            {"t": "counter", "name": "compile_retraces", "v": 0, "total": 0, "ts": 1.0,
             "attrs": {"site": "train_step"}}]
    for i, (fp, retrace) in enumerate([("bb22", False), ("bb33", True)]):
        recs += [{"t": "event", "name": "compile_done", "ts": 2.0 + i,
                  "attrs": {"site": "serve_prefill", "fingerprint": fp, "wall_s": 0.1 + i,
                            "retrace": retrace, "aot": False, "total_compiles": 2 + i,
                            "total_retraces": int(retrace),
                            "graph_pool_bytes": (8 + i) * 2**20}},
                 {"t": "counter", "name": "compiles", "v": 1, "total": 2 + i, "ts": 2.0 + i,
                  "attrs": {"site": "serve_prefill"}},
                 {"t": "counter", "name": "compile_retraces", "v": int(retrace),
                  "total": int(retrace), "ts": 2.0 + i, "attrs": {"site": "serve_prefill"}}]
    return recs


def section(report, head):
    """The lines of ``report`` under the ``## head`` heading."""
    lines = report.splitlines()
    i = lines.index(f"## {head}")
    j = next((k for k in range(i + 1, len(lines)) if lines[k].startswith("## ")), len(lines))
    return lines[i:j]


def test_predicted_and_live_views_equal_the_jax_package(tmp_path):
    path = str(tmp_path / "t.jsonl")
    write_trace(path, predicted_live_records())
    ours = memory_report.fold(memory_report.parse_trace(path))
    theirs = jax_memory_report.fold(jax_memory_report.parse_trace(path))
    assert ours["predicted"] == theirs["predicted"] and ours["live"] == theirs["live"]
    a = memory_report.render(ours, "t.jsonl")
    b = jax_memory_report.render(theirs, "t.jsonl")
    for head in ("Predicted (analytic model)", "Headroom", "Live HBM"):
        assert section(a, head) == section(b, head)
    assert "| pool | kv_blocks | 24.0 MiB |" in a
    # with no capture, the one ratio is live(peak) / predicted peak
    assert "- !! live(peak) / predicted peak = 4.27 (2.0 GiB vs 480.0 MiB)" in a


def test_report_with_captures_and_divergence(tmp_path):
    path = str(tmp_path / "t.jsonl")
    write_trace(path, predicted_live_records() + capture_records())
    report = memory_report.main([path, "-o", str(tmp_path / "r.md")])
    assert (tmp_path / "r.md").read_text() == report
    rows = section(report, "CUDA-graph captures")
    assert "| serve_prefill | 2 | 1 | 1.100s | 9.0 MiB |" in rows
    assert "| train_step | 1 | 0 | 0.420s | 36.0 MiB |" in rows
    assert "- **1 retrace(s)** — a site captured again for a new signature; on a serving " \
           "ladder this means a bucket leak" in rows
    # (30 + 10) MiB predicted activations + staging against the 36 MiB pool
    assert "- predicted activations + staging / largest graph pool = 1.11 " \
           "(40.0 MiB vs 36.0 MiB)" in report
    assert "XLA" not in report


def test_missing_views_and_corrupt_lines_tolerated(tmp_path):
    path = str(tmp_path / "live.jsonl")
    write_trace(path, [{"t": "gauge", "name": "hbm_bytes", "v": 1024.0, "ts": 1.0,
                        "attrs": {"device": "0", "kind": "in_use"}},
                       {"t": "event", "name": "xla_memory", "ts": 1.0,
                        "attrs": {"site": "jax_step", "total_bytes": 1}},
                       ["not", "a", "record"]])
    with open(path, "a") as f:
        f.write('{"t": "event", "name": "compile_do')  # truncated mid-write
    report = memory_report.main([path])
    assert "no `memory_predicted` event" in report
    assert "no capture events" in report
    assert "nothing to cross-check" in report
    assert "jax_step" not in report


def test_golden_output(tmp_path):
    """Byte-exact golden; regenerate with
    ``PYTHONPATH=. python tests/test_torch_trace_readers.py --regen`` after a deliberate
    format change."""
    path = str(tmp_path / "t.jsonl")
    write_trace(path, predicted_live_records() + capture_records())
    report = memory_report.render(memory_report.fold(memory_report.parse_trace(path)),
                                  "golden.jsonl")
    with open(GOLDEN) as f:
        assert report == f.read()


if __name__ == "__main__" and "--regen" in sys.argv:
    import tempfile

    tmp = os.path.join(tempfile.mkdtemp(), "t.jsonl")
    write_trace(tmp, predicted_live_records() + capture_records())
    with open(GOLDEN, "w") as f:
        f.write(memory_report.render(memory_report.fold(memory_report.parse_trace(tmp)),
                                     "golden.jsonl"))
    print(f"regenerated {GOLDEN}")
