"""The port's telemetry on the training path, the strategy search and the
serving engine, held against the JAX package on the CPU.

The same tiny models, built from one seed, run through both packages with
``FF_TELEMETRY=1 FF_HEALTH=1``.  What must be equal is equal exactly: the
multiset of record kinds, names and attribute keys, the analytic numbers
(the ``samples`` totals, ``est_collective_bytes_per_step``, the forward
FLOPs behind MFU), the step a NaN batch is flagged at, the seeded search's
``search_candidate`` records, and the serving engine's per-request records
(with the tokens unchanged).  The port alone: losses bitwise equal with
telemetry on and off, no ``EventLog`` call at all with it off, the capture
ledger over fake CUDA graphs, ``memory_predicted`` against the memory
model, the op profiler and ``print_op_profile``, the live ``/metrics``
plane, and the checkpoint, data-wait and guard narration.
"""

import collections
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import jax

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.models.transformer import build_transformer as jax_build_transformer
from flexflow_tpu.observability import events as jax_events
from flexflow_tpu.observability import metrics as jax_metrics
from flexflow_tpu.serving.engine import InferenceEngine as JaxEngine
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
from flexflow_tpu_torch.models.transformer import build_transformer
from flexflow_tpu_torch.observability import events, memplane, metrics
from flexflow_tpu_torch.runtime.dataloader import DataLoader
from flexflow_tpu_torch.runtime.step_graph import StepGraph, graphs_enabled
from flexflow_tpu_torch.serving.engine import InferenceEngine
from flexflow_tpu_torch.simulator.machine import H100MachineModel
from flexflow_tpu_torch.simulator.memory import memory_per_device
from flexflow_tpu_torch.tools import trace_report

from test_torch_search import _search_pair, restricted_reference  # noqa: F401
from test_torch_step import _FakeCuda

B, S, V = 4, 8, 64
SHAPE = dict(seq_length=S, num_layers=2, embed_dim=32, num_heads=4, vocab_size=V)
KNOBS = ("FF_TELEMETRY", "FF_TELEMETRY_FILE", "FF_TELEMETRY_SYNC", "FF_HEALTH",
         "FF_HEALTH_SAMPLE_EVERY", "FF_HEALTH_STRAGGLER_K", "FF_HEALTH_DATA_WAIT_RATIO",
         "FF_HEARTBEAT_PATH", "FF_MEMPLANE", "FF_OPPROF", "FF_OPPROF_BUDGET_S",
         "FF_OPPROF_CORPUS", "FF_METRICS_PORT", "FF_METRICS_HOST", "FF_SKIP_NONFINITE",
         "FF_TRACE_SAMPLE", "FF_TRACE_CHUNK", "FF_CKPT_RETRIES", "FF_CKPT_BACKOFF_S")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Each test starts with both packages' logs and exporters off."""
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)
    for mod in (events, jax_events):
        mod.reset_active()
    yield
    for mod in (events, jax_events):
        mod.reset_active()
    for mod in (metrics, jax_metrics):
        mod.stop()


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _records(path, name=None):
    return [r for r in _read(path) if r["t"] != "meta" and (name is None or r["name"] == name)]


def _signature(recs):
    """The multiset of (kind, name, attribute keys)."""
    return collections.Counter((r["t"], r["name"], tuple(sorted(r.get("attrs") or {})))
                               for r in recs)


def _cfg(pkg, **kw):
    return pkg.FFConfig(batch_size=B, **(dict(device="cpu") if pkg is ft
                                         else dict(workers_per_node=1)), **kw)


def _compile(pkg, m, opt=None):
    args = (opt or pkg.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    if pkg is ff:
        m.compile(*args, machine=ff.Machine(devices=jax.devices()[:1]))
    else:
        m.compile(*args)


def _lm(pkg, seed=0, **cfg):
    m = pkg.FFModel(_cfg(pkg, **cfg))
    (jax_build_transformer if pkg is ff else build_transformer)(m, B, **SHAPE)
    _compile(pkg, m)
    m.init_layers(seed=seed)
    return m


def _lm_batch(m, seed=0):
    rng = np.random.default_rng(seed)
    feed = {t: (rng.integers(0, V, (B, S)).astype(np.int32) if t.name == "tokens"
                else np.tile(np.arange(S, dtype=np.int32), (B, 1))) for t in m.input_tensors}
    m.set_batch(feed, rng.integers(0, V, (B, S)).astype(np.int32))


def _mlp(pkg, **cfg):
    m = pkg.FFModel(_cfg(pkg, **cfg))
    inp = m.create_tensor((B, 12), nchw=False)
    t = m.dense(inp, 24, activation="relu", name="fc1")
    t = m.dense(t, 6, name="fc2")
    m.softmax(t, name="sm")
    _compile(pkg, m)
    m.init_layers(seed=8)
    return m, inp


def _traced(monkeypatch, path, **env):
    monkeypatch.setenv("FF_TELEMETRY", "1")
    monkeypatch.setenv("FF_TELEMETRY_FILE", str(path))
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))


def _train_lm(pkg, monkeypatch, path, steps=4, **env):
    """A traced run of the tiny transformer; returns the model."""
    _traced(monkeypatch, path, **env)
    m = _lm(pkg)
    _lm_batch(m)
    for _ in range(steps):
        m.train_iteration()
    m.get_metrics()
    m.sync()
    (jax_events if pkg is ff else events).reset_active()
    return m


# ---------------------------------------------------------------------------
# the training path against the JAX package
# ---------------------------------------------------------------------------

def test_training_records_match_the_jax_package(monkeypatch, tmp_path):
    """Both packages' traces hold the same records (kind, name, attribute
    keys) the same number of times, one ``step`` span per step with the
    same analytic attributes."""
    _train_lm(ff, monkeypatch, tmp_path / "j.jsonl", FF_HEALTH=1, FF_HEALTH_SAMPLE_EVERY=2)
    _train_lm(ft, monkeypatch, tmp_path / "t.jsonl", FF_HEALTH=1, FF_HEALTH_SAMPLE_EVERY=2)
    want, got = _records(tmp_path / "j.jsonl"), _records(tmp_path / "t.jsonl")
    assert _signature(got) == _signature(want)
    steps = [_records(tmp_path / f, "step") for f in ("j.jsonl", "t.jsonl")]
    assert [len(s) for s in steps] == [4, 4]
    for js, ts in zip(*steps):
        for k in ("step", "first", "batch_size"):
            assert ts["attrs"][k] == js["attrs"][k], k
    assert {r["name"] for r in got} >= {"compile", "step", "metric_drain", "sim_prediction",
                                        "memory_predicted", "grad_global_norm", "mfu"}


@pytest.mark.parametrize("build", ["transformer", "mlp"])
def test_analytic_numbers_equal(build, monkeypatch, tmp_path):
    """The ``samples`` totals, ``est_collective_bytes_per_step`` and the
    forward FLOPs behind MFU are the JAX package's exactly."""
    out = {}
    for pkg, name in ((ff, "j"), (ft, "t")):
        path = tmp_path / f"{name}.jsonl"
        _traced(monkeypatch, path)
        if build == "transformer":
            m = _lm(pkg)
            _lm_batch(m)
        else:
            m, inp = _mlp(pkg)
            rng = np.random.default_rng(1)
            m.set_batch({inp: rng.standard_normal((B, 12), dtype=np.float32)},
                        rng.integers(0, 6, (B, 1)).astype(np.int32))
        for _ in range(3):
            m.train_iteration()
        m.sync()
        fwd_flops = m._stepstats._statics()[0]
        (jax_events if pkg is ff else events).reset_active()
        recs = _records(path)
        out[name] = (fwd_flops,
                     [r["total"] for r in recs if r["name"] == "samples"],
                     [r["v"] for r in recs if r["name"] == "est_collective_bytes_per_step"])
    assert out["t"] == out["j"]
    assert out["t"][1] == [B, 2 * B, 3 * B]


@pytest.mark.parametrize("guard", [False, True])
def test_a_nan_batch_is_flagged_at_the_same_step(guard, monkeypatch, tmp_path):
    """A NaN in the third batch: both packages' health monitors flag the
    same step in the same words, and with the guard on both skip it and
    say so in the same ``step_skipped`` event."""
    got = {}
    for pkg, name in ((ff, "j"), (ft, "t")):
        path = tmp_path / f"{name}.jsonl"
        _traced(monkeypatch, path, FF_HEALTH=1, FF_HEALTH_SAMPLE_EVERY=2,
                **({"FF_SKIP_NONFINITE": 5} if guard else {}))
        m, inp = _mlp(pkg)
        rng = np.random.default_rng(2)
        for i in range(6):
            x = rng.standard_normal((B, 12), dtype=np.float32)
            if i == 2:
                x[1, 3] = np.nan
            m.set_batch({inp: x}, rng.integers(0, 6, (B, 1)).astype(np.int32))
            m.train_iteration()
        m.get_metrics()
        m.sync()
        (jax_events if pkg is ff else events).reset_active()
        got[name] = [(r["name"], r["attrs"]) for r in _records(path)
                     if r["name"] in ("health", "step_skipped")]
    assert got["t"] == got["j"]
    kinds = [a.get("kind", n) for n, a in got["t"]]
    assert "nonfinite_loss" in kinds and ("step_skipped" in kinds) == guard


# ---------------------------------------------------------------------------
# the port alone: the disabled path, losses, the capture ledger
# ---------------------------------------------------------------------------

def test_disabled_telemetry_makes_no_event_log_call(monkeypatch, tmp_path):
    """With telemetry off, compile, steps, the metric drain, a checkpoint,
    the data loader, a search, generate and the serving engine make no
    ``EventLog`` call at all."""
    def boom(*a, **kw):
        raise AssertionError("an EventLog method was called with telemetry off")
    for name in ("span", "span_at", "counter", "gauge", "event", "flush", "_write",
                 "add_observer", "__init__"):
        monkeypatch.setattr(events.EventLog, name, boom)
    m = ft.FFModel(_cfg(ft, search_budget=20))
    build_transformer(m, B, **SHAPE)
    _compile(ft, m)
    m.init_layers(seed=0)
    assert m._telemetry is None and m._stepstats is None
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, V, (2 * B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2 * B, 1))
    ins = {t: (tokens if t.name == "tokens" else pos) for t in m.input_tensors}
    loader = DataLoader(m, ins, rng.integers(0, V, (2 * B, S)).astype(np.int32))
    for _ in range(2):
        loader.next_batch(m)
        m.train_iteration()
    m.get_metrics()
    m.save(str(tmp_path / "ck"))
    m.load(str(tmp_path / "ck"))
    assert m.generate(tokens[:2, :3], 3).shape == (2, 3)
    with InferenceEngine(m, max_batch=2, max_seq=S, max_new_tokens=3) as eng:
        assert eng.submit([1, 2], 3).result(60).shape == (3,)


@pytest.mark.parametrize("env", [{"FF_TELEMETRY": 1},
                                 {"FF_TELEMETRY": 1, "FF_HEALTH": 1,
                                  "FF_HEALTH_SAMPLE_EVERY": 1, "FF_MEMPLANE": 1},
                                 {"FF_TELEMETRY": 1, "FF_HEALTH": 1, "FF_SKIP_NONFINITE": 3}])
def test_losses_are_bitwise_equal_with_telemetry_on_and_off(env, monkeypatch, tmp_path):
    """Telemetry reads the step; it never changes it: the loss of every
    step and every weight after them are bitwise the untraced run's."""
    def run():
        m = _lm(ft, seed=4)
        losses = []
        for i in range(5):
            _lm_batch(m, seed=i)
            m.train_iteration()
            m.get_metrics()
            losses.append(m.last_loss)
        m.sync()
        return losses, {k: m.get_parameter(*k) for k in
                        ((op.name, w.name) for op in m.ops for w in op.weights)}
    off_losses, off_w = run()
    monkeypatch.setenv("FF_TELEMETRY_FILE", str(tmp_path / "t.jsonl"))
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    on_losses, on_w = run()
    events.reset_active()
    assert on_losses == off_losses
    for k in off_w:
        np.testing.assert_array_equal(on_w[k], off_w[k], err_msg=str(k))
    assert len(_records(tmp_path / "t.jsonl", "step")) == 5


def _fake_graph_model(monkeypatch):
    """The compiled step's control flow on the CPU: fake CUDA graphs whose
    replay runs what they captured (tests/test_torch_step.py)."""
    _FakeCuda(monkeypatch)
    monkeypatch.setattr(ft.FFModel, "_use_graph",
                        lambda self: not self._sharded and graphs_enabled())

    def capture(self, step):
        self.graph = torch.cuda.CUDAGraph()  # the fake's: its replay runs the step
        self.graph.fn = step
        self.captures += 1
    monkeypatch.setattr(StepGraph, "_capture", capture)


def test_capture_ledger_counts_captures_and_retraces(monkeypatch, tmp_path):
    """FF_MEMPLANE on the compiled step: the eager first step and the
    capture are marked ``first`` (the capture also ``capture``), one
    capture is logged at ``train_step``, replays log nothing, and a batch
    of another shape (a new signature at the same site) is a retrace."""
    _fake_graph_model(monkeypatch)
    _traced(monkeypatch, tmp_path / "t.jsonl", FF_MEMPLANE=1)
    m, inp = _mlp(ft)
    assert m._memplane is not None
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((B, 12), dtype=np.float32), rng.integers(0, 6, (B, 1))
    m.set_batch({inp: x}, y.astype(np.int32))
    for _ in range(4):
        m.train_iteration()
    assert (m._memplane.compiles, m._memplane.retraces) == (1, 0)
    half = B // 2
    m.set_batch({inp: x[:half]}, y[:half].astype(np.int32))  # another signature
    for _ in range(2):
        m.train_iteration()
    m.sync()
    events.reset_active()
    done = _records(tmp_path / "t.jsonl", "compile_done")
    assert [(r["attrs"]["site"], r["attrs"]["retrace"]) for r in done] == \
        [("train_step", False), ("train_step", True)]
    assert done[0]["attrs"]["fingerprint"] != done[1]["attrs"]["fingerprint"]
    assert all(r["attrs"]["aot"] is False and "graph_pool_bytes" not in r["attrs"]
               for r in done)  # the CPU has no graph pool to measure
    retr = _records(tmp_path / "t.jsonl", "compile_retraces")
    assert [r["total"] for r in retr] == [0.0, 1.0]
    steps = [r["attrs"] for r in _records(tmp_path / "t.jsonl", "step")]
    assert [s["first"] for s in steps] == [True, True, False, False, True, True]
    assert [s.get("capture", False) for s in steps] == [False, True, False, False, False, True]


def test_decode_signatures_are_separate_sites(monkeypatch, tmp_path):
    """Each generate and beam_search signature captures at a site of its
    own (the beam's two graphs at two), so none of them is a retrace."""
    from flexflow_tpu_torch.runtime import decode_graph

    monkeypatch.setattr(decode_graph.DecodeGraph, "_use_graph", lambda self: graphs_enabled())
    monkeypatch.setattr(StepGraph, "_eager_on_side_stream", lambda self, step: step())

    class Graph:
        def __init__(self, step):
            self.replay = step

    def capture(self, step):
        self.graph = Graph(step)
        self.captures += 1
    monkeypatch.setattr(decode_graph.DecodeGraph, "_capture", capture)
    _traced(monkeypatch, tmp_path / "t.jsonl", FF_MEMPLANE=1)
    m = _lm(ft)
    prompt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    m.generate(prompt, 3)
    m.generate(prompt, 3)          # the same signature: replays only
    m.generate(prompt, 4)
    m.beam_search(prompt, 3, beam_size=2)
    events.reset_active()
    sites = [(r["attrs"]["site"], r["attrs"]["retrace"])
             for r in _records(tmp_path / "t.jsonl", "compile_done")]
    assert sites == [("generate:2x3x3", False), ("generate:2x3x4", False),
                     ("beam_search:2x3x3x2:prompt", False),
                     ("beam_search:2x3x3x2:expand", False)]


def test_memory_prediction_is_the_memory_model(monkeypatch, tmp_path):
    """``memory_predicted`` carries the port's ``memory_per_device`` terms
    against the H100's capacity."""
    _traced(monkeypatch, tmp_path / "t.jsonl")
    m = _lm(ft)
    events.reset_active()
    (ev,) = _records(tmp_path / "t.jsonl", "memory_predicted")
    mem = memory_per_device(m, None, machine_model=H100MachineModel.calibrated(num_devices=1))
    peak = mem["per_device"][mem["peak_device"]]
    a = ev["attrs"]
    assert a["terms"] == {k: peak[k] for k in
                          ("params", "grads", "optimizer", "activations", "staging")}
    assert (a["peak_bytes"], a["dominant_term"], a["capacity_bytes"]) == \
        (mem["peak_bytes"], mem["dominant_term"], int(80e9))
    (pred,) = _records(tmp_path / "t.jsonl", "sim_prediction")
    assert pred["attrs"]["predicted_step_ms"] == round(m._predicted_step_s * 1e3, 4) > 0


# ---------------------------------------------------------------------------
# the strategy search's flight recorder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,name,nd,budget,seed", [("mcmc", "alexnet", 4, 200, 1),
                                                         ("population", "alexnet", 4, 200, 1)])
def test_search_candidates_equal_the_jax_recorder(engine, name, nd, budget, seed, tmp_path,
                                                  monkeypatch, restricted_reference):  # noqa: F811
    """A seeded search that test_torch_search.py holds equal to the JAX
    package's records the same proposals: every ``search_candidate`` (and
    the population engine's exchanges, elites and crossovers) equal."""
    monkeypatch.setattr(jax_events, "_active", jax_events.EventLog(str(tmp_path / "j.jsonl")))
    monkeypatch.setattr(events, "_active", events.EventLog(str(tmp_path / "t.jsonl")))
    want, got = _search_pair(engine, name, nd, budget, seed, tmp_path)
    assert (got.best_s, got.dp_s) == (want.best_s, want.dp_s)
    jax_events._active.close()
    events._active.close()
    names = ("search_start", "search_candidate", "search_exchange", "search_elite",
             "search_crossover", "search_op_summary")

    def recs(path):
        return [(r["name"], r["attrs"]) for r in _records(path) if r["name"] in names]
    got_r, want_r = recs(tmp_path / "t.jsonl"), recs(tmp_path / "j.jsonl")
    assert len([r for r in got_r if r[0] == "search_candidate"]) == budget
    assert got_r == want_r
    spans = _records(tmp_path / "t.jsonl", f"{engine}_search")
    assert len(spans) == 1 and spans[0]["attrs"]["best_ms"] == round(got.best_s * 1e3, 3)


def test_exported_strategy_carries_the_provenance(tmp_path, monkeypatch):
    """compile(search_budget=...) exports a sidecar built by
    ``build_provenance``: the search, per-op costs and predicted memory,
    and the search trace's run id when telemetry is on."""
    from flexflow_tpu_torch.parallel.strategy import read_provenance

    _traced(monkeypatch, tmp_path / "t.jsonl")
    pb = str(tmp_path / "s.pb")
    m, _ = _mlp(ft, search_budget=30, export_strategy_file=pb)
    meta = read_provenance(pb)
    assert (meta["engine"], meta["budget"], meta["num_devices"]) == ("mcmc", 30, 1)
    assert set(meta["ops"]) == {op.name for op in m.ops} and meta["lowered"] is False
    assert meta["search_run_id"] == m._telemetry.run_id and meta["hbm_peak_bytes"] > 0
    events.reset_active()
    assert len(_records(tmp_path / "t.jsonl", "search_candidate")) == 30


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve_pair():
    shape = dict(seq_length=32, num_layers=1, embed_dim=16, num_heads=2, vocab_size=32)
    jm = ff.FFModel(_cfg(ff))
    jax_build_transformer(jm, B, **shape)
    _compile(ff, jm)
    jm.init_layers(seed=3)
    tm = ft.FFModel(_cfg(ft))
    build_transformer(tm, B, **shape)
    _compile(ft, tm)
    tm.init_layers(seed=3)
    load_jax_params(tm, jax_params_to_numpy(jm))
    return jm, tm


@pytest.mark.parametrize("paged", ["off", "on"])
def test_serving_records_match_the_jax_engine(paged, tmp_path, monkeypatch):
    """Each request's records (by trace id, in submission order) have the
    JAX engine's names and attribute keys, every request ends in one
    ``serve_request_done``, and the tokens are the untraced engine's."""
    monkeypatch.setenv("FF_TRACE_SAMPLE", "1")
    monkeypatch.setenv("FF_TRACE_CHUNK", "4")
    jm, tm = _serve_pair()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 32, int(rng.integers(3, 9))).astype(np.int32) for _ in range(5)]
    prompts.append(prompts[0].copy())   # a prefix hit in paged mode
    out = {}
    for name, Eng, model, mod in (("j", JaxEngine, jm, jax_events), ("t", InferenceEngine, tm,
                                                                      events)):
        log = mod.EventLog(str(tmp_path / f"{name}.jsonl"))
        eng = Eng(model, max_batch=2, max_seq=32, max_new_tokens=10, paged=paged,
                  telemetry=log)
        hs = [eng.submit(p, 10) for p in prompts]
        with eng:
            toks = [h.result(120) for h in hs]
        log.close()
        recs = _records(tmp_path / f"{name}.jsonl")
        per_req = [_signature([r for r in recs
                               if (r.get("attrs") or {}).get("trace_id") == h.trace.trace_id])
                   for h in hs]
        out[name] = (toks, per_req, _signature(r for r in recs if r["t"] == "counter"))
    for a, b in zip(out["t"][0], out["j"][0]):
        np.testing.assert_array_equal(a, b)
    assert out["t"][1] == out["j"][1]
    assert out["t"][2] == out["j"][2]
    done = [sig for sig in out["t"][1]
            if sig[("event", "serve_request_done",
                    tuple(sorted(("request_id", "status", "prompt_len", "new_tokens", "replica",
                                  "queue_wait_s", "ttft_s", "tpot_s", "trace_id",
                                  "parent_span_id"))))] == 1]
    assert len(done) == len(prompts)
    with InferenceEngine(tm, max_batch=2, max_seq=32, max_new_tokens=10, paged=paged) as eng:
        plain = [eng.submit(p, 10).result(120) for p in prompts]
    for a, b in zip(out["t"][0], plain):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# profiling, opprof, the metrics plane, runtime narration
# ---------------------------------------------------------------------------

def test_print_op_profile_and_the_profiler_trace(monkeypatch, tmp_path, capsys):
    """print_op_profile measures every op on the model's device (the CPU
    here) and, traced, emits one ``op_profile`` event per op beside its
    agreement row; trace() writes a torch.profiler Chrome trace."""
    from flexflow_tpu_torch.runtime import profiling

    _traced(monkeypatch, tmp_path / "t.jsonl")
    m, inp = _mlp(ft, profiling=True)
    m.print_op_profile()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[profiling]")]
    assert [ln.split(":")[0] for ln in lines] == [f"[profiling] {op.name}" for op in m.ops]
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("one step"):
            m.set_batch({inp: np.ones((B, 12), np.float32)}, np.zeros((B, 1), np.int32))
            m.train_iteration()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    events.reset_active()
    prof = _records(tmp_path / "t.jsonl", "op_profile")
    assert [r["attrs"]["op"] for r in prof] == [op.name for op in m.ops]
    assert all(r["attrs"]["forward_ms"] > 0 for r in prof)
    div = [r for r in _records(tmp_path / "t.jsonl", "sim_divergence")
           if r["attrs"]["scope"] == "op"]
    assert {r["attrs"]["measured_src"] for r in div} == {"standalone"}


def test_opprof_measures_on_its_cadence_and_writes_no_weight(monkeypatch, tmp_path):
    """FF_OPPROF=2: passes at steps 2 and 4, never at step 0; each op's
    forward and backward fragments are ``op_runtime`` events and corpus
    entries tagged with the device they ran on; the fragments leave the
    model's weights and optimizer state as they were."""
    corpus = tmp_path / "corpus.json"
    _traced(monkeypatch, tmp_path / "t.jsonl", FF_OPPROF=2, FF_OPPROF_CORPUS=corpus,
            FF_OPPROF_BUDGET_S=60)
    m = _lm(ft)
    _lm_batch(m)
    for _ in range(3):
        m.train_iteration()
    before = {k: t.detach().clone() for k, t in
              ((f"{o}/{n}", t) for o, ws in m._params.items() for n, t in ws.items())}
    m._opprof._run_pass(2)
    after = {f"{o}/{n}": t for o, ws in m._params.items() for n, t in ws.items()}
    for k, t in before.items():
        assert torch.equal(t, after[k]), k
    m.train_iteration()
    m.train_iteration()
    events.reset_active()
    passes = [r["attrs"] for r in _records(tmp_path / "t.jsonl", "op_runtime_pass")]
    assert [p["step"] for p in passes] == [2, 2, 4]
    rt = _records(tmp_path / "t.jsonl", "op_runtime")
    assert {r["attrs"]["op"] for r in rt} == {op.name for op in m.ops}
    mha = [r["attrs"] for r in rt if r["attrs"]["op"] == "attn_0"]
    assert {a["which"] for a in mha} == {"forward", "backward"}
    assert all(a["measured_ms"] > 0 for a in mha)
    with open(corpus) as f:
        entries = json.load(f)
    assert entries and all(e["platform"] == "cpu" and e["device"] == "cpu"
                           for e in entries.values())


def test_metrics_port_serves_training_series(monkeypatch, tmp_path):
    """FF_METRICS_PORT starts the exporter at compile; a scrape returns the
    step's series in Prometheus text."""
    _traced(monkeypatch, tmp_path / "t.jsonl", FF_METRICS_PORT=0,
            FF_METRICS_HOST="127.0.0.1")
    m = _lm(ft)
    _lm_batch(m)
    for _ in range(3):
        m.train_iteration()
    m.sync()
    port = metrics.server_port()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        assert r.status == 200
        text = r.read().decode()
    assert f"ff_samples_total {3 * B}" in text and "ff_mfu " in text
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/vars", timeout=30) as r:
        assert json.loads(r.read())["counters"]


def test_checkpoint_data_wait_and_retry_narration(monkeypatch, tmp_path):
    """checkpoint_save/restore and data_wait spans, one ckpt_retry event
    per retried attempt, and trace_report folds it all with one step span
    per step."""
    from flexflow_tpu_torch.runtime import checkpoint

    _traced(monkeypatch, tmp_path / "t.jsonl", FF_CKPT_BACKOFF_S=0)
    m, inp = _mlp(ft)
    rng = np.random.default_rng(0)
    loader = DataLoader(m, {inp: rng.standard_normal((2 * B, 12), dtype=np.float32)},
                        rng.integers(0, 6, (2 * B, 1)).astype(np.int32))
    for _ in range(2):
        loader.next_batch(m)
        m.train_iteration()
    write = checkpoint._write_npz
    fails = iter([OSError("disk full")])

    def flaky(flat, final):
        err = next(fails, None)
        if err is not None:
            raise err
        write(flat, final)
    monkeypatch.setattr(checkpoint, "_write_npz", flaky)
    m.save(str(tmp_path / "ck"))
    m.load(str(tmp_path / "ck"))
    events.reset_active()
    recs = _records(tmp_path / "t.jsonl")
    names = collections.Counter(r["name"] for r in recs)
    assert (names["checkpoint_save"], names["checkpoint_restore"], names["data_wait"],
            names["ckpt_retry"]) == (1, 1, 2, 1)
    (retry,) = [r["attrs"] for r in recs if r["name"] == "ckpt_retry"]
    assert (retry["site"], retry["attempt"]) == ("ckpt_save", 1)
    report = trace_report.render_report(trace_report.parse_trace(str(tmp_path / "t.jsonl")))
    assert "| checkpoint_save | 1 |" in report and "| data_wait | 2 |" in report
    assert "steady-state over 1 steps" in report and "first step (incl. compile)" in report


def test_memplane_needs_telemetry(monkeypatch):
    """FF_MEMPLANE without a log resolves to no ledger (nothing to log to)."""
    monkeypatch.setenv("FF_MEMPLANE", "1")
    assert memplane.maybe_plane(None) is None
