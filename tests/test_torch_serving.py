"""Continuous-batching serving in the port (flexflow_tpu_torch/serving/),
on the CPU: the counterparts of tests/test_serving.py and
tests/test_paged_kv.py.

The load-bearing claim is the JAX package's: admitting requests
mid-flight into a slot-based (dense or block-paged) kv pool is
transparent, so every request's greedy tokens equal a standalone
``FFModel.generate`` of its prompt, here the port's and the JAX
package's on the same weights (``convert.load_jax_params``).  Dense and
paged engines give the same tokens, a prefix hit the cold prefill's.

Every wait on a request has its own timeout, and no test sleeps for a
fixed time.  Telemetry, request tracing, the capture ledger and the
metrics endpoints serve; what the port does not have yet raises, naming
its ROADMAP item: the replica pool (A11), chaos faults (A10).  The decode graphs run here with fake CUDA graphs
whose replay runs the captured step again.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.models.transformer import build_transformer as jax_build_transformer
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
from flexflow_tpu_torch.models.transformer import build_transformer
from flexflow_tpu_torch.runtime import decode_graph
from flexflow_tpu_torch.runtime.step_graph import StepGraph, graphs_enabled
from flexflow_tpu_torch.serving import (InferenceRequest, RequestQueue, ServeConfig,
                                        ServeError, ServeTimeout)
from flexflow_tpu_torch.serving.engine import InferenceEngine
from flexflow_tpu_torch.serving.kvpool import BlockExhausted, KVBlockPool, blocks_for

V = 32          # vocab
MAX_SEQ = 64    # kv_block 16 -> 4 blocks per worst-case sequence
WAIT = 120      # seconds any one request may take
SHAPE = dict(seq_length=MAX_SEQ, num_layers=1, embed_dim=16, num_heads=2, vocab_size=V)


def _pair(seed=3):
    jm = ff.FFModel(ff.FFConfig(batch_size=4, workers_per_node=1))
    jax_build_transformer(jm, 4, **SHAPE)
    jm.compile(ff.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"],
               machine=ff.Machine(devices=jax.devices()[:1]))
    jm.init_layers(seed=seed)
    tm = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu"))
    build_transformer(tm, 4, **SHAPE)
    tm.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    tm.init_layers(seed=seed)
    load_jax_params(tm, jax_params_to_numpy(jm))
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    # untrained is fine: equivalence needs determinism, not accuracy
    return _pair()


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def _prompts(n, seed=0, lo=3, hi=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=int(rng.integers(lo, hi + 1))).astype(np.int32)
            for _ in range(n)]


def _want(model, prompt, n):
    return model.generate(prompt[None], n)[0]


def _results(handles):
    return [h.result(WAIT) for h in handles]


# ---------------------------------------------------------------------------
# config / queue units
# ---------------------------------------------------------------------------

def test_serve_config_env_and_buckets(monkeypatch):
    monkeypatch.setenv("FF_SERVE_MAX_BATCH", "3")
    monkeypatch.setenv("FF_SERVE_MAX_SEQ", "48")
    monkeypatch.setenv("FF_SERVE_BUCKETS", "4,16")
    monkeypatch.setenv("FF_SERVE_QUEUE_TIMEOUT", "2.5")
    cfg = ServeConfig.from_env()
    assert (cfg.max_batch, cfg.max_seq) == (3, 48)
    assert cfg.resolved_buckets() == (4, 16)
    assert cfg.bucket_for(4) == 4 and cfg.bucket_for(5) == 16
    assert cfg.bucket_for(17) is None
    assert cfg.queue_timeout_s == 2.5
    assert ServeConfig.from_env(max_batch=9).max_batch == 9  # an override beats the env
    assert ServeConfig(max_seq=64).resolved_buckets() == (8, 16, 32)


def test_serve_config_rejects_bad_env(monkeypatch):
    monkeypatch.setenv("FF_SERVE_MAX_BATCH", "zero")
    with pytest.raises(ValueError, match="FF_SERVE_MAX_BATCH"):
        ServeConfig.from_env()
    monkeypatch.delenv("FF_SERVE_MAX_BATCH")
    monkeypatch.setenv("FF_SERVE_BUCKETS", "16,8")
    with pytest.raises(ValueError, match="ascending"):
        ServeConfig.from_env()
    monkeypatch.delenv("FF_SERVE_BUCKETS")
    with pytest.raises(ValueError, match="no room"):
        ServeConfig(max_seq=16, buckets=(16,))


POOL_KNOBS = [("FF_SERVE_REPLICAS", "replicas", "4", 4),
              ("FF_SERVE_MAX_QUEUE", "max_queue", "64", 64),
              ("FF_SERVE_SHED_WAIT_S", "shed_wait_s", "2.5", 2.5),
              ("FF_SERVE_REPLICA_TIMEOUT", "replica_timeout_s", "3", 3.0),
              ("FF_SERVE_HEDGE_MS", "hedge_ms", "50", 50.0),
              ("FF_SERVE_RESTART_BACKOFF_S", "restart_backoff_s", "1", 1.0),
              ("FF_SERVE_RESTART_CAP_S", "restart_cap_s", "60", 60.0),
              ("FF_SERVE_ZONES", "zones", "zone-a,zone-b", ("zone-a", "zone-b"))]


@pytest.mark.parametrize("var,field,raw,value", POOL_KNOBS,
                         ids=[k[0] for k in POOL_KNOBS])
def test_pool_knobs_raise_until_the_pool_is_ported(monkeypatch, var, field, raw, value):
    """Only the replica pool reads these knobs (ROADMAP A11): set away from
    its default, each is refused from the env and as a field, never
    silently ignored; at its default it is accepted, and a malformed value
    is still a ValueError naming the variable."""
    monkeypatch.setenv(var, raw)
    with pytest.raises(NotImplementedError, match=f"{var}.*ROADMAP A11"):
        ServeConfig.from_env()
    monkeypatch.delenv(var)
    with pytest.raises(NotImplementedError, match=f"ServeConfig.{field}.*ROADMAP A11"):
        ServeConfig(**{field: value})
    default = getattr(ServeConfig(), field)
    assert getattr(ServeConfig(**{field: default}), field) == default
    if field != "zones":
        monkeypatch.setenv(var, "x")
        with pytest.raises(ValueError, match=var):
            ServeConfig.from_env()


def test_request_queue_priority_and_expiry():
    q = RequestQueue()
    a = InferenceRequest([1], 4, priority=0)
    b = InferenceRequest([1], 4, priority=5)
    c = InferenceRequest([1], 4, priority=1, timeout_s=0.0001)
    for r in (a, b, c):
        q.put(r)
    now = c.t_submit + 0.01  # a clock past c's deadline, without sleeping
    assert q.pop_ready(now) is b           # highest priority first
    assert q.expire(now) == 1              # c expired while queued
    assert c.status == "timeout"
    with pytest.raises(ServeTimeout):
        c.result(0)
    assert q.pop_ready(now) is a
    assert q.pop_ready(now) is None


# ---------------------------------------------------------------------------
# engine core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", ["off", "on"])
def test_greedy_equivalence_and_occupancy(pair, paged):
    """8 mixed-length requests (the first four queued before the loop runs,
    the rest while it runs): every output equals a one-shot generate() of
    its prompt in the port and in the JAX package, and the batch really
    batched (mean occupancy > 1.5)."""
    jm, tm = pair
    prompts = _prompts(8, seed=1)
    news = [6, 16, 4, 12, 9, 15, 8, 10]
    eng = InferenceEngine(tm, max_batch=4, max_seq=MAX_SEQ, max_new_tokens=32, paged=paged)
    assert eng._paged == (paged == "on")
    handles = [eng.submit(p, n) for p, n in zip(prompts[:4], news[:4])]
    with eng:
        handles += [eng.submit(p, n) for p, n in zip(prompts[4:], news[4:])]
        outs = _results(handles)
    for p, n, out in zip(prompts, news, outs):
        np.testing.assert_array_equal(out, _want(tm, p, n), err_msg=str(p.tolist()))
        np.testing.assert_array_equal(out, jm.generate(p[None], n)[0])
    st = eng.stats()
    assert st["completed"] == 8
    assert st["mean_occupancy"] > 1.5, st
    assert st["graphs_captured"] == 0  # the CPU runs eagerly


def test_slot_reuse_after_completion(model):
    """6 requests through 2 slots: every slot is recycled mid-flight."""
    eng = InferenceEngine(model, max_batch=2, max_seq=MAX_SEQ, max_new_tokens=16)
    with eng:
        _results([eng.submit(p, 5) for p in _prompts(6, seed=2)])
    st = eng.stats()
    assert st["admitted"] == 6 and st["completed"] == 6
    assert st["max_active"] <= 2
    assert all(s is None for s in eng._slots)


@pytest.mark.parametrize("paged", ["off", "on"])
def test_bucketed_prefill_no_retrace(model, paged):
    """Prompt lengths 3, 4, 5, 7, 8 fall in buckets {4, 8}: two prefill
    signatures, as the JAX package's two compiles (the port replays one
    B = 1 prefill graph for every bucket)."""
    eng = InferenceEngine(model, max_batch=2, max_seq=MAX_SEQ, buckets=(4, 8),
                          max_new_tokens=8, paged=paged)
    rng = np.random.default_rng(5)
    with eng:
        _results([eng.submit(rng.integers(0, V, size=n).astype(np.int32), 3)
                  for n in (3, 4, 5, 7, 8)])
    # paged signatures key on (gather bucket, suffix bucket); cold
    # admissions gather nothing
    want = [(0, 4), (0, 8)] if paged == "on" else [4, 8]
    assert sorted(eng._prefill_keys) == want
    assert eng.stats()["prefill_compiles"] == 2


def test_queue_timeout_and_priority_order(model):
    eng = InferenceEngine(model, max_batch=1, max_seq=MAX_SEQ, max_new_tokens=32)
    prompts = _prompts(4, seed=7)
    # submitted before start: admission order is (priority desc, arrival
    # asc), serialized by max_batch=1
    slow = eng.submit(prompts[0], 24, priority=10)
    low = eng.submit(prompts[1], 3, priority=0)
    high = eng.submit(prompts[2], 3, priority=5)
    doomed = eng.submit(prompts[3], 3, timeout_s=0.001)
    with eng:
        _results([slow, low, high])
        with pytest.raises(ServeTimeout):
            doomed.result(WAIT)
    assert doomed.status == "timeout"
    assert slow.admit_seq < high.admit_seq < low.admit_seq
    assert eng.stats()["timeouts"] == 1


def test_eos_stops_early(model):
    prompt = _prompts(1, seed=11)[0]
    want = _want(model, prompt, 8)
    eos = int(want[2])
    stop = int(np.argmax(want == eos))     # first occurrence, inclusive
    eng = InferenceEngine(model, max_batch=1, max_seq=MAX_SEQ, max_new_tokens=8)
    with eng:
        out = eng.submit(prompt, 8, eos_id=eos).result(WAIT)
    np.testing.assert_array_equal(out, want[:stop + 1])


def test_submit_validation(model):
    eng = InferenceEngine(model, max_batch=1, max_seq=16, buckets=(8,), max_new_tokens=16)
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(np.arange(9, dtype=np.int32), 2)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(np.arange(8, dtype=np.int32), 16)
    with pytest.raises(ValueError, match="exceeds the engine cap"):
        eng.submit([1, 2], 17)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], 2)


def test_engine_rejects_extra_graph_inputs():
    """A third graph input (seq2seq-style) cannot be fed one token at a
    time: the engine refuses at construction."""
    m2 = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu"))
    toks = m2.create_tensor((4, 8), dtype="int32", nchw=False, name="toks")
    pos = m2.create_tensor((4, 8), dtype="int32", nchw=False, name="pos")
    seg = m2.create_tensor((4, 8), dtype="int32", nchw=False, name="seg")
    x = m2.add(m2.embedding(toks, V, 16, aggr=ft.AggrMode.NONE, name="e1"),
               m2.embedding(pos, 8, 16, aggr=ft.AggrMode.NONE, name="e2"), name="a1")
    x = m2.add(x, m2.embedding(seg, 4, 16, aggr=ft.AggrMode.NONE, name="e3"), name="a2")
    m2.softmax(m2.dense(x, V, name="head"), name="sm")
    m2.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    m2.init_layers(seed=0)
    with pytest.raises(ValueError, match="extra graph input"):
        InferenceEngine(m2, max_batch=1, max_seq=8)


def test_stop_cancels_outstanding(model):
    eng = InferenceEngine(model, max_batch=1, max_seq=MAX_SEQ, max_new_tokens=32)
    eng.start()
    hs = [eng.submit(p, 24) for p in _prompts(3, seed=13)]
    hs[0].result(WAIT)
    eng.stop(drain=False)
    for h in hs[1:]:
        if not h.done() or h.status != "done":
            with pytest.raises(ServeError):
                h.result(5)
    with pytest.raises(ServeError, match="not accepting"):
        eng.submit([1, 2], 2)


# ---------------------------------------------------------------------------
# what the port does not have yet raises, naming its ROADMAP item
# ---------------------------------------------------------------------------

def test_serve_chaos_error_isolated(model, monkeypatch):
    """The JAX package fails the FF_CHAOS ``serve`` site's request alone;
    the port has no chaos injection yet and refuses it."""
    monkeypatch.setenv("FF_CHAOS", "serve:2=error")
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        InferenceEngine(model, max_batch=1, max_seq=MAX_SEQ)


@pytest.mark.parametrize("how", ["telemetry", "FF_TRACE_SAMPLE", "FF_MEMPLANE"])
def test_serve_report_empty_trace(model, monkeypatch, tmp_path, how):
    """The engine's telemetry, request tracing and capture ledger: an
    engine that served nothing leaves an empty trace, which the port's
    trace_report folds; each request it serves then ends in one
    ``serve_request_done`` carrying its trace id.  A sampled trace
    (FF_TRACE_SAMPLE=1) adds decode-chunk spans under the request's root;
    FF_MEMPLANE puts every decode graph's capture (fake graphs here) in
    the ledger, with no retrace after warmup()."""
    from flexflow_tpu_torch.observability.events import EventLog
    from flexflow_tpu_torch.tools import trace_report

    path = tmp_path / "serve.jsonl"
    log = EventLog(str(path))
    if how != "telemetry":
        monkeypatch.setenv(how, "1")
    if how == "FF_MEMPLANE":
        monkeypatch.setattr(decode_graph.DecodeGraph, "_use_graph",
                            lambda self: graphs_enabled())
        monkeypatch.setattr(StepGraph, "_eager_on_side_stream", lambda self, step: step())

        class Graph:
            def __init__(self, step):
                self.replay = step

        def capture(self, step):
            self.graph = Graph(step)
            self.captures += 1
        monkeypatch.setattr(decode_graph.DecodeGraph, "_capture", capture)
    eng = InferenceEngine(model, max_batch=2, max_seq=MAX_SEQ, max_new_tokens=12,
                          telemetry=log)
    assert "(no span/counter records in trace)" in trace_report.render_report([])
    captured = eng.warmup() if how == "FF_MEMPLANE" else 0
    prompts = _prompts(3, seed=23)
    with eng:
        outs = _results([eng.submit(p, 12) for p in prompts])
    log.close()
    for p, got in zip(prompts, outs):
        np.testing.assert_array_equal(got, _want(model, p, 12))
    recs = trace_report.parse_trace(str(path))
    done = [r for r in recs if r.get("name") == "serve_request_done"]
    assert len(done) == 3 and len({r["attrs"]["trace_id"] for r in done}) == 3
    chunks = [r for r in recs if r.get("name") == "serve_decode_chunk"]
    assert bool(chunks) == (how == "FF_TRACE_SAMPLE")
    if chunks:
        assert all("parent_span_id" in r["attrs"] for r in chunks + done)
    compiles = [r for r in recs if r.get("name") == "compile_done"]
    assert len(compiles) == captured
    assert not any(r["attrs"]["retrace"] for r in compiles)


@pytest.mark.parametrize("name", ["ReplicaPool", "Autoscaler", "ScaleConfig"])
def test_refcounts_zero_after_chaos_replica_kill(name):
    """The replica pool (and its autoscaler) are not ported yet."""
    import flexflow_tpu_torch.serving as serving

    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        getattr(serving, name)


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

def _post(url, payload, timeout=WAIT):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_http_roundtrip_ephemeral_port(model):
    from flexflow_tpu_torch.serving.api import ServingAPI

    eng = InferenceEngine(model, max_batch=2, max_seq=MAX_SEQ, max_new_tokens=16)
    prompt = _prompts(1, seed=19)[0]
    with eng, ServingAPI(eng, port=0) as api:
        out = _post(f"{api.url}/generate", {"prompt": [int(t) for t in prompt],
                                            "max_new_tokens": 6})
        np.testing.assert_array_equal(np.asarray(out["tokens"], np.int32),
                                      _want(model, prompt, 6))
        assert out["prompt_len"] == prompt.size and out["ttft_s"] > 0
        with urllib.request.urlopen(f"{api.url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["completed"] >= 1
        with urllib.request.urlopen(f"{api.url}/readyz", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read())["ready"] is True
        for payload in ({"max_new_tokens": 4}, {"prompt": [1], "temperature": 0.7}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"{api.url}/generate", payload)
            assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{api.url}/nope", timeout=30)
        assert ei.value.code == 404
        # the metrics plane: the backend's live state without FF_METRICS_PORT
        with urllib.request.urlopen(f"{api.url}/metrics", timeout=30) as r:
            assert r.status == 200
            text = r.read().decode()
        assert "ff_serve_queue_depth" in text and "ff_serve_active" in text
        with urllib.request.urlopen(f"{api.url}/debug/vars", timeout=30) as r:
            assert r.status == 200
            dv = json.loads(r.read())
        assert dv["disabled"] is True and dv["backend"]["completed"] >= 1


# ---------------------------------------------------------------------------
# paged KV: the pool's accounting
# ---------------------------------------------------------------------------

def test_kvpool_reserve_release_accounting():
    pool = KVBlockPool(9, 16, bytes_per_block=1024)  # 8 usable + the sink
    toks = list(range(40))                           # 3 blocks
    res = pool.reserve(toks, max_new=10)             # worst case 4
    assert len(res.table()) == blocks_for(40, 16) == 3
    assert res.promised == 1
    pool.register_prefix(toks, res)
    pool.extend(res, pos=48)                         # crosses into block 4
    assert len(res.table()) == 4
    pool.release(res)
    assert pool.slot_refs() == 0
    st = pool.stats()
    assert st["blocks_promised"] == 0
    assert st["index_entries"] >= 1 and st["blocks_used"] >= 2
    res2 = pool.reserve(toks, max_new=10)            # the exact-prompt entry
    assert res2.hit_tokens > 0 and pool.stats()["prefix_hits"] == 1
    pool.end_gather(res2)
    pool.release(res2)
    assert pool.slot_refs() == 0


def test_kvpool_exhaustion_sheds_not_crashes():
    pool = KVBlockPool(3, 16, bytes_per_block=64)    # 2 usable blocks
    with pytest.raises(BlockExhausted):
        pool.check_room(40, 10)
    ok = pool.reserve(list(range(16)), max_new=8)
    with pytest.raises(BlockExhausted) as ei:
        pool.reserve(list(range(100, 116)), max_new=8)
    assert ei.value.retry_after_s > 0
    assert pool.stats()["sheds"] >= 1
    pool.release(ok)
    assert pool.slot_refs() == 0


# ---------------------------------------------------------------------------
# paged KV: transparency, prefix reuse, copy-on-write, exhaustion
# ---------------------------------------------------------------------------

def test_paged_greedy_parity_mixed_lengths(model):
    """Paged and dense engines give equal tokens for every request, and
    both equal generate(); the paged pool leaks nothing."""
    prompts = _prompts(8, seed=1, lo=3, hi=28)
    news = [6, 16, 4, 12, 9, 15, 8, 10]
    outs = {}
    for paged in ("on", "off"):
        eng = InferenceEngine(model, max_batch=4, max_seq=MAX_SEQ, max_new_tokens=32,
                              paged=paged)
        hs = [eng.submit(p, n) for p, n in zip(prompts, news)]
        with eng:
            outs[paged] = _results(hs)
        if paged == "on":
            st = eng.stats()
            assert st["paged"] and st["kv"]["blocks_peak"] > 0
            assert st["kv"]["blocks_promised"] == 0 and eng._kvpool.slot_refs() == 0
    for i, (p, n) in enumerate(zip(prompts, news)):
        np.testing.assert_array_equal(outs["on"][i], outs["off"][i])
        np.testing.assert_array_equal(outs["on"][i], _want(model, p, n), err_msg=str(i))


def test_admission_transfers_only_prompt_blocks(model):
    """An 8-token prompt moves its one block into the pool (the JAX
    package's scatter moves the suffix bucket's ceil(8/16) + 1 = 2, the
    extra one into the garbage block); a dense insert moves a whole
    max_seq row, 4 blocks' worth."""
    p = np.arange(8, dtype=np.int32) % V
    eng = InferenceEngine(model, max_batch=2, max_seq=MAX_SEQ, max_new_tokens=8)
    with eng:
        out = eng.submit(p, 6).result(WAIT)
    np.testing.assert_array_equal(out, _want(model, p, 6))
    st = eng.stats()["kv"]
    bpb = eng._kvpool.bytes_per_block
    assert bpb == 2 * 2 * 16 * 8 * 4  # k and v, 2 heads x 16 positions x 8, f32
    assert st["transferred_blocks"] == blocks_for(8, 16) == 1
    assert st["transferred_bytes"] == bpb < (MAX_SEQ // st["block_size"]) * bpb


def test_prefix_hit_bitwise_identical_to_cold_prefill(model):
    p = _prompts(1, seed=7, lo=24, hi=24)[0]        # 1 full + 1 partial block
    eng = InferenceEngine(model, max_batch=2, max_seq=MAX_SEQ, max_new_tokens=16)
    with eng:
        cold = eng.submit(p, 10).result(WAIT)       # registers the prefix
        warm = eng.submit(p, 10).result(WAIT)       # gathers it back
        st = eng.stats()["kv"]
    np.testing.assert_array_equal(cold, _want(model, p, 10))
    np.testing.assert_array_equal(warm, cold)
    assert st["prefix_hits"] >= 1 and st["prefix_hit_rate"] > 0
    assert st["prefill_tokens_saved"] > 0
    assert st["gathered_blocks"] >= 1


def test_cow_divergence_after_shared_prefix(model):
    """Continuations that hit a prompt ending mid-block share its full
    block and copy the partial tail before writing their own suffix; the
    donor's tokens never bleed into a sharer's output."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, V, size=24).astype(np.int32)
    ext_a = np.concatenate([base, np.array([1, 2], np.int32)])
    ext_b = np.concatenate([base, np.array([3], np.int32)])
    eng = InferenceEngine(model, max_batch=2, max_seq=MAX_SEQ, max_new_tokens=16)
    outs = {}
    with eng:
        for key, prompt in (("base", base), ("a", ext_a), ("b", ext_b), ("base2", base)):
            outs[key] = eng.submit(prompt, 12).result(WAIT)
        st = eng.stats()["kv"]
    for key, prompt in (("base", base), ("a", ext_a), ("b", ext_b), ("base2", base)):
        np.testing.assert_array_equal(outs[key], _want(model, prompt, 12), err_msg=key)
    np.testing.assert_array_equal(outs["base2"], outs["base"])
    assert st["prefix_hits"] >= 3
    assert st["cow_copies"] >= 1, "the partial-tail share was never copied"
    assert eng._kvpool.slot_refs() == 0


def test_block_exhaustion_503_retry_after_no_leak(model):
    from flexflow_tpu_torch.serving.api import ServingAPI

    # 2 usable blocks: one 20-token prompt and its promise take both, so a
    # concurrent admission sheds at submit, not mid-decode
    eng = InferenceEngine(model, max_batch=2, max_seq=MAX_SEQ, max_new_tokens=8, kv_blocks=2)
    p_big = np.arange(20, dtype=np.int32) % V       # ceil(28/16) = 2
    with eng, ServingAPI(eng, port=0) as api:
        h = eng.submit(p_big, 8)
        body = json.dumps({"prompt": [int(t) for t in p_big], "max_new_tokens": 8}).encode()
        req = urllib.request.Request(f"{api.url}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        err = ei.value
        assert err.code == 503 and int(err.headers["Retry-After"]) >= 1
        detail = json.loads(err.read()).get("error", "")
        assert detail.startswith("kv blocks exhausted"), detail
        np.testing.assert_array_equal(h.result(WAIT), _want(model, p_big, 8))
        # drained: every block returned, and the same prompt admits again
        assert eng._kvpool.slot_refs() == 0
        np.testing.assert_array_equal(eng.submit(p_big, 8).result(WAIT),
                                      _want(model, p_big, 8))
    st = eng.stats()["kv"]
    assert st["sheds"] >= 1 and st["blocks_promised"] == 0
    assert eng._kvpool.slot_refs() == 0


def test_paged_outadmits_dense_at_equal_budget(model):
    """The dense equivalent of max_batch=2 is 8 blocks; with short prompts
    the paged engine keeps 4 sequences live on that budget."""
    eng = InferenceEngine(model, max_batch=4, max_seq=MAX_SEQ, max_new_tokens=8, kv_blocks=8)
    prompts = _prompts(6, seed=5, lo=4, hi=10)
    hs = [eng.submit(p, 8) for p in prompts]
    with eng:
        outs = _results(hs)
    for i, (p, got) in enumerate(zip(prompts, outs)):
        np.testing.assert_array_equal(got, _want(model, p, 8), err_msg=str(i))
    assert eng.stats()["max_active"] >= 4 > 2
    assert eng._kvpool.slot_refs() == 0


# ---------------------------------------------------------------------------
# the engine's decode graphs, with fake CUDA graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", ["off", "on"])
def test_warmup_captures_every_graph_and_serving_captures_none(model, paged, monkeypatch):
    """warmup() captures the prefill step and one step per window of the
    ladder (1, 2, 4 blocks); serving then only replays, and the tokens are
    the eager engine's."""
    monkeypatch.setattr(decode_graph.DecodeGraph, "_use_graph", lambda self: graphs_enabled())
    monkeypatch.setattr(StepGraph, "_eager_on_side_stream", lambda self, step: step())

    class Graph:
        def __init__(self, step):
            self.replay = step

    def capture(self, step):
        self.graph = Graph(step)
        self.captures += 1
    monkeypatch.setattr(decode_graph.DecodeGraph, "_capture", capture)
    prompts = _prompts(6, seed=3, lo=3, hi=30)
    eng = InferenceEngine(model, max_batch=4, max_seq=MAX_SEQ, max_new_tokens=16, paged=paged)
    assert eng.warmup() == 1 + 3
    hs = [eng.submit(p, 16) for p in prompts]
    with eng:
        outs = _results(hs)
    assert eng.stats()["graphs_captured"] == 4
    with pytest.raises(RuntimeError, match="before start"):
        eng.start()
        try:
            eng.warmup()
        finally:
            eng.stop()
    for p, got in zip(prompts, outs):
        np.testing.assert_array_equal(got, _want(model, p, 16))
