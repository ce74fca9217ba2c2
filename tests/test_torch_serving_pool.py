"""The replica pool in the port (flexflow_tpu_torch/serving/pool.py), on
the CPU: the counterparts of tests/test_serving_pool.py, of
test_paged_kv.py's refcount check across a replica kill and of
test_reqtrace.py's failover trace, and one run of both packages' pools on
the same weights.

The load-bearing claims are the JAX package's: losing a replica degrades
throughput, never correctness (every request, the killed replica's in
flight ones included, resolves once with tokens bitwise equal to
``FFModel.generate``); admission control sheds with ``ServeOverload``
(503 + Retry-After); SIGTERM drains.  Replicas here share one CPU model,
each engine thread-isolated; on a card they share it the same way.

Every wait is bounded (``result(timeout=...)`` or a deadline), every
pool is stopped by its ``with`` block or a ``finally``, and the pool's
threads are daemons.
"""

import collections
import signal
import time

import numpy as np
import pytest

import jax

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.models.transformer import build_transformer as jax_build_transformer
from flexflow_tpu.serving import ServeConfig as JaxServeConfig
from flexflow_tpu.serving.pool import ReplicaPool as JaxReplicaPool
from flexflow_tpu.testing.chaos import ChaosMonkey as JaxChaosMonkey
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
from flexflow_tpu_torch.models.transformer import build_transformer
from flexflow_tpu_torch.observability import events
from flexflow_tpu_torch.runtime.resilience import PreemptionHandler, backoff_delay
from flexflow_tpu_torch.serving import ServeConfig, ServeError, ServeOverload
from flexflow_tpu_torch.serving.pool import ReplicaPool
from flexflow_tpu_torch.serving.queue import DONE
from flexflow_tpu_torch.testing.chaos import ChaosMonkey
from flexflow_tpu_torch.tools import trace_report

V = 32          # vocab
MAX_SEQ = 64
WAIT = 120      # seconds any one request may take
SHAPE = dict(seq_length=MAX_SEQ, num_layers=1, embed_dim=16, num_heads=2, vocab_size=V)


def _make_model(seed=3):
    m = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu"))
    build_transformer(m, 4, **SHAPE)
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=seed)
    return m


@pytest.fixture(scope="module")
def model():
    return _make_model()


def _prompts(n, seed=0, lo=3, hi=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=int(rng.integers(lo, hi + 1))).astype(np.int32)
            for _ in range(n)]


def _cfg(cls=ServeConfig, **kw):
    # a generous replica_timeout: a slow first prefill must not read as a
    # wedged replica
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("replica_timeout_s", 120.0)
    kw.setdefault("restart_backoff_s", 0.05)
    kw.setdefault("restart_cap_s", 0.2)
    return cls(**kw)


def _until(cond, timeout=30.0, every=0.005):
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() >= deadline:
            return False
        time.sleep(every)
    return True


# ---------------------------------------------------------------------------
# N=1 parity: a pool of one behaves like the bare engine
# ---------------------------------------------------------------------------

def test_pool_n1_matches_generate(model):
    prompts = _prompts(5, seed=1)
    with ReplicaPool(model, config=_cfg(replicas=1)) as pool:
        outs = [h.result(WAIT) for h in [pool.submit(p, 8) for p in prompts]]
    for p, got in zip(prompts, outs):
        np.testing.assert_array_equal(got, model.generate(p[None], 8)[0])
    st = pool.stats()
    assert st["completed"] == 5
    assert st["failovers"] == 0 and st["shed"] == 0 and st["hedged"] == 0


# ---------------------------------------------------------------------------
# failover: kill a replica mid-load, everything still resolves exactly once
# ---------------------------------------------------------------------------

def test_pool_failover_exactly_once(model, monkeypatch):
    # the 3rd pool-wide admission raises ChaosReplicaKill inside whichever
    # replica pops it: that loop dies holding a mid-admit request and
    # possibly a live slot
    monkeypatch.setattr(model, "_chaos", ChaosMonkey("serve:3=replica_kill"))
    prompts = _prompts(8, seed=2)
    fires = collections.Counter()
    with ReplicaPool(model, config=_cfg(replicas=3)) as pool:
        handles = [pool.submit(p, 8) for p in prompts]
        for h in handles:
            h.add_done_callback(lambda r: fires.update([r.request_id]))
        outs = [h.result(WAIT) for h in handles]
        st = pool.stats()
    for i, (p, got) in enumerate(zip(prompts, outs)):
        np.testing.assert_array_equal(got, model.generate(p[None], 8)[0], err_msg=str(i))
    assert st["replica_downs"] >= 1, st
    assert st["failovers"] >= 1, "the kill never caught a request in flight"
    assert st["completed"] == 8, st
    # exactly once: each client fires its done callbacks a single time
    assert len(fires) == 8 and set(fires.values()) == {1}, fires
    assert not pool._attempts and not pool._clients


def test_pool_single_replica_restart_serves_queued(model, monkeypatch):
    # N=1 and the only replica dies: the failover attempt can only be
    # served by the RESTARTED incarnation (avoid = the dead uid), and
    # healthz narrates down -> ok on the way
    monkeypatch.setattr(model, "_chaos", ChaosMonkey("serve:1=replica_kill"))
    p = _prompts(1, seed=4)[0]
    with ReplicaPool(model, config=_cfg(replicas=1, restart_backoff_s=0.4,
                                        restart_cap_s=1.0)) as pool:
        assert pool.ready()
        h = pool.submit(p, 6)
        assert _until(lambda: pool.healthz()["status"] == "down"), \
            "replica death never surfaced in healthz"
        assert not pool.ready()     # the LB signal drops with it
        np.testing.assert_array_equal(h.result(WAIT), model.generate(p[None], 6)[0])
        assert _until(lambda: pool.healthz()["status"] == "ok" and pool.ready())
        st = pool.stats()
        assert st["replica_downs"] == 1 and st["replica_restarts"] == 1
    assert pool.healthz()["status"] == "stopped"


def test_refcounts_zero_after_chaos_replica_kill(model, monkeypatch):
    """The dying loop releases every KV reservation it holds (live slots
    and the mid-admit request) before the pool fails its work over; the
    restarted incarnations end clean too, and the dead one dropped its
    caches and graphs."""
    monkeypatch.setattr(model, "_chaos", ChaosMonkey("serve:3=replica_kill"))
    prompts = _prompts(8, seed=2)
    engines = []
    with ReplicaPool(model, config=_cfg(replicas=2)) as pool:
        engines.extend(r.engine for r in pool._replicas)
        outs = [h.result(WAIT) for h in [pool.submit(p, 8) for p in prompts]]
        st = pool.stats()
        assert _until(lambda: pool.stats()["replica_restarts"] >= 1)
        engines.extend(r.engine for r in pool._replicas)
    for i, (p, got) in enumerate(zip(prompts, outs)):
        np.testing.assert_array_equal(got, model.generate(p[None], 8)[0], err_msg=str(i))
    assert st["replica_downs"] >= 1 and st["completed"] == 8
    seen = {id(e): e for e in engines if e is not None}
    assert len(seen) >= 3, "expected at least one restarted incarnation"
    for e in seen.values():
        assert e._paged
        assert e._kvpool.slot_refs() == 0, e.uid
        assert e._kvpool.stats()["blocks_promised"] == 0, e.uid
    dead = [e for e in seen.values() if e.crashed is not None]
    assert len(dead) == 1 and dead[0]._caches is None and not dead[0]._step_graphs


# ---------------------------------------------------------------------------
# admission control: shed with 503 + Retry-After, keep the accepted tail
# ---------------------------------------------------------------------------

def test_pool_shedding_503_retry_after(model):
    pool = ReplicaPool(model, config=_cfg(replicas=1, max_batch=1, max_queue=2))
    accepted, sheds = [], []
    with pool:
        for p in _prompts(10, seed=5):
            try:
                accepted.append((p, pool.submit(p, 24)))
            except ServeOverload as e:
                sheds.append(e)
        for p, h in accepted:
            np.testing.assert_array_equal(h.result(WAIT), model.generate(p[None], 24)[0])
    assert sheds, "FF_SERVE_MAX_QUEUE never shed under a 10-request burst"
    assert all(e.retry_after_s >= 1.0 for e in sheds)
    st = pool.stats()
    assert st["shed"] == len(sheds)
    assert st["completed"] == len(accepted) == 10 - len(sheds)
    # accepted requests wait behind a bounded queue, not the whole burst
    e2e = sorted(h.t_done - h.t_submit for _, h in accepted)
    assert e2e[-1] < 60.0, f"accepted p99 unbounded: {e2e[-1]:.1f}s"


def test_pool_unbounded_queue_never_sheds(model):
    with ReplicaPool(model, config=_cfg(replicas=1, max_batch=1)) as pool:
        for h in [pool.submit(p, 8) for p in _prompts(6, seed=6)]:
            h.result(WAIT)
    assert pool.stats()["shed"] == 0


# ---------------------------------------------------------------------------
# hedging: winner takes the client, loser is cancelled
# ---------------------------------------------------------------------------

def test_pool_hedge_winner_takes_all(model):
    p = _prompts(1, seed=7, lo=3, hi=6)[0]
    with ReplicaPool(model, config=_cfg(replicas=2, hedge_ms=10.0)) as pool:
        h = pool.submit(p, 32)
        np.testing.assert_array_equal(h.result(WAIT), model.generate(p[None], 32)[0])
        st = pool.stats()
        assert st["hedged"] == 1, st
        assert st["completed"] == 1 and st["failed"] == 0
        # the losing attempt is untracked and force-cancelled; its slot
        # frees at the next token boundary
        assert _until(lambda: not pool._attempts, timeout=10)
        assert _until(lambda: all(r.engine.num_active == 0 for r in pool._replicas),
                      timeout=10)
    assert h.status == DONE


def test_pool_hedge_needs_two_ready_replicas(model):
    # hedge_ms set but N=1: the scan stays inert
    p = _prompts(1, seed=8)[0]
    with ReplicaPool(model, config=_cfg(replicas=1, hedge_ms=1.0)) as pool:
        np.testing.assert_array_equal(pool.generate(p, 16, timeout=WAIT),
                                      model.generate(p[None], 16)[0])
        assert pool.stats()["hedged"] == 0


# ---------------------------------------------------------------------------
# restart backoff: bounded exponential, shared helper
# ---------------------------------------------------------------------------

def test_backoff_delay_caps():
    assert backoff_delay(1, 0.5, 30.0) == 0.5
    assert backoff_delay(2, 0.5, 30.0) == 1.0
    assert backoff_delay(3, 0.5, 30.0) == 2.0
    assert backoff_delay(10, 0.5, 30.0) == 30.0     # capped
    assert backoff_delay(0, 0.5, 30.0) == 0.5       # clamped to the first


def test_pool_restart_backoff_caps(model):
    # repeated down-marks walk the bounded exponential schedule
    cfg = _cfg(replicas=1, restart_backoff_s=5.0, restart_cap_s=8.0)
    with ReplicaPool(model, config=cfg) as pool:
        rep = pool._replicas[0]
        for want in (5.0, 8.0, 8.0):      # 5, 10->8, 20->8
            now = time.perf_counter()
            pool._mark_down(rep, "test", now)
            assert rep.restart_at - now == pytest.approx(want, rel=1e-6)
        assert pool.stats()["replica_downs"] == 3


# ---------------------------------------------------------------------------
# graceful drain: SIGTERM finishes everything, refuses new work
# ---------------------------------------------------------------------------

def test_pool_sigterm_drains(model):
    prompts = _prompts(4, seed=9)
    pool = ReplicaPool(model, config=_cfg(replicas=2))
    pool.start()
    try:
        handler = PreemptionHandler()
        pool.attach_preemption(handler)
        handles = [pool.submit(p, 8) for p in prompts]
        # simulate SIGTERM: the handler only sets the flag the monitor polls
        handler.signum = signal.SIGTERM
        handler.requested = True
        outs = [h.result(WAIT) for h in handles]
        for p, got in zip(prompts, outs):
            np.testing.assert_array_equal(got, model.generate(p[None], 8)[0])
        assert _until(lambda: pool._draining)
        assert not pool.ready()
        with pytest.raises(ServeError, match="not accepting"):
            pool.submit(prompts[0], 4)
        assert pool.healthz()["status"] in ("draining", "stopped")
        assert pool.stats()["completed"] == 4       # nothing dropped
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# healthz shape
# ---------------------------------------------------------------------------

def test_pool_healthz_detail(model):
    with ReplicaPool(model, config=_cfg(replicas=2)) as pool:
        hz = pool.healthz()
        assert hz["status"] == "ok" and hz["accepting"]
        assert [r["name"] for r in hz["replicas"]] == ["replica-0", "replica-1"]
        for r in hz["replicas"]:
            assert r["state"] == "ready"
            assert r["incarnation"].startswith(r["name"] + "#")
            assert r["beat_age_s"] is not None
        # the card memory each replica holds: its own KV pool (no graphs
        # on the CPU)
        dev = pool.device_bytes()
        assert sorted(dev) == ["replica-0", "replica-1"]
        assert all(b["graph_pools"] is None for b in dev.values())
    hz = pool.healthz()
    assert hz["status"] == "stopped" and not pool.ready()


# ---------------------------------------------------------------------------
# request tracing through a failover (tests/test_reqtrace.py's pool case)
# ---------------------------------------------------------------------------

def test_failover_attempts_are_siblings(model, tmp_path, monkeypatch):
    monkeypatch.setenv("FF_TRACE_SAMPLE", "1")
    monkeypatch.setattr(model, "_chaos", ChaosMonkey("serve:3=replica_kill"))
    log = events.EventLog(str(tmp_path / "t.jsonl"))
    prompts = _prompts(8, seed=2)
    with ReplicaPool(model, config=_cfg(replicas=3), telemetry=log) as pool:
        outs = [h.result(WAIT) for h in [pool.submit(p, 8) for p in prompts]]
        st = pool.stats()
    log.close()
    for p, got in zip(prompts, outs):
        np.testing.assert_array_equal(got, model.generate(p[None], 8)[0])
    assert st["failovers"] >= 1, "the kill never caught a request"
    recs = trace_report.parse_trace(log.path)
    fo = [r for r in recs if r.get("name") == "request_failover"]
    assert fo and all(r["attrs"].get("trace_id") for r in fo)
    tid = fo[0]["attrs"]["trace_id"]
    mine = [r for r in recs if (r.get("attrs") or {}).get("trace_id") == tid]
    roots = [r for r in mine if r["name"] == "serve_request"]
    atts = [r for r in mine if r["name"] == "serve_attempt"]
    assert len(roots) == 1
    assert len(atts) >= 2, "a failover leaves both attempt spans"
    root_span = roots[0]["attrs"]["span_id"]
    for a in atts:  # every attempt is a child of the client root: siblings
        assert a["attrs"]["parent_span_id"] == root_span
        assert "#a" in a["attrs"]["request_id"]
    assert len({a["attrs"]["incarnation"] for a in atts}) >= 2
    t0, t1 = roots[0]["ts"], roots[0]["ts"] + roots[0]["dur"]
    for a in atts:  # the root span covers its attempts (one submit clock)
        assert a["ts"] >= t0 - 1e-6
        assert a["ts"] + a["dur"] <= t1 + 0.05


# ---------------------------------------------------------------------------
# both packages' pools on the same weights, through the same kill
# ---------------------------------------------------------------------------

def test_pool_equals_the_jax_package_through_a_kill():
    """The JAX package's ReplicaPool and the port's, on transplanted
    weights, the same prompts and ``serve:3=replica_kill``: equal tokens,
    and equal completed and failover counts.  One slot a replica, so the
    killed replica holds exactly the request it was admitting whichever
    replica pops what, and the counts are deterministic."""
    jm = ff.FFModel(ff.FFConfig(batch_size=4, workers_per_node=1))
    jax_build_transformer(jm, 4, **SHAPE)
    jm.compile(ff.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"],
               machine=ff.Machine(devices=jax.devices()[:1]))
    jm.init_layers(seed=5)
    tm = _make_model(seed=5)
    load_jax_params(tm, jax_params_to_numpy(jm))
    prompts = _prompts(6, seed=11)
    got = {}
    for name, m, pool_cls, cfg_cls, monkey in (
            ("jax", jm, JaxReplicaPool, JaxServeConfig, JaxChaosMonkey),
            ("port", tm, ReplicaPool, ServeConfig, ChaosMonkey)):
        m._chaos = monkey("serve:3=replica_kill")
        try:
            with pool_cls(m, config=_cfg(cfg_cls, replicas=2, max_batch=1)) as pool:
                outs = [np.asarray(h.result(WAIT))
                        for h in [pool.submit(p, 8) for p in prompts]]
                st = pool.stats()
        finally:
            m._chaos = None
        got[name] = (outs, st["completed"], st["failovers"], st["replica_downs"])
    for i, (a, b) in enumerate(zip(got["jax"][0], got["port"][0])):
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    assert got["jax"][1:] == got["port"][1:] == (6, 1, 1)
    for p, out in zip(prompts, got["port"][0]):
        np.testing.assert_array_equal(out, tm.generate(p[None], 8)[0])
