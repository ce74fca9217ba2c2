"""A replica pool over slices of cards (flexflow_tpu_torch/serving/remote.py)
on gloo ranks on the CPU, against the JAX package.

The JAX package's ``ReplicaPool([m0, m1])`` serves one model per disjoint
device slice; the port's slices are processes, one a rank, each slice a
``torch.distributed`` world of its own formed through the pool's hub.  One
module-scoped hub starts every slice once (subprocesses that import the
port only, build the small LM on their slice, carry the JAX model's
weights in with ``convert.load_jax_params`` and run ``serve_slice``):

* ``s0``, ``s1``: 2 ranks each, the transformer's attention split by heads
  and its dense layers (the vocabulary head included) by column, 2 ways;
* ``one0``, ``one1``: one rank each, no mesh (spares the pools claim);
* ``k0``: one rank, killed by one case.

Each case builds a pool in this process over some of them, the pool's
attempts and their CAS here, and stops it, which returns the slices to
the hub.  The cases mirror tests/test_serving_pool.py and
tests/test_autoscaler.py over remote replicas (n=1 parity, failover
exactly once, a single replica's restart serving its queue, shedding
with 503 and Retry-After, hedging, the restart backoff cap, SIGTERM
drain, ``healthz``, scale-up and scale-down onto spares), and add what
only processes have: a killed process (the slice lost, never restarted
in place), a hedge loser cancelled on its remote leader, a zone outage
over slices.  Every request's greedy tokens equal the JAX package's
``FFModel.generate`` on the same weights (exact, f32), and the JAX
package's own pool over two 2-device slices of the host CPU devices.
"""

import collections
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

import flexflow_tpu as ff
from flexflow_tpu.models.transformer import build_transformer as jax_build_transformer
from flexflow_tpu.serving import ServeConfig as JaxServeConfig
from flexflow_tpu.serving.pool import ReplicaPool as JaxReplicaPool
from flexflow_tpu_torch.convert import jax_params_to_numpy
from flexflow_tpu_torch.observability import events
from flexflow_tpu_torch.runtime.resilience import PreemptionHandler
from flexflow_tpu_torch.serving import (Autoscaler, ScaleConfig, ServeConfig, ServeError,
                                        ServeOverload)
from flexflow_tpu_torch.serving.api import ServingAPI
from flexflow_tpu_torch.serving.pool import LOST, ReplicaPool
from flexflow_tpu_torch.serving.remote import SliceHub
from flexflow_tpu_torch.testing import fleet
from flexflow_tpu_torch.tools import trace_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(seq_length=32, num_layers=2, embed_dim=32, num_heads=4, vocab_size=50)
NEW = 5
WAIT = 60           # seconds any one request or pool transition may take
SPAWN_WAIT = 120    # the slices' start: torch import, gloo, the model
HEADS = {name: (1, 1, 2) for i in range(LM["num_layers"])
         for name in (f"attn_{i}", f"mlp_up_{i}", f"mlp_down_{i}")}
HEADS["lm_head"] = (1, 1, 2)
SLICES = {"s0": dict(ranks=2, mesh=True, strategies=HEADS),
          "s1": dict(ranks=2, mesh=True, strategies=HEADS),
          "one0": dict(ranks=1, mesh=False, strategies={}),
          "one1": dict(ranks=1, mesh=False, strategies={}),
          "k0": dict(ranks=1, mesh=False, strategies={})}

# one rank of a slice: the port only, never jax
_SLICE = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
job = json.load(open(sys.argv[1]))
name, rank = sys.argv[2], int(sys.argv[3])
sys.path.insert(0, job["root"])
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.convert import load_jax_params
from flexflow_tpu_torch.models.transformer import build_transformer
from flexflow_tpu_torch.serving import remote
spec = job["slices"][name]
params = np.load(job["params"], allow_pickle=True).item()


def build(device):
    m = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu", compute_dtype="float32",
                               strategies={k: ft.ParallelConfig(dims=tuple(v))
                                           for k, v in spec["strategies"].items()}))
    build_transformer(m, 4, **job["lm"])
    m.compile(ft.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=12)
    load_jax_params(m, params)
    return m


remote.serve_slice(build, endpoint=job["endpoint"], name=name, rank=rank,
                   ranks=spec["ranks"], device="cpu", mesh=spec["mesh"], pg_timeout_s=600)
"""


def _jax_lm(devices, strategies=None):
    cfg = ff.FFConfig(batch_size=4, workers_per_node=1)
    for k, v in (strategies or {}).items():
        cfg.strategies[k] = ff.ParallelConfig(dims=tuple(v))
    m = ff.FFModel(cfg)
    jax_build_transformer(m, 4, **LM)
    m.compile(ff.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy", ["accuracy"],
              machine=ff.Machine(devices=devices))
    m.init_layers(seed=11)
    return m


def _requests(n=12, seed=21):
    rng = np.random.default_rng(seed)
    lens = [3, 5, 9, 13]
    return [rng.integers(0, LM["vocab_size"], lens[i % 4]).astype(np.int32) for i in range(n)]


def _cfg(cls=ServeConfig, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_seq", LM["seq_length"])
    kw.setdefault("kv_block", 4)
    kw.setdefault("replica_timeout_s", 10.0)
    kw.setdefault("restart_backoff_s", 0.05)
    kw.setdefault("restart_cap_s", 0.2)
    return cls(**kw)


def _until(cond, timeout=WAIT, every=0.01):
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() >= deadline:
            return False
        time.sleep(every)
    return True


@pytest.fixture(scope="module")
def jax_lm():
    return _jax_lm(jax.devices()[:1])


@pytest.fixture(scope="module")
def hub(tmp_path_factory, jax_lm):
    """The hub and every slice's ranks, started once; torn down with the
    module (exit, then kill what is left)."""
    tmp = tmp_path_factory.mktemp("slices")
    hub = SliceHub()
    np.save(tmp / "params.npy", jax_params_to_numpy(jax_lm), allow_pickle=True)
    (tmp / "slice.py").write_text(_SLICE)
    (tmp / "job.json").write_text(json.dumps(dict(
        root=ROOT, endpoint=hub.endpoint, lm=LM, slices=SLICES,
        params=str(tmp / "params.npy"))))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("FF_CHAOS", None)
    procs = {}
    for name, spec in SLICES.items():
        # one1 writes its engine's records to an event log of its own
        e = env if name != "one1" else dict(env, FF_TELEMETRY="1", FF_TRACE_SAMPLE="1",
                                            FF_TELEMETRY_FILE=str(tmp / "one1.jsonl"))
        procs[name] = [subprocess.Popen(
            [sys.executable, str(tmp / "slice.py"), str(tmp / "job.json"), name, str(r)],
            env=e, stdout=open(tmp / f"{name}.{r}.log", "w"), stderr=subprocess.STDOUT)
            for r in range(spec["ranks"])]
    hub.one1_log = str(tmp / "one1.jsonl")
    try:
        hub.wait(list(SLICES), timeout=SPAWN_WAIT)
        yield hub, procs
    finally:
        hub.close()
        deadline = time.perf_counter() + 20
        for ps in procs.values():
            for p in ps:
                try:
                    p.wait(max(0.1, deadline - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def want(jax_lm):
    """Each request's JAX tokens, memoized (one JAX compile a length)."""
    memo = {}

    def get(p, n=NEW):
        key = (p.tobytes(), n)
        if key not in memo:
            memo[key] = np.asarray(jax_lm.generate(p[None], n)[0])
        return memo[key]
    return get


def _slices(hub, *names):
    return [hub[0].claim(n) for n in names]


def _check(outs, prompts, want, n=NEW):
    for i, (p, got) in enumerate(zip(prompts, outs)):
        np.testing.assert_array_equal(got, want(p, n), err_msg=f"request {i}")


def _burst(pool, prompts, n=NEW):
    fires = collections.Counter()
    hs = [pool.submit(p, n) for p in prompts]
    for h in hs:
        h.add_done_callback(lambda r: fires.update([r.request_id]))
    outs = [h.result(WAIT) for h in hs]
    # exactly once: each client fires its done callbacks a single time
    assert len(fires) == len(prompts) and set(fires.values()) == {1}, fires
    return outs


# ---------------------------------------------------------------------------
# the slices against the JAX package
# ---------------------------------------------------------------------------

def test_pool_over_two_slices_equals_the_jax_package(hub, want, jax_lm):
    """Two replicas of 2 ranks each, heads split 2: every request's tokens
    equal the JAX package's generate, and its ReplicaPool over two slices
    of 2 host CPU devices each."""
    prompts = _requests(12)
    with ReplicaPool(_slices(hub, "s0", "s1"), config=_cfg()) as pool:
        outs = _burst(pool, prompts)
        st = pool.stats()
        served = {r: v["engine"]["completed"] for r, v in st["replicas"].items()}
    _check(outs, prompts, want)
    assert st["completed"] == len(prompts) and st["failovers"] == 0
    assert all(v["engine"]["world_size"] == 2 for v in st["replicas"].values())
    assert all(n > 0 for n in served.values()), served  # both slices served
    devs = jax.devices()
    jms = [_jax_lm(devs[2 * i:2 * i + 2], HEADS) for i in range(2)]
    for m in jms:
        m._params = jax_lm._params
    with JaxReplicaPool(jms, config=_cfg(JaxServeConfig)) as jpool:
        jouts = [np.asarray(h.result(WAIT)) for h in [jpool.submit(p, NEW) for p in prompts]]
    for i, (a, b) in enumerate(zip(outs, jouts)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")


def test_slice_pool_n1_matches_generate(hub, want):
    prompts = _requests(5, seed=1)
    with ReplicaPool(_slices(hub, "s0"), config=_cfg()) as pool:
        outs = [h.result(WAIT) for h in [pool.submit(p, NEW) for p in prompts]]
        hz = pool.healthz()
    _check(outs, prompts, want)
    st = pool.stats()
    assert st["completed"] == 5 and st["failovers"] == 0 and st["shed"] == 0
    assert hz["replicas"][0]["slice"] == "s0" and hz["replicas"][0]["world_size"] == 2
    # the stopped pool returned its slice to the hub's spares
    assert "s0" in {s.name for s in hub[0].spares()}


# ---------------------------------------------------------------------------
# failures: a remote leader killed, restarted in place, a process killed
# ---------------------------------------------------------------------------

def test_slice_failover_exactly_once(hub, want):
    """``serve:3=replica_kill`` on s0's leader: its loop dies holding
    attempts, the pool fails them over to s1 exactly once, and s0
    restarts in place, its world formed again (a mesh slice)."""
    s0, s1 = _slices(hub, "s0", "s1")
    s0.set_chaos("serve:3=replica_kill")
    prompts = _requests(10, seed=2)
    try:
        with ReplicaPool([s0, s1], config=_cfg()) as pool:
            outs = _burst(pool, prompts)
            st = pool.stats()
            assert _until(lambda: pool.stats()["replica_restarts"] >= 1
                          and pool.ready_replicas == 2), pool.healthz()
            gen = s0.generation
            # the restarted incarnation serves
            again = [h.result(WAIT) for h in [pool.submit(p, NEW) for p in prompts[:6]]]
    finally:
        s0.set_chaos(None)
    _check(outs, prompts, want)
    _check(again, prompts[:6], want)
    assert st["replica_downs"] >= 1 and st["failovers"] >= 1, st
    assert st["completed"] == len(prompts)
    assert gen >= 1   # the mesh slice re-formed its world
    assert not pool._attempts and not pool._clients


def test_slice_single_replica_restart_serves_queued(hub, want):
    """N=1: the only replica's leader dies at its first admission; the
    failover attempt waits for the restarted incarnation (avoid = the dead
    uid), and healthz narrates down -> ok."""
    (s0,) = _slices(hub, "s0")
    s0.set_chaos("serve:1=replica_kill")
    p = _requests(1, seed=4)[0]
    try:
        with ReplicaPool([s0], config=_cfg(restart_backoff_s=0.4, restart_cap_s=1.0)) as pool:
            assert pool.ready()
            h = pool.submit(p, NEW)
            assert _until(lambda: pool.healthz()["status"] == "down")
            assert not pool.ready()
            np.testing.assert_array_equal(h.result(WAIT), want(p))
            assert _until(lambda: pool.healthz()["status"] == "ok" and pool.ready())
            st = pool.stats()
            assert st["replica_downs"] == 1 and st["replica_restarts"] == 1
    finally:
        s0.set_chaos(None)
    assert pool.healthz()["status"] == "stopped"


def test_killed_process_loses_its_slice(hub, want):
    """SIGKILL of a slice's process while it serves: the slice is LOST at
    once (its channel closed), its attempts fail over exactly once, it is
    never restarted in place, and a spare slice comes in through
    ``add_replica``."""
    hubo, procs = hub
    k0, s1 = _slices(hub, "k0", "s1")
    # k0's first admission sleeps (a request-level hang): the process is
    # killed while it holds that attempt
    k0.set_chaos("serve:1=hang:30")
    prompts = _requests(10, seed=6)
    with ReplicaPool([k0, s1], config=_cfg(restart_backoff_s=0.05)) as pool:
        hs = [pool.submit(p, NEW) for p in prompts]
        assert _until(lambda: pool._replicas[0].engine.active_requests())
        time.sleep(0.3)     # the submit crosses; the admission sleeps there
        procs["k0"][0].send_signal(signal.SIGKILL)
        outs = [h.result(WAIT) for h in hs]
        assert _until(lambda: pool._replicas[0].state == LOST)
        time.sleep(0.5)  # several monitor ticks past the backoff: no restart
        st = pool.stats()
        assert st["replica_restarts"] == 0 and pool._replicas[0].state == LOST
        hz = pool.healthz()["replicas"][0]
        assert hz["lost"] and "closed its channel" in hz["lost"]
        name = pool.add_replica()
        assert name is not None and pool.ready_replicas == 2
        more = [h.result(WAIT) for h in [pool.submit(p, NEW) for p in prompts[:4]]]
    _check(outs, prompts, want)
    _check(more, prompts[:4], want)
    assert st["replica_downs"] == 1 and st["failovers"] >= 1
    assert st["completed"] == len(prompts)
    assert k0.lost is not None and k0 not in hubo.spares()


# ---------------------------------------------------------------------------
# admission control, hedging, backoff, drain, health
# ---------------------------------------------------------------------------

def test_slice_shedding_503_retry_after(hub, want):
    (one0,) = _slices(hub, "one0")
    pool = ReplicaPool([one0], config=_cfg(max_batch=1, max_queue=2))
    accepted, sheds = [], []
    with pool:
        for p in _requests(10, seed=5):
            try:
                accepted.append((p, pool.submit(p, 16)))
            except ServeOverload as e:
                sheds.append(e)
        with ServingAPI(pool, port=0) as api:
            codes = []
            for p in _requests(6, seed=8):
                body = json.dumps({"prompt": p.tolist(), "max_new_tokens": 16}).encode()
                req = urllib.request.Request(f"{api.url}/generate", data=body,
                                             headers={"Content-Type": "application/json"})
                try:
                    urllib.request.urlopen(req, timeout=0.01)
                except urllib.error.HTTPError as e:
                    codes.append((e.code, e.headers.get("Retry-After")))
                except Exception:  # noqa: BLE001 — an accepted post we did not wait for
                    pass
        outs = [h.result(WAIT) for _, h in accepted]
    assert sheds and all(e.retry_after_s >= 1.0 for e in sheds)
    assert any(c == 503 and ra is not None and float(ra) >= 1.0 for c, ra in codes), codes
    for (p, _), got in zip(accepted, outs):
        np.testing.assert_array_equal(got, want(p, 16))
    assert pool.stats()["shed"] >= len(sheds)


def test_slice_hedge_winner_takes_all_and_the_loser_is_cancelled_remotely(hub, want):
    p = _requests(1, seed=7)[0]
    with ReplicaPool(_slices(hub, "s0", "s1"), config=_cfg(hedge_ms=10.0)) as pool:
        h = pool.submit(p, 20)
        np.testing.assert_array_equal(h.result(WAIT), want(p, 20))
        st = pool.stats()
        assert st["hedged"] == 1 and st["completed"] == 1 and st["failed"] == 0, st
        # the loser's remote slot frees at its next boundary
        assert _until(lambda: not pool._attempts, timeout=10)
        assert _until(lambda: all(r.engine.num_active == 0 for r in pool._replicas))
        assert _until(lambda: sum(v["engine"].get("cancelled", 0)
                                  for v in pool.stats()["replicas"].values()) >= 1), \
            pool.stats()["replicas"]


def test_slice_restart_backoff_caps(hub):
    cfg = _cfg(restart_backoff_s=5.0, restart_cap_s=8.0)
    with ReplicaPool(_slices(hub, "one0"), config=cfg) as pool:
        rep = pool._replicas[0]
        for want_s in (5.0, 8.0, 8.0):
            now = time.perf_counter()
            pool._mark_down(rep, "test", now)
            assert rep.restart_at - now == pytest.approx(want_s, rel=1e-6)
        assert pool.stats()["replica_downs"] == 3


def test_slice_pool_sigterm_drains(hub, want):
    prompts = _requests(4, seed=9)
    pool = ReplicaPool(_slices(hub, "s0", "one0"), config=_cfg())
    pool.start()
    try:
        handler = PreemptionHandler()
        pool.attach_preemption(handler)
        handles = [pool.submit(p, NEW) for p in prompts]
        handler.signum = signal.SIGTERM
        handler.requested = True
        outs = [h.result(WAIT) for h in handles]
        _check(outs, prompts, want)
        assert _until(lambda: pool._draining)
        assert not pool.ready()
        with pytest.raises(ServeError, match="not accepting"):
            pool.submit(prompts[0], 4)
        assert pool.stats()["completed"] == 4
    finally:
        pool.stop()


def test_slice_pool_healthz_detail(hub):
    with ReplicaPool(_slices(hub, "s0", "one0"), config=_cfg()) as pool:
        hz = pool.healthz()
        assert hz["status"] == "ok" and hz["accepting"]
        assert [r["slice"] for r in hz["replicas"]] == ["s0", "one0"]
        assert [r["world_size"] for r in hz["replicas"]] == [2, 1]
        for r in hz["replicas"]:
            assert r["state"] == "ready" and r["lost"] is None
            assert r["incarnation"].startswith(r["name"] + "#")
            assert len(r["pids"]) == r["world_size"] and all(r["pids"])
            assert r["beat_age_s"] is not None and r["beat_age_s"] < 5
        with ServingAPI(pool, port=0) as api:
            with urllib.request.urlopen(f"{api.url}/healthz", timeout=10) as r:
                body = json.loads(r.read())
            with urllib.request.urlopen(f"{api.url}/metrics", timeout=10) as r:
                metrics = r.read().decode()
        assert [r["slice"] for r in body["replicas"]] == ["s0", "one0"]
        assert 'ff_replica_up{replica="replica-0",slice="s0",state="ready"} 1' in metrics
        assert 'ff_replica_ranks{replica="replica-0",slice="s0"} 2' in metrics
        assert sorted(pool.device_bytes()) == ["replica-0", "replica-1"]
    assert pool.healthz()["status"] == "stopped"


def test_remote_attempt_spans_in_the_slice_s_own_log(hub, want, tmp_path, monkeypatch):
    """A sampled request served by a remote replica: the pool's log holds
    its serve_request and serve_attempt spans, the slice's own log the
    engine's serve_queue_wait, serve_prefill and serve_decode spans under
    the attempt's request id, all with the one trace id."""
    monkeypatch.setenv("FF_TRACE_SAMPLE", "1")
    log = events.EventLog(str(tmp_path / "pool.jsonl"))
    p = _requests(1, seed=13)[0]
    with ReplicaPool(_slices(hub, "one1"), config=_cfg(), telemetry=log) as pool:
        h = pool.submit(p, NEW)
        np.testing.assert_array_equal(h.result(WAIT), want(p))
    log.close()
    tid = h.trace.trace_id
    mine = [r for r in trace_report.parse_trace(log.path)
            if (r.get("attrs") or {}).get("trace_id") == tid]
    assert {r["name"] for r in mine} >= {"serve_request", "serve_attempt"}
    attempt = next(r for r in mine if r["name"] == "serve_attempt")["attrs"]

    def remote():
        return [r for r in trace_report.parse_trace(hub[0].one1_log)
                if (r.get("attrs") or {}).get("trace_id") == tid]
    assert _until(lambda: {"serve_queue_wait", "serve_prefill", "serve_decode"}
                  <= {r["name"] for r in remote()}, timeout=10)
    for r in remote():
        if r["name"] in ("serve_queue_wait", "serve_prefill", "serve_decode"):
            assert r["attrs"]["request_id"] == attempt["request_id"]
            assert r["attrs"]["parent_span_id"] == attempt["span_id"]


# ---------------------------------------------------------------------------
# elastic membership and zones over slices
# ---------------------------------------------------------------------------

def test_autoscaler_scales_up_onto_a_spare_and_down_returning_it(hub, want):
    hubo = hub[0]
    (s0,) = _slices(hub, "s0")
    spares = {s.name for s in hubo.spares()}
    assert spares, "no spare slice left"
    prompts = _requests(12, seed=10)
    with ReplicaPool([s0], config=_cfg(max_batch=1)) as pool:
        sc = Autoscaler(pool, ScaleConfig(min_replicas=1, max_replicas=2, interval_s=0.02,
                                          up_queue=1.0, down_queue=0.5, streak=2,
                                          up_cooldown_s=0.05, down_cooldown_s=0.2,
                                          up_burn=0))
        with sc:
            hs = [pool.submit(p, NEW) for p in prompts]
            assert _until(lambda: pool.num_replicas == 2), pool.healthz()
            added = pool._replicas[1].slice.name
            assert added in spares
            outs = [h.result(WAIT) for h in hs]
            assert _until(lambda: pool.num_replicas == 1), pool.healthz()
        st = sc.stats()
    _check(outs, prompts, want)
    assert st["scale_ups"] >= 1 and st["scale_downs"] >= 1
    assert pool.stats()["replicas_added"] >= 1 and pool.stats()["replicas_retired"] >= 1
    assert added in {s.name for s in hubo.spares()}  # the drain returned it


def test_zone_outage_over_slices(hub, want):
    """``serve:1=zone_outage:1`` on s1's leader: the pool learns of it from
    that leader's beat and downs every replica of zone-b at once, fails
    their attempts over to zone-a exactly once, and restarts none of
    them in place.  12 requests: the other replicas' 9 slots leave s1
    some, whichever pump pops first."""
    s0, s1, one0, one1 = _slices(hub, "s0", "s1", "one0", "one1")
    s1.set_chaos("serve:1=zone_outage:1")
    prompts = _requests(12, seed=12)
    try:
        cfg = _cfg(zones=("zone-a", "zone-b"))
        with ReplicaPool([s0, s1, one0, one1], config=cfg) as pool:
            outs = _burst(pool, prompts)
            assert _until(lambda: pool.zones_down() == {"zone-b"})
            assert _until(lambda: pool.ready_replicas == 2)
            time.sleep(0.3)
            st = pool.stats()
            zones = {r["name"]: (r["zone"], r["state"]) for r in pool.healthz()["replicas"]}
    finally:
        s1.set_chaos(None)
    _check(outs, prompts, want)
    assert st["zone_outages"] == 1 and st["replica_restarts"] == 0
    assert all(state == ("ready" if z == "zone-a" else "restarting")
               for z, state in zones.values()), zones
    assert st["completed"] == len(prompts)


def test_fleet_zone_outage_over_slices(hub, want):
    """The fleet's zone-outage incident over four slices (two zones): every
    finished request correct, none lost, the failover exactly once, the
    autoscaler's backfill finding no spare left (the killed slice's is
    gone)."""
    slices = _slices(hub, "s0", "s1", "one0", "one1")
    assert all(slices)

    def matches(prompts, news, outs):
        return [bool(np.array_equal(o, want(p, n))) for p, n, o in zip(prompts, news, outs)]

    got = fleet.run_scenario("zone_outage", requests=16, seed=3, slices=slices,
                             matches=matches, serve=dict(max_seq=LM["seq_length"], kv_block=4),
                             slo_ms=60000.0)
    assert got["n_incorrect"] == 0 and got["n_lost"] == 0, got
    assert got["n_done"] + got["n_shed"] + got["n_failed"] == 16, got
    assert got["incident"] is not None and got["pool"]["replica_downs"] >= 2, got
    assert got["n_failed"] == 0, got
