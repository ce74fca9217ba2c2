"""The autoscaler and the zone-aware pool in the port
(flexflow_tpu_torch/serving/autoscaler.py): the counterparts of
tests/test_autoscaler.py, and one stub pool and fake clock driving both
packages' ``Autoscaler`` to equal timelines.

The policy half runs against a stub pool with a fake clock
(``Autoscaler._tick(now)`` is deterministic given the pool snapshot and
the timestamp), so the hysteresis and cooldown claims never sleep.  The
integration half runs a real two-zone pool on the tiny CPU transformer:
round-robin zone placement, a graceful drain whose tokens stay bitwise
``generate``'s, and the retired replica gone from ``healthz`` and the
Prometheus render.
"""

import time

import numpy as np
import pytest

from flexflow_tpu.serving.autoscaler import Autoscaler as JaxAutoscaler
from flexflow_tpu.serving.autoscaler import ScaleConfig as JaxScaleConfig
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.transformer import build_transformer
from flexflow_tpu_torch.observability.metrics import render_backend
from flexflow_tpu_torch.serving import Autoscaler, ScaleConfig, ServeConfig
from flexflow_tpu_torch.serving.pool import ReplicaPool
from flexflow_tpu_torch.serving.queue import TIMEOUT, InferenceRequest, RequestQueue

V = 32
MAX_SEQ = 64
WAIT = 120


def _until(cond, timeout=30.0, every=0.01):
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() >= deadline:
            return False
        time.sleep(every)
    return True


# ---------------------------------------------------------------------------
# loud knob parsing
# ---------------------------------------------------------------------------

def test_scale_env_garbage_is_loud(monkeypatch):
    monkeypatch.setenv("FF_SCALE_MAX", "banana")
    with pytest.raises(ValueError, match="FF_SCALE_MAX"):
        ScaleConfig.from_env()


def test_scale_env_min_zero_is_loud(monkeypatch):
    monkeypatch.setenv("FF_SCALE_MIN", "0")
    with pytest.raises(ValueError, match="FF_SCALE_MIN"):
        ScaleConfig.from_env()


def test_scale_min_above_max_is_loud():
    with pytest.raises(ValueError, match="FF_SCALE_MAX"):
        ScaleConfig(min_replicas=3, max_replicas=2)


def test_scale_streak_zero_is_loud(monkeypatch):
    monkeypatch.setenv("FF_SCALE_STREAK", "0")
    with pytest.raises(ValueError, match="FF_SCALE_STREAK"):
        ScaleConfig.from_env()


def test_scale_inverted_hysteresis_band_is_loud():
    with pytest.raises(ValueError, match="DOWN_QUEUE"):
        ScaleConfig(max_replicas=2, up_queue=1.0, down_queue=2.0)


def test_scale_env_roundtrip(monkeypatch):
    monkeypatch.setenv("FF_SCALE_MIN", "2")
    monkeypatch.setenv("FF_SCALE_MAX", "5")
    monkeypatch.setenv("FF_SCALE_UP_QUEUE", "3.5")
    cfg = ScaleConfig.from_env()
    assert (cfg.min_replicas, cfg.max_replicas, cfg.up_queue) == (2, 5, 3.5)
    assert cfg.enabled
    assert "replicas=[2,5]" in cfg.describe()
    # every FF_SCALE_* knob parses as the JAX package parses it
    for var, val in (("FF_SCALE_INTERVAL_S", "0.5"), ("FF_SCALE_UP_BURN", "3"),
                     ("FF_SCALE_DOWN_QUEUE", "0.25"), ("FF_SCALE_STREAK", "4"),
                     ("FF_SCALE_UP_COOLDOWN_S", "1.5"), ("FF_SCALE_DOWN_COOLDOWN_S", "9")):
        monkeypatch.setenv(var, val)
    assert ScaleConfig.from_env() == ScaleConfig(**vars(JaxScaleConfig.from_env()))


def test_scale_disabled_by_default():
    cfg = ScaleConfig.from_env()
    assert not cfg.enabled
    with pytest.raises(ValueError, match="disabled"):
        Autoscaler(_StubPool(), cfg).start()


def test_zones_env_parsing(monkeypatch):
    monkeypatch.setenv("FF_SERVE_ZONES", "zone-a, zone-b")
    assert ServeConfig.from_env().zones == ("zone-a", "zone-b")
    monkeypatch.setenv("FF_SERVE_ZONES", "a,,b")
    with pytest.raises(ValueError, match="FF_SERVE_ZONES"):
        ServeConfig.from_env()
    monkeypatch.setenv("FF_SERVE_ZONES", "a,b,a")
    with pytest.raises(ValueError, match="unique"):
        ServeConfig.from_env()


# ---------------------------------------------------------------------------
# policy: stub pool + fake clock, no threads, no sleeps
# ---------------------------------------------------------------------------

class _StubPool:
    def __init__(self, ready=2, queued=0):
        self.ready_replicas = ready
        self.num_replicas = ready
        self.num_queued = queued
        self._telemetry = None
        self.adds = 0
        self.drains = 0

    def add_replica(self, zone=None):
        self.adds += 1
        self.ready_replicas += 1
        self.num_replicas += 1
        return f"replica-{self.num_replicas}"

    def drain_replica(self, name=None):
        self.drains += 1
        self.ready_replicas -= 1
        self.num_replicas -= 1
        return f"replica-{self.num_replicas + 1}"


def _scaler(pool, cls=Autoscaler, cfg_cls=ScaleConfig, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("streak", 2)
    kw.setdefault("up_cooldown_s", 2.0)
    kw.setdefault("down_cooldown_s", 15.0)
    return cls(pool, cfg_cls(**kw))


def test_scale_up_on_queue_pressure_respects_streak():
    pool = _StubPool(ready=2, queued=20)     # 10/replica >> up_queue=4
    sc = _scaler(pool)
    sc._tick(0.0)
    assert pool.adds == 0, "one hot tick must not scale (streak=2)"
    sc._tick(1.0)
    assert pool.adds == 1 and pool.ready_replicas == 3
    assert sc.timeline[-1][1:] == (3, 3)


def test_scale_up_cooldown_blocks_consecutive_adds():
    pool = _StubPool(ready=1, queued=50)
    sc = _scaler(pool, up_cooldown_s=10.0)
    sc._tick(0.0)
    sc._tick(1.0)                            # streak met -> add
    assert pool.adds == 1
    for t in (2.0, 3.0, 4.0):                # still hot, inside the cooldown
        sc._tick(t)
    assert pool.adds == 1, "the cooldown paces consecutive adds"
    sc._tick(12.0)
    sc._tick(13.0)                           # a fresh streak past the cooldown
    assert pool.adds == 2


def test_no_flap_inside_hysteresis_band():
    # queued/replica between down_queue and up_queue: neither direction
    pool = _StubPool(ready=2, queued=4)      # 2/replica, the band is (0.5, 4)
    sc = _scaler(pool)
    for t in range(20):
        sc._tick(float(t))
    assert pool.adds == 0 and pool.drains == 0
    st = sc.stats()
    assert st["up_streak"] == 0 and st["down_streak"] == 0


def test_scale_down_quiet_respects_cooldown_and_min():
    pool = _StubPool(ready=3, queued=0)
    sc = _scaler(pool, min_replicas=2, down_cooldown_s=15.0)
    sc._last_down = 0.0                      # a recent (fake) drain
    sc._tick(1.0)
    sc._tick(2.0)                            # streak met, inside the cooldown
    assert pool.drains == 0
    sc._tick(16.0)
    sc._tick(17.0)                           # past the cooldown -> drain
    assert pool.drains == 1 and pool.ready_replicas == 2
    for t in range(40, 80):                  # at min: quiet forever, no lower
        sc._tick(float(t))
    assert pool.drains == 1
    assert sc.stats()["blocked_min"] > 0


def test_scale_up_clamped_at_max():
    pool = _StubPool(ready=4, queued=100)
    sc = _scaler(pool, max_replicas=4)
    for t in range(6):
        sc._tick(float(t))
    assert pool.adds == 0
    assert sc.stats()["blocked_max"] > 0


def test_backfill_below_min_is_immediate():
    # a zone outage just took the fleet below min: no streak required
    pool = _StubPool(ready=1, queued=0)
    sc = _scaler(pool, min_replicas=3, max_replicas=6, up_cooldown_s=0.0)
    sc._tick(0.0)
    sc._tick(0.1)
    assert pool.adds == 2 and pool.ready_replicas == 3
    sc._tick(0.2)                            # at min again: no more
    assert pool.adds == 2


def test_burn_rate_triggers_scale_up_without_queue():
    pool = _StubPool(ready=2, queued=0)
    sc = _scaler(pool, up_burn=2.0, down_cooldown_s=1e9)
    for w in ("5m", "1h"):                   # not observing yet: ignored
        sc._observe({"t": "gauge", "name": "slo_burn_rate", "v": 6.0,
                     "attrs": {"slo": "ttft", "window": w}})
    sc._observing = True
    sc._observe({"t": "gauge", "name": "slo_burn_rate", "v": 6.0,
                 "attrs": {"slo": "ttft", "window": "5m"}})
    assert sc.burn_rate() == 6.0
    sc._tick(0.0)
    sc._tick(1.0)
    assert pool.adds == 1, "burn above FF_SCALE_UP_BURN scales up"


def test_both_packages_scale_alike():
    """One traffic script on a stub pool and one fake clock drive the JAX
    package's Autoscaler and the port's: the same timelines, actions and
    counters, tick for tick."""
    script = [(3, 30)] * 4 + [(4, 20)] * 6 + [(5, 2)] * 20 + [(1, 0)] * 3 + [(4, 0)] * 40
    out = {}
    for name, cls, cfg_cls in (("jax", JaxAutoscaler, JaxScaleConfig),
                               ("port", Autoscaler, ScaleConfig)):
        pool = _StubPool(ready=2)
        sc = _scaler(pool, cls=cls, cfg_cls=cfg_cls, min_replicas=2, max_replicas=5,
                     up_burn=2.0, up_cooldown_s=1.5, down_cooldown_s=6.0)
        sc._observing = True
        for i, (ready, queued) in enumerate(script):
            if ready < pool.ready_replicas and i % 7 == 0:   # an outage under its feet
                pool.ready_replicas = ready
            pool.num_queued = queued
            if i == 12:
                sc._observe({"t": "gauge", "name": "slo_burn_rate", "v": 3.0,
                             "attrs": {"slo": "ttft", "window": "5m"}})
            if i == 20:
                sc._observe({"t": "gauge", "name": "slo_burn_rate", "v": 0.1,
                             "attrs": {"slo": "ttft", "window": "5m"}})
            sc._tick(0.5 * i)
        out[name] = (sc.timeline, pool.adds, pool.drains, sc.stats())
    assert out["port"] == out["jax"]
    assert out["port"][1] > 0 and out["port"][2] > 0, out["port"]


# ---------------------------------------------------------------------------
# queue sweeper: expiry without anyone popping (drain hardening)
# ---------------------------------------------------------------------------

def test_queue_sweeper_expires_without_pops():
    q = RequestQueue()
    q.start_sweeper(interval_s=0.01)
    q.start_sweeper(interval_s=0.01)         # idempotent
    try:
        r = InferenceRequest([1, 2, 3], 4, timeout_s=0.05)
        q.put(r)
        assert _until(r.done, timeout=5.0)
        assert r.status == TIMEOUT, (r.status, r.error)
        assert len(q) == 0
    finally:
        q.stop_sweeper()
    assert q._sweeper is None or not q._sweeper.is_alive()


# ---------------------------------------------------------------------------
# integration: a real two-zone pool on the tiny CPU transformer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    m = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu"))
    build_transformer(m, 4, seq_length=MAX_SEQ, num_layers=1, embed_dim=16, num_heads=2,
                      vocab_size=V)
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=3)
    return m


def _cfg(**kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("replica_timeout_s", 120.0)
    kw.setdefault("restart_backoff_s", 0.05)
    kw.setdefault("restart_cap_s", 0.2)
    return ServeConfig(**kw)


def test_zone_round_robin_placement(model):
    with ReplicaPool(model, config=_cfg(replicas=4, zones=("za", "zb"))) as pool:
        hz = pool.healthz()
        assert hz["zones"]["za"]["total"] == 2
        assert hz["zones"]["zb"]["total"] == 2
        by_zone = {}
        for r in hz["replicas"]:
            by_zone.setdefault(r["zone"], []).append(r["name"])
        assert sorted(by_zone) == ["za", "zb"]
        # add_replica backfills the least-populated zone
        assert pool.add_replica() is not None
        zones = [r["zone"] for r in pool.healthz()["replicas"]]
        assert sorted((zones.count("za"), zones.count("zb"))) == [2, 3]


def test_graceful_drain_bitwise_and_series_retired(model):
    prompts = [np.array([5, 6, 7, 8], np.int32), np.array([9, 10, 11], np.int32),
               np.array([3, 1, 4, 1, 5], np.int32), np.array([2, 7, 1, 8, 2, 8], np.int32)]
    want = [model.generate(p[None], 6)[0] for p in prompts]
    with ReplicaPool(model, config=_cfg(replicas=2)) as pool:
        handles = [pool.submit(p, 6) for p in prompts]
        victim = pool.drain_replica(timeout=WAIT)
        assert victim is not None
        outs = [h.result(WAIT) for h in handles]
        for i, (got, w) in enumerate(zip(outs, want)):
            np.testing.assert_array_equal(got, w, err_msg=f"the drain broke request {i}")
        hz = pool.healthz()
        # the retired replica is gone, not a zombie series
        assert victim not in [r["name"] for r in hz["replicas"]], hz
        assert len(hz["replicas"]) == 1
        rendered = render_backend(pool)
        assert f'replica="{victim}"' not in rendered
        assert "ff_replica_up" in rendered
        st = pool.stats()
        assert st["replicas_retired"] == 1
        assert st["completed"] + st["failovers"] >= len(prompts)


def test_autoscaler_live_backfill_below_min(model):
    # drop a replica under the scaler's feet: the next tick backfills
    with ReplicaPool(model, config=_cfg(replicas=2)) as pool:
        sc = Autoscaler(pool, ScaleConfig(min_replicas=2, max_replicas=3, interval_s=0.02,
                                          streak=2, up_cooldown_s=0.05,
                                          down_cooldown_s=1e9))
        with sc:
            pool.drain_replica()
            assert _until(lambda: pool.ready_replicas >= 2), pool.healthz()
        assert sc.stats()["scale_ups"] >= 1
        assert pool.stats()["replicas_added"] >= 1


def test_add_replica_refused_while_stopped(model):
    pool = ReplicaPool(model, config=_cfg(replicas=1))
    assert pool.add_replica() is None       # not started yet
    with pool:
        assert pool.add_replica() is not None
    assert pool.add_replica() is None       # stopped
