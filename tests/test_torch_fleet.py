"""Chaos, the serving report and the fleet scenarios in the port, on the
CPU: ``testing/chaos.py`` against the JAX package's parser and monkey on
the same specs, the serve site wired through ``FFModel.compile`` and the
engine, ``tools/serve_report.py`` of both packages over one trace the
port's pool wrote, and a tiny ``zone_outage`` scenario of
``testing/fleet.py``.
"""

import numpy as np
import pytest

from flexflow_tpu.testing import chaos as jax_chaos
from flexflow_tpu.tools import serve_report as jax_serve_report
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.transformer import build_transformer
from flexflow_tpu_torch.observability import events
from flexflow_tpu_torch.serving import ServeConfig, ServeError
from flexflow_tpu_torch.serving.engine import InferenceEngine
from flexflow_tpu_torch.serving.pool import ReplicaPool
from flexflow_tpu_torch.testing import chaos, fleet
from flexflow_tpu_torch.tools import serve_report, trace_report

WAIT = 120

# the JAX package's example specs (testing/chaos.py's docstring and tests)
SPECS = ["step:23=nan_loss;step:40=hang:2;ckpt_save:2=io_error", "step:57=sigterm",
         "step:p0.01=nan_loss", "serve:2=error", "serve:3=hang:2", "serve:3=replica_kill",
         "serve:3=replica_hang:5", "serve:5=zone_outage:1", "resharding:4=device_loss:4",
         "resharding:9=device_gain", "step:3=divergence:0.1", "data:p0.5=error;sync:1=sigint",
         " serve:1=error ; ; ckpt_restore:0=io_error "]
BAD_SPECS = ["", ";", "step=nan_loss", "stp:1=nan_loss", "step:1=nan", "step:x=hang",
             "step:p2=hang", "step:px=hang", "step:-1=hang", "step:1=hang:abc"]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_parses_as_the_jax_package(spec):
    assert chaos.parse_spec(spec) == jax_chaos.parse_spec(spec)
    assert chaos.ChaosMonkey(spec).describe() == jax_chaos.ChaosMonkey(spec).describe()


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_chaos_spec_raises_as_the_jax_package(spec):
    with pytest.raises(ValueError) as want:
        jax_chaos.parse_spec(spec)
    with pytest.raises(ValueError) as got:
        chaos.parse_spec(spec)
    assert str(got.value) == str(want.value)


def test_chaos_monkeys_fire_alike():
    """Exact and seeded probabilistic triggers fire at the same calls, with
    the same recorded state, in both packages."""
    spec = "resharding:p0.3=device_loss;resharding:7=device_gain:2;serve:p0.2=zone_outage:1"
    mk, jmk = chaos.ChaosMonkey(spec, seed=7), jax_chaos.ChaosMonkey(spec, seed=7)
    for m in (mk, jmk):
        for _ in range(60):
            m.fire("resharding")
            m.fire("serve")
    assert mk.fired == jmk.fired and mk.fired
    assert (mk.lost_device_count, mk.zones_down) == (jmk.lost_device_count, jmk.zones_down)


@pytest.fixture(scope="module")
def model():
    m = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu"))
    build_transformer(m, 4, seq_length=64, num_layers=1, embed_dim=16, num_heads=2,
                      vocab_size=32)
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=3)
    return m


def test_serve_chaos_from_the_env_fails_one_request(monkeypatch):
    """``FF_CHAOS=serve:2=error`` resolves at compile and fires at the
    engine's admissions: the second request fails alone, the others match
    ``generate``."""
    monkeypatch.setenv("FF_CHAOS", "serve:2=error")
    m = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu"))
    build_transformer(m, 4, seq_length=64, num_layers=1, embed_dim=16, num_heads=2,
                      vocab_size=32)
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=3)
    assert isinstance(m._chaos, chaos.ChaosMonkey)
    prompts = [np.array([1, 2, 3]), np.array([4, 5]), np.array([6, 7, 8, 9])]
    with InferenceEngine(m, max_batch=1, max_seq=64) as eng:
        hs = [eng.submit(p, 5) for p in prompts]
        for i, h in enumerate(hs):
            if i == 1:
                with pytest.raises(ServeError, match="chaos-injected error at serve:2"):
                    h.result(WAIT)
            else:
                h.result(WAIT)
    assert [h.status for h in hs] == ["done", "error", "done"]
    assert "chaos-injected error at serve:2" in hs[1].error
    for p, h in zip(prompts, hs):
        if h.status == "done":
            np.testing.assert_array_equal(h.tokens, m.generate(p[None], 5)[0])
    assert m._chaos.fired == [("serve", 2, "error")]


def test_serve_report_equals_the_jax_package_over_a_pool_trace(model, tmp_path, monkeypatch):
    """A trace the port's pool wrote (a kill, a failover, a restart, sampled
    requests) folds into the same markdown under both packages'
    serve_report."""
    monkeypatch.setenv("FF_TRACE_SAMPLE", "1")
    monkeypatch.setattr(model, "_chaos", chaos.ChaosMonkey("serve:3=replica_kill"))
    path = str(tmp_path / "pool.jsonl")
    log = events.EventLog(path)
    cfg = ServeConfig(max_batch=2, max_seq=64, replicas=2, zones=("za", "zb"),
                      replica_timeout_s=120.0, restart_backoff_s=0.05, restart_cap_s=0.2)
    rng = np.random.default_rng(4)
    with ReplicaPool(model, config=cfg, telemetry=log) as pool:
        hs = [pool.submit(rng.integers(0, 32, size=5), 6) for _ in range(6)]
        for h in hs:
            h.result(WAIT)
        pool.add_replica()
    log.close()
    recs = trace_report.parse_trace(path)
    report = serve_report.render_report(recs)
    assert report == jax_serve_report.render_report(recs)
    for section in ("## Requests", "## Latency (ms)", "## Replicas", "## Fleet",
                    "## Slow requests"):
        assert section in report, section
    assert "failovers 1" in report or "failovers 2" in report


@pytest.mark.parametrize("traffic", [False, True], ids=["mix", "traffic"])
def test_fleet_zone_outage_backfills_and_stays_correct(traffic):
    """A tiny zone_outage scenario: zone-b goes dark mid-run, every request
    still finishes bitwise equal to ``generate`` (none lost, none failed),
    and the autoscaler restores the ready count in zone-a.  ``traffic``:
    the caller's own requests (prompts over the whole vocabulary, longer
    than the mix's) on replicas captured up front instead of warm-up waves."""
    kw = dict(requests=8)
    if traffic:
        rng = np.random.default_rng(5)
        reqs = [(rng.integers(0, 32, size=int(rng.integers(12, 33)), dtype=np.int32),
                 int(rng.integers(4, 12))) for _ in range(8)]
        kw = dict(traffic=reqs, pool_warmup=True)
    res = fleet.run_scenario("zone_outage", seed=0, device="cpu", **kw)
    assert res["requests"] == 8
    assert res["n_done"] == 8 and res["n_lost"] == 0 and res["n_failed"] == 0
    assert res["n_incorrect"] == 0
    assert res["incident"] is not None and res["time_to_recover_s"] is not None
    assert res["pool"]["ready_replicas"] >= fleet.SCENARIOS["zone_outage"].scale["min_replicas"]
    assert res["pool"]["replica_downs"] == 2 and res["scale_events"]["ups"] >= 2
    assert res["offered_rps"] > 0 and res["attained_rps"] > 0
