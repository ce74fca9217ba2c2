"""Online re-parallelization in the port (flexflow_tpu_torch/runtime/
reconfigure.py, FFModel.recompile): tests/test_reconfigure.py's cases, on
the port.

The model is tests/test_reconfigure.py's MLP (8 -> 16 -> 4, batch 16,
Adam 0.01), its initial weights the JAX package's (``convert``).  The
knobs, the refit, the triggers, the gate, probation and rollback and the
strategy hash run on one CPU device, where a divergence swap re-searches
the one-device map.  The device loss and gain run as one job of four gloo
ranks (testing/chaos_smoke.py's reshard scenario, twice): half the ranks
are lost after step 4, the swap applies at step 6 onto the two survivors
(the lost ranks benched), a gain after step 7 takes the run back to four
ranks at step 9, and the two runs end bitwise equal.  The job starts
from the JAX package's weights, and every rank ends at the weights of the
same steps on one device with no swap, and at those of the JAX package's
run with the same chaos spec and lag on its 8-device mesh (half of it lost
and regained), which swaps at the same steps (rtol 1e-5, atol 1e-6); its
divergence swap and rollback equal the port's; a recompile in training
equals the JAX package's recompile at rtol 1e-5, atol 1e-6.
"""

import functools
import glob
import json
import os
import threading

import numpy as np
import pytest

import jax

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.observability import events
from flexflow_tpu_torch.parallel.strategy import strategies_fingerprint
from flexflow_tpu_torch.runtime import reconfigure
from flexflow_tpu_torch.runtime.elastic import DeviceHangError, StepWatchdog, elastic_train
from flexflow_tpu_torch.runtime.reconfigure import (ReconfigPolicy, ReconfigurationController,
                                                    maybe_controller, refit_machine_model)
from flexflow_tpu_torch.runtime.resilience import (StrategyMismatchError, read_resume_meta,
                                                   write_resume_meta)

PARITY_TOL = dict(rtol=1e-5, atol=1e-6)
RECONFIG_KEYS = ("FF_RECONFIGURE", "FF_RECONFIG_GAIN", "FF_RECONFIG_PROBATION",
                 "FF_RECONFIG_DIVERGENCE", "FF_RECONFIG_SUSTAIN", "FF_RECONFIG_BUDGET",
                 "FF_RECONFIG_LAG_STEPS", "FF_RECONFIG_REGRESS", "FF_RECONFIG_SEED",
                 "FF_RECONFIG_DIR")
ROLLBACK_ENV = {"FF_RECONFIGURE": "1", "FF_RECONFIG_BUDGET": "40",
                "FF_RECONFIG_LAG_STEPS": "2", "FF_RECONFIG_GAIN": "-10",
                "FF_RECONFIG_PROBATION": "3",
                # the planted regression: every step after the swap at step
                # 6 is inflated by 150 ms (chaos divergence fault)
                "FF_CHAOS": "resharding:7=divergence:0.15"}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in RECONFIG_KEYS + ("FF_CHAOS", "FF_CHAOS_SEED", "FF_TELEMETRY",
                              "FF_TELEMETRY_FILE", "FF_HEALTH"):
        monkeypatch.delenv(k, raising=False)
    events.reset_active()
    yield
    events.reset_active()


def _graph(pkg, **cfg):
    m = pkg.FFModel(pkg.FFConfig(batch_size=16, **cfg))
    inp = m.create_tensor((16, 8), nchw=False, name="input")
    t = m.dense(inp, 16, activation="relu", name="fc1")
    t = m.dense(t, 4, name="fc2")
    m.softmax(t, name="sm")
    return m, inp


def _data(n_samples=48):
    rng = np.random.default_rng(3)
    return (rng.standard_normal((n_samples, 8), dtype=np.float32),
            rng.integers(0, 4, size=(n_samples, 1), dtype=np.int32))


def _build_jax(one_device=True):
    m, inp = _graph(ff)
    machine = ff.Machine(devices=jax.devices()[:1]) if one_device else None
    m.compile(ff.AdamOptimizer(alpha=0.01), "sparse_categorical_crossentropy", ["accuracy"],
              machine=machine)
    m.init_layers(seed=9)
    x, y = _data()
    return m, ff.DataLoader(m, {inp: x}, y, seed=5)


def _jax_params(m):
    from flexflow_tpu_torch.convert import jax_params_to_numpy

    return jax_params_to_numpy(m)


@functools.lru_cache(maxsize=None)
def _jax_weights():
    return _jax_params(_build_jax()[0])


def _build():
    from flexflow_tpu_torch.convert import load_jax_params

    m, inp = _graph(ft, device="cpu")
    m.compile(ft.AdamOptimizer(alpha=0.01), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=9)
    load_jax_params(m, _jax_weights())
    x, y = _data()
    return m, ft.DataLoader(m, {inp: x}, y, seed=5)


def _swap_events(trace):
    out = []
    with open(trace) as f:
        for line in f:
            if line.strip() and '"strategy_swap"' in line:
                rec = json.loads(line)
                if rec.get("name") == "strategy_swap":
                    out.append(rec["attrs"])
    return out


def _kick(holder):
    def kick(epoch, _metrics):
        if epoch == 0:
            holder[0]._reconfig.request("divergence", ratio=2.0)
    return kick


# ---------------------------------------------------------------------------
# policy / knobs
# ---------------------------------------------------------------------------

def test_policy_from_env(monkeypatch):
    from flexflow_tpu.runtime.reconfigure import ReconfigPolicy as JaxPolicy

    assert ReconfigPolicy.from_env() is None  # unset -> zero overhead
    monkeypatch.setenv("FF_RECONFIGURE", "1")
    monkeypatch.setenv("FF_RECONFIG_GAIN", "0.1")
    monkeypatch.setenv("FF_RECONFIG_PROBATION", "5")
    pol = ReconfigPolicy.from_env()
    assert pol.gain == 0.1 and pol.probation == 5
    assert pol.describe() == JaxPolicy.from_env().describe()
    monkeypatch.setenv("FF_RECONFIG_GAIN", "lots")
    with pytest.raises(ValueError, match="FF_RECONFIG_GAIN"):
        ReconfigPolicy.from_env()
    monkeypatch.setenv("FF_RECONFIG_GAIN", "0.1")
    monkeypatch.setenv("FF_RECONFIG_REGRESS", "0.9")
    with pytest.raises(ValueError, match="FF_RECONFIG_REGRESS"):
        ReconfigPolicy.from_env()


def test_refit_quantizes_and_clamps():
    base8, base4 = refit_machine_model(8), refit_machine_model(4)
    assert base8.num_devices == 8 and base4.num_devices == 4
    slow = refit_machine_model(4, predicted_s=1e-5, measured_s=1e-2)
    assert slow.matmul_efficiency == pytest.approx(base4.matmul_efficiency / 4.0)
    assert all(v == pytest.approx(base4.op_efficiency[k] / 4.0)
               for k, v in slow.op_efficiency.items())
    fast = refit_machine_model(4, predicted_s=1.0, measured_s=0.3)  # 1/3 -> the 1/4 bucket
    assert fast.matmul_efficiency == pytest.approx(base4.matmul_efficiency * 4.0)
    near = refit_machine_model(8, predicted_s=1.0, measured_s=1.2)
    assert near.matmul_efficiency == base8.matmul_efficiency


def test_zero_overhead_when_unset(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("controller constructed with FF_RECONFIGURE unset")

    monkeypatch.setattr(reconfigure, "ReconfigurationController", boom)
    assert maybe_controller(object(), None, str(tmp_path)) is None
    m, dl = _build()
    assert elastic_train(m, dl, epochs=1, checkpoint_dir=str(tmp_path / "ckpt")) == 1
    assert not hasattr(m, "_reconfig")


# ---------------------------------------------------------------------------
# trigger streams
# ---------------------------------------------------------------------------

def test_divergence_observer_arms_after_sustained_windows(tmp_path):
    m, _ = _build()
    ctrl = ReconfigurationController(m, None, str(tmp_path),
                                     policy=ReconfigPolicy(divergence=1.5, sustain=2))

    def div(ratio):
        return {"t": "event", "name": "sim_divergence", "attrs": {"scope": "step",
                                                                  "ratio": ratio}}

    ctrl._observe(div(0.5))
    assert ctrl._pending is None
    ctrl._observe(div(1.1))  # back within the threshold: the streak resets
    ctrl._observe(div(0.5))
    assert ctrl._pending is None
    ctrl._observe(div(2.0))
    assert ctrl._pending[0] == "divergence"
    ctrl._pending = None
    ctrl._observe({"t": "event", "name": "sim_divergence",
                   "attrs": {"scope": "epoch", "ratio": 9.0}})
    ctrl._observe({"t": "event", "name": "step", "attrs": {"ratio": 9.0}})
    assert ctrl._pending is None


def test_chaos_device_loss_and_gain_probe(tmp_path, monkeypatch):
    """The probe takes the last ranks of the roster; one device is never
    lost (on a one-card machine a loss is a no-op)."""
    from flexflow_tpu_torch.testing.chaos import ChaosMonkey

    m, _ = _build()
    m._chaos = ChaosMonkey("resharding:2=device_loss:4;resharding:5=device_gain:4")
    ctrl = ReconfigurationController(m, None, str(tmp_path), policy=ReconfigPolicy())
    ctrl._full_ranks = list(range(8))  # the roster of an 8-rank job
    fired = []
    monkeypatch.setattr(ctrl, "_launch", lambda: (fired.append(ctrl._pending),
                                                  setattr(ctrl, "_pending", None)))
    for step in range(1, 7):
        m._step_count = step
        ctrl.on_step()
    assert [t for (t, _) in fired] == ["device_loss", "device_gain"]
    assert fired[0][1]["lost"] == [4, 5, 6, 7] and fired[1][1]["lost"] == []
    one = ReconfigurationController(m, None, str(tmp_path / "one"), policy=ReconfigPolicy())
    m._chaos = ChaosMonkey("resharding:1=device_loss:4")
    m._chaos.fire("resharding", index=1, model=m)
    assert one._probe() == frozenset()


# ---------------------------------------------------------------------------
# device loss and gain: four gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reshard_job(tmp_path_factory):
    from flexflow_tpu_torch.testing.chaos_smoke import reshard_job

    return reshard_job(str(tmp_path_factory.mktemp("reshard")), "cpu", 4,
                       weights=_flat_params(_jax_weights()))


def _flat_params(tree):
    return {f"params/{opn}/{wn}": w for opn, ws in tree.items() for wn, w in ws.items()}


def test_device_loss_hot_swap_onto_the_survivors(reshard_job):
    from flexflow_tpu_torch.tools.search_report import read_sidecar, render_diff

    for rank, rec in enumerate(reshard_job["ranks"]):
        assert [tuple(s) for s in rec["run1"]["swaps"]][0] == (6, "device_loss", "applied")
        assert rec["run1"]["steps"] == 12  # the benched ranks kept the step count
    loss = reshard_job["ranks"][0]["run1"]["events"][0]
    assert loss["trigger"] == "device_loss" and loss["step"] == 6
    assert (loss["old_devices"], loss["new_devices"]) == (4, 2)
    assert loss["probation"] == "skipped_device_change" and loss["lost"] == [2, 3]
    meta_old, status = read_sidecar(loss["old_pb"])
    assert status == "ok" and meta_old["engine"] == "active" and meta_old["num_devices"] == 4
    meta_new, status = read_sidecar(loss["new_pb"])
    assert status == "ok" and meta_new["engine"] == "reconfig-mcmc"
    assert meta_new["num_devices"] == 2 and meta_new["budget"] == 40
    out = render_diff(loss["old_pb"], loss["new_pb"])
    assert "reconfig-mcmc" in out


def test_device_gain_takes_the_benched_ranks_back(reshard_job):
    for rec in reshard_job["ranks"]:
        assert [tuple(s) for s in rec["run1"]["swaps"]][1] == (9, "device_gain", "applied")
        assert rec["run1"]["devices"] == 4 and rec["run1"]["finite"]
    gain = reshard_job["ranks"][0]["run1"]["events"][1]
    assert (gain["old_devices"], gain["new_devices"], gain["lost"]) == (2, 4, [])


def test_hot_swap_is_deterministic(reshard_job):
    from flexflow_tpu_torch.testing.chaos_smoke import check_reshard

    assert check_reshard(reshard_job) > 0
    for p1, p2 in zip(reshard_job["run1_params"], reshard_job["run2_params"]):
        for name, w in p1.items():
            np.testing.assert_array_equal(p2[name], w)


def test_every_rank_ends_at_the_unswapped_run(reshard_job, tmp_path):
    """Every rank (the survivors and the benched ranks taken back) holds
    the weights of the same 12 steps on one device with no swap, and that
    run equals the JAX package's on one device from the same weights."""
    ref = reshard_job["reference_params"]
    assert len(reshard_job["run1_params"]) == 4
    for rank, got in enumerate(reshard_job["run1_params"]):
        for name, w in ref.items():
            np.testing.assert_allclose(got[name], w, **PARITY_TOL,
                                       err_msg=f"rank {rank} {name}")
    from flexflow_tpu.runtime.elastic import elastic_train as jax_elastic_train

    jm, jdl = _build_jax()
    jax_elastic_train(jm, jdl, epochs=4, checkpoint_dir=str(tmp_path / "jax"))
    for name, w in _flat_params(_jax_params(jm)).items():
        np.testing.assert_allclose(ref[name], w, **PARITY_TOL, err_msg=name)


def test_swap_steps_equal_the_jax_package(reshard_job, tmp_path, monkeypatch):
    """The JAX package's controller, same lag and chaos steps, half of its
    8-device mesh lost and regained: the same swaps at the same steps."""
    from flexflow_tpu.observability import events as jax_events
    from flexflow_tpu.runtime.elastic import elastic_train as jax_elastic_train

    for k, v in {"FF_RECONFIGURE": "1", "FF_RECONFIG_BUDGET": "40",
                 "FF_RECONFIG_LAG_STEPS": "2",
                 "FF_CHAOS": "resharding:4=device_loss:4;resharding:7=device_gain:4"}.items():
        monkeypatch.setenv(k, v)
    jax_events.reset_active()
    m, dl = _build_jax(one_device=False)
    for opn, ws in _jax_params(m).items():  # the port's job started here
        for wn, w in ws.items():
            np.testing.assert_array_equal(w, _jax_weights()[opn][wn])
    jax_elastic_train(m, dl, epochs=4, checkpoint_dir=str(tmp_path / "ck"))
    port = [tuple(s) for s in reshard_job["ranks"][0]["run1"]["swaps"]]
    assert [tuple(s) for s in m._reconfig.swaps] == port
    # and ended at the same weights
    for name, w in _flat_params(_jax_params(m)).items():
        for rank, got in enumerate(reshard_job["run1_params"]):
            np.testing.assert_allclose(got[name], w, **PARITY_TOL,
                                       err_msg=f"rank {rank} {name}")


# ---------------------------------------------------------------------------
# acceptance gate + probation
# ---------------------------------------------------------------------------

def test_no_swap_below_gain_threshold(tmp_path, monkeypatch):
    for k, v in {"FF_RECONFIGURE": "1", "FF_RECONFIG_BUDGET": "40",
                 "FF_RECONFIG_GAIN": "0.99", "FF_TELEMETRY": "1",
                 "FF_TELEMETRY_FILE": str(tmp_path / "trace.jsonl")}.items():
        monkeypatch.setenv(k, v)
    events.reset_active()
    m, dl = _build()
    before = strategies_fingerprint(m._all_strategies())
    elastic_train(m, dl, epochs=3, checkpoint_dir=str(tmp_path / "ckpt"), on_epoch=_kick([m]))
    swaps = _swap_events(tmp_path / "trace.jsonl")
    assert [s["outcome"] for s in swaps] == ["rejected_gain"] and swaps[0]["threshold"] == 0.99
    assert strategies_fingerprint(m._all_strategies()) == before
    assert not glob.glob(str(tmp_path / "ckpt" / "reconfig" / "*.pb"))


def test_probation_rollback_on_planted_regression(tmp_path, monkeypatch):
    from flexflow_tpu.runtime.elastic import elastic_train as jax_elastic_train

    for k, v in {**ROLLBACK_ENV, "FF_TELEMETRY": "1",
                 "FF_TELEMETRY_FILE": str(tmp_path / "trace.jsonl")}.items():
        monkeypatch.setenv(k, v)
    events.reset_active()
    m, dl = _build()
    before = strategies_fingerprint(m._all_strategies())
    elastic_train(m, dl, epochs=5, checkpoint_dir=str(tmp_path / "ckpt"), on_epoch=_kick([m]))
    assert m._reconfig.swaps[0] == (6, "divergence", "applied")
    assert [o for (_, _, o) in m._reconfig.swaps] == ["applied", "rolled_back"]
    rb = [s for s in _swap_events(tmp_path / "trace.jsonl") if s["outcome"] == "rolled_back"][0]
    assert rb["swap_step"] == 6 and rb["measured_post_ms"] > rb["measured_pre_ms"] * 1.3
    assert strategies_fingerprint(m._all_strategies()) == before
    assert m._step_count == 15 and np.isfinite(m.get_parameter("fc1", "kernel")).all()
    assert len(glob.glob(str(tmp_path / "ckpt" / "reconfig" / "*.pb"))) == 2
    # the JAX package swaps and rolls back at the same steps
    monkeypatch.delenv("FF_TELEMETRY")
    jm, jdl = _build_jax()
    jax_elastic_train(jm, jdl, epochs=5, checkpoint_dir=str(tmp_path / "jax"),
                      on_epoch=_kick([jm]))
    assert [tuple(s) for s in jm._reconfig.swaps] == m._reconfig.swaps


def test_probation_ok_keeps_new_strategy(tmp_path, monkeypatch):
    for k, v in {"FF_RECONFIGURE": "1", "FF_RECONFIG_BUDGET": "40", "FF_RECONFIG_GAIN": "-10",
                 "FF_RECONFIG_PROBATION": "3", "FF_RECONFIG_REGRESS": "5.0",
                 "FF_TELEMETRY": "1",
                 "FF_TELEMETRY_FILE": str(tmp_path / "trace.jsonl")}.items():
        monkeypatch.setenv(k, v)
    events.reset_active()
    m, dl = _build()
    elastic_train(m, dl, epochs=4, checkpoint_dir=str(tmp_path / "ckpt"), on_epoch=_kick([m]))
    assert [s["outcome"] for s in _swap_events(tmp_path / "trace.jsonl")] == \
        ["applied", "probation_ok"]


# ---------------------------------------------------------------------------
# resume after a reconfiguration (the strategy hash in resume_meta.json)
# ---------------------------------------------------------------------------

def test_resume_meta_records_strategy_hash(tmp_path):
    m, dl = _build()
    elastic_train(m, dl, epochs=1, checkpoint_dir=str(tmp_path))
    with open(tmp_path / "resume_meta.json") as f:
        meta = json.load(f)
    assert meta["strategy_hash"] == strategies_fingerprint(m._all_strategies())


def test_strategy_mismatch_on_resume(tmp_path):
    """A checkpoint taken under another map (here: fc1 split (4, 2), as a
    swap on a mesh would record it) against a model compiled with the
    one-device map."""
    m, dl = _build()
    elastic_train(m, dl, epochs=1, checkpoint_dir=str(tmp_path))
    meta = read_resume_meta(str(tmp_path))
    other = dict(m._all_strategies(), fc1=ft.ParallelConfig(dims=(4, 2)))
    meta.update(strategy_hash=strategies_fingerprint(other),
                strategy_file=str(tmp_path / "reconfig" / "swap_000_new.pb"))
    write_resume_meta(str(tmp_path), **meta)
    m2, dl2 = _build()
    with pytest.raises(StrategyMismatchError, match="swap_000_new.pb"):
        elastic_train(m2, dl2, epochs=2, checkpoint_dir=str(tmp_path))
    m3, dl3 = _build()
    with pytest.warns(RuntimeWarning, match="strategy"):
        ran = elastic_train(m3, dl3, epochs=2, checkpoint_dir=str(tmp_path),
                            on_strategy_mismatch="recompute")
    assert ran == 1 and m3._step_count == 6
    assert np.isfinite(m3.get_parameter("fc1", "kernel")).all()


def test_elastic_train_rejects_bad_on_strategy_mismatch(tmp_path):
    m, dl = _build()
    with pytest.raises(ValueError, match="on_strategy_mismatch"):
        elastic_train(m, dl, epochs=1, checkpoint_dir=str(tmp_path),
                      on_strategy_mismatch="explode")


# ---------------------------------------------------------------------------
# recompile in place (the hot swap's half, without a controller)
# ---------------------------------------------------------------------------

def _steps(m, dl, n):
    for _ in range(n):
        dl.next_batch(m)
        m.train_iteration()
    m.sync()


def test_recompile_preserves_training_state():
    """3 steps, recompile, 3 steps: the state survives bit for bit, the
    rebuilt step trains, the result equals 6 straight steps bitwise and
    the JAX package's recompile at rtol 1e-5, atol 1e-6."""
    m, dl = _build()
    _steps(m, dl, 3)
    before = {k: m.get_parameter(k, "kernel") for k in ("fc1", "fc2")}
    m.recompile(strategies={"fc1": ft.ParallelConfig(dims=(4, 2))})
    assert m._step_count == 3
    for k, w in before.items():
        np.testing.assert_array_equal(m.get_parameter(k, "kernel"), w)
    assert m._all_strategies()["fc1"].dims == (1, 1)  # one device: legalized
    _steps(m, dl, 3)
    straight, sdl = _build()
    _steps(straight, sdl, 6)
    jm, jdl = _build_jax()
    _steps(jm, jdl, 3)
    jm.recompile(strategies={"fc1": ff.ParallelConfig(dims=(1, 1))})
    _steps(jm, jdl, 3)
    for k in ("fc1", "fc2"):
        np.testing.assert_array_equal(m.get_parameter(k, "kernel"),
                                      straight.get_parameter(k, "kernel"))
        np.testing.assert_allclose(m.get_parameter(k, "kernel"),
                                   np.asarray(jm.get_parameter(k, "kernel")), **PARITY_TOL)


# ---------------------------------------------------------------------------
# watchdog stranded-thread accounting
# ---------------------------------------------------------------------------

def test_watchdog_stranded_cap_and_gauge(tmp_path, monkeypatch):
    trace = tmp_path / "trace.jsonl"
    monkeypatch.setenv("FF_TELEMETRY", "1")
    monkeypatch.setenv("FF_TELEMETRY_FILE", str(trace))
    events.reset_active()
    StepWatchdog._stranded.clear()
    StepWatchdog._warned_sites.clear()
    monkeypatch.setattr(StepWatchdog, "STRANDED_MAX", 4)
    release = threading.Event()
    try:
        wd = StepWatchdog(timeout=0.02)
        with pytest.warns(RuntimeWarning, match="stranded"):
            for _ in range(7):
                with pytest.raises(DeviceHangError):
                    wd.run(release.wait)
        assert len(StepWatchdog._stranded) == 4
        assert len(StepWatchdog._warned_sites) == 1
        with pytest.warns(RuntimeWarning, match="stranded"):
            with pytest.raises(DeviceHangError):
                wd.run(release.wait)  # another call site warns again
        assert len(StepWatchdog._warned_sites) == 2
    finally:
        release.set()
        StepWatchdog._stranded.clear()
        StepWatchdog._warned_sites.clear()
        events.reset_active()
    with open(trace) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    gauges = [r for r in recs if r.get("t") == "gauge" and r.get("name") == "stranded_count"]
    assert len(gauges) == 8 and gauges[-1]["v"] <= 4.0
