"""Elastic training in the port (flexflow_tpu_torch/runtime/elastic.py):
tests/test_elastic.py's cases, the dropout resume (ROADMAP C8) and the
JAX package's loop on the same inputs.

The model is tests/test_elastic.py's MLP (8 -> 16 -> 4, batch 16, Adam
0.01 or SGD 0.1 momentum 0.9) on one CPU device, its initial weights the
JAX package's (``convert``).  A resumed run must equal an uninterrupted
one bitwise; the port's loop, preempted and resumed, must end within
rtol 1e-5, atol 1e-6 of the JAX package's loop preempted and resumed
alike (one f32 device each); a wedged call must surface as
DeviceHangError.
"""

import functools
import json
import threading
import time

import numpy as np
import pytest

import jax

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.observability import events
from flexflow_tpu_torch.runtime.elastic import DeviceHangError, StepWatchdog, elastic_train
from flexflow_tpu_torch.runtime.resilience import Preempted, ResumeMismatchError

PARITY_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("FF_CHAOS", "FF_SKIP_NONFINITE", "FF_TELEMETRY", "FF_TELEMETRY_FILE",
              "FF_HEALTH", "FF_RECONFIGURE"):
        monkeypatch.delenv(k, raising=False)
    events.reset_active()
    yield
    events.reset_active()


def _graph(pkg, dropout=0.0, **cfg):
    m = pkg.FFModel(pkg.FFConfig(batch_size=16, **cfg))
    inp = m.create_tensor((16, 8), nchw=False, name="input")
    t = m.dense(inp, 16, activation="relu", name="fc1")
    if dropout:
        t = m.dropout(t, dropout, name="drop")
    t = m.dense(t, 4, name="fc2")
    m.softmax(t, name="sm")
    return m, inp


def _optimizer(pkg, opt):
    return (pkg.AdamOptimizer(alpha=0.01) if opt == "adam"
            else pkg.SGDOptimizer(lr=0.1, momentum=0.9))


def _data(n_samples):
    rng = np.random.default_rng(3)
    return (rng.standard_normal((n_samples, 8), dtype=np.float32),
            rng.integers(0, 4, size=(n_samples, 1), dtype=np.int32))


def _build_jax(opt="adam", n_samples=48):
    m, inp = _graph(ff, workers_per_node=1)
    m.compile(_optimizer(ff, opt), "sparse_categorical_crossentropy", ["accuracy"],
              machine=ff.Machine(devices=jax.devices()[:1]))
    m.init_layers(seed=9)
    x, y = _data(n_samples)
    return m, ff.DataLoader(m, {inp: x}, y, seed=5)


@functools.lru_cache(maxsize=None)
def _jax_weights():
    from flexflow_tpu_torch.convert import jax_params_to_numpy

    return jax_params_to_numpy(_build_jax()[0])


def _build(opt="adam", n_samples=48, dropout=0.0):
    from flexflow_tpu_torch.convert import load_jax_params

    m, inp = _graph(ft, dropout=dropout, device="cpu")
    m.compile(_optimizer(ft, opt), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=9)
    load_jax_params(m, _jax_weights())
    x, y = _data(n_samples)
    return m, ft.DataLoader(m, {inp: x}, y, seed=5)


def _weights(m):
    return {n: m.get_parameter(n, "kernel") for n in ("fc1", "fc2")}


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_resume_matches_uninterrupted(tmp_path, opt):
    """2 epochs + restart + 2 more == 4 straight epochs, bitwise (same
    shuffle stream, same per-step seeds, same Adam schedule)."""
    ck1 = str(tmp_path / "ck_interrupted")
    m1, dl1 = _build(opt)
    assert elastic_train(m1, dl1, epochs=2, checkpoint_dir=ck1) == 2
    m2, dl2 = _build(opt)
    assert elastic_train(m2, dl2, epochs=4, checkpoint_dir=ck1) == 2
    m3, dl3 = _build(opt)
    assert elastic_train(m3, dl3, epochs=4, checkpoint_dir=str(tmp_path / "ck_straight")) == 4
    for name, w in _weights(m3).items():
        np.testing.assert_array_equal(_weights(m2)[name], w)


def test_failure_saves_then_propagates(tmp_path):
    m, dl = _build()

    def on_epoch(epoch, metrics):
        if epoch == 1:
            raise RuntimeError("injected failure")

    with pytest.raises(RuntimeError, match="injected failure"):
        elastic_train(m, dl, epochs=4, checkpoint_dir=str(tmp_path / "ck"), on_epoch=on_epoch)
    m2, dl2 = _build()
    ran = elastic_train(m2, dl2, epochs=4, checkpoint_dir=str(tmp_path / "ck"))
    assert 0 < ran < 4  # resumed from the save the failure made


def test_step_granular_resume_mid_epoch(tmp_path):
    mb, dlb = _build()
    elastic_train(mb, dlb, epochs=2, checkpoint_dir=str(tmp_path / "base"))

    m, dl = _build()
    calls = {"n": 0}
    real_next = type(dl).next_batch

    def crashing_next(self, ff_=None):
        calls["n"] += 1
        if calls["n"] == 5:  # step 4: one step into epoch 2
            raise RuntimeError("mid-epoch crash")
        return real_next(self, ff_)

    dl.next_batch = crashing_next.__get__(dl)
    with pytest.raises(RuntimeError, match="mid-epoch crash"):
        elastic_train(m, dl, epochs=2, checkpoint_dir=str(tmp_path / "ck"), save_every_steps=1)
    m2, dl2 = _build()
    ran = elastic_train(m2, dl2, epochs=2, checkpoint_dir=str(tmp_path / "ck"),
                        save_every_steps=1)
    assert ran == 1 and m2._step_count == 6
    np.testing.assert_array_equal(m2.get_parameter("fc1", "kernel"),
                                  mb.get_parameter("fc1", "kernel"))


def test_resume_mismatch_named_error_and_recompute(tmp_path):
    m, dl = _build()
    elastic_train(m, dl, epochs=1, checkpoint_dir=str(tmp_path / "ck"))
    m2, dl2 = _build(n_samples=64)  # 3 -> 4 steps/epoch
    with pytest.raises(ResumeMismatchError, match="3 steps/epoch"):
        elastic_train(m2, dl2, epochs=2, checkpoint_dir=str(tmp_path / "ck"))
    m3, dl3 = _build(n_samples=64)
    with pytest.warns(RuntimeWarning, match="recomputing"):
        ran = elastic_train(m3, dl3, epochs=2, checkpoint_dir=str(tmp_path / "ck"),
                            on_steps_mismatch="recompute")
    assert ran > 0


def test_watchdog_detects_hang():
    wd = StepWatchdog(timeout=0.3)
    t0 = time.perf_counter()
    with pytest.raises(DeviceHangError):
        wd.run(time.sleep, 5.0)  # stands in for a blocked synchronize
    assert time.perf_counter() - t0 < 2.0


def test_watchdog_passes_through_results_and_errors():
    wd = StepWatchdog(timeout=5.0)
    assert wd.run(lambda: 42) == 42
    with pytest.raises(ValueError):
        wd.run(lambda: (_ for _ in ()).throw(ValueError("x")))


def test_watchdog_names_threads_and_narrates_hangs(tmp_path, monkeypatch):
    trace = tmp_path / "trace.jsonl"
    monkeypatch.setenv("FF_TELEMETRY", "1")
    monkeypatch.setenv("FF_TELEMETRY_FILE", str(trace))
    events.reset_active()
    StepWatchdog._stranded.clear()
    StepWatchdog._warned_sites.clear()
    release = threading.Event()
    try:
        wd = StepWatchdog(timeout=0.05)
        with pytest.raises(DeviceHangError, match="ff-watchdog-"):
            wd.run(release.wait)
        assert [t for t in threading.enumerate() if t.name.startswith("ff-watchdog-")]
        with pytest.warns(RuntimeWarning, match="stranded"):
            for _ in range(StepWatchdog.STRANDED_WARN_AT - 1):
                with pytest.raises(DeviceHangError):
                    wd.run(release.wait)
    finally:
        release.set()
        StepWatchdog._stranded.clear()
        StepWatchdog._warned_sites.clear()
        events.reset_active()
    names = [json.loads(line).get("name") for line in open(trace) if line.strip()]
    assert names.count("device_hang") == StepWatchdog.STRANDED_WARN_AT


def test_watchdog_on_a_chaos_sync_hang(monkeypatch):
    """``sync:1=hang`` plants a wedged synchronize: the watchdog gives
    DeviceHangError after its deadline, and the model trains on."""
    monkeypatch.setenv("FF_CHAOS", "sync:1=hang:1.0")
    m, dl = _build()
    t0 = time.perf_counter()
    with pytest.raises(DeviceHangError):
        StepWatchdog(0.2).run(m.sync)
    assert time.perf_counter() - t0 < 0.9
    dl.next_batch(m)
    m.train_iteration()
    m.sync()


# ---------------------------------------------------------------------------
# ROADMAP C8: dropout's draws are a function of (seed, step)
# ---------------------------------------------------------------------------

def test_dropout_resume_from_checkpoint_is_bitwise(tmp_path):
    """4 steps of a dropout-0.1 model uninterrupted against 2 steps, a
    save, a load into a fresh model and 2 more: bitwise equal (a restored
    model draws step k+1's masks, not step 1's again)."""
    def run(steps, m=None, dl=None):
        if m is None:
            m, dl = _build(dropout=0.1)
        for _ in range(steps):
            dl.next_batch(m)
            m.train_iteration()
        return m, dl

    straight, _ = run(4)
    first, dl = run(2)
    first.save(str(tmp_path / "c.npz"))
    resumed, dl2 = _build(dropout=0.1)
    resumed.load(str(tmp_path / "c.npz"))
    dl2.skip_batches(2)
    run(2, resumed, dl2)
    assert resumed._step_count == straight._step_count == 4
    for name, w in _weights(straight).items():
        np.testing.assert_array_equal(_weights(resumed)[name], w)
    # the masks do differ from step to step (dropout is on)
    plain, _ = run(4, *_build())
    assert not np.array_equal(_weights(plain)["fc2"], _weights(straight)["fc2"])


def test_elastic_train_dropout_resume_is_bitwise(tmp_path, monkeypatch):
    base, dlb = _build(dropout=0.1)
    elastic_train(base, dlb, epochs=3, checkpoint_dir=str(tmp_path / "base"))
    monkeypatch.setenv("FF_CHAOS", "step:4=sigterm")
    victim, dlv = _build(dropout=0.1)
    with pytest.raises(Preempted):
        elastic_train(victim, dlv, epochs=3, checkpoint_dir=str(tmp_path / "ck"))
    monkeypatch.delenv("FF_CHAOS")
    resumed, dlr = _build(dropout=0.1)
    elastic_train(resumed, dlr, epochs=3, checkpoint_dir=str(tmp_path / "ck"))
    for name, w in _weights(base).items():
        np.testing.assert_array_equal(_weights(resumed)[name], w)


# ---------------------------------------------------------------------------
# against the JAX package's loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_preempted_resume_matches_the_jax_package(tmp_path, monkeypatch, opt):
    """Both packages' elastic_train on the same weights and data, preempted
    by SIGTERM during step 4 and resumed in a fresh model: the same step,
    the same saved position, weights within rtol 1e-5, atol 1e-6."""
    from flexflow_tpu.runtime.elastic import elastic_train as jax_elastic_train
    from flexflow_tpu.runtime.resilience import Preempted as JaxPreempted

    out = {}
    for name, build, train, preempted in (
            ("port", lambda: _build(opt), elastic_train, Preempted),
            ("jax", lambda: _build_jax(opt), jax_elastic_train, JaxPreempted)):
        ck = str(tmp_path / name)
        monkeypatch.setenv("FF_CHAOS", "step:4=sigterm")
        m, dl = build()
        with pytest.raises(preempted) as ei:
            train(m, dl, epochs=3, checkpoint_dir=ck)
        monkeypatch.delenv("FF_CHAOS")
        m2, dl2 = build()
        train(m2, dl2, epochs=3, checkpoint_dir=ck)
        out[name] = (ei.value.step, m2._step_count,
                     {n: np.asarray(m2.get_parameter(n, "kernel")) for n in ("fc1", "fc2")})
    assert out["port"][:2] == out["jax"][:2] == (5, 9)
    for n, w in out["jax"][2].items():
        np.testing.assert_allclose(out["port"][2][n], w, **PARITY_TOL)
