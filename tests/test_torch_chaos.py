"""Chaos fault injection and step-level recovery in the port
(flexflow_tpu_torch/testing/chaos.py, runtime/resilience.py), against the
JAX package's: tests/test_chaos.py's cases, on the port.

The grammar parses every spec to the JAX package's tables and rejects
what it rejects, and seeded monkeys of both fire on the same calls.  The
model is tests/test_chaos.py's MLP (8 -> 16 -> 4, Adam 0.01, batch 16) on
one CPU device, its initial weights the JAX package's (``convert``).  A
NaN step is skipped bitwise and training converges; the losses of a run
with a NaN step equal the JAX package's run with the same fault at rtol
1e-5, atol 1e-6 (one f32 device each, the same weights and data); a
failing checkpoint write is retried and leaves no partial file; a SIGTERM
preemption, in process and against a real subprocess, resumes bitwise.
"""

import functools
import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import jax

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.testing import chaos as jax_chaos
from flexflow_tpu_torch.observability import events
from flexflow_tpu_torch.runtime import resilience
from flexflow_tpu_torch.runtime.elastic import elastic_train
from flexflow_tpu_torch.runtime.resilience import (NonFiniteEscalationError, Preempted,
                                                   with_ckpt_retries)
from flexflow_tpu_torch.testing.chaos import (ChaosError, ChaosIOError, ChaosMonkey,
                                              from_env, parse_spec)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("FF_CHAOS", "FF_CHAOS_SEED", "FF_SKIP_NONFINITE", "FF_CKPT_RETRIES",
              "FF_CKPT_BACKOFF_S", "FF_TELEMETRY", "FF_TELEMETRY_FILE", "FF_HEALTH"):
        monkeypatch.delenv(k, raising=False)
    events.reset_active()
    yield
    events.reset_active()


def _data(n_samples=48):
    rng = np.random.default_rng(3)
    return (rng.standard_normal((n_samples, 8), dtype=np.float32),
            rng.integers(0, 4, size=(n_samples, 1), dtype=np.int32))


def _graph(pkg, **cfg):
    m = pkg.FFModel(pkg.FFConfig(batch_size=16, **cfg))
    inp = m.create_tensor((16, 8), nchw=False, name="input")
    t = m.dense(inp, 16, activation="relu", name="fc1")
    t = m.dense(t, 4, name="fc2")
    m.softmax(t, name="sm")
    return m, inp


def _build_jax():
    m, inp = _graph(ff, workers_per_node=1)
    m.compile(ff.AdamOptimizer(alpha=0.01), "sparse_categorical_crossentropy", ["accuracy"],
              machine=ff.Machine(devices=jax.devices()[:1]))
    m.init_layers(seed=9)
    x, y = _data()
    return m, ff.DataLoader(m, {inp: x}, y, seed=5)


@functools.lru_cache(maxsize=None)
def _jax_weights():
    from flexflow_tpu_torch.convert import jax_params_to_numpy

    return jax_params_to_numpy(_build_jax()[0])


def _build(n_samples=48):
    """The port's model on the JAX package's initial weights."""
    from flexflow_tpu_torch.convert import load_jax_params

    m, inp = _graph(ft, device="cpu")
    m.compile(ft.AdamOptimizer(alpha=0.01), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=9)
    load_jax_params(m, _jax_weights())
    x, y = _data(n_samples)
    return m, ft.DataLoader(m, {inp: x}, y, seed=5)


# ---------------------------------------------------------------------------
# spec grammar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "step:23=nan_loss;step:40=hang:2;ckpt_save:2=io_error;step:57=sigterm",
    "data:p0.25=error", "resharding:4=device_loss:2;resharding:7=device_gain:2",
    "serve:3=replica_kill;serve:6=zone_outage:1;sync:1=hang:5;ckpt_restore:1=io_error",
])
def test_parse_spec_grammar(spec):
    """Every site and fault parses to the JAX package's tables."""
    assert parse_spec(spec) == jax_chaos.parse_spec(spec)
    exact, prob = parse_spec(
        "step:23=nan_loss;step:40=hang:2;ckpt_save:2=io_error;step:57=sigterm")
    assert exact[("step", 40)] == ("hang", 2.0) and prob == []


@pytest.mark.parametrize("bad", [
    "nonsense", "step:=nan_loss", "badsite:1=nan_loss",
    "step:1=badfault", "step:px=error", "step:p1.5=error",
    "step:-1=error", "step:1=hang:soon", ";;",
])
def test_parse_spec_rejects_bad_entries(bad):
    with pytest.raises(ValueError):
        parse_spec(bad)
    with pytest.raises(ValueError):
        jax_chaos.parse_spec(bad)


def test_exact_trigger_fires_once_and_prob_is_seeded():
    mk = ChaosMonkey("sync:2=error")
    assert mk.fire("sync") is None
    with pytest.raises(ChaosError):
        mk.fire("sync")
    assert mk.fire("sync") is None
    assert mk.fired == [("sync", 2, "error")]

    def hit_indices(monkey_cls, error):
        mk = monkey_cls("data:p0.2=error", seed=7)
        hits = []
        for i in range(200):
            try:
                mk.fire("data")
            except error:
                hits.append(i)
        return hits

    a = hit_indices(ChaosMonkey, ChaosError)
    assert a == hit_indices(ChaosMonkey, ChaosError) and 10 < len(a) < 80
    # the JAX package's monkey fires on the same calls
    assert a == hit_indices(jax_chaos.ChaosMonkey, jax_chaos.ChaosError)


def test_from_env_zero_cost_when_unset():
    assert from_env() is None
    m, _ = _build()
    assert m._chaos is None and m._guard is None
    assert m._metric_keys() == ("train_all", "train_correct", "cce_loss", "sparse_cce_loss",
                                "mse_loss", "rmse_loss", "mae_loss", "loss", "steps")


# ---------------------------------------------------------------------------
# the non-finite guard
# ---------------------------------------------------------------------------

def _losses(m, dl, steps=12, probe=None):
    losses = []
    for i in range(steps):
        dl.next_batch(m)
        if probe:
            probe(i, "pre")
        m.train_iteration()
        if probe:
            probe(i, "post")
        m.get_metrics()
        if m.last_loss is not None:
            losses.append(m.last_loss)
    return losses


def test_nan_step_is_skipped_bitwise_and_training_converges(monkeypatch):
    monkeypatch.setenv("FF_CHAOS", "step:2=nan_loss")
    monkeypatch.setenv("FF_SKIP_NONFINITE", "5")
    m, dl = _build()
    seen = {}

    def probe(i, when):
        if i == 2:
            seen[when] = m.get_parameter("fc1", "kernel")

    losses = _losses(m, dl, probe=probe)
    assert (seen["pre"] == seen["post"]).all()  # the poisoned step changed nothing
    assert m._guard.total_skipped == 1
    assert m._chaos.fired == [("step", 2, "nan_loss")]
    assert all(np.isfinite(v) for v in losses) and losses[-1] < losses[0]
    # the JAX package under the same fault, on the same weights and data
    jm, jdl = _build_jax()
    np.testing.assert_allclose(losses, _losses(jm, jdl), **LOSS_TOL)
    assert jm._nonfinite_guard.total_skipped == 1


def test_persistent_nan_escalates(monkeypatch):
    monkeypatch.setenv("FF_CHAOS", "step:1=nan_loss;step:2=nan_loss;step:3=nan_loss")
    monkeypatch.setenv("FF_SKIP_NONFINITE", "3")
    m, dl = _build()
    with pytest.raises(NonFiniteEscalationError, match="3 consecutive"):
        for _ in range(6):
            dl.next_batch(m)
            m.train_iteration()
            m.get_metrics()


def test_consec_run_survives_metric_reset(monkeypatch):
    monkeypatch.setenv("FF_CHAOS", "step:1=nan_loss;step:2=nan_loss;step:3=nan_loss")
    monkeypatch.setenv("FF_SKIP_NONFINITE", "3")
    m, dl = _build()
    with pytest.raises(NonFiniteEscalationError):
        for _ in range(6):
            dl.next_batch(m)
            m.train_iteration()
            m.get_metrics()
            m.reset_metrics()  # an epoch boundary between every step


# ---------------------------------------------------------------------------
# retried atomic checkpoint I/O
# ---------------------------------------------------------------------------

def test_ckpt_io_error_retried_no_partial_file(tmp_path, monkeypatch):
    monkeypatch.setenv("FF_CHAOS", "ckpt_save:1=io_error;ckpt_restore:1=io_error")
    monkeypatch.setenv("FF_CKPT_BACKOFF_S", "0.01")
    m, _ = _build()
    path = str(tmp_path / "w.npz")
    m.save(path)  # attempt 1 fails, the retry succeeds
    assert os.path.exists(path) and not glob.glob(str(tmp_path / "*.tmp-*"))
    m.load(path)  # so does the read
    assert m._chaos.fired == [("ckpt_save", 1, "io_error"), ("ckpt_restore", 1, "io_error")]
    # the JAX package reads the file the port wrote after its retry
    jm, _ = _build_jax()
    jm.load(path)
    np.testing.assert_array_equal(np.asarray(jm.get_parameter("fc1", "kernel")),
                                  m.get_parameter("fc1", "kernel"))


def test_ckpt_retries_exhausted_propagates():
    calls = []

    def always_fails():
        calls.append(1)
        raise ChaosIOError("disk on fire")

    with pytest.raises(ChaosIOError):
        with_ckpt_retries(always_fails, retries=2, base_delay=0.0, sleep=lambda s: None)
    assert len(calls) == 3  # 1 + 2 retries


def test_atomic_npz_failed_write_leaves_nothing(tmp_path, monkeypatch):
    from flexflow_tpu_torch.runtime import checkpoint as ck

    monkeypatch.setenv("FF_CKPT_RETRIES", "0")
    m, _ = _build()
    real = np.savez

    def boom(f, **kw):
        real(f, **kw)               # bytes reach the temporary file...
        raise OSError("disk full")  # ...then the write fails

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        ck.save_checkpoint(m, str(tmp_path / "x.npz"))
    assert os.listdir(tmp_path) == []  # no final file, no temporary


# ---------------------------------------------------------------------------
# telemetry narration
# ---------------------------------------------------------------------------

def test_recovery_events_reach_trace_and_reports(tmp_path, monkeypatch):
    trace = str(tmp_path / "trace.jsonl")
    monkeypatch.setenv("FF_TELEMETRY", "1")
    monkeypatch.setenv("FF_TELEMETRY_FILE", trace)
    monkeypatch.setenv("FF_CHAOS", "step:2=nan_loss;ckpt_save:1=io_error")
    monkeypatch.setenv("FF_SKIP_NONFINITE", "5")
    monkeypatch.setenv("FF_CKPT_BACKOFF_S", "0.01")
    events.reset_active()
    m, dl = _build()
    for _ in range(4):
        dl.next_batch(m)
        m.train_iteration()
    m.get_metrics()
    m.save(str(tmp_path / "w.npz"))
    m._telemetry.flush()
    events.reset_active()

    names = [json.loads(line).get("name") for line in open(trace) if line.strip()]
    for name in ("fault_injected", "step_skipped", "ckpt_retry"):
        assert name in names
    # the port's reports and the JAX package's fold the port's trace alike
    from flexflow_tpu.tools import health_report as jax_health_report
    from flexflow_tpu.tools import trace_report as jax_trace_report
    from flexflow_tpu_torch.tools import health_report, trace_report

    rep = trace_report.main([trace, "-o", str(tmp_path / "r.md")])
    assert "## Resilience" in rep and "nan_loss" in rep and "ckpt_retry" in rep
    assert rep == jax_trace_report.main([trace, "-o", str(tmp_path / "rj.md")])
    hrep = health_report.main([trace, "-o", str(tmp_path / "h.md")])
    assert "## Recovery" in hrep and "non-finite steps skipped: 1" in hrep
    assert hrep == jax_health_report.main([trace, "-o", str(tmp_path / "hj.md")])


# ---------------------------------------------------------------------------
# preemption (in-process signal and a real subprocess kill)
# ---------------------------------------------------------------------------

def test_sigterm_preemption_saves_then_resume_is_bitwise(tmp_path, monkeypatch):
    mb, dlb = _build()
    elastic_train(mb, dlb, epochs=2, checkpoint_dir=str(tmp_path / "base"))
    base = mb.get_parameter("fc1", "kernel")

    # chaos delivers a real SIGTERM during step 4's update; the step
    # completes, the loop saves at the next boundary and exits cleanly
    monkeypatch.setenv("FF_CHAOS", "step:4=sigterm")
    m, dl = _build()
    with pytest.raises(Preempted) as ei:
        elastic_train(m, dl, epochs=2, checkpoint_dir=str(tmp_path / "ck"))
    assert ei.value.code == 0 and ei.value.step == 5
    meta = resilience.read_resume_meta(str(tmp_path / "ck"))
    assert meta["step"] == 5 and meta["steps_per_epoch"] == 3

    monkeypatch.delenv("FF_CHAOS")
    m2, dl2 = _build()
    elastic_train(m2, dl2, epochs=2, checkpoint_dir=str(tmp_path / "ck"))
    assert m2._step_count == 6
    np.testing.assert_array_equal(m2.get_parameter("fc1", "kernel"), base)


_CHILD = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.runtime.elastic import elastic_train

m = ft.FFModel(ft.FFConfig(batch_size=16, device="cpu"))
inp = m.create_tensor((16, 8), nchw=False, name="input")
t = m.dense(inp, 16, activation="relu", name="fc1")
t = m.dense(t, 4, name="fc2")
m.softmax(t, name="sm")
m.compile(ft.AdamOptimizer(alpha=0.01), "sparse_categorical_crossentropy", ["accuracy"])
m.init_layers(seed=9)
w = np.load({weights!r}, allow_pickle=True).item()
for opn, ws in w.items():
    for wn, v in ws.items():
        m.set_parameter(opn, wn, v)
rng = np.random.default_rng(3)
x = rng.standard_normal((48, 8), dtype=np.float32)
y = rng.integers(0, 4, size=(48, 1), dtype=np.int32)
dl = ft.DataLoader(m, {{inp: x}}, y, seed=5)
print("READY", flush=True)
elastic_train(m, dl, epochs=100000, checkpoint_dir={ckpt!r})
"""


def test_kill_term_subprocess_then_rerun_matches_uninterrupted(tmp_path):
    """A real ``kill -TERM`` of a training process (imports only the port):
    it saves and exits 0, and a rerun lands on the uninterrupted run's
    trajectory exactly."""
    ckpt = str(tmp_path / "ck")
    weights = str(tmp_path / "w.npy")
    np.save(weights, _jax_weights(), allow_pickle=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("FF_CHAOS", "FF_TELEMETRY", "FF_HEALTH")}
    proc = subprocess.Popen([sys.executable, "-c", _CHILD.format(root=ROOT, ckpt=ckpt,
                                                                 weights=weights)],
                            env=env, stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        # mid-run: wait for a first epoch's checkpoint, then kill
        deadline = time.monotonic() + 60
        while not glob.glob(os.path.join(ckpt, "ckpt_*.npz")) and time.monotonic() < deadline:
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0  # a clean exit after the save
    finally:
        if proc.poll() is None:
            proc.kill()
    meta = resilience.read_resume_meta(ckpt)
    assert meta is not None and meta["step"] > 0
    target_epochs = int(meta["step"]) // 3 + 2
    m2, dl2 = _build()
    elastic_train(m2, dl2, epochs=target_epochs, checkpoint_dir=ckpt)
    mb, dlb = _build()
    elastic_train(mb, dlb, epochs=target_epochs, checkpoint_dir=str(tmp_path / "base"))
    assert m2._step_count == mb._step_count
    np.testing.assert_array_equal(m2.get_parameter("fc1", "kernel"),
                                  mb.get_parameter("fc1", "kernel"))


# ---------------------------------------------------------------------------
# data / sync sites
# ---------------------------------------------------------------------------

def test_data_and_sync_sites_fire(monkeypatch):
    monkeypatch.setenv("FF_CHAOS", "data:2=error;sync:1=error")
    m, dl = _build()
    dl.next_batch(m)          # data call 1: no fire
    with pytest.raises(ChaosError, match="data:2"):
        dl.next_batch(m)      # data call 2 fires
    with pytest.raises(ChaosError, match="sync:1"):
        m.sync()
