"""The port's chipwatch (observability/chipwatch.py) on the CPU: a port of
each case of tests/test_chipwatch.py with fake probe and measure commands
at platform "cuda", held against the JAX package's module where the
function is shared (backoff_delays), and against the port's cost model
(read_measured_count counts what read_measured reads).  Subprocess probes
never hang the parent; a killed measurement still leaves a readable,
monotonically grown cache; the default probe on a host without a card
fails and says so."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from flexflow_tpu.observability import chipwatch as jax_chipwatch
from flexflow_tpu_torch.observability import chipwatch, events
from flexflow_tpu_torch.simulator import cost_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Fake probe commands: plain python -c, no torch import (fast).
PROBE_OK = [sys.executable, "-c", "print('GPU_OK fake_h100 16777216.0')"]
PROBE_FAIL = [sys.executable, "-c",
              "import sys; print('no gpu', file=sys.stderr); sys.exit(1)"]
PROBE_HANG = [sys.executable, "-c", "import time; time.sleep(600)"]

# Fake measurement backend: grows a measured-cache file one entry at a time
# (temporary file + rename, like CostModel._persist), resuming from what an
# interrupted window already persisted.
FAKE_MEASURE = r"""
import json, os, sys, time
path, n, delay = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
data = {}
if os.path.exists(path):
    data = json.load(open(path))
start = len(data)
for i in range(start, start + n):
    data[f"FakeOp:({i},):():k:bfloat16:forward"] = {
        "t": 1e-4, "measured": True, "platform": "cuda"}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)
    time.sleep(delay)
"""


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("FF_TELEMETRY", "FF_TELEMETRY_FILE"):
        monkeypatch.delenv(var, raising=False)
    events.reset_active()
    yield
    events.reset_active()


def _measure_cmd(cache, n, delay):
    return [sys.executable, "-c", FAKE_MEASURE, cache, str(n), str(delay)]


def test_probe_once_ok():
    res = chipwatch.probe_once(timeout=30.0, probe_cmd=PROBE_OK)
    assert res.ok and res.device_kind == "fake_h100"
    assert res.latency_s >= 0


def test_probe_once_failure_carries_stderr():
    res = chipwatch.probe_once(timeout=30.0, probe_cmd=PROBE_FAIL)
    assert not res.ok
    assert "no gpu" in res.detail


def test_probe_once_kills_hung_child():
    t0 = time.monotonic()
    res = chipwatch.probe_once(timeout=1.0, probe_cmd=PROBE_HANG)
    assert not res.ok
    assert "no answer in 1s" in res.detail
    # the child was killed: the parent is back long before its 600 s sleep
    assert time.monotonic() - t0 < 30.0


@pytest.mark.parametrize("args", [dict(initial=10.0, factor=2.0, cap=35.0),
                                  dict(initial=20.0, factor=2.0, cap=600.0),
                                  dict(initial=0.25, factor=3.0, cap=5.0)])
def test_backoff_is_capped_and_equals_the_jax_package(args):
    ours, theirs = chipwatch.backoff_delays(**args), jax_chipwatch.backoff_delays(**args)
    got = [next(ours) for _ in range(8)]
    assert got == [next(theirs) for _ in range(8)]
    assert max(got) == args["cap"]
    if args["cap"] == 35.0:
        assert got[:5] == [10.0, 20.0, 35.0, 35.0, 35.0]


def test_wait_for_chip_backs_off_then_gives_up():
    slept = []
    res = chipwatch.wait_for_chip(budget_s=3600.0, probe_timeout=30.0,
                                  probe_cmd=PROBE_FAIL, initial_backoff=0.25,
                                  backoff_factor=2.0, backoff_cap=0.6, max_probes=4,
                                  sleep=slept.append)
    assert res is None
    assert slept == [0.25, 0.5, 0.6]  # no sleep after the last probe


def test_wait_for_chip_returns_first_success():
    slept = []
    res = chipwatch.wait_for_chip(budget_s=3600.0, probe_timeout=30.0, probe_cmd=PROBE_OK,
                                  max_probes=5, sleep=slept.append)
    assert res is not None and res.ok
    assert slept == []


def test_wait_for_chip_respects_budget():
    # a budget smaller than the first backoff: exactly one probe
    slept = []
    res = chipwatch.wait_for_chip(budget_s=0.1, probe_timeout=30.0, probe_cmd=PROBE_FAIL,
                                  initial_backoff=5.0, sleep=slept.append)
    assert res is None and slept == []


def test_read_measured_count_counts_what_the_cost_model_reads(tmp_path):
    p = tmp_path / "cache.json"
    p.write_text(json.dumps({
        "a": {"t": 1e-3, "measured": True, "platform": "cuda"},
        "b": {"t": 1e-3, "measured": True, "platform": "cpu"},
        "c": {"t": 1e-3, "measured": False, "platform": "cuda"},
        "d": {"t": 1e-3, "measured": True},               # no platform: no card's
        "e": {"t": 2e-3, "measured": True, "platform": "cuda", "device": "H100"},
        "f": {"t": 1e-3, "measured": True, "platform": "tpu"},
        "g": "legacy-bare-float"}))
    assert chipwatch.read_measured_count(str(p), "cuda") \
        == len(cost_model.read_measured(str(p), "cuda")) == 2
    assert chipwatch.read_measured_count(str(p), "cpu") == 1
    assert chipwatch.read_measured_count(str(p)) == 2  # the default platform is cuda
    # the JAX package counts an entry without a platform as a TPU's; the port
    # counts it as nobody's
    assert jax_chipwatch.read_measured_count(str(p), "tpu") == 2
    assert chipwatch.read_measured_count(str(p), "tpu") == 1
    assert chipwatch.read_measured_count(str(tmp_path / "missing.json")) == 0
    p.write_text('{"torn mid-wri')
    assert chipwatch.read_measured_count(str(p)) is None


def test_convert_window_completes_and_counts(tmp_path):
    cache = str(tmp_path / "measured.json")
    win = chipwatch.convert_window(cache_path=cache, measure_cmd=_measure_cmd(cache, 5, 0.01),
                                   max_seconds=30.0, poll_every=0.05, refit=False)
    assert win.converted
    assert win.entries_before == 0 and win.entries_after == 5
    assert win.measure_rc == 0
    assert win.refit_rc is None  # refit=False
    json.load(open(cache))


def test_interrupted_window_grows_cache_monotonically(tmp_path):
    """A window whose measurement subprocess is KILLED mid-run (its budget
    spent) still leaves a readable cache, and a second interrupted window
    resumes and grows it monotonically."""
    cache = str(tmp_path / "measured.json")
    # the fake backend wants 500 entries at 50 ms each; the budget kills it
    # after about 0.5 s
    win1 = chipwatch.convert_window(cache_path=cache, measure_cmd=_measure_cmd(cache, 500, 0.05),
                                    max_seconds=0.5, grace=0.0, poll_every=0.05, refit=False)
    assert win1.converted, win1
    assert win1.measure_rc != 0  # it really was killed
    n1 = chipwatch.read_measured_count(cache)
    assert n1 == win1.entries_after
    assert 0 < n1 < 500
    json.load(open(cache))  # no partial JSON despite the kill
    win2 = chipwatch.convert_window(cache_path=cache, measure_cmd=_measure_cmd(cache, 500, 0.05),
                                    max_seconds=0.5, grace=0.0, poll_every=0.05, refit=False)
    assert win2.entries_before == n1
    assert win2.entries_after > win2.entries_before
    assert chipwatch.read_measured_count(cache) >= n1


def test_convert_window_stall_kill(tmp_path):
    cache = str(tmp_path / "measured.json")
    # one entry, then the backend hangs without producing more
    hang = [sys.executable, "-c", FAKE_MEASURE.replace(
        "time.sleep(delay)", "time.sleep(delay if i > start else 600)"), cache, "5", "0.01"]
    win = chipwatch.convert_window(cache_path=cache, measure_cmd=hang, max_seconds=60.0,
                                   poll_every=0.05, stall_timeout=0.5, refit=False)
    assert win.converted and win.entries_after == 1
    assert "no cache growth" in win.detail


def test_window_emits_telemetry_events(tmp_path, monkeypatch):
    trace = tmp_path / "trace.jsonl"
    monkeypatch.setenv("FF_TELEMETRY", "1")
    monkeypatch.setenv("FF_TELEMETRY_FILE", str(trace))
    events.reset_active()
    cache = str(tmp_path / "measured.json")
    chipwatch.probe_once(timeout=30.0, probe_cmd=PROBE_FAIL)
    chipwatch.convert_window(cache_path=cache, measure_cmd=_measure_cmd(cache, 3, 0.01),
                             max_seconds=30.0, poll_every=0.05, refit=False)
    events.reset_active()
    names = [json.loads(ln)["name"] for ln in trace.read_text().splitlines() if '"name"' in ln]
    assert "chip_probe" in names
    assert "measurement_progress" in names
    assert "chip_window" in names
    # the port's trace_report folds them into its Measurement section
    from flexflow_tpu_torch.tools import trace_report

    rep = trace_report.render_report(trace_report.parse_trace(str(trace)))
    assert "## Measurement" in rep
    assert "window converted" in rep


def test_cost_model_persist_survives_sigkill(tmp_path):
    """CostModel._persist writes a temporary file and renames it: SIGKILL a
    process that persists in a tight loop, and the cache still parses."""
    cache = str(tmp_path / "simcache.json")
    code = (
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "from flexflow_tpu_torch.simulator.cost_model import CostModel\n"
        "from flexflow_tpu_torch.simulator.machine import H100MachineModel\n"
        "cm = CostModel(H100MachineModel(num_devices=1), cache_path=%r)\n"
        "print('READY', flush=True)\n"
        "i = 0\n"
        "while True:\n"
        "    cm._persist(f'Dense:({8},):():h{i}:bfloat16:forward', 1e-4,\n"
        "                {'platform': 'cuda', 'device': 'fake'})\n"
        "    i += 1\n" % (ROOT, cache))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().startswith("READY")
        deadline = time.monotonic() + 20.0
        while not os.path.exists(cache) and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.3)  # let many read-modify-write cycles run
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    data = json.load(open(cache))  # would raise on a torn write
    assert len(data) >= 1
    assert all(v.get("measured") and v.get("platform") == "cuda" for v in data.values())


def test_default_probe_fails_without_a_card():
    """The real probe on a host without a CUDA device: not ok, and the
    detail names the missing device (never an "ok on cpu")."""
    res = chipwatch.probe_once(timeout=120.0)
    assert res.ok is False
    assert "no CUDA device" in res.detail and "is_available() is False" in res.detail


def test_chipwatch_probe_only_cli(capsys):
    rc = chipwatch.main(["--probe-only", "--probe-timeout", "120"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and rec["ok"] is False and "no CUDA device" in rec["detail"]


def test_default_commands_carry_the_windows_own_paths(tmp_path):
    """The default measure and refit commands run the port's calibrate with
    the window's --out and an explicit --fit-out (never the committed
    machine_h100.json), and only flags the port's calibrate has."""
    from flexflow_tpu_torch.tools import calibrate

    cache = str(tmp_path / "m.json")
    fit = str(tmp_path / "fit.json")
    m = chipwatch.default_measure_cmd(cache, 60, fit)
    r = chipwatch.default_refit_cmd(cache, fit)
    assert m[1:3] == ["-m", "flexflow_tpu_torch.tools.calibrate"] == r[1:3]
    assert m[m.index("--out") + 1] == cache and m[m.index("--max-seconds") + 1] == "60"
    # a measuring run fits at its end too: into the window's fit file
    assert m[m.index("--fit-out") + 1] == fit
    assert "--fit-only" in r and r[r.index("--out") + 1] == cache
    assert r[r.index("--fit-out") + 1] == fit
    assert chipwatch.default_fit_path(cache) == str(tmp_path / "m.fit.json")
    d = chipwatch.default_measure_cmd(cache, 60)
    assert d[d.index("--fit-out") + 1] == chipwatch.default_fit_path(cache)
    assert chipwatch.MEASURED_CACHE == cost_model.MEASURED_CACHE
    # every flag parses with the port's calibrate (no --job-timeout)
    parser_flags = {"--max-seconds", "--out", "--fit-only", "--fit-out"}
    src = open(calibrate.__file__).read()
    assert all(f'"{f}"' in src for f in parser_flags)
    assert "--job-timeout" not in m + r


def test_refit_runs_after_a_converted_window(tmp_path):
    """A grown cache gets the refit: the refit command sees the window's
    own cache and fit paths, and both children write to the window's log."""
    cache = str(tmp_path / "measured.json")
    fit = str(tmp_path / "fit.json")
    log = tmp_path / "window.log"
    refit = [sys.executable, "-c",
             "import json, sys; n = len(json.load(open(sys.argv[1]))); "
             "json.dump({'fit_points': n}, open(sys.argv[2], 'w')); print('refitted')",
             cache, fit]
    talk = "import sys; print('measuring', flush=True); sys.stderr.write('err\\n')\n"
    measure = [sys.executable, "-c", talk + FAKE_MEASURE, cache, "4", "0.01"]
    win = chipwatch.convert_window(cache_path=cache, measure_cmd=measure, max_seconds=30.0,
                                   poll_every=0.05, refit_cmd=refit, fit_path=fit,
                                   log_path=str(log))
    assert win.converted and win.refit_rc == 0
    assert json.load(open(fit)) == {"fit_points": 4}
    assert log.read_text().split() == ["measuring", "err", "refitted"]
