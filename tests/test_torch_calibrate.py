"""Calibrate's per-job supervisor (``flexflow_tpu_torch/tools/calibrate.py``,
the JAX package's ``supervise_worker``/``run_measurements``) on the CPU.

A stand-in worker (the supervisor's ``worker_cmd``) measures keys into a
JSON cache the way calibrate's worker does: a heartbeat before each job,
each result persisted as it lands, the skip file's keys left out.  One of
its jobs hangs: the supervisor must kill it once its beat is older than
the job timeout, skip that key and start the worker again, which resumes
from the cache (no key measured twice).  A worker that never beats is
killed at the startup deadline.  ``run_measurements`` itself beats before
every job, skips the skip file's keys and ends with the null sentinel.
"""

import json
import os
import sys
import time

import numpy as np
import pytest

from flexflow_tpu_torch.tools import calibrate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# argv: [--worker --heartbeat HB --skip-keys-file SKIP] + the supervisor's
# forwarded arguments (--out CACHE --log LOG --hang KEY)
FAKE_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
from flexflow_tpu_torch.tools.calibrate import beat
args = sys.argv[2:]
arg = lambda name: args[args.index(name) + 1]
hb, cache, log, hang = arg("--heartbeat"), arg("--out"), arg("--log"), arg("--hang")
skip = set(open(arg("--skip-keys-file")).read().split())
done = json.load(open(cache)) if os.path.exists(cache) else {}
with open(log, "a") as f:
    f.write("start\n")
for i, key in enumerate(["a", "b", "c"]):
    if key in skip or key in done:
        continue
    beat(hb, key, i)
    if key == hang:
        time.sleep(600)
    done[key] = i
    json.dump(done, open(cache, "w"))
    with open(log, "a") as f:
        f.write(key + "\n")
beat(hb, None, 3)
"""


def _worker():
    return [sys.executable, "-c", FAKE_WORKER, ROOT]


def test_a_hung_job_is_killed_skipped_and_the_restart_keeps_the_cache(tmp_path):
    cache, log = str(tmp_path / "m.json"), str(tmp_path / "log")
    t0 = time.time()
    rc = calibrate.supervise_worker(["--out", cache, "--log", log, "--hang", "b"],
                                    job_timeout=1.0, max_restarts=2, max_seconds=60.0,
                                    startup_timeout=30.0, poll=0.1, worker_cmd=_worker())
    assert rc == 0 and time.time() - t0 < 30
    # the first attempt measured a and hung on b; the second skipped b and
    # measured only c: a came from the durable cache
    assert open(log).read().split() == ["start", "a", "start", "c"]
    assert json.load(open(cache)) == {"a": 0, "c": 2}


def test_a_worker_that_never_beats_is_killed_at_the_startup_deadline(tmp_path, capsys):
    cmd = [sys.executable, "-c", "import time; time.sleep(600)"]
    t0 = time.time()
    rc = calibrate.supervise_worker([], job_timeout=0.2, max_restarts=1, max_seconds=60.0,
                                    startup_timeout=0.5, poll=0.1, worker_cmd=cmd)
    assert rc == 1 and time.time() - t0 < 20
    out = capsys.readouterr().out
    assert out.count("wrote no heartbeat") == 2 and "restart budget spent" in out


def test_run_measurements_beats_before_each_job_and_skips_hung_keys(tmp_path):
    hb = str(tmp_path / "hb.json")
    seen = []

    class Cost:
        def op_time(self, op, pc, which):
            with open(hb) as f:
                seen.append(json.load(f)["key"])  # the beat written before the job
            return 1e-6

    jobs = [(None, None, "forward", k) for k in ("k1", "k2", "k3")]
    done = calibrate.run_measurements(jobs, Cost(), verbose=False, heartbeat_path=hb,
                                      skip_keys={"k2"})
    assert done == 2 and seen == ["k1", "k3"]
    with open(hb) as f:
        assert json.load(f)["key"] is None  # the end: no stale beat kills the teardown


def test_main_supervises_by_default_and_forwards_its_arguments(monkeypatch, tmp_path):
    """Without --fit-only, --worker or --no-supervise, main measures in a
    supervised worker with the caller's arguments, then fits here from the
    cache, on the CPU, for the worker's platform."""
    calls = {}

    def supervise(argv, job_timeout, max_restarts, max_seconds):
        calls["supervise"] = (argv, job_timeout, max_restarts, max_seconds)
        return 0

    def fit(*args, **kw):
        calls["calibrate"] = (args, kw)
        return {"fit": {}, "written": False, "measured": 0, "out": args[5],
                "fit_out": args[6]}

    monkeypatch.setattr(calibrate, "supervise_worker", supervise)
    monkeypatch.setattr(calibrate, "calibrate", fit)
    out = str(tmp_path / "m.json")
    calibrate.main(["--models", "alexnet:8", "--devices", "2", "--out", out,
                    "--fit-out", str(tmp_path / "f.json"), "--max-seconds", "30",
                    "--job-timeout", "5", "--max-restarts", "1", "--quiet"])
    argv, job_timeout, restarts, max_seconds = calls["supervise"]
    assert (job_timeout, restarts, max_seconds) == (5.0, 1, 930.0)
    assert argv[argv.index("--out") + 1] == out and "--quiet" in argv
    assert argv[argv.index("--models") + 1] == "alexnet:8"
    args, kw = calls["calibrate"]
    assert args[7] is True and args[9] == "cpu" and kw["platform"] == "cuda"
    assert kw["do_fit"] is True


# ------------------------------------------------ C16: the packaged fit kept

PACKAGED_FIT = os.path.join(ROOT, "flexflow_tpu_torch", "simulator", "machine_h100.json")
PACKAGED_CACHE = os.path.join(ROOT, "flexflow_tpu_torch", "simulator", "measured_h100.json")


def _default_fit(monkeypatch, tmp_path):
    """A copy of the packaged fit as the default fit path (what
    H100MachineModel.calibrated() reads), and no nvidia-smi on the PATH
    (card_label's cache emptied, so that a call would run it)."""
    from flexflow_tpu_torch.simulator import cost_model, machine

    fit = tmp_path / "machine_h100.json"
    fit.write_bytes(open(PACKAGED_FIT, "rb").read())
    monkeypatch.setattr(machine, "CALIBRATION_PATH", str(fit))
    monkeypatch.setenv("FF_REPORT_KEYS_PATH", str(tmp_path / "no_keys.json"))
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    cost_model.card_label.cache_clear()
    monkeypatch.chdir(ROOT)
    return fit


@pytest.mark.parametrize("supervise", [True, False], ids=["supervised", "no-supervise"])
def test_a_cpu_calibration_leaves_the_default_fit_file_unchanged(supervise, monkeypatch,
                                                                 tmp_path, capsys):
    """ROADMAP C16: a calibration measured on the CPU fits (a thin fit over
    AlexNet's first ops) but does not write it over the default fit file,
    whose bytes stay as they were, and finishes without nvidia-smi; with
    --fit-out it writes the fit there, labelled with the CPU."""
    fit = _default_fit(monkeypatch, tmp_path)
    before = fit.read_bytes()
    args = ["--device", "cpu", "--models", "alexnet:8", "--devices", "1", "--dp-parts", "1",
            "--max-seconds", "3", "--out", str(tmp_path / "m.json"), "--quiet"]
    args += [] if supervise else ["--no-supervise"]
    r = calibrate.main(args)
    assert r["fit"]["fit_points"] > 0 and not r["written"]
    assert "NOT writing the machine fit" in capsys.readouterr().out
    assert fit.read_bytes() == before
    named = tmp_path / "cpu_fit.json"
    r = calibrate.main(args + ["--fit-out", str(named)])
    assert r["written"] and fit.read_bytes() == before
    written = json.load(open(named))
    assert written["device"] == "cpu" and written["fit_points"] == r["fit"]["fit_points"]


def _cache_of(path, keep):
    data = json.load(open(PACKAGED_CACHE))
    with open(path, "w") as f:
        json.dump({k: v for k, v in data.items() if keep(k)}, f)


def test_a_partial_fit_keeps_the_families_and_keys_it_did_not_measure(monkeypatch, tmp_path):
    """A refit over AlexNet's entries alone, written with --fit-out over a
    full fit, replaces the keys it fits and keeps every other: the per-family
    constants of MultiHeadAttention, LayerNorm, Embedding and ElementBinary
    (which AlexNet has not) and the earlier fit's other keys.  Then a fit of
    the host-transfer ladder alone keeps the whole roofline."""
    _default_fit(monkeypatch, tmp_path)
    prev = json.load(open(PACKAGED_FIT))
    prev["pcie_bandwidth"], prev["host_xfer_latency"] = 1.0e9, 1.0e-3
    out, target = tmp_path / "m.json", tmp_path / "fit.json"
    target.write_text(json.dumps(prev))
    alexnet_families = ("Conv2D:", "Pool2D:", "Dense:", "Flat:", "Softmax:")
    _cache_of(out, lambda k: k.startswith(alexnet_families))
    r = calibrate.main(["--fit-only", "--models", "alexnet:256", "--devices", "8",
                        "--out", str(out), "--fit-out", str(target), "--quiet"])
    new, merged = r["fit"], json.load(open(target))
    assert r["written"] and new["fit_points"] < prev["fit_points"]
    assert set(new["op_backward_multiplier"]) < set(prev["op_backward_multiplier"])
    for k in ("op_efficiency", "op_backward_multiplier"):
        assert merged[k] == {**prev[k], **new[k]}
        for fam in ("MultiHeadAttention", "LayerNorm", "Embedding", "ElementBinary"):
            if fam in prev[k]:
                assert merged[k][fam] == prev[k][fam]
    for k, v in new.items():
        if k not in ("op_efficiency", "op_backward_multiplier"):
            assert merged[k] == v, k
    assert (merged["pcie_bandwidth"], merged["host_xfer_latency"]) == (1.0e9, 1.0e-3)

    # the ladder alone (card-tagged entries): the roofline stays, the link is refitted
    tag = {"measured": True, "platform": "cuda", "device": "NVIDIA H100 80GB HBM3",
           "power_limit": "700.00 W"}
    with open(out, "w") as f:
        json.dump({f"host_xfer:{n}": dict(tag, t=2e-5 + n / 50e9)
                   for n in calibrate.HOST_XFER_SIZES}, f)
    before = json.load(open(target))
    r = calibrate.main(["--fit-only", "--models", "alexnet:256", "--devices", "8",
                        "--out", str(out), "--fit-out", str(target), "--quiet"])
    after = json.load(open(target))
    assert set(r["fit"]) == {"pcie_bandwidth", "host_xfer_latency", "device", "power_limit"}
    assert after["pcie_bandwidth"] == pytest.approx(50e9, rel=1e-9)
    assert after["host_xfer_latency"] == pytest.approx(2e-5, rel=1e-6)
    assert {k: v for k, v in after.items() if k not in r["fit"]} == \
        {k: v for k, v in before.items() if k not in r["fit"]}


def test_fit_only_on_the_cpu_refits_the_cards_entries(monkeypatch, tmp_path, capsys):
    """--fit-only --device cpu builds the models' shapes on the CPU and
    refits the card's (cuda) entries, labelled with the card they name;
    over a cache with none of them it says there is nothing to fit and
    writes nothing."""
    fit = _default_fit(monkeypatch, tmp_path)
    before = fit.read_bytes()
    out, target = tmp_path / "m.json", tmp_path / "fit.json"
    _cache_of(out, lambda k: k.startswith(("Conv2D:", "Pool2D:", "Dense:", "Flat:",
                                           "Softmax:")))
    cards = {v["device"] for v in json.load(open(out)).values()}
    args = ["--fit-only", "--device", "cpu", "--models", "alexnet:256", "--devices", "8",
            "--out", str(out), "--fit-out", str(target), "--quiet"]
    r = calibrate.main(args)
    assert r["written"] and r["fit"]["fit_points"] > 0
    assert json.load(open(target))["device"] == " / ".join(sorted(cards))
    target.unlink()
    out.write_text(json.dumps({k: dict(v, platform="cpu")
                               for k, v in json.load(open(out)).items()}))
    r = calibrate.main(args)
    assert not r["written"] and r["fit"] == {} and not target.exists()
    assert "nothing to fit" in capsys.readouterr().out
    assert fit.read_bytes() == before


@pytest.mark.parametrize("case", ["ladder", "noisy", "one size", "negative slope"])
def test_fit_host_transfer_equals_the_jax_packages(case):
    """The port's least squares over host_xfer entries is the JAX package's
    (flexflow_tpu/tools/calibrate.py:122-141) on the same entries; other keys
    are ignored."""
    from flexflow_tpu.tools import calibrate as jax_calibrate

    rng = np.random.default_rng(0)
    sizes = {"one size": [1 << 20]}.get(case, list(calibrate.HOST_XFER_SIZES))
    t = {n: 1e-5 + n / 25e9 for n in sizes}
    if case == "noisy":
        t = {n: v * (1 + 0.05 * rng.standard_normal()) for n, v in t.items()}
    elif case == "negative slope":
        t = {n: 1e-2 - n / 1e12 for n in sizes}

    class Cost:
        _measured = {**{f"host_xfer:{n}": v for n, v in t.items()},
                     "Conv2D:(1,):():k(1, 1)s(1, 1):bfloat16:forward": 1.0}

    got, want = calibrate.fit_host_transfer(Cost), jax_calibrate.fit_host_transfer(Cost)
    assert got == want
    assert bool(got) == (case in ("ladder", "noisy"))


def test_the_ladder_measures_nothing_off_a_card(tmp_path):
    """On the CPU there is no host-to-device link: no entry, no beat left."""
    class Cost:
        device = __import__("torch").device("cpu")
        _measured = {}

    hb = str(tmp_path / "hb.json")
    assert calibrate.measure_host_transfer(Cost, verbose=False, heartbeat_path=hb) == 0
    assert Cost._measured == {} and not os.path.exists(hb)
