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
        return {"fit": {}, "measured": 0, "out": args[5], "fit_out": args[6]}

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
