"""The port's tools on the CPU at small sizes: opbench (its suite the JAX
package's), profile_report (a row per op, the port's FLOP counts),
soap_report (report, strategy file, report keys only at the canonical
scale), the calibration's job order from the report keys, the doctor
(its checks the JAX package's, in order), report_configs, and the
committed calibration left byte-identical."""

import argparse
import ast
import hashlib
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM = os.path.join(ROOT, "flexflow_tpu_torch", "simulator")
COMMITTED = [os.path.join(SIM, "measured_h100.json"), os.path.join(SIM, "machine_h100.json")]


def _digests():
    out = {}
    for path in COMMITTED:
        with open(path, "rb") as f:
            out[path] = hashlib.sha256(f.read()).hexdigest()
    return out


# taken when this file's tests start; the last test compares
BEFORE = _digests()


@pytest.fixture
def keys_path(tmp_path, monkeypatch):
    path = str(tmp_path / "report_keys.json")
    monkeypatch.setenv("FF_REPORT_KEYS_PATH", path)
    return path


# -- report_configs ----------------------------------------------------------

def test_report_configs_keep_the_reference_configurations():
    from flexflow_tpu.tools import report_configs as jax_rc
    from flexflow_tpu_torch.tools import calibrate, report_configs as rc

    assert rc.REPORT_GLOBAL_BATCH == jax_rc.REPORT_GLOBAL_BATCH
    assert rc.REPORT_DEVICES == jax_rc.REPORT_DEVICES
    assert rc.SEARCH_BUDGET == jax_rc.SEARCH_BUDGET
    assert rc.REPORT_COMPUTE_DTYPE == "bfloat16"
    # one source: calibrate takes the thin-fit limits from report_configs
    assert calibrate.THIN_FIT_POINTS is rc.THIN_FIT_POINTS
    assert calibrate.THIN_FIT_OP_TYPES is rc.THIN_FIT_OP_TYPES
    assert rc.report_keys_path() == os.environ["FF_REPORT_KEYS_PATH"]


def test_calibration_target_is_the_default_job_space():
    """CALIBRATION_TARGET_ENTRIES counts calibrate's default job space
    (alexnet:256 and transformer:16 on 8 GPUs, data-parallel over 1, 2, 4
    and 8 parts, both directions), with no measurement in hand."""
    from flexflow_tpu_torch.simulator.cost_model import CostModel
    from flexflow_tpu_torch.simulator.machine import H100MachineModel
    from flexflow_tpu_torch.tools.calibrate import candidate_jobs
    from flexflow_tpu_torch.tools.offline_search import build_model
    from flexflow_tpu_torch.tools.report_configs import CALIBRATION_TARGET_ENTRIES

    cost = CostModel(H100MachineModel(num_devices=8), cache_path="",
                     measured_cache_path=os.devnull, compute_dtype="bfloat16")
    n = sum(len(candidate_jobs(build_model(name, batch, 8, "cpu", "bfloat16"), 8, cost,
                               False, [1, 2, 4, 8]))
            for name, batch in (("alexnet", 256), ("transformer", 16)))
    assert CALIBRATION_TARGET_ENTRIES == n


# -- opbench -----------------------------------------------------------------

def test_opbench_suite_equals_the_jax_package():
    from flexflow_tpu.tools import opbench as jax_opbench
    from flexflow_tpu_torch.tools import opbench

    assert opbench._SUITE == jax_opbench._SUITE
    assert len(opbench._SUITE) == 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_opbench_single_op_on_the_cpu(dtype):
    from flexflow_tpu_torch.tools import opbench

    args = argparse.Namespace(out_dim=32, device="cpu", compute_dtype=dtype)
    r = opbench.bench_op("linear", 8, (64,), args, iters=2)
    (f, f_gf), (b, b_gf) = r["fwd"], r["fwd+bwd"]
    assert 0 < f < b  # forward + backward
    # forward GFLOP/s over 2 * 8 * 64 * 32 flops, three times that with the backward
    assert f_gf == pytest.approx(2 * 8 * 64 * 32 / f / 1e9, rel=1e-12)
    assert b_gf == pytest.approx(3 * 2 * 8 * 64 * 32 / b / 1e9, rel=1e-12)


def test_opbench_cli(capsys):
    from flexflow_tpu_torch.tools.opbench import main

    rows = main(["linear", "--batch", "8", "--in-shape", "64", "--out-dim", "32",
                 "--iters", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "linear" in out and "fwd" in out
    assert len(rows) == 1 and rows[0]["fwd_bwd_ms"] > rows[0]["fwd_ms"] > 0


# -- profile_report ----------------------------------------------------------

def test_profile_report_alexnet_on_the_cpu(tmp_path):
    from flexflow_tpu_torch.tools import profile_report
    from flexflow_tpu_torch.tools.offline_search import build_model

    out = str(tmp_path / "PROFILE.md")
    res = profile_report.main(["alexnet", "--batch-size", "2", "--device", "cpu",
                               "--out", out])
    text = open(out).read()
    assert text.startswith("# Per-op profile — alexnet, batch 2, bfloat16, cpu")
    rows = {}
    for line in text.splitlines():
        m = re.match(r"\| (\S+) \| ([\d.]+) \| ([\d.]+) \| ([\d.]+) \|", line)
        if m:
            rows[m.group(1)] = tuple(float(x) for x in m.groups()[1:])
    model = build_model("alexnet", 2, 1, "cpu", "bfloat16")
    assert list(rows) == [op.name for op in model.ops]
    for op in model.ops:
        fwd, bwd, gflop = rows[op.name]
        # the GFLOP column: the port's flops_per_sample() times the batch (2 decimals)
        assert gflop == pytest.approx(op.flops_per_sample() * 2 / 1e9, abs=5e-3)
        assert fwd > 0
    for r in res["rows"]:
        if r["trains"]:
            assert r["backward_ms"] > 0, r
    assert res["total_ms"] == pytest.approx(
        sum(r["forward_ms"] + r["backward_ms"] for r in res["rows"]), rel=1e-12)


# -- soap_report and the report keys -----------------------------------------

def test_soap_report_writes_report_strategy_and_keys(tmp_path, keys_path):
    from flexflow_tpu_torch.parallel.strategy import load_strategies_from_file
    from flexflow_tpu_torch.tools import soap_report

    out, pb = str(tmp_path / "REPORT.md"), str(tmp_path / "s.pb")
    res = soap_report.main(["alexnet", "--devices", "16", "--batch-size", "64", "--budget",
                            "200", "--restarts", "1", "--export", pb, "--out", out,
                            "--measured-single-chip-ms", "8.0"])
    assert res["speedup"] >= 1.0 and res["canonical"]
    text = open(out).read()
    assert "SOAP searched" in text and "agreement" in text.lower()
    assert "16 GPUs (2 node(s)" in text and "InfiniBand" in text
    strategies = load_strategies_from_file(pb)
    assert len(strategies) == 13 and all(pc.num_parts() >= 1 for pc in strategies.values())
    keys = json.load(open(keys_path))
    assert list(keys) == ["alexnet"]
    assert keys["alexnet"]["devices"] == 16 and keys["alexnet"]["batch"] == 64
    assert keys["alexnet"]["keys"] and all(k.endswith(("forward", "backward"))
                                           for k in keys["alexnet"]["keys"])


def test_soap_report_off_canonical_leaves_the_keys_alone(tmp_path, keys_path):
    from flexflow_tpu_torch.tools import soap_report

    with open(keys_path, "w") as f:
        json.dump({"nmt": {"devices": 16, "batch": 1024, "keys": ["x"]}}, f)
    before = open(keys_path).read()
    for extra in (["--devices", "8", "--batch-size", "64"],
                  ["--devices", "16", "--batch-size", "64", "--compute-dtype", "float32"]):
        res = soap_report.main(["alexnet", *extra, "--budget", "50", "--restarts", "1",
                                "--out", str(tmp_path / "r.md")])
        assert not res["canonical"]
        assert open(keys_path).read() == before


def test_committed_report_keys_are_the_canonical_reports():
    """The committed keys file holds the five report models at their
    canonical scale, and each holds its data-parallel plan's keys."""
    from flexflow_tpu_torch.config import ParallelConfig
    from flexflow_tpu_torch.simulator.cost_model import CostModel
    from flexflow_tpu_torch.simulator.machine import H100MachineModel
    from flexflow_tpu_torch.tools.offline_search import build_model
    from flexflow_tpu_torch.tools.report_configs import REPORT_DEVICES, REPORT_GLOBAL_BATCH

    with open(os.path.join(SIM, "report_keys.json")) as f:
        committed = json.load(f)
    assert sorted(committed) == sorted(REPORT_DEVICES)
    for name, entry in committed.items():
        assert (entry["devices"], entry["batch"]) == (REPORT_DEVICES[name],
                                                     REPORT_GLOBAL_BATCH[name])
    nd = REPORT_DEVICES["alexnet"]
    model = build_model("alexnet", REPORT_GLOBAL_BATCH["alexnet"], nd, "cpu", "bfloat16")
    cost = CostModel(H100MachineModel(num_devices=nd), compute_dtype="bfloat16")
    dp_keys = {cost._key(op, ParallelConfig.data_parallel(op.output.num_dims, nd), w)
               for op in model.ops for w in ("forward", "backward")}
    assert dp_keys <= set(committed["alexnet"]["keys"])


def _jobs(tmp_path):
    """calibrate's job list for alexnet:256 on 8 GPUs with nothing measured;
    (jobs, extra fit models), cost model."""
    from flexflow_tpu_torch.simulator.cost_model import CostModel
    from flexflow_tpu_torch.simulator.machine import H100MachineModel
    from flexflow_tpu_torch.tools import calibrate
    from flexflow_tpu_torch.tools.offline_search import build_model

    build = lambda name, batch, nd: build_model(name, batch, nd, "cpu", "bfloat16")  # noqa
    cost = CostModel(H100MachineModel(num_devices=8), cache_path="",
                     measured_cache_path=str(tmp_path / "none.json"), compute_dtype="bfloat16")
    mb = [("alexnet", 256)]
    return calibrate.build_job_list(mb, [build(*mb[0], 8)], 8, cost, False, [1, 2, 4, 8],
                                    build), cost


def test_calibrate_puts_the_report_keys_first(tmp_path, keys_path, capsys):
    """The keys of a report-keys file come first in calibrate's job order
    (cheapest by the roofline first); a report model whose scale the
    enumeration does not cover gets targeted jobs for exactly its keys and
    joins the fit's records; without the file the order is the
    enumeration's and the fallback line is printed."""
    from flexflow_tpu_torch.config import ParallelConfig
    from flexflow_tpu_torch.tools import calibrate
    from flexflow_tpu_torch.tools.offline_search import build_model

    (plain, extra), cost = _jobs(tmp_path)
    assert extra == [] and "no report-key priority hints" in capsys.readouterr().out
    # the keys of alexnet@256 at 2 parts, and nmt's at its report scale
    picked = [j[3] for j in plain if j[1].dims[0] == 2][:6]
    nmt = build_model("nmt", 1024, 16, "cpu", "bfloat16")
    nmt_keys = sorted({cost._key(op, ParallelConfig.data_parallel(op.output.num_dims, 16)
                                 .with_device_ids(tuple(range(16))), w)
                       for op in nmt.ops[:3] for w in ("forward", "backward")})
    with open(keys_path, "w") as f:
        json.dump({"alexnet": {"devices": 8, "batch": 256, "keys": picked},
                   "nmt": {"devices": 16, "batch": 1024, "keys": nmt_keys}}, f)
    (jobs, extra), cost = _jobs(tmp_path)
    n = len(picked) + len(nmt_keys)
    assert sorted(j[3] for j in jobs[:n]) == sorted(picked + nmt_keys)
    first = [cost._analytic(j[0], j[1], j[2]) for j in jobs[:n]]
    assert first == sorted(first)
    # the rest keeps the enumeration's order, nothing lost or doubled
    assert [j[3] for j in jobs[n:]] == [j[3] for j in plain if j[3] not in picked]
    assert len({j[3] for j in jobs}) == len(jobs)
    assert [nd for _, nd in extra] == [16]
    assert calibrate.read_report_keys()["nmt"]["keys"] == nmt_keys


# -- doctor ------------------------------------------------------------------

def _jax_doctor_plan():
    """The check names of the JAX package's doctor, read from its source."""
    with open(os.path.join(ROOT, "flexflow_tpu", "tools", "doctor.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    names = []
    for node in ast.walk(main):
        if isinstance(node, ast.Tuple) and node.elts and isinstance(node.elts[0], ast.Constant) \
                and isinstance(node.elts[0].value, str) and len(node.elts) == 3:
            names.append((node.lineno, node.col_offset, node.elts[0].value))
    return [n for _, _, n in sorted(names)]


def test_doctor_passes_on_the_cpu_with_the_jax_checks(capsys):
    from flexflow_tpu_torch.tools.doctor import main

    assert main(["--skip-accelerator"]) == 0
    out = capsys.readouterr().out.splitlines()
    lines = [ln for ln in out if ln.startswith("[")]
    names = [re.match(r"\[\w+\s*\] (.+?)  ", ln).group(1).strip() for ln in lines]
    jax_names = _jax_doctor_plan()
    assert "accelerator" in jax_names and len(jax_names) == 16
    assert names == [n for n in jax_names if n != "accelerator"]
    by_name = dict(zip(names, lines))
    assert by_name["lowering"].startswith("[ok") and \
        "probe-lower: 1-step train bitwise == per-op dispatch" in by_name["lowering"]
    assert by_name["cpu training"].startswith("[ok")
    assert "ffsim built" in by_name["native libs"] and "ffsearch built" in by_name["native libs"]
    assert "chip probe: skipped" in by_name["perf"]
    assert out[-1] == "doctor: all required checks passed"


def test_doctor_accelerator_warns_without_a_card():
    from flexflow_tpu_torch.tools import doctor

    name, status, detail = doctor._check("accelerator", doctor._accelerator, False)
    assert status == "warn" and "no CUDA device found" in detail


@pytest.mark.parametrize("module", [
    "tools.doctor", "tools.opbench", "tools.profile_report", "tools.memory_report",
    "tools.timeline_export", "tools.soap_report", "observability.chipwatch"])
def test_every_tool_has_a_cli(module, capsys):
    import importlib

    mod = importlib.import_module(f"flexflow_tpu_torch.{module}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0 and "usage" in capsys.readouterr().out


def test_the_committed_calibration_is_unchanged():
    """Nothing above wrote measured_h100.json or machine_h100.json."""
    assert _digests() == BEFORE
