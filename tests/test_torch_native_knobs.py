"""The search's environment knobs and the search tools in the port, against
the JAX package, on the CPU.

* ``FF_SEARCH_POPULATION``, ``FF_SEARCH_LADDER``, ``FF_SEARCH_EXCHANGE``,
  ``FF_SEARCH_CROSSOVER`` and ``FF_SEARCH_LEARNED``: every value the JAX
  package's parsers accept gives the same knobs in the port, every value
  they reject raises ``ValueError`` with the same message;
* a population search under set knobs equals the JAX engine's bit for bit
  (the harness of tests/test_torch_search.py);
* ``FF_SIM_DELTA=0`` (full rebuilds) gives the same seeded result as the
  delta simulator, for mcmc and the population; ``FF_SIM_DELTA_CHECK``
  sets the cross-check's cadence (0: none; a non-integer raises as in the
  JAX package), and a divergence raises;
* ``tools/perf_ledger.py`` and ``tools/search_bench.py`` on a temporary
  ledger only: the ledger's regressions equal the JAX module's on the same
  entries, and its default path is the port's own.
"""

import json
import os

import pytest

from flexflow_tpu.simulator import population as jax_population
from flexflow_tpu.simulator import search as jax_search
from flexflow_tpu.tools import perf_ledger as jax_ledger
from flexflow_tpu_torch.simulator import population, search
from flexflow_tpu_torch.simulator.population import PopulationKnobs, population_search
from flexflow_tpu_torch.simulator.search import mcmc_search
from flexflow_tpu_torch.simulator.simulator import Simulator
from flexflow_tpu_torch.tools import perf_ledger, search_bench

from test_torch_search import _dims, _search_pair
from test_torch_simulator import build_pair, cost_pair

GOOD = [
    {},
    {"FF_SEARCH_POPULATION": "3", "FF_SEARCH_LADDER": "1,0.5,0.25",
     "FF_SEARCH_EXCHANGE": "0", "FF_SEARCH_LEARNED": "0"},
    {"FF_SEARCH_LADDER": "0.5"},
    {"FF_SEARCH_LADDER": "1"},
    {"FF_SEARCH_POPULATION": "2", "FF_SEARCH_CROSSOVER": "0"},
    {"FF_SEARCH_POPULATION": "12", "FF_SEARCH_EXCHANGE": "7", "FF_SEARCH_CROSSOVER": "13"},
    {"FF_SEARCH_LEARNED": "on"},
    {"FF_SEARCH_LEARNED": "False"},
    {"FF_SEARCH_LEARNED": ""},
]
BAD = [
    {"FF_SEARCH_POPULATION": "1"},
    {"FF_SEARCH_POPULATION": "zebra"},
    {"FF_SEARCH_POPULATION": "2.5"},
    {"FF_SEARCH_LADDER": "1.5"},
    {"FF_SEARCH_LADDER": "1,0.5"},
    {"FF_SEARCH_LADDER": "0.5,-1", "FF_SEARCH_POPULATION": "2"},
    {"FF_SEARCH_LADDER": "0"},
    {"FF_SEARCH_LADDER": "half"},
    {"FF_SEARCH_EXCHANGE": "-1"},
    {"FF_SEARCH_CROSSOVER": "x"},
    {"FF_SEARCH_LEARNED": "maybe"},
    {"FF_SEARCH_LEARNED": "2"},
]


@pytest.mark.parametrize("env", GOOD, ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items())
                         or "unset")
def test_knobs_accept_what_the_jax_package_accepts(env):
    want = jax_population.PopulationKnobs.from_env(env=env)
    got = PopulationKnobs.from_env(env=env)
    assert got.__dict__ == want.__dict__
    assert got.alphas(0.05) == want.alphas(0.05)


@pytest.mark.parametrize("env", BAD, ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()))
def test_knobs_reject_what_the_jax_package_rejects(env):
    with pytest.raises(ValueError) as want:
        jax_population.PopulationKnobs.from_env(env=env)
    with pytest.raises(ValueError) as got:
        PopulationKnobs.from_env(env=env)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("raw", ["", "0", "1", "on", "OFF", "true", "False", "2", "yes"])
def test_the_learned_flag_reads_as_the_jax_package_reads_it(raw):
    try:
        want = jax_population.parse_learned_flag(raw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            population.parse_learned_flag(raw)
        return
    assert population.parse_learned_flag(raw) is want


KNOB_ENVS = [
    {"FF_SEARCH_POPULATION": "4", "FF_SEARCH_LADDER": "0.5", "FF_SEARCH_EXCHANGE": "10",
     "FF_SEARCH_CROSSOVER": "20", "FF_SEARCH_LEARNED": "0"},
    {"FF_SEARCH_POPULATION": "3", "FF_SEARCH_LADDER": "1,0.7,0.2", "FF_SEARCH_EXCHANGE": "0",
     "FF_SEARCH_CROSSOVER": "5"},
]


@pytest.mark.parametrize("env", KNOB_ENVS, ids=["geometric", "explicit-ladder"])
def test_a_population_under_set_knobs_equals_the_jax_engine(env, tmp_path, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want, got = _search_pair("population", "alexnet", 16, 200, 3, tmp_path)
    assert (got.best_s, got.dp_s) == (want.best_s, want.dp_s)
    assert _dims(got) == _dims(want)
    assert got.chains == want.chains
    assert len(got.chains) == int(env["FF_SEARCH_POPULATION"])
    for k in ("population", "ladder", "exchange_every", "crossover_every", "spent",
              "winner_chain", "exchange", "crossover", "lineage"):
        assert got.stats[k] == want.stats[k], k
    learned = want.stats["learned"]
    assert (got.stats["learned"] is None) == (learned is None)


def test_a_malformed_knob_stops_the_population_search(monkeypatch, tmp_path):
    monkeypatch.setenv("FF_SEARCH_POPULATION", "one")
    _, pm = build_pair("alexnet", 64, 4)
    _, _, pmm, pc = cost_pair(4, tmp_path)
    with pytest.raises(ValueError, match="FF_SEARCH_POPULATION must be an integer"):
        population_search(pm, 10, machine_model=pmm, cost_model=pc, verbose=False)
    monkeypatch.delenv("FF_SEARCH_POPULATION")
    monkeypatch.setenv("FF_SEARCH_LEARNED", "sometimes")
    with pytest.raises(ValueError, match="FF_SEARCH_LEARNED must be 0 or 1"):
        mcmc_search(pm, 10, machine_model=pmm, cost_model=pc, verbose=False)


@pytest.mark.parametrize("engine", ["mcmc", "population"])
def test_delta_off_equals_delta_on(engine, tmp_path, monkeypatch):
    """``FF_SIM_DELTA=0``: every proposal by a full rebuild, the same seeded
    result bit for bit (and the JAX package's)."""
    runs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("FF_SIM_DELTA", flag)
        runs[flag] = _search_pair(engine, "alexnet", 8, 120, 2, tmp_path / flag)
    (want_on, on), (want_off, off) = runs["1"], runs["0"]
    assert dict(on) == dict(off) and (on.best_s, on.dp_s) == (off.best_s, off.dp_s)
    assert (on.best_s, off.best_s) == (want_on.best_s, want_off.best_s)
    assert on.delta_sim is True and off.delta_sim is False
    if engine == "population":
        assert on.chains == off.chains and off.stats["delta_sim"] is False


def _count_rebuilds(monkeypatch):
    calls = []
    real = Simulator.simulate_runtime

    def counted(self, model, strategies):
        calls.append(1)
        return real(self, model, strategies)
    monkeypatch.setattr(Simulator, "simulate_runtime", counted)
    return calls


@pytest.mark.parametrize("every", ["3", "7", "0", ""])
def test_the_delta_check_cadence(every, tmp_path, monkeypatch):
    """One full rebuild every ``FF_SIM_DELTA_CHECK`` accepts: a run at 1
    counts the accepts, a run at n checks accepts // n times, 0 or empty
    never."""
    _, pm = build_pair("alexnet", 64, 8)
    _, _, pmm, pc = cost_pair(8, tmp_path)
    calls = _count_rebuilds(monkeypatch)
    monkeypatch.setenv("FF_SIM_DELTA_CHECK", "1")
    first = mcmc_search(pm, 150, seed=2, machine_model=pmm, cost_model=pc, verbose=False)
    accepts = len(calls)
    assert accepts > 3
    calls.clear()
    monkeypatch.setenv("FF_SIM_DELTA_CHECK", every)
    n = int(every) if every else 0
    assert search.delta_check_every() == n
    r = mcmc_search(pm, 150, seed=2, machine_model=pmm, cost_model=pc, verbose=False)
    assert len(calls) == (accepts // n if n else 0)
    assert dict(r) == dict(first) and r.best_s == first.best_s and r.delta_sim is True


def test_the_delta_check_reads_as_the_jax_package_and_raises_on_a_divergence(
        tmp_path, monkeypatch):
    monkeypatch.setenv("FF_SIM_DELTA_CHECK", "often")
    with pytest.raises(ValueError):
        int(os.environ.get("FF_SIM_DELTA_CHECK", "200") or 0)  # the JAX package's reading
    with pytest.raises(ValueError):
        search.delta_check_every()
    monkeypatch.setenv("FF_SIM_DELTA_CHECK", "1")
    _, pm = build_pair("alexnet", 64, 8)
    _, _, pmm, pc = cost_pair(8, tmp_path)
    real = Simulator.simulate_runtime
    monkeypatch.setattr(Simulator, "simulate_runtime",
                        lambda self, model, s: real(self, model, s) * (1 + 1e-12))
    with pytest.raises(RuntimeError, match="delta simulation diverged"):
        mcmc_search(pm, 150, seed=2, machine_model=pmm, cost_model=pc, verbose=False)
    assert jax_search._delta_enabled() is search.delta_enabled()


def _entry(value, metric="search_throughput", backend="cpu", status="ok"):
    return dict(kind="bench", metric=metric, value=value, unit="proposals/s",
                backend=backend, proxy=False, status=status, batch=64,
                provenance={"model": "alexnet"})


def test_the_ledger_on_a_temporary_file(tmp_path, monkeypatch):
    path = str(tmp_path / "ledger.jsonl")
    assert os.path.basename(perf_ledger.default_path()) == "perf_ledger_torch.jsonl"
    monkeypatch.setenv("FF_TORCH_PERF_LEDGER", path)
    assert perf_ledger.default_path() == path
    entries = [_entry(1000.0), _entry(1050.0), _entry(800.0), _entry(900.0, backend="cuda"),
               _entry(700.0, backend="cuda", status="killed")]
    for e in entries:
        perf_ledger.append_entry(e)
    with open(path, "ab") as f:
        f.write(b'{"truncated')  # a writer killed mid-line
    perf_ledger.append_entry(_entry(500.0, backend="cuda"))
    got = perf_ledger.read_entries()
    assert len(got) == 6 and all(e["schema"] == 1 for e in got)
    assert perf_ledger.detect_regressions(got) == jax_ledger.detect_regressions(got)
    assert [r["value"] for r in perf_ledger.detect_regressions(got)] == [800.0, 500.0]
    assert perf_ledger.last_good(got)["value"] == 500.0  # a card's number, never the host's
    report = perf_ledger.render_report(got, path=path)
    assert "**REGRESSION**" in report and "search_throughput" in report
    assert perf_ledger.main(["last-good", "--ledger", path]) == 0
    assert perf_ledger.main(["report", "--ledger", path, "-o", str(tmp_path / "r.md")]) == 0


@pytest.mark.parametrize("mode", ["throughput", "quality"])
def test_search_bench_on_a_temporary_ledger(mode, tmp_path, capsys):
    path = str(tmp_path / "ledger.jsonl")
    rc = search_bench.main(["alexnet", "--devices", "8", "--budget", "60", "--repeats", "1",
                            "--mode", mode, "--ledger", path])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (entry,) = perf_ledger.read_entries(path)
    assert entry["backend"] == "cpu" and entry["proxy"] is False
    if mode == "throughput":
        assert out["identical"] is True and entry["metric"] == "search_throughput"
        assert entry["value"] == out["delta_proposals_per_s"]
    else:
        assert entry["metric"] == "search_quality" and entry["value"] == out["ratio"]
        assert out["single_ms"] > 0 and out["population_ms"] > 0
    assert "FF_SIM_DELTA" not in os.environ
