"""The port's native (C++) engines on the CPU: the event loop and the
annealer over the H100 machine model.

``g++`` builds ``flexflow_tpu_torch/native/*.cpp`` at first use into
``flexflow_tpu_torch/_build/``; here:

* ``utils/native.simulate_dag`` (``native/ffsim.cpp``) equals the JAX
  package's ``simulate_dag`` exactly on seeded random DAGs over chips,
  links and the host key (both loops are topology-free), and the port's
  plain Python loops (``delta._simulate_arrays_ref``,
  ``simulator.event_loop_ref``) bit for bit; a cycle raises;
* on the zoo's task graphs (data parallelism and random strategies of the
  search, DLRM's tables on the host among them) the C++ loop equals the
  Python loops bit for bit, through ``Simulator`` and ``DeltaSimulator``;
* the annealer's (``native/ffsearch.cpp``) ``dp_s`` and ``best_s`` equal
  the port's ``Simulator`` at rel 1e-9 for AlexNet, DLRM (the host tier)
  and NMT (the LSTM's two outputs, a shared embedding) at 1, 8 and 16
  GPUs (16: two nodes joined by InfiniBand), with the overlap mode on and
  off, and at budget 0 from a warm start;
* ``enumerate_candidates`` gives the JAX package's set per op where the
  two split spaces coincide, host placements included;
* with one seeded cost table patched into both packages, on two devices
  of one host at one link rate (where a torus and NVSwitch agree), the
  JAX package's annealer and the port's price data parallelism alike;
* the same seed gives the same map in two processes.
"""

import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest

import flexflow_tpu_torch as ft
from flexflow_tpu.simulator import native_search as jax_native
from flexflow_tpu.simulator.cost_model import CostModel as JaxCostModel
from flexflow_tpu.simulator.machine import TPUMachineModel
from flexflow_tpu.utils import native as jax_utils_native
from flexflow_tpu_torch.parallel.strategy import strategies_fingerprint
from flexflow_tpu_torch.simulator.cost_model import CostModel
from flexflow_tpu_torch.simulator.delta import DeltaSimulator, _simulate_arrays_ref
from flexflow_tpu_torch.simulator.machine import H100MachineModel
from flexflow_tpu_torch.simulator.native_search import (enumerate_candidates,
                                                        native_mcmc_search)
from flexflow_tpu_torch.simulator.search import random_parallel_config
from flexflow_tpu_torch.simulator.simulator import HOST_KEY, Simulator
from flexflow_tpu_torch.tools import offline_search
from flexflow_tpu_torch.utils import native

from test_torch_simulator import build_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-9


def _jax_simulate_dag(*arrays):
    """The JAX package's loop; its library is built by ``make`` at first
    use, and a worker that raced another's build retries the load."""
    for _ in range(5):
        got = jax_utils_native.simulate_dag(*arrays)
        if got is not None:
            return got
        jax_utils_native._libs.pop("libffsim.so", None)
        time.sleep(1.0)
    raise AssertionError("the JAX package's libffsim.so could not be loaded")


def _random_dag(seed, n=300, nd=8):
    """A DAG in creation order with ties: run times from a small set (zeros
    included), keys over chips, links and the host."""
    rng = np.random.default_rng(seed)
    rt = rng.choice([0.0, 1e-6, 2.5e-6, 1e-5, 3e-5], size=n)
    links = [-(a * nd + b + 1) for a in range(nd) for b in range(a + 1, nd)]
    keys = np.array(list(range(nd)) + [HOST_KEY] + links[:12], np.int64)
    dev = rng.choice(keys, size=n)
    src, dst = [], []
    for t in range(1, n):
        for s in rng.choice(t, size=min(t, int(rng.integers(0, 4))), replace=False):
            src.append(int(s))
            dst.append(t)
    return rt, dev, np.asarray(src, np.int32), np.asarray(dst, np.int32)


@pytest.mark.parametrize("seed", range(6))
def test_simulate_dag_equals_the_jax_loop_and_the_plain_loop(seed):
    arrays = _random_dag(seed)
    got = native.simulate_dag(*arrays)
    assert got == _jax_simulate_dag(*arrays)  # exact
    assert got == _simulate_arrays_ref(*arrays)
    # edges in another order: the same graph, the same float
    rt, dev, src, dst = arrays
    perm = np.random.default_rng(seed).permutation(len(src))
    assert native.simulate_dag(rt, dev, src[perm], dst[perm]) == got


def test_simulate_dag_raises_on_a_cycle_or_a_stray_edge():
    with pytest.raises(RuntimeError, match="cycle"):
        native.simulate_dag([1.0, 1.0, 1.0], [0, 0, 1], [0, 1, 2], [1, 2, 1])
    with pytest.raises(ValueError, match="outside the graph"):
        native.simulate_dag([1.0, 1.0], [0, 0], [0], [2])
    assert native.simulate_dag([], [], [], []) == 0.0
    info = native.build_info("ffsim.cpp")
    assert info["path"].startswith(native.BUILD_DIR) and os.path.exists(info["path"])


def _models():
    """Small zoo graphs (the port's, as the simulator tests build them)."""
    out = {}
    for name in ("alexnet", "dlrm", "nmt", "transformer_moe"):
        _, pm = build_pair(name, 64, 8)
        out[name] = pm
    return out


@pytest.mark.parametrize("overlap", [False, True])
def test_the_loops_agree_on_the_zoo_task_graphs(overlap):
    nd = 8
    mm = H100MachineModel(num_devices=nd)
    sim = Simulator(mm, CostModel(mm, cache_path=None), overlap_backward_update=overlap)
    rng = random.Random(7)
    hosted = 0
    for name, pm in _models().items():
        delta = DeltaSimulator(sim, pm)
        plans = [{}] + [{op.name: op.legalize_pc(random_parallel_config(op, nd, rng, model=pm))
                         for op in pm.ops} for _ in range(4)]
        for plan in plans:
            hosted += sum(pc.host_placed for pc in plan.values())
            full = sim.simulate_runtime(pm, plan)
            assert full == sim.simulate_runtime_ref(pm, plan), name
            arrays = delta.task_graph(plan)
            assert native.simulate_dag(*arrays) == _simulate_arrays_ref(*arrays) == full, name
    assert hosted > 0  # DLRM's tables on the host among the plans


def _dp(model, nd):
    return {op.name: op.legalize_pc(ft.ParallelConfig.data_parallel(op.output.num_dims, nd)
                                    .with_device_ids(tuple(range(nd)))) for op in model.ops}


@pytest.mark.parametrize("overlap", [False, True], ids=["barriers", "overlap"])
@pytest.mark.parametrize("nd", [1, 8, 16])
@pytest.mark.parametrize("name", ["alexnet", "dlrm", "nmt"])
def test_native_equals_the_simulator(name, nd, overlap):
    model = offline_search.build_model(name, 64, nd, device="cpu")
    mm = H100MachineModel.calibrated(num_devices=nd)
    r = native_mcmc_search(model, 400, machine_model=mm, seed=nd, verbose=False,
                           overlap_backward_update=overlap)
    sim = Simulator(mm, CostModel(mm, compute_dtype=model.config.compute_dtype),
                    overlap_backward_update=overlap)
    assert r.engine == "native" and r.num_devices == nd and (nd == 1 or r.evaluated > 0)
    assert r.dp_s == pytest.approx(sim.simulate_runtime(model, _dp(model, nd)), rel=REL)
    assert r.best_s == pytest.approx(sim.simulate_runtime(model, dict(r)), rel=REL)
    assert r.best_s <= r.dp_s
    if nd > 1:
        from flexflow_tpu_torch.parallel.mesh import hybrid_mesh_shape, placements_for_degrees

        sizes, names = hybrid_mesh_shape(nd, max(1, nd // 8))
        for op in model.ops:
            op.check_config(r[op.name])
            if not r[op.name].host_placed:
                placements_for_degrees(names, sizes, r[op.name].dims)


@pytest.mark.parametrize("name,nd", [("alexnet", 8), ("dlrm", 8), ("nmt", 16)])
def test_a_warm_start_at_budget_0_costs_exactly_that_plan(name, nd):
    """Every table on the host for DLRM (the host tier's serial timeline,
    no device all-reduce), random strategies of the search elsewhere."""
    model = offline_search.build_model(name, 64, nd, device="cpu")
    mm = H100MachineModel.calibrated(num_devices=nd)
    sim = Simulator(mm, CostModel(mm, compute_dtype=model.config.compute_dtype))
    rng = random.Random(nd)
    for _ in range(3):
        plan = {op.name: op.legalize_pc(random_parallel_config(op, nd, rng, model=model))
                for op in model.ops}
        if name == "dlrm":
            for op in model.ops:
                if op._type == "Embedding":
                    plan[op.name] = ft.ParallelConfig.host_rowsparse(op.output.num_dims)
        r = native_mcmc_search(model, 0, machine_model=mm, verbose=False, init_strategies=plan)
        assert r.dp_s == r.best_s == pytest.approx(sim.simulate_runtime(model, plan), rel=REL)
        assert dict(r) == {op.name: op.legalize_pc(plan[op.name]) for op in model.ops}


def _as_set(cands):
    return {(pc.device_type.value, pc.dims, tuple(pc.device_ids)) for pc in cands}


@pytest.mark.parametrize("name", ["alexnet", "transformer", "dlrm", "nmt"])
def test_candidates_are_the_jax_packages(name):
    """Eight devices of one node: every degree vector composes, so the two
    enumerations hold the same (device type, dims, device ids) per op,
    the host placement of DLRM's tables included."""
    jm, pm = build_pair(name, 64, 8, seq_length=64, num_layers=2, embed_dim=128, num_heads=8,
                        vocab_size=512)
    hosts = 0
    for jop, pop in zip(jm.ops, pm.ops):
        want = _as_set(jax_native.enumerate_candidates(jop, 8, model=jm))
        assert _as_set(enumerate_candidates(pop, 8, model=pm)) == want, pop.name
        hosts += sum(1 for t, _, _ in want if t == ft.DeviceType.CPU.value)
    if name in ("alexnet", "dlrm"):
        assert (hosts > 0) == (name == "dlrm")


def _seeded_table(seed):
    """op_time from one seeded table, keyed alike in both packages."""
    cache = {}

    def op_time(self, op, pc, which):
        key = (op.name, tuple(pc.dims), tuple(pc.device_ids[:pc.num_parts()]),
               int(pc.device_type.value), which)
        if key not in cache:
            rs = random.Random(f"{seed}:{key}")
            cache[key] = rs.uniform(1e-5, 2e-3)
        return cache[key]
    return op_time


@pytest.mark.parametrize("name", ["alexnet", "nmt"])
def test_two_devices_at_one_link_rate_price_data_parallelism_as_the_jax_annealer(
        name, monkeypatch):
    jax_lib = None
    for _ in range(5):  # the JAX package builds its library with make at first use
        jax_lib = jax_native.native_lib()
        if jax_lib is not None:
            break
        jax_utils_native._libs.pop("libffsearch.so", None)
        time.sleep(1.0)
    assert jax_lib is not None, "the JAX package's libffsearch.so could not be loaded"
    table = _seeded_table(11)
    monkeypatch.setattr(JaxCostModel, "op_time", table)
    monkeypatch.setattr(CostModel, "op_time", table)
    jm, pm = build_pair(name, 64, 2)
    bw = 45e9
    _, _, want = jax_native.native_mcmc_search(
        jm, budget=0, machine_model=TPUMachineModel(num_devices=2, ici_bandwidth=bw),
        verbose=False)
    got = native_mcmc_search(pm, 0, machine_model=H100MachineModel(num_devices=2,
                                                                    nvlink_bandwidth=bw),
                             verbose=False)
    assert got.dp_s == want


_SEEDED = r"""
import sys
sys.path.insert(0, sys.argv[1])
from flexflow_tpu_torch.parallel.strategy import strategies_fingerprint
from flexflow_tpu_torch.simulator.machine import H100MachineModel
from flexflow_tpu_torch.simulator.native_search import native_mcmc_search
from flexflow_tpu_torch.tools import offline_search
m = offline_search.build_model("alexnet", 64, 8, device="cpu")
r = native_mcmc_search(m, 800, seed=3, verbose=False,
                       machine_model=H100MachineModel.calibrated(num_devices=8))
print(strategies_fingerprint(dict(r)), repr(r.best_s), repr(r.dp_s))
"""


def test_the_same_seed_gives_the_same_map_in_two_processes():
    outs = [subprocess.run([sys.executable, "-c", _SEEDED, ROOT], capture_output=True,
                           text=True, timeout=300, cwd=ROOT) for _ in range(2)]
    for o in outs:
        assert o.returncode == 0, o.stderr[-2000:]
    assert outs[0].stdout == outs[1].stdout
    m = offline_search.build_model("alexnet", 64, 8, device="cpu")
    r = native_mcmc_search(m, 800, seed=3, verbose=False,
                           machine_model=H100MachineModel.calibrated(num_devices=8))
    assert outs[0].stdout.split() == [strategies_fingerprint(dict(r)), repr(r.best_s),
                                      repr(r.dp_s)]


def test_the_native_search_is_traced(tmp_path, monkeypatch):
    """With telemetry on, the anneal is one ``native_search`` span and the
    recorder's start and per-op finish (``tools/search_report.py`` reads
    the native engine's trace)."""
    import json

    from flexflow_tpu_torch.observability import events

    path = tmp_path / "t.jsonl"
    monkeypatch.setenv("FF_TELEMETRY", "1")
    monkeypatch.setenv("FF_TELEMETRY_FILE", str(path))
    try:
        m = offline_search.build_model("alexnet", 64, 8, device="cpu")
        log = events.active_log()
        assert log is not None
        r = native_mcmc_search(m, 200, verbose=False,
                               machine_model=H100MachineModel.calibrated(num_devices=8))
        log.flush()
    finally:
        events.reset_active()
    recs = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    names = [x.get("name") for x in recs]
    assert "native_search" in names and "search_start" in names
    span = next(x for x in recs if x.get("name") == "native_search")
    assert span["attrs"]["best_ms"] == round(r.best_s * 1e3, 3)
    start = next(x for x in recs if x.get("name") == "search_start")
    assert start["attrs"]["engine"] == "native" and start["attrs"]["candidates"] == r.candidates


def test_the_native_libraries_are_the_ports_own():
    """The port builds only its own sources, into its own build directory,
    and names none of the JAX package's libraries (nor runs its make)."""
    port = os.path.join(ROOT, "flexflow_tpu_torch")
    assert native.NATIVE_DIR == os.path.join(port, "native")
    assert native.BUILD_DIR == os.path.join(port, "_build")
    assert sorted(f for f in os.listdir(native.NATIVE_DIR) if f.endswith(".cpp")) == \
        ["ffsearch.cpp", "ffsim.cpp", "flexflow_c.cpp"]
    sources = [os.path.join(d, f) for d, _, fs in os.walk(port) for f in fs
               if f.endswith((".py", ".cpp"))] + [os.path.join(ROOT, "chip_smoke.py")]
    for path in sources:
        with open(path) as f:
            text = f.read()
        for name in ("libffsim.so", "libffsearch.so", "libffdata.so", "make -C"):
            assert name not in text, f"{os.path.relpath(path, ROOT)} names {name}"


@pytest.mark.parametrize("engine", ["", "native"])
def test_a_library_that_does_not_build(engine, monkeypatch, capsys):
    """"native" raises with the compiler's message; "" runs mcmc, as the
    JAX package does, and says so on its line and in the engine's name."""
    from flexflow_tpu_torch.simulator import native_search

    def fail():
        raise RuntimeError("g++ failed on ffsearch.cpp (rc 1): a planted error")
    monkeypatch.setattr(native_search, "native_lib", fail)
    m = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu", search_budget=20,
                               search_engine=engine))
    x = m.create_tensor((4, 8))
    m.softmax(m.dense(x, 3, name="fc"), name="sm")
    if engine == "native":
        with pytest.raises(RuntimeError, match="a planted error"):
            m.compile(ft.SGDOptimizer(lr=0.1))
        return
    m.compile(ft.SGDOptimizer(lr=0.1))
    out = capsys.readouterr().out
    assert "mcmc (native unavailable) search over 1 GPU(s)" in out and "a planted error" in out
    assert m._search_provenance["engine"] == "mcmc (native unavailable)"
    m.init_layers(seed=0)
    m.set_batch({x: np.ones((4, 8), np.float32)}, np.zeros((4, 1), np.int32))
    m.train_iteration()
    assert m.get_metrics().train_all == 4
