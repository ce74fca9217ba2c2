"""The port's strategy search against the JAX package's, on the CPU.

The harness of tests/test_torch_simulator.py (the JAX package's machine
model and measured cache, handed to the port by a test-local machine
model) makes both packages cost alike, so a seeded search must return the
same strategy and the same floats:

* the port's ``mcmc_search`` reproduces the reference's single-chain
  goldens of tests/test_population_search.py bit for bit (AlexNet at 16
  devices, which splits pool3 on height and width, the transformer at 64):
  the port proposes what the reference proposes;
* seeded searches (MCMC at other seeds and device counts over the zoo,
  DLRM's host placements among the proposals, and ``population_search``
  with its warm start from strategies/alexnet_16.pb) equal the JAX
  package's unrestricted search: the same search space (``_SPLITTABLE``:
  convs and pools on height and width, the LSTM's hidden dim, the experts)
  and the same host placement of eligible tables;
* ``compile(search_budget=...)`` searches on the CPU with each engine,
  trains a step and exports a strategy that loads back equal; "native"
  raises naming ROADMAP A8b;
* a strategy the port's search found for 4 devices trains a small CNN on 4
  gloo ranks to the JAX package's single-device weights;
* the offline search and the calibration tool's fit run on the CPU.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

import jax

import flexflow_tpu as ff
import flexflow_tpu.parallel.strategy as jax_strategy
from flexflow_tpu.simulator import search as jax_search
from flexflow_tpu.simulator.population import population_search as jax_population_search
from flexflow_tpu_torch.convert import jax_params_to_numpy
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.parallel.strategy as port_strategy
from flexflow_tpu_torch.parallel.strategy import (load_strategies_from_file, read_provenance,
                                                  save_strategies_to_file,
                                                  strategies_fingerprint)
from flexflow_tpu_torch.simulator.machine import H100MachineModel
from flexflow_tpu_torch.simulator.population import population_search
from flexflow_tpu_torch.simulator.search import (enumerate_candidates, in_search_space,
                                                 mcmc_search, random_parallel_config,
                                                 splittable_dims)
from flexflow_tpu_torch.tools import calibrate, offline_search

from test_torch_simulator import ZOO, build_pair, cost_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_population_search.py's single-chain goldens: the JAX
# package's build_model(name, 64, nd) (its default transformer: S 256,
# 4 layers, E 512, 8 heads, vocab 32000), float32.
GOLDENS = [
    ("alexnet", 16, 300, 3, 0.00388669815776176, 0.01863936267427486,
     "sha256:1dd6a00fcccd3c077c5835ded51dd71c56f8eb232be75f6c9134e4c886574074"),
    ("transformer", 64, 200, 0, 0.013445108752907626, 0.014559030250737392,
     "sha256:5569e1894349173d188a2095401cf2d7f0bae14ec12c1957cb96db93193965de"),
]


def _search_pair(engine, name, nd, budget, seed, tmp_path, **kw):
    """(reference result, port result) of one seeded search."""
    jm, pm = build_pair(name, 64, nd)
    mm, jc, pmm, pc = cost_pair(nd, tmp_path)
    if engine == "mcmc":
        want = jax_search.mcmc_search(jm, budget, seed=seed, machine_model=mm, cost_model=jc,
                                      verbose=False, **kw)
        got = mcmc_search(pm, budget, seed=seed, machine_model=pmm, cost_model=pc,
                          verbose=False, **kw)
    else:
        want = jax_population_search(jm, budget, seed=seed, machine_model=mm, cost_model=jc,
                                     verbose=False, **kw)
        got = population_search(pm, budget, seed=seed, machine_model=pmm, cost_model=pc,
                                verbose=False, **kw)
    return want, got


def _dims(result):
    return {k: (v.dims, v.device_ids) for k, v in result.items()}


@pytest.mark.parametrize("name,nd,budget,seed,best_s,dp_s,fp", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_mcmc_reproduces_the_reference_golden(name, nd, budget, seed, best_s, dp_s, fp,
                                              tmp_path):
    _, pm = build_pair(name, 64, nd)
    _, _, pmm, pc = cost_pair(nd, tmp_path)
    r = mcmc_search(pm, budget=budget, seed=seed, machine_model=pmm, cost_model=pc,
                    verbose=False)
    assert r.best_s == best_s  # exact: bitwise, not approx
    assert r.dp_s == dp_s
    assert strategies_fingerprint(dict(r)) == fp
    assert (r.engine, r.budget, r.seed, r.num_devices) == ("mcmc", budget, seed, nd)


@pytest.mark.parametrize("name,nd,budget,seed", [("alexnet", 4, 300, 1), ("alexnet", 8, 200, 7),
                                                 ("alexnet", 16, 300, 3),
                                                 ("transformer", 16, 150, 2),
                                                 ("transformer", 8, 200, 5),
                                                 ("nmt", 8, 150, 1), ("dlrm", 8, 150, 2),
                                                 ("transformer_moe", 8, 150, 3),
                                                 ("candle_uno", 4, 150, 4)])
def test_mcmc_equals_the_restricted_reference(name, nd, budget, seed, tmp_path):
    """The port's search against the JAX package's unrestricted one (the
    name is older than the equal search spaces)."""
    want, got = _search_pair("mcmc", name, nd, budget, seed, tmp_path)
    assert (got.best_s, got.dp_s) == (want.best_s, want.dp_s)
    assert _dims(got) == _dims(want)
    _, pm = build_pair(name, 64, nd)
    assert all(in_search_space(op, got[op.name]) for op in pm.ops)
    if (name, nd) == ("alexnet", 16):  # the golden's seed: the golden itself
        assert (got.best_s, got.dp_s) == GOLDENS[0][4:6]
        assert strategies_fingerprint(dict(got)) == GOLDENS[0][6]


@pytest.mark.parametrize("name,nd,budget,seed", [("transformer", 64, 200, 0),
                                                 ("alexnet", 16, 300, 3),
                                                 ("alexnet", 4, 200, 1)])
def test_population_equals_the_restricted_reference(name, nd, budget, seed, tmp_path):
    """The tempered population against the JAX package's unrestricted one."""
    want, got = _search_pair("population", name, nd, budget, seed, tmp_path)
    assert (got.best_s, got.dp_s) == (want.best_s, want.dp_s)
    assert _dims(got) == _dims(want)
    assert got.chains == want.chains
    for k in ("spent", "winner_chain", "exchange", "crossover", "lineage"):
        assert got.stats[k] == want.stats[k], k
    assert got.stats["learned"]["used_families"] == want.stats["learned"]["used_families"]
    if (name, nd) == ("transformer", 64):
        # attention sequence splits in the space (0.012368573036562407 without)
        assert got.best_s == 0.010052137823982232
    if (name, nd) == ("alexnet", 16):
        # strategies/alexnet_16.pb splits conv1 on height and width: a warm start
        assert [c["seed"] for c in got.chains[:2]] == ["dp", "sidecar:alexnet_16.pb"]


def test_population_warm_starts_only_from_strategies_it_could_propose(tmp_path, monkeypatch):
    """A shipped strategy for this model and device count seeds a chain
    when it splits only dims the search proposes (a conv's height now
    among them); one that splits a conv's output channels does not."""
    _, pm = build_pair("alexnet", 64, 8)
    legal = {op.name: ft.ParallelConfig.data_parallel(op.output.num_dims, 8) for op in pm.ops}
    legal["fc1"] = ft.ParallelConfig(dims=(1, 8))
    legal["conv1"] = ft.ParallelConfig(dims=(2, 4, 1, 1))
    spatial = dict(legal, conv1=ft.ParallelConfig(dims=(1, 1, 1, 8)))
    assert in_search_space(pm.ops[0], legal["conv1"])
    assert not in_search_space(pm.ops[0], spatial["conv1"])
    sdir = tmp_path / "strategies"
    sdir.mkdir()
    for fn, strategies in (("a_spatial.pb", spatial), ("b_legal.pb", legal)):
        save_strategies_to_file(str(sdir / fn), strategies,
                                provenance={"model": "alexnet", "num_devices": 8})
    monkeypatch.setattr(port_strategy, "DEFAULT_STRATEGY_DIR", str(sdir))
    assert [label for label, _ in port_strategy.load_warm_starts(pm, 8)] == \
        ["a_spatial.pb", "b_legal.pb"]
    _, _, pmm, pc = cost_pair(8, tmp_path)
    got = population_search(pm, 40, seed=2, machine_model=pmm, cost_model=pc, verbose=False)
    assert [c["seed"] for c in got.chains[:3]] == ["dp", "sidecar:b_legal.pb", "random"]
    assert got.stats["population"] == len(got.chains) == 8


def test_no_candidate_splits_an_attention_sequence():
    """Attention's sequence is splittable now (ring or Ulysses attention):
    the search proposes sequence splits, and the op accepts every one (a
    Ulysses op refuses a sequence degree that does not divide the heads a
    part holds, and the ring takes any)."""
    m = ft.FFModel(ft.FFConfig(batch_size=8, workers_per_node=8, device="cpu"))
    m.multihead_attention(m.create_tensor((8, 64, 64), nchw=False), num_heads=8)
    op = m.ops[0]
    assert splittable_dims(op) == (0, 1, 2)
    cands = enumerate_candidates(op, 8)
    assert {pc.dims for pc in cands} >= {(8, 1, 1), (1, 1, 8), (2, 1, 4), (1, 8, 1),
                                         (2, 4, 1), (1, 2, 4)}
    for pc in cands:
        op.check_config(pc)
    op.seq_parallel_mode = "ulysses"
    op.check_config(ft.ParallelConfig(dims=(1, 2, 4)))  # 8 / 4 heads, 2 ways
    with pytest.raises(ValueError, match="sequence degree 4 and head degree 4"):
        op.check_config(ft.ParallelConfig(dims=(1, 4, 4)))


@pytest.mark.parametrize("kind", ["conv", "pool"])
def test_no_candidate_splits_a_conv_or_pool_spatially(kind):
    """The name is older than the split: convs and pools are now split on
    height and width as the JAX package's search splits them, and every
    spatial candidate computes, tile by tile (``forward_tiles``), the
    unsplit op's output and gradients."""
    import torch

    m = ft.FFModel(ft.FFConfig(batch_size=8, workers_per_node=8, device="cpu"))
    t = m.create_tensor((8, 4, 16, 16))
    if kind == "conv":
        m.conv2d(t, 8, 3, 3, 1, 1, 1, 1)
    else:
        m.pool2d(t, 2, 2, 2, 2, 0, 0)
    op = m.ops[0]
    assert splittable_dims(op) == (0, 1, 2)
    cands = {pc.dims for pc in enumerate_candidates(op, 8)}
    spatial = sorted(d for d in cands if d[1] > 1 or d[2] > 1)
    assert {(1, 2, 1, 1), (1, 1, 8, 1), (2, 2, 2, 1), (1, 4, 2, 1)} <= set(spatial)
    gen = torch.Generator().manual_seed(0)
    params = {w.name: torch.randn(w.dims, generator=gen, dtype=torch.float64,
                                  requires_grad=True) for w in op.weights}
    x = torch.randn(8, 16, 16, 4, generator=gen, dtype=torch.float64, requires_grad=True)
    y = op.forward(params, [x], None)[0]
    g = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    want = torch.autograd.grad(y, [x, *params.values()], g)
    for dims in spatial:
        op.check_config(ft.ParallelConfig(dims=dims))
        got_y = op.forward_tiles(params, x, dims[1], dims[2])
        torch.testing.assert_close(got_y, y, rtol=1e-12, atol=1e-12)
        got = torch.autograd.grad(got_y, [x, *params.values()], g)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def _small_cnn(cfg):
    m = ft.FFModel(cfg)
    inp = m.create_tensor((cfg.batch_size, 3, 12, 12))
    t = m.conv2d(inp, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="conv1")
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = m.flat(t, name="flat1")
    t = m.dense(t, 32, activation="relu", name="fc1")
    t = m.dense(t, 10, name="fc2")
    m.softmax(t, name="softmax1")
    return m, inp


@pytest.mark.parametrize("engine", ["", "mcmc", "population"])
def test_compile_searches_trains_and_exports(engine, tmp_path, capsys):
    pb = str(tmp_path / "searched.pb")
    cfg = ft.FFConfig(batch_size=16, device="cpu", search_budget=50, search_engine=engine,
                      seed=3, export_strategy_file=pb)
    m, inp = _small_cnn(cfg)
    m.compile(ft.SGDOptimizer(m, lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    out = capsys.readouterr().out
    assert f"{engine or 'mcmc'} search over 1 GPU(s), budget 50" in out
    assert "spec (unfitted)" in out or "fitted on" in out
    # the searched map, resolved, legalized and placed as any other
    assert set(cfg.strategies) == {op.name for op in m.ops}
    assert load_strategies_from_file(pb) == {op.name: op.pc for op in m.ops}
    meta = read_provenance(pb)
    assert (meta["engine"], meta["budget"], meta["num_devices"]) == \
        (engine or "mcmc", 50, 1)
    m.init_layers(seed=0)
    rng = np.random.default_rng(0)
    m.set_batch({inp: rng.standard_normal((16, 12, 12, 3), dtype=np.float32)},
                rng.integers(0, 10, (16, 1)).astype(np.int32))
    m.train_iteration()
    assert m.get_metrics().train_all == 16 and np.isfinite(m.last_loss)


def _zoo_batch(model, rng):
    """A batch for each graph input of a small zoo model: ids below the
    smallest table or vocabulary that reads them, else normal floats."""
    rows = {id(op.inputs[0]): op.num_entries for op in model.ops if op._type == "Embedding"}
    xs = {}
    for t in model.input_tensors:
        if "int" in t.dtype:
            xs[t] = rng.integers(0, min(rows.get(id(t), 16), 16), size=t.dims).astype(np.int32)
        else:
            xs[t] = rng.standard_normal(t.dims).astype(np.float32)
    lt = model.label_tensor
    labels = (rng.integers(0, 4, size=lt.dims).astype(np.int32) if "int" in lt.dtype
              else rng.standard_normal(lt.dims).astype(np.float32))
    return xs, labels


@pytest.mark.parametrize("name", sorted(ZOO))
def test_compile_searches_each_zoo_model_and_trains(name, capsys):
    """compile(search_budget=...) on every new model of the zoo (its small
    test size, one device): the search runs, every resolved config is one
    the port trains (check_config), and a step trains."""
    port_build, _, kw = ZOO[name]
    batch = 4
    cfg = ft.FFConfig(batch_size=batch, device="cpu", search_budget=30, seed=1)
    m = ft.FFModel(cfg)
    port_build(m, batch, **kw)
    loss = ("mean_squared_error" if name in ("dlrm", "candle_uno")
            else "sparse_categorical_crossentropy")
    m.compile(ft.SGDOptimizer(m, lr=0.01), loss, ["accuracy"])
    assert "mcmc search over 1 GPU(s), budget 30" in capsys.readouterr().out
    assert set(cfg.strategies) == {op.name for op in m.ops}
    for op in m.ops:
        op.check_config(op.pc)
    m.init_layers(seed=0)
    xs, labels = _zoo_batch(m, np.random.default_rng(0))
    m.set_batch(xs, labels)
    m.train_iteration()
    assert m.get_metrics().train_all > 0 and np.isfinite(m.last_loss)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_offline_search_of_each_zoo_model_stays_in_the_ports_space(name, tmp_path):
    """An 8-GPU search of each new model proposes only configs the port
    trains, over the JAX package's whole space (the LSTM's hidden split,
    the experts, convs and pools on height and width, tables on the host),
    and the search meets such configs."""
    _, pm = build_pair(name, 64, 8)
    _, _, pmm, pc = cost_pair(8, tmp_path)
    best = mcmc_search(pm, budget=150, seed=2, machine_model=pmm, cost_model=pc, verbose=False)
    for op in pm.ops:
        assert in_search_space(op, best[op.name])
        op.check_config(best[op.name])
    wide = {"resnet": "Conv2D", "inception": "Conv2D", "nmt": "LSTM",
            "transformer_moe": "ExpertMLP"}.get(name)
    if wide is not None:  # a proposal outside the batch split, for the op family
        rng = random.Random(0)
        op = next(o for o in pm.ops if o._type == wide and o.output.dims[1] % 2 == 0)
        assert any(max(random_parallel_config(op, 8, rng).dims[1:]) > 1 for _ in range(50))


@pytest.mark.parametrize("engine,exc,match", [("native", NotImplementedError, "ROADMAP A8b"),
                                              ("bogus", ValueError, "unknown search_engine")])
def test_compile_refuses_unported_and_unknown_engines(engine, exc, match):
    m, _ = _small_cnn(ft.FFConfig(batch_size=16, device="cpu", search_budget=10,
                                  search_engine=engine))
    with pytest.raises(exc, match=match):
        m.compile(ft.SGDOptimizer(m, lr=0.1))


# ---------------------------------------------------------------- 4 gloo ranks

CNN_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_torch_soap.py's
CNN_STEPS = 6

_RANK = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
job = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
sys.path.insert(0, job["root"])
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.convert import load_jax_params
from flexflow_tpu_torch.parallel import distributed as dist
dist.initialize("cpu", init_method=job["init"], world_size=4, rank=rank)
m = ft.FFModel(ft.FFConfig(batch_size=16, device="cpu", search_budget=job["budget"],
                           seed=job["seed"], fused_optimizer=True))
inp = m.create_tensor((16, 3, 12, 12))
t = m.conv2d(inp, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="conv1")
t = m.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
t = m.flat(t, name="flat1")
t = m.dense(t, 32, activation="relu", name="fc1")
t = m.dense(t, 10, name="fc2")
m.softmax(t, name="softmax1")
m.compile(ft.SGDOptimizer(m, lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
m.init_layers(seed=9)
load_jax_params(m, np.load(job["params"], allow_pickle=True).item())
data = np.load(job["data"])
dl = ft.DataLoader(m, {inp: data["x"]}, data["y"])
for _ in range(job["steps"]):
    dl.next_batch(m)
    m.train_iteration()
out = dict(pcs={op.name: op.pc.dims for op in m.ops},
           conv1=m.get_parameter("conv1", "kernel"), fc2=m.get_parameter("fc2", "kernel"))
np.save(job["out"] % rank, out, allow_pickle=True)
dist.shutdown()
"""


def _jax_cnn(x, y):
    m = ff.FFModel(ff.FFConfig(batch_size=16, workers_per_node=1))
    inp = m.create_tensor((16, 3, 12, 12))
    t = m.conv2d(inp, 8, 3, 3, 1, 1, 1, 1, activation=ff.ActiMode.RELU, name="conv1")
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = m.flat(t, name="flat1")
    t = m.dense(t, 32, activation=ff.ActiMode.RELU, name="fc1")
    t = m.dense(t, 10, name="fc2")
    m.softmax(t, name="softmax1")
    m.compile(ff.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"],
              machine=ff.Machine(devices=jax.devices()[:1]))
    m.init_layers(seed=3)
    params0 = jax_params_to_numpy(m)
    dl = ff.DataLoader(m, {inp: x}, y)
    for _ in range(CNN_STEPS):
        dl.next_batch(m)
        m.train_iteration()
    return params0, m


def test_a_searched_strategy_trains_on_four_gloo_ranks(tmp_path):
    budget, seed = 300, 1
    # the strategy the search finds for this CNN on 4 devices (the search is
    # deterministic: every rank finds this one)
    m, _ = _small_cnn(ft.FFConfig(batch_size=16, workers_per_node=4, device="cpu"))
    found = {k: v.dims for k, v in mcmc_search(
        m, budget, seed=seed, verbose=False,
        machine_model=H100MachineModel.calibrated(num_devices=4)).items()}
    assert found != {op.name: (4,) + (1,) * (op.output.num_dims - 1) for op in m.ops}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((32, 3, 12, 12), dtype=np.float32)
    y = rng.integers(0, 10, size=(32, 1), dtype=np.int32)
    np.savez(tmp_path / "data.npz", x=x, y=y)
    params0, jm = _jax_cnn(x, y)
    np.save(tmp_path / "params.npy", params0, allow_pickle=True)
    job = dict(root=ROOT, init=f"file://{tmp_path / 'pg'}", params=str(tmp_path / "params.npy"),
               data=str(tmp_path / "data.npz"), out=str(tmp_path / "out_%d.npy"),
               budget=budget, seed=seed, steps=CNN_STEPS)
    with open(tmp_path / "job.json", "w") as f:
        json.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(tmp_path / "job.json"), str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r in range(4):
        out = np.load(tmp_path / f"out_{r}.npy", allow_pickle=True).item()
        legal = {k: m.ops[i].legalize_pc(ft.ParallelConfig(dims=v)).dims
                 for i, (k, v) in enumerate(found.items())}
        assert out["pcs"] == legal
        for op in ("conv1", "fc2"):
            np.testing.assert_allclose(out[op], jm.get_parameter(op, "kernel"), **CNN_TOL,
                                       err_msg=f"rank {r} {op}")


# ---------------------------------------------------------------- tools

def test_offline_search_for_an_h100_node(tmp_path, capsys):
    pb = str(tmp_path / "alexnet_8.pb")
    best = offline_search.main(["alexnet", "--devices", "8", "--budget", "150", "--batch-size",
                                "64", "--export", pb, "--device", "cpu", "--quiet"])
    out = capsys.readouterr().out
    assert "data-parallel:" in out and "proposals/s" in out and "on 8 H100(s)" in out
    assert best.best_s <= best.dp_s
    assert load_strategies_from_file(pb) == dict(best)
    meta = read_provenance(pb)
    assert (meta["model"], meta["num_devices"], meta["engine"]) == ("alexnet", 8, "mcmc")
    # every model of the zoo builds, at the full width of its cell
    for name, (_, _, batch, _) in offline_search.MODELS.items():
        m = offline_search.build_model(name, batch, 8, device="cpu")
        assert m.ops and m.config.batch_size == batch
    with pytest.raises(ValueError, match="unknown model"):
        offline_search.build_model("vgg", 64, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A8b"):
        offline_search.run(offline_search.build_model("alexnet", 64, 8, device="cpu"), 8, 10,
                           engine="native")


def test_offline_search_for_two_h100_nodes(tmp_path, capsys):
    """``--devices 16``: two nodes of 8 joined by InfiniBand; every config
    of the search composes over the hybrid mesh (a dcn dim of 2, then each
    node's 8 GPUs) and is one its op trains; a count that does not fill
    whole nodes is refused."""
    from flexflow_tpu_torch.parallel.mesh import hybrid_mesh_shape, placements_for_degrees

    best = offline_search.main(["nmt", "--devices", "16", "--budget", "150", "--device", "cpu",
                                "--quiet"])
    assert "on 16 H100(s)" in capsys.readouterr().out
    assert best.num_devices == 16 and best.best_s <= best.dp_s
    sizes, names = hybrid_mesh_shape(16, 2)
    model = offline_search.build_model("nmt", 64, 16, device="cpu")
    for op in model.ops:
        pc = op.legalize_pc(best[op.name])
        op.check_config(pc)
        if not pc.host_placed:
            placements_for_degrees(names, sizes, pc.dims)
    with pytest.raises(SystemExit):
        offline_search.main(["nmt", "--devices", "12", "--device", "cpu", "--quiet"])


def test_calibration_jobs_and_fit(tmp_path):
    """The tool's job list and roofline fit on the CPU: measurements taken
    here are tagged "cpu", so the fit is held on records it builds from
    them directly."""
    m = offline_search.build_model("alexnet", 64, 8, device="cpu", compute_dtype="bfloat16")
    from flexflow_tpu_torch.simulator.cost_model import CostModel

    cost = CostModel(H100MachineModel(num_devices=8), compute_dtype="bfloat16",
                     cache_path=str(tmp_path / "c.json"),
                     measured_cache_path=str(tmp_path / "none.json"))
    jobs = calibrate.candidate_jobs(m, 8, cost, full=False, dp_parts=(1, 2, 4, 8))
    keys = [j[3] for j in jobs]
    assert len(keys) == len(set(keys)) == 13 * 4 * 2
    full = calibrate.candidate_jobs(m, 8, cost, full=True)
    assert {j[3] for j in jobs} <= {j[3] for j in full}
    # records whose times the roofline of known constants produces: the fit
    # recovers those constants
    mm = H100MachineModel(num_devices=8)
    truth = H100MachineModel(num_devices=8, matmul_efficiency=0.4,
                             hbm_bandwidth=0.8 * mm.hbm_bandwidth, kernel_launch_overhead=8e-6)
    for op, pc, which, key in jobs:
        cost._measured[key] = CostModel(truth, compute_dtype="bfloat16",
                                        cache_path=None)._analytic(op, pc, which)
    recs = calibrate.collect_fit_records([m], [8], cost)
    assert len(recs) == 13 * 4
    fit = calibrate.fit_machine(recs, mm)
    assert fit["matmul_efficiency"] == pytest.approx(0.4)
    assert fit["hbm_bandwidth"] == pytest.approx(0.8 * mm.hbm_bandwidth)
    assert fit["kernel_launch_overhead"] == 8e-6
    assert fit["backward_multiplier"] == pytest.approx(2.0)
    assert fit["fit_log_rmse"] < 1e-6 and fit["fit_points"] == 13 * 4
