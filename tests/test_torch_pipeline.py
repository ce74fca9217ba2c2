"""Pipeline parallelism in the port against the JAX package, on the CPU.

* The GPipe schedule in lockstep (``parallel.pipeline.gpipe`` with no
  group: every ring slot in this process) against the JAX package's
  ``pipeline_graph_apply`` on a 4-device mesh: value and gradient of the
  inputs and of every stage weight, with uneven boundaries, 8 stages
  composed onto 4 slots, a skip connection riding two hops and remat
  (rtol 1e-5 on the value, rtol 1e-4 atol 1e-6 on the gradients, the JAX
  package's own tolerances, tests/test_pipeline.py:396-398).
* In this process (one device): ``set_pipeline``'s validation errors, the
  single-device fallback (no ring, the ops as built, trained against the
  JAX package's fallback), ``generate`` on a pipelined model against the
  JAX package's unpipelined model, ``PipelineMLP``'s numerics and legal
  degrees, and ``search_pipeline`` on the JAX package's measured cost
  table (the harness of tests/test_torch_simulator.py) returning the JAX
  package's plan, which ``compile`` applies.
* One job of 4 gloo ranks (tests/test_torch_soap.py's harness): the MLP of
  tests/test_pipeline.py under ``set_pipeline`` (4 stages; remat with 8
  microbatches; dp x pp = 2 x 2 with two stages a slot; explicit stages),
  3 SGD steps against the JAX package's model pipelined over 4 of its
  devices, losses and weights at rtol 2e-4, atol 2e-5 (the JAX package's
  pipeline tolerance); a skip connection riding two hops; ``PipelineMLP``
  at degree 4 and at 2 x 2; a ring of 3 the mesh cannot express (the
  fallback message); the BatchNorm refusal; and compile with
  ``search_pipeline`` on.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import flexflow_tpu as ff
from flexflow_tpu.parallel.pipeline import pipeline_graph_apply
from flexflow_tpu.simulator import pipeline_search as jax_pipeline_search
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.parallel.pipeline import Spec, compose_slots, gpipe
from flexflow_tpu_torch.simulator import pipeline_search

from test_torch_simulator import cost_pair
from test_torch_soap import _PRELUDE, _launch

WORLD = 4
VALUE_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PIPE_TOL = dict(rtol=2e-4, atol=2e-5)
BATCH, STEPS = 16, 3


# ---------------------------------------------------------------- the schedule

def _jax_value_and_grad(fn, params, x):
    v, g = jax.jit(jax.value_and_grad(lambda p, x_: jnp.sum(fn(p, x_) ** 2),
                                      argnums=(0, 1)))(params, x)
    return np.asarray(v), [np.asarray(a) for a in g[0]], np.asarray(g[1])


def _port_value_and_grad(fn, params, x):
    ps = [torch.tensor(np.asarray(p), requires_grad=True) for p in params]
    xt = torch.tensor(np.asarray(x), requires_grad=True)
    y = fn(ps, xt)
    loss = (y ** 2).sum()
    g = torch.autograd.grad(loss, ps + [xt])
    return loss.detach().numpy(), [a.numpy() for a in g[:-1]], g[-1].numpy()


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dims", [
    [(16, 64), (64, 64), (64, 4), (4, 3)],
    [(16, 64), (64, 64), (64, 4), (4, 4), (4, 4), (4, 4), (4, 4), (4, 3)],
], ids=["4-stages", "8-stages-on-4-slots"])
def test_lockstep_schedule_matches_jax_pipeline_graph_apply(dims, remat):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:WORLD]), ("pipe",))
    params = [(np.random.default_rng(i).standard_normal(d) * 0.1).astype(np.float32)
              for i, d in enumerate(dims)]
    x = np.random.default_rng(9).standard_normal((8, 16)).astype(np.float32)
    S = len(dims)
    jfns = [lambda p, h, mi, i=i: jnp.tanh(h @ p[i]) for i in range(S)]

    def jax_fn(p, x_):
        return pipeline_graph_apply(jfns, p, x_, mesh, "pipe", 4, [(d[0],) for d in dims],
                                    [(d[1],) for d in dims], remat=remat)

    tfns = [lambda p, hs, mi, i=i: [torch.tanh(hs[0] @ p[f"w{i}"])] for i in range(S)]
    k = S // WORLD
    specs = [[Spec((dims[(r + 1) * k - 1][1],), torch.float32)] for r in range(WORLD)]

    def port_fn(ps, xt):
        y, = gpipe(compose_slots(tfns, WORLD), {f"w{i}": p for i, p in enumerate(ps)}, [xt],
                   4, specs, remat=remat)
        return y

    want = _jax_value_and_grad(jax_fn, [jnp.asarray(p) for p in params], jnp.asarray(x))
    got = _port_value_and_grad(port_fn, params, x)
    np.testing.assert_allclose(got[0], want[0], **VALUE_TOL)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    np.testing.assert_allclose(got[2], want[2], **GRAD_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_a_skip_connection_rides_two_hops(remat):
    """Slot 0's projection ``s`` is read by slot 3: it rides hops 0-1 and
    1-2 beside each slot's own output (a bundle of two tensors; the JAX
    package packs the same bundle into one flat payload)."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:WORLD]), ("pipe",))
    shapes = dict(w0=(16, 32), ws=(16, 4), w1=(32, 8), w2=(8, 4))
    params = {n: (np.random.default_rng(i).standard_normal(d) * 0.2).astype(np.float32)
              for i, (n, d) in enumerate(shapes.items())}
    x = np.random.default_rng(5).standard_normal((8, 16)).astype(np.float32)
    names = list(shapes)

    jfns = [
        lambda p, h, mi: jnp.concatenate([jnp.tanh(h @ p[0]), h @ p[1]], 1),
        lambda p, h, mi: jnp.concatenate([jnp.tanh(h[:, :32] @ p[2]), h[:, 32:]], 1),
        lambda p, h, mi: jnp.concatenate([jnp.tanh(h[:, :8] @ p[3]), h[:, 8:]], 1),
        lambda p, h, mi: h[:, :4] * h[:, 4:] + h[:, :4],
    ]

    def jax_fn(p, x_):
        return pipeline_graph_apply(jfns, p, x_, mesh, "pipe", 4,
                                    [(16,), (36,), (12,), (8,)], [(36,), (12,), (8,), (4,)],
                                    remat=remat)

    tfns = [
        lambda p, hs, mi: [torch.tanh(hs[0] @ p["w0"]), hs[0] @ p["ws"]],
        lambda p, hs, mi: [torch.tanh(hs[0] @ p["w1"]), hs[1]],
        lambda p, hs, mi: [torch.tanh(hs[0] @ p["w2"]), hs[1]],
        lambda p, hs, mi: [hs[0] * hs[1] + hs[0]],
    ]
    f32 = torch.float32
    specs = [[Spec((32,), f32), Spec((4,), f32)], [Spec((8,), f32), Spec((4,), f32)],
             [Spec((4,), f32), Spec((4,), f32)], [Spec((4,), f32)]]

    def port_fn(ps, xt):
        y, = gpipe(tfns, dict(zip(names, ps)), [xt], 4, specs, remat=remat)
        return y

    plist = [params[n] for n in names]
    want = _jax_value_and_grad(jax_fn, [jnp.asarray(p) for p in plist], jnp.asarray(x))
    got = _port_value_and_grad(port_fn, plist, x)
    np.testing.assert_allclose(got[0], want[0], **VALUE_TOL)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    np.testing.assert_allclose(got[2], want[2], **GRAD_TOL)


# ---------------------------------------------------------------- one device

def _build_mlp(pkg, m, inp):
    relu = pkg.ActiMode.RELU
    t = m.dense(inp, 32, activation=relu, name="fc1")
    t = m.dense(t, 48, activation=relu, name="fc2")
    t = m.dense(t, 24, activation=relu, name="fc3")
    t = m.dense(t, 10, name="fc4")
    return m.softmax(t, name="sm")


def _mlp_data():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((BATCH, 16), dtype=np.float32),
            rng.integers(0, 10, size=(BATCH, 1), dtype=np.int32))


def _jax_mlp(pipeline_kw, devices, steps=STEPS):
    m = ff.FFModel(ff.FFConfig(batch_size=BATCH, workers_per_node=devices))
    inp = m.create_tensor((BATCH, 16), nchw=False)
    _build_mlp(ff, m, inp)
    if pipeline_kw:
        m.set_pipeline(**pipeline_kw)
    m.compile(ff.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", ["accuracy"],
              machine=ff.Machine(devices=jax.devices()[:devices]))
    m.init_layers(seed=5)
    params0 = jax_params_to_numpy(m)
    x, y = _mlp_data()
    losses = []
    for _ in range(steps):
        m.set_batch({inp: x}, y)
        m.train_iteration()
        m.get_metrics()
        losses.append(m.last_loss)
    return params0, m, losses


def test_stages_out_of_order_raise_in_both_packages():
    for pkg, extra in ((ff, dict(workers_per_node=1)), (ft, dict(device="cpu"))):
        m = pkg.FFModel(pkg.FFConfig(batch_size=8, **extra))
        inp = m.create_tensor((8, 16), nchw=False)
        t1 = m.dense(inp, 16, name="fc1")
        t2 = m.dense(t1, 16, name="fc2")
        m.add(t1, t2, name="skip")
        m.set_pipeline(stages=[["fc1"], ["skip"], ["fc2"]])
        kw = dict(machine=ff.Machine(devices=jax.devices()[:1])) if pkg is ff else {}
        with pytest.raises(ValueError, match="contiguous|topological"):
            m.compile(pkg.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy",
                      ["accuracy"], **kw)
    m = ft.FFModel(ft.FFConfig(batch_size=8, device="cpu"))
    with pytest.raises(ValueError, match="num_stages"):
        m.set_pipeline()


def test_single_device_fallback_trains_as_the_jax_package(capsys):
    """On one device a plan commits to no ring: the ops keep their own
    configs and train as built, as the JAX package's fallback does."""
    params0, jm, losses = _jax_mlp(dict(num_stages=4), devices=1)
    assert jm._pipeline_plan is None
    m = ft.FFModel(ft.FFConfig(batch_size=BATCH, device="cpu"))
    inp = m.create_tensor((BATCH, 16), nchw=False)
    _build_mlp(ft, m, inp)
    m.set_pipeline(num_stages=4)
    m.compile(ft.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", ["accuracy"])
    assert m._pipeline_plan is None and capsys.readouterr().out == ""
    m.init_layers(seed=0)
    load_jax_params(m, params0)
    x, y = _mlp_data()
    got = []
    for _ in range(STEPS):
        m.set_batch({inp: x}, y)
        m.train_iteration()
        m.get_metrics()
        got.append(m.last_loss)
    np.testing.assert_allclose(got, losses, **PIPE_TOL)
    for op in jm.ops:
        for w in op.weights:
            np.testing.assert_allclose(m.get_parameter(op.name, w.name),
                                       jm.get_parameter(op.name, w.name), **PIPE_TOL)


def test_generate_on_a_pipelined_model_matches_the_unpipelined_jax_model():
    """tests/test_pipeline.py:404's graph: the pipelined port model decodes
    its ops in order and emits the JAX package's unpipelined tokens."""
    B, S, V = 8, 8, 30

    def build(pkg, m):
        tok = m.create_tensor((B, S), name="tokens", dtype="int32", nchw=False)
        x = m.embedding(tok, V, 16, aggr="none", name="embed")
        for i in (1, 2, 3):
            x = m.dense(x, 32, activation=pkg.ActiMode.RELU, name=f"mlp{i}")
        x = m.dense(x, V, name="head")
        m.softmax(x, name="sm")

    jm = ff.FFModel(ff.FFConfig(batch_size=B, workers_per_node=1))
    build(ff, jm)
    jm.compile(ff.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", ["accuracy"],
               machine=ff.Machine(devices=jax.devices()[:1]))
    jm.init_layers(seed=5)
    m = ft.FFModel(ft.FFConfig(batch_size=B, device="cpu"))
    build(ft, m)
    m.set_pipeline(stages=[["embed", "mlp1", "mlp2"], ["mlp3", "head"]], num_microbatches=4,
                   dp_degree=2)
    m.compile(ft.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=0)
    load_jax_params(m, jax_params_to_numpy(jm))
    prompt = np.random.default_rng(1).integers(0, V, size=(B, 3)).astype(np.int32)
    np.testing.assert_array_equal(m.generate(prompt, 3), jm.generate(prompt, 3))


def _pmlp(pkg, **extra):
    m = pkg.FFModel(pkg.FFConfig(batch_size=BATCH, **extra))
    inp = m.create_tensor((BATCH, 8), nchw=False)
    t = m.pipeline_mlp(inp, num_stages=4, num_microbatches=4, name="pipe")
    t = m.dense(t, 5, name="head")
    m.softmax(t, name="sm")
    return m, inp


def _pmlp_data():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((BATCH, 8), dtype=np.float32),
            rng.integers(0, 5, size=(BATCH, 1), dtype=np.int32))


def _jax_pmlp():
    jm, jinp = _pmlp(ff, workers_per_node=1)
    jm.compile(ff.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", ["accuracy"],
               machine=ff.Machine(devices=jax.devices()[:1]))
    jm.init_layers(seed=11)
    params0 = jax_params_to_numpy(jm)
    x, y = _pmlp_data()
    for _ in range(STEPS):
        jm.set_batch({jinp: x}, y)
        jm.train_iteration()
    return params0, jm


def test_pipeline_mlp_matches_jax_on_one_device():
    params0, jm = _jax_pmlp()
    m, inp = _pmlp(ft, device="cpu")
    m.compile(ft.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=0)
    load_jax_params(m, params0)
    x, y = _pmlp_data()
    for _ in range(STEPS):
        m.set_batch({inp: x}, y)
        m.train_iteration()
    for name in ("kernel", "bias"):
        np.testing.assert_allclose(m.get_parameter("pipe", name), jm.get_parameter("pipe", name),
                                   **PIPE_TOL)


def test_pipeline_mlp_legal_degrees_match_jax():
    """Config dim 1 is the pipeline degree: legalized against num_stages
    (not the feature width) in both packages, and every search candidate
    is legal."""
    import random

    from flexflow_tpu.simulator.search import random_parallel_config as jax_random_pc
    from flexflow_tpu_torch.simulator.search import random_parallel_config

    for stages in (3, 4):
        jm = ff.FFModel(ff.FFConfig(batch_size=16))
        jm.pipeline_mlp(jm.create_tensor((16, 8), nchw=False), num_stages=stages, name="pipe")
        m = ft.FFModel(ft.FFConfig(batch_size=16, device="cpu"))
        m.pipeline_mlp(m.create_tensor((16, 8), nchw=False), num_stages=stages, name="pipe")
        for dims in ((1, 8), (2, 6), (4, 2), (16, 3)):
            assert m.ops[0].legalize_pc(ft.ParallelConfig(dims=dims)).dims == \
                jm.ops[0].legalize_pc(ff.ParallelConfig(dims=dims)).dims
        rng, jrng = random.Random(0), random.Random(0)
        for _ in range(50):
            pc = m.ops[0].legalize_pc(random_parallel_config(m.ops[0], 8, rng))
            jpc = jm.ops[0].legalize_pc(jax_random_pc(jm.ops[0], 8, jrng))
            assert stages % pc.dims[1] == 0 and pc.dims == jpc.dims


def _search_models(nd):
    def build(pkg, m):
        inp = m.create_tensor((64, 256), nchw=False)
        t = inp
        for i in range(6):
            t = m.dense(t, 256, activation=pkg.ActiMode.RELU, name=f"fc{i}")
        t = m.dense(t, 10, name="out")
        m.softmax(t, name="sm")

    jm = ff.FFModel(ff.FFConfig(batch_size=64, workers_per_node=nd))
    pm = ft.FFModel(ft.FFConfig(batch_size=64, workers_per_node=nd, device="cpu"))
    build(ff, jm)
    build(ft, pm)
    return jm, pm


@pytest.mark.parametrize("nd", [4, 8])
def test_search_pipeline_returns_the_jax_plan_on_the_same_costs(nd, tmp_path, monkeypatch):
    mm, jc, pmm, pc = cost_pair(nd, tmp_path)
    monkeypatch.setattr(jax_pipeline_search, "CostModel", lambda *a, **k: jc)
    jm, pm = _search_models(nd)
    want = jax_pipeline_search.search_pipeline(jm, machine_model=mm)
    got = pipeline_search.search_pipeline(pm, machine_model=pmm, cost_model=pc)
    assert want is not None and got == want


def test_suggest_parallelization_picks_the_faster_space(tmp_path):
    """Both spaces searched on the same costs: the dimension search's and
    the pipeline grid's simulated times, and the faster one returned."""
    _, _, pmm, _ = cost_pair(8, tmp_path)
    _, pm = _search_models(8)
    out = pipeline_search.suggest_parallelization(pm, budget=50, machine_model=pmm,
                                                  engine="mcmc")
    alt = out["alternatives"]
    plan = pipeline_search.search_pipeline(pm, machine_model=pmm)
    assert alt["pipeline_s"] == plan["simulated_s"]
    assert out["kind"] == ("pipeline" if alt["pipeline_s"] < alt["dims_s"] else "dims")
    assert out["simulated_s"] == min(alt["dims_s"], alt["pipeline_s"])
    with pytest.raises(NotImplementedError, match="ROADMAP A8b"):
        pipeline_search.suggest_parallelization(pm, budget=5, machine_model=pmm, engine="native")


def test_compile_applies_the_searched_plan(monkeypatch):
    plan = {"num_stages": 2, "dp_degree": 1, "num_microbatches": 4, "remat": True,
            "simulated_s": 1e-9, "mem_bytes": 0}
    monkeypatch.setattr(pipeline_search, "search_pipeline", lambda model, **kw: dict(plan))
    m = ft.FFModel(ft.FFConfig(batch_size=BATCH, device="cpu", search_budget=20,
                               search_pipeline=True))
    inp = m.create_tensor((BATCH, 16), nchw=False)
    _build_mlp(ft, m, inp)
    m.compile(ft.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", ["accuracy"])
    assert m._pipeline_req == {"num_stages": 2, "names": None, "num_microbatches": 4,
                               "degree": None, "dp_degree": 1, "remat": True}
    m.init_layers(seed=0)
    x, y = _mlp_data()
    m.set_batch({inp: x}, y)
    m.train_iteration()
    assert m.get_metrics().train_all == BATCH


# ---------------------------------------------------------------- 4 gloo ranks

_PIPE = _PRELUDE + r"""
import contextlib, io
x, y = np.load(job["data"])["x"], np.load(job["data"])["y"]
px, py = np.load(job["data"])["px"], np.load(job["data"])["py"]


def mlp(m, inp, skip=False):
    t = m.dense(inp, 32, activation="relu", name="fc1")
    t = m.dense(t, 48, activation="relu", name="fc2")
    t = m.dense(t, 24, activation="relu", name="fc3")
    t = m.dense(t, 10, name="fc4")
    m.softmax(t, name="sm")


def skip_model(m, inp):
    t1 = m.dense(inp, 16, name="fc1")
    t2 = m.dense(t1, 16, name="fc2")
    t3 = m.dense(t2, 16, name="fc3")
    m.add(t1, t3, name="skip")


def train(m, inp, xs, ys, params, steps):
    m.init_layers(seed=9)
    load_jax_params(m, params)
    losses = []
    for _ in range(steps):
        m.set_batch({inp: xs}, ys)
        m.train_iteration()
        m.get_metrics()
        losses.append(m.last_loss)
    return dict(losses=losses, weights={(op.name, w.name): m.get_parameter(op.name, w.name)
                                        for op in m.ops for w in op.weights})


for name, run in job["runs"].items():
    cfg = ft.FFConfig(batch_size=16, device="cpu", fused_optimizer=True,
                      strategies={k: ft.ParallelConfig(dims=tuple(v))
                                  for k, v in run.get("strategies", {}).items()},
                      search_budget=run.get("budget", 0),
                      search_pipeline=bool(run.get("budget")))
    m = ft.FFModel(cfg)
    if run["model"] == "pmlp":
        inp = m.create_tensor((16, 8), nchw=False)
        t = m.pipeline_mlp(inp, num_stages=4, num_microbatches=4, name="pipe")
        m.softmax(m.dense(t, 5, name="head"), name="sm")
        xs, ys = px, py
    elif run["model"] == "bn":
        inp = m.create_tensor((16, 16), nchw=False)
        t = m.batch_norm(m.dense(inp, 16, name="fc1"), name="bn")
        m.softmax(m.dense(t, 10, name="fc2"), name="sm")
    elif run["model"] == "skip":
        inp = m.create_tensor((16, 16), nchw=False)
        skip_model(m, inp)
        xs, ys = x, x[:, :16].copy()
    else:
        inp = m.create_tensor((16, 16), nchw=False)
        mlp(m, inp)
        xs, ys = x, y
    if run.get("pipeline"):
        m.set_pipeline(**run["pipeline"])
    loss = run.get("loss", "sparse_categorical_crossentropy")
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            m.compile(ft.SGDOptimizer(m, lr=0.05), loss, ["accuracy"] if "sparse" in loss
                      else ["mean_squared_error"])
    except ValueError as e:
        out[name] = dict(error=str(e))
        continue
    plan = m._pipeline_plan
    out[name] = dict(
        printed=printed.getvalue(),
        plan=None if plan is None else dict(
            degree=plan["degree"], dp=plan["dp_degree"],
            stages=[[o.name for o in g] for g in plan["stages"]],
            hops=[[t.guid for t in h] for h in plan["boundaries"]],
            packed=sorted(plan["pack"]["entries"]) if plan["pack"] else []),
        req=m._pipeline_req)
    out[name].update(train(m, inp, xs, ys, params0[run["model"]], job["steps"]))
    if plan is not None and plan["pack"]:
        out[name]["plan"]["local"] = tuple(m._params["_pipe"]["buffer"].to_local().shape)
    if run["model"] == "pmlp":
        out[name]["pipe_local"] = tuple(m._params["pipe"]["kernel"].to_local().shape)
np.save(job["out"] % rank, out, allow_pickle=True)
dist.shutdown()
"""

RUNS = {
    "pp4": dict(model="mlp", pipeline=dict(num_stages=4, num_microbatches=4)),
    "pp4_remat": dict(model="mlp", pipeline=dict(num_stages=4, num_microbatches=8, remat=True)),
    "dp2xpp2": dict(model="mlp", pipeline=dict(num_stages=4, num_microbatches=4, dp_degree=2)),
    "explicit": dict(model="mlp", pipeline=dict(stages=[["fc1", "fc2"], ["fc3", "fc4"]],
                                                num_microbatches=4)),
    "ring3": dict(model="mlp", pipeline=dict(num_stages=3)),
    "skip": dict(model="skip", loss="mean_squared_error",
                 pipeline=dict(stages=[["fc1"], ["fc2"], ["fc3"], ["skip"]])),
    "pmlp4": dict(model="pmlp", strategies={"pipe": (1, 4), "head": (1, 1)}),
    "pmlp2x2": dict(model="pmlp", strategies={"pipe": (2, 2), "head": (2, 1)}),
    "bn": dict(model="bn", pipeline=dict(num_stages=2)),
    "search": dict(model="mlp", budget=30),
}


def _jax_skip(pipelined):
    m = ff.FFModel(ff.FFConfig(batch_size=BATCH, workers_per_node=WORLD if pipelined else 1))
    inp = m.create_tensor((BATCH, 16), nchw=False)
    t1 = m.dense(inp, 16, name="fc1")
    t2 = m.dense(t1, 16, name="fc2")
    t3 = m.dense(t2, 16, name="fc3")
    m.add(t1, t3, name="skip")
    if pipelined:
        m.set_pipeline(stages=[["fc1"], ["fc2"], ["fc3"], ["skip"]])
    m.compile(ff.SGDOptimizer(lr=0.05), "mean_squared_error", ["mean_squared_error"],
              machine=ff.Machine(devices=jax.devices()[:WORLD if pipelined else 1]))
    m.init_layers(seed=5)
    params0 = jax_params_to_numpy(m)
    x, _ = _mlp_data()
    losses = []
    for _ in range(STEPS):
        m.set_batch({inp: x}, x[:, :16].copy())
        m.train_iteration()
        m.get_metrics()
        losses.append(m.last_loss)
    return params0, m, losses


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe4")
    x, y = _mlp_data()
    px, py = _pmlp_data()
    np.savez(tmp / "data.npz", x=x, y=y, px=px, py=py)
    mlp0, jm, losses = _jax_mlp(dict(num_stages=4, num_microbatches=4), devices=WORLD)
    assert jm._pipeline_plan is not None and jm._pipeline_plan["degree"] == WORLD
    skip0, jskip, skip_losses = _jax_skip(True)
    pmlp0, jpmlp = _jax_pmlp()
    params0 = {"mlp": mlp0, "skip": skip0, "pmlp": pmlp0, "bn": {}}
    ranks = _launch(tmp, _PIPE, WORLD, params0, data=str(tmp / "data.npz"), runs=RUNS,
                    steps=STEPS)
    return dict(ranks=ranks, mlp=(jm, losses), skip=(jskip, skip_losses), pmlp=jpmlp)


@pytest.mark.parametrize("name", ["pp4", "pp4_remat", "dp2xpp2", "explicit", "search"])
def test_set_pipeline_on_four_ranks_matches_the_jax_pipeline(job, name):
    jm, losses = job["mlp"]
    for out in job["ranks"]:
        got = out[name]
        np.testing.assert_allclose(got["losses"], losses, **PIPE_TOL)
        for op in jm.ops:
            for w in op.weights:
                np.testing.assert_allclose(got["weights"][(op.name, w.name)],
                                           jm.get_parameter(op.name, w.name), **PIPE_TOL)


def test_the_plans_on_four_ranks(job):
    ranks = job["ranks"]
    r0 = ranks[0]
    assert r0["pp4"]["plan"]["degree"] == 4 and r0["pp4"]["plan"]["dp"] == 1
    assert r0["pp4"]["plan"]["stages"] == [["fc1"], ["fc2"], ["fc3"], ["fc4"]]
    # each rank holds one slot's row of the pipe buffer: its own weights
    assert r0["pp4"]["plan"]["packed"] == ["fc1", "fc2", "fc3", "fc4"]
    assert r0["pp4"]["plan"]["local"] == (1, 32 * 48 + 48)  # the widest slot, fc2
    # a ring of 4 does not factor over a (2, 2) mesh beside dp 2: 2 slots of
    # two stages each, dp 2
    assert (r0["dp2xpp2"]["plan"]["degree"], r0["dp2xpp2"]["plan"]["dp"]) == (2, 2)
    assert r0["explicit"]["plan"]["stages"] == [["fc1", "fc2"], ["fc3", "fc4"]]
    # a ring of 3 cannot be expressed: the JAX package's message, no plan
    assert r0["ring3"]["plan"] is None
    assert "not expressible over mesh {'m0': 2, 'm1': 2}; running without pipelining" in \
        r0["ring3"]["printed"]
    assert all(out["bn"]["error"].startswith("pipeline: op bn carries running stats")
               for out in ranks)
    # fc1's output rides hops 0-1 and 1-2 to the skip add
    skip = r0["skip"]["plan"]
    assert skip["degree"] == 4 and len(skip["hops"][1]) == 2 and len(skip["hops"][2]) == 2


def test_ring3_falls_back_to_the_ops_own_configs(job):
    jm, losses = job["mlp"]
    for out in job["ranks"]:
        np.testing.assert_allclose(out["ring3"]["losses"], losses, **PIPE_TOL)


def test_skip_connection_on_four_ranks_matches_jax(job):
    jm, losses = job["skip"]
    for out in job["ranks"]:
        np.testing.assert_allclose(out["skip"]["losses"], losses, **PIPE_TOL)
        for op in jm.ops:
            for w in op.weights:
                np.testing.assert_allclose(out["skip"]["weights"][(op.name, w.name)],
                                           jm.get_parameter(op.name, w.name), **PIPE_TOL)


@pytest.mark.parametrize("name,local", [("pmlp4", (1, 8, 8)), ("pmlp2x2", (2, 8, 8))])
def test_pipeline_mlp_on_four_ranks_matches_jax(job, name, local):
    jm = job["pmlp"]
    for out in job["ranks"]:
        assert out[name]["pipe_local"] == local  # this rank's stages only
        for wn in ("kernel", "bias"):
            np.testing.assert_allclose(out[name]["weights"][("pipe", wn)],
                                       jm.get_parameter("pipe", wn), **PIPE_TOL)
