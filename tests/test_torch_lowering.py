"""Whole-graph lowering in the port (``flexflow_tpu_torch/parallel/lowering.py``)
against the JAX package's (``tests/test_lowering.py``).

* The pure helpers (the hybrid mesh's shadow, the role-aware assignment,
  the spec strings, the knob's strict parse and precedence) equal the JAX
  package's outputs on the same inputs; without a ``dcn`` dim the
  assignment is the port's ``parallel/mesh.assign_axes``.  Auto lowers on
  several nodes or hosts, never on one host's ranks.
* On the CPU a lowered step (``aot_eager``) is bitwise equal to per-op
  dispatch: weights, ``eval_batch`` metrics and ``predict_batch``, for a
  dense model, a CNN with dropout and the transformer with dropout, remat
  and accumulation on one device, and on 4 gloo ranks (one job, a
  module-scoped fixture): the CNN under a hybrid strategy (a spatial
  conv/pool split, whose halo exchanges run between compiled regions),
  with dropout, on the (2, 2) hybrid mesh of ``num_nodes=2`` (auto
  lowers), and the transformer split by heads and columns with dropout,
  greedy ``generate`` through the compiled mesh decode step included;
  and the serving engine (dense and paged) on 2 ranks, its tokens equal.
  Each site compiles once a step signature (the graph counts are stated).
* One compile per step signature, through the capture ledger's
  ``compile_done`` records (FF_MEMPLANE).
* ``plan()`` and the sidecar's stamp and per-op specs equal the JAX
  package's for the same strategies.
* Inductor on the CPU within a stated tolerance, and the port's lowered
  step against the JAX package's lowered step on transplanted weights.
"""

import json
import os

import numpy as np
import pytest

import jax
import torch

import flexflow_tpu as ff
from flexflow_tpu.parallel import lowering as jlow

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
from flexflow_tpu_torch.parallel import lowering as low
from flexflow_tpu_torch.parallel import mesh as pmesh

from test_torch_soap import _PRELUDE, _launch

# the port's lowered step against the JAX package's (transplanted weights):
# the same f32 operations in another order
JAX_TOL = dict(rtol=1e-5, atol=1e-6)
# inductor on the CPU fuses and reorders the f32 sums of two SGD steps
INDUCTOR_TOL = dict(rtol=1e-5, atol=1e-6)
METRICS = ["accuracy", "sparse_categorical_crossentropy"]


class _Shadow:
    """A machine's mesh shape without a process group (what ``plan()`` and
    ``placements_for`` read)."""

    def __init__(self, names, sizes):
        self.axis_names, self.axis_sizes = tuple(names), tuple(sizes)
        self.device = torch.device("cpu")
        self.mesh = None


# ---------------------------------------------------------------- pure helpers

@pytest.mark.parametrize("n,hosts", [(16, 2), (8, 1), (12, 1), (12, 5), (1, 1), (4, 2),
                                     (32, 4)])
def test_hybrid_axis_layout_matches_the_jax_package(n, hosts):
    assert low.hybrid_axis_layout(n, hosts) == jlow.hybrid_axis_layout(n, hosts)
    if hosts > 1 and n % hosts == 0:
        sizes, names = pmesh.hybrid_mesh_shape(n, hosts)
        assert low.hybrid_axis_layout(n, hosts) == (names, sizes)


SWEEP = [(8, 1), (1, 8), (2, 4), (4, 2), (2, 2, 2), (4, 1, 2, 1), (1, 1), (8,),
         (2, 1, 2, 2), (1, 4, 2)]


@pytest.mark.parametrize("degrees", SWEEP)
def test_assign_axes_matches_the_mesh_greedy_and_the_jax_package(degrees):
    """Without a dcn dim the role-aware assignment is the port's runtime
    lowering (parallel/mesh.assign_axes), step for step."""
    names, sizes = ("m0", "m1", "m2"), (2, 2, 2)
    groups, spill = low.assign_axes(names, sizes, degrees)
    assert spill == ()
    assert [tuple(g) for g in groups] == [tuple(g) for g in pmesh.axes_for_degrees(
        names, sizes, degrees)]
    assert (groups, spill) == jlow.assign_axes(names, sizes, degrees)
    with pytest.raises(ValueError, match="not expressible"):
        low.assign_axes(names, sizes, (3,))


@pytest.mark.parametrize("degrees,roles", [
    ((16, 1), None), ((2, 8), None), ((1, 16), None), ((4, 4), None),
    ((1, 16), ("sample", "parameter")), ((2, 1, 8), ("sample", "attribute", "parameter")),
    ((1, 2, 8), None)])
def test_assign_axes_dcn_rules_match_the_jax_package(degrees, roles):
    names, sizes = low.hybrid_axis_layout(16, 2)
    got = low.assign_axes(names, sizes, degrees, roles)
    assert got == jlow.assign_axes(names, sizes, degrees, roles)
    # the same mesh dims as the runtime's lowering, in mesh-dim order
    want, spill = pmesh.assign_axes(names, sizes, degrees)
    assert [set(g) for g in got[0]] == [set(g) for g in want] and got[1] == spill


@pytest.mark.parametrize("groups", [[("m0", "m1"), (), ("m2",)], [(), ()],
                                    [("dcn",), ("m0",)], [("m0", "dcn")]])
def test_spec_string_matches_the_jax_package(groups):
    assert low.spec_string(groups) == jlow.spec_string(groups)
    assert low.spec_entries(groups) == jlow.spec_entries(groups)


@pytest.mark.parametrize("raw", ["1", "true", "ON", "yes", "0", "False", "off", "no", "",
                                 "auto", None, "banana"])
def test_lowered_env_knob_is_loud(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("FF_LOWERED", raising=False)
    else:
        monkeypatch.setenv("FF_LOWERED", raw)
    if raw == "banana":
        with pytest.raises(ValueError, match="FF_LOWERED"):
            low.lowered_from_env()
        with pytest.raises(ValueError, match="FF_LOWERED"):
            jlow.lowered_from_env()
        return
    assert low.lowered_from_env() is jlow.lowered_from_env()


def test_resolve_lowered_precedence_and_the_hosts_auto(monkeypatch):
    monkeypatch.delenv("FF_LOWERED", raising=False)
    # auto: on exactly when the run spans nodes or hosts (the JAX package's
    # process count is the hosts: one JAX process drives a host's chips)
    assert low.resolve_lowered(None, 1, 1) is False
    assert low.resolve_lowered(None, 2, 1) is True
    assert low.resolve_lowered(None, 1, 4) is True
    for args in ((None, 1, 1), (None, 2, 1), (None, 1, 4)):
        assert low.resolve_lowered(*args) is jlow.resolve_lowered(*args)
    monkeypatch.setenv("FF_LOWERED", "1")
    assert low.resolve_lowered(False, 2, 4) is False
    assert low.resolve_lowered(None, 1, 1) is True
    monkeypatch.setenv("FF_LOWERED", "0")
    assert low.resolve_lowered(True, 1, 1) is True
    assert low.resolve_lowered(None, 2, 1) is False
    with pytest.raises(ValueError, match="FFConfig.lowered"):
        low.resolve_lowered("yes", 1, 1)


def test_one_host_stays_on_per_op_dispatch(monkeypatch):
    """Without a process group (one host) auto leaves the model on per-op
    dispatch; FF_LOWERED=1 lowers it, a bad value raises at compile."""
    from flexflow_tpu_torch.parallel.distributed import host_count

    monkeypatch.delenv("FF_LOWERED", raising=False)
    assert host_count() == 1
    m, _ = _dense()
    assert m._lowering is None
    monkeypatch.setenv("FF_LOWERED", "1")
    m, _ = _dense()
    assert m._lowering is not None and m._lowering.backend == "aot_eager"
    monkeypatch.setenv("FF_LOWERED", "banana")
    with pytest.raises(ValueError, match="FF_LOWERED"):
        _dense()


def test_the_module_imports_no_torch_at_its_top():
    """The simulator and the sidecars import the pure helpers: torch is
    imported inside the functions that need it only."""
    import ast

    tree = ast.parse(open(low.__file__).read())
    top = [a.name for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))
           for a in n.names] + [n.module or "" for n in tree.body
                                if isinstance(n, ast.ImportFrom)]
    assert not any(name.split(".")[0] == "torch" for name in top), top


def test_cli_flags_set_config():
    cfg = ft.FFConfig(batch_size=8, device="cpu")
    cfg.parse_args(["--lowered"])
    assert cfg.lowered is True
    cfg.parse_args(["--no-lowered"])
    assert cfg.lowered is False


def test_placements_match_the_machines_and_the_backend_follows_the_device():
    names, sizes = ("dcn", "m0", "m1"), (2, 2, 2)
    m, _ = _dense(lowered=True)
    lw = low.GraphLowering(_Shadow(names, sizes), m.ops)
    fc1 = next(op for op in m.ops if op.name == "fc1")
    for dims in ((8, 1), (2, 4), (1, 2), (2, 2), (4, 2), (1, 8)):
        pc = ft.ParallelConfig(dims=dims)
        assert lw.placements_for(fc1, pc, 2) == pmesh.placements_for_degrees(
            names, sizes, dims, 2), dims
    assert low.default_backend(torch.device("cpu")) == "aot_eager"
    assert low.default_backend(torch.device("cuda", 0)) == "inductor"
    assert "GraphLowering(ops=3" in repr(lw) and "'dcn': 2" in repr(lw)


# ---------------------------------------------------------------- one device

def _dense(batch=16, lowered=None, **cfg):
    m = ft.FFModel(ft.FFConfig(batch_size=batch, device="cpu", lowered=lowered, **cfg))
    inp = m.create_tensor((batch, 8), nchw=False)
    t = m.dense(inp, 16, activation="relu", name="fc1")
    m.softmax(m.dense(t, 4, name="fc2"), name="sm")
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", METRICS)
    return m, inp


def _cnn_graph(m, batch, dropout=0.0):
    inp = m.create_tensor((batch, 3, 12, 12))
    t = m.conv2d(inp, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="conv1")
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = m.flat(t, name="flat1")
    t = m.dense(t, 32, activation="relu", name="fc1")
    if dropout:
        t = m.dropout(t, dropout, name="drop1")
    m.softmax(m.dense(t, 10, name="fc2"), name="softmax1")
    return inp


def _cnn(lowered, dropout=0.0, batch=8):
    m = ft.FFModel(ft.FFConfig(batch_size=batch, device="cpu", lowered=lowered))
    inp = _cnn_graph(m, batch, dropout)
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", METRICS)
    return m, inp


def _lm(lowered, dropout=0.0, remat=False, accum=1):
    from flexflow_tpu_torch.models.transformer import build_transformer

    m = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu", lowered=lowered, remat=remat,
                               grad_accum_steps=accum))
    tok, pos, _ = build_transformer(m, 4, seq_length=8, num_layers=2, embed_dim=32,
                                    num_heads=4, vocab_size=64, dropout=dropout)
    m.compile(ft.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", METRICS)
    return m, (tok, pos)


def _train(kind, lowered, steps=3, **kw):
    from flexflow_tpu_torch.models.transformer import synthetic_lm_batch

    rng = np.random.default_rng(7)
    if kind == "lm":
        m, (tok, pos) = _lm(lowered, **kw)
        toks, posa, labels = synthetic_lm_batch(4, 8, 64, seed=2)
        feed = lambda: m.set_batch({tok: toks, pos: posa}, labels)  # noqa: E731
    else:
        m, inp = _dense(lowered=lowered) if kind == "dense" else _cnn(lowered, **kw)
        shape = (16, 8) if kind == "dense" else (8, 12, 12, 3)
        x = rng.standard_normal(shape, dtype=np.float32)
        y = rng.integers(0, 4, (shape[0], 1), dtype=np.int32)
        feed = lambda: m.set_batch({inp: x}, y)  # noqa: E731
    m.init_layers(seed=3)
    for _ in range(steps):
        feed()
        m.train_iteration()
    metrics = m.eval_batch()
    return m, {k: m.get_parameter(*k) for k in m._weight_names()}, metrics, m.predict_batch()


@pytest.mark.parametrize("kind,kw", [
    ("dense", {}), ("cnn", {"dropout": 0.3}), ("lm", {"dropout": 0.1}),
    ("lm", {"dropout": 0.1, "remat": True}), ("lm", {"accum": 2})],
    ids=["dense", "cnn-dropout", "lm-dropout", "lm-dropout-remat", "lm-accum2"])
def test_lowered_step_is_bitwise_per_op_dispatch_on_one_device(kind, kw):
    _, wa, ma, pa = _train(kind, False, **kw)
    m, wb, mb, pb = _train(kind, True, **kw)
    assert m._lowering is not None and m._lowering.backend == "aot_eager"
    # one graph a site: the step's region, the eval region (eval_batch and
    # predict_batch share it)
    assert m._lowering.graphs == {"train_step": 1, "eval_step": 1}
    for k in wa:
        np.testing.assert_array_equal(wa[k], wb[k], err_msg=str(k))
    assert ma == mb
    np.testing.assert_array_equal(pa, pb)


def test_dropout_masks_are_drawn_before_the_region_in_walk_order():
    """A lowered step's masks are the ones per-op dispatch draws: the probe
    records each draw's op and shape in the op walk's order, once a batch
    signature, and the region receives them."""
    m, _, _, _ = _train("lm", True, steps=2, dropout=0.1)
    (plan,) = m._mask_plans.values()
    drops = [op.guid for op in m.ops if op.draws_random]
    assert [g for g, _, _ in plan] == drops and all(k == pytest.approx(0.9) for *_, k in plan)


def test_the_strict_dynamo_settings_hold_only_inside_a_region():
    """A region compiles under the settings that make dynamo raise rather
    than fall back to eager; the process's own settings stay as they were
    for every other torch.compile user."""
    import torch._dynamo as dynamo

    strict = low._strict_settings()
    assert strict and all(v is True for k, v in strict.items() if k.startswith("fail_on"))
    before = {k: getattr(dynamo.config, k) for k in strict}
    m, _ = _dense(lowered=True)
    seen = {}
    g = low.GraphLowering(m.machine, m.ops, backend="eager")
    g.on_compile = lambda site, s: seen.update({k: getattr(dynamo.config, k) for k in strict})
    assert torch.equal(g.compile_step(lambda x: x * 2, site="double")(torch.ones(3)),
                       torch.full((3,), 2.0))
    assert seen == strict and g.graphs == {"double": 1}
    assert {k: getattr(dynamo.config, k) for k in strict} == before


def test_recompile_builds_a_new_lowering():
    m, inp = _dense(lowered=True)
    m.init_layers(seed=0)
    first = m._lowering
    m.recompile(strategies={"fc1": ft.ParallelConfig(dims=(1, 1))})
    assert m._lowering is not None and m._lowering is not first
    m.set_batch({inp: np.ones((16, 8), np.float32)}, np.zeros((16, 1), np.int32))
    m.train_iteration()
    assert m._lowering.graphs == {"train_step": 1}


def test_lowered_single_compile_per_step(tmp_path, monkeypatch):
    """One compile per step function over repeated calls, zero retraces,
    in the capture ledger's records (the JAX package's memplane check)."""
    from flexflow_tpu_torch.observability import events

    trace = str(tmp_path / "trace.jsonl")
    monkeypatch.setenv("FF_TELEMETRY", "1")
    monkeypatch.setenv("FF_TELEMETRY_FILE", trace)
    monkeypatch.setenv("FF_MEMPLANE", "1")
    events.reset_active()
    try:
        m, inp = _dense(lowered=True)
        m.init_layers(seed=0)
        assert m._lowering is not None and m._memplane is not None
        rng = np.random.default_rng(0)
        x = rng.standard_normal((16 * 3, 8), np.float32)
        y = rng.integers(0, 4, (16 * 3, 1), dtype=np.int32)
        dl = ft.DataLoader(m, {inp: x}, y)
        for _ in range(3):
            dl.next_batch(m)
            m.train_iteration()
        m.eval_batch()
        m.eval_batch()
        m.sync()
    finally:
        events.reset_active()
    with open(trace) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    dones = [r for r in recs if r.get("name") == "compile_done"]
    per_site = {}
    for d in dones:
        per_site[d["attrs"]["site"]] = per_site.get(d["attrs"]["site"], 0) + 1
    assert per_site == {"train_step": 1, "eval_step": 1}
    assert m._memplane.retraces == 0
    assert all(d["attrs"]["retrace"] is False and d["attrs"]["stage"] == "compile"
               for d in dones)


# ---------------------------------------------------------------- introspection

HYBRID8 = {"conv1": (2, 2, 2, 1), "pool1": (2, 2, 1, 1), "flat1": (2, 1), "fc1": (2, 4),
           "fc2": (2, 1), "softmax1": (8, 1)}


def _jax_cnn(strategies, batch=16, **cfg):
    m = ff.FFModel(ff.FFConfig(batch_size=batch, strategies={
        k: ff.ParallelConfig(dims=v) for k, v in strategies.items()}, **cfg))
    inp = m.create_tensor((batch, 3, 12, 12))
    t = m.conv2d(inp, 8, 3, 3, 1, 1, 1, 1, name="conv1")
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = m.flat(t, name="flat1")
    t = m.dense(t, 32, name="fc1")
    t = m.dense(t, 10, name="fc2")
    m.softmax(t, name="softmax1")
    return m, inp


def test_plan_matches_the_jax_package(devices, tmp_path):
    """The same strategies on the same mesh shape plan the same specs and
    roles (the JAX package on its 8 virtual devices, the port on the
    shadow of an 8-GPU mesh), and neither spills."""
    jm, _ = _jax_cnn(HYBRID8, lowered=True)
    jm.compile(ff.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    want = jm._lowering.plan()
    m, _ = _cnn(True, batch=16)
    for op in m.ops:
        op.pc = op.legalize_pc(ft.ParallelConfig(dims=HYBRID8[op.name]))
    names, sizes = low.hybrid_axis_layout(8, 1)
    lw = low.GraphLowering(_Shadow(names, sizes), m.ops)
    assert lw.plan() == want
    assert lw.plan()["fc1"]["roles"] == "sp" and lw.dcn_spill == {}


def test_sidecar_stamp_and_specs_match_the_jax_package(devices, tmp_path):
    """A lowered compile stamps its sidecar with ``lowered`` and the plan;
    the per-op specs (the mesh shadow of the device count) equal the JAX
    package's sidecar rows for the same strategies (16 devices: two
    nodes, fc1 split (1, 16) spills onto dcn in both)."""
    from flexflow_tpu.observability.searchtrace import per_op_attribution as jax_rows
    from flexflow_tpu_torch.observability.searchtrace import per_op_attribution

    pb = str(tmp_path / "s.pb")
    m = ft.FFModel(ft.FFConfig(batch_size=16, device="cpu", lowered=True,
                               export_strategy_file=pb))
    inp = m.create_tensor((16, 8), nchw=False)
    t = m.dense(inp, 16, activation="relu", name="fc1")
    m.softmax(m.dense(t, 4, name="fc2"), name="sm")
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    with open(pb + ".meta.json") as f:
        meta = json.load(f)
    assert meta["lowered"] is True and meta["lowering"] == m._lowering.plan()
    assert all("spec" in row for row in meta["ops"].values())
    m2, _ = _dense()
    assert m2._lowering is None
    strategies = {"conv1": (4, 2, 1, 1), "pool1": (16, 1, 1, 1), "flat1": (2, 1),
                  "fc1": (1, 16), "fc2": (2, 8), "softmax1": (16, 1)}
    jm, _ = _jax_cnn({}, batch=16, workers_per_node=8, num_nodes=2)
    pm = ft.FFModel(ft.FFConfig(batch_size=16, device="cpu", workers_per_node=8, num_nodes=2))
    _cnn_graph(pm, 16)
    jrows = jax_rows(jm, {k: ff.ParallelConfig(dims=v) for k, v in strategies.items()})
    rows = per_op_attribution(pm, {k: ft.ParallelConfig(dims=v) for k, v in strategies.items()})
    assert {k: r["spec"] for k, r in rows.items()} == {k: r["spec"] for k, r in jrows.items()}
    assert "dcn" in rows["fc1"]["spec"]


# ---------------------------------------------------------------- backends

def test_inductor_on_the_cpu_within_tolerance():
    """The CUDA backend's compiler, run on the CPU for a tiny dense model:
    2 steps within INDUCTOR_TOL of per-op dispatch (it fuses and reorders
    f32 sums), one graph for the step."""
    _, wa, ma, _ = _train("dense", False, steps=2)
    m, inp = _dense(lowered=True)
    m._lowering = low.GraphLowering(m.machine, m.ops, backend="inductor")
    m.init_layers(seed=3)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, 8), dtype=np.float32)
    y = rng.integers(0, 4, (16, 1), dtype=np.int32)
    for _ in range(2):
        m.set_batch({inp: x}, y)
        m.train_iteration()
    for k in wa:
        np.testing.assert_allclose(m.get_parameter(*k), wa[k], **INDUCTOR_TOL, err_msg=str(k))
    assert m._lowering.graphs == {"train_step": 1}


def test_lowered_step_against_the_jax_packages_lowered_step():
    """The same CNN, its weights transplanted from the JAX package, 3 SGD
    steps lowered in both packages (one device): every weight within
    JAX_TOL, the eval metrics' counts equal."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 12, 12, 3), dtype=np.float32)
    y = rng.integers(0, 10, (8, 1), dtype=np.int32)
    jm = ff.FFModel(ff.FFConfig(batch_size=8, lowered=True, workers_per_node=1))
    inp = jm.create_tensor((8, 3, 12, 12))
    t = jm.conv2d(inp, 8, 3, 3, 1, 1, 1, 1, activation=ff.ActiMode.RELU, name="conv1")
    t = jm.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = jm.flat(t, name="flat1")
    t = jm.dense(t, 32, activation=ff.ActiMode.RELU, name="fc1")
    jm.softmax(jm.dense(t, 10, name="fc2"), name="softmax1")
    jm.compile(ff.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", METRICS,
               machine=ff.Machine(devices=jax.devices()[:1]))
    jm.init_layers(seed=3)
    assert jm._lowering is not None
    params0 = jax_params_to_numpy(jm)
    m, pinp = _cnn(True)
    m.init_layers(seed=0)
    load_jax_params(m, params0)
    for _ in range(3):
        jm.set_batch({inp: x}, y)
        jm.train_iteration()
        m.set_batch({pinp: x}, y)
        m.train_iteration()
    for op, ws in jax_params_to_numpy(jm).items():
        for wn, want in ws.items():
            np.testing.assert_allclose(m.get_parameter(op, wn), want, **JAX_TOL,
                                       err_msg=f"{op}/{wn}")
    jm.set_batch({inp: x}, y)
    m.set_batch({pinp: x}, y)
    assert m.eval_batch()["train_correct"] == jm.eval_batch()["train_correct"]


# ---------------------------------------------------------------- 4 gloo ranks

_MESH = _PRELUDE + r"""
from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch
data = np.load(job["data"])
METRICS = ["accuracy", "sparse_categorical_crossentropy"]

def cnn(strategies, lowered, nodes=1, dropout=0.0):
    cfg = ft.FFConfig(batch_size=16, device="cpu", lowered=lowered, num_nodes=nodes,
                      strategies={k: ft.ParallelConfig(dims=tuple(v))
                                  for k, v in strategies.items()})
    m = ft.FFModel(cfg)
    inp = m.create_tensor((16, 3, 12, 12))
    t = m.conv2d(inp, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="conv1")
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = m.flat(t, name="flat1")
    t = m.dense(t, 32, activation="relu", name="fc1")
    if dropout:
        t = m.dropout(t, dropout, name="drop1")
    t = m.dense(t, 10, name="fc2")
    m.softmax(t, name="softmax1")
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", METRICS)
    m.init_layers(seed=9)
    for s in range(3):
        m.set_batch({inp: data["x%d" % s]}, data["y%d" % s])
        m.train_iteration()
    m.set_batch({inp: data["x3"]}, data["y3"])
    return m, m.eval_batch(), None

def lm(strategies, lowered, dropout=0.0):
    cfg = ft.FFConfig(batch_size=4, device="cpu", lowered=lowered,
                      strategies={k: ft.ParallelConfig(dims=tuple(v))
                                  for k, v in strategies.items()})
    m = ft.FFModel(cfg)
    tok, pos, _ = build_transformer(m, 4, seq_length=8, num_layers=1, embed_dim=32,
                                    num_heads=4, vocab_size=64, dropout=dropout)
    m.compile(ft.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", METRICS)
    m.init_layers(seed=13)
    toks, posa, labels = synthetic_lm_batch(4, 8, 64, seed=2)
    for _ in range(2):
        m.set_batch({tok: toks, pos: posa}, labels)
        m.train_iteration()
    return m, m.eval_batch(), m.generate(toks[:, :4], 4)

for name, (kind, kw) in job["runs"].items():
    m, met, gen = (cnn if kind == "cnn" else lm)(**kw)
    low = m._lowering
    out[name] = dict(weights={(o, n): m.get_parameter(o, n) for o, n in m._weight_names()},
                     metrics=met, gen=gen, lowered=low is not None,
                     graphs=dict(low.graphs) if low is not None else {},
                     axes=(m.machine.axis_names, m.machine.axis_sizes))
np.save(job["out"] % rank, out, allow_pickle=True)
dist.shutdown()
"""

HYBRID4 = {"conv1": (2, 2, 1, 1), "pool1": (2, 2, 1, 1), "flat1": (2, 1), "fc1": (2, 2),
           "fc2": (2, 1), "softmax1": (4, 1)}
TP4 = {"attn_0": (2, 1, 2), "mlp_up_0": (2, 2), "mlp_down_0": (2, 1), "lm_head": (2, 1, 2),
       "softmax": (4, 1, 1)}
MESH_RUNS = {
    "hyb": ("cnn", dict(strategies=HYBRID4, lowered=False)),
    "hyb_low": ("cnn", dict(strategies=HYBRID4, lowered=True)),
    "drop": ("cnn", dict(strategies=HYBRID4, lowered=False, dropout=0.2)),
    "drop_low": ("cnn", dict(strategies=HYBRID4, lowered=True, dropout=0.2)),
    "nodes": ("cnn", dict(strategies=HYBRID4, lowered=False, nodes=2)),
    "nodes_auto": ("cnn", dict(strategies=HYBRID4, lowered=None, nodes=2)),
    "tp": ("lm", dict(strategies=TP4, lowered=False, dropout=0.1)),
    "tp_low": ("lm", dict(strategies=TP4, lowered=True, dropout=0.1)),
}


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lowering_mesh")
    rng = np.random.default_rng(0)
    data = {}
    for s in range(4):
        data["x%d" % s] = rng.standard_normal((16, 12, 12, 3), dtype=np.float32)
        data["y%d" % s] = rng.integers(0, 10, (16, 1), dtype=np.int32)
    np.savez(tmp / "data.npz", **data)
    return _launch(tmp, _MESH, 4, {}, data=str(tmp / "data.npz"),
                   runs={k: list(v) for k, v in MESH_RUNS.items()})


# the compiled regions a site made: the hybrid CNN's conv1 and pool1 split
# their rows (halo exchanges, run between regions), so its step compiles
# the run flat1..softmax1 once; the transformer's step is one region
CNN_GRAPHS = {"train_step:flat1": 1, "eval_step:flat1": 1}
LM_GRAPHS = {"train_step": 1, "eval_step": 1, "decode_step": 1}


@pytest.mark.parametrize("per_op,lowered,graphs,axes", [
    ("hyb", "hyb_low", CNN_GRAPHS, (("m0", "m1"), (2, 2))),
    ("drop", "drop_low", CNN_GRAPHS, (("m0", "m1"), (2, 2))),
    ("nodes", "nodes_auto", CNN_GRAPHS, (("dcn", "m0"), (2, 2))),
    ("tp", "tp_low", LM_GRAPHS, (("m0", "m1"), (2, 2)))])
def test_lowered_mesh_step_is_bitwise_per_op_dispatch(mesh, per_op, lowered, graphs, axes):
    """On 4 gloo ranks the lowered step equals per-op dispatch bit for bit:
    every weight on every rank, the eval metrics and the greedy tokens;
    ``num_nodes=2`` lowers by default, one host's mesh does not."""
    for r, out in enumerate(mesh):
        a, b = out[per_op], out[lowered]
        assert not a["lowered"] and b["lowered"] and b["graphs"] == graphs, (r, b["graphs"])
        assert b["axes"] == axes
        for k in a["weights"]:
            np.testing.assert_array_equal(a["weights"][k], b["weights"][k],
                                          err_msg=f"rank {r} {k}")
        assert a["metrics"] == b["metrics"]
        if a["gen"] is not None:
            np.testing.assert_array_equal(a["gen"], b["gen"])


_LEAD_ONLY = _PRELUDE + r"""
def tiny(**kw):
    m = ft.FFModel(ft.FFConfig(batch_size=8, device="cpu"))
    x = m.create_tensor((8, 16))
    m.softmax(m.dense(x, 4, name="fc"))
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"], **kw)
    return m

if rank == 0:  # the lead rank alone: no collective may run here
    m = tiny(machine=ft.Machine(devices=[torch.device("cpu")]))
    out["single"] = (m._lowering is None, m.machine.mesh is None, dist._HOSTS)
m = tiny()  # every rank: the mesh over the group
out["mesh"] = (m._lowering is None, m.machine.mesh is None, dist._HOSTS)
np.save(job["out"] % rank, out, allow_pickle=True)
dist.shutdown()
"""


def test_auto_counts_hosts_only_for_a_model_on_the_mesh(tmp_path):
    """A single-device model compiled on one rank while a group is up
    counts no hosts (the count is a collective the other ranks would not
    join); a model on the group's mesh counts them on every rank, and one
    host keeps it on per-op dispatch."""
    got = _launch(tmp_path, _LEAD_ONLY, 2, {})
    assert got[0]["single"] == (True, True, None)
    for r in got:
        assert r["mesh"] == (True, False, 1)


_ENGINE = _PRELUDE + r"""
from flexflow_tpu_torch.models.transformer import build_transformer
from flexflow_tpu_torch.serving.engine import InferenceEngine
reqs = [np.asarray(r, np.int32) for r in job["requests"]]
# A request waits in the queue while the engine compiles its step's
# signatures and decodes the requests before it (max_batch 3 of 4), and
# under a loaded host that outlasts the engine's 30 s default deadline:
# each wait may take what the rank's whole run may, the launcher's 300 s
# less the model's build.
WAIT_S = 240.0
for lowered in (False, True):
    m = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu", lowered=lowered, strategies={
        k: ft.ParallelConfig(dims=tuple(v)) for k, v in job["strategies"].items()}))
    build_transformer(m, 4, seq_length=32, num_layers=2, embed_dim=32, num_heads=4,
                      vocab_size=50)
    m.compile(ft.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=12)
    for paged in ("off", "on"):
        eng = InferenceEngine(m, paged=paged, max_batch=3, max_seq=32, kv_block=4,
                              replica_timeout_s=60.0, queue_timeout_s=WAIT_S)
        eng.start()
        got = ([h.result(WAIT_S) for h in [eng.submit(r, 5) for r in reqs]]
               if eng.is_leader else None)
        eng.stop()
        out[(lowered, paged)] = got
    out[("graphs", lowered)] = dict(m._lowering.graphs) if lowered else {}
np.save(job["out"] % rank, out, allow_pickle=True)
dist.shutdown()
"""


def test_the_engine_on_a_lowered_mesh_serves_per_op_dispatchs_tokens(tmp_path):
    """The serving engine (dense and paged KV) on 2 gloo ranks, the model
    split by heads and columns and lowered: each engine step is the
    compiled mesh decode step, one compile per step signature, and every
    request's tokens equal per-op dispatch's."""
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, 50, size=n).tolist() for n in (3, 5, 7, 9)]
    split = {f"{p}_{i}": (1, 1, 2) for i in range(2) for p in ("attn", "mlp_up", "mlp_down")}
    split["lm_head"] = (1, 1, 2)
    lead = _launch(tmp_path, _ENGINE, 2, {}, requests=reqs, strategies=split)[0]
    for paged in ("off", "on"):
        assert len(lead[(False, paged)]) == len(reqs)
        for a, b in zip(lead[(False, paged)], lead[(True, paged)]):
            np.testing.assert_array_equal(a, b)
    # one compile per step signature: the dense engine's prefill and its
    # windows over 8- and 16-position caches, the paged engine's windows
    # over 2- and 4-block tables
    assert lead[("graphs", True)] == {"decode_step": 5}
