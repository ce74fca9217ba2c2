"""The JAX package's whole SOAP space in the port, on 4 gloo ranks.

Every split the JAX package's search proposes now runs in the port: a
conv's or a pool's height and width (each part computes its tile from its
input rectangle, the halo from the parts that own it), the LSTM's hidden
dim (gate-blocked weights, one h all-gather a step), the experts of an
ExpertMLP (the tokens replicated, the combine summed), host placement in
the search (tests/test_torch_search.py, tests/test_torch_simulator.py),
ZeRO-1 and the hybrid nodes x devices mesh.  tests/test_torch_soap_parts.py
holds the splits' parts in lockstep against the JAX ops; here ONE job of 4
gloo ranks (tests/test_torch_soap.py's harness) on a (2, 2) mesh runs:

* each op under a strategy on DTensors, outputs and every input and
  weight gradient against the JAX op on the same numpy weights and inputs
  (conv/pool H 4, W 4, H 2 x W 2 on uneven input shards, the LSTM split 2
  and 4 and batch 2 x hidden 2, with and without state, with
  ``share_with`` at the owner's degree and at another, ExpertMLP ep 2, 4
  and dp 2 x ep 2 at a capacity factor that drops tokens), each conv
  part's input its ``input_ranges`` rectangle;
* models trained 3 steps against the JAX package on one device: NMT with
  its LSTMs split 4 on the hidden dim and batch 2 x hidden 2, the MoE
  transformer at ep 4 and dp 2 x ep 2, ZeRO-1 (SGD momentum and Adam: 1/4
  of each state leaf on each rank, still split after the steps, an
  ``.npz`` the JAX package loads, a ``recompile`` onto 2 ranks that trains
  on alike; the state bytes each rank holds are the memory model's) and
  a (2, 2) hybrid mesh (``num_nodes=2``; a split of no batch stays on a
  node).

Tolerances are the reference tests': the LSTM's rtol 2e-4, atol 2e-5
(tests/test_nmt_tp.py), the MoE's rtol 1e-4, atol 1e-5
(tests/test_moe.py), the rest rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest

import jax

import flexflow_tpu as ff
from flexflow_tpu_torch.convert import jax_params_to_numpy
import flexflow_tpu_torch as ft

from test_torch_soap import _PRELUDE, ZOO_MOE, ZOO_NMT, ZOO_STEPS, _jax_zoo, _launch
from test_torch_soap_parts import (LSTM_TOL, MOE_TOL, SPLITS, TOL, WINDOWS, _assert_case,
                                   _case, _jax_vjp, _lstm_model, _moe_model, _window_model)

# ------------------------------------------------------------ 4 gloo ranks

# one-op cases on DTensors: (kind, its argument, strategies)
OP_CASES = {
    **{f"{w}_{'h%dw%d' % s}": ("window", w, {"op": (1, *s, 1)})
       for w in sorted(WINDOWS) for s in SPLITS},
    "lstm_h2": ("lstm", False, {"lstm": (1, 1, 2)}),
    "lstm_h4_state": ("lstm", True, {"lstm": (1, 1, 4)}),
    "lstm_b2h2_state": ("lstm", True, {"lstm": (2, 1, 2)}),
    "lstm_share_h2": ("lstm_share", False, {"lstm": (1, 1, 2), "lstm_b": (1, 1, 2)}),
    "lstm_share_h4_h2": ("lstm_share", False, {"lstm": (1, 1, 4), "lstm_b": (2, 1, 2)}),
    "moe_ep2": ("moe", None, {"moe": (1, 2, 1)}),
    "moe_ep4": ("moe", None, {"moe": (1, 4, 1)}),
    "moe_dp2_ep2": ("moe", None, {"moe": (2, 2, 1)}),
}

_SPACE = _PRELUDE + r"""
import contextlib, io
from torch.distributed.tensor import DTensor, Shard
import flexflow_tpu_torch.ops.conv2d as c2
from flexflow_tpu_torch.parallel.distributed import hybrid_machine
from flexflow_tpu_torch.parallel.mesh import Machine

WINDOWS = job["windows"]

def build(kind, arg, strategies, zero=False, opt=None, nodes=1):
    cfg = ft.FFConfig(device="cpu", compute_dtype="float32", fused_optimizer=True,
                      zero_optimizer=zero, num_nodes=nodes,
                      strategies={k: ft.ParallelConfig(dims=tuple(v))
                                  for k, v in strategies.items()})
    if kind == "window":
        dims, a = WINDOWS[arg]
        cfg.batch_size = dims[0]
        m = ft.FFModel(cfg)
        x = m.create_tensor((dims[0], dims[3], dims[1], dims[2]))
        if a[0] == "conv":
            m.conv2d(x, a[1], a[2], a[2], a[3], a[3], a[4], a[4], activation="relu", name="op")
        else:
            m.pool2d(x, a[1], a[1], a[2], a[2], a[3], a[3], pool_type=a[0], name="op")
    elif kind in ("lstm", "lstm_share"):
        cfg.batch_size = 4
        m = ft.FFModel(cfg)
        x = m.create_tensor((4, 5, 8), nchw=False)
        hx = cx = None
        if arg:
            hx, cx = m.create_tensor((4, 8), nchw=False), m.create_tensor((4, 8), nchw=False)
        y, _, _ = m.lstm(x, 8, hx=hx, cx=cx, name="lstm")
        if kind == "lstm_share":
            m.lstm(y, 8, share_with=m.ops[0], name="lstm_b")
    elif kind == "moe":
        cfg.batch_size = 4
        m = ft.FFModel(cfg)
        m.expert_mlp(m.create_tensor((4, 6, 8), nchw=False), 4, 16, capacity_factor=0.5,
                     name="moe")
    else:  # the MLP of ZeRO-1 and the hybrid mesh
        cfg.batch_size = 16
        m = ft.FFModel(cfg)
        inp = m.create_tensor((16, 8), nchw=False)
        t = m.dense(inp, 16, activation="relu", name="fc1")
        t = m.dense(t, 4, name="fc2")
        m.softmax(t)
    m.compile(opt or ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    return m

out["ops"] = {}
rects = []
tile = c2.Conv2D._tile
c2.Conv2D._tile = lambda self, p, x, pads: (rects.append(tuple(x.shape[1:3])),
                                            tile(self, p, x, pads))[1]
for name, (kind, arg, strategies) in job["op_cases"].items():
    case = params0["cases"][name]
    m = build(kind, arg, strategies)
    m.init_layers(seed=0)
    load_jax_params(m, case["weights"])
    mach = m.machine
    xs = [mach.distribute(torch.tensor(a), mach.replicated()).requires_grad_(True)
          for a in case["inputs"]]
    rects.clear()
    env = m._run_graph(m._params, {f"in_{t.guid}": x for t, x in zip(m.input_tensors, xs)},
                       True)
    outs = [env[t.guid] for op in m.ops for t in op.outputs]
    loss = sum((o.full_tensor() * torch.tensor(c)).sum() for o, c in zip(outs, case["cots"]))
    loss.backward()
    gp = {}
    for opn, ws in m._params.items():
        for wn, w in ws.items():
            gp[(opn, wn)] = m._op_named(opn).stored(wn, w.grad.full_tensor(),
                                                    inverse=True).numpy()
    out["ops"][name] = dict(
        outs=[o.full_tensor().detach().numpy() for o in outs],
        gx=[x.grad.full_tensor().numpy() for x in xs], gp=gp, rects=list(rects),
        part={op.name: [mach.split_of(mach.spec_for_config(op.pc, 4), d)[2] for d in (1, 2)]
              for op in m.ops if op._type == "Conv2D"},
        pcs={op.name: op.pc.dims for op in m.ops},
        placements={o: {n: str(w.placements) for n, w in ws.items()}
                    for o, ws in m._params.items()})
c2.Conv2D._tile = tile

# -- NMT and the MoE transformer, 3 steps
from flexflow_tpu_torch.models.nmt import build_nmt, synthetic_batch
from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch
nmt, moe = job["nmt"], job["moe"]
out["models"] = {}
for name, run in job["model_runs"].items():
    m = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu", fused_optimizer=True,
                               strategies={k: ft.ParallelConfig(dims=tuple(v))
                                           for k, v in run["strategies"].items()}))
    if run["model"] == "nmt":
        ins = list(build_nmt(m, 4, **nmt)[:2])
        opt = ft.AdamOptimizer(m, alpha=1e-2)
        batches = [synthetic_batch(4, nmt["seq_length"], nmt["vocab_size"], seed=s)
                   for s in range(job["steps"])]
    else:
        ins = list(build_transformer(m, 4, **moe)[:2])
        opt = ft.SGDOptimizer(m, lr=0.05, momentum=0.9)
        batches = [synthetic_lm_batch(4, moe["seq_length"], moe["vocab_size"], seed=10 + s)
                   for s in range(job["steps"])]
    m.compile(opt, "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=9)
    load_jax_params(m, params0["zoo"][run["model"]])
    losses = []
    for b in batches:
        m.set_batch(dict(zip(ins, b[:2])), b[2])
        m.train_iteration()
        m.get_metrics()
        losses.append(m.last_loss)
    if name == "nmt_h4":  # the gate-blocked weights and state, saved logical
        m.save(job["npz"] % name)
    out["models"][name] = dict(
        losses=losses, pcs={op.name: op.pc.dims for op in m.ops},
        weights={(op.name, w.name): m.get_parameter(op.name, w.name)
                 for op in m.ops for w in op.weights})

# -- ZeRO-1 and the hybrid mesh: the MLP, 3 steps (then 2 on 2 ranks)
data = np.load(job["mlp_data"])
def feed(m, s):
    m.set_batch({m.input_tensors[0]: data["x%d" % s]}, data["y%d" % s])
out["zero"] = {}
for opt_name in ("sgd", "adam"):
    def make_opt():
        return (ft.SGDOptimizer(lr=0.1, momentum=0.9) if opt_name == "sgd"
                else ft.AdamOptimizer(alpha=0.01))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m = build("mlp", None, {}, zero=True, opt=make_opt())
        m.init_layers(seed=0)
    load_jax_params(m, params0["mlp"])
    for s in range(3):
        feed(m, s)
        m.train_iteration()
    slots = {s: {(o, n): (tuple(t.to_local().shape), str(t.placements))
                 for o, ws in tree.items() for n, t in ws.items()}
             for s, tree in m._opt_state.items()}
    weights3 = {(o, n): m.get_parameter(o, n) for o, n in m._weight_names()}
    state3 = {s: {(o, n): m._read_leaf(s, o, n) for o, n in m._weight_names()}
              for s in m._opt_state}
    path = job["npz"] % ("zero_" + opt_name)
    m.save(path)
    m.recompile(machine=Machine.for_ranks(m.device, [0, 1]))
    after = None
    if not m._benched:
        two = {s: {(o, n): tuple(t.to_local().shape) for o, ws in tree.items()
                   for n, t in ws.items()} for s, tree in m._opt_state.items()}
        for s in range(3, 5):
            feed(m, s)
            m.train_iteration()
        after = dict(weights={(o, n): m.get_parameter(o, n) for o, n in m._weight_names()},
                     two=two)
    else:
        for s in range(3, 5):
            feed(m, s)
            m.train_iteration()
    out["zero"][opt_name] = dict(report=buf.getvalue(), slots=slots, weights=weights3,
                                 state=state3, after=after)

# the memory model's ZeRO-1 state against the state bytes each rank holds
from flexflow_tpu_torch.simulator.machine import H100MachineModel
from flexflow_tpu_torch.simulator.memory import memory_per_device
out["zero_memory"] = {}
for split in ((1, 2), (2, 2), (4, 1)):
    with contextlib.redirect_stdout(io.StringIO()):
        m = build("mlp", None, {"fc1": split}, zero=True,
                  opt=ft.AdamOptimizer(alpha=0.01))
        m.init_layers(seed=0)
    held = sum(4 * t.to_local().numel() for tree in m._opt_state.values()
               for ws in tree.values() for t in ws.values())
    pred = memory_per_device(m, None, machine_model=H100MachineModel(num_devices=4))
    out["zero_memory"][split] = (held, pred["per_device"][0]["optimizer"])

hyb = {}
plain = hybrid_machine(1, torch.device("cpu"))
hyb["plain"] = (plain.axis_names, plain.axis_sizes)
for name, strategies in (("dp", {}), ("tp", {"fc1": (2, 2)}), ("split", {"fc1": (1, 2)})):
    m = build("mlp", None, strategies, nodes=2)
    m.init_layers(seed=0)
    load_jax_params(m, params0["mlp"])
    for s in range(3):
        feed(m, s)
        m.train_iteration()
    hyb[name] = dict(axes=(m.machine.axis_names, m.machine.axis_sizes),
                     placements={o: {n: str(w.placements) for n, w in ws.items()}
                                 for o, ws in m._params.items()},
                     weights={(o, n): m.get_parameter(o, n) for o, n in m._weight_names()})
out["hybrid"] = hyb
np.save(job["out"] % rank, out, allow_pickle=True)
dist.shutdown()
"""

MODEL_RUNS = {
    "nmt_h4": {"model": "nmt", "strategies": {f"{p}_lstm{i}": (1, 1, 4)
                                              for p in ("enc", "dec") for i in range(2)}},
    "nmt_b2h2": {"model": "nmt", "strategies": {"enc_lstm0": (2, 1, 2),
                                                "dec_lstm1": (2, 1, 2)}},
    "moe_ep4": {"model": "moe", "strategies": {"moe_0": (1, 4, 1), "moe_1": (1, 4, 1)}},
    "moe_dp2_ep2": {"model": "moe", "strategies": {"moe_0": (2, 2, 1), "moe_1": (2, 2, 1)}},
}


def _op_jax_model(kind, arg):
    if kind == "window":
        return _window_model(ff, arg), _window_model(ft, arg)
    if kind == "moe":
        return _moe_model(ff), _moe_model(ft)
    share = kind == "lstm_share"
    return _lstm_model(ff, arg, share), _lstm_model(ft, arg, share)


def _mlp(opt, steps, data, params=None):
    m = ff.FFModel(ff.FFConfig(batch_size=16, workers_per_node=1, compute_dtype="float32"))
    inp = m.create_tensor((16, 8), nchw=False)
    t = m.dense(inp, 16, activation=ff.ActiMode.RELU, name="fc1")
    t = m.dense(t, 4, name="fc2")
    m.softmax(t)
    optimizer = (ff.SGDOptimizer(lr=0.1, momentum=0.9) if opt == "sgd"
                 else ff.SGDOptimizer(lr=0.1) if opt == "plain"
                 else ff.AdamOptimizer(alpha=0.01))
    m.compile(optimizer, "sparse_categorical_crossentropy", ["accuracy"],
              machine=ff.Machine(devices=jax.devices()[:1]))
    m.init_layers(seed=0)
    params0 = jax_params_to_numpy(m)
    runs = []
    for s in steps:
        m.set_batch({inp: data[f"x{s}"]}, data[f"y{s}"])
        m.train_iteration()
        runs.append({(o, n): np.asarray(m.get_parameter(o, n))
                     for o, ws in params0.items() for n in ws})
    return params0, m, runs


@pytest.fixture(scope="module")
def space(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("space")
    cases, want = {}, {}
    for name, (kind, arg, _) in OP_CASES.items():
        jm, pm = _op_jax_model(kind, arg)
        case = _case(pm, sum(map(ord, name)))  # image inputs NHWC, as staged
        cases[name] = case
        want[name] = _jax_vjp(jm, case["weights"], case["inputs"], case["cots"])
    rng = np.random.default_rng(11)
    data = {}
    for s in range(5):
        data[f"x{s}"] = rng.standard_normal((16, 8), dtype=np.float32)
        data[f"y{s}"] = rng.integers(0, 4, size=(16, 1), dtype=np.int32)
    np.savez(tmp / "mlp.npz", **data)
    mlp = {opt: _mlp(opt, range(5), data) for opt in ("sgd", "adam", "plain")}
    zoo = {name: _jax_zoo(name) for name in ("nmt", "moe")}
    params0 = dict(cases=cases, zoo={k: v[0] for k, v in zoo.items()},
                   mlp=mlp["sgd"][0])
    ranks = _launch(tmp, _SPACE, 4, params0, op_cases=OP_CASES, windows=WINDOWS,
                    model_runs=MODEL_RUNS, nmt=ZOO_NMT, moe=ZOO_MOE, steps=ZOO_STEPS,
                    mlp_data=str(tmp / "mlp.npz"), npz=str(tmp / "%s"))
    return dict(ranks=ranks, want=want, zoo=zoo, mlp=mlp, data=data, tmp=tmp)


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_each_split_on_four_ranks_equals_the_jax_op(space, name):
    kind = OP_CASES[name][0]
    tol = LSTM_TOL if kind.startswith("lstm") else MOE_TOL if kind == "moe" else TOL
    jouts, jgx, jgp = space["want"][name]
    for r, out in enumerate(space["ranks"]):
        got = out["ops"][name]
        assert got["pcs"] == {k: tuple(v) for k, v in OP_CASES[name][2].items()}
        _assert_case((got["outs"], got["gx"], got["gp"]), (jouts, jgx, jgp), tol)
        if kind == "moe":  # the dropped tokens are the JAX package's
            np.testing.assert_array_equal(np.abs(got["outs"][0]).max(-1) > 0,
                                          np.abs(jouts[0]).max(-1) > 0)
        if name.startswith("conv"):  # the part's input is its input_ranges rectangle
            jm, pm = _op_jax_model("window", OP_CASES[name][1])
            op = pm.ops[0]
            pc = ft.ParallelConfig(dims=OP_CASES[name][2]["op"])
            ph, pw = got["part"]["op"]
            idx = ph * pc.dims[2] + pw
            assert got["rects"] == [tuple(hi - lo + 1 for lo, hi in
                                          op.input_ranges(0, pc, idx)[1:3])]
        if kind == "lstm" and OP_CASES[name][2]["lstm"][2] > 1:  # stored split on the gates
            assert got["placements"]["lstm"]["w_ih"].count("Shard(dim=1)") >= 1
        if kind == "moe":
            ep = OP_CASES[name][2]["moe"][1]
            assert got["placements"]["moe"]["w_in"].count("Shard(dim=0)") == \
                (2 if ep == 4 else 1)


@pytest.mark.parametrize("name", sorted(MODEL_RUNS))
def test_zoo_splits_train_on_four_ranks_to_the_jax_weights(space, name):
    """NMT (Adam) at the LSTM's tolerance, the MoE transformer at the MoE's."""
    _, jm, j_losses = space["zoo"][MODEL_RUNS[name]["model"]]
    tol = LSTM_TOL if MODEL_RUNS[name]["model"] == "nmt" else MOE_TOL
    for r, out in enumerate(space["ranks"]):
        got = out["models"][name]
        for k, v in MODEL_RUNS[name]["strategies"].items():
            assert got["pcs"][k] == tuple(v)
        np.testing.assert_allclose(got["losses"], j_losses, **tol)
        for (opn, wn), w in got["weights"].items():
            np.testing.assert_allclose(w, jm.get_parameter(opn, wn), **tol,
                                       err_msg=f"rank {r} {name} {opn}/{wn}")


def test_a_hidden_split_lstm_checkpoint_loads_into_the_jax_package(space):
    """NMT with every LSTM split 4 on the hidden dim saves the JAX
    package's ``.npz``: the JAX package loads it, every weight equal to
    what the port reports, and the Adam state within the LSTM tolerance
    of the JAX package's own after the same 3 steps."""
    _, jm, _ = space["zoo"]["nmt"]
    jm2 = _jax_zoo("nmt")[1]
    path = str(space["tmp"] / "nmt_h4.npz")
    jm2.load(path)
    got = space["ranks"][0]["models"]["nmt_h4"]["weights"]
    for (opn, wn), w in got.items():
        np.testing.assert_array_equal(np.asarray(jm2.get_parameter(opn, wn)), w)
    with np.load(path) as saved:
        for slot in ("m", "v"):
            for op in jm.ops:
                if op._type != "LSTM":
                    continue
                for w in op.weights:
                    want = np.asarray(jm._opt_state[slot][op.name][w.name])
                    np.testing.assert_allclose(saved[f"opt_state/{slot}/{op.name}/{w.name}"],
                                               want, **LSTM_TOL, err_msg=f"{slot} {op.name}")


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_zero_optimizer_on_four_ranks(space, opt):
    """Each state leaf holds 1/4 of its rows on each rank and stays split
    over the steps; the weights equal the JAX package's plain update; the
    checkpoint is the JAX package's whole-state ``.npz``; after a
    ``recompile`` onto 2 ranks each holds 1/2, and training goes on
    alike."""
    _, jm, runs = space["mlp"][opt]
    dims = {("fc1", "kernel"): (8, 16), ("fc1", "bias"): (16,), ("fc2", "kernel"): (16, 4),
            ("fc2", "bias"): (4,)}
    for r, out in enumerate(space["ranks"]):
        got = out["zero"][opt]
        assert "ZeRO-1 optimizer-state sharding: 4/4 weights sharded" in got["report"] or r
        for slot, leaves in got["slots"].items():
            for k, (shape, pl) in leaves.items():
                assert shape == (dims[k][0] // 4,) + dims[k][1:], (slot, k)
                assert pl == "(Shard(dim=0), Shard(dim=0))"
        for k, w in got["weights"].items():
            np.testing.assert_allclose(w, runs[2][k], **TOL, err_msg=f"rank {r} {k}")
        if r < 2:
            for slot, leaves in got["after"]["two"].items():
                for k, shape in leaves.items():
                    assert shape == (dims[k][0] // 2,) + dims[k][1:]
            for k, w in got["after"]["weights"].items():
                np.testing.assert_allclose(w, runs[4][k], **TOL, err_msg=f"rank {r} {k}")
        else:
            assert got["after"] is None  # benched
    # the JAX package loads the port's ZeRO checkpoint: its whole state
    jm2 = _mlp(opt, range(1), space["data"])[1]
    jm2.load(str(space["tmp"] / f"zero_{opt}.npz"))
    assert jm2._step_count == 3
    for (o, n), w in space["ranks"][0]["zero"][opt]["weights"].items():
        np.testing.assert_array_equal(np.asarray(jm2.get_parameter(o, n)), w)
    state = space["ranks"][0]["zero"][opt]["state"]
    with np.load(str(space["tmp"] / f"zero_{opt}.npz")) as saved:
        for slot, leaves in state.items():
            for (o, n), v in leaves.items():
                assert v.shape == dims[(o, n)]
                np.testing.assert_array_equal(saved[f"opt_state/{slot}/{o}/{n}"], v)


def test_zero_state_bytes_are_what_the_memory_model_predicts(space):
    """Under ZeRO-1 with Adam, fc1 split (1, 2), (2, 2) and (4, 1): the
    optimizer bytes each rank holds are the memory model's for device 0
    (the kernel split on its columns keeps its state over the 2 devices
    left free, the split bias keeps all of its own)."""
    for r, out in enumerate(space["ranks"]):
        for split, (held, predicted) in out["zero_memory"].items():
            assert held == predicted, (r, split)
    assert space["ranks"][0]["zero_memory"][(1, 2)][0] == \
        4 * 2 * (8 * 16 // 2 // 2 + 16 // 2 + 16 * 4 // 4 + 4 // 4)


def test_hybrid_mesh_on_four_ranks(space):
    """``num_nodes=2`` on 4 ranks: a (2, 2) mesh ``dcn`` x ``m0``, the batch
    on ``dcn`` first and any other split on ``m0``; trained equal to one
    device, data parallel, with fc1 split (2, 2) and with fc1 split (1, 2);
    one node collapses to the plain mesh."""
    runs = space["mlp"]["plain"][2]
    for r, out in enumerate(space["ranks"]):
        hyb = out["hybrid"]
        assert hyb["plain"] == (("m0", "m1"), (2, 2))
        for name in ("dp", "tp", "split"):
            assert hyb[name]["axes"] == (("dcn", "m0"), (2, 2))
            for k, w in hyb[name]["weights"].items():
                np.testing.assert_allclose(w, runs[2][k], **TOL, err_msg=f"rank {r} {name} {k}")
        # fc1 (2, 2): the batch on dcn, the kernel's columns on m0
        assert hyb["tp"]["placements"]["fc1"]["kernel"] == "(Replicate(), Shard(dim=1))"
        assert hyb["dp"]["placements"]["fc1"]["kernel"] == "(Replicate(), Replicate())"
        # fc1 (1, 2): no batch split, and the columns stay on a node (m0), not on dcn
        assert hyb["split"]["placements"]["fc1"]["kernel"] == "(Replicate(), Shard(dim=1))"
        assert hyb["split"]["placements"]["fc1"]["bias"] == "(Replicate(), Shard(dim=0))"
