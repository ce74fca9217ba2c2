"""The JAX package's SOAP splits as parts in lockstep, on the CPU.

The splits the port adds to its search space (tests/test_torch_search.py),
each run as its parts in lockstep in one process (``forward_tiles``,
``forward_parts``, ``halo_exchange`` and ``all_gather_dim`` with no group)
and held against the JAX op's forward and ``jax.vjp`` on the same numpy
weights and inputs: conv tiles at AlexNet's conv1 window (11x11, stride
4, padding 2) on uneven input shards, a window reaching a part that is not
a neighbour, max and avg pools, each conv part's rectangle its
``input_ranges``; the LSTM's hidden parts with and without hx/cx, and its
gate-blocked stored layout; expert and batch parts at a capacity factor
that drops tokens, the dropped set equal.  tests/test_torch_soap_space.py
runs the same splits on 4 gloo ranks.

Tolerances are the reference tests': the LSTM's rtol 2e-4, atol 2e-5
(tests/test_nmt_tp.py), the MoE's rtol 1e-4, atol 1e-5
(tests/test_moe.py), the rest rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as ff
from flexflow_tpu.ops.base import FwdCtx as JaxCtx
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.ops.base import FwdCtx
from flexflow_tpu_torch.parallel.collectives import all_gather_dim, halo_exchange
from flexflow_tpu_torch.parallel.mesh import (assign_axes, chunk_bounds, hybrid_mesh_shape,
                                              mesh_shape, placements_for_degrees)
from flexflow_tpu_torch.simulator.machine import H100MachineModel
from flexflow_tpu_torch.simulator.memory import memory_per_device, zero_share
from torch.distributed.tensor import Replicate, Shard

LSTM_TOL = dict(rtol=2e-4, atol=2e-5)
MOE_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-5)

# (kind, input NHWC dims, op arguments): AlexNet's conv1 window on 53 rows
# (12 output rows; 53 splits 14/13/13/13 over a (2, 2) mesh, 14/14/14/11 in
# one), a 7x7 window on 8 rows (part 0's tile reads part 2's rows), pools
# of ResNet's 3x3/2 padding 1 on 23 rows (12 outputs)
WINDOWS = {
    "conv11": ((2, 53, 53, 3), ("conv", 4, 11, 4, 2)),
    "conv7": ((2, 8, 8, 3), ("conv", 4, 7, 1, 3)),
    "maxpool": ((2, 23, 23, 4), ("max", 3, 2, 1)),
    "avgpool": ((2, 23, 23, 4), ("avg", 3, 2, 1)),
}
SPLITS = [(4, 1), (1, 4), (2, 2)]


def _window_model(pkg, kind):
    dims, args = WINDOWS[kind]
    extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
    m = pkg.FFModel(pkg.FFConfig(batch_size=dims[0], compute_dtype="float32", **extra))
    x = m.create_tensor((dims[0], dims[3], dims[1], dims[2]))
    if args[0] == "conv":
        _, cout, k, s, p = args
        m.conv2d(x, cout, k, k, s, s, p, p, activation="relu", name="op")
    else:
        pool, k, s, p = args
        m.pool2d(x, k, k, s, s, p, p, pool_type=pool, name="op")
    return m


def _lstm_model(pkg, state, share=False, batch=4, t=5, h=8):
    extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
    m = pkg.FFModel(pkg.FFConfig(batch_size=batch, compute_dtype="float32", **extra))
    x = m.create_tensor((batch, t, h), nchw=False)
    hx = cx = None
    if state:
        hx = m.create_tensor((batch, h), nchw=False)
        cx = m.create_tensor((batch, h), nchw=False)
    y, _, _ = m.lstm(x, h, hx=hx, cx=cx, name="lstm")
    if share:
        m.lstm(y, h, share_with=m.ops[0], name="lstm_b")
    return m


def _moe_model(pkg, batch=4, seq=6, d=8, experts=4):
    extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
    m = pkg.FFModel(pkg.FFConfig(batch_size=batch, compute_dtype="float32", **extra))
    x = m.create_tensor((batch, seq, d), nchw=False)
    m.expert_mlp(x, experts, 16, capacity_factor=0.5, name="moe")
    return m


def _params(model, seed):
    rng = np.random.default_rng(seed)
    return {op.name: {w.name: (rng.standard_normal(w.dims) * 0.5).astype(np.float32)
                      for w in op.weights} for op in model.ops if op.weights}


def _jax_vjp(model, params, inputs, cots):
    """The JAX package's ops in graph order on one device: every output and
    the gradients of sum(output * cot) over inputs and weights."""
    def f(ps, xs):
        env = {t.guid: x for t, x in zip(model.input_tensors, xs)}
        outs = []
        for op in model.ops:
            ys = op.forward(ps.get(op.share_from.name if op.share_from else op.name, {}),
                            [env[t.guid] for t in op.inputs], JaxCtx(training=True))
            for t, y in zip(op.outputs, ys):
                env[t.guid] = y
            outs += list(ys)
        return outs

    ps = jax.tree_util.tree_map(jnp.asarray, params)
    xs = [jnp.asarray(a) for a in inputs]
    outs, vjp = jax.vjp(f, ps, xs)
    gp, gx = vjp([jnp.asarray(c) for c in cots])
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return [np.asarray(o) for o in outs], as_np(gx), as_np(gp)


def _case(model, seed):
    """Weights, inputs and cotangents of a one-op case, from a seed."""
    rng = np.random.default_rng(seed + 100)
    inputs = [rng.standard_normal(t.dims).astype(np.float32) for t in model.input_tensors]
    cots = [rng.standard_normal(t.dims).astype(np.float32)
            for op in model.ops for t in op.outputs]
    return dict(weights=_params(model, seed), inputs=inputs, cots=cots)


def _port_vjp(model, params, inputs, cots, fn):
    """The port's graph as ``fn(params, xs) -> outputs`` with autograd."""
    ps = {o: {n: torch.tensor(v, dtype=torch.float64, requires_grad=True) for n, v in ws.items()}
          for o, ws in params.items()}
    xs = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in inputs]
    outs = fn(ps, xs)
    loss = sum((o * torch.tensor(c, dtype=o.dtype)).sum() for o, c in zip(outs, cots))
    leaves = xs + [v for ws in ps.values() for v in ws.values()]
    grads = torch.autograd.grad(loss, leaves)
    names = [(o, n) for o, ws in ps.items() for n in ws]
    return ([o.detach().numpy() for o in outs], [g.numpy() for g in grads[:len(xs)]],
            {k: g.numpy() for k, g in zip(names, grads[len(xs):])})


def _assert_case(got, want, tol):
    outs, gx, gp = got
    jouts, jgx, jgp = want
    for a, b in zip(outs, jouts):
        np.testing.assert_allclose(a, b, **tol)
    for a, b in zip(gx, jgx):
        np.testing.assert_allclose(a, b, **tol)
    for (o, n), g in gp.items():
        np.testing.assert_allclose(g, jgp[o][n], **tol, err_msg=f"{o}/{n}")


# ------------------------------------------------------------ lockstep, one process

def test_halo_exchange_and_all_gather_in_lockstep_equal_slicing():
    """Each part's rows, from parts that own them unevenly, are the rows of
    the whole; the gradient of a row read by two parts is the sum of both
    reads."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 29, 5, generator=gen, dtype=torch.float64, requires_grad=True)
    owned = chunk_bounds(29, [2, 2])
    assert owned == [(0, 7), (8, 14), (15, 21), (22, 28)]
    assert [hi - lo + 1 for lo, hi in owned] == \
        [c.shape[0] for c in torch.arange(29).chunk(2)[0].chunk(2)] + \
        [c.shape[0] for c in torch.arange(29).chunk(2)[1].chunk(2)]
    assert chunk_bounds(5, [4]) == [(0, 1), (2, 3), (4, 4), (5, 4)]
    need = [(0, 12), (5, 20), (13, 28), (0, 28)]  # part 3 needs every part's rows
    parts = [x.narrow(1, lo, hi - lo + 1) for lo, hi in owned]
    got = halo_exchange(parts, 1, need, owned, None)
    gen2 = torch.Generator().manual_seed(1)
    cots = [torch.randn(g.shape, generator=gen2, dtype=torch.float64) for g in got]
    for g, (lo, hi) in zip(got, need):
        torch.testing.assert_close(g, x[:, lo:hi + 1], rtol=0, atol=0)
    (gx,) = torch.autograd.grad(sum((g * c).sum() for g, c in zip(got, cots)), [x])
    want = torch.zeros_like(x)
    for c, (lo, hi) in zip(cots, need):
        want[:, lo:hi + 1] += c
    torch.testing.assert_close(gx, want, rtol=0, atol=1e-15)
    chunks = list(x.chunk(4, 2)[:2])
    torch.testing.assert_close(all_gather_dim(chunks, 2, None), x[:, :, :4], rtol=0, atol=0)


def test_hybrid_mesh_shape():
    assert hybrid_mesh_shape(16, 2) == ((2, 2, 2, 2), ("dcn", "m0", "m1", "m2"))
    assert hybrid_mesh_shape(4, 2) == ((2, 2), ("dcn", "m0"))
    assert hybrid_mesh_shape(6, 3) == ((3, 2), ("dcn", "m0"))
    assert hybrid_mesh_shape(8, 1) == mesh_shape(8) == ((2, 2, 2), ("m0", "m1", "m2"))
    assert hybrid_mesh_shape(2, 2) == ((2, 1), ("dcn", "m0"))


# degrees on two nodes of 8 -> (their mesh dims, the dims that spill onto dcn)
HYBRID_LOWERING = {
    (1, 2): ([(), ("m0",)], ()),
    (1, 1, 2): ([(), (), ("m0",)], ()),
    (2, 2): ([("dcn",), ("m0",)], ()),
    (4, 4): ([("dcn", "m0"), ("m1", "m2")], ()),
    (1, 16): ([(), ("dcn", "m0", "m1", "m2")], ((1, 2),)),
    (2, 1, 8): ([("dcn",), (), ("m0", "m1", "m2")], ()),
}


@pytest.mark.parametrize("degrees", sorted(HYBRID_LOWERING))
def test_the_hybrid_lowering_keeps_splits_on_a_node(degrees):
    """One lowering serves the runtime and the simulator: on two nodes of
    8 the batch takes ``dcn`` first, any other split takes a node's GPU
    dims and spills onto ``dcn`` only past 8; the placements follow the
    groups, and the machine model prices exactly the spill."""
    sizes, names = hybrid_mesh_shape(16, 2)
    groups, spill = HYBRID_LOWERING[degrees]
    assert assign_axes(names, sizes, degrees) == (groups, spill)
    owner = {n: i for i, g in enumerate(groups) for n in g}
    assert placements_for_degrees(names, sizes, degrees) == tuple(
        Shard(owner[n]) if n in owner else Replicate() for n in names)
    assert H100MachineModel(num_devices=16).dcn_spill(degrees) == spill


@pytest.mark.parametrize("dims,shares", [((4, 1), (4, 4)), ((1, 2), (2, 1)),
                                         ((2, 2), (2, 1)), ((1, 4), (1, 1)),
                                         ((2, 1), (4, 4))])
def test_zero_state_is_priced_as_the_runtime_shards_it(dims, shares):
    """ZeRO-1's state per device: a weight's leading dim over the devices
    its split leaves free, so a kernel split on its output columns keeps
    half its state on 4 devices and its split bias keeps all; the JAX
    package's model divides both by the batch degree instead."""
    m = ft.FFModel(ft.FFConfig(batch_size=8, workers_per_node=4, device="cpu",
                               zero_optimizer=True))
    m.dense(m.create_tensor((8, 16)), 32, name="fc")
    op, pc = m.ops[0], ft.ParallelConfig(dims=dims)
    assert tuple(zero_share(w, pc, 4) for w in op.param_weights) == shares
    got = memory_per_device(m, {"fc": pc}, machine_model=H100MachineModel(num_devices=4),
                            opt_slots=1)["per_device"][0]["optimizer"]
    tiles = [np.prod([hi - lo + 1 for lo, hi in op.weight_tile(pc, i, 0)]) for i in range(2)]
    assert got == int(sum(4.0 * t / s for t, s in zip(tiles, shares)))
    assert zero_share(op.param_weights[0], pc, 1) == 1


@pytest.mark.parametrize("kind", sorted(WINDOWS))
@pytest.mark.parametrize("split", SPLITS, ids=["h4", "w4", "h2w2"])
def test_window_tiles_in_lockstep_equal_the_jax_op(kind, split):
    """Each tile from its input rectangle (halo included, padding only at
    the image edge) equals the JAX op's output and gradients; a conv
    part's rectangle is its ``input_ranges``."""
    pm, jm = _window_model(ft, kind), _window_model(ff, kind)
    case = _case(pm, 3)
    want = _jax_vjp(jm, case["weights"], case["inputs"], case["cots"])
    op = pm.ops[0]
    rects = []

    def fn(ps, xs):
        return [op.forward_tiles(ps.get("op", {}), xs[0], *split, rects)]

    got = _port_vjp(pm, case["weights"], case["inputs"], case["cots"], fn)
    _assert_case(got, want, TOL)
    pc = ft.ParallelConfig(dims=(1, *split, 1))
    if op._type == "Conv2D":
        assert [tuple(r.shape[1:3]) for r in rects] == \
            [tuple(hi - lo + 1 for lo, hi in op.input_ranges(0, pc, i)[1:3])
             for i in range(split[0] * split[1])]


@pytest.mark.parametrize("state", [False, True], ids=["zero_state", "hx_cx"])
@pytest.mark.parametrize("k", [2, 4])
def test_lstm_hidden_parts_in_lockstep_equal_the_jax_op(k, state):
    pm, jm = _lstm_model(ft, state), _lstm_model(ff, state)
    case = _case(pm, 5)
    want = _jax_vjp(jm, case["weights"], case["inputs"], case["cots"])
    op = pm.ops[0]
    got = _port_vjp(pm, case["weights"], case["inputs"], case["cots"],
                    lambda ps, xs: op.forward_parts(ps["lstm"], xs, k, FwdCtx()))
    _assert_case(got, want, LSTM_TOL)
    # the stored layout: part p's columns are [i_p | f_p | g_p | o_p]
    op.pc = ft.ParallelConfig(dims=(1, 1, k))
    w = torch.tensor(case["weights"]["lstm"]["w_hh"])
    stored = op.stored("w_hh", w)
    assert torch.equal(op.stored("w_hh", stored, inverse=True), w)
    hp = 8 // k
    assert torch.equal(stored[:, 4 * hp:8 * hp], torch.cat(
        [w[:, g * 8 + hp:g * 8 + 2 * hp] for g in range(4)], 1))


@pytest.mark.parametrize("dp,ep", [(1, 2), (1, 4), (2, 2)])
def test_expert_parts_in_lockstep_equal_the_jax_op(dp, ep):
    """At capacity factor 0.5 the op drops tokens: the parts keep the JAX
    package's tokens (a dropped token's output row is 0) and give its
    output and gradients."""
    pm, jm = _moe_model(ft), _moe_model(ff)
    case = _case(pm, 7)
    want = _jax_vjp(jm, case["weights"], case["inputs"], case["cots"])
    op = pm.ops[0]
    keep = []
    got = _port_vjp(pm, case["weights"], case["inputs"], case["cots"],
                    lambda ps, xs: [op.forward_parts(ps["moe"], xs[0], dp, ep, keep)])
    _assert_case(got, want, MOE_TOL)
    kept = torch.cat(keep, 0).any(-1).numpy()
    assert 0 < kept.sum() < kept.size
    np.testing.assert_array_equal(kept, np.abs(want[0][0]).reshape(-1, 8).max(-1) > 0)
