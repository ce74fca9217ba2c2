"""The model zoo's ops in the port against the JAX package's, on the CPU.

Concat (4-D under the reference's NCHW channel axis and the NHWC height
axis, and 2-D), LSTM (with and without hx/cx inputs) and ExpertMLP (with
capacity drops) are built by the same graph call in both packages; the
same numpy inputs, weights and output cotangents go through
``op.forward`` and its gradient (``jax.grad`` vs torch autograd), every
output of the op at once.  float32, rtol 1e-5, atol 1e-6.

The MoE routing is compared exactly first: the expert index and the keep
mask of the JAX formulation (ops/moe.py:107-116 there) against the
port's ``route``; a top-1 margin below f32 rounding anywhere fails the
test with that reason rather than as a mismatch.

``share_with`` on an embedding, a dense layer and an LSTM: the sharing
op holds no weight, the parameter tree, the optimizer state and a
checkpoint hold the weight once under its owner's name, and two SGD steps
(the gradient the sum of both uses) match the JAX package's model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.ops.base import FwdCtx as JaxCtx
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
from flexflow_tpu_torch.ops.base import FwdCtx

TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)


def _models(batch=4):
    return (ff.FFModel(ff.FFConfig(batch_size=batch, workers_per_node=1,
                                   compute_dtype="float32")),
            ft.FFModel(ft.FFConfig(batch_size=batch, device="cpu", compute_dtype="float32")))


def _weights(op, rng):
    """Weights at the scale the op's initializers give (Glorot), drawn from
    ``rng``: biases too, so that their gradients are exercised."""
    return {w.name: (rng.standard_normal(w.dims) * np.sqrt(2.0 / sum(w.dims[-2:]))
                     ).astype(np.float32) for w in op.weights}


def _jax_side(op, params, xs, cts):
    def f(p, xs_):
        ys = op.forward(p, list(xs_), JaxCtx())
        return sum(jnp.sum(y * c) for y, c in zip(ys, cts))
    ys = op.forward(params, list(xs), JaxCtx())
    gp, gx = jax.grad(f, argnums=(0, 1))(params, tuple(xs))
    return ([np.asarray(y) for y in ys], [np.asarray(g) for g in gx],
            {k: np.asarray(v) for k, v in gp.items()})


def _torch_side(op, params, xs, cts):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = [torch.tensor(x, requires_grad=True) for x in xs]
    ys = op.forward(p, xt, FwdCtx())
    sum((y * torch.from_numpy(c)).sum() for y, c in zip(ys, cts)).backward()
    return ([y.detach().numpy() for y in ys], [x.grad.numpy() for x in xt],
            {k: v.grad.numpy() for k, v in p.items()})


def _compare(jop, top, xs, seed):
    rng = np.random.default_rng(seed)
    params = _weights(jop, rng)
    assert [(w.name, w.dims) for w in jop.weights] == [(w.name, w.dims) for w in top.weights]
    cts = [rng.standard_normal(t.dims).astype(np.float32) for t in jop.outputs]
    want = _jax_side(jop, params, xs, cts)
    got = _torch_side(top, params, xs, cts)
    for what, w, g in zip(("output", "input gradient"), want[:2], got[:2]):
        assert len(w) == len(g)
        for i, (a, b) in enumerate(zip(w, g)):
            np.testing.assert_allclose(b, a, **TOL, err_msg=f"{what} {i}")
    assert want[2].keys() == got[2].keys()
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], **TOL, err_msg=f"d{k}")
    return want, got


CONCAT_CASES = [  # (input dims, reference axis)
    ([(2, 3, 5, 4), (2, 6, 5, 4), (2, 1, 5, 4)], 1),  # NCHW channels -> NHWC 3
    ([(2, 3, 5, 4), (2, 3, 2, 4)], 2),                 # NCHW height -> NHWC 1
    ([(4, 7), (4, 1), (4, 9)], 1),                     # 2-D features stay axis 1
]


@pytest.mark.parametrize("dims,axis", CONCAT_CASES, ids=["4d-channels", "4d-height", "2d"])
def test_concat_matches_jax(dims, axis):
    jm, tm = _models()
    outs = []
    for m in (jm, tm):
        ts = [m.create_tensor(d) for d in dims]
        outs.append(m.concat(ts, axis=axis))
    assert outs[0].dims == outs[1].dims
    assert jm.ops[-1].axis == tm.ops[-1].axis
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(t.dims).astype(np.float32) for t in jm.ops[-1].inputs]
    _compare(jm.ops[-1], tm.ops[-1], xs, seed=4)
    # the simulator's input rectangles of every part of a batch split
    pc = ft.ParallelConfig(dims=(2,) + (1,) * (len(dims[0]) - 1))
    jpc = ff.ParallelConfig(dims=pc.dims)
    for j in range(len(dims)):
        for part in range(2):
            assert tm.ops[-1].input_ranges(j, pc, part) == jm.ops[-1].input_ranges(j, jpc, part)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "hx-cx"])
def test_lstm_matches_jax(with_state):
    b, t, e, h = 3, 5, 6, 4
    jm, tm = _models(b)
    for m in (jm, tm):
        x = m.create_tensor((b, t, e), nchw=False)
        if with_state:
            hx = m.create_tensor((b, h), nchw=False)
            cx = m.create_tensor((b, h), nchw=False)
            ys = m.lstm(x, h, hx=hx, cx=cx, name="lstm")
        else:
            ys = m.lstm(x, h, name="lstm")
        assert [y.dims for y in ys] == [(b, t, h), (b, h), (b, h)]
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal(tn.dims).astype(np.float32) for tn in jm.ops[-1].inputs]
    _compare(jm.ops[-1], tm.ops[-1], xs, seed=8)
    assert tm.ops[-1].flops_per_sample() == jm.ops[-1].flops_per_sample()


def _jax_routing(x, router, cap):
    """The JAX package's routing formulation: expert index, keep mask and
    the top-1 margin of the gates, per token."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    gates = jax.nn.softmax(jnp.dot(xf, jnp.asarray(router)), axis=-1)
    idx = jnp.argmax(gates, axis=-1)
    onehot = jax.nn.one_hot(idx, router.shape[1], dtype=jnp.float32)
    pos = jnp.cumsum(onehot, axis=0) * onehot
    keep = (pos > 0) & (pos <= cap)
    top2 = jnp.sort(gates, axis=-1)[:, -2:]
    return np.asarray(idx), np.asarray(keep), np.asarray(top2[:, 1] - top2[:, 0])


@pytest.mark.parametrize("capacity_factor,activation", [(0.5, "relu"), (1.25, "gelu")])
def test_expert_mlp_routing_and_gradients_match_jax(capacity_factor, activation):
    b, s, d, e, h = 2, 12, 8, 4, 16
    jm, tm = _models(b)
    for m in (jm, tm):
        m.expert_mlp(m.create_tensor((b, s, d), nchw=False), num_experts=e, hidden_size=h,
                     capacity_factor=capacity_factor, activation=activation, name="moe")
    jop, top = jm.ops[-1], tm.ops[-1]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    params = _weights(jop, np.random.default_rng(12))
    cap = top.capacity(b * s)
    assert cap == jop.capacity(b * s)
    want_idx, want_keep, margin = _jax_routing(x, params["router"], cap)
    assert margin.min() > 1e-6, (
        f"a top-1 routing margin of {margin.min():.3e} is within f32 rounding: the "
        "exact routing comparison is not meaningful at this seed")
    idx, _, keep, _ = top.route(torch.from_numpy(x).reshape(-1, d),
                                torch.from_numpy(params["router"]), cap, cap)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    dropped = (~want_keep.any(-1)).sum()
    if capacity_factor < 1:
        assert dropped > 0, "the small capacity drops no token"
    _compare(jop, top, [x], seed=12)
    assert top.flops_per_sample() == jop.flops_per_sample()


def test_expert_mlp_output_is_zero_for_dropped_tokens():
    b, s, d = 1, 16, 4
    _, tm = _models(b)
    tm.expert_mlp(tm.create_tensor((b, s, d), nchw=False), num_experts=2, hidden_size=8,
                  capacity_factor=0.25, name="moe")
    op = tm.ops[-1]
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy(v) for k, v in _weights(op, rng).items()}
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    cap = op.capacity(s)
    _, _, keep, _ = op.route(x.reshape(-1, d), params["router"], cap, cap)
    y = op.forward(params, [x], FwdCtx())[0].reshape(-1, d)
    kept = keep.any(-1)
    assert int(kept.sum()) <= 2 * cap
    assert torch.all(y[~kept] == 0) and torch.all(y[kept].abs().sum(-1) > 0)


# --------------------------------------------------------------- weight sharing

def _build_shared(m, kind):
    """A two-use graph of ``kind``: the second op shares the first's weights."""
    if kind == "embedding":
        ids = [m.create_tensor((4, 3), dtype="int32", nchw=False) for _ in range(2)]
        a = m.embedding(ids[0], 20, 6, aggr="sum", name="emb_a")
        b = m.embedding(ids[1], 20, 6, aggr="sum", share_with=m.ops[-1], name="emb_b")
        out = m.dense(m.add(a, b), 5, name="head")
        return ids, out
    if kind == "dense":
        x = m.create_tensor((4, 6), nchw=False)
        a = m.dense(x, 6, activation="tanh", name="fc_a")
        b = m.dense(a, 6, share_with=m.ops[-1], activation="tanh", name="fc_b")
        return [x], m.dense(b, 5, name="head")
    x = m.create_tensor((4, 3, 6), nchw=False)
    y, h, c = m.lstm(x, 6, name="lstm_a")
    y2, _, _ = m.lstm(y, 6, hx=h, cx=c, share_with=m.ops[-1], name="lstm_b")
    return [x], m.dense(m.flat(y2), 5, name="head")


def _shared_batch(kind, inputs, seed):
    rng = np.random.default_rng(seed)
    if kind == "embedding":
        xs = [rng.integers(0, 20, size=(4, 3)).astype(np.int32) for _ in inputs]
    else:
        xs = [rng.standard_normal(inputs[0].dims).astype(np.float32)]
    return xs, rng.integers(0, 5, size=(4, 1)).astype(np.int32)


@pytest.mark.parametrize("kind", ["embedding", "dense", "lstm"])
def test_shared_weights_train_like_the_jax_package(kind, tmp_path):
    jm, tm = _models()
    jin, _ = _build_shared(jm, kind)
    tin, _ = _build_shared(tm, kind)
    owner, sharer = tm.ops[0], tm.ops[1]
    assert sharer.share_from is owner and sharer.weights == []
    assert sharer.param_key == owner.name
    for m, opt in ((jm, ff.SGDOptimizer(lr=0.1, momentum=0.9)),
                   (tm, ft.SGDOptimizer(lr=0.1, momentum=0.9))):
        m.compile(opt, "sparse_categorical_crossentropy", ["accuracy"],
                  **({"machine": ff.Machine(devices=jax.devices()[:1])} if m is jm else {}))
    jm.init_layers(seed=0)
    tm.init_layers(seed=1)
    load_jax_params(tm, jax_params_to_numpy(jm))
    assert sharer.name not in tm._params and owner.name in tm._params
    assert sharer.name not in tm._opt_state["v"]
    before = {wn: tm.get_parameter(owner.name, wn) for wn in tm._params[owner.name]}
    for step in range(2):
        xs, labels = _shared_batch(kind, jin, seed=step)
        jm.set_batch(dict(zip(jin, xs)), labels)
        tm.set_batch(dict(zip(tin, xs)), labels)
        jm.train_iteration()
        tm.train_iteration()
    np.testing.assert_allclose(tm.get_metrics().train_correct, jm.get_metrics().train_correct)
    for op in tm.ops:
        for w in op.weights:
            np.testing.assert_allclose(tm.get_parameter(op.name, w.name),
                                       jm.get_parameter(op.name, w.name), **MODEL_TOL,
                                       err_msg=f"{op.name}/{w.name}")
    for wn, w0 in before.items():
        assert not np.array_equal(tm.get_parameter(owner.name, wn), w0)
    tm.save(str(tmp_path / "shared"))
    with np.load(str(tmp_path / "shared.npz")) as data:
        keys = data.files
    assert not any(f"/{sharer.name}/" in k for k in keys)
    assert sum(k.startswith(f"params/{owner.name}/") for k in keys) == len(owner.weights)


def test_share_with_refuses_a_different_op():
    _, tm = _models()
    x = tm.create_tensor((4, 6), nchw=False)
    tm.dense(x, 6, name="fc")
    with pytest.raises(ValueError, match="identical shape"):
        tm.dense(x, 7, share_with=tm.ops[-1])
    ids = tm.create_tensor((4, 2), dtype="int32", nchw=False)
    with pytest.raises(ValueError, match="identical shape"):
        tm.embedding(ids, 10, 6, share_with=tm.ops[0])


def test_shared_weights_chain_to_their_owner():
    """Sharing with a sharing op reads the owner's weights."""
    _, tm = _models()
    ids = tm.create_tensor((4, 2), dtype="int32", nchw=False)
    tm.embedding(ids, 10, 6, name="a")
    tm.embedding(ids, 10, 6, share_with=tm.ops[-1], name="b")
    tm.embedding(ids, 10, 6, share_with=tm.ops[-1], name="c")
    assert tm.ops[2].share_from is tm.ops[0] and tm.ops[2].param_key == "a"
