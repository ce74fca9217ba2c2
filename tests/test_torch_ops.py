"""Per-op parity: the port's ops vs the JAX package's ops on the CPU.

Each op is built by the same graph call in both packages; the same
numpy input, weights and output cotangent go through ``op.forward`` and
its gradient (``jax.grad`` vs torch autograd).  A multi-input op gets the
input at every position; an int input (Embedding's ids) has no gradient.
Attention runs the JAX package's CPU path (``blockwise_attention``) and
the port's flash kernels' plain versions.  Shapes follow
tests/test_ops.py.  float32; rtol 1e-4, atol 1e-5: XLA and PyTorch sum
convolutions and products in different orders.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.losses import Loss as JaxLoss
from flexflow_tpu.ops.base import FwdCtx as JaxCtx
from flexflow_tpu_torch.losses import Loss
from flexflow_tpu_torch.ops.base import FwdCtx

TOL = dict(rtol=1e-4, atol=1e-5)
EMBED_ROWS = 10


def _models():
    return (ff.FFModel(ff.FFConfig(batch_size=4, workers_per_node=1)),
            ft.FFModel(ft.FFConfig(batch_size=4, device="cpu")))


def _jax_side(op, params, x, ct):
    """Output, input gradient (None for int inputs) and weight gradients;
    a multi-input op gets ``x`` at every input."""
    n = len(op.inputs)

    def f(p, x_):
        return jnp.sum(op.forward(p, [x_] * n, JaxCtx())[0] * ct)
    y = op.forward(params, [x] * n, JaxCtx())[0]
    if jnp.issubdtype(x.dtype, jnp.integer):
        gp, gx = jax.grad(f)(params, x), None
    else:
        gp, gx = jax.grad(f, argnums=(0, 1))(params, x)
    return (np.asarray(y), None if gx is None else np.asarray(gx),
            {k: np.asarray(v) for k, v in gp.items()})


def _torch_side(op, params, x, ct):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=x.dtype.kind == "f")
    y = op.forward(p, [xt] * len(op.inputs), FwdCtx())[0]
    (y * torch.from_numpy(ct)).sum().backward()
    return (y.detach().numpy(), None if xt.grad is None else xt.grad.numpy(),
            {k: v.grad.numpy() for k, v in p.items()})


CASES = {
    "conv_stride2_pad1_bias": (
        (4, 3, 16, 16), lambda m, t: m.conv2d(t, 8, 3, 3, 2, 2, 1, 1)),
    "conv_5x5_nobias_relu": (
        (4, 3, 16, 16), lambda m, t: m.conv2d(t, 8, 5, 5, 1, 1, 2, 2,
                                              activation="relu", use_bias=False)),
    "conv_11x11_stride4_relu": (
        (2, 3, 31, 31), lambda m, t: m.conv2d(t, 16, 11, 11, 4, 4, 2, 2, activation="relu")),
    "maxpool_3x3_s2": ((2, 4, 13, 13), lambda m, t: m.pool2d(t, 3, 3, 2, 2, 0, 0)),
    "maxpool_3x3_s2_pad1": ((2, 4, 13, 13), lambda m, t: m.pool2d(t, 3, 3, 2, 2, 1, 1)),
    "avgpool_3x3_s2_pad1": (
        (2, 4, 9, 9), lambda m, t: m.pool2d(t, 3, 3, 2, 2, 1, 1, pool_type="avg")),
    "dense_relu": ((4, 32), lambda m, t: m.dense(t, 16, activation="relu")),
    "dense_nobias": ((4, 32), lambda m, t: m.dense(t, 16, use_bias=False)),
    "flat": ((2, 3, 4, 4), lambda m, t: m.flat(t)),
    "softmax": ((2, 10), lambda m, t: m.softmax(t)),
    "layer_norm": ((4, 6, 16), lambda m, t: m.layer_norm(t)),
    "embedding_none_seq": (
        (4, 6), lambda m, t: m.embedding(t, EMBED_ROWS, 8, aggr="none"), "int32"),
    "embedding_sum": ((4, 6), lambda m, t: m.embedding(t, EMBED_ROWS, 8, aggr="sum"), "int32"),
    "add": ((4, 16), lambda m, t: m.add(t, t)),
    "mha_causal_e32_h4": ((2, 8, 32), lambda m, t: m.multihead_attention(t, num_heads=4,
                                                                          causal=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_forward_and_gradients_match_jax(case):
    in_dims, build, *dtype = CASES[case]
    dtype = dtype[0] if dtype else "float32"
    jm, tm = _models()
    for m in (jm, tm):
        build(m, m.create_tensor(in_dims, dtype=dtype))
    jop, top = jm.ops[0], tm.ops[0]
    assert jop.output.dims == top.output.dims
    assert [w.dims for w in jop.weights] == [w.dims for w in top.weights]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if dtype == "int32":
        x = rng.integers(0, EMBED_ROWS, size=jop.inputs[0].dims).astype(np.int32)
    else:
        x = rng.standard_normal(jop.inputs[0].dims).astype(np.float32)
    params = {w.name: rng.standard_normal(w.dims).astype(np.float32) * 0.3
              for w in jop.weights}
    ct = rng.standard_normal(jop.output.dims).astype(np.float32)
    jy, jgx, jgp = _jax_side(jop, {k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), jnp.asarray(ct))
    ty, tgx, tgp = _torch_side(top, params, x, ct)
    np.testing.assert_allclose(ty, jy, **TOL)
    assert (tgx is None) == (jgx is None)
    if jgx is not None:
        np.testing.assert_allclose(tgx, jgx, **TOL)
    assert tgp.keys() == jgp.keys()
    for k in jgp:
        np.testing.assert_allclose(tgp[k], jgp[k], **TOL)
    assert top.flops_per_sample() == jop.flops_per_sample()


@pytest.mark.parametrize("loss_type", ["sparse_categorical_crossentropy",
                                       "categorical_crossentropy",
                                       "mean_squared_error"])
def test_loss_value_and_gradient_match_jax(loss_type):
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((4, 10)).astype(np.float32) * 3
    if loss_type.startswith("sparse"):
        labels = rng.integers(0, 10, size=(4, 1)).astype(np.int32)
    elif loss_type.startswith("categorical"):
        labels = np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=4)]
    else:
        labels = rng.standard_normal((4, 10)).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda z: JaxLoss(loss_type)(z, jnp.asarray(labels)))(
        jnp.asarray(logits))
    z = torch.tensor(logits, requires_grad=True)
    tl = Loss(loss_type)(z, torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jg), **TOL)
