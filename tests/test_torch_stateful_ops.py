"""Dropout, BatchNorm, the MSELoss op and graph constants: the port against
the JAX package on the CPU.

Op level, at tests/test_ops.py's shapes: BatchNorm (4x3x8x8, ReLU) in
training (output, gradients, the running-moment update) and in
evaluation; Dropout equal to the JAX package's in evaluation and at rate
0, and above it only statistics can agree (different generators): every
value 0 or 1 / keep and the zero share of an (8, 100) draw at rate 0.5 in
(0.3, 0.7), the JAX package's own bounds; the MSELoss op's value and
gradients.  rtol 1e-4, atol 1e-5 (XLA and PyTorch sum in other orders).

Model level: a conv -> BatchNorm -> dense model, the JAX model's weights
and statistics carried into the port, 3 SGD-momentum steps, then an
evaluation forward (which reads the running moments): weights, moments and
outputs at the same tolerance; the moments through ``.npz`` both ways,
exactly; a NaN batch under the non-finite guard leaves weights and
moments bitwise.  examples/pca.py's graph (``create_constant``) trains 3
steps alike.  A transformer with attention dropout trains with remat as
it does without (bitwise, one seed), and a model that draws registers its
generator with the step's capture.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.ops.base import FwdCtx as JaxCtx
from flexflow_tpu_torch.convert import jax_params_to_numpy, jax_stats_to_numpy, load_jax_params
from flexflow_tpu_torch.ops.base import FwdCtx
from flexflow_tpu_torch.runtime.step_graph import StepGraph, disable_graphs, graphs_enabled

TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _models(batch=4):
    return (ff.FFModel(ff.FFConfig(batch_size=batch, workers_per_node=1)),
            ft.FFModel(ft.FFConfig(batch_size=batch, device="cpu")))


# ---------------------------------------------------------------- op level

@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_op_matches_jax(training):
    jm, pm = _models()
    for m in (jm, pm):
        m.batch_norm(m.create_tensor((4, 3, 8, 8)), relu=True, name="bn")
    jop, pop = jm.ops[0], pm.ops[0]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 8, 8, 3), dtype=np.float32)
    ct = rng.standard_normal((4, 8, 8, 3), dtype=np.float32)
    params = {"scale": np.array([1.5, 0.5, 2.0], np.float32),
              "bias": np.array([0.1, -0.2, 0.0], np.float32)}
    stats = {"mean": np.array([0.2, -0.1, 0.05], np.float32),
             "var": np.array([1.5, 0.7, 1.1], np.float32)}

    def jax_fwd(p, x_):
        ctx = JaxCtx(training=training, stats_in={"bn": {k: jnp.asarray(v)
                                                          for k, v in stats.items()}},
                     stats_out={} if training else None)
        return jop.forward(p, [x_], ctx)[0], ctx.stats_out

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jy, jstats = jax_fwd(jp, jnp.asarray(x))
    jgp, jgx = jax.grad(lambda p, x_: jnp.sum(jax_fwd(p, x_)[0] * ct), argnums=(0, 1))(
        jp, jnp.asarray(x))
    pp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    ctx = FwdCtx(training=training, stats_in={"bn": {k: torch.tensor(v) for k, v in stats.items()}},
                 stats_out={} if training else None)
    y = pop.forward(pp, [xt], ctx)[0]
    (y * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    for k in params:
        np.testing.assert_allclose(pp[k].grad.numpy(), np.asarray(jgp[k]), **TOL)
    if training:
        for k in stats:
            np.testing.assert_allclose(ctx.stats_out["bn"][k].numpy(),
                                       np.asarray(jstats["bn"][k]), **TOL)
    assert pop.has_running_stats and set(pop.init_stats("cpu")) == {"mean", "var"}


def test_dropout_op_matches_jax_in_eval_and_at_rate_zero_and_in_distribution():
    jm, pm = _models(8)
    for m in (jm, pm):
        t = m.create_tensor((8, 100), nchw=False)
        m.dropout(t, rate=0.5)
        m.dropout(t, rate=0.0)
    x = np.random.default_rng(1).standard_normal((8, 100)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    for (jop, pop), training in ((tuple(zip(jm.ops, pm.ops))[0], False),
                                 (tuple(zip(jm.ops, pm.ops))[1], True)):
        jy = jop.forward({}, [jnp.asarray(x)], JaxCtx(training=training,
                                                       rng=jax.random.key(0)))[0]
        py = pop.forward({}, [torch.from_numpy(x)], FwdCtx(training=training, rng=gen))[0]
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    drop = pm.ops[0]
    assert drop.draws_random and not pm.ops[1].draws_random
    ones = torch.ones(8, 100)
    ctx = FwdCtx(training=True, rng=gen)
    y = drop.forward({}, [ones], ctx)[0]
    assert set(np.unique(y.numpy())) <= {0.0, 2.0}
    assert 0.3 < (y == 0).float().mean().item() < 0.7
    # one mask per call (a remat recompute reads it), a new one per call
    assert torch.equal(drop.forward({}, [ones], ctx)[0], y)
    assert not torch.equal(drop.forward({}, [ones], FwdCtx(training=True, rng=gen))[0], y)
    jy = jm.ops[0].forward({}, [jnp.ones((8, 100))], JaxCtx(training=True,
                                                             rng=jax.random.key(0)))[0]
    assert set(np.unique(np.asarray(jy))) <= {0.0, 2.0}
    assert 0.3 < float((np.asarray(jy) == 0).mean()) < 0.7
    with pytest.raises(RuntimeError, match="generator"):
        drop.forward({}, [ones], FwdCtx(training=True))


@pytest.mark.parametrize("reduction", ["average", "sum"])
def test_mse_loss_op_matches_jax(reduction):
    jm, pm = _models()
    for m in (jm, pm):
        m.mse_loss(m.create_tensor((4, 6), nchw=False), m.create_tensor((4, 6), nchw=False),
                   reduction=reduction)
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((4, 6)).astype(np.float32) for _ in range(2))
    jop, pop = jm.ops[0], pm.ops[0]
    jy = jop.forward({}, [jnp.asarray(a), jnp.asarray(b)], JaxCtx())[0]
    jga = jax.grad(lambda a_: jop.forward({}, [a_, jnp.asarray(b)], JaxCtx())[0][0])(
        jnp.asarray(a))
    at = torch.tensor(a, requires_grad=True)
    py = pop.forward({}, [at, torch.from_numpy(b)], FwdCtx())[0]
    py[0].backward()
    assert py.shape == (1,) == jy.shape
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(jga), **TOL)


# ---------------------------------------------------------------- BatchNorm in a model

def _bn_model(pkg, batch=8):
    extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
    m = pkg.FFModel(pkg.FFConfig(batch_size=batch, compute_dtype="float32", **extra))
    inp = m.create_tensor((batch, 3, 8, 8))
    t = m.conv2d(inp, 4, 3, 3, 1, 1, 1, 1, name="conv")
    t = m.batch_norm(t, relu=True, name="bn")
    t = m.flat(t, name="flat")
    t = m.dense(t, 5, name="fc")
    m.softmax(t, name="sm")
    machine = pkg.Machine(devices=jax.devices()[:1]) if pkg is ff else None
    m.compile(pkg.SGDOptimizer(lr=0.05, momentum=0.9), "sparse_categorical_crossentropy",
              ["accuracy"], machine=machine)
    m.init_layers(seed=3)
    return m, inp


def _bn_batch(step, batch=8):
    rng = np.random.default_rng(20 + step)
    x = 2.0 + 3.0 * rng.standard_normal((batch, 8, 8, 3), dtype=np.float32)
    return x, rng.integers(0, 5, size=(batch, 1), dtype=np.int32)


def _bn_train(m, inp, steps, first=0):
    for step in range(first, first + steps):
        x, y = _bn_batch(step)
        m.set_batch({inp: x}, y)
        m.train_iteration()
    m.sync()


def _stats(m):
    """BatchNorm's moments, copied (a CPU tensor's numpy view would follow
    the buffer the step writes in place)."""
    return {k: np.array(v) for k, v in m._stats["bn"].items()}


def _weights(m):
    return {(op.name, w.name): np.asarray(m.get_parameter(op.name, w.name))
            for op in m.ops for w in op.weights}


@pytest.fixture(scope="module")
def bn_pair():
    jm, jinp = _bn_model(ff)
    pm, pinp = _bn_model(ft)
    load_jax_params(pm, jax_params_to_numpy(jm), stats=jax_stats_to_numpy(jm))
    return jm, jinp, pm, pinp


def test_batch_norm_model_trains_and_evaluates_as_jax(bn_pair):
    jm, jinp, pm, pinp = bn_pair
    np.testing.assert_array_equal(_stats(pm)["var"], np.ones(4, np.float32))
    for m, inp in ((jm, jinp), (pm, pinp)):
        _bn_train(m, inp, 3)
    for k, v in _stats(pm).items():
        np.testing.assert_allclose(v, _stats(jm)[k], **TOL, err_msg=k)
    assert not np.allclose(_stats(pm)["mean"], 0.0)  # the moments moved
    jw = _weights(jm)
    for key, w in _weights(pm).items():
        np.testing.assert_allclose(w, jw[key], **TOL, err_msg=str(key))
    x, y = _bn_batch(99)
    for m, inp in ((jm, jinp), (pm, pinp)):
        m.set_batch({inp: x}, y)
    np.testing.assert_allclose(pm.predict_batch(), jm.predict_batch(), **TOL)


def test_batch_norm_statistics_through_npz_both_ways(tmp_path):
    jm, jinp = _bn_model(ff)
    _bn_train(jm, jinp, 2)
    path = str(tmp_path / "jax.npz")
    jm.save(path)
    pm, pinp = _bn_model(ft)
    pm.load(path)
    for k, v in _stats(jm).items():
        np.testing.assert_array_equal(_stats(pm)[k], v)
    _bn_train(pm, pinp, 2, first=2)
    out = str(tmp_path / "port.npz")
    pm.save(out)
    with np.load(out) as data:
        assert {k for k in data.files if k.startswith("stats/")} == {"stats/bn/mean",
                                                                      "stats/bn/var"}
    back, _ = _bn_model(ff)
    back.load(out)
    for k, v in _stats(pm).items():
        np.testing.assert_array_equal(_stats(back)[k], v)
    with np.load(out) as data:
        weights_only = {k: data[k] for k in data.files if not k.startswith("stats/")}
    np.savez(tmp_path / "no_stats.npz", **weights_only)
    with pytest.raises(KeyError, match="stats/bn/mean"):
        pm.load(str(tmp_path / "no_stats.npz"))


def test_the_guard_leaves_batch_norm_statistics_alone(monkeypatch):
    monkeypatch.setenv("FF_SKIP_NONFINITE", "100")
    pm, pinp = _bn_model(ft)
    _bn_train(pm, pinp, 1)
    stats, weights = _stats(pm), _weights(pm)
    x, y = _bn_batch(5)
    x[0, 0, 0, 0] = np.nan
    pm.set_batch({pinp: x}, y)
    pm.train_iteration()
    pm.get_metrics()
    assert pm._guard.total_skipped == 1
    for k, v in stats.items():
        np.testing.assert_array_equal(_stats(pm)[k], v)
    for key, w in weights.items():
        np.testing.assert_array_equal(_weights(pm)[key], w)
    _bn_train(pm, pinp, 1, first=1)  # a good step moves them again
    assert not np.array_equal(_stats(pm)["mean"], stats["mean"])


# ---------------------------------------------------------------- constants (PCA)

def _pca_module():
    spec = importlib.util.spec_from_file_location("pca_example",
                                                  os.path.join(ROOT, "examples", "pca.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pca_graph_with_constants_trains_as_jax():
    pca = _pca_module()
    b = 8
    out = {}
    for pkg in (ff, ft):
        extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
        m = pkg.FFModel(pkg.FFConfig(batch_size=b, compute_dtype="float32", **extra))
        inputs, _ = pca.build_pca(m, b)
        machine = pkg.Machine(devices=jax.devices()[:1]) if pkg is ff else None
        m.compile(pkg.SGDOptimizer(lr=0.05), "mean_squared_error",
                  ["mean_squared_error"], machine=machine)
        m.init_layers(seed=0)
        if pkg is ff:
            params0 = jax_params_to_numpy(m)
        else:
            load_jax_params(m, params0)
            assert len(m._constants) == 75 and not set(m._constants) & {
                t.guid for t in m.input_tensors}
        rng = np.random.default_rng(0)
        x = rng.standard_normal((b, pca.NPCS), dtype=np.float32)
        batch = {inputs["pcvec"]: x, inputs["pcmax"]: np.full((b, pca.NPCS), 3.0, np.float32),
                 inputs["pcmin"]: np.full((b, pca.NPCS), -3.0, np.float32)}
        for i in range(1, 6):
            batch[inputs[f"sb{i}"]] = np.zeros((b, pca.NN_SHL[i]), np.float32)
        m.set_batch(batch, np.tanh(x))
        losses = []
        for _ in range(3):
            m.train_iteration()
            m.get_metrics()
            losses.append(m.last_loss)
        out[pkg] = (m, losses)
    (jm, jl), (pm, pl) = out[ff], out[ft]
    np.testing.assert_allclose(pl, jl, **TOL)
    assert pl[-1] < pl[0]
    jw = _weights(jm)
    for key, w in _weights(pm).items():
        np.testing.assert_allclose(w, jw[key], **TOL, err_msg=str(key))


# ---------------------------------------------------------------- dropout in the step

def _dropout_lm(remat=False):
    from flexflow_tpu_torch.models.transformer import build_transformer

    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu", compute_dtype="float32",
                               remat=remat, seed=4))
    tok, pos, _ = build_transformer(m, 2, seq_length=16, num_layers=2, embed_dim=32,
                                    num_heads=4, vocab_size=64, dropout=0.1)
    m.compile(ft.SGDOptimizer(lr=0.05, momentum=0.9), "sparse_categorical_crossentropy",
              ["accuracy"])
    m.init_layers()
    return m, tok, pos


def _lm_steps(m, tok, pos, steps=2):
    from flexflow_tpu_torch.models.transformer import synthetic_lm_batch

    losses = []
    for step in range(steps):
        toks, posa, labels = synthetic_lm_batch(2, 16, 64, seed=step)
        m.set_batch({tok: toks, pos: posa}, labels)
        m.train_iteration()
        m.get_metrics()
        losses.append(m.last_loss)
    return losses


def test_remat_with_attention_dropout_equals_plain():
    plain, remat = _dropout_lm(), _dropout_lm(remat=True)
    assert _lm_steps(*plain) == _lm_steps(*remat)
    for key, w in _weights(plain[0]).items():
        np.testing.assert_array_equal(_weights(remat[0])[key], w, err_msg=str(key))
    # the same batch twice draws two masks: two losses
    m, tok, pos = plain
    assert len(set(_lm_steps(m, tok, pos, 1) + _lm_steps(m, tok, pos, 1))) == 2


def test_the_step_registers_its_generator_with_the_capture(monkeypatch):
    """A model that draws hands its generator to StepGraph, which registers
    it with each capture; a model that draws nothing registers none.  The
    graph path (fake graphs that replay what they captured) trains as the
    eager one with dropout, step for step."""
    from test_torch_step import _FakeCuda

    _FakeCuda(monkeypatch)
    monkeypatch.setattr(ft.FFModel, "_use_graph",
                        lambda self: not self._sharded and graphs_enabled())
    registered = []

    def register(self, gen):
        registered.append(gen)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "register_generator_state", register,
                        raising=False)
    capture = StepGraph._capture

    def recorded(self, step):
        # the real capture (which registers the generators) of nothing, as
        # a capture runs nothing; the fake graph then replays the step
        capture(self, lambda: None)
        self.graph.fn = step
    monkeypatch.setattr(StepGraph, "_capture", recorded)
    graph, eager = _dropout_lm(), _dropout_lm()
    got = _lm_steps(*graph, steps=3)
    with disable_graphs():
        want = _lm_steps(*eager, steps=3)
    assert graph[0]._step_graph.captures == 1 and registered == [graph[0]._rng]
    assert got == want
    for key, w in _weights(eager[0]).items():
        np.testing.assert_array_equal(_weights(graph[0])[key], w, err_msg=str(key))
    pm, pinp = _bn_model(ft)
    _bn_train(pm, pinp, 3)
    assert pm._step_graph.captures == 1 and pm._step_graph.generators == []
    assert registered == [graph[0]._rng]
