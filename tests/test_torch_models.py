"""The rest of the model zoo: the port against the JAX package, on the CPU.

Each model is built by the same builder in both packages at the sizes of
tests/test_models.py, float32.  The JAX model's initial weights are
carried into the port (``convert.load_jax_params``); both then take 2
training steps on the same synthetic batches (the JAX package's
``synthetic_batch`` helpers where it has them, else a numpy seed).  Per
step the loss, then the drained metrics and every weight must agree
within rtol 1e-4, atol 1e-5: XLA and PyTorch sum products in different
orders.

* ResNet-50 at 64x64, batch 2, SGD momentum;
* DLRM with tables 100/100/50, bag 2, MSE, SGD;
* NMT at vocab 64, seq 6, hidden 16, Adam; ``embed_dst`` shares
  ``embed_src``'s table, so the port's Adam updates it once a step;
* CANDLE-Uno at widths 32, MSE, SGD;
* the MoE transformer at 2 layers, width 64, ``moe_every=1``, 4 experts,
  S 16, SGD momentum, its MoE routing first held exactly against the JAX
  package's on the batch it trains on;
* Inception-v3: each of blocks A-E as its own small graph at batch 2 (the
  whole network's 299-pixel input is too heavy here), and the whole
  network's op list, output shapes and parameter tree against the JAX
  package's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.models import candle_uno as jax_candle
from flexflow_tpu.models import dlrm as jax_dlrm
from flexflow_tpu.models import inception as jax_inception
from flexflow_tpu.models import nmt as jax_nmt
from flexflow_tpu.models import resnet as jax_resnet
from flexflow_tpu.models import transformer as jax_transformer
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
from flexflow_tpu_torch.models import candle_uno, dlrm, inception, nmt, resnet, transformer

TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 2


def _pair(batch, build, jbuild, make_opt, loss, metrics):
    """(JAX model, port model, JAX graph inputs, port graph inputs): the
    same graph, compiled, the port holding the JAX model's weights."""
    jm = ff.FFModel(ff.FFConfig(batch_size=batch, workers_per_node=1, compute_dtype="float32"))
    tm = ft.FFModel(ft.FFConfig(batch_size=batch, device="cpu", compute_dtype="float32",
                                fused_optimizer=True))
    jin, tin = jbuild(jm), build(tm)
    assert [(o.name, o._type, [t.dims for t in o.outputs], [w.dims for w in o.weights])
            for o in jm.ops] == \
        [(o.name, o._type, [t.dims for t in o.outputs], [w.dims for w in o.weights])
         for o in tm.ops]
    jm.compile(make_opt(ff), loss, metrics, machine=ff.Machine(devices=jax.devices()[:1]))
    tm.compile(make_opt(ft), loss, metrics)
    jm.init_layers(seed=0)
    tm.init_layers(seed=1)
    load_jax_params(tm, jax_params_to_numpy(jm))
    return jm, tm, jin, tin


def _train_both(jm, tm, jin, tin, batches):
    params0 = jax_params_to_numpy(jm)
    for xs, labels in batches:
        losses = []
        for m, ins in ((jm, jin), (tm, tin)):
            m.set_batch(dict(zip(ins, xs)), labels)
            m.train_iteration()
            m._drain_metrics()
            losses.append(m.last_loss)
        np.testing.assert_allclose(losses[1], losses[0], **TOL)
    jmet, tmet = jm.get_metrics(), tm.get_metrics()
    assert tmet.train_all == jmet.train_all
    assert tmet.train_correct == jmet.train_correct
    for key in ("sparse_cce_loss", "mse_loss"):
        np.testing.assert_allclose(getattr(tmet, key), getattr(jmet, key), **TOL)
    for opn, ws in params0.items():
        for wn, w0 in ws.items():
            got = tm.get_parameter(opn, wn)
            assert not np.array_equal(got, w0), f"{opn}/{wn} never moved"
            np.testing.assert_allclose(got, jm.get_parameter(opn, wn), **TOL,
                                       err_msg=f"{opn}/{wn}")


def _sgd(momentum=0.9):
    return lambda pkg: pkg.SGDOptimizer(lr=0.01, momentum=momentum)


def test_resnet50_trains_like_the_jax_package():
    jm, tm, jin, tin = _pair(
        2, lambda m: [resnet.build_resnet50(m, 2, height=64, width=64)[0]],
        lambda m: [jax_resnet.build_resnet50(m, 2, height=64, width=64)[0]],
        _sgd(), "sparse_categorical_crossentropy", ["accuracy"])
    assert sum(len(op.weights) for op in tm.ops) == 108
    # the JAX package's synthetic data (DataLoader.synthetic), 2 batches
    data = ff.DataLoader.synthetic(jm, jin[0], num_samples=2 * STEPS)
    x, y = data.inputs[jin[0]], data.labels
    batches = [([x[2 * s:2 * s + 2]], y[2 * s:2 * s + 2]) for s in range(STEPS)]
    _train_both(jm, tm, jin, tin, batches)


DLRM = dict(embedding_sizes=[100, 100, 50], embedding_bag_size=2, sparse_feature_size=8,
            mlp_bot=[4, 16, 8], mlp_top=[32, 16, 1])


def test_dlrm_trains_like_the_jax_package():
    def flat(r):
        return list(r[0]) + [r[1]]
    jm, tm, jin, tin = _pair(16, lambda m: flat(dlrm.build_dlrm(m, 16, **DLRM)),
                             lambda m: flat(jax_dlrm.build_dlrm(m, 16, **DLRM)),
                             _sgd(0.0), "mean_squared_error", ["mean_squared_error"])
    batches = []
    for step in range(STEPS):
        want = jax_dlrm.synthetic_batch(16, DLRM["embedding_sizes"], 2, 4, seed=step)
        got = dlrm.synthetic_batch(16, DLRM["embedding_sizes"], 2, 4, seed=step)
        for a, b in zip(flat(got), flat(want)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[2], want[2])
        batches.append((flat(got), got[2]))
    _train_both(jm, tm, jin, tin, batches)


NMT = dict(seq_length=6, num_layers=2, hidden_size=16, embed_size=16, vocab_size=64)


def test_nmt_trains_like_the_jax_package():
    jm, tm, jin, tin = _pair(4, lambda m: list(nmt.build_nmt(m, 4, **NMT)[:2]),
                             lambda m: list(jax_nmt.build_nmt(m, 4, **NMT)[:2]),
                             lambda pkg: pkg.AdamOptimizer(alpha=1e-2),
                             "sparse_categorical_crossentropy", ["accuracy"])
    assert tm.ops[1].share_from is tm.ops[0] and "embed_dst" not in tm._params
    assert len([1 for ws in tm._params.values() for _ in ws]) == 1 + 4 * 3 + 2
    batches = []
    for step in range(STEPS):
        src, dst, labels = nmt.synthetic_batch(4, 6, 64, seed=step)
        for a, b in zip((src, dst, labels), jax_nmt.synthetic_batch(4, 6, 64, seed=step)):
            np.testing.assert_array_equal(a, b)
        batches.append(([src, dst], labels))
    _train_both(jm, tm, jin, tin, batches)


def test_nmt_greedy_translate_names_its_roadmap_item(tmp_path):
    """greedy_translate decodes on one device (tests/test_torch_decode.py
    holds its tokens against the JAX package's) and on a mesh (a one-rank
    gloo group here; tests/test_torch_decode_mesh.py splits the LSTMs over
    two ranks), where it gives the one-device tokens."""
    from flexflow_tpu_torch.parallel import distributed

    src_tokens = np.random.default_rng(0).integers(0, 64, (2, 6)).astype(np.int32)
    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    src, dst, _ = nmt.build_nmt(m, 2, **NMT)
    m.compile(ft.AdamOptimizer(alpha=1e-2))
    m.init_layers(seed=0)
    out = nmt.greedy_translate(m, src, dst, src_tokens, 4)
    assert out.shape == (2, 4) and ((out >= 0) & (out < 64)).all()
    distributed.initialize("cpu", init_method=f"file://{tmp_path / 'pg'}", world_size=1,
                           rank=0)
    try:
        mm = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
        msrc, mdst, _ = nmt.build_nmt(mm, 2, **NMT)
        mm.compile(ft.AdamOptimizer(alpha=1e-2))
        mm.init_layers(seed=0)
        assert mm._sharded
        np.testing.assert_array_equal(nmt.greedy_translate(mm, msrc, mdst, src_tokens, 4), out)
    finally:
        distributed.shutdown()


def test_candle_uno_trains_like_the_jax_package():
    def build(pkg_builder):
        def b(m):
            inputs, _ = pkg_builder(m, 4, dense_layers=[32] * 3, dense_feature_layers=[32] * 3)
            return [inputs[k] for k in sorted(inputs)]
        return b
    jm, tm, jin, tin = _pair(4, build(candle_uno.build_candle_uno),
                             build(jax_candle.build_candle_uno), _sgd(0.0),
                             "mean_squared_error", ["mean_squared_error"])
    assert [op._type for op in tm.ops].count("Concat") == 1
    rng = np.random.default_rng(3)
    batches = [([rng.standard_normal(t.dims).astype(np.float32) for t in tin],
                rng.standard_normal((4, 1)).astype(np.float32)) for _ in range(STEPS)]
    _train_both(jm, tm, jin, tin, batches)


MOE = dict(seq_length=16, num_layers=2, embed_dim=64, num_heads=4, vocab_size=64,
           moe_every=1, num_experts=4)


def test_moe_transformer_trains_like_the_jax_package():
    jm, tm, jin, tin = _pair(
        2, lambda m: list(transformer.build_transformer(m, 2, **MOE)[:2]),
        lambda m: list(jax_transformer.build_transformer(m, 2, **MOE)[:2]),
        _sgd(), "sparse_categorical_crossentropy", ["accuracy"])
    assert [op.name for op in tm.ops if op._type == "ExpertMLP"] == ["moe_0", "moe_1"]
    batches = [(list(transformer.synthetic_lm_batch(2, 16, 64, seed=10 + s)[:2]),
                transformer.synthetic_lm_batch(2, 16, 64, seed=10 + s)[2])
               for s in range(STEPS)]
    # the first MoE layer's routing on the first batch, held exactly
    # against the JAX package's before anything is compared within a
    # tolerance (its input is the embeddings after one attention block)
    moe = tm.ops[[op.name for op in tm.ops].index("moe_0")]
    tm.set_batch(dict(zip(tin, batches[0][0])), batches[0][1])
    env = tm._run_graph(tm._params, tm._batch, training=False)
    h = env[moe.inputs[0].guid].detach()
    router = tm.get_parameter("moe_0", "router")
    xf = h.reshape(-1, h.shape[-1])
    cap = moe.capacity(xf.shape[0])
    idx, _, keep, _ = moe.route(xf, env[moe.inputs[0].guid].new_tensor(router), cap, cap)
    gates = jax.nn.softmax(jnp.dot(jnp.asarray(xf.numpy()), jnp.asarray(router)), axis=-1)
    want_idx = np.asarray(jnp.argmax(gates, axis=-1))
    top2 = np.sort(np.asarray(gates), axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-6, "a routing tie within f32 rounding"
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    onehot = np.eye(4, dtype=np.float32)[want_idx]
    pos = np.cumsum(onehot, 0) * onehot
    np.testing.assert_array_equal(keep.numpy(), (pos > 0) & (pos <= cap))
    _train_both(jm, tm, jin, tin, batches)


# ----------------------------------------------------------------- Inception-v3

BLOCKS = [  # (block, input (N, C, H, W), extra builder arguments)
    ("inception_a", (2, 8, 5, 5), (32,)),
    ("inception_b", (2, 8, 7, 7), ()),
    ("inception_c", (2, 8, 5, 5), (16,)),
    ("inception_d", (2, 8, 7, 7), ()),
    ("inception_e", (2, 8, 3, 3), ()),
]


@pytest.mark.parametrize("block,dims,extra", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_inception_block_trains_like_the_jax_package(block, dims, extra):
    def build(mod):
        def b(m):
            x = m.create_tensor(dims, name="input")
            t = getattr(mod, block)(m, x, *extra)
            m.softmax(m.dense(m.flat(t), 10, name="head"))
            return [x]
        return b
    jm, tm, jin, tin = _pair(2, build(inception), build(jax_inception), _sgd(),
                             "sparse_categorical_crossentropy", ["accuracy"])
    assert tm.ops[-4]._type == "Concat" and tm.ops[-4].axis == 3
    rng = np.random.default_rng(5)
    n, c, h, w = dims
    batches = [([rng.standard_normal((n, h, w, c)).astype(np.float32)],
                rng.integers(0, 10, size=(n, 1)).astype(np.int32)) for _ in range(STEPS)]
    _train_both(jm, tm, jin, tin, batches)


def test_inception_v3_graph_matches_the_jax_package():
    """The full-width network of chip_smoke.py, graph only: ops, types,
    output shapes and the parameter tree."""
    graphs = []
    for pkg, build in ((ff, jax_inception.build_inception_v3),
                       (ft, inception.build_inception_v3)):
        extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
        m = pkg.FFModel(pkg.FFConfig(batch_size=128, **extra))
        inp, out = build(m, 128)
        assert inp.dims == (128, 299, 299, 3) and out.dims == (128, 10)
        graphs.append([(o.name, o._type, getattr(o, "axis", None),
                        [t.dims for t in o.inputs], [t.dims for t in o.outputs],
                        [(w.name, w.dims) for w in o.weights]) for o in m.ops])
    assert graphs[0] == graphs[1]
    assert sum(g[1] == "Concat" for g in graphs[1]) == 11
    assert sum(len(g[5]) for g in graphs[1]) == 190
