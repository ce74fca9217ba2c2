"""The transformer slice end to end: the port vs the JAX package on the CPU.

``build_transformer`` at batch 2, sequence 16, 2 layers, embed 32, 4 heads
and vocab 64, float32, is built in both packages.  The JAX model's initial
weights are carried into the port with ``convert.load_jax_params``; both
then train 3 SGD-momentum steps on ``synthetic_lm_batch`` (one numpy seed
per step).  Per-step loss, the drained per-token metrics and every weight
must agree within rtol 1e-4, atol 1e-5: XLA and PyTorch sum products in
different orders.

The JAX side runs its CPU attention path, ``blockwise_attention``
(ops/attention.py:150-153 of the JAX package), and its plain optimizer
update.  The port side runs ``fused_optimizer=True`` and its flash
attention, which on CPU tensors are the kernels' plain versions.  Both
mask causally with the same convention, since Sq == Sk.
"""

import numpy as np
import pytest
import torch

import jax

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.models.transformer import build_transformer as jax_build_transformer
from flexflow_tpu.models.transformer import synthetic_lm_batch as jax_lm_batch
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch

TOL = dict(rtol=1e-4, atol=1e-5)
BATCH, SEQ, LAYERS, EMBED, HEADS, VOCAB, STEPS = 2, 16, 2, 32, 4, 64, 3
SHAPE = dict(seq_length=SEQ, num_layers=LAYERS, embed_dim=EMBED, num_heads=HEADS,
             vocab_size=VOCAB)
METRICS = ["accuracy", "sparse_categorical_crossentropy"]


def _optimizer(pkg, model):
    return pkg.SGDOptimizer(model, lr=0.05, momentum=0.9, weight_decay=1e-4)


def _build_jax():
    m = ff.FFModel(ff.FFConfig(batch_size=BATCH, workers_per_node=1,
                               compute_dtype="float32"))
    tok, pos, _ = jax_build_transformer(m, BATCH, **SHAPE)
    m.compile(_optimizer(ff, m), "sparse_categorical_crossentropy", METRICS,
              machine=ff.Machine(devices=jax.devices()[:1]))
    m.init_layers(seed=0)
    return m, tok, pos


def _build_port(jax_model):
    m = ft.FFModel(ft.FFConfig(batch_size=BATCH, device="cpu", compute_dtype="float32",
                               fused_optimizer=True))
    tok, pos, _ = build_transformer(m, BATCH, **SHAPE)
    m.compile(_optimizer(ft, m), "sparse_categorical_crossentropy", METRICS)
    m.init_layers(seed=1)
    load_jax_params(m, jax_params_to_numpy(jax_model))
    return m, tok, pos


def _train(model, tok, pos, make_batch):
    losses = []
    for step in range(STEPS):
        toks, posa, labels = make_batch(BATCH, SEQ, VOCAB, seed=10 + step)
        model.set_batch({tok: toks, pos: posa}, labels)
        model.train_iteration()
        model.get_metrics()
        losses.append(model.last_loss)
    return losses, model.get_metrics()


def test_synthetic_lm_batch_matches_the_jax_recipe():
    for a, b in zip(synthetic_lm_batch(3, 7, 50, seed=4), jax_lm_batch(3, 7, 50, seed=4)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_transformer_trains_like_the_jax_package():
    jm, jtok, jpos = _build_jax()
    tm, ttok, tpos = _build_port(jm)
    assert [(op.name, [w.dims for w in op.weights]) for op in jm.ops] == \
        [(op.name, [w.dims for w in op.weights]) for op in tm.ops]
    params0 = jax_params_to_numpy(jm)

    j_losses, j_metrics = _train(jm, jtok, jpos, jax_lm_batch)
    t_losses, t_metrics = _train(tm, ttok, tpos, synthetic_lm_batch)

    np.testing.assert_allclose(t_losses, j_losses, **TOL)
    assert t_metrics.train_all == j_metrics.train_all == BATCH * SEQ * STEPS
    assert t_metrics.train_correct == j_metrics.train_correct
    np.testing.assert_allclose(t_metrics.sparse_cce_loss, j_metrics.sparse_cce_loss, **TOL)
    for opn, ws in params0.items():
        for wn, w0 in ws.items():
            got = tm.get_parameter(opn, wn)
            assert not np.array_equal(got, w0), f"{opn}/{wn} never moved"
            np.testing.assert_allclose(got, jm.get_parameter(opn, wn), **TOL,
                                       err_msg=f"{opn}/{wn}")
    np.testing.assert_allclose(tm._opt_state["v"]["attn_0"]["wq"].numpy(),
                               np.asarray(jm._opt_state["v"]["attn_0"]["wq"]), **TOL)


def test_port_attention_goes_through_the_flash_wrappers(monkeypatch):
    """On the CPU the wrappers run their plain versions and count no
    launch; the model's attention still reaches them, forward and
    backward, once per layer."""
    names = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
    calls = dict.fromkeys(names, 0)
    launches = [getattr(fa, n).launches for n in names]
    for name in names:
        def wrapped(*a, _name=name, _fn=getattr(fa, name)):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(fa, name, wrapped)

    m = ft.FFModel(ft.FFConfig(batch_size=BATCH, device="cpu"))
    tok, pos, _ = build_transformer(m, BATCH, **SHAPE)
    m.compile(ft.SGDOptimizer(m, lr=0.01), "sparse_categorical_crossentropy", METRICS)
    m.init_layers(seed=0)
    toks, posa, labels = synthetic_lm_batch(BATCH, SEQ, VOCAB, seed=0)
    m.set_batch({tok: toks, pos: posa}, labels)
    m.train_iteration()
    monkeypatch.undo()
    assert calls == dict.fromkeys(names, LAYERS)
    assert [getattr(fa, n).launches for n in names] == launches


def test_transformer_parameter_count_at_full_width():
    """The full-width transformer of chip_smoke.py: 45,664,512 parameters
    in 54 leaves in both packages (graph only, nothing initialized)."""
    jm = ff.FFModel(ff.FFConfig(batch_size=16, workers_per_node=1))
    jax_build_transformer(jm, 16, seq_length=512)
    tm = ft.FFModel(ft.FFConfig(batch_size=16, device="cpu"))
    build_transformer(tm, 16, seq_length=512)
    for m in (jm, tm):
        leaves = [w.dims for op in m.ops for w in op.weights]
        assert len(leaves) == 54
        assert sum(int(np.prod(d)) for d in leaves) == 45_664_512


def test_unported_transformer_options_raise():
    """The MoE blocks build (ops/moe.py) and decode (dropless routing);
    their expert split is ported too (tests/test_torch_soap_space.py trains
    it on gloo ranks): the op accepts it.  Attention dropout is ported: the
    transformer trains with it."""
    m = ft.FFModel(ft.FFConfig(batch_size=BATCH, device="cpu"))
    build_transformer(m, BATCH, moe_every=2, **SHAPE)
    assert [op.name for op in m.ops if op._type == "ExpertMLP"] == ["moe_1"]
    # compile runs this check on every op's resolved config (a mesh of two
    # or more devices; tests/test_torch_soap.py drives it on gloo ranks)
    next(op for op in m.ops if op.name == "moe_1").check_config(ft.ParallelConfig(dims=(1, 2, 1)))
    next(op for op in m.ops if op.name == "moe_1").check_config(ft.ParallelConfig(dims=(2, 1, 1)))
    # one token decoded is the token's forward (a capacity of 1 keeps it)
    m.compile(_optimizer(ft, m), "sparse_categorical_crossentropy", METRICS)
    m.init_layers(seed=0)
    moe = next(op for op in m.ops if op.name == "moe_1")
    params = {k: v.detach() for k, v in m._params["moe_1"].items()}
    x = torch.randn(1, 1, EMBED, generator=torch.Generator().manual_seed(0))
    ys, cache = moe.decode(params, [x], None, torch.tensor(3), None)
    assert cache is None
    torch.testing.assert_close(ys[0], moe.forward(params, [x], None)[0], rtol=1e-5, atol=1e-6)
    dm = ft.FFModel(ft.FFConfig(batch_size=BATCH, device="cpu"))
    tok, pos, _ = build_transformer(dm, BATCH, dropout=0.1, **SHAPE)
    dm.compile(_optimizer(ft, dm), "sparse_categorical_crossentropy", METRICS)
    dm.init_layers(seed=0)
    toks, posa, labels = synthetic_lm_batch(BATCH, SEQ, VOCAB, seed=0)
    dm.set_batch({tok: toks, pos: posa}, labels)
    dm.train_iteration()
    assert np.isfinite(dm.get_metrics().sparse_cce_loss)
    assert all(op.draws_random for op in dm.ops if op._type == "MultiHeadAttention")
