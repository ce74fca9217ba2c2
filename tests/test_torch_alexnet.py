"""The AlexNet slice end to end: the port vs the JAX package on the CPU.

``build_alexnet(height=63, width=63)`` (63 is the smallest input that
survives the three pools; fc1 is then 256->4096), batch 4, float32.  The
JAX model's initial weights are carried into the port with
``convert.load_jax_params``; both then train on the same synthetic batch
(``DataLoader.synthetic``, one numpy seed) for 3 SGD-momentum steps, and
separately 3 Adam steps with ``next_epoch()`` before the second.  Per-step
loss, the drained ``PerfMetrics`` and every weight (and Adam's moments)
must agree within rtol 1e-4, atol 1e-5: XLA and PyTorch sum convolutions
and products in different orders.

The JAX side takes its plain update (``fused_optimizer=False``; its Pallas
kernels are pinned to that path by tests/test_fused_optimizer.py).  The
port side runs ``fused_optimizer=True``, which on CPU tensors is the
kernels' plain versions.

Adam uses alpha 1e-4.  Its first step is uncorrected (alpha_t = alpha),
so every weight moves by about 3*alpha whatever its gradient; at 1e-3 the
loss jumps by an order of magnitude on the second step, where rounding
differences between the two frameworks grow past any fixed tolerance.
"""

import numpy as np
import pytest

import jax

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.models.alexnet import build_alexnet as jax_build_alexnet
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
from flexflow_tpu_torch.models.alexnet import build_alexnet

TOL = dict(rtol=1e-4, atol=1e-5)
BATCH, SIDE, STEPS = 4, 63, 3
METRICS = ["accuracy", "sparse_categorical_crossentropy"]


def _optimizer(pkg, name, model):
    if name == "sgd":
        return pkg.SGDOptimizer(model, lr=0.01, momentum=0.9, weight_decay=1e-4)
    return pkg.AdamOptimizer(model, alpha=1e-4, weight_decay=1e-4)


def _build_jax(opt_name):
    m = ff.FFModel(ff.FFConfig(batch_size=BATCH, workers_per_node=1))
    inp, _ = jax_build_alexnet(m, BATCH, height=SIDE, width=SIDE)
    m.compile(_optimizer(ff, opt_name, m), "sparse_categorical_crossentropy", METRICS,
              machine=ff.Machine(devices=jax.devices()[:1]))
    m.init_layers(seed=0)
    return m, inp


def _build_port(opt_name, jax_model):
    m = ft.FFModel(ft.FFConfig(batch_size=BATCH, device="cpu", fused_optimizer=True))
    inp, _ = build_alexnet(m, BATCH, height=SIDE, width=SIDE)
    m.compile(_optimizer(ft, opt_name, m), "sparse_categorical_crossentropy", METRICS)
    assert m.optimizer.fused
    m.init_layers(seed=1)
    load_jax_params(m, jax_params_to_numpy(jax_model))
    return m, inp


def _train(model, inp, pkg):
    dl = pkg.DataLoader.synthetic(model, inp, num_samples=BATCH, seed=5)
    losses = []
    for step in range(STEPS):
        if step == 1:
            model.optimizer.next_epoch()
        dl.next_batch(model)
        model.train_iteration()
        model.get_metrics()
        losses.append(model.last_loss)
    return losses, model.get_metrics()


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_alexnet_trains_like_the_jax_package(opt_name):
    jm, jinp = _build_jax(opt_name)
    tm, tinp = _build_port(opt_name, jm)
    params0 = jax_params_to_numpy(jm)
    assert sum(a.size for ws in params0.values() for a in ws.values()) == \
        sum(w.numel() for ws in tm._params.values() for w in ws.values())

    j_losses, j_metrics = _train(jm, jinp, ff)
    t_losses, t_metrics = _train(tm, tinp, ft)

    np.testing.assert_allclose(t_losses, j_losses, **TOL)
    assert t_metrics.train_all == j_metrics.train_all == BATCH * STEPS
    assert t_metrics.train_correct == j_metrics.train_correct
    np.testing.assert_allclose(t_metrics.sparse_cce_loss, j_metrics.sparse_cce_loss, **TOL)
    for opn, ws in params0.items():
        for wn, w0 in ws.items():
            got = tm.get_parameter(opn, wn)
            assert not np.array_equal(got, w0) or not np.any(w0), f"{opn}/{wn} never moved"
            np.testing.assert_allclose(got, jm.get_parameter(opn, wn), **TOL,
                                       err_msg=f"{opn}/{wn}")
    for slot, tree in jm._opt_state.items():
        for opn, ws in tree.items():
            for wn, ref in ws.items():
                np.testing.assert_allclose(tm._opt_state[slot][opn][wn].numpy(),
                                           np.asarray(ref), **TOL,
                                           err_msg=f"{slot}:{opn}/{wn}")


def test_load_jax_params_carries_optimizer_state():
    jm, _ = _build_jax("adam")
    tm, _ = _build_port("adam", jm)
    rng = np.random.default_rng(0)
    state = {slot: {"fc3": {"bias": rng.standard_normal(10).astype(np.float32)}}
             for slot in ("m", "v")}
    load_jax_params(tm, {}, state)
    for slot in ("m", "v"):
        np.testing.assert_array_equal(tm._opt_state[slot]["fc3"]["bias"].numpy(),
                                      state[slot]["fc3"]["bias"])
    with pytest.raises(KeyError):
        load_jax_params(tm, {}, {"momentum": {}})
