"""The port's fused optimizer updates vs the JAX package's Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as
tests/test_fused_optimizer.py runs them; the port's wrappers, given CPU
tensors, run their plain PyTorch versions.  Both see the same numpy
inputs.  Tolerance 1e-6 (relative and absolute): the same f32 formulas,
evaluated by two compilers.  The CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py.
"""

import bisect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu.kernels.fused_optimizer import (fused_adam_update as jax_adam,
                                                  fused_sgd_update as jax_sgd)
from flexflow_tpu_torch import optimizers
from flexflow_tpu_torch.kernels import fused_optimizer as fo

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False), (0.9, True)])
@pytest.mark.parametrize("shape", [(7,), (33, 5), (4, 3, 9)])
def test_sgd_matches_pallas(shape, momentum, nesterov):
    rng = np.random.default_rng(0)
    w, g, m = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    lr, wd = 0.05, 1e-4
    w_ref, m_ref = jax_sgd(jnp.asarray(w), jnp.asarray(g), jnp.asarray(m),
                           lr, wd, momentum, nesterov)
    for update in (fo.fused_sgd_update_ref, fo.fused_sgd_update):
        tw, tm = _t(w), _t(m)
        update(tw, _t(g), tm if momentum > 0 else None, lr, wd, momentum, nesterov)
        np.testing.assert_allclose(tw.numpy(), np.asarray(w_ref), **TOL)
        np.testing.assert_allclose(tm.numpy(), np.asarray(m_ref), **TOL)


@pytest.mark.parametrize("shape", [(129,), (16, 40)])
def test_adam_matches_pallas(shape):
    rng = np.random.default_rng(1)
    w, g, m = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(shape)).astype(np.float32)
    alpha_t, wd, b1, b2, eps = 0.01, 1e-4, 0.9, 0.999, 1e-8
    refs = jax_adam(jnp.asarray(w), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
                    alpha_t, wd, b1, b2, eps)
    for update in (fo.fused_adam_update_ref, fo.fused_adam_update):
        tw, tm, tv = _t(w), _t(m), _t(v)
        update(tw, _t(g), tm, tv, alpha_t, wd, b1, b2, eps)
        for got, ref in zip((tw, tm, tv), refs):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (fo.fused_sgd_update.launches, fo.fused_adam_update.launches)
    w = torch.ones(10)
    fo.fused_sgd_update(w, torch.ones(10), torch.zeros(10), 0.1, 0.0, 0.9)
    fo.fused_adam_update(w, torch.ones(10), torch.zeros(10), torch.zeros(10), 0.1)
    assert (fo.fused_sgd_update.launches, fo.fused_adam_update.launches) == before


@pytest.mark.parametrize("bad,err", [
    (lambda: torch.ones(10, dtype=torch.float64), TypeError),
    (lambda: torch.ones(20)[::2], ValueError),
    (lambda: torch.ones(11), ValueError),
])
def test_wrappers_reject_operands_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        fo.fused_sgd_update(torch.ones(10), bad(), torch.zeros(10), 0.1, 0.0, 0.9)
    with pytest.raises(err):
        fo.fused_adam_update(torch.ones(10), torch.ones(10), bad(), torch.zeros(10), 0.1)


# ------------------------------------------------ the multi-tensor SGD step

def _offset_view(a):
    """A copy of ``a`` as a view one element into a larger buffer: contiguous,
    at a storage offset that breaks 16-byte alignment on the card."""
    base = torch.zeros(a.size + 1, dtype=torch.float32)
    view = base[1:].view(a.shape)
    view.copy_(torch.from_numpy(a))
    return view


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False), (0.9, True)])
def test_sgd_multi_matches_pallas_leaf_by_leaf(momentum, nesterov):
    rng = np.random.default_rng(2)
    shapes = [(1,), (7,), (33, 5), (0,), (4, 3, 9), (6, 11)]
    leaves = [tuple(rng.standard_normal(s).astype(np.float32) for _ in range(3))
              for s in shapes]
    lr, wd = 0.05, 1e-4
    refs = [jax_sgd(jnp.asarray(w), jnp.asarray(g), jnp.asarray(m), lr, wd, momentum, nesterov)
            if w.size else (w, m) for w, g, m in leaves]
    for update in (fo.fused_sgd_update_multi_ref, fo.fused_sgd_update_multi):
        # the last leaf's w and m are views at an odd offset
        ws = [_t(w) for w, _, _ in leaves[:-1]] + [_offset_view(leaves[-1][0])]
        ms = [_t(m) for _, _, m in leaves[:-1]] + [_offset_view(leaves[-1][2])]
        gs = [_t(g) for _, g, _ in leaves]
        update(ws, gs, ms if momentum > 0 else None, lr, wd, momentum, nesterov)
        for tw, tm, (w_ref, m_ref), (_, _, m0) in zip(ws, ms, refs, leaves):
            np.testing.assert_allclose(tw.numpy(), np.asarray(w_ref), **TOL)
            # without momentum the buffers are never touched
            np.testing.assert_allclose(tm.numpy(), np.asarray(m_ref) if momentum else m0,
                                       **TOL)


def test_sgd_launch_plan_chunk_starts_and_leaf_of_every_chunk():
    assert fo.SGD_CHUNK == 16384
    numels = [1, 7, 165, 0, 108, 40000, 16384, 16385, 0]
    (plan,) = fo.sgd_launch_plan(numels)
    assert plan == [(0, 0), (1, 1), (2, 2), (4, 3), (5, 4), (6, 7), (7, 8)]
    firsts = [first for _, first in plan]
    total = firsts[-1] + -(-numels[plan[-1][0]] // 16384)
    assert total == 10
    # the kernel's lookup: block b belongs to the last leaf whose first chunk
    # is at or before b; every element is covered once
    covered = {i: 0 for i, _ in plan}
    for b in range(total):
        i, first = plan[bisect.bisect_right(firsts, b) - 1]
        begin = (b - first) * 16384
        assert 0 <= begin < numels[i]
        covered[i] += min(16384, numels[i] - begin)
    assert covered == {i: numels[i] for i, _ in plan}


def test_sgd_launch_plan_splits_at_capacity():
    assert fo.SGD_TABLE_CAPACITY == 64
    numels = [3 + (i % 5) * 20000 for i in range(130)]
    plan = fo.sgd_launch_plan(numels)
    assert [len(launch) for launch in plan] == [64, 64, 2]
    assert [i for launch in plan for i, _ in launch] == list(range(130))
    for launch in plan:
        first = 0
        for i, got in launch:
            assert got == first
            first += -(-numels[i] // fo.SGD_CHUNK)
    # zero-size leaves take no slot
    assert [len(launch) for launch in fo.sgd_launch_plan([0, 5] * 65)] == [64, 1]
    assert fo.sgd_launch_plan([0, 0]) == []


def test_sgd_table_capacity_fits_the_transformer_in_one_launch():
    assert len(fo.sgd_launch_plan([512] * 54)) == 1
    assert fo.SGD_CHUNK % 4 == 0


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_optimizer_fused_makes_one_multi_call_per_step(monkeypatch, momentum):
    calls = []

    def counting(ws, gs, ms, *args):
        calls.append(len(ws))
        fo.fused_sgd_update_multi(ws, gs, ms, *args)

    monkeypatch.setattr(optimizers, "fused_sgd_update_multi", counting)
    opt = optimizers.SGDOptimizer(lr=0.1, momentum=momentum)
    opt.fused = True
    params = {"a": {"kernel": torch.ones(3, 2), "bias": torch.ones(2)},
              "b": {"kernel": torch.ones(5)}}
    grads = {o: {n: torch.full_like(w, 0.5) for n, w in ws.items()} for o, ws in params.items()}
    state = opt.init_state(params)
    for _ in range(3):
        opt.apply(params, grads, state, opt.hparams())
    assert calls == [3, 3, 3]
    # three steps: m = 0.5, 0.5 (1 + mu), 0.5 (1 + mu + mu^2)
    step = 0.1 * 0.5 * (3 + 2 * momentum + momentum ** 2)
    for ws in params.values():
        for w in ws.values():
            torch.testing.assert_close(w, torch.full_like(w, 1.0 - step), **TOL)


@pytest.mark.parametrize("args,err", [
    (lambda: ([torch.ones(3)], [torch.ones(3), torch.ones(3)], None, 0.0), ValueError),
    (lambda: ([torch.ones(3)], [torch.ones(3)], None, 0.9), ValueError),
    (lambda: ([torch.ones(3)], [torch.ones(3, dtype=torch.float64)], None, 0.0), TypeError),
])
def test_sgd_multi_rejects_leaf_lists_the_kernel_does_not_take(args, err):
    ws, gs, ms, momentum = args()
    with pytest.raises(err):
        fo.fused_sgd_update_multi(ws, gs, ms, 0.1, 0.0, momentum)


def test_sgd_multi_on_cpu_counts_no_launch():
    before = fo.fused_sgd_update.launches
    fo.fused_sgd_update_multi([torch.ones(4), torch.ones(2)], [torch.ones(4), torch.ones(2)],
                              None, 0.1)
    assert fo.fused_sgd_update.launches == before
