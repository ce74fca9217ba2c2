"""The port's fused optimizer updates vs the JAX package's Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as
tests/test_fused_optimizer.py runs them; the port's wrappers, given CPU
tensors, run their plain PyTorch versions.  Both see the same numpy
inputs.  Tolerance 1e-6 (relative and absolute): the same f32 formulas,
evaluated by two compilers.  The CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu.kernels.fused_optimizer import (fused_adam_update as jax_adam,
                                                  fused_sgd_update as jax_sgd)
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
