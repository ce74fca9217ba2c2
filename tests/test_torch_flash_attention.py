"""The port's flash attention vs the JAX package's on the CPU.

The port's ``flash_attention`` on CPU tensors runs its wrappers' plain
versions through its ``torch.autograd.Function``; the JAX package's Pallas
kernels run in interpret mode off a TPU (flash_attention.py:33-34 there).
Both see the same numpy inputs, (2, 2, S, 64) float32, with the JAX kernel
at 64-row blocks: S = 128 is a multiple of the block, S = 96 is not (the
JAX wrapper then falls back to gcd blocks of 32, the port's kernels mask a
ragged tile); with Sq != Sk (128/192 and 192/128) both mask top-left.
Tolerance rtol 1e-4, atol 1e-5: the same f32 formulas, summed in
different orders.

The lse cotangent is held against ``jax.grad`` through
``flexflow_tpu.parallel.sequence.blockwise_attention``, never against the
JAX flash VJP, which drops it (ROADMAP C1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_tpu.kernels.flash_attention import flash_attention as jax_flash
from flexflow_tpu.kernels.flash_attention import mha_reference as jax_mha_reference
from flexflow_tpu.parallel.sequence import blockwise_attention
from flexflow_tpu_torch.kernels import flash_attention as fa

TOL = dict(rtol=1e-4, atol=1e-5)
B, H, D, BLOCK = 2, 2, 64, 64


@pytest.fixture(autouse=True, scope="module")
def _compiled_here():
    """The JAX kernels this file holds the port to are compiled in this
    process: JAX's in-memory caches start empty and the persistent compile
    cache that every test worker shares (tests/conftest.py) is off while
    the file runs, so no executable another process wrote, or is writing,
    stands in for the reference."""
    was = jax.config.jax_enable_compilation_cache
    jax.clear_caches()
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", was)


def _inputs(seq, seed, sk=None, d=D):
    rng = np.random.default_rng(seed)
    sk = seq if sk is None else sk
    q = rng.standard_normal((B, H, seq, d)).astype(np.float32)
    k = rng.standard_normal((B, H, sk, d)).astype(np.float32)
    v = rng.standard_normal((B, H, sk, d)).astype(np.float32)
    ct = rng.standard_normal((B, H, seq, d)).astype(np.float32)
    ct_lse = rng.standard_normal((B, H, seq)).astype(np.float32)
    return q, k, v, ct, ct_lse


def _port(q, k, v, causal, ct, ct_lse=None):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o, lse = fa.flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    loss = (o * torch.from_numpy(ct)).sum()
    if ct_lse is not None:
        loss = loss + (lse * torch.from_numpy(ct_lse)).sum()
    loss.backward()
    return (o.detach().numpy(), lse.detach().numpy(),
            *(t.grad.numpy() for t in (tq, tk, tv)))


def _assert_matches_the_jax_kernel(q, k, v, ct, causal):
    jq, jk, jv, jct = map(jnp.asarray, (q, k, v, ct))
    jo, jlse = jax_flash(jq, jk, jv, causal=causal, block_q=BLOCK, block_k=BLOCK,
                         return_lse=True)

    def loss(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, causal=causal, block_q=BLOCK,
                                 block_k=BLOCK) * jct)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    o, lse, dq, dk, dv = _port(q, k, v, causal, ct)
    np.testing.assert_allclose(o, np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse, np.asarray(jlse), **TOL)
    for got, ref, name in zip((dq, dk, dv), jgrads, "qkv"):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 96])
def test_flash_matches_the_jax_kernel(seq, causal):
    _assert_matches_the_jax_kernel(*_inputs(seq, seed=seq + causal)[:4], causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(128, 192), (192, 128)])
def test_flash_matches_the_jax_kernel_when_sq_differs_from_sk(sq, sk, causal):
    """Both mask top-left (q_idx >= k_idx) when Sq != Sk, so ROADMAP C2
    (the references' bottom-right mask) does not apply."""
    _assert_matches_the_jax_kernel(*_inputs(sq, seed=sq + sk + causal, sk=sk)[:4], causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 96])
def test_head_dim_16_matches_the_jax_kernel(seq, causal):
    """D = 16, the head dim of the JAX package's transformer_4d and
    transformer_generate examples (ROADMAP C4): forward and gradients."""
    _assert_matches_the_jax_kernel(*_inputs(seq, seed=seq + causal + 16, d=16)[:4], causal)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_cotangent_matches_blockwise_attention(causal):
    """d(sum(O*ct) + sum(lse*ct_lse)) through the port's backward against
    jax.grad of the plain blockwise path (top-left causal, as the port)."""
    _assert_lse_cotangent_matches_blockwise_attention(*_inputs(96, seed=7 + causal), causal)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_cotangent_matches_blockwise_attention_at_head_dim_16(causal):
    _assert_lse_cotangent_matches_blockwise_attention(*_inputs(96, seed=23 + causal, d=16),
                                                      causal)


def _assert_lse_cotangent_matches_blockwise_attention(q, k, v, ct, ct_lse, causal):
    jq, jk, jv, jct, jcl = map(jnp.asarray, (q, k, v, ct, ct_lse))

    def loss(q_, k_, v_):
        o, lse = blockwise_attention(q_, k_, v_, causal=causal)
        return jnp.sum(o * jct) + jnp.sum(lse * jcl)

    jo, jlse = blockwise_attention(jq, jk, jv, causal=causal)
    jgrads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    o, lse, dq, dk, dv = _port(q, k, v, causal, ct, ct_lse)
    np.testing.assert_allclose(o, np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse, np.asarray(jlse), **TOL)
    for got, ref, name in zip((dq, dk, dv), jgrads, "qkv"):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL, err_msg=f"d{name}")
    # the lse term is not negligible: without it dq moves by far more than TOL
    _, _, dq0, _, _ = _port(q, k, v, causal, ct)
    assert np.abs(dq - dq0).max() > 1e-2


def test_backward_wrappers_take_the_lse_cotangent_as_none_or_zero():
    q, k, v, ct, _ = (torch.from_numpy(a) for a in _inputs(64, seed=3))
    o, lse = fa.flash_fwd(q, k, v, 0.125, True)
    delta = (o * ct).sum(-1)
    zero = torch.zeros_like(lse)
    for a, b in zip(fa.flash_bwd_dkdv(q, k, v, ct, lse, delta, None, 0.125, True),
                    fa.flash_bwd_dkdv(q, k, v, ct, lse, delta, zero, 0.125, True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(fa.flash_bwd_dq(q, k, v, ct, lse, delta, None, 0.125, True),
                               fa.flash_bwd_dq(q, k, v, ct, lse, delta, zero, 0.125, True),
                               rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches_the_jax_reference(causal):
    """Sq != Sk: both references mask bottom-right when causal (ROADMAP C2)."""
    q, k, v, _, _ = _inputs(32, seed=11, sk=48)
    got = fa.mha_reference(*map(torch.from_numpy, (q, k, v)), causal=causal)
    ref = jax_mha_reference(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_flash_matches_mha_reference_in_bfloat16():
    q, k, v, _, _ = (torch.from_numpy(a).bfloat16() for a in _inputs(80, seed=5))
    o = fa.flash_attention(q, k, v, causal=True)
    assert o.dtype == torch.bfloat16
    # bf16 output rounding: one ulp of values of order 1 is 2**-8
    torch.testing.assert_close(o.float(), fa.mha_reference(q, k, v, causal=True).float(),
                               rtol=1e-2, atol=1e-2)


def test_a_row_with_no_key_gives_zero_and_the_empty_lse():
    q = torch.randn(1, 1, 4, 32)
    o, lse = fa.flash_fwd(q, q[:, :, :0], q[:, :, :0], 1.0, False)
    assert torch.equal(o, torch.zeros_like(q))
    assert torch.equal(lse, torch.full((1, 1, 4), fa.NEG_INF))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    q, k, v, ct, _ = _inputs(64, seed=2)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dkdv.launches, fa.flash_bwd_dq.launches)
    got = _port(q, k, v, True, ct)
    with fa.plain_versions():
        plain = _port(q, k, v, True, ct)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dkdv.launches,
            fa.flash_bwd_dq.launches) == before
    assert not fa._plain


@pytest.mark.parametrize("bad,err", [
    (lambda q: q.half(), TypeError),
    (lambda q: q.double(), TypeError),
    (lambda q: q.transpose(2, 3).contiguous().transpose(2, 3), ValueError),
    (lambda q: q[:, :, :, :32], ValueError),
    (lambda q: q[0], ValueError),
])
def test_wrappers_reject_operands_the_kernels_do_not_take(bad, err):
    q = torch.randn(1, 2, 64, 64)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(err):
        fa.flash_fwd(q, bad(q), q, 0.125, False)
    with pytest.raises(err):
        fa.flash_bwd_dkdv(q, q, q, bad(q), lse, lse, None, 0.125, False)
    with pytest.raises(err):
        fa.flash_bwd_dq(q, bad(q), q, q, lse, lse, None, 0.125, False)
    with pytest.raises(ValueError):
        fa.flash_bwd_dq(q, q, q, q, lse, lse[..., :8], None, 0.125, False)


@pytest.mark.parametrize("d,ok", [(16, True), (32, True), (64, True), (128, True),
                                  (48, False), (8, False), (256, False)])
def test_kernel_head_dims(d, ok):
    """The head dims compiled into the kernels; any other raises before a
    launch (the plain versions on the CPU take any)."""
    q = torch.zeros(1, 1, 4, d)
    if ok:
        fa.check_kernel_operands(q, q)
    else:
        with pytest.raises(ValueError, match="head dim"):
            fa.check_kernel_operands(q, q)


def test_kernels_refuse_misaligned_operands():
    """The bf16 kernels copy rows in 16-byte words: a view 4 bytes off
    alignment is refused before a launch."""
    flat = torch.zeros(1 + 4 * 64)
    q = flat[1:].view(1, 1, 4, 64)
    assert q.is_contiguous() and q.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="aligned"):
        fa.check_kernel_operands(torch.zeros(1, 1, 4, 64), q)
