"""Sequence-parallel attention: the port's ring and Ulysses against the
JAX package on the CPU.

* ``blockwise_attention`` and ``_merge_partials`` against the JAX
  package's at tests/test_sequence_parallel.py's shapes (B2 H4 S64 D16,
  float32, causal offsets), atol 1e-5; a merge with rows that saw no keys.
* The ring in one process, rank by rank (``ring_rank_attention``), on
  the blockwise path (``use_flash=False``) and through the flash kernels'
  plain versions: its blocks are merged by the lse the
  forward returns, so the backward's lse cotangent is not zero, and the
  gradient equals ``mha_reference`` autodiff (ROADMAP C1: the JAX
  package's flash VJP drops that term) within atol 1e-5, and differs from
  it when the backward drops the term.
* The cost model measures a sequence part as the ring's last rank
  computes it: its q rows against every K/V block, equal to those rows of
  the whole op's output.
* One job of 4 gloo ranks (tests/test_torch_soap.py's harness; a (2, 2)
  mesh whose two dims form one flattened ring):
  - ring and Ulysses attention, causal and not, each rank holding its
    sequence block: the output against the JAX package's
    ``sequence_parallel_attention`` on its 2x4 CPU mesh (dp 2, sp 4),
    atol 1e-4; q/k/v gradients against ``jax.grad`` of the JAX package's
    ``mha_reference``, atol 1e-3 (Ulysses causal too, which the JAX
    package's test skips);
  - the transformer of tests/test_torch_transformer.py (batch 2, S 16,
    2 layers, E 32, 4 heads, vocab 64) with every attention op's sequence
    split 4 ways, 2 SGD-momentum steps as a ring and as Ulysses: every
    weight within rtol 1e-4, atol 1e-5 of the JAX package trained under
    the same strategy on 4 CPU devices (its ring; Ulysses computes the
    same function);
  - cross-attention (Sq 16, Sk 8) under a sequence split: one step and a
    forward equal the single device's (each part reads the whole K/V);
  - ``compile(search_budget=300)`` on that transformer, whose search
    splits an attention op's sequence: every rank gets the same configs,
    and one step trains under them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import flexflow_tpu as ff
from flexflow_tpu.kernels.flash_attention import mha_reference as jax_mha_reference
from flexflow_tpu.models.transformer import build_transformer as jax_build_transformer
from flexflow_tpu.models.transformer import synthetic_lm_batch as jax_lm_batch
from flexflow_tpu.parallel import sequence as jseq
from flexflow_tpu_torch.convert import jax_params_to_numpy
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.parallel import sequence as seq
from test_torch_soap import _PRELUDE, _launch

B, H, S, D = 2, 4, 64, 16
WORLD = 4
BLOCK_TOL = dict(rtol=0, atol=1e-5)
FWD_TOL = dict(rtol=0, atol=1e-4)
GRAD_TOL = dict(rtol=0, atol=1e-3)
LM = dict(seq_length=16, num_layers=2, embed_dim=32, num_heads=4, vocab_size=64)
LM_BATCH, LM_STEPS = 2, 2
LM_TOL = dict(rtol=1e-4, atol=1e-5)
SEARCH_BUDGET = 300


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(4)]


def test_blockwise_attention_matches_jax():
    q, k, v, _ = _qkv(0)
    for causal, qo, ko in ((False, 0, 0), (True, 0, 0), (True, 32, 0), (True, 0, 32)):
        got = seq.blockwise_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                      q_offset=qo, k_offset=ko)
        want = jseq.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                        q_offset=qo, k_offset=ko)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **BLOCK_TOL)


def test_merge_partials_matches_jax_with_rows_that_saw_no_keys():
    q, k, v, _ = _qkv(1)
    half = S // 2
    parts = []
    for pkg, conv in ((seq, torch.from_numpy), (jseq, jnp.asarray)):
        # the second block lies after the first half of the q rows: those
        # rows see no key of it (lse NEG_INF)
        o1, l1 = pkg.blockwise_attention(conv(q), conv(k[:, :, :half]), conv(v[:, :, :half]),
                                         causal=True, k_offset=0)
        o2, l2 = pkg.blockwise_attention(conv(q), conv(k[:, :, half:]), conv(v[:, :, half:]),
                                         causal=True, k_offset=half)
        parts.append(pkg._merge_partials(o1, l1, o2, l2))
    (o, lse), (jo, jlse) = parts
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **BLOCK_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6, atol=1e-5)
    ref = jax_mha_reference(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), **BLOCK_TOL)


def _ring_in_one_process(q, k, v, causal, use_flash=True):
    n = WORLD
    return torch.cat([seq.ring_rank_attention(qb.contiguous(), k, v, i, n, causal=causal,
                                              use_flash=use_flash)
                      for i, qb in enumerate(q.chunk(n, dim=2))], dim=2)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_on_the_blockwise_path_matches_reference_autodiff(causal):
    """``use_flash=False``: each block is ``blockwise_attention`` with the
    blocks' offsets (the JAX package's jnp path), masked blocks included."""
    q, k, v, ct = (torch.from_numpy(a).requires_grad_() for a in _qkv(4))
    out = _ring_in_one_process(q, k, v, causal, use_flash=False)
    g = torch.autograd.grad((out * ct).sum(), (q, k, v))
    ref = fa.mha_reference(q, k, v, causal=causal)
    gr = torch.autograd.grad((ref * ct).sum(), (q, k, v))
    torch.testing.assert_close(out, ref, **BLOCK_TOL)
    for a, b in zip(g, gr):
        torch.testing.assert_close(a, b, **BLOCK_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradient_through_the_lse_cotangent_matches_reference_autodiff(causal,
                                                                            monkeypatch):
    q, k, v, ct = map(torch.from_numpy, _qkv(2))
    g_lse_seen = []
    backward = fa._Flash.backward

    def watch(ctx, do, g_lse):
        g_lse_seen.append(g_lse is not None and bool(g_lse.abs().max() > 0))
        return backward(ctx, do, g_lse)

    monkeypatch.setattr(fa._Flash, "backward", staticmethod(watch))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        return out, torch.autograd.grad((out * ct).sum(), leaves)

    out, g = grads(lambda a, b, c: _ring_in_one_process(a, b, c, causal))
    ref, gr = grads(lambda a, b, c: fa.mha_reference(a, b, c, causal=causal))
    # 4 diagonal blocks and 6 earlier ones causal, 16 blocks otherwise, each a
    # flash call whose lse feeds a merge; only causal rank 0's diagonal block
    # merges with nothing but masked blocks, and its lse cotangent is zero
    assert len(g_lse_seen) == (10 if causal else 16)
    assert sum(g_lse_seen) == (9 if causal else 16)
    torch.testing.assert_close(out, ref, **BLOCK_TOL)
    for a, b in zip(g, gr):
        torch.testing.assert_close(a, b, **BLOCK_TOL)
    # the term matters: a backward that drops it gives other gradients
    monkeypatch.setattr(fa._Flash, "backward",
                        staticmethod(lambda ctx, do, g_lse: backward(ctx, do, None)))
    _, dropped = grads(lambda a, b, c: _ring_in_one_process(a, b, c, causal))
    assert max((a - b).abs().max().item() for a, b in zip(dropped, gr)) > 1e-2


@pytest.mark.parametrize("causal", [False, True])
def test_the_cost_model_times_a_sequence_part_as_the_rings_last_rank(causal, tmp_path):
    """A sequence part is measured on its q rows against the whole K/V, as
    ``input_ranges`` says, computed as the ring's last rank computes them
    (block by block, merged): no causal call with Sq != Sk (ROADMAP C2)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.ops.base import FwdCtx
    from flexflow_tpu_torch.simulator.cost_model import CostModel
    from flexflow_tpu_torch.simulator.machine import H100MachineModel

    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    x = m.create_tensor((2, 16, 32), nchw=False)
    m.multihead_attention(x, num_heads=4, causal=causal)
    op = m.ops[0]
    m.compile(ft.SGDOptimizer(lr=0.1), "mean_squared_error", [])
    m.init_layers(seed=0)
    pc = op.legalize_pc(ft.ParallelConfig(dims=(1, 4, 1)))
    assert op.part_input_shapes(pc) == [(2, 4, 32), (2, 16, 32), (2, 16, 32)]
    cost = CostModel(H100MachineModel(num_devices=4), measure=True, device="cpu",
                     target_platform="cpu", cache_path=str(tmp_path / "c.json"))
    assert cost.op_time(op, pc, "forward") > 0 and cost.stats["measured_runs"] == 1
    params = {k: v.detach() for k, v in m._params[op.name].items()}
    xs = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(0))
    part = op.part_forward(pc)(params, [xs[:, 12:], xs, xs], FwdCtx())
    torch.testing.assert_close(part, op.forward(params, [xs] * 3, FwdCtx())[0][:, 12:],
                               **BLOCK_TOL)


_SEQ = _PRELUDE + r"""
import torch.distributed as tdist
from flexflow_tpu_torch.parallel.sequence import sequence_parallel_attention
from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch
machine = ft.Machine.from_process_group(torch.device("cpu"))
world = job["world"]
names = machine.axes_for_degrees((1, world, 1))[1]
out["seq_group"] = (names, tdist.get_process_group_ranks(machine.group(names)))
data = np.load(job["data"])
q, k, v, ct = (torch.from_numpy(data[n]) for n in ("q", "k", "v", "ct"))
s = q.shape[2] // world
blk = lambda t: t[:, :, rank * s:(rank + 1) * s].contiguous()
for mode in ("ring", "ulysses"):
    for causal in (False, True):
        ql, kl, vl = (blk(t).requires_grad_() for t in (q, k, v))
        o = sequence_parallel_attention(ql, kl, vl, machine, (1, world, 1), causal=causal,
                                        mode=mode)
        (o * blk(ct)).sum().backward()
        out[f"{mode}_{causal}"] = [t.detach().numpy() for t in (o, ql.grad, kl.grad, vl.grad)]
lm = job["lm"]
for mode in ("ring", "ulysses"):
    m = ft.FFModel(ft.FFConfig(batch_size=job["batch"], device="cpu", compute_dtype="float32",
                               fused_optimizer=True))
    tok, pos, _ = build_transformer(m, job["batch"], **lm)
    attn = [op for op in m.ops if op._type == "MultiHeadAttention"]
    for op in attn:
        op.seq_parallel_mode = mode
    m.config.strategies = {op.name: ft.ParallelConfig(dims=(1, world, 1)) for op in attn}
    m.compile(ft.SGDOptimizer(m, lr=0.05, momentum=0.9, weight_decay=1e-4),
              "sparse_categorical_crossentropy", ["accuracy", "sparse_categorical_crossentropy"])
    m.init_layers(seed=9)
    load_jax_params(m, params0)
    losses = []
    for step in range(job["steps"]):
        toks, posa, labels = synthetic_lm_batch(job["batch"], lm["seq_length"],
                                                lm["vocab_size"], seed=10 + step)
        m.set_batch({tok: toks, pos: posa}, labels)
        m.train_iteration()
        m.get_metrics()
        losses.append(m.last_loss)
    out[mode] = dict(
        weights={(op.name, w.name): m.get_parameter(op.name, w.name)
                 for op in m.ops for w in op.weights},
        pcs={op.name: op.pc.dims for op in attn}, losses=losses)
# cross-attention (Sq != Sk) under a sequence split: q's rows split, K/V whole
def cross(strategies):
    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu", compute_dtype="float32",
                               strategies=strategies))
    q_in = m.create_tensor((2, 16, 32), nchw=False)
    kv_in = m.create_tensor((2, 8, 32), nchw=False)
    m.multihead_attention(q_in, kv_in, kv_in, num_heads=4, name="xattn")
    m.compile(ft.SGDOptimizer(m, lr=0.1), "mean_squared_error", [])
    m.init_layers(seed=5)
    rng = np.random.default_rng(6)
    m.set_batch({q_in: rng.standard_normal((2, 16, 32), dtype=np.float32),
                 kv_in: rng.standard_normal((2, 8, 32), dtype=np.float32)},
                rng.standard_normal((2, 16, 32), dtype=np.float32))
    m.train_iteration()
    return m
m = cross({"xattn": ft.ParallelConfig(dims=(1, world, 1))})
out["cross"] = dict(pc=m.ops[0].pc.dims, probs=m.predict_batch(),
                    wq=m.get_parameter("xattn", "wq"))
# the strategy search through compile on these 4 ranks: whatever configs
# it proposes (sequence splits among them), the step accepts and trains
m = ft.FFModel(ft.FFConfig(batch_size=job["batch"], device="cpu", compute_dtype="float32",
                           search_budget=job["budget"], seed=1))
tok, pos, _ = build_transformer(m, job["batch"], **lm)
m.compile(ft.SGDOptimizer(m, lr=0.05), "sparse_categorical_crossentropy", ["accuracy"])
m.init_layers(seed=9)
toks, posa, labels = synthetic_lm_batch(job["batch"], lm["seq_length"], lm["vocab_size"], seed=3)
m.set_batch({tok: toks, pos: posa}, labels)
m.train_iteration()
m.get_metrics()
out["searched"] = dict(pcs={op.name: op.pc.dims for op in m.ops}, loss=m.last_loss)
np.save(job["out"] % rank, out, allow_pickle=True)
dist.shutdown()
"""


def _jax_attention(q, k, v, ct):
    """The JAX package's ring on its 2x4 CPU mesh (forward) and jax.grad
    of its mha_reference (gradients), causal and not."""
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "sp"))
    # jitted: one XLA program each, not a dispatch per op
    ring = jax.jit(jseq.sequence_parallel_attention,
                   static_argnames=("mesh", "seq_axes", "batch_axes", "causal", "mode"))
    out = {}
    for causal in (False, True):
        o = ring(q, k, v, mesh=mesh, seq_axes="sp", batch_axes="dp", causal=causal,
                 mode="ring")

        def loss(q_, k_, v_, causal=causal):
            return jnp.sum(jax_mha_reference(q_, k_, v_, causal=causal) * ct)
        out[causal] = [np.asarray(o)] + [np.asarray(g) for g in
                                         jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]
    return out


def _jax_lm():
    m = ff.FFModel(ff.FFConfig(batch_size=LM_BATCH, workers_per_node=1,
                               compute_dtype="float32"))
    tok, pos, _ = jax_build_transformer(m, LM_BATCH, **LM)
    m.config.strategies = {op.name: ff.ParallelConfig(dims=(1, WORLD, 1)) for op in m.ops
                           if op._type == "MultiHeadAttention"}
    m.compile(ff.SGDOptimizer(m, lr=0.05, momentum=0.9, weight_decay=1e-4),
              "sparse_categorical_crossentropy", ["accuracy", "sparse_categorical_crossentropy"],
              machine=ff.Machine(devices=jax.devices()[:WORLD]))
    m.init_layers(seed=0)
    params0 = jax_params_to_numpy(m)
    losses = []
    for step in range(LM_STEPS):
        toks, posa, labels = jax_lm_batch(LM_BATCH, LM["seq_length"], LM["vocab_size"],
                                          seed=10 + step)
        m.set_batch({tok: toks, pos: posa}, labels)
        m.train_iteration()
        m.get_metrics()
        losses.append(m.last_loss)
    return params0, m, losses


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq4")
    q, k, v, ct = _qkv(3)
    np.savez(tmp / "qkv.npz", q=q, k=k, v=v, ct=ct)
    params0, jm, losses = _jax_lm()
    ranks = _launch(tmp, _SEQ, WORLD, params0, data=str(tmp / "qkv.npz"), lm=LM,
                    batch=LM_BATCH, steps=LM_STEPS, budget=SEARCH_BUDGET)
    return dict(ranks=ranks, jax=_jax_attention(*map(jnp.asarray, (q, k, v, ct))),
                lm=(jm, losses))


def test_the_sequence_group_is_one_flattened_ring(job):
    for out in job["ranks"]:
        assert out["seq_group"] == (("m0", "m1"), [0, 1, 2, 3])


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_on_four_ranks_matches_jax(job, mode, causal):
    got = [np.concatenate([out[f"{mode}_{causal}"][i] for out in job["ranks"]], axis=2)
           for i in range(4)]
    want = job["jax"][causal]
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    for name, g, w in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_transformer_with_a_sequence_split_matches_jax(job, mode):
    jm, losses = job["lm"]
    for r, out in enumerate(job["ranks"]):
        got = out[mode]
        assert set(got["pcs"].values()) == {(1, WORLD, 1)}
        np.testing.assert_allclose(got["losses"], losses, **LM_TOL)
        for (opn, wn), w in got["weights"].items():
            np.testing.assert_allclose(w, jm.get_parameter(opn, wn), **LM_TOL,
                                       err_msg=f"rank {r} {mode} {opn}/{wn}")


def test_a_searched_strategy_trains_on_four_ranks(job):
    searched = [out["searched"] for out in job["ranks"]]
    assert all(r["pcs"] == searched[0]["pcs"] for r in searched)  # one seeded search
    assert all(np.isfinite(r["loss"]) for r in searched)
    assert any(dims[1] > 1 for name, dims in searched[0]["pcs"].items()
               if name.startswith("attn_"))


def test_cross_attention_under_a_sequence_split_reads_the_whole_kv(job):
    """Sq != Sk: each part's q rows attend the whole K/V (the JAX package's
    rule); one training step and a forward equal the single device's."""
    import flexflow_tpu_torch as ft

    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu", compute_dtype="float32"))
    q_in = m.create_tensor((2, 16, 32), nchw=False)
    kv_in = m.create_tensor((2, 8, 32), nchw=False)
    m.multihead_attention(q_in, kv_in, kv_in, num_heads=4, name="xattn")
    m.compile(ft.SGDOptimizer(m, lr=0.1), "mean_squared_error", [])
    m.init_layers(seed=5)
    rng = np.random.default_rng(6)
    m.set_batch({q_in: rng.standard_normal((2, 16, 32), dtype=np.float32),
                 kv_in: rng.standard_normal((2, 8, 32), dtype=np.float32)},
                rng.standard_normal((2, 16, 32), dtype=np.float32))
    m.train_iteration()
    for out in job["ranks"]:
        assert out["cross"]["pc"] == (1, WORLD, 1)
        np.testing.assert_allclose(out["cross"]["wq"], m.get_parameter("xattn", "wq"),
                                   **LM_TOL)
        np.testing.assert_allclose(out["cross"]["probs"], m.predict_batch(), **LM_TOL)
