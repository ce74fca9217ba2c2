"""kv-cached decoding, the port against the JAX package on the CPU.

Each model is built by the same build function in both packages (2
layers, width 32-64, vocab <= 97, float32 unless a test says bf16), the
JAX model's weights carried into the port with
``convert.load_jax_params``.  The JAX
side runs on one CPU device (its decode path has no Pallas kernel).

Tolerances: an op's decode outputs and caches, and ``decode_step``'s
probabilities, within rtol 1e-5, atol 1e-6 (f32; XLA and PyTorch sum in
different orders); beam scores within rtol 1e-5; tokens (greedy, beams,
NMT, the MoE transformer) equal.

The decode graphs' control flow (runtime/decode_graph.py) runs here with
fake CUDA graphs whose replay runs the captured step again, as
tests/test_torch_step.py does for the training step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.models import nmt as jax_nmt
from flexflow_tpu.models.transformer import build_transformer as jax_build_transformer
from flexflow_tpu.ops.base import FwdCtx as JaxCtx
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
from flexflow_tpu_torch.models import nmt
from flexflow_tpu_torch.models.transformer import build_transformer
from flexflow_tpu_torch.ops.base import FwdCtx
from flexflow_tpu_torch.runtime import decode_graph
from flexflow_tpu_torch.runtime.step_graph import StepGraph, disable_graphs, graphs_enabled

TOL = dict(rtol=1e-5, atol=1e-6)
# bf16 decoding against an f32 forward: the two tokens' f32 probabilities
# within this share of the top one (a few bf16 roundings of a logit)
BF16_GAP_TOL = 2.0 ** -5
LM = dict(seq_length=16, num_layers=2, embed_dim=32, num_heads=4, vocab_size=50)


def _pair(batch, build, jbuild, dtype="float32", seed=11):
    """(JAX model, port model, JAX inputs, port inputs), the port holding
    the JAX model's weights."""
    jm = ff.FFModel(ff.FFConfig(batch_size=batch, workers_per_node=1, compute_dtype=dtype))
    tm = ft.FFModel(ft.FFConfig(batch_size=batch, device="cpu", compute_dtype=dtype))
    jin, tin = jbuild(jm), build(tm)
    jm.compile(ff.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy", ["accuracy"],
               machine=ff.Machine(devices=jax.devices()[:1]))
    tm.compile(ft.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy", ["accuracy"])
    jm.init_layers(seed=seed)
    tm.init_layers(seed=seed + 1)
    load_jax_params(tm, jax_params_to_numpy(jm))
    return jm, tm, jin, tin


def _lm_pair(batch=4, dtype="float32", seed=11, **kw):
    shape = dict(LM, **kw)
    return _pair(batch, lambda m: build_transformer(m, batch, **shape)[:2],
                 lambda m: jax_build_transformer(m, batch, **shape)[:2], dtype, seed)


def _nmt_pair(batch=4):
    shape = dict(seq_length=6, num_layers=2, hidden_size=16, embed_size=16, vocab_size=64)
    return _pair(batch, lambda m: nmt.build_nmt(m, batch, **shape)[:2],
                 lambda m: jax_nmt.build_nmt(m, batch, **shape)[:2])


def _op(m, name):
    return next(op for op in m.ops if op.name == name)


def _tparams(tm, op):
    return {k: v.detach() for k, v in tm._params[op.param_key].items()}


def _jparams(jm, op):
    return jm._params[op.param_key]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# each op's decode against the JAX op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_pos", "per_row_pos"])
def test_attention_decode_matches_the_jax_op(per_row):
    jm, tm, _, _ = _lm_pair()
    jop, top = _op(jm, "attn_1"), _op(tm, "attn_1")
    rng = np.random.default_rng(0)
    B, S, E = 4, 16, 32
    x = rng.standard_normal((B, 1, E), dtype=np.float32)
    k0 = rng.standard_normal((B, 4, S, 8), dtype=np.float32)
    v0 = rng.standard_normal((B, 4, S, 8), dtype=np.float32)
    pos = np.array([0, 3, 7, 15]) if per_row else np.array(5)
    jys, jc = jop.decode(_jparams(jm, jop), [jnp.asarray(x)] * 3,
                         {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                         jnp.asarray(pos, jnp.int32), JaxCtx())
    cache = {"k": torch.tensor(k0), "v": torch.tensor(v0)}
    tys, tc = top.decode(_tparams(tm, top), [torch.tensor(x)] * 3, cache,
                         torch.tensor(pos), FwdCtx())
    assert tc is cache  # written in place
    _close(tys[0], jys[0])
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_attention_decode_paged_matches_the_jax_op():
    jm, tm, _, _ = _lm_pair()
    jop, top = _op(jm, "attn_0"), _op(tm, "attn_0")
    rng = np.random.default_rng(1)
    B, E, N, bs = 4, 32, 9, 4
    x = rng.standard_normal((B, 1, E), dtype=np.float32)
    pool_k = rng.standard_normal((N, 4, bs, 8), dtype=np.float32)
    pool_v = rng.standard_normal((N, 4, bs, 8), dtype=np.float32)
    tables = np.array([[1, 2, 3], [4, 0, 0], [5, 6, 0], [7, 8, 2]])
    pos = np.array([9, 2, 5, 11])
    jys, jc = jop.decode_paged(_jparams(jm, jop), [jnp.asarray(x)] * 3,
                               {"k": jnp.asarray(pool_k), "v": jnp.asarray(pool_v)},
                               jnp.asarray(pos, jnp.int32), jnp.asarray(tables, jnp.int32),
                               JaxCtx())
    cache = {"k": torch.tensor(pool_k), "v": torch.tensor(pool_v)}
    tys, tc = top.decode_paged(_tparams(tm, top), [torch.tensor(x)] * 3, cache,
                               torch.tensor(pos), torch.tensor(tables), FwdCtx())
    _close(tys[0], jys[0])
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_attention_decode_falls_back_and_refuses_as_the_jax_op():
    """A full-sequence input runs forward and leaves the cache; a
    single-token non-causal self-attention raises, as the JAX op does."""
    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu", compute_dtype="float32"))
    x = m.create_tensor((2, 8, 32))
    m.multihead_attention(x, num_heads=4, causal=False, name="enc")
    m.compile(ft.SGDOptimizer(lr=0.1))
    m.init_layers(seed=0)
    op = m.ops[0]
    xs = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0))
    cache = op.init_cache(2, 8, torch.float32)
    ys, c = op.decode(_tparams(m, op), [xs] * 3, cache, torch.tensor(0), FwdCtx())
    torch.testing.assert_close(ys[0], op.forward(_tparams(m, op), [xs] * 3, FwdCtx())[0])
    assert c is cache and not cache["k"].any()
    with pytest.raises(ValueError, match="not decodable"):
        op.decode(_tparams(m, op), [xs[:, :1]] * 3, cache, torch.tensor(0), FwdCtx())


def test_lstm_decode_matches_the_jax_op():
    """The decoder LSTM with hx/cx inputs: rows at position 0 seed the
    carry from the state inputs, the others advance the cached (h, c)."""
    jm, tm, _, _ = _nmt_pair()
    jop, top = _op(jm, "dec_lstm1"), _op(tm, "dec_lstm1")
    assert top.has_state_inputs
    rng = np.random.default_rng(2)
    B, E, H = 4, 16, 16
    x = rng.standard_normal((B, 1, E), dtype=np.float32)
    hx, cx = (rng.standard_normal((B, H), dtype=np.float32) for _ in range(2))
    h0, c0 = (rng.standard_normal((B, H), dtype=np.float32) for _ in range(2))
    pos = np.array([0, 3, 0, 1])
    jys, jc = jop.decode(_jparams(jm, jop), [jnp.asarray(a) for a in (x, hx, cx)],
                         {"h": jnp.asarray(h0), "c": jnp.asarray(c0)},
                         jnp.asarray(pos, jnp.int32), JaxCtx())
    cache = {"h": torch.tensor(h0), "c": torch.tensor(c0)}
    tys, tc = top.decode(_tparams(tm, top), [torch.tensor(a) for a in (x, hx, cx)], cache,
                         torch.tensor(pos), FwdCtx())
    for got, want in zip(tys, jys):
        _close(got, want)
    _close(tc["h"], jc["h"])
    _close(tc["c"], jc["c"])
    assert top.init_cache(3, 7, torch.bfloat16)["h"].dtype == torch.float32


def _moe_pair():
    return _lm_pair(batch=4, moe_every=2, num_experts=4, embed_dim=32)


def test_moe_decode_matches_the_jax_op():
    """Dropless routing: every token reaches its chosen expert (the
    training forward's capacity of ceil(4 / 4 * 1.25) = 2 would drop some
    of these tokens, which all route to one expert)."""
    jm, tm, _, _ = _moe_pair()
    jop, top = _op(jm, "moe_1"), _op(tm, "moe_1")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 1, 32), dtype=np.float32)
    jys, _ = jop.decode(_jparams(jm, jop), [jnp.asarray(x)], None, jnp.asarray(0), JaxCtx())
    tys, c = top.decode(_tparams(tm, top), [torch.tensor(x)], None, torch.tensor(0), FwdCtx())
    assert c is None
    _close(tys[0], jys[0])
    # one token routed alone is the dropless forward of that token
    one = top.forward(_tparams(tm, top), [torch.tensor(x[:1])], FwdCtx())[0]
    _close(tys[0][:1], one.numpy())


def test_moe_decode_breaks_a_router_tie_to_the_first_expert():
    """Two router columns equal: argmax takes the first in both packages."""
    jm, tm, _, _ = _moe_pair()
    jop, top = _op(jm, "moe_1"), _op(tm, "moe_1")
    router = np.asarray(jm.get_parameter("moe_1", "router")).copy()
    router[:, 2] = router[:, 1] = router.max(axis=1) + 1.0  # experts 1 and 2 lead, tied
    jp = dict(_jparams(jm, jop), router=jnp.asarray(router))
    tp = dict(_tparams(tm, top), router=torch.tensor(router))
    x = np.abs(np.random.default_rng(4).standard_normal((4, 1, 32), dtype=np.float32))
    jys, _ = jop.decode(jp, [jnp.asarray(x)], None, jnp.asarray(0), JaxCtx())
    tys, _ = top.decode(tp, [torch.tensor(x)], None, torch.tensor(0), FwdCtx())
    _close(tys[0], jys[0])
    gates = torch.softmax(torch.tensor(x[:, 0]) @ tp["router"], -1)
    assert torch.equal(gates[:, 1], gates[:, 2]) and (gates.argmax(-1) == 1).all()


# ---------------------------------------------------------------------------
# decode_step and generate
# ---------------------------------------------------------------------------

def test_decode_step_probs_match_the_jax_package():
    jm, tm, (jtok, jpos), (ttok, tpos) = _lm_pair()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 50, size=(4, 6)).astype(np.int32)
    jc, tc = jm.init_decode_caches(4, 8), tm.init_decode_caches(4, 8)
    for t in range(6):
        jp, jc = jm.decode_step(jm._params, jm._stats, jc, jnp.asarray(toks[:, t]),
                                jnp.asarray(t, jnp.int32), jtok, jpos)
        tp, tc = tm.decode_step(tm._decode_params(), tc, torch.tensor(toks[:, t]), t,
                                ttok, tpos)
        assert tp.dtype == torch.float32 and tp.shape == (4, 50)
        _close(tp, jp)


def test_generate_matches_the_jax_package_and_the_full_forward_oracle():
    """Greedy tokens equal the JAX package's, and equal an iterated
    full-sequence forward's argmax (the port's counterpart of
    tests/test_transformer.py::test_generate_matches_full_forward_oracle)."""
    B, P, N, S = 4, 5, 6, 16
    jm, tm, _, (tok, pos) = _lm_pair()
    prompt = np.random.default_rng(3).integers(0, 50, size=(B, P)).astype(np.int32)
    out = tm.generate(prompt, N)
    assert out.shape == (B, N) and out.dtype == np.int32
    np.testing.assert_array_equal(out, jm.generate(prompt, N))
    seq = prompt.copy()
    posa = np.broadcast_to(np.arange(S), (B, S)).copy()
    for _ in range(N):
        L = seq.shape[1]
        full = np.zeros((B, S), np.int64)
        full[:, :L] = seq
        with torch.no_grad():
            env = tm._run_graph(tm._params, {f"in_{tok.guid}": torch.tensor(full),
                                             f"in_{pos.guid}": torch.tensor(posa)}, False)
        nxt = env[tm.final_tensor().guid][:, L - 1].argmax(-1).numpy().astype(np.int32)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(out, seq[:, P:])
    assert tm.generate(prompt, 0).shape == (B, 0)


def test_generate_bfloat16():
    """The bench's decode config: caches and activations in bf16, argmax
    over the f32-cast probabilities.  Every bf16 token is held against the
    JAX package's f32 full forward over the same tokens on the same
    weights: the token's f32 probability lies within BF16_GAP_TOL (a share
    of the top probability) of the forward's argmax."""
    jf, _, (jtok, jpos), _ = _lm_pair(seed=2)
    _, tm, _, _ = _lm_pair(dtype="bfloat16", seed=2)
    load_jax_params(tm, jax_params_to_numpy(jf))
    caches = tm.init_decode_caches(4, 9)
    assert caches["attn_0"]["k"].dtype == torch.bfloat16 and caches["ln1_0"] is None
    B, N, S = 4, 8, LM["seq_length"]
    prompt = np.random.default_rng(0).integers(0, 50, size=(B, 1)).astype(np.int32)
    out = tm.generate(prompt, N)
    assert out.shape == (B, N) and (out >= 0).all() and (out < 50).all()
    np.testing.assert_array_equal(tm.generate(prompt, N), out)
    full = np.zeros((B, S), np.int32)
    full[:, :N + 1] = np.concatenate([prompt, out], axis=1)
    env, _ = jf._run_graph(jf._params, jf._stats,
                           {f"in_{jtok.guid}": jnp.asarray(full),
                            f"in_{jpos.guid}": jnp.asarray(np.broadcast_to(np.arange(S), (B, S)),
                                                           jnp.int32)}, False, None)
    probs = np.asarray(env[jf.final_tensor().guid], np.float32)[:, :N]  # predict 1..N
    top = probs.max(-1)
    got = np.take_along_axis(probs, out[..., None].astype(np.int64), -1)[..., 0]
    assert ((top - got) / top).max() <= BF16_GAP_TOL


def test_sampling_knobs_validate_and_restrict_the_support():
    """Bad knobs raise even for greedy; top_k = 1 equals greedy at any
    temperature; each sampled token lies in its step's top-k and nucleus
    (checked on the step's full-forward distribution); one seed gives one
    sequence."""
    B, P, N, S = 4, 3, 6, 16
    _, tm, _, (tok, pos) = _lm_pair(vocab_size=20, seed=9)
    prompt = np.random.default_rng(5).integers(0, 20, size=(B, P)).astype(np.int32)
    for kw, match in ((dict(top_k=0), "top_k"), (dict(top_p=0.0), "top_p"),
                      (dict(top_p=1.5), "top_p")):
        with pytest.raises(ValueError, match=match):
            tm.generate(prompt, 2, **kw)
    greedy = tm.generate(prompt, N)
    np.testing.assert_array_equal(tm.generate(prompt, N, temperature=1.7, top_k=1, seed=3),
                                  greedy)
    k, p = 4, 0.5
    out = tm.generate(prompt, N, temperature=1.0, top_k=k, top_p=p, seed=11)
    np.testing.assert_array_equal(tm.generate(prompt, N, temperature=1.0, top_k=k, top_p=p,
                                              seed=11), out)
    seq = prompt.copy()
    posa = np.broadcast_to(np.arange(S), (B, S)).copy()
    for i in range(N):
        L = seq.shape[1]
        full = np.zeros((B, S), np.int64)
        full[:, :L] = seq
        with torch.no_grad():
            env = tm._run_graph(tm._params, {f"in_{tok.guid}": torch.tensor(full),
                                             f"in_{pos.guid}": torch.tensor(posa)}, False)
        probs = env[tm.final_tensor().guid][:, L - 1].numpy()
        for row in range(B):
            srt = np.sort(probs[row])[::-1]
            cutoff = srt[min(int((np.cumsum(srt) < p).sum()), srt.size - 1)]
            got = probs[row, out[row, i]]
            assert got >= srt[k - 1] - 1e-7 and got >= cutoff - 1e-7, (i, row)
        seq = np.concatenate([seq, out[:, i:i + 1]], axis=1)


def test_signature_cache_reuse():
    """Seeds and temperatures reuse a signature; the greedy variant and
    inactive knobs add one; init_layers drops them all."""
    _, tm, _, _ = _lm_pair(vocab_size=20, num_layers=1, seed=1)
    prompt = np.random.default_rng(0).integers(0, 20, size=(4, 2)).astype(np.int32)
    for seed in range(3):
        tm.generate(prompt, 3, temperature=0.7 + 0.1 * seed, seed=seed)
    assert len(tm._gen_cache) == 1
    tm.generate(prompt, 3)
    tm.generate(prompt, 3, top_k=5, top_p=0.5)  # greedy ignores the knobs
    assert len(tm._gen_cache) == 2
    tm.init_layers(seed=2)
    assert tm._gen_cache == {}


def test_position_table_overflow_raises_before_any_lookup():
    _, tm, _, _ = _lm_pair(num_layers=1)
    prompt = np.zeros((4, 10), np.int32)
    tm.generate(prompt, 7)  # 16 positions: 0..15
    with pytest.raises(ValueError, match="position table has only 16 entries"):
        tm.generate(prompt, 8)
    with pytest.raises(ValueError, match="position table"):
        tm.beam_search(prompt[:1], 8, beam_size=2)


@pytest.mark.parametrize("eos,penalty", [(None, 0.0), (7, 0.0), (7, 1.0)],
                         ids=["plain", "eos", "eos_length_penalty"])
def test_beam_search_matches_the_jax_package(eos, penalty):
    jm, tm, _, _ = _lm_pair(batch=3, vocab_size=12, seed=21)
    prompt = np.random.default_rng(4).integers(0, 12, size=(3, 4)).astype(np.int32)
    if eos is not None:  # an eos the beams actually emit
        eos = int(jm.beam_search(prompt, 5, beam_size=4)[0][0, 1, 0])
    js, jsc = jm.beam_search(prompt, 5, beam_size=4, eos_id=eos, length_penalty=penalty)
    ts, tsc = tm.beam_search(prompt, 5, beam_size=4, eos_id=eos, length_penalty=penalty)
    assert ts.shape == (3, 4, 5) and tsc.shape == (3, 4)
    # a beam of score -inf is a filler (every candidate was impossible, as
    # when the prompt ends in eos): its tokens are an arbitrary tie break
    # among -inf, as the JAX package's own beam test says
    fin = np.isfinite(jsc)
    np.testing.assert_array_equal(np.isfinite(tsc), fin)
    np.testing.assert_array_equal(ts[fin], js[fin])
    np.testing.assert_allclose(tsc[fin], jsc[fin], rtol=1e-5)
    if eos is not None:
        assert (ts[fin] == eos).any()
        for s in ts[fin].tolist():  # a finished beam emits eos again
            if eos in s:
                assert all(t == eos for t in s[s.index(eos):]), s
    # one beam is greedy
    np.testing.assert_array_equal(tm.beam_search(prompt, 3, beam_size=1)[0][:, 0],
                                  tm.generate(prompt, 3))


def test_greedy_translate_matches_the_jax_package():
    jm, tm, (jsrc, jdst), (tsrc, tdst) = _nmt_pair()
    src = np.random.default_rng(6).integers(0, 64, size=(4, 6)).astype(np.int32)
    out = nmt.greedy_translate(tm, tsrc, tdst, src, 6)
    assert out.shape == (4, 6)
    np.testing.assert_array_equal(out, jax_nmt.greedy_translate(jm, jsrc, jdst, src, 6))
    # the encoder runs once a call, outside the per-token steps
    run = next(iter(tm._gen_cache.values()))
    assert run.static_names == {"embed_src", "enc_lstm0", "enc_lstm1"}


def test_moe_transformer_generate_matches_the_jax_package():
    jm, tm, _, _ = _moe_pair()
    prompt = np.random.default_rng(7).integers(0, 50, size=(4, 5)).astype(np.int32)
    np.testing.assert_array_equal(tm.generate(prompt, 6), jm.generate(prompt, 6))


# ---------------------------------------------------------------------------
# the decode graphs' control flow, with fake CUDA graphs
# ---------------------------------------------------------------------------

def _fake_graphs(monkeypatch, events):
    """DecodeGraph on the CPU as on a card: the first step eager (on a
    "side stream"), the next recorded as a "capture" whose replay runs the
    step again."""
    monkeypatch.setattr(decode_graph.DecodeGraph, "_use_graph", lambda self: graphs_enabled())

    def eager(self, step):
        events.append("eager")
        step()

    class Graph:
        def __init__(self, step):
            self.step = step

        def replay(self):
            events.append("replay")
            self.step()

    def capture(self, step):
        events.append("capture")
        self.graph = Graph(step)
        self.captures += 1

    monkeypatch.setattr(StepGraph, "_eager_on_side_stream", eager)
    monkeypatch.setattr(decode_graph.DecodeGraph, "_capture", capture)


def test_decode_graph_runs_eager_then_captures_then_replays(monkeypatch):
    events, calls = [], []
    _fake_graphs(monkeypatch, events)
    g = decode_graph.DecodeGraph(torch.device("cpu"), lambda: calls.append(1))
    g.advance(4, before=lambda: events.append("before"))
    assert events == ["before", "eager", "before", "capture", "replay",
                      "before", "replay", "before", "replay"]
    assert (g.captures, g.replays, len(calls)) == (1, 3, 4)
    with disable_graphs():  # eager over the same buffers; the graph stays
        g.advance(2)
    assert (g.captures, g.replays, len(calls)) == (1, 3, 6) and g.graph is not None
    g.advance(1)
    assert g.replays == 4


def test_graphed_generate_and_beam_search_equal_eager(monkeypatch):
    """generate (greedy and sampled) and beam_search through the graph
    path (the fake replay re-runs the captured step) equal the eager path;
    a second call of a signature only replays."""
    events = []
    _fake_graphs(monkeypatch, events)
    _, tm, _, _ = _lm_pair(vocab_size=20, seed=5)
    prompt = np.random.default_rng(1).integers(0, 20, size=(4, 3)).astype(np.int32)
    with disable_graphs():
        want = tm.generate(prompt, 5)
        want_s = tm.generate(prompt, 5, temperature=0.9, top_k=6, seed=4)
        want_b = tm.beam_search(prompt, 4, beam_size=3, eos_id=2)
    tm._gen_cache.clear()
    for _ in range(2):
        np.testing.assert_array_equal(tm.generate(prompt, 5), want)
        np.testing.assert_array_equal(tm.generate(prompt, 5, temperature=0.9, top_k=6,
                                                  seed=4), want_s)
        seqs, scores = tm.beam_search(prompt, 4, beam_size=3, eos_id=2)
        np.testing.assert_array_equal(seqs, want_b[0])
        np.testing.assert_array_equal(scores, want_b[1])
    runs = list(tm._gen_cache.values())
    assert [r.captures for r in runs] == [1, 1, 2]  # the beam's prompt and expand graphs
    assert events.count("eager") == 4 and events.count("capture") == 4
    # 7 steps a generate call (P + N - 1), 2 + 4 a beam call, all but the
    # eager first ones replays
    assert events.count("replay") == 2 * (2 * 7 + 6) - 4
