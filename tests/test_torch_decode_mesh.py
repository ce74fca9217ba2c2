"""Decoding on a mesh: the port on gloo ranks against the JAX package on
one CPU device.

GSPMD decoding on a mesh computes the one-device function, so the JAX
package's one-device decode is the reference.  Each job launches its
ranks once (a module-scoped fixture, tests/test_torch_soap.py's
launcher): one Python subprocess per rank that imports the port only,
builds each model under its strategy, carries the JAX model's weights in
with ``convert.load_jax_params`` and decodes on every rank; the cases
read each rank's results.  Every model is small (2 layers, widths 16-64,
vocab 50-64, f32).

* models, 2 ranks: the transformer with its attention split by heads (1,
  1, 2) and the dense layers (the vocabulary-wide head included) by
  column: ``decode_step`` probabilities, greedy ``generate``,
  ``beam_search`` with and without an eos, and a sampled ``generate``
  (every rank's tokens equal, and equal to the port's one-device draw at
  the same seed); NMT with its four LSTMs split 2 on the hidden dim
  (``greedy_translate``); the MoE transformer at expert degree 2; a
  ``set_pipeline`` model over the 2 ranks (its stage weights gathered once
  and its ops walked in order, against the JAX package's unpipelined
  model, as tests/test_pipeline.py:404 does); a ``pipeline_mlp`` of 2
  stages split over the ranks (gathered alike); the transformer with its
  token embedding a row-sharded host table.
* training then decoding, 4 ranks: the transformer under (2, 1, 2) (the
  JAX package's test_generate_on_sharded_model shape, halved) after one
  SGD step taken by both packages.
* the engine, 2 ranks: a dozen mixed-length requests, some sharing a
  prefix, dense and paged, each against the JAX package's ``generate``
  at temperature 0; ``/healthz`` on the leader's ``ServingAPI`` reports
  the world size; ``submit`` and a ``ServingAPI`` on a follower raise;
  ``stop()`` on the
  leader ends the followers; ``serve:3=replica_kill`` on the leader ends
  them within ``FF_SERVE_REPLICA_TIMEOUT``; a step fault after its plan
  was sent, planted on the leader and then on the follower, ends both
  loops (``LockstepBroken``; the leader's ``/healthz`` turns 503); a
  leader that never sends a plan leaves its follower raising after the
  timeout.
* the engine, 3 ranks: a machine over ranks 0 and 1 (``Machine.for_ranks``)
  with rank 2 benched serves the JAX tokens; the benched rank builds no
  engine.
* the process group formed again, 2 ranks: shut down, a one-rank mesh
  on rank 0 (generate, an engine's plan group), shut down, then the 2
  ranks again; each mesh generates the JAX tokens.

Tolerances: probabilities rtol 1e-5, atol 1e-6 (f32; XLA and PyTorch sum
in different orders); beam scores rtol 1e-5; tokens equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import flexflow_tpu as ff
from flexflow_tpu.models import nmt as jax_nmt
from flexflow_tpu.models.transformer import build_transformer as jax_build_transformer
from flexflow_tpu.ops.embedding import AggrMode
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
from flexflow_tpu_torch.models.transformer import build_transformer

from test_torch_soap import _PRELUDE, _launch

TOL = dict(rtol=1e-5, atol=1e-6)
LM = dict(seq_length=16, num_layers=2, embed_dim=32, num_heads=4, vocab_size=50)
ENGINE_LM = dict(LM, seq_length=32)
MOE = dict(LM, moe_every=2, num_experts=4)
NMT = dict(seq_length=6, num_layers=2, hidden_size=16, embed_size=16, vocab_size=64)
PIPE_V = 30
B, P, N = 4, 5, 6
BEAM = dict(B=3, P=4, N=5, K=4)
SAMPLING = dict(temperature=0.9, top_k=8, top_p=0.9, seed=5)
# the engine: requests of 4 prompt lengths (one JAX compile each), the
# last 3 extending the first's prompt (a shared prefix)
ENGINE = dict(max_batch=3, max_seq=32, kv_block=4, replica_timeout_s=3.0)
ENGINE_NEW = 5


def _heads_and_columns(world, dp=1):
    s = {}
    for i in range(LM["num_layers"]):
        for name in (f"attn_{i}", f"mlp_up_{i}", f"mlp_down_{i}"):
            s[name] = (dp, 1, world)
    s["lm_head"] = (dp, 1, world)
    return s


def _jax_model(build, batch=B):
    m = ff.FFModel(ff.FFConfig(batch_size=batch, workers_per_node=1))
    ins = build(m)
    m.compile(ff.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy", ["accuracy"],
              machine=ff.Machine(devices=jax.devices()[:1]))
    m.init_layers(seed=11)
    return m, ins


def _jax_lm(shape=LM, batch=B):
    return _jax_model(lambda m: jax_build_transformer(m, batch, **shape)[:2], batch)


def _jax_pipe_model():
    def build(m):
        tok = m.create_tensor((B, 8), name="tokens", dtype="int32", nchw=False)
        x = m.embedding(tok, PIPE_V, 16, aggr=AggrMode.NONE, name="embed")
        for i in (1, 2, 3):
            x = m.dense(x, 32, activation=ff.ActiMode.RELU, name=f"mlp{i}")
        x = m.dense(x, PIPE_V, name="head")
        m.softmax(x, name="sm")
        return tok
    return _jax_model(build)


def _jax_pipeline_mlp_model():
    def build(m):
        tok = m.create_tensor((B, 8), name="tokens", dtype="int32", nchw=False)
        x = m.embedding(tok, PIPE_V, 16, aggr=AggrMode.NONE, name="embed")
        x = m.pipeline_mlp(x, 2, num_microbatches=2, name="pmlp")
        m.softmax(m.dense(x, PIPE_V, name="head"), name="sm")
        return tok
    return _jax_model(build)


def _prompt(seed, rows, cols, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(rows, cols)).astype(np.int32)


def _decode_probs(jm, toks):
    """The JAX package's decode_step probabilities over ``toks`` (B, T)."""
    jtok, jpos = jm.input_tensors[:2]
    caches, out = jm.init_decode_caches(toks.shape[0], 8), []
    for t in range(toks.shape[1]):
        p, caches = jm.decode_step(jm._params, jm._stats, caches, jnp.asarray(toks[:, t]),
                                   jnp.asarray(t, jnp.int32), jtok, jpos)
        out.append(np.asarray(p))
    return np.stack(out)


def _lm_refs(jm, prompt, beam_prompt, probe):
    """What every transformer case compares with: decode_step probabilities,
    greedy tokens and beams (eos: a token the plain search emits)."""
    eos = int(jm.beam_search(beam_prompt, BEAM["N"], beam_size=BEAM["K"])[0][0, 1, 0])
    return dict(probs=_decode_probs(jm, probe), greedy=jm.generate(prompt, N), eos=eos,
                beam=jm.beam_search(beam_prompt, BEAM["N"], beam_size=BEAM["K"]),
                beam_eos=jm.beam_search(beam_prompt, BEAM["N"], beam_size=BEAM["K"],
                                        eos_id=eos))


# What every rank runs: build each model of the job under its strategy,
# carry the JAX weights in, decode.
_CHILD = _PRELUDE + r"""
import os, time
from flexflow_tpu_torch.config import DeviceType
from flexflow_tpu_torch.models import nmt
from flexflow_tpu_torch.models.transformer import build_transformer
import urllib.error, urllib.request
from flexflow_tpu_torch.serving.api import ServingAPI
from flexflow_tpu_torch.serving.engine import InferenceEngine, LeaderLost, LockstepBroken
from flexflow_tpu_torch.testing import chaos


def compiled(m, machine=None):
    m.compile(ft.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy", ["accuracy"],
              machine=machine)
    if not m._benched:  # a rank outside the machine holds no state
        m.init_layers(seed=12)
    return m


def config(strategies, batch=4):
    return ft.FFConfig(batch_size=batch, device="cpu", compute_dtype="float32",
                       strategies={k: ft.ParallelConfig(dims=tuple(v))
                                   for k, v in strategies.items()})


def lm(shape, strategies, params, host=False, machine=None):
    cfg = config(strategies)
    if host:  # the token table row-sharded over the ranks' host memory
        cfg.strategies["tok_embed"] = ft.ParallelConfig(DeviceType.CPU, (1, 1, 1), (0,))
    m = ft.FFModel(cfg)
    build_transformer(m, 4, **shape)
    compiled(m, machine)
    if not m._benched:
        load_jax_params(m, params)
    return m


# start ``eng``; on the leader submit every request and return their
# tokens; stop it
def serve_all(eng, reqs, new):
    eng.start()
    got = [h.result(120) for h in [eng.submit(r, new) for r in reqs]] \
        if eng.is_leader else None
    eng.stop()
    return got


# make this rank's ``on_call``-th decode step fail after it ran (its
# collectives met the other ranks'), so that only this rank raises
def planted_fault(eng, on_call=2):
    run, calls = eng._run_decode, []

    def faulty(*args):
        out = run(*args)
        calls.append(1)
        if len(calls) == on_call:
            raise RuntimeError("planted step fault")
        return out
    eng._run_decode = faulty


def lm_cases(m, job):
    tok, pos = m.input_tensors[:2]
    probe = np.asarray(job["probe"])
    caches, probs = m.init_decode_caches(probe.shape[0], 8), []
    for t in range(probe.shape[1]):
        p, caches = m.decode_step(m._decode_params(), caches, torch.tensor(probe[:, t]), t,
                                  tok, pos)
        probs.append(p.numpy())
    bp, beam = np.asarray(job["beam_prompt"]), job["beam"]
    return dict(probs=np.stack(probs), greedy=m.generate(np.asarray(job["prompt"]), job["N"]),
                beam=m.beam_search(bp, beam["N"], beam_size=beam["K"]),
                beam_eos=m.beam_search(bp, beam["N"], beam_size=beam["K"],
                                       eos_id=job["eos"]),
                sampled=m.generate(np.asarray(job["prompt"]), job["N"], **job["sampling"]))


if "models" in job["cases"]:
    m = lm(job["lm"], job["heads"], params0["lm"])
    out["heads"] = lm_cases(m, job)
    out["heads"]["cache_heads"] = tuple(m.init_decode_caches(1, 8)["attn_0"]["k"].shape)
    out["heads"]["lm_head_local"] = tuple(m._params["lm_head"]["kernel"].to_local().shape)
    m = lm(job["lm"], {}, params0["lm"], host=True)
    out["host"] = dict(greedy=m.generate(np.asarray(job["prompt"]), job["N"]),
                       sparse=sorted(m._host.sparse),
                       rows=tuple(m._host.sparse["tok_embed"]["table"].shape))
    m = lm(job["moe"], job["moe_split"], params0["moe"])
    out["moe"] = dict(greedy=m.generate(np.asarray(job["prompt"]), job["N"]),
                      w_in_local=tuple(m._params["moe_1"]["w_in"].to_local().shape))
    m = ft.FFModel(config(job["nmt_split"]))
    src, dst, _ = nmt.build_nmt(m, 4, **job["nmt"])
    compiled(m)
    load_jax_params(m, params0["nmt"])
    out["nmt"] = dict(tokens=nmt.greedy_translate(m, src, dst, np.asarray(job["src"]), 6),
                      cache=tuple(m.init_decode_caches(1, 8)["dec_lstm0"]["h"].shape))
    m = ft.FFModel(config({}))
    tok = m.create_tensor((4, 8), name="tokens", dtype="int32", nchw=False)
    x = m.embedding(tok, job["pipe_v"], 16, aggr="none", name="embed")
    for i in (1, 2, 3):
        x = m.dense(x, 32, activation="relu", name=f"mlp{i}")
    m.softmax(m.dense(x, job["pipe_v"], name="head"), name="sm")
    m.set_pipeline(stages=[["embed", "mlp1", "mlp2"], ["mlp3", "head"]], num_microbatches=2)
    compiled(m)
    load_jax_params(m, params0["pipe"])
    out["pipe"] = dict(greedy=m.generate(np.asarray(job["pipe_prompt"]), 3),
                       packed=m._pipe_pack() is not None)
    m = ft.FFModel(config({"pmlp": (1, 2, 1)}))
    tok = m.create_tensor((4, 8), name="tokens", dtype="int32", nchw=False)
    x = m.embedding(tok, job["pipe_v"], 16, aggr="none", name="embed")
    x = m.pipeline_mlp(x, 2, num_microbatches=2, name="pmlp")
    m.softmax(m.dense(x, job["pipe_v"], name="head"), name="sm")
    compiled(m)
    load_jax_params(m, params0["pmlp"])
    out["pmlp"] = dict(greedy=m.generate(np.asarray(job["pipe_prompt"]), 3),
                       local=tuple(m._params["pmlp"]["kernel"].to_local().shape),
                       decoded=tuple(m._decode_params()["pmlp"]["kernel"].to_local().shape))

if "trained" in job["cases"]:
    m = lm(job["lm"], job["heads"], params0["lm"])
    tok, pos = m.input_tensors[:2]
    data = np.load(job["data"])
    m.set_batch({tok: data["toks"], pos: data["pos"]}, data["labels"])
    m.train_iteration()
    m.get_metrics()
    out["trained"] = lm_cases(m, job)

if "engine" in job["cases"]:
    m = lm(job["lm"], job["heads"], params0["lm"])
    reqs = [np.asarray(r, np.int32) for r in job["requests"]]
    for paged in ("off", "on"):
        eng = InferenceEngine(m, paged=paged, **job["engine"])
        res = dict(leader=eng.is_leader, world=eng.stats()["world_size"])
        eng.start()
        if eng.is_leader:
            hs = [eng.submit(r, job["new"]) for r in reqs]
            res["tokens"] = [h.result(120) for h in hs]
            res["kv"] = eng.stats().get("kv")
            with ServingAPI(eng, port=0) as api:
                with urllib.request.urlopen(f"{api.url}/healthz", timeout=60) as r:
                    res["healthz"] = json.loads(r.read())
        else:
            try:
                eng.submit(reqs[0], 2)
            except ValueError as e:
                res["submit_error"] = str(e)
            try:
                ServingAPI(eng, port=0)
            except ValueError as e:
                res["api_error"] = str(e)
        eng.stop()
        res["t_stop"] = time.time()  # the leader's stop, or its follower's loop, ended
        res["alive"], res["crashed"] = eng.alive(), eng.crashed
        out[paged] = res
    # the leader killed at its third admission (FF_CHAOS on every rank; only
    # the leader fires it)
    os.environ["FF_CHAOS"] = "serve:3=replica_kill"
    m._chaos = chaos.from_env()
    eng = InferenceEngine(m, paged="on", **job["engine"])
    eng.start()
    t0 = time.perf_counter()
    if eng.is_leader:
        hs = [eng.submit(r, job["new"]) for r in reqs[:4]]
        eng._thread.join(60)
        out["kill"] = dict(crashed=eng.crashed, errors=sum(h.status == "error" for h in hs))
    else:
        eng._thread.join(60)
        try:
            eng.stop()
            raised = None
        except LeaderLost as e:
            raised = str(e)
        out["kill"] = dict(ended_s=time.perf_counter() - t0, raised=raised,
                           alive=eng.alive())
    # a step fault after its plan was sent, on the leader, then on the
    # follower (on a fresh model, so a fresh plan group: a plan whose send
    # timed out leaves its group in an undefined state)
    del os.environ["FF_CHAOS"]
    m._chaos = None
    for side, name in ((0, "leader_fault"), (1, "follower_fault")):
        if side:
            m = lm(job["lm"], job["heads"], params0["lm"])
        eng = InferenceEngine(m, paged="off", **job["engine"])
        if rank == side:
            planted_fault(eng)
        eng.start()
        t0 = time.perf_counter()
        if eng.is_leader:
            hs = [eng.submit(r, job["new"]) for r in reqs[:4]]
        eng._thread.join(60)
        res = dict(ended_s=time.perf_counter() - t0, crashed=eng.crashed, alive=eng.alive())
        if eng.is_leader:
            res["statuses"] = [h.status for h in hs]
            with ServingAPI(eng, port=0) as api:
                try:
                    urllib.request.urlopen(f"{api.url}/healthz", timeout=60)
                except urllib.error.HTTPError as e:
                    res["healthz"] = (e.code, json.loads(e.read())["status"])
        else:
            try:
                eng.stop()
            except LockstepBroken as e:
                res["raised"] = type(e).__name__
        out[name] = res
    # a leader that never starts: its follower times out and raises
    m = lm(job["lm"], job["heads"], params0["lm"])
    eng = InferenceEngine(m, paged="off", **job["engine"])
    if not eng.is_leader:
        eng.start()
        t0 = time.perf_counter()
        eng._thread.join(60)
        out["silent"] = dict(ended_s=time.perf_counter() - t0, crashed=eng.crashed)
    else:
        time.sleep(job["engine"]["replica_timeout_s"] + 2)
        out["silent"] = {}

if "subset" in job["cases"]:
    # a machine over ranks 0 and 1; every rank builds it (rank 2 benched)
    machine = ft.Machine.for_ranks(torch.device("cpu"), [0, 1])
    m = lm(job["lm"], job["heads"], params0["lm"], machine=machine)
    out["subset"] = dict(benched=m._benched)
    if not m._benched:
        eng = InferenceEngine(m, paged="off", **job["engine"])
        out["subset"].update(tokens=serve_all(eng, [np.asarray(r, np.int32)
                                                    for r in job["requests"]], job["new"]),
                             world=eng.stats()["world_size"], crashed=eng.crashed)
    # a later machine over other ranks still meets: every rank made the
    # plan group above alike, so every rank's groups stay in step
    other = ft.Machine.for_ranks(torch.device("cpu"), [1, 2])
    if not other.benched:
        import torch.distributed as tdist
        t = torch.ones(1)
        tdist.all_reduce(t, group=other.process_group)
        out["subset"]["later_sum"] = float(t)

if "regroup" in job["cases"]:
    # the process group re-formed in living processes: the 2 ranks' group
    # shut down; on rank 0 a one-rank group (a mesh decode and an engine's
    # plan group), shut down; then the 2 ranks again, decoding on the mesh
    prompt = np.asarray(job["prompt"])
    dist.shutdown()
    if rank == 0:
        dist.initialize("cpu", init_method=job["init"] + "_one", world_size=1, rank=0)
        m = lm(job["lm"], job["heads1"], params0["lm"])
        InferenceEngine(m, paged="off", **job["engine"])
        out["one"] = dict(greedy=m.generate(prompt, job["N"]), world=m.machine.num_devices)
        dist.shutdown()
    dist.initialize("cpu", init_method=job["init"] + "_again", world_size=2, rank=rank)
    m = lm(job["lm"], job["heads"], params0["lm"])
    out["again"] = dict(greedy=m.generate(prompt, job["N"]), world=m.machine.num_devices)

np.save(job["out"] % rank, out, allow_pickle=True)
dist.shutdown()
"""


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The 2-rank models job and its JAX references."""
    tmp = tmp_path_factory.mktemp("decode_mesh")
    jm, _ = _jax_lm()
    prompt, probe = _prompt(3, B, P, 50), _prompt(5, B, 6, 50)
    beam_prompt = _prompt(4, BEAM["B"], BEAM["P"], 50)
    refs = {"lm": _lm_refs(jm, prompt, beam_prompt, probe)}
    jmoe, _ = _jax_lm(MOE)
    refs["moe"] = jmoe.generate(prompt, N)
    jn, (jsrc, jdst) = _jax_model(lambda m: jax_nmt.build_nmt(m, B, **NMT)[:2])
    src = _prompt(6, B, 6, 64)
    refs["nmt"] = jax_nmt.greedy_translate(jn, jsrc, jdst, src, 6)
    jp, _ = _jax_pipe_model()
    pipe_prompt = _prompt(1, B, 3, PIPE_V)
    refs["pipe"] = jp.generate(pipe_prompt, 3)
    jpm, _ = _jax_pipeline_mlp_model()
    refs["pmlp"] = jpm.generate(pipe_prompt, 3)
    params = dict(lm=jax_params_to_numpy(jm), moe=jax_params_to_numpy(jmoe),
                  nmt=jax_params_to_numpy(jn), pipe=jax_params_to_numpy(jp),
                  pmlp=jax_params_to_numpy(jpm))
    # the port's own one-device draw at the same seed
    tm = ft.FFModel(ft.FFConfig(batch_size=B, device="cpu", compute_dtype="float32"))
    build_transformer(tm, B, **LM)
    tm.compile(ft.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy", ["accuracy"])
    tm.init_layers(seed=12)
    load_jax_params(tm, params["lm"])
    refs["sampled"] = tm.generate(prompt, N, **SAMPLING)
    ranks = _launch(tmp, _CHILD, 2, params, cases=["models"], lm=LM, moe=MOE, nmt=NMT,
                    heads=_heads_and_columns(2), moe_split={"moe_1": (1, 2, 1)},
                    nmt_split={f"{p}_lstm{i}": (1, 1, 2) for p in ("enc", "dec")
                               for i in range(2)},
                    prompt=prompt.tolist(), probe=probe.tolist(), N=N, src=src.tolist(),
                    beam_prompt=beam_prompt.tolist(), beam=BEAM, eos=refs["lm"]["eos"],
                    sampling=SAMPLING, pipe_v=PIPE_V, pipe_prompt=pipe_prompt.tolist())
    return ranks, refs


@pytest.fixture(scope="module")
def regroup(tmp_path_factory):
    """The 2-rank job that re-forms its process group (a one-rank group on
    rank 0 in between), and the JAX package's greedy tokens."""
    tmp = tmp_path_factory.mktemp("decode_mesh_regroup")
    jm, _ = _jax_lm()
    prompt = _prompt(3, B, P, 50)
    ranks = _launch(tmp, _CHILD, 2, {"lm": jax_params_to_numpy(jm)}, cases=["regroup"],
                    lm=LM, heads=_heads_and_columns(2), heads1=_heads_and_columns(1),
                    engine=dict(ENGINE, max_seq=LM["seq_length"]), prompt=prompt.tolist(),
                    N=N)
    return ranks, jm.generate(prompt, N)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The 4-rank job: one SGD step under (2, 1, 2), then decoding, beside
    the JAX package's one-device model after the same step."""
    tmp = tmp_path_factory.mktemp("decode_mesh_trained")
    jm, (jtok, jpos) = _jax_lm()
    params = {"lm": jax_params_to_numpy(jm)}
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 50, size=(B, LM["seq_length"])).astype(np.int32)
    posa = np.broadcast_to(np.arange(LM["seq_length"], dtype=np.int32), toks.shape).copy()
    labels = np.roll(toks, -1, 1).astype(np.int32)
    np.savez(tmp / "data.npz", toks=toks, pos=posa, labels=labels)
    jm.set_batch({jtok: toks, jpos: posa}, labels)
    jm.train_iteration()
    jm.sync()
    prompt, probe = _prompt(13, B, P, 50), _prompt(15, B, 6, 50)
    beam_prompt = _prompt(14, BEAM["B"], BEAM["P"], 50)
    refs = _lm_refs(jm, prompt, beam_prompt, probe)
    ranks = _launch(tmp, _CHILD, 4, params, cases=["trained"], lm=LM,
                    heads=_heads_and_columns(2, dp=2), data=str(tmp / "data.npz"),
                    prompt=prompt.tolist(), probe=probe.tolist(), N=N,
                    beam_prompt=beam_prompt.tolist(), beam=BEAM, eos=refs["eos"],
                    sampling=SAMPLING)
    return ranks, refs


def _requests():
    rng = np.random.default_rng(21)
    lens = [3, 5, 9, 3, 5, 9, 3, 5, 9]
    reqs = [rng.integers(0, 50, n).astype(np.int32) for n in lens]
    base = reqs[2]  # 9 tokens: two whole blocks of 4 and a partial one
    reqs += [np.concatenate([base, rng.integers(0, 50, 4).astype(np.int32)])
             for _ in range(3)]
    return reqs


@pytest.fixture(scope="module")
def engine_lm():
    """The engine jobs' JAX model's weights, the requests and each
    request's JAX tokens."""
    jm, _ = _jax_lm(ENGINE_LM)
    reqs = _requests()
    return ({"lm": jax_params_to_numpy(jm)}, reqs,
            [jm.generate(r[None], ENGINE_NEW)[0] for r in reqs])


@pytest.fixture(scope="module")
def engine(tmp_path_factory, engine_lm):
    """The 2-rank engine job and each request's JAX tokens."""
    params, reqs, want = engine_lm
    ranks = _launch(tmp_path_factory.mktemp("decode_mesh_engine"), _CHILD, 2, params,
                    cases=["engine"], lm=ENGINE_LM, heads=_heads_and_columns(2),
                    engine=ENGINE, new=ENGINE_NEW, requests=[r.tolist() for r in reqs])
    return ranks, want


@pytest.fixture(scope="module")
def subset(tmp_path_factory, engine_lm):
    """The 3-rank job: the engine on a machine over ranks 0 and 1."""
    params, reqs, want = engine_lm
    ranks = _launch(tmp_path_factory.mktemp("decode_mesh_subset"), _CHILD, 3, params,
                    cases=["subset"], lm=ENGINE_LM, heads=_heads_and_columns(2),
                    engine=ENGINE, new=ENGINE_NEW, requests=[r.tolist() for r in reqs])
    return ranks, want


# ---------------------------------------------------------------- the transformer

def _lm_checks(got, ref):
    np.testing.assert_allclose(got["probs"], ref["probs"], **TOL)
    np.testing.assert_array_equal(got["greedy"], ref["greedy"])
    for key in ("beam", "beam_eos"):
        (seqs, scores), (jseqs, jscores) = got[key], ref[key]
        fin = np.isfinite(jscores)  # a -inf beam's tokens are an arbitrary tie break
        np.testing.assert_array_equal(np.isfinite(scores), fin)
        np.testing.assert_array_equal(seqs[fin], jseqs[fin])
        np.testing.assert_allclose(scores[fin], jscores[fin], rtol=1e-5)


@pytest.mark.parametrize("rank", [0, 1])
def test_head_split_transformer_decodes_as_the_jax_package(models, rank):
    ranks, refs = models
    got = ranks[rank]["heads"]
    _lm_checks(got, refs["lm"])
    # each rank caches its 2 of the 4 heads and holds half the vocabulary head
    assert got["cache_heads"] == (1, 2, 8, 8)
    assert got["lm_head_local"] == (32, 25)


def test_sampled_generate_is_the_same_on_every_rank_and_on_one_device(models):
    ranks, refs = models
    np.testing.assert_array_equal(ranks[0]["heads"]["sampled"], ranks[1]["heads"]["sampled"])
    np.testing.assert_array_equal(ranks[0]["heads"]["sampled"], refs["sampled"])
    assert not np.array_equal(refs["sampled"], refs["lm"]["greedy"])


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_trained_transformer_on_4_ranks_decodes_as_the_jax_package(trained, rank):
    ranks, refs = trained
    _lm_checks(ranks[rank]["trained"], refs)


def test_trained_transformer_samples_alike_on_every_rank(trained):
    ranks, _ = trained
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["trained"]["sampled"], ranks[0]["trained"]["sampled"])


# ---------------------------------------------------------------- the zoo

@pytest.mark.parametrize("rank", [0, 1])
def test_nmt_greedy_translate_with_the_lstms_split(models, rank):
    ranks, refs = models
    np.testing.assert_array_equal(ranks[rank]["nmt"]["tokens"], refs["nmt"])
    assert ranks[rank]["nmt"]["cache"] == (1, 8)  # this rank's half of h


@pytest.mark.parametrize("rank", [0, 1])
def test_moe_transformer_generate_with_the_experts_split(models, rank):
    ranks, refs = models
    np.testing.assert_array_equal(ranks[rank]["moe"]["greedy"], refs["moe"])
    assert ranks[rank]["moe"]["w_in_local"] == (2, 32, 128)  # 2 of 4 experts


@pytest.mark.parametrize("rank", [0, 1])
def test_pipelined_model_generates_as_the_unpipelined_jax_model(models, rank):
    ranks, refs = models
    assert ranks[rank]["pipe"]["packed"]
    np.testing.assert_array_equal(ranks[rank]["pipe"]["greedy"], refs["pipe"])


@pytest.mark.parametrize("rank", [0, 1])
def test_pipeline_mlp_decodes_its_stages_in_order(models, rank):
    """A PipelineMLP split over the 2 ranks (one stage each) decodes with
    its stages gathered whole, never through the GPipe ring."""
    ranks, refs = models
    got = ranks[rank]["pmlp"]
    assert got["local"] == (1, 16, 16) and got["decoded"] == (2, 16, 16)
    np.testing.assert_array_equal(got["greedy"], refs["pmlp"])


@pytest.mark.parametrize("rank", [0, 1])
def test_host_table_model_generates_as_the_jax_package(models, rank):
    ranks, refs = models
    got = ranks[rank]["host"]
    assert got["sparse"] == ["tok_embed"] and got["rows"] == (25, 32)  # half the rows
    np.testing.assert_array_equal(got["greedy"], refs["lm"]["greedy"])


# ---------------------------------------------------------------- the engine

@pytest.mark.parametrize("paged", ["off", "on"], ids=["dense", "paged"])
def test_engine_on_a_mesh_serves_the_jax_tokens(engine, paged):
    ranks, want = engine
    lead, follow = ranks[0][paged], ranks[1][paged]
    assert lead["leader"] and not follow["leader"]
    assert lead["world"] == follow["world"] == 2
    assert lead["healthz"]["world_size"] == 2 and lead["healthz"]["status"] == "ok"
    assert len(lead["tokens"]) == len(want)
    for got, w in zip(lead["tokens"], want):
        np.testing.assert_array_equal(got, w)
    if paged == "on":
        assert lead["kv"]["prefix_hits"] >= 3


@pytest.mark.parametrize("paged", ["off", "on"], ids=["dense", "paged"])
def test_engine_follower_refuses_submit_and_stops_with_the_leader(engine, paged):
    ranks, _ = engine
    lead, follow = ranks[0][paged], ranks[1][paged]
    assert "leader, rank 0" in follow["submit_error"]
    assert "leader, rank 0" in follow["api_error"]  # the HTTP front binds on the leader
    assert not follow["alive"] and not lead["alive"]
    assert follow["crashed"] is None and lead["crashed"] is None
    # the follower's loop ended at the leader's stop plan, within the timeout
    assert follow["t_stop"] - lead["t_stop"] < ENGINE["replica_timeout_s"]


def test_killed_leader_ends_its_followers_within_the_timeout(engine):
    ranks, _ = engine
    lead, follow = ranks[0]["kill"], ranks[1]["kill"]
    assert lead["crashed"] and "ChaosReplicaKill" in lead["crashed"]
    assert lead["errors"] >= 1  # a standalone engine fails what it held
    assert follow["raised"] and "died" in follow["raised"] and not follow["alive"]
    assert follow["ended_s"] < ENGINE["replica_timeout_s"]


def test_silent_leader_times_its_follower_out(engine):
    ranks, _ = engine
    got = ranks[1]["silent"]
    assert got["crashed"] and "LeaderLost" in got["crashed"]
    assert ENGINE["replica_timeout_s"] - 0.5 <= got["ended_s"] < ENGINE["replica_timeout_s"] + 5


@pytest.mark.parametrize("side", ["leader", "follower"])
def test_step_fault_after_the_plan_ends_every_rank(engine, side):
    """A step that fails on one rank after its plan was sent ends the loop
    on both: the leader's fault sends the abort plan (the follower's
    ``LeaderLost``); the follower's leaves the leader's next plan
    unanswered, and the leader's send times out.  No request hangs, and
    the leader's ``/healthz`` says down."""
    ranks, _ = engine
    lead, follow = ranks[0][f"{side}_fault"], ranks[1][f"{side}_fault"]
    timeout = ENGINE["replica_timeout_s"]
    assert not lead["alive"] and not follow["alive"]
    assert lead["crashed"].startswith("LockstepBroken")
    assert follow["crashed"].startswith("LeaderLost" if side == "leader" else "LockstepBroken")
    assert follow["raised"] == ("LeaderLost" if side == "leader" else "LockstepBroken")
    assert "planted step fault" in (lead if side == "leader" else follow)["crashed"]
    if side == "follower":
        assert "did not take the leader's plan" in lead["crashed"]
    assert all(st == "error" for st in lead["statuses"]), lead["statuses"]
    assert lead["healthz"] == (503, "down")
    assert max(lead["ended_s"], follow["ended_s"]) < timeout + 5


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_engine_on_a_machine_over_some_ranks(subset, rank):
    """A machine over ranks 0 and 1 of 3 (``Machine.for_ranks``, as the
    elastic runtime makes for its survivors): its ranks serve in lockstep
    while rank 2, benched, builds no engine; a machine made afterwards over
    ranks 1 and 2 still meets."""
    ranks, want = subset
    got = ranks[rank]["subset"]
    assert got["benched"] == (rank == 2)
    assert got.get("later_sum") == (None if rank == 0 else 2.0)
    if rank == 0:
        assert got["world"] == 2 and got["crashed"] is None
        assert len(got["tokens"]) == len(want)
        for t, w in zip(got["tokens"], want):
            np.testing.assert_array_equal(t, w)
    elif rank == 1:
        assert got["world"] == 2 and got["crashed"] is None and got["tokens"] is None


@pytest.mark.parametrize("rank", [0, 1])
def test_decoding_after_the_process_group_is_formed_again(regroup, rank):
    """A process that shut its group down, ran a one-rank mesh (rank 0)
    and joined a new group of 2 decodes the JAX tokens in each; on gloo
    this works (on NCCL it is ROADMAP C10's open fault)."""
    ranks, want = regroup
    if rank == 0:
        assert ranks[0]["one"]["world"] == 1
        np.testing.assert_array_equal(ranks[0]["one"]["greedy"], want)
    assert ranks[rank]["again"]["world"] == 2
    np.testing.assert_array_equal(ranks[rank]["again"]["greedy"], want)
