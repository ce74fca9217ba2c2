"""SOAP execution across processes: the port on gloo ranks against the JAX
package on one device.

Each world size launches its ranks once (a module-scoped fixture): one
Python subprocess per rank, running a code string that imports torch,
numpy and the port only (never jax: a child that unpickled a function of
this module would import it, and with it the JAX package).  The JAX side
runs here, on one device; the initial weights are transplanted from it
into every port run through a ``.npy`` file.

* CNN, 4 ranks on a (2, 2) mesh (the small CNN of
  tests/test_sharding.py:37-61): 6 SGD steps under SINGLE (every op
  unsplit), DP4, and a hybrid (conv1/pool1 (2, 2, 1, 1), fc1 (2, 2)
  column-parallel, the rest (2, 1)) imported from a ``.pb`` file; the
  hybrid again with 2 accumulated micro-batches, remat and the
  non-finite guard, then one batch with an inf.
  conv1 and fc2 must equal the JAX single-device run at rtol 5e-4,
  atol 5e-5 (tests/test_sharding.py:101-107).
* AlexNet on the same 4 ranks under strategies/alexnet_16.pb legalized
  onto them (the 8-part configs fall back to DP4, fc1/fc2 are
  column-parallel (1, 2), conv3/pool1/pool3 (2, 1, 1, 1)): 63x63 input,
  batch 8, 3 SGD-momentum steps, every weight within
  tests/test_torch_alexnet.py's rtol 1e-4, atol 1e-5.
* Transformer, 2 ranks (2 layers, E 64, 4 heads, S 32, vocab 128,
  causal): 3 steps under data parallelism (2, 1, 1) and under head/column
  parallelism (1, 1, 2) for the attention and dense ops, with SGD and
  with Adam, every weight within tests/test_torch_transformer.py's rtol
  1e-4, atol 1e-5.  Adam takes alpha 1e-4, as tests/test_torch_alexnet.py
  does: its uncorrected first step moves each weight by about alpha
  whatever its gradient's size.
* NMT, 2 ranks (vocab 64, seq 6, hidden 16, Adam): ``embed_dst`` reads
  ``embed_src``'s table, placed once under the owner's config.  3 steps
  under data parallelism, and with the owner column-split (1, 1, 2) while
  its sharer stays batch-split (2, 1, 1), every weight within rtol 1e-4,
  atol 1e-5 of the JAX single-device run; the MoE transformer (2 layers,
  E 64, 4 experts every layer, S 16, batch 4) under data parallelism
  alike, its capacity and queue places the global batch's; an LSTM hidden
  split (1, 1, 2) and an expert split (1, 2, 1) alike.

On the CPU the flash and optimizer kernels are their plain versions.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

import flexflow_tpu as ff
from flexflow_tpu.models.transformer import build_transformer as jax_build_transformer
from flexflow_tpu.models.transformer import synthetic_lm_batch
from flexflow_tpu.parallel import strategy as jax_strategy
from flexflow_tpu_torch.convert import jax_params_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNN_TOL = dict(rtol=5e-4, atol=5e-5)
ALEX = dict(batch=8, side=63, steps=3)
LM_TOL = dict(rtol=1e-4, atol=1e-5)
CNN_BATCH, CNN_STEPS = 16, 6
LM = dict(batch=4, seq_length=32, num_layers=2, embed_dim=64, num_heads=4, vocab_size=128)
LM_STEPS = 3
METRICS = ["accuracy", "sparse_categorical_crossentropy"]

HYBRID = {"conv1": (2, 2, 1, 1), "pool1": (2, 2, 1, 1), "flat1": (2, 1), "fc1": (2, 2),
          "fc2": (2, 1), "softmax1": (2, 1)}
DP4 = {"conv1": (4, 1, 1, 1), "pool1": (4, 1, 1, 1), "flat1": (4, 1), "fc1": (4, 1),
       "fc2": (4, 1), "softmax1": (4, 1)}
SINGLE = {k: (1,) * len(v) for k, v in DP4.items()}

# What every child runs first: the port, a gloo rank of the job's world.
_PRELUDE = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
job = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
sys.path.insert(0, job["root"])
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.convert import load_jax_params
from flexflow_tpu_torch.parallel import distributed as dist
early = ft.FFConfig(batch_size=16, device="cpu")  # built before the group exists
dist.initialize("cpu", init_method=job["init"], world_size=job["world"], rank=rank)
params0 = np.load(job["params"], allow_pickle=True).item()
out = {}
"""

_CNN = _PRELUDE + r"""
import os
data = np.load(job["data"])
for name, run in job["runs"].items():
    os.environ["FF_SKIP_NONFINITE"] = str(run.get("guard", 0))
    cfg = ft.FFConfig(batch_size=16, device="cpu", fused_optimizer=True,
                      strategies={k: ft.ParallelConfig(dims=tuple(v))
                                  for k, v in run.get("strategies", {}).items()},
                      import_strategy_file=run.get("import", ""),
                      export_strategy_file=run.get("export", ""),
                      grad_accum_steps=run.get("accum", 1), remat=run.get("remat", False))
    m = ft.FFModel(cfg)
    inp = m.create_tensor((16, 3, 12, 12))
    t = m.conv2d(inp, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="conv1")
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = m.flat(t, name="flat1")
    t = m.dense(t, 32, activation="relu", name="fc1")
    t = m.dense(t, 10, name="fc2")
    m.softmax(t, name="softmax1")
    m.compile(ft.SGDOptimizer(m, lr=0.1), "sparse_categorical_crossentropy",
              ["accuracy", "sparse_categorical_crossentropy"])
    m.init_layers(seed=9)
    load_jax_params(m, params0)
    dl = ft.DataLoader(m, {inp: data["x"]}, data["y"])
    for _ in range(job["steps"]):
        dl.next_batch(m)
        m.train_iteration()
    met = m.get_metrics()
    out[name] = dict(
        eval=m.eval_batch(), probs=m.predict_batch(),
        conv1=m.get_parameter("conv1", "kernel"), fc2=m.get_parameter("fc2", "kernel"),
        fc1_local=tuple(m._params["fc1"]["kernel"].to_local().shape),
        pcs={op.name: op.pc.dims for op in m.ops},
        metrics=(met.train_all, met.train_correct, met.sparse_cce_loss))
    if run.get("guard"):
        # a batch with an inf: every rank skips the step, and each keeps
        # its shards bitwise; the skip is counted once over the parts
        before = [w.to_local().clone() for ws in m._params.values() for w in ws.values()]
        bad = data["x"][:16].transpose(0, 2, 3, 1).copy()  # NHWC, as the loader stages
        bad[5, 0, 0, 0] = np.inf
        m.set_batch({inp: bad}, data["y"][:16])
        m.train_iteration()
        after = [w.to_local() for ws in m._params.values() for w in ws.values()]
        m.get_metrics()
        out[name]["guard"] = (all(torch.equal(a, b) for a, b in zip(before, after)),
                              m._guard.total_skipped, m._guard.consec)
os.environ.pop("FF_SKIP_NONFINITE")
from flexflow_tpu_torch.models.alexnet import build_alexnet
alex = job["alexnet"]
m = ft.FFModel(ft.FFConfig(batch_size=alex["batch"], device="cpu", fused_optimizer=True,
                           import_strategy_file=alex["strategy"]))
inp, _ = build_alexnet(m, alex["batch"], height=alex["side"], width=alex["side"])
m.compile(ft.SGDOptimizer(m, lr=0.01, momentum=0.9, weight_decay=1e-4),
          "sparse_categorical_crossentropy", ["accuracy", "sparse_categorical_crossentropy"])
m.init_layers(seed=9)
load_jax_params(m, np.load(alex["params"], allow_pickle=True).item())
dl = ft.DataLoader.synthetic(m, inp, num_samples=alex["batch"])
for _ in range(alex["steps"]):
    dl.next_batch(m)
    m.train_iteration()
m.get_metrics()
out["alexnet"] = dict(
    weights={(op.name, w.name): m.get_parameter(op.name, w.name)
             for op in m.ops for w in op.weights},
    pcs={op.name: op.pc.dims for op in m.ops}, loss=m.last_loss)
def small(cfg):
    m = ft.FFModel(cfg)
    m.softmax(m.dense(m.create_tensor((16, 8), nchw=False), 4, name="fc"), name="sm")
    return m
m = small(early)
m.compile(ft.SGDOptimizer(m, lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
out["default_pcs"] = {op.name: op.pc.dims for op in m.ops}
m = small(ft.FFConfig(batch_size=16, device="cpu", workers_per_node=2))
try:
    m.compile(ft.SGDOptimizer(m, lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    out["workers_error"] = ""
except ValueError as e:
    out["workers_error"] = str(e)
machine = ft.Machine.from_process_group(torch.device("cpu"))
out["rows"] = {d: dist.local_batch(machine, np.arange(16), d).tolist() for d in (1, 2, 4)}
out["coordinate"] = tuple(machine.mesh.get_coordinate())
np.save(job["out"] % rank, out, allow_pickle=True)
dist.shutdown()
"""

_LM = _PRELUDE + r"""
from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch
lm = job["lm"]
for name, run in job["runs"].items():
    m = ft.FFModel(ft.FFConfig(batch_size=lm["batch"], device="cpu", fused_optimizer=True))
    tok, pos, _ = build_transformer(m, lm["batch"], **{k: v for k, v in lm.items()
                                                        if k != "batch"})
    if run["tp"]:
        m.config.strategies = {op.name: ft.ParallelConfig(dims=(1, 1, 2)) for op in m.ops
                               if op._type in ("MultiHeadAttention", "Dense")}
    opt = (ft.SGDOptimizer(m, lr=0.05, momentum=0.9, weight_decay=1e-4) if run["opt"] == "sgd"
           else ft.AdamOptimizer(m, alpha=1e-4, weight_decay=1e-4))
    m.compile(opt, "sparse_categorical_crossentropy", ["accuracy", "sparse_categorical_crossentropy"])
    m.init_layers(seed=9)
    load_jax_params(m, params0)
    losses = []
    for step in range(job["steps"]):
        toks, posa, labels = synthetic_lm_batch(lm["batch"], lm["seq_length"],
                                                lm["vocab_size"], seed=10 + step)
        m.set_batch({tok: toks, pos: posa}, labels)
        m.train_iteration()
        m.get_metrics()
        losses.append(m.last_loss)
    met = m.get_metrics()
    out[name] = dict(
        weights={(op.name, w.name): m.get_parameter(op.name, w.name)
                 for op in m.ops for w in op.weights},
        wq_local=tuple(m._params["attn_0"]["wq"].to_local().shape),
        pcs={op.name: op.pc.dims for op in m.ops}, losses=losses,
        metrics=(met.train_all, met.train_correct, met.sparse_cce_loss))
np.save(job["out"] % rank, out, allow_pickle=True)
dist.shutdown()
"""


_ZOO = _PRELUDE + r"""
from flexflow_tpu_torch.models.nmt import build_nmt, synthetic_batch
from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch
nmt, moe = job["nmt"], job["moe"]
for name, run in job["runs"].items():
    m = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu", fused_optimizer=True,
                               strategies={k: ft.ParallelConfig(dims=tuple(v))
                                           for k, v in run["strategies"].items()}))
    if run["model"] == "nmt":
        ins = list(build_nmt(m, 4, **nmt)[:2])
        opt = ft.AdamOptimizer(m, alpha=1e-2)

        def batch(step):
            src, dst, labels = synthetic_batch(4, nmt["seq_length"], nmt["vocab_size"],
                                               seed=step)
            return [src, dst], labels
    else:
        ins = list(build_transformer(m, 4, **moe)[:2])
        opt = ft.SGDOptimizer(m, lr=0.05, momentum=0.9)

        def batch(step):
            toks, posa, labels = synthetic_lm_batch(4, moe["seq_length"], moe["vocab_size"],
                                                    seed=10 + step)
            return [toks, posa], labels
    try:
        m.compile(opt, "sparse_categorical_crossentropy", ["accuracy"])
    except NotImplementedError as e:
        out[name] = dict(error=str(e))
        continue
    m.init_layers(seed=9)
    load_jax_params(m, params0[run["model"]])
    losses = []
    for step in range(job["steps"]):
        xs, labels = batch(step)
        m.set_batch(dict(zip(ins, xs)), labels)
        m.train_iteration()
        m.get_metrics()
        losses.append(m.last_loss)
    out[name] = dict(
        weights={(op.name, w.name): m.get_parameter(op.name, w.name)
                 for op in m.ops for w in op.weights},
        pcs={op.name: op.pc.dims for op in m.ops}, losses=losses,
        leaves=sorted((o, w) for o, ws in m._params.items() for w in ws),
        placements={o: str(m._params[o][next(iter(ws))].placements)
                    for o, ws in m._params.items()})
np.save(job["out"] % rank, out, allow_pickle=True)
dist.shutdown()
"""


def _launch(tmp, code, world, params, **job):
    """Run ``code`` on ``world`` gloo ranks; returns each rank's results."""
    np.save(tmp / "params.npy", params, allow_pickle=True)
    job.update(root=ROOT, world=world, init=f"file://{tmp / 'pg'}",
               params=str(tmp / "params.npy"), out=str(tmp / "out_%d.npy"))
    with open(tmp / "job.json", "w") as f:
        json.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp / "job.json"), str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    finally:
        for p in procs:  # a failed or hung sibling must not outlive the test
            if p.poll() is None:
                p.kill()
    return [np.load(tmp / f"out_{r}.npy", allow_pickle=True).item() for r in range(world)]


# ---------------------------------------------------------------- CNN, 4 ranks

def _jax_cnn(x, y):
    m = ff.FFModel(ff.FFConfig(batch_size=CNN_BATCH, workers_per_node=1))
    inp = m.create_tensor((CNN_BATCH, 3, 12, 12))
    t = m.conv2d(inp, 8, 3, 3, 1, 1, 1, 1, activation=ff.ActiMode.RELU, name="conv1")
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = m.flat(t, name="flat1")
    t = m.dense(t, 32, activation=ff.ActiMode.RELU, name="fc1")
    t = m.dense(t, 10, name="fc2")
    m.softmax(t, name="softmax1")
    m.compile(ff.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", METRICS,
              machine=ff.Machine(devices=jax.devices()[:1]))
    m.init_layers(seed=3)
    params0 = jax_params_to_numpy(m)
    dl = ff.DataLoader(m, {inp: x}, y)
    for _ in range(CNN_STEPS):
        dl.next_batch(m)
        m.train_iteration()
    met = m.get_metrics()
    return params0, m, met


def _jax_alexnet():
    from flexflow_tpu.models.alexnet import build_alexnet as jax_build_alexnet

    m = ff.FFModel(ff.FFConfig(batch_size=ALEX["batch"], workers_per_node=1))
    inp, _ = jax_build_alexnet(m, ALEX["batch"], height=ALEX["side"], width=ALEX["side"])
    m.compile(ff.SGDOptimizer(m, lr=0.01, momentum=0.9, weight_decay=1e-4),
              "sparse_categorical_crossentropy", METRICS,
              machine=ff.Machine(devices=jax.devices()[:1]))
    m.init_layers(seed=0)
    params0 = jax_params_to_numpy(m)
    dl = ff.DataLoader.synthetic(m, inp, num_samples=ALEX["batch"])
    for _ in range(ALEX["steps"]):
        dl.next_batch(m)
        m.train_iteration()
    m.get_metrics()
    return params0, m


@pytest.fixture(scope="module")
def cnn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cnn4")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((CNN_BATCH * 2, 3, 12, 12), dtype=np.float32)
    y = rng.integers(0, 10, size=(CNN_BATCH * 2, 1), dtype=np.int32)
    np.savez(tmp / "data.npz", x=x, y=y)
    params0, jm, jmet = _jax_cnn(x, y)
    pb, exported = str(tmp / "hybrid.pb"), str(tmp / "exported.pb")
    jax_strategy.save_strategies_to_file(
        pb, {k: ff.ParallelConfig(dims=v) for k, v in HYBRID.items()})
    runs = {"single": {"strategies": SINGLE}, "dp4": {"strategies": DP4},
            "hybrid": {"import": pb, "export": exported},
            "hybrid_step_options": {"import": pb, "accum": 2, "remat": True, "guard": 3}}
    alex_params0, alex_jax = _jax_alexnet()
    np.save(tmp / "alex_params.npy", alex_params0, allow_pickle=True)
    alex = dict(ALEX, params=str(tmp / "alex_params.npy"),
                strategy=os.path.join(ROOT, "strategies", "alexnet_16.pb"))
    ranks = _launch(tmp, _CNN, 4, params0, data=str(tmp / "data.npz"), runs=runs,
                    steps=CNN_STEPS, alexnet=alex)
    return dict(ranks=ranks, jax=jm, jax_metrics=jmet, exported=exported,
                alexnet=alex_jax, jax_eval=jm.eval_batch(), jax_probs=jm.predict_batch())


@pytest.mark.parametrize("name", ["single", "dp4", "hybrid", "hybrid_step_options"])
def test_cnn_on_four_ranks_matches_jax_single_device(cnn, name):
    jm = cnn["jax"]
    for r, out in enumerate(cnn["ranks"]):
        got = out[name]
        for op in ("conv1", "fc2"):
            np.testing.assert_allclose(got[op], jm.get_parameter(op, "kernel"), **CNN_TOL,
                                       err_msg=f"rank {r} {name} {op}")
        jmet = cnn["jax_metrics"]
        assert got["metrics"][:2] == (jmet.train_all, jmet.train_correct)
        np.testing.assert_allclose(got["metrics"][2], jmet.sparse_cce_loss, **CNN_TOL)
        # eval_batch and predict_batch of the last staged batch, gathered
        assert got["probs"].shape == (CNN_BATCH, 10)
        np.testing.assert_allclose(got["probs"], cnn["jax_probs"], **CNN_TOL)
        for key, value in cnn["jax_eval"].items():
            if key in got["eval"]:
                np.testing.assert_allclose(got["eval"][key], value, **CNN_TOL, err_msg=key)
        assert {"train_all", "loss"} <= set(got["eval"])


def test_step_options_on_four_ranks(cnn):
    """Gradient accumulation (K = 2), remat and the non-finite guard on the
    SOAP path: the hybrid run above matches the JAX package's full-batch
    steps, and a batch with an inf is skipped on every rank alike."""
    for out in cnn["ranks"]:
        assert out["hybrid_step_options"]["pcs"] == HYBRID
        assert out["hybrid_step_options"]["guard"] == (True, 1, 1)


def test_cnn_strategies_resolve_and_shard_the_weights(cnn):
    want = {"single": SINGLE, "dp4": DP4, "hybrid": HYBRID}
    for out in cnn["ranks"]:
        for name, pcs in want.items():
            assert out[name]["pcs"] == pcs
        # fc1 (2, 2): the kernel's out dim split 2 ways on every rank
        assert out["hybrid"]["fc1_local"] == (288, 16)
        assert out["dp4"]["fc1_local"] == out["single"]["fc1_local"] == (288, 32)
    exported = jax_strategy.load_strategies_from_file(cnn["exported"])
    assert {k: v.dims for k, v in exported.items()} == HYBRID


def test_alexnet_under_the_shipped_strategy_on_four_ranks(cnn):
    jm = cnn["alexnet"]
    want = {"conv1": (4, 1, 1, 1), "pool1": (2, 1, 1, 1), "conv2": (4, 1, 1, 1),
            "pool2": (4, 1, 1, 1), "conv3": (2, 1, 1, 1), "conv4": (4, 1, 1, 1),
            "conv5": (4, 1, 1, 1), "pool3": (2, 1, 1, 1), "flat": (1, 1), "fc1": (1, 2),
            "fc2": (1, 2), "fc3": (1, 1), "softmax": (4, 1)}
    for r, out in enumerate(cnn["ranks"]):
        got = out["alexnet"]
        assert got["pcs"] == want
        assert np.isfinite(got["loss"])
        for (opn, wn), w in got["weights"].items():
            np.testing.assert_allclose(w, jm.get_parameter(opn, wn), **LM_TOL,
                                       err_msg=f"rank {r} {opn}/{wn}")


def test_default_config_is_data_parallel_over_the_world(cnn):
    """An FFConfig built before initialize() still defaults to data
    parallelism over every rank (the default follows the compiled
    machine), and two workers a node on a world of 4 raise."""
    for out in cnn["ranks"]:
        assert out["default_pcs"] == {"fc": (4, 1), "sm": (4, 1)}
        assert "machine has 4 device(s)" in out["workers_error"]


def test_host_local_batch_gives_each_rank_its_rows(cnn):
    for out in cnn["ranks"]:
        i, j = out["coordinate"]
        assert out["rows"][1] == list(range(16))
        # degree 2 splits over mesh dim m0; degree 4 over m0 then m1
        assert out["rows"][2] == list(range(8 * i, 8 * i + 8))
        k = 2 * i + j
        assert out["rows"][4] == list(range(4 * k, 4 * k + 4))


# ---------------------------------------------------------------- transformer, 2 ranks

def _jax_lm(opt):
    m = ff.FFModel(ff.FFConfig(batch_size=LM["batch"], workers_per_node=1,
                               compute_dtype="float32"))
    tok, pos, _ = jax_build_transformer(m, LM["batch"], **{k: v for k, v in LM.items()
                                                            if k != "batch"})
    o = (ff.SGDOptimizer(m, lr=0.05, momentum=0.9, weight_decay=1e-4) if opt == "sgd"
         else ff.AdamOptimizer(m, alpha=1e-4, weight_decay=1e-4))
    m.compile(o, "sparse_categorical_crossentropy", METRICS,
              machine=ff.Machine(devices=jax.devices()[:1]))
    m.init_layers(seed=0)
    params0 = jax_params_to_numpy(m)
    losses = []
    for step in range(LM_STEPS):
        toks, posa, labels = synthetic_lm_batch(LM["batch"], LM["seq_length"],
                                                LM["vocab_size"], seed=10 + step)
        m.set_batch({tok: toks, pos: posa}, labels)
        m.train_iteration()
        m.get_metrics()
        losses.append(m.last_loss)
    return params0, m, losses, m.get_metrics()


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm2")
    jax_runs = {opt: _jax_lm(opt) for opt in ("sgd", "adam")}
    params0 = jax_runs["sgd"][0]
    for opn, ws in jax_runs["adam"][0].items():  # one init, both optimizers
        for wn, w in ws.items():
            np.testing.assert_array_equal(w, params0[opn][wn])
    runs = {f"{mode}_{opt}": {"tp": mode == "tp", "opt": opt}
            for mode in ("dp", "tp") for opt in ("sgd", "adam")}
    ranks = _launch(tmp, _LM, 2, params0, lm=LM, runs=runs, steps=LM_STEPS)
    return dict(ranks=ranks, jax=jax_runs)


@pytest.mark.parametrize("mode", ["dp", "tp"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_transformer_on_two_ranks_matches_jax_single_device(lm, mode, opt):
    _, jm, j_losses, jmet = lm["jax"][opt]
    for r, out in enumerate(lm["ranks"]):
        got = out[f"{mode}_{opt}"]
        np.testing.assert_allclose(got["losses"], j_losses, **LM_TOL)
        assert got["metrics"][:2] == (jmet.train_all, jmet.train_correct)
        for (opn, wn), w in got["weights"].items():
            np.testing.assert_allclose(w, jm.get_parameter(opn, wn), **LM_TOL,
                                       err_msg=f"rank {r} {mode} {opt} {opn}/{wn}")


def test_transformer_head_parallel_configs_split_the_heads(lm):
    e = LM["embed_dim"]
    for out in lm["ranks"]:
        dp, tp = out["dp_sgd"], out["tp_sgd"]
        assert dp["pcs"]["attn_0"] == (2, 1, 1) and dp["wq_local"] == (e, e)
        assert tp["pcs"]["attn_0"] == tp["pcs"]["mlp_up_0"] == (1, 1, 2)
        assert tp["pcs"]["ln1_0"] == (2, 1, 1)
        assert tp["wq_local"] == (e, e // 2)


# ---------------------------------------------------------------- NMT and MoE, 2 ranks

ZOO_NMT = dict(seq_length=6, num_layers=2, hidden_size=16, embed_size=16, vocab_size=64)
ZOO_MOE = dict(seq_length=16, num_layers=2, embed_dim=64, num_heads=4, vocab_size=64,
               moe_every=1, num_experts=4)
ZOO_STEPS = 3


def _jax_zoo(name):
    from flexflow_tpu.models import nmt as jax_nmt

    m = ff.FFModel(ff.FFConfig(batch_size=4, workers_per_node=1, compute_dtype="float32"))
    if name == "nmt":
        ins = list(jax_nmt.build_nmt(m, 4, **ZOO_NMT)[:2])
        opt = ff.AdamOptimizer(m, alpha=1e-2)
    else:
        ins = list(jax_build_transformer(m, 4, **ZOO_MOE)[:2])
        opt = ff.SGDOptimizer(m, lr=0.05, momentum=0.9)
    m.compile(opt, "sparse_categorical_crossentropy", ["accuracy"],
              machine=ff.Machine(devices=jax.devices()[:1]))
    m.init_layers(seed=0)
    params0 = jax_params_to_numpy(m)
    losses = []
    for step in range(ZOO_STEPS):
        if name == "nmt":
            src, dst, labels = jax_nmt.synthetic_batch(4, 6, 64, seed=step)
            xs = [src, dst]
        else:
            toks, posa, labels = synthetic_lm_batch(4, 16, 64, seed=10 + step)
            xs = [toks, posa]
        m.set_batch(dict(zip(ins, xs)), labels)
        m.train_iteration()
        m.get_metrics()
        losses.append(m.last_loss)
    return params0, m, losses


ZOO_RUNS = {
    "nmt_dp": {"model": "nmt", "strategies": {}},
    # the owner's table split on its columns, the sharer's use batch-split
    "nmt_shared_split": {"model": "nmt", "strategies": {"embed_src": (1, 1, 2),
                                                        "embed_dst": (2, 1, 1)}},
    "moe_dp": {"model": "moe", "strategies": {}},
    "lstm_hidden_split": {"model": "nmt", "strategies": {"enc_lstm0": (1, 1, 2)}},
    "expert_split": {"model": "moe", "strategies": {"moe_0": (1, 2, 1)}},
}


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zoo2")
    jax_runs = {name: _jax_zoo(name) for name in ("nmt", "moe")}
    params0 = {name: r[0] for name, r in jax_runs.items()}
    ranks = _launch(tmp, _ZOO, 2, params0, nmt=ZOO_NMT, moe=ZOO_MOE, runs=ZOO_RUNS,
                    steps=ZOO_STEPS)
    return dict(ranks=ranks, jax=jax_runs)


@pytest.mark.parametrize("name", ["nmt_dp", "nmt_shared_split", "moe_dp"])
def test_zoo_on_two_ranks_matches_jax_single_device(zoo, name):
    _, jm, j_losses = zoo["jax"][ZOO_RUNS[name]["model"]]
    for r, out in enumerate(zoo["ranks"]):
        got = out[name]
        np.testing.assert_allclose(got["losses"], j_losses, **LM_TOL)
        for (opn, wn), w in got["weights"].items():
            np.testing.assert_allclose(w, jm.get_parameter(opn, wn), **LM_TOL,
                                       err_msg=f"rank {r} {name} {opn}/{wn}")


def test_a_shared_table_is_placed_once_by_its_owner(zoo):
    for out in zoo["ranks"]:
        for name in ("nmt_dp", "nmt_shared_split"):
            got = out[name]
            assert not any(o == "embed_dst" for o, _ in got["leaves"])
            assert ("embed_src", "weight") in got["leaves"]
        split = out["nmt_shared_split"]
        assert split["pcs"]["embed_src"] == (1, 1, 2)
        assert split["pcs"]["embed_dst"] == (2, 1, 1)
        assert split["placements"]["embed_src"] == "(Shard(dim=1),)"
        assert out["nmt_dp"]["placements"]["embed_src"] == "(Replicate(),)"


@pytest.mark.parametrize("name,what", [("lstm_hidden_split", "hidden split"),
                                       ("expert_split", "expert parallelism")])
def test_unported_zoo_splits_raise_at_compile(zoo, name, what):
    """The name is older than the port of these splits: an LSTM hidden split
    and an expert split now compile and train 3 steps to the JAX package's
    single-device weights."""
    _, jm, j_losses = zoo["jax"][ZOO_RUNS[name]["model"]]
    for r, out in enumerate(zoo["ranks"]):
        got = out[name]
        assert "error" not in got, f"{what}: {got.get('error')}"
        np.testing.assert_allclose(got["losses"], j_losses, **LM_TOL)
        for (opn, wn), w in got["weights"].items():
            np.testing.assert_allclose(w, jm.get_parameter(opn, wn), **LM_TOL,
                                       err_msg=f"rank {r} {name} {opn}/{wn}")
