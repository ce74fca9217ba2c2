"""Host-resident weights in the port against the JAX package, on the CPU
(after tests/test_sparse_host_embed.py and tests/test_host_offload.py).

On the CPU the host is the device: the tables are CPU tensors, and the
swap-in, the remap, the bucket ladder and the scatter-back run as on a
card (without pinned memory, side streams or events).

* Row-sparse tables (a CPU-typed config on an own-table Embedding fed from
  a graph input, plain SGD): training equals the dense device run bitwise
  (the JAX package's is held at rtol 2e-5, atol 2e-6; the port's gradient
  of a row is the same sum in the same order) and equals the JAX
  package's sparse run at rtol 2e-5, atol 2e-6; untouched rows do not
  move; the per-step transfer is the batch's (the compact leaf, at most
  ``u_max`` rows, whatever the table); the bucket ladder under repeated
  keys; ``FF_HE_SYNC_SCATTER``, eval, gradient accumulation and the fused
  optimizer compose; decode copies the table to the device once per
  version; a step the non-finite guard skips leaves the table bitwise; one
  captured graph per bucket on the compiled step (fake CUDA graphs).
* Momentum in auto mode streams the table (offload) and equals the device
  run; forced sparse momentum and Adam are lazy, and equal the JAX
  package's forced runs; a "host" memory type places a table too.
* ``.npz`` files move both ways with the JAX package (whole tables and
  their optimizer slots).
* One job of 4 gloo ranks: each rank owns a quarter of the table's rows;
  plain, pipelined (the table hoisted ahead of the ring as a heterogeneous
  head) and forced-lazy Adam, 3 steps each against the JAX package's run,
  and a checkpoint the ranks write that the JAX package loads.
"""

import numpy as np
import pytest
import torch

import jax

import flexflow_tpu as ff
from flexflow_tpu.config import DeviceType as JaxDeviceType
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.config import DeviceType
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
from flexflow_tpu_torch.runtime.step_graph import disable_graphs, graphs_enabled

from test_torch_soap import _PRELUDE, _launch
from test_torch_step import _FakeCuda

SPARSE_TOL = dict(rtol=2e-5, atol=2e-6)
BATCH, ROWS, WORLD = 16, 1000, 4


def _build(pkg, offload, rows=ROWS, momentum=0.0, sparse=None, batch=BATCH, grad_accum=1,
           fused=False, opt="sgd", memory_host=False):
    extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
    cfg = pkg.FFConfig(batch_size=batch, grad_accum_steps=grad_accum, fused_optimizer=fused,
                       **extra)
    cfg.sparse_host_embeddings = sparse
    dt = DeviceType if pkg is ft else JaxDeviceType
    if memory_host:
        cfg.strategies["emb"] = pkg.ParallelConfig(dt.GPU if pkg is ft else dt.TPU, (1, 1), (0,),
                                                   memory_types=("host",))
    elif offload:
        cfg.strategies["emb"] = pkg.ParallelConfig(dt.CPU, (1, 1), (0,))
    m = pkg.FFModel(cfg)
    ids = m.create_tensor((batch, 4), dtype="int32", name="ids")
    t = m.embedding(ids, rows, 8, name="emb")
    t = m.dense(t, 4, name="head")
    m.softmax(t, name="sm")
    optimizer = (pkg.AdamOptimizer(m, alpha=0.01) if opt == "adam"
                 else pkg.SGDOptimizer(m, lr=0.1, momentum=momentum))
    kw = dict(machine=ff.Machine(devices=jax.devices()[:1])) if pkg is ff else {}
    m.compile(optimizer, "sparse_categorical_crossentropy", ["accuracy"], **kw)
    m.init_layers(seed=11)
    return m, ids


def _data(rows=ROWS, batch=BATCH, seed=0):
    x = np.random.default_rng(seed).integers(0, rows, (batch, 4)).astype(np.int32)
    return x, (x[:, 0] % 4).astype(np.int32).reshape(-1, 1)


def _train(m, ids, steps, x=None, y=None):
    if x is None:
        x, y = _data(m.ops[0].num_entries, m.config.batch_size)
    for _ in range(steps):
        m.set_batch({ids: x}, y)
        m.train_iteration()
    m.sync()
    return m


def _pair(jax_kw, port_kw=None, steps=4):
    """The JAX package's model and the port's from its weights, both
    trained ``steps`` steps on the same batch."""
    jm, jids = _build(ff, **jax_kw)
    pm, pids = _build(ft, **(port_kw or jax_kw))
    load_jax_params(pm, jax_params_to_numpy(jm))
    return _train(jm, jids, steps), _train(pm, pids, steps)


def _weights(m):
    return {(op.name, w.name): np.asarray(m.get_parameter(op.name, w.name))
            for op in m.ops for w in op.weights}


def test_sparse_table_lives_on_the_host():
    m, _ = _build(ft, offload=True)
    assert list(m._host.sparse) == ["emb"] and not m._host.offload
    info = m._host.sparse["emb"]
    assert info["table"].device.type == "cpu" and info["table"].shape == (ROWS, 8)
    assert "emb" not in m._params  # the step's compact leaf is made at the swap-in


def test_sparse_training_equals_dense_bitwise_and_the_jax_package():
    jm, sparse = _pair(dict(offload=True), steps=8)
    assert "emb" in jm._host_embed and "emb" in sparse._host.sparse
    dense, ids = _build(ft, offload=False)
    load_jax_params(dense, jax_params_to_numpy(_build(ff, offload=True)[0]))
    _train(dense, ids, 8)
    for key, v in _weights(dense).items():
        np.testing.assert_array_equal(_weights(sparse)[key], v, err_msg=str(key))
    for key, v in _weights(jm).items():
        np.testing.assert_allclose(_weights(sparse)[key], v, **SPARSE_TOL)


def test_untouched_rows_do_not_move():
    m, ids = _build(ft, offload=True)
    before = m.get_parameter("emb", "weight")
    x, y = _data()
    _train(m, ids, 1, x, y)
    after = m.get_parameter("emb", "weight")
    touched = np.unique(x)
    untouched = np.setdiff1d(np.arange(ROWS), touched)
    np.testing.assert_array_equal(before[untouched], after[untouched])
    assert np.abs(after[touched] - before[touched]).max() > 0


def test_transfer_scales_with_the_batch_not_the_table():
    small, sids = _build(ft, offload=True, rows=500)
    large, lids = _build(ft, offload=True, rows=50_000)
    assert small._host.sparse["emb"]["u_max"] == large._host.sparse["emb"]["u_max"] == 64
    _train(small, sids, 1)
    _train(large, lids, 1)
    for m, rows in ((small, 500), (large, 50_000)):
        u = m._host.sparse["emb"]["u_hwm"]
        assert u <= 64 and m._params["emb"]["weight"].shape == (u, 8)
        # in: the compact leaf (the bucket's rows); out: the step's unique rows
        assert m._host.bytes_in == u * 8 * 4
        assert m._host.bytes_out == len(np.unique(_data(rows)[0])) * 8 * 4


def test_momentum_streams_and_equals_the_device_run():
    """Auto mode with momentum: the update moves every row, so the table
    streams (offload) and training equals the dense device run."""
    jm, m = _pair(dict(offload=True, momentum=0.9))
    assert not m._host.sparse and ("emb", "weight") in m._host.offload
    assert ("emb", "weight") in jm._offload
    info = m._host.offload[("emb", "weight")]
    assert set(info["slots"]) == {"v"} and info["host"].shape == (ROWS, 8)
    dense, _ = _pair(dict(offload=False, momentum=0.9))
    for key, v in _weights(dense).items():
        np.testing.assert_allclose(_weights(m)[key], v, **SPARSE_TOL)
    # 4 streamed bytes a step: the weight and its momentum, in and out
    assert m._host.bytes_in == m._host.bytes_out == 2 * ROWS * 8 * 4


@pytest.mark.parametrize("opt,momentum", [("sgd", 0.9), ("adam", 0.0)])
def test_forced_sparse_is_lazy_and_equals_the_jax_package(opt, momentum):
    jm, m = _pair(dict(offload=True, momentum=momentum, sparse=True, opt=opt), steps=3)
    assert "emb" in m._host.sparse and "emb" in jm._host_embed
    slots = {"sgd": ["v"], "adam": ["m", "v"]}[opt]
    assert sorted(m._host.sparse["emb"]["slots"]) == sorted(slots)
    for key, v in _weights(jm).items():
        np.testing.assert_allclose(_weights(m)[key], v, **SPARSE_TOL)
    for slot in slots:
        np.testing.assert_allclose(m._read_leaf(slot, "emb", "weight"),
                                   np.asarray(jm._opt_state[slot]["emb"]["weight"]),
                                   **SPARSE_TOL)


def test_offloaded_adam_equals_the_device_run():
    _, m = _pair(dict(offload=True, opt="adam", rows=512))
    assert ("emb", "weight") in m._host.offload
    _, dense = _pair(dict(offload=False, opt="adam", rows=512))
    for key, v in _weights(dense).items():
        np.testing.assert_allclose(_weights(m)[key], v, **SPARSE_TOL)


def test_a_host_memory_type_places_the_table():
    m, _ = _build(ft, offload=False, memory_host=True, rows=50)
    assert "emb" in m._host.sparse


def test_the_bucket_ladder_under_repeated_keys():
    m, ids = _build(ft, offload=True)
    info = m._host.sparse["emb"]
    y = np.zeros((BATCH, 1), np.int32)
    skew = (np.arange(64).reshape(BATCH, 4) % 5).astype(np.int32)  # 5 ids
    full = np.arange(64).reshape(BATCH, 4).astype(np.int32)
    _train(m, ids, 1, skew, y)
    assert info["u_max"] == 64 and info["u_hwm"] == 8
    assert m._params["emb"]["weight"].shape == (8, 8)
    _train(m, ids, 1, full, y)
    assert info["u_hwm"] == 64
    _train(m, ids, 1, skew, y)
    assert info["u_hwm"] == 64  # never shrinks
    assert info["uniq_rows_steps"] == 3 and info["uniq_rows_total"] == 5 + 64 + 5


def test_one_captured_graph_per_bucket(monkeypatch):
    """On the compiled step a bucket's compact leaf is a static buffer, so
    each bucket size is one capture; the ladder only grows.  Fake CUDA
    graphs replay what they captured (tests/test_torch_step.py)."""
    from flexflow_tpu_torch.runtime.step_graph import StepGraph

    _FakeCuda(monkeypatch)
    monkeypatch.setattr(ft.FFModel, "_use_graph",
                        lambda self: not self._sharded and graphs_enabled())

    def capture(self, step):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.fn = step
        self.captures += 1
    monkeypatch.setattr(StepGraph, "_capture", capture)
    graph, gids = _build(ft, offload=True)
    eager, eids = _build(ft, offload=True)
    y = np.zeros((BATCH, 1), np.int32)
    skew = (np.arange(64).reshape(BATCH, 4) % 5).astype(np.int32)
    batches = [skew] * 3 + [np.arange(64).reshape(BATCH, 4).astype(np.int32)] * 3 + [skew] * 2
    captures = []
    for x in batches:
        _train(graph, gids, 1, x, y)
        with disable_graphs():
            _train(eager, eids, 1, x, y)
        captures.append(graph._step_graph.captures)
    assert captures == [0, 1, 1, 1, 2, 2, 2, 2]  # buckets 8 then 64: two graphs
    for key, v in _weights(eager).items():
        np.testing.assert_array_equal(_weights(graph)[key], v, err_msg=str(key))


def test_sync_scatter_knob(monkeypatch):
    m, ids = _build(ft, offload=True)
    monkeypatch.setenv("FF_HE_SYNC_SCATTER", "1")
    x, y = _data()
    m.set_batch({ids: x}, y)
    m.train_iteration()
    assert m._host.pending is None  # written before update() returned
    monkeypatch.delenv("FF_HE_SYNC_SCATTER")
    m.train_iteration()
    assert m._host.pending is not None  # in flight until a read barrier
    w = m.get_parameter("emb", "weight")
    assert m._host.pending is None
    m2, ids2 = _build(ft, offload=True)
    _train(m2, ids2, 2, x, y)
    np.testing.assert_array_equal(m2.get_parameter("emb", "weight"), w)


def test_eval_and_predict_gather_the_batch_rows():
    jm, m = _pair(dict(offload=True), steps=2)
    for mm in (jm, m):
        mm.set_batch({mm.input_tensors[0]: _data()[0]}, _data()[1])
    before = m.get_parameter("emb", "weight")
    np.testing.assert_allclose(m.predict_batch(), jm.predict_batch(), **SPARSE_TOL)
    got, want = m.eval_batch(), jm.eval_batch()
    assert got["train_all"] == want["train_all"] == BATCH
    np.testing.assert_allclose(got["loss"], want["loss"], **SPARSE_TOL)
    np.testing.assert_array_equal(m.get_parameter("emb", "weight"), before)


def test_grad_accumulation_composes():
    d, dids = _build(ft, offload=False, rows=300, grad_accum=2)
    s, sids = _build(ft, offload=True, rows=300, grad_accum=2)
    jm, jids = _build(ff, offload=True, rows=300, grad_accum=2)
    w0 = jax_params_to_numpy(jm)
    load_jax_params(d, w0)
    load_jax_params(s, w0)
    for m, ids in ((d, dids), (s, sids), (jm, jids)):
        _train(m, ids, 4)
    for key, v in _weights(d).items():
        np.testing.assert_array_equal(_weights(s)[key], v, err_msg=str(key))
        np.testing.assert_allclose(v, _weights(jm)[key], **SPARSE_TOL)


def test_the_fused_optimizer_composes():
    """fused_optimizer routes the compact leaf through the multi-tensor SGD
    step with the rest (its plain version on the CPU)."""
    _, s = _pair(dict(offload=True, rows=500, fused=True))
    _, d = _pair(dict(offload=False, rows=500, fused=True))
    assert "emb" in s._host.sparse
    for key, v in _weights(d).items():
        np.testing.assert_array_equal(_weights(s)[key], v, err_msg=str(key))


def test_decode_copies_the_table_once_per_version():
    m, ids = _build(ft, offload=True)
    dp = m._decode_params()
    assert dp["emb"]["weight"].shape == (ROWS, 8)
    assert m._decode_params()["emb"]["weight"] is dp["emb"]["weight"]
    _train(m, ids, 1)
    dp2 = m._decode_params()
    assert dp2["emb"]["weight"] is not dp["emb"]["weight"]
    np.testing.assert_array_equal(dp2["emb"]["weight"].numpy(), m.get_parameter("emb", "weight"))


def test_a_guarded_nan_step_leaves_the_table_bitwise(monkeypatch):
    monkeypatch.setenv("FF_SKIP_NONFINITE", "5")
    m, ids = _build(ft, offload=True)
    x, y = _data()
    _train(m, ids, 2, x, y)
    before = m.get_parameter("emb", "weight")
    m.set_parameter("head", "kernel", np.full((8, 4), np.nan, np.float32))
    head = m.get_parameter("head", "bias")
    m.set_batch({ids: x}, y)
    m.train_iteration()
    m.get_metrics()
    assert m._guard.total_skipped == 1
    np.testing.assert_array_equal(m.get_parameter("emb", "weight"), before)
    np.testing.assert_array_equal(m.get_parameter("head", "bias"), head)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_npz_moves_both_ways_with_the_jax_package(opt, tmp_path):
    sparse = dict(offload=True, sparse=True if opt == "adam" else None, opt=opt)
    jm, pm = _pair(sparse, steps=2)
    path = str(tmp_path / "port.npz")
    pm.save(path)
    j2, _ = _build(ff, **sparse)
    j2.load(path)
    for key, v in _weights(pm).items():
        np.testing.assert_array_equal(_weights(j2)[key], v, err_msg=str(key))
    jpath = str(tmp_path / "jax.npz")
    jm.save(jpath)
    p2, _ = _build(ft, **sparse)
    p2.load(jpath)
    with np.load(jpath) as data:
        saved = {k: data[k] for k in data.files}
    np.testing.assert_array_equal(p2.get_parameter("emb", "weight"), saved["params/emb/weight"])
    for slot in p2._opt_state:
        np.testing.assert_array_equal(p2._read_leaf(slot, "emb", "weight"),
                                      saved[f"opt_state/{slot}/emb/weight"])
    assert p2._step_count == 2


# ---------------------------------------------------------------- 4 gloo ranks

_HOST = _PRELUDE + r"""
from flexflow_tpu_torch.config import DeviceType
data = np.load(job["data"])
x, y = data["x"], data["y"]
for name, run in job["runs"].items():
    cfg = ft.FFConfig(batch_size=16, device="cpu")
    cfg.sparse_host_embeddings = run.get("sparse")
    cfg.strategies["emb"] = ft.ParallelConfig(DeviceType.CPU, (1, 1), (0,))
    m = ft.FFModel(cfg)
    ids = m.create_tensor((16, 4), dtype="int32", name="ids")
    t = m.embedding(ids, 1000, 8, name="emb")
    t = m.dense(t, 24, activation="relu", name="fc1")
    t = m.dense(t, 24, activation="relu", name="fc2")
    t = m.dense(t, 4, name="head")
    m.softmax(t, name="sm")
    if run.get("pipeline"):
        m.set_pipeline(num_stages=2, num_microbatches=4)
    opt = ft.AdamOptimizer(m, alpha=0.01) if run["opt"] == "adam" else ft.SGDOptimizer(m, lr=0.1)
    m.compile(opt, "sparse_categorical_crossentropy", ["accuracy"])
    m.init_layers(seed=3)
    load_jax_params(m, params0[run["opt"]])
    for _ in range(job["steps"]):
        m.set_batch({ids: x}, y)
        m.train_iteration()
    m.get_metrics()
    info = m._host.sparse["emb"]
    plan = m._pipeline_plan
    out[name] = dict(
        rows=(info["row_lo"], info["row_hi"], tuple(info["table"].shape)),
        head=[o.name for o in plan["head"]] if plan else None,
        weights={(op.name, w.name): m.get_parameter(op.name, w.name)
                 for op in m.ops for w in op.weights})
    if name == "plain":
        m.save(job["ckpt"])
np.save(job["out"] % rank, out, allow_pickle=True)
dist.shutdown()
"""

HOST_RUNS = {"plain": dict(opt="sgd"), "pipeline": dict(opt="sgd", pipeline=True),
             "lazy_adam": dict(opt="adam", sparse=True)}


def _jax_hetero(opt, sparse=None, steps=3):
    cfg = ff.FFConfig(batch_size=BATCH, workers_per_node=1)
    cfg.sparse_host_embeddings = sparse
    cfg.strategies["emb"] = ff.ParallelConfig(JaxDeviceType.CPU, (1, 1), (0,))
    m = ff.FFModel(cfg)
    ids = m.create_tensor((BATCH, 4), dtype="int32", name="ids")
    t = m.embedding(ids, 1000, 8, name="emb")
    t = m.dense(t, 24, activation="relu", name="fc1")
    t = m.dense(t, 24, activation="relu", name="fc2")
    t = m.dense(t, 4, name="head")
    m.softmax(t, name="sm")
    optimizer = ff.AdamOptimizer(m, alpha=0.01) if opt == "adam" else ff.SGDOptimizer(m, lr=0.1)
    m.compile(optimizer, "sparse_categorical_crossentropy", ["accuracy"],
              machine=ff.Machine(devices=jax.devices()[:1]))
    m.init_layers(seed=3)
    params0 = jax_params_to_numpy(m)
    x, y = _data(1000)
    for _ in range(steps):
        m.set_batch({ids: x}, y)
        m.train_iteration()
    m.sync()
    return params0, m


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host4")
    x, y = _data(1000)
    np.savez(tmp / "data.npz", x=x, y=y)
    sgd0, jsgd = _jax_hetero("sgd")
    adam0, jadam = _jax_hetero("adam", sparse=True)
    ranks = _launch(tmp, _HOST, WORLD, {"sgd": sgd0, "adam": adam0}, data=str(tmp / "data.npz"),
                    runs=HOST_RUNS, steps=3, ckpt=str(tmp / "ranks.npz"))
    return dict(ranks=ranks, sgd=jsgd, adam=jadam, ckpt=str(tmp / "ranks.npz"))


def test_each_rank_owns_a_row_range(job):
    for r, out in enumerate(job["ranks"]):
        assert out["plain"]["rows"] == (250 * r, 250 * (r + 1), (250, 8))


@pytest.mark.parametrize("name", sorted(HOST_RUNS))
def test_host_tables_on_four_ranks_match_jax(job, name):
    want = job["adam" if name == "lazy_adam" else "sgd"]
    for out in job["ranks"]:
        for key, v in _weights(want).items():
            np.testing.assert_allclose(out[name]["weights"][key], v, **SPARSE_TOL,
                                       err_msg=str(key))


def test_the_table_runs_ahead_of_the_ring(job):
    assert all(out["pipeline"]["head"] == ["emb"] for out in job["ranks"])


def test_the_ranks_checkpoint_loads_into_the_jax_package(job):
    jm = _jax_hetero("sgd", steps=0)[1]
    jm.load(job["ckpt"])
    for key, v in _weights(job["sgd"]).items():
        np.testing.assert_allclose(_weights(jm)[key], v, **SPARSE_TOL, err_msg=str(key))
    assert jm._step_count == 3
