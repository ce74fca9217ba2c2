"""The SOAP slice without worker processes: the strategy codec and the mesh
lowering against the JAX package, and the port on a one-rank process
group (gloo, in this process) against its single-device path.

* Codec: a ``.pb`` written by either package decodes to the same map in
  the other, both write the same bytes, and the shipped 16-device files
  decode equal.
* Mesh: the port's pure lowering reproduces tests/test_sharding.py's 8
  device cases, each held against the JAX ``PartitionSpec``.
* One rank: strategy import/export and the rank-mismatch fallback
  (tests/test_sharding.py:110-140 at world size 1), ``host_local_batch``,
  the SOAP path against the plain path (the same numbers), and the kernel
  wrappers' refusal of a DTensor.
"""

import os

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.parallel import strategy as jax_strategy
from flexflow_tpu.parallel.mesh import Machine as JaxMachine
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.kernels import fused_optimizer as fo
from flexflow_tpu_torch.parallel import distributed as dist
from flexflow_tpu_torch.parallel import mesh
from flexflow_tpu_torch.parallel import strategy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = ["alexnet_16.pb", "dlrm_16.pb", "nmt_16.pb"]


def _map(pkg):
    P, D = pkg.ParallelConfig, pkg.DeviceType
    return {"conv1": P(dims=(2, 2, 2, 1), device_ids=tuple(range(8))),
            "fc1": P(dims=(2, 4), device_ids=(0, 1, 2, 3, 4, 5, 6, 7)),
            "emb": P(D.CPU, (1, 1), (0,), ("host", "hbm")),
            "big": P(dims=(300, 1))}


def _same(port_map, jax_map):
    assert list(port_map) == list(jax_map)
    for name, pc in port_map.items():
        j = jax_map[name]
        assert (pc.device_type.value, pc.dims, pc.device_ids, pc.memory_types) == \
            (j.device_type.value, j.dims, j.device_ids, j.memory_types), name


# ---------------------------------------------------------------- codec

@pytest.mark.parametrize("reference_order", [False, True])
def test_files_cross_decode_and_write_the_same_bytes(tmp_path, reference_order):
    jpath, ppath = str(tmp_path / "jax.pb"), str(tmp_path / "port.pb")
    jax_strategy.save_strategies_to_file(jpath, _map(ff))
    strategy.save_strategies_to_file(ppath, _map(ft))
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()
    _same(strategy.load_strategies_from_file(jpath, reference_order),
          jax_strategy.load_strategies_from_file(ppath, reference_order))
    assert strategy.strategies_fingerprint(_map(ft)) == \
        jax_strategy.strategies_fingerprint(_map(ff))


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_strategy_files_decode_equal(name):
    path = os.path.join(ROOT, "strategies", name)
    port = strategy.load_strategies_from_file(path)
    _same(port, jax_strategy.load_strategies_from_file(path))
    with open(path, "rb") as f:
        data = f.read()
    assert strategy.strategy_content_hash(data) == jax_strategy.strategy_content_hash(data)


def test_provenance_sidecar(tmp_path):
    path = str(tmp_path / "s.pb")
    strategy.save_strategies_to_file(path, _map(ft), provenance={"engine": "manual"})
    meta = jax_strategy.read_provenance(path)
    assert meta["engine"] == "manual" and meta["strategy_file"] == "s.pb"
    with open(path, "rb") as f:
        assert meta["content_hash"] == strategy.strategy_content_hash(f.read())
    assert strategy.sidecar_path(path) == jax_strategy.sidecar_path(path)


# ---------------------------------------------------------------- mesh

SIZES, NAMES = mesh.mesh_shape(8)


def test_mesh_factoring_matches_the_jax_machine(devices):
    jm = JaxMachine(devices)
    assert SIZES == jm.axis_sizes == (2, 2, 2) and NAMES == jm.axis_names
    assert mesh.mesh_shape(12) == ((3, 2, 2), ("m0", "m1", "m2"))
    assert mesh.mesh_shape(1) == ((1,), ("m0",))
    with pytest.raises(ValueError):
        mesh.axes_for_degrees(NAMES, SIZES, [3])
    with pytest.raises(ValueError):
        jm.axes_for_degrees([3])


@pytest.mark.parametrize("dims,placements", [
    ((4, 1, 2, 1), (Shard(0), Shard(0), Shard(2))),
    ((8, 1), (Shard(0), Shard(0), Shard(0))),
    ((1, 1), (Replicate(), Replicate(), Replicate())),
    ((2, 4), (Shard(0), Shard(1), Shard(1))),
    ((1, 1, 2, 4), (Shard(2), Shard(3), Shard(3))),
    ((2, 2, 2, 1), (Shard(0), Shard(1), Shard(2))),
    ((1, 2, 1), (Shard(1), Replicate(), Replicate())),
])
def test_spec_and_placements_match_the_jax_partition_spec(devices, dims, placements):
    spec = tuple(JaxMachine(devices).spec_for_config(ff.ParallelConfig(dims=dims)))
    groups = mesh.axes_for_degrees(NAMES, SIZES, dims)
    assert tuple(None if not g else (g[0] if len(g) == 1 else g) for g in groups) == \
        spec + (None,) * (len(dims) - len(spec))
    assert mesh.placements_for_degrees(NAMES, SIZES, dims) == placements
    # each mesh dim's Shard(i) is exactly where the JAX spec names that dim
    for name, p in zip(NAMES, placements):
        owner = [i for i, e in enumerate(spec)
                 if e == name or (isinstance(e, tuple) and name in e)]
        assert owner == ([p.dim] if isinstance(p, Shard) else [])


def test_shard_slices_nest_in_mesh_dim_order():
    # tensor dim 0 split over mesh dims 0 and 1 of a (2, 2) mesh: the
    # device at (i, j) holds quarter 2i + j, the JAX spec's ('m0', 'm1')
    pl = (Shard(0), Shard(0))
    for i in range(2):
        for j in range(2):
            s = mesh.shard_slices((8, 3), pl, (2, 2), (i, j))
            assert (s[0].start, s[0].stop, s[1]) == (2 * (2 * i + j), 2 * (2 * i + j) + 2,
                                                    slice(0, 3))
    with pytest.raises(ValueError):
        mesh.shard_slices((6,), (Shard(0),), (4,), (0,))


# ---------------------------------------------------------------- one rank

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo process group in this process, torn down after the
    module's tests."""
    path = tmp_path_factory.mktemp("pg") / "init"
    dev = dist.initialize("cpu", init_method=f"file://{path}", world_size=1, rank=0)
    yield dev
    dist.shutdown()


HYBRID = {"conv1": (2, 2, 2, 1), "pool1": (2, 2, 1, 1), "flat1": (2, 1), "fc1": (2, 4),
          "fc2": (2, 1), "softmax1": (2, 1)}


def _cnn(cfg, batch=16):
    m = ft.FFModel(cfg)
    inp = m.create_tensor((batch, 3, 12, 12))
    t = m.conv2d(inp, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="conv1")
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = m.flat(t, name="flat1")
    t = m.dense(t, 32, activation="relu", name="fc1")
    t = m.dense(t, 10, name="fc2")
    m.softmax(t, name="softmax1")
    return m, inp


def test_import_export_strategy_file(one_rank, tmp_path):
    """tests/test_sharding.py's import/export at world size 1: the 8-part
    configs fall back to data parallelism over the one device, the export
    is what compile resolved, and legalization clamps a degree to one
    that divides the op's dim (10 % 4 != 0 -> 2)."""
    path, out = str(tmp_path / "st.pb"), str(tmp_path / "out.pb")
    strategy.save_strategies_to_file(
        path, {k: ft.ParallelConfig(dims=v) for k, v in HYBRID.items()})
    m, _ = _cnn(ft.FFConfig(batch_size=16, device="cpu", import_strategy_file=path,
                            export_strategy_file=out))
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    assert m.machine.num_devices == 1 and m.machine.mesh is not None
    assert [op.pc.dims for op in m.ops] == [(1, 1, 1, 1), (1, 1, 1, 1), (1, 1), (1, 1),
                                             (1, 1), (1, 1)]
    _same(strategy.load_strategies_from_file(out),
          jax_strategy.load_strategies_from_file(out))
    assert {k: v.dims for k, v in strategy.load_strategies_from_file(out).items()} == \
        {op.name: op.pc.dims for op in m.ops}
    m2 = ft.FFModel(ft.FFConfig(batch_size=16, device="cpu"))
    t2 = m2.dense(m2.create_tensor((16, 48), nchw=False), 10, name="fc1")
    m2.softmax(t2, name="softmax1")
    m2.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    assert m2.ops[0].legalize_pc(ft.ParallelConfig(dims=(2, 4))).dims == (2, 2)
    mha = ft.FFModel(ft.FFConfig(batch_size=4, device="cpu"))
    mha.multihead_attention(mha.create_tensor((4, 8, 32)), num_heads=4)
    assert mha.ops[0].legalize_pc(ft.ParallelConfig(dims=(2, 1, 8))).dims == (2, 1, 4)


def test_rank_mismatched_strategy_degrades_to_dp(one_rank):
    cfg = ft.FFConfig(batch_size=16, device="cpu")
    assert cfg.num_devices == 0  # every device of the compiled machine
    cfg.strategies["fc1"] = ft.ParallelConfig(dims=(2, 2, 1, 1))
    m = ft.FFModel(cfg)
    inp = m.create_tensor((16, 8), nchw=False)
    t = m.dense(inp, 16, activation="relu", name="fc1")
    t = m.dense(t, 4, name="fc2")
    m.softmax(t, name="sm")
    m.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"])
    fc1 = next(op for op in m.ops if op.name == "fc1")
    assert fc1.pc.ndims == 2 and fc1.pc.dims[0] == m.machine.num_devices
    m.init_layers(seed=0)
    assert isinstance(m._params["fc1"]["kernel"], DTensor)
    rng = np.random.default_rng(0)
    m.set_batch({inp: rng.standard_normal((16, 8), dtype=np.float32)},
                rng.integers(0, 4, size=(16, 1), dtype=np.int32))
    m.train_iteration()
    assert np.isfinite(m.get_metrics().accuracy)


def test_host_local_batch_on_one_rank(one_rank):
    machine = ft.Machine.from_process_group(one_rank)
    rows = np.arange(24, dtype=np.float32).reshape(12, 2)
    assert machine.batch_index(1) == 0
    np.testing.assert_array_equal(dist.local_batch(machine, rows, 1), rows)
    d = dist.host_local_batch(machine, rows, 1)
    assert isinstance(d, DTensor) and tuple(d.shape) == (12, 2)
    np.testing.assert_array_equal(d.full_tensor().numpy(), rows)
    assert (dist.process_count(), dist.process_index(), dist.is_coordinator()) == (1, 0, True)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_soap_path_on_one_rank_equals_the_plain_path(one_rank, opt):
    """The same CNN, weights and batches through DTensors on the one-rank
    mesh and through plain tensors (an explicit one-device Machine): the
    same per-device computations, so the same weights to the bit."""
    def run(single):
        m, inp = _cnn(ft.FFConfig(batch_size=8, device="cpu", fused_optimizer=True), batch=8)
        make = (lambda: ft.SGDOptimizer(m, lr=0.1, momentum=0.9)) if opt == "sgd" else \
            (lambda: ft.AdamOptimizer(m, alpha=1e-3))
        m.compile(make(), "sparse_categorical_crossentropy",
                  ["accuracy", "sparse_categorical_crossentropy"],
                  machine=ft.Machine(devices=["cpu"]) if single else None)
        assert (m.machine.mesh is None) == single
        m.init_layers(seed=4)
        rng = np.random.default_rng(2)
        x = rng.standard_normal((16, 3, 12, 12), dtype=np.float32)
        y = rng.integers(0, 10, size=(16, 1), dtype=np.int32)
        dl = ft.DataLoader(m, {inp: x}, y)
        for _ in range(3):
            dl.next_batch(m)
            m.train_iteration()
        met = m.get_metrics()
        return ({(op.name, w.name): m.get_parameter(op.name, w.name)
                 for op in m.ops for w in op.weights},
                (met.train_all, met.train_correct, met.sparse_cce_loss, m.last_loss),
                m.eval_batch(), m.predict_batch())

    (wa, ma, ea, pa), (wb, mb, eb, pb) = run(False), run(True)
    for key in wa:
        np.testing.assert_array_equal(wa[key], wb[key], err_msg=str(key))
    assert ma == mb and ea == eb
    np.testing.assert_array_equal(pa, pb)


def test_sequence_split_attention_raises(one_rank):
    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    x = m.create_tensor((2, 8, 32), nchw=False)
    m.multihead_attention(x, num_heads=4, causal=True, name="attn")
    m.compile(ft.SGDOptimizer(lr=0.1), "mean_squared_error", [])
    m.init_layers(seed=0)
    m.ops[0].pc = ft.ParallelConfig(dims=(1, 2, 1))
    m.set_batch({x: np.zeros((2, 8, 32), np.float32)}, np.zeros((2, 8, 32), np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        m.train_iteration()


def test_host_placed_strategy_raises(one_rank):
    cfg = ft.FFConfig(batch_size=2, device="cpu")
    cfg.strategies["fc"] = ft.ParallelConfig(ft.DeviceType.CPU, (1, 1))
    m = ft.FFModel(cfg)
    m.dense(m.create_tensor((2, 4), nchw=False), 3, name="fc")
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        m.compile(ft.SGDOptimizer(lr=0.1))


def test_kernel_wrappers_refuse_a_dtensor(one_rank):
    machine = ft.Machine.from_process_group(one_rank)
    w = machine.distribute(torch.randn(64), machine.replicated())
    g, m, v = (machine.distribute(torch.randn(64).abs(), machine.replicated())
               for _ in range(3))
    with pytest.raises(TypeError, match="DTensor"):
        fo.fused_sgd_update_multi([w], [g], [m], 0.1, 0.0, 0.9)
    with pytest.raises(TypeError, match="DTensor"):
        fo.fused_sgd_update(w, g, None, 0.1)
    with pytest.raises(TypeError, match="DTensor"):
        fo.fused_adam_update(w, g, m, v, 1e-3)
    q = machine.distribute(torch.randn(1, 2, 8, 32), machine.replicated())
    for call in (lambda: fa.flash_fwd(q, q, q, 0.25, True),
                 lambda: fa.flash_bwd_dkdv(q, q, q, q, None, None, None, 0.25, True),
                 lambda: fa.flash_bwd_dq(q, q, q, q, None, None, None, 0.25, True),
                 lambda: fa.flash_attention(q, q, q, causal=True)):
        with pytest.raises(TypeError, match="DTensor"):
            call()
    # the local shards go through (on the CPU, the plain versions)
    fo.fused_adam_update(w.to_local(), g.to_local(), m.to_local(), v.to_local(), 1e-3)
    assert fa.flash_fwd(q.to_local(), q.to_local(), q.to_local(), 0.25, True)[0].shape == \
        (1, 2, 8, 32)
