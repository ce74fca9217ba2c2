"""The port's DLRM strategy generators against the JAX package's
(tests/test_dlrm_strategy_tool.py; reference: src/runtime/
dlrm_strategy.cc and dlrm_strategy_hetero.cc).

Both tools run here, so the files are compared byte for byte (the JAX
package's own test of the wire format needs the reference's absent
strategy.proto; the bytes being equal, the port's files decode wherever
the JAX package's do).  The port loads either file under reference-order
semantics, and the hetero file drives a small DLRM's tables onto the
row-sparse host path, trained 3 steps against the JAX package's run from
the same weights (rtol 2e-5, atol 2e-6, tests/test_sparse_host_embed.py's
tolerance) and against the port's on-device run bitwise; the homogeneous
file compiles and trains too.
"""

import numpy as np
import pytest

import jax

import flexflow_tpu as ff
from flexflow_tpu.models.dlrm import build_dlrm as jax_build_dlrm
from flexflow_tpu.models.dlrm import synthetic_batch
from flexflow_tpu.tools import dlrm_strategy as jax_dlrm_strategy
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.config import DeviceType
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
from flexflow_tpu_torch.models.dlrm import build_dlrm
from flexflow_tpu_torch.parallel.strategy import load_strategies_from_file
from flexflow_tpu_torch.tools import dlrm_strategy

TOL = dict(rtol=2e-5, atol=2e-6)
SIZES = [64] * 4
DLRM = dict(embedding_sizes=SIZES, embedding_bag_size=2, sparse_feature_size=8,
            mlp_bot=[8, 16, 8], mlp_top=[8 * 5, 16, 1])


@pytest.mark.parametrize("argv", [
    ["--gpu", "4", "--node", "2"], ["--gpu", "1", "--node", "1", "--emb", "4"],
    ["--hetero"], ["--hetero", "--gpu", "8", "--cpu", "2", "--emb", "4"],
], ids=["4x2", "1x1-emb4", "hetero", "hetero-8gpu-2cpu"])
def test_the_files_are_the_jax_tools_bytes(argv, tmp_path):
    ours, theirs = str(tmp_path / "port.pb"), str(tmp_path / "jax.pb")
    assert dlrm_strategy.main(argv + ["-o", ours]) == ours
    jax_dlrm_strategy.main(argv + ["-o", theirs])
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_default_names_match_the_jax_tool(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert dlrm_strategy.main(["--gpu", "4", "--node", "2"]) == "dlrm_strategy_gpu_4_node_2.pb"
    assert dlrm_strategy.main(["--hetero", "--gpu", "2"]) == \
        "dlrm_strategy_8nEmb_1cpu_2gpu.pb"


def test_the_port_loads_the_reference_layout(tmp_path):
    out = str(tmp_path / "s.pb")
    dlrm_strategy.main(["--gpu", "4", "--node", "2", "-o", out])
    loaded = load_strategies_from_file(out, reference_order=True)
    assert len(loaded) == 24 + 3
    assert loaded["embedding5"].device_ids == (5,) and loaded["embedding5"].dims == (1, 1)
    assert loaded["concat"].dims == (2, 1) and loaded["concat"].device_ids == (0, 4)
    assert loaded["linear"].dims == (8, 1)
    assert loaded["mse_loss"].memory_types == ("hbm",)
    hetero = str(tmp_path / "h.pb")
    dlrm_strategy.main(["--hetero", "--gpu", "2", "-o", hetero])
    loaded = load_strategies_from_file(hetero, reference_order=True)
    assert loaded["embedding0"].device_type == DeviceType.CPU
    assert loaded["embedding0"].memory_types == ("host", "host", "host")
    assert loaded["embedding0"].host_placed and loaded["linear"].dims == (2, 1)
    assert ft.ParallelConfig.host_rowsparse(3).dims == ff.ParallelConfig.host_rowsparse(3).dims


def _dlrm(pkg, strategy=None):
    extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
    cfg = pkg.FFConfig(batch_size=16, compute_dtype="float32", **extra)
    if strategy:
        cfg.import_strategy_file = strategy
        cfg.import_strategy_reference_order = True
    m = pkg.FFModel(cfg)
    sparse, dense, _ = (build_dlrm if pkg is ft else jax_build_dlrm)(m, 16, **DLRM)
    kw = dict(machine=ff.Machine(devices=jax.devices()[:1])) if pkg is ff else {}
    m.compile(pkg.SGDOptimizer(lr=0.05), "mean_squared_error", ["mean_squared_error"], **kw)
    m.init_layers(seed=1)
    return m, sparse + [dense]


def _train(m, ins, steps=3):
    xs, xd, y = synthetic_batch(16, SIZES, 2, 8)
    for _ in range(steps):
        m.set_batch(dict(zip(ins, xs + [xd])), y)
        m.train_iteration()
    m.sync()
    return {(op.name, w.name): np.asarray(m.get_parameter(op.name, w.name))
            for op in m.ops for w in op.weights}


def test_the_hetero_file_drives_the_row_sparse_path(tmp_path):
    out = str(tmp_path / "h.pb")
    dlrm_strategy.main(["--hetero", "--emb", "4", "-o", out])
    jm, jins = _dlrm(ff, out)
    assert len(jm._host_embed) == 4
    w0 = jax_params_to_numpy(jm)
    pm, pins = _dlrm(ft, out)
    assert sorted(pm._host.sparse) == [f"embedding{i}" for i in range(4)]
    load_jax_params(pm, w0)
    dev, dins = _dlrm(ft)
    load_jax_params(dev, w0)
    want, got, on_card = _train(jm, jins), _train(pm, pins), _train(dev, dins)
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, **TOL, err_msg=str(key))
        np.testing.assert_array_equal(got[key], on_card[key], err_msg=str(key))


def test_the_homogeneous_file_compiles_and_trains(tmp_path):
    out = str(tmp_path / "s.pb")
    dlrm_strategy.main(["--gpu", "1", "--node", "1", "--emb", "4", "-o", out])
    m, ins = _dlrm(ft, out)
    assert next(op for op in m.ops if op.name == "embedding1").pc.dims == (1, 1)
    assert not m._host.active
    w = _train(m, ins)
    assert all(np.isfinite(v).all() for v in w.values())
