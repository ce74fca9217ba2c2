"""A spatially split model built after the process group was formed again.

One job of 4 gloo ranks (tests/test_torch_soap.py's launcher), one process
a rank.  Each rank trains a small CNN with conv1 and pool1 split over H
and W and fc1 split by columns (so its kernel is sharded) on the (2, 2)
mesh ``Machine.from_process_group`` builds (dims ``m0``, ``m1``), three
times from the same weights and batch:

1. before any process group, on one device (what a fresh process gives);
2. in a first world that made more groups than the second will;
3. after ``distributed.shutdown()`` and ``initialize()``, in a second world.

Each run takes one SGD step and reads every parameter back, a gather on
the mesh.  Every leaf's ``detach()`` must come out on the model's own
mesh object, the second world must give the first world's weights bit for
bit, and both the one-device weights at rtol 1e-5, atol 1e-6 (the split
ops sum in another order).  On the unrepaired tree the second world's
first ``get_parameter`` raised "Could not resolve the process group
registered under the name 21".

The fault this holds off: torch's ``DeviceMesh`` compares and hashes by
its ranks, layout and dim names, not by its process groups, so DTensor's
caches keyed on a mesh (sharding propagation, the redistribute planner)
handed the second world's equal mesh the first world's, whose group names
c10d no longer resolved, or resolved to a group of the new world.
"""

import numpy as np
import pytest

from test_torch_soap import _launch

TOL = dict(rtol=1e-5, atol=1e-6)
BATCH = 8

_CHILD = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
job = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
sys.path.insert(0, job["root"])
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.parallel import distributed as dist

data = np.load(job["data"])
init = np.load(job["params"], allow_pickle=True).item()
SPLIT = {"conv1": (1, 2, 2, 1), "pool1": (1, 2, 2, 1), "fc1": (1, 2)}


def run(machine):
    m = ft.FFModel(ft.FFConfig(batch_size=job["batch"], device="cpu",
                               strategies={k: ft.ParallelConfig(dims=v)
                                           for k, v in SPLIT.items()}))
    inp = m.create_tensor((job["batch"], 3, 8, 8))
    t = m.conv2d(inp, 4, 3, 3, 1, 1, 1, 1, activation="relu", name="conv1")
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = m.flat(t, name="flat1")
    t = m.dense(t, 16, activation="relu", name="fc1")
    t = m.dense(t, 10, name="fc2")
    m.softmax(t, name="softmax1")
    m.compile(ft.SGDOptimizer(m, lr=0.1), "sparse_categorical_crossentropy", ["accuracy"],
              machine=machine)
    m.init_layers(seed=0)
    for (opn, wn), v in init.items():
        m.set_parameter(opn, wn, v)
    m.set_batch({inp: data["x"]}, data["y"])
    m.train_iteration()
    # a DTensor op's output on another mesh object than the model's
    leaves = [w for ws in m._params.values() for w in ws.values()]
    stale = sum(isinstance(w, torch.distributed.tensor.DTensor)
                and w.detach().device_mesh is not m.machine.mesh for w in leaves)
    return {(op.name, w.name): m.get_parameter(op.name, w.name)
            for op in m.ops for w in op.weights}, (str(m.machine.axis_names), stale)


out = {"fresh": run(ft.Machine(devices=[torch.device("cpu")]))[0]}
dist.initialize("cpu", init_method=job["init"] + "_1", world_size=job["world"], rank=rank)
for _ in range(job["extra_groups"]):  # the first world numbers more groups
    torch.distributed.new_group(list(range(job["world"])))
out["world1"], out["mesh1"] = run(None)
dist.shutdown()
dist.initialize("cpu", init_method=job["init"] + "_2", world_size=job["world"], rank=rank)
out["world2"], out["mesh2"] = run(None)
dist.shutdown()
np.save(job["out"] % rank, out, allow_pickle=True)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("regroup")
    rng = np.random.default_rng(23)
    np.savez(tmp / "data.npz",
             x=rng.standard_normal((BATCH, 8, 8, 3), dtype=np.float32),
             y=rng.integers(0, 10, (BATCH, 1)).astype(np.int32))
    init = {("conv1", "kernel"): rng.standard_normal((3, 3, 3, 4), dtype=np.float32) * 0.3,
            ("conv1", "bias"): rng.standard_normal(4, dtype=np.float32) * 0.1,
            ("fc1", "kernel"): rng.standard_normal((64, 16), dtype=np.float32) * 0.2,
            ("fc1", "bias"): rng.standard_normal(16, dtype=np.float32) * 0.1,
            ("fc2", "kernel"): rng.standard_normal((16, 10), dtype=np.float32) * 0.2,
            ("fc2", "bias"): rng.standard_normal(10, dtype=np.float32) * 0.1}
    return _launch(tmp, _CHILD, 4, init, data=str(tmp / "data.npz"), batch=BATCH,
                   extra_groups=20)


@pytest.mark.parametrize("rank", range(4))
def test_second_world_reads_what_the_first_world_read(ranks, rank):
    out = ranks[rank]
    assert out["mesh1"] == out["mesh2"] == (str(("m0", "m1")), 0)
    for key, want in out["world1"].items():
        np.testing.assert_array_equal(out["world2"][key], want, err_msg=str(key))


@pytest.mark.parametrize("world", ["world1", "world2"])
def test_each_world_matches_one_device(ranks, world):
    for out in ranks:
        for key, want in out["fresh"].items():
            np.testing.assert_allclose(out[world][key], want, **TOL, err_msg=str(key))
