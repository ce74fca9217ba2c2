"""The port's DataLoader prefetch (flexflow_tpu_torch/runtime/dataloader.py)
against the JAX package's loader: tests/test_dataloader.py's cases.

The prefetch worker prepares the NEXT batch while the device computes; it
must never change WHAT is delivered, only when.  Batches are compared
exactly: with and without prefetch, shuffled or not, across a reset in
the middle of an epoch and a ``skip_batches``, and against the batches
the JAX package's loader delivers for the same dataset and seed.  On the
CPU the worker only gathers (the pinned-buffer copy to the card runs in
chip_smoke.py's phase 14 (e)).  On two gloo ranks a recompile that changes
the input's batch degree discards the batch prefetched under the old one.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as ft


def _recording(pkg):
    """A model of ``pkg`` whose ``set_batch`` records what it is given."""
    extra = dict(device="cpu") if pkg is ft else {}
    m = pkg.FFModel(pkg.FFConfig(batch_size=8, **extra))
    t = m.create_tensor((8, 4), nchw=False)
    m.batches = []

    def set_batch(inputs, labels):
        m.batches.append(([np.asarray(v).copy() for v in inputs.values()],
                          np.asarray(labels).copy()))
    m.set_batch = set_batch
    return m, t


def _drive(pkg, prefetch, shuffle, epochs=3):
    m, t = _recording(pkg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 4), dtype=np.float32)
    y = np.arange(40, dtype=np.int32).reshape(-1, 1)
    dl = pkg.DataLoader(m, {t: x}, y, shuffle=shuffle, seed=11, prefetch=prefetch)
    for _ in range(epochs):
        dl.reset()
        for _ in range(dl.num_batches()):
            dl.next_batch(m)
    return m.batches


def _same(a, b):
    assert len(a) == len(b)
    for (xi, yi), (xj, yj) in zip(a, b):
        np.testing.assert_array_equal(yi, yj)
        for u, v in zip(xi, xj):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("shuffle", [False, True])
def test_prefetch_delivers_identical_batches(shuffle):
    plain = _drive(ft, prefetch=False, shuffle=shuffle)
    assert len(plain) == 15
    _same(plain, _drive(ft, prefetch=True, shuffle=shuffle))
    _same(plain, _drive(ff, prefetch=True, shuffle=shuffle))


def test_prefetch_survives_mid_epoch_reset():
    """A reset between next_batch calls discards the pending batch (the
    version check): the following epoch starts at sample 0; a skip lands
    on the batch after the skipped ones."""
    m, t = _recording(ft)
    x = np.arange(40 * 4, dtype=np.float32).reshape(40, 4)
    y = np.arange(40, dtype=np.int32).reshape(-1, 1)
    dl = ft.DataLoader(m, {t: x}, y, prefetch=True)
    dl.next_batch(m)
    dl.next_batch(m)
    dl.reset()
    dl.next_batch(m)
    dl.skip_batches(2)
    dl.next_batch(m)
    dl.close()
    labels = [b[1].ravel().tolist() for b in m.batches]
    assert labels == [list(range(8)), list(range(8, 16)), list(range(8)), list(range(24, 32))]


RECOMPILE_RANK = r"""
import json, sys
import numpy as np
job = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
sys.path.insert(0, job["root"])
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.parallel import distributed
from flexflow_tpu_torch.testing.chaos_smoke import build_mlp, params_of

distributed.initialize("cpu", init_method=job["init"], world_size=2, rank=rank)
m, dl = build_mlp("cpu")
degrees = [m._all_strategies()["fc1"].dims[0]]
for _ in range(2):
    dl.next_batch(m)
    m.train_iteration()
# fc1 (the input's consumer) from a batch split to an output split: the
# batch the worker prepared meanwhile holds half the rows the step now wants
m.recompile(strategies={"fc1": ft.ParallelConfig(dims=(1, 2))})
degrees.append(m._all_strategies()["fc1"].dims[0])
for _ in range(2):
    dl.next_batch(m)
    m.train_iteration()
params = params_of(m)
dl.close()
np.savez(job["out"] % rank, degrees=np.array(degrees), **params)
distributed.shutdown()
"""


def test_recompile_discards_a_batch_prefetched_under_another_split(tmp_path):
    from flexflow_tpu_torch.testing.chaos_smoke import build_mlp, params_of

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    job = tmp_path / "job.json"
    job.write_text(json.dumps(dict(root=root, init=f"file://{tmp_path / 'pg'}",
                                   out=str(tmp_path / "out_%d.npz"))))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RECOMPILE_RANK, str(job), str(r)],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    finally:
        for p in procs:  # a failed or hung sibling must not outlive the test
            if p.poll() is None:
                p.kill()
    # the same four steps on one device
    m, dl = build_mlp("cpu")
    for _ in range(4):
        dl.next_batch(m)
        m.train_iteration()
    dl.close()
    want = params_of(m)
    for r in range(2):
        with np.load(tmp_path / f"out_{r}.npz") as got:
            assert got["degrees"].tolist() == [2, 1]
            for name, w in want.items():
                np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-6,
                                           err_msg=f"rank {r} {name}")
