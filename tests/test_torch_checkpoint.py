"""Checkpoints and resume: the port's ``.npz`` checkpoints against the JAX
package's, in both directions, and the pieces a step-granular resume needs
(``CheckpointManager``, retried I/O, ``DataLoader.skip_batches``).

The model is the small MLP of tests/test_checkpoint.py (SGD momentum 0.9,
so there is optimizer state to carry), on one device in each package.
Round trips through a file are held exactly; training continued in one
package from the other's file is held at rtol 1e-4, atol 1e-5, as the
port's other parity tests.
"""

import os

import numpy as np
import pytest
import torch

import jax

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.runtime import resilience
from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager

TOL = dict(rtol=1e-4, atol=1e-5)


def _small_model(pkg, opt="sgd", batch=16):
    extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
    m = pkg.FFModel(pkg.FFConfig(batch_size=batch, compute_dtype="float32", **extra))
    inp = m.create_tensor((batch, 8), nchw=False)
    t = m.dense(inp, 16, activation="relu", name="fc1")
    t = m.dense(t, 4, name="fc2")
    m.softmax(t)
    optimizer = (pkg.SGDOptimizer(lr=0.1, momentum=0.9) if opt == "sgd"
                 else pkg.AdamOptimizer(alpha=0.01))
    machine = pkg.Machine(devices=jax.devices()[:1]) if pkg is ff else None
    m.compile(optimizer, pkg.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
              [pkg.MetricsType.ACCURACY], machine=machine)
    m.init_layers(seed=3)
    return m, inp


def _feed(m, inp, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, 8), dtype=np.float32)
    y = rng.integers(0, 4, size=(16, 1), dtype=np.int32)
    m.set_batch({inp: x}, y)


def _train(m, inp, steps, seed=0):
    _feed(m, inp, seed)
    for _ in range(steps):
        m.train_iteration()
    m.sync()


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_a_jax_checkpoint_loads_into_the_port(opt, tmp_path):
    jm, jinp = _small_model(ff, opt)
    _train(jm, jinp, 3)
    path = str(tmp_path / "jax.npz")
    jm.save(path)
    pm, pinp = _small_model(ft, opt)
    pm.load(path)
    saved = _npz(path)
    assert pm._step_count == jm._step_count == 3
    for opn, ws in pm._params.items():
        for wn, w in ws.items():
            np.testing.assert_array_equal(w.detach().numpy(), saved[f"params/{opn}/{wn}"])
    for slot, tree in pm._opt_state.items():
        for opn, ws in tree.items():
            for wn, t in ws.items():
                np.testing.assert_array_equal(t.numpy(), saved[f"opt_state/{slot}/{opn}/{wn}"])
    # both continue alike from the same state
    _train(jm, jinp, 2, seed=1)
    _train(pm, pinp, 2, seed=1)
    for opn in ("fc1", "fc2"):
        np.testing.assert_allclose(pm.get_parameter(opn), jm.get_parameter(opn), **TOL)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_a_port_checkpoint_loads_into_the_jax_package(opt, tmp_path):
    pm, pinp = _small_model(ft, opt)
    _train(pm, pinp, 3)
    path = str(tmp_path / "port")
    pm.save(path)  # no suffix: path + ".npz", as the JAX package without orbax
    assert os.path.exists(path + ".npz") and not os.path.exists(path)
    jm, jinp = _small_model(ff, opt)
    _train(jm, jinp, 1, seed=9)  # makes the JAX package's optimizer state
    jm.load(path + ".npz")
    assert jm._step_count == 3
    saved = _npz(path + ".npz")
    assert set(saved) == set(ff.runtime.checkpoint._flatten(
        ff.runtime.checkpoint._tree_from_model(jm)))
    for opn in ("fc1", "fc2"):
        for wn in ("kernel", "bias"):
            np.testing.assert_array_equal(np.asarray(jm.get_parameter(opn, wn)),
                                          saved[f"params/{opn}/{wn}"])
    _train(jm, jinp, 2, seed=1)
    _train(pm, pinp, 2, seed=1)
    for opn in ("fc1", "fc2"):
        np.testing.assert_allclose(pm.get_parameter(opn), jm.get_parameter(opn), **TOL)


def test_a_weights_only_npz_zeroes_the_optimizer_state(tmp_path):
    """A file of parameters alone (the weight interchange form of the JAX
    package's .npz) loads; the optimizer state it lacks starts at zero."""
    jm, jinp = _small_model(ff)
    _train(jm, jinp, 1)
    path = str(tmp_path / "weights.npz")
    jm.save(path)
    weights = {k: v for k, v in _npz(path).items() if k.startswith("params/")}
    np.savez(path, **weights)
    pm, pinp = _small_model(ft)
    _train(pm, pinp, 2)
    pm.load(path)
    assert pm._step_count == 0
    assert all(not t.any() for ws in pm._opt_state["v"].values() for t in ws.values())
    np.testing.assert_array_equal(pm.get_parameter("fc2"), jm.get_parameter("fc2"))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_save_load_and_two_more_steps_equal_four_steps(opt, tmp_path):
    """Bitwise on the CPU, into a fresh model whose staged tensors keep
    their addresses (load writes in place)."""
    straight, sinp = _small_model(ft, opt)
    _train(straight, sinp, 4)
    first, finp = _small_model(ft, opt)
    _train(first, finp, 2)
    path = str(tmp_path / "half.npz")
    first.save(path)
    fresh, rinp = _small_model(ft, opt)
    ptrs = [w.data_ptr() for ws in fresh._params.values() for w in ws.values()]
    fresh.load(path)
    assert [w.data_ptr() for ws in fresh._params.values() for w in ws.values()] == ptrs
    assert fresh._step_count == 2
    _train(fresh, rinp, 2)
    assert fresh._step_count == 4
    for opn, ws in straight._params.items():
        for wn, w in ws.items():
            assert torch.equal(w, fresh._params[opn][wn]), (opn, wn)
    for slot, tree in straight._opt_state.items():
        for opn, ws in tree.items():
            for wn, t in ws.items():
                assert torch.equal(t, fresh._opt_state[slot][opn][wn]), (slot, opn, wn)


def test_checkpoint_manager_rotation(tmp_path):
    """tests/test_checkpoint.py:88 against the port's manager: saves at
    steps 1-4, two kept, the latest restored."""
    m, inp = _small_model(ft)
    _feed(m, inp)
    mgr = CheckpointManager(str(tmp_path / "mgr"), max_to_keep=2)
    for _ in range(4):
        m.train_iteration()
        m.sync()
        assert mgr.save(m)
    mgr.wait_until_finished()
    step = m._step_count
    w = m.get_parameter("fc1")
    m.train_iteration()
    m.sync()
    assert not np.array_equal(m.get_parameter("fc1"), w)
    restored = mgr.restore_latest(m)
    assert restored == step == 4
    assert m._step_count == step
    np.testing.assert_array_equal(m.get_parameter("fc1"), w)
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path / "mgr")) == ["ckpt_3.npz", "ckpt_4.npz"]
    mgr.close()


def test_checkpoint_manager_interval_and_force(tmp_path):
    m, inp = _small_model(ft)
    _feed(m, inp)
    mgr = CheckpointManager(str(tmp_path / "mgr"), max_to_keep=3, save_interval_steps=2)
    saved = []
    for _ in range(5):
        m.train_iteration()
        saved.append(mgr.save(m))
    assert saved == [False, True, False, True, False]
    assert not mgr.save(m, step=4, force=False)  # not past the latest
    assert mgr.save(m, force=True)  # step 5, off the interval
    assert mgr.all_steps() == [2, 4, 5]
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(m) is None


def test_with_ckpt_retries_retries_an_injected_oserror(monkeypatch):
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("injected")
        return "done"

    assert resilience.with_ckpt_retries(flaky, retries=2, base_delay=0.5,
                                        sleep=sleeps.append) == "done"
    assert len(calls) == 3 and sleeps == [0.5, 1.0]
    calls.clear()
    with pytest.raises(OSError):
        resilience.with_ckpt_retries(flaky, retries=1, base_delay=0.0, sleep=sleeps.append)
    with pytest.raises(ValueError):  # not an I/O error: no retry
        resilience.with_ckpt_retries(lambda: int("x"), retries=3, sleep=sleeps.append)
    monkeypatch.setenv("FF_CKPT_RETRIES", "4")
    monkeypatch.setenv("FF_CKPT_BACKOFF_S", "0.25")
    assert (resilience.ckpt_retries(), resilience.ckpt_backoff_s()) == (4, 0.25)
    assert resilience.backoff_delay(10, 1.0) == resilience.MAX_BACKOFF_S


def test_save_is_retried_and_atomic(tmp_path, monkeypatch):
    m, inp = _small_model(ft)
    _train(m, inp, 1)
    real_savez, fails = np.savez, []

    def failing_savez(f, **arrays):
        if not fails:
            fails.append(1)
            raise OSError("disk full")
        real_savez(f, **arrays)

    monkeypatch.setattr(np, "savez", failing_savez)
    monkeypatch.setenv("FF_CKPT_BACKOFF_S", "0")
    path = str(tmp_path / "retried.npz")
    m.save(path)
    assert fails == [1]
    assert os.listdir(tmp_path) == ["retried.npz"]  # no temporary file left
    assert int(_npz(path)["step"]) == 1


def test_preemption_handler_sets_its_flag_and_restores_the_handler():
    import signal

    before = signal.getsignal(signal.SIGTERM)
    with resilience.PreemptionHandler(signals=(signal.SIGTERM,)) as h:
        assert not h.requested
        signal.raise_signal(signal.SIGTERM)
        assert h.requested and h.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before
    stop = resilience.Preempted(12)
    assert isinstance(stop, SystemExit) and stop.code == 0 and "step 12" in str(stop)


def test_resume_meta_round_trips(tmp_path):
    resilience.write_resume_meta(str(tmp_path), step=7, steps_per_epoch=3)
    meta = resilience.read_resume_meta(str(tmp_path))
    assert (meta["step"], meta["steps_per_epoch"]) == (7, 3)
    assert resilience.read_resume_meta(str(tmp_path / "none")) is None


@pytest.mark.parametrize("skip", [0, 2, 6])
def test_skip_batches_lands_where_the_jax_loader_does(skip):
    """Shuffle on, the same seed: after reset() and skip_batches(n), both
    loaders stage the same rows (6 skips pass the end of the 5-batch
    epoch and wrap, as next_batch does)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((20, 8), dtype=np.float32)
    y = rng.integers(0, 4, size=(20, 1), dtype=np.int32)
    staged = []
    for pkg in (ff, ft):
        m, inp = _small_model(pkg, batch=4)
        dl = pkg.DataLoader(m, {inp: x}, y, shuffle=True, seed=11)
        dl.reset()
        dl.skip_batches(skip)
        dl.next_batch(m)
        staged.append((np.asarray(m._batch[f"in_{inp.guid}"]), np.asarray(m._batch["label"])))
    for a, b in zip(*staged):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the zoo's models

NMT = dict(seq_length=6, num_layers=2, hidden_size=16, embed_size=16, vocab_size=64)
MOE = dict(seq_length=16, num_layers=2, embed_dim=64, num_heads=4, vocab_size=64,
           moe_every=1, num_experts=4)


def _zoo_model(pkg, name):
    """NMT (Adam; embed_dst shares embed_src's table) or the MoE transformer
    (SGD momentum) at the sizes of tests/test_torch_models.py, with its
    inputs and a batch maker."""
    extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
    m = pkg.FFModel(pkg.FFConfig(batch_size=2, compute_dtype="float32", **extra))
    if name == "nmt":
        mod = __import__(f"{pkg.__name__}.models.nmt", fromlist=["x"])
        ins = list(mod.build_nmt(m, 2, **NMT)[:2])
        opt = pkg.AdamOptimizer(alpha=0.01)

        def batch(seed):
            src, dst, labels = mod.synthetic_batch(2, 6, 64, seed=seed)
            return [src, dst], labels
    else:
        mod = __import__(f"{pkg.__name__}.models.transformer", fromlist=["x"])
        ins = list(mod.build_transformer(m, 2, **MOE)[:2])
        opt = pkg.SGDOptimizer(lr=0.05, momentum=0.9)

        def batch(seed):
            toks, pos, labels = mod.synthetic_lm_batch(2, 16, 64, seed=seed)
            return [toks, pos], labels
    machine = pkg.Machine(devices=jax.devices()[:1]) if pkg is ff else None
    m.compile(opt, pkg.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [pkg.MetricsType.ACCURACY],
              machine=machine)
    m.init_layers(seed=3)
    return m, ins, batch


def _zoo_train(m, ins, batch, steps, seed):
    for s in range(steps):
        xs, labels = batch(seed + s)
        m.set_batch(dict(zip(ins, xs)), labels)
        m.train_iteration()


@pytest.mark.parametrize("name", ["nmt", "transformer_moe"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_zoo_checkpoints_carry_across_both_ways(name, direction, tmp_path):
    """The .npz of NMT (a shared embedding, LSTMs, Adam) and of the MoE
    transformer (ExpertMLP, SGD momentum) written by one package loads
    into the other exactly; both then train 2 more steps alike.  NMT's
    file holds embed_src's table once and nothing of embed_dst."""
    src_pkg, dst_pkg = (ff, ft) if direction == "jax_to_port" else (ft, ff)
    a, a_ins, batch = _zoo_model(src_pkg, name)
    _zoo_train(a, a_ins, batch, 2, seed=0)
    path = str(tmp_path / f"{name}.npz")
    a.save(path)
    saved = _npz(path)
    if name == "nmt":
        assert "params/embed_src/weight" in saved
        assert not any("embed_dst" in k for k in saved)
    b, b_ins, _ = _zoo_model(dst_pkg, name)
    _zoo_train(b, b_ins, batch, 1, seed=7)  # state that the load must overwrite
    b.load(path)
    assert b._step_count == 2
    leaves = [(op.name, w.name) for op in b.ops for w in op.weights]
    assert {f"params/{o}/{w}" for o, w in leaves} == {k for k in saved if k.startswith("params/")}
    for o, w in leaves:
        np.testing.assert_array_equal(np.asarray(b.get_parameter(o, w)), saved[f"params/{o}/{w}"])
    _zoo_train(a, a_ins, batch, 2, seed=20)
    _zoo_train(b, b_ins, batch, 2, seed=20)
    for o, w in leaves:
        np.testing.assert_allclose(np.asarray(b.get_parameter(o, w)),
                                   np.asarray(a.get_parameter(o, w)), **TOL,
                                   err_msg=f"{o}/{w}")
