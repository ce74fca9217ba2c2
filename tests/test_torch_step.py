"""The training step's options, the port vs the JAX package on the CPU:
gradient accumulation, rematerialization, the non-finite step guard and
the optimizer's scalar vector.

Both packages build the same graph; the JAX model's initial weights are
carried into the port (``convert.load_jax_params``), and both train on the
same numpy batch.  The JAX model runs on one device.  Tolerances:
accumulation rtol 2e-5, atol 2e-6, the JAX package's own accumulation test
(tests/test_grad_accum.py); port remat vs plain rtol 1e-6, atol 1e-7, the
JAX package's remat test; across the packages rtol 1e-4, atol 1e-5, as the
port's other parity tests (XLA and PyTorch sum in different orders).  A
skipped step is held bitwise.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

import jax

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params
from flexflow_tpu_torch.kernels import fused_optimizer as fo
from flexflow_tpu_torch.runtime import resilience
from flexflow_tpu_torch.runtime.step_graph import disable_graphs, graphs_enabled

ACCUM_TOL = dict(rtol=2e-5, atol=2e-6)
REMAT_TOL = dict(rtol=1e-6, atol=1e-7)
TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 32


def _optimizer(pkg, name):
    if name == "sgd":
        return pkg.SGDOptimizer(lr=0.1, momentum=0.9)
    return pkg.AdamOptimizer(alpha=0.01)


def _mlp(pkg, accum, opt, **cfg):
    """The MLP of tests/test_grad_accum.py:13-33."""
    extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
    m = pkg.FFModel(pkg.FFConfig(batch_size=BATCH, grad_accum_steps=accum, **extra, **cfg))
    inp = m.create_tensor((BATCH, 12), nchw=False)
    t = m.dense(inp, 24, activation="relu", name="fc1")
    t = m.dense(t, 6, name="fc2")
    m.softmax(t, name="sm")
    machine = pkg.Machine(devices=jax.devices()[:1]) if pkg is ff else None
    m.compile(_optimizer(pkg, opt), "sparse_categorical_crossentropy", ["accuracy"],
              machine=machine)
    m.init_layers(seed=8)
    return m, inp


def _pair(accum, opt, **cfg):
    jm, jinp = _mlp(ff, accum, opt, **cfg)
    pm, pinp = _mlp(ft, accum, opt, **cfg)
    load_jax_params(pm, jax_params_to_numpy(jm))
    return (jm, jinp), (pm, pinp)


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, 12), dtype=np.float32),
            rng.integers(0, 6, size=(BATCH, 1), dtype=np.int32))


def _steps(m, inp, n, x, y):
    m.set_batch({inp: x}, y)
    for _ in range(n):
        m.train_iteration()
    m.sync()


def _weights(m):
    return {(op.name, w.name): np.asarray(m.get_parameter(op.name, w.name))
            for op in m.ops for w in op.weights}


def _port_state(m):
    """Every port weight and optimizer slot, cloned."""
    out = {("w", o, n): t.detach().clone() for o, ws in m._params.items() for n, t in ws.items()}
    for slot, tree in m._opt_state.items():
        out.update({(slot, o, n): t.clone() for o, ws in tree.items() for n, t in ws.items()})
    return out


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accum_matches_the_jax_package_and_the_full_batch(accum, opt):
    (jm, jinp), (pm, pinp) = _pair(accum, opt)
    full, full_inp = _mlp(ft, 1, opt)
    load_jax_params(full, jax_params_to_numpy(jm))
    x, y = _batch()
    for m, inp in ((jm, jinp), (pm, pinp), (full, full_inp)):
        _steps(m, inp, 3, x, y)
    jw, pw, fw = _weights(jm), _weights(pm), _weights(full)
    for key in pw:
        np.testing.assert_allclose(pw[key], jw[key], **ACCUM_TOL, err_msg=str(key))
        np.testing.assert_allclose(pw[key], fw[key], **ACCUM_TOL, err_msg=str(key))
    # per-step metric semantics: every micro's samples counted, the loss
    # entry the mean micro loss, one step a step
    jpm, ppm = jm.get_metrics(), pm.get_metrics()
    assert ppm.train_all == jpm.train_all == 3 * BATCH
    assert ppm.train_correct == jpm.train_correct
    np.testing.assert_allclose(pm.last_loss, jm.last_loss, **ACCUM_TOL)


def test_grad_accum_refuses_a_batch_it_does_not_divide():
    m, inp = _mlp(ft, 5, "sgd")
    x, y = _batch()
    m.set_batch({inp: x}, y)
    with pytest.raises(ValueError, match="does not divide"):
        m.train_iteration()


def _convnet(pkg, remat):
    """The conv + dense graph of tests/test_grad_accum.py:54."""
    extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
    m = pkg.FFModel(pkg.FFConfig(batch_size=16, remat=remat, **extra))
    inp = m.create_tensor((16, 3, 12, 12))
    t = m.conv2d(inp, 8, 3, 3, 1, 1, 1, 1, activation=pkg.ActiMode.RELU, name="conv1")
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = m.flat(t, name="flat")
    t = m.dense(t, 10, name="fc")
    m.softmax(t, name="sm")
    machine = pkg.Machine(devices=jax.devices()[:1]) if pkg is ff else None
    m.compile(pkg.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"],
              machine=machine)
    m.init_layers(seed=3)
    return m, inp


def test_remat_matches_plain_and_the_jax_packages_remat():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 12, 12, 3), dtype=np.float32)  # NHWC
    y = rng.integers(0, 10, size=(16, 1), dtype=np.int32)
    jm, jinp = _convnet(ff, True)
    runs = {}
    for remat in (False, True):
        m, inp = _convnet(ft, remat)
        load_jax_params(m, jax_params_to_numpy(jm))
        _steps(m, inp, 3, x, y)
        runs[remat] = _weights(m)
    _steps(jm, jinp, 3, x, y)
    jw = _weights(jm)
    for key in jw:
        np.testing.assert_allclose(runs[True][key], runs[False][key], **REMAT_TOL,
                                   err_msg=str(key))
        np.testing.assert_allclose(runs[True][key], jw[key], **TOL, err_msg=str(key))


def test_remat_recomputes_the_weighted_ops_in_the_backward():
    """With remat the conv and dense forwards run twice a step (once more
    in the backward); without, once."""
    calls = {}
    for remat in (False, True):
        m, inp = _convnet(ft, remat)
        rng = np.random.default_rng(2)
        m.set_batch({inp: rng.standard_normal((16, 12, 12, 3), dtype=np.float32)},
                    rng.integers(0, 10, size=(16, 1), dtype=np.int32))
        counts = {}
        for op in m.ops:
            fwd = op.forward

            def counted(params, xs, ctx, fwd=fwd, name=op.name):
                counts[name] = counts.get(name, 0) + 1
                return fwd(params, xs, ctx)
            op.forward = counted
        m.train_iteration()
        calls[remat] = counts
    assert calls[False] == {"conv1": 1, "pool1": 1, "flat": 1, "fc": 1, "sm": 1}
    assert calls[True] == {"conv1": 2, "pool1": 1, "flat": 1, "fc": 2, "sm": 1}


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_the_guard_skips_a_non_finite_step_like_the_jax_package(opt, monkeypatch):
    monkeypatch.setenv("FF_SKIP_NONFINITE", "3")
    (jm, jinp), (pm, pinp) = _pair(1, opt)
    keys = pm._metric_keys()
    assert keys[-5:] == resilience.HEALTH_METRIC_KEYS + resilience.GUARD_METRIC_KEYS
    x, y = _batch()
    bad = x.copy()
    bad[3, 4] = np.inf
    for m, inp in ((jm, jinp), (pm, pinp)):
        _steps(m, inp, 1, x, y)
    before = _port_state(pm)
    for m, inp in ((jm, jinp), (pm, pinp)):
        _steps(m, inp, 1, bad, y)
    after = _port_state(pm)
    for key in before:
        assert torch.equal(before[key], after[key]), key
    assert pm._step_count == jm._step_count == 2
    # the window's entries, read before the drain consumes them
    acc = dict(zip(keys, pm._metric_acc.tolist()))
    assert (acc["skipped_steps"], acc["consec_skipped"], acc["steps"]) == (1.0, 1.0, 1.0)
    assert acc["nonfinite_loss"] == 1.0 and acc["grad_norm"] > 0
    for m in (jm, pm):
        m.get_metrics()
    assert pm._guard.total_skipped == jm._nonfinite_guard.total_skipped == 1
    assert pm._guard.consec == jm._nonfinite_guard.consec == 1
    assert pm.get_metrics().train_all == jm.get_metrics().train_all == BATCH
    # a good step resets the run length and trains as the JAX package does
    for m, inp in ((jm, jinp), (pm, pinp)):
        _steps(m, inp, 1, x, y)
        m.get_metrics()
    assert pm._guard.consec == jm._nonfinite_guard.consec == 0
    jw, pw = _weights(jm), _weights(pm)
    for key in pw:
        np.testing.assert_allclose(pw[key], jw[key], **TOL, err_msg=str(key))
    # three bad steps in a row escalate at the drain, in both packages
    for m, inp in ((jm, jinp), (pm, pinp)):
        _steps(m, inp, 3, bad, y)
    with pytest.raises(ff.runtime.resilience.NonFiniteEscalationError):
        jm.get_metrics()
    with pytest.raises(resilience.NonFiniteEscalationError, match="3 consecutive"):
        pm.get_metrics()


def test_the_guard_run_length_survives_a_metrics_reset(monkeypatch):
    monkeypatch.setenv("FF_SKIP_NONFINITE", "2")
    m, inp = _mlp(ft, 1, "sgd")
    x, y = _batch()
    x[0, 0] = np.nan
    _steps(m, inp, 1, x, y)
    acc = m._metric_acc
    m.reset_metrics()
    assert m._metric_acc is acc  # zeroed in place: a captured step adds into it
    assert m._guard.consec == 1
    _steps(m, inp, 1, x, y)
    with pytest.raises(resilience.NonFiniteEscalationError):
        m.get_metrics()


def test_metric_keys_carry_the_guard_entries_only_with_the_guard(monkeypatch):
    m, _ = _mlp(ft, 1, "sgd")
    assert m._metric_keys() == ft.model.METRIC_KEYS
    monkeypatch.setenv("FF_SKIP_NONFINITE", "1")
    g, _ = _mlp(ft, 1, "sgd")
    assert g._metric_keys() == (ft.model.METRIC_KEYS + resilience.HEALTH_METRIC_KEYS
                                + resilience.GUARD_METRIC_KEYS)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_the_scalar_vector_carries_lr_and_alpha_t(opt):
    """A changed lr and next_epoch() write the optimizer's vector in place;
    the step (plain updates on the CPU) reads them, as the JAX package's
    step reads hparams()."""
    (jm, jinp), (pm, pinp) = _pair(1, opt)
    vec = pm.optimizer.scalars(pm.device)
    x, y = _batch()
    for step in range(3):
        if step == 1:
            for m in (jm, pm):
                if opt == "sgd":
                    m.optimizer.lr = 0.03
                else:
                    m.optimizer.next_epoch()
        for m, inp in ((jm, jinp), (pm, pinp)):
            _steps(m, inp, 1, x, y)
    assert pm.optimizer.scalars(pm.device) is vec
    want = pm.optimizer.lr if opt == "sgd" else pm.optimizer.alpha_t
    assert vec.tolist() == [np.float32(want), 0.0]
    jw, pw = _weights(jm), _weights(pm)
    for key in pw:
        np.testing.assert_allclose(pw[key], jw[key], **TOL, err_msg=str(key))


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False), (0.9, True)])
def test_plain_sgd_reads_the_vector_and_its_skip_flag(momentum, nesterov):
    rng = np.random.default_rng(3)
    w, g, m = (torch.from_numpy(rng.standard_normal(40).astype(np.float32)) for _ in range(3))
    want_w, want_m = w.clone(), m.clone()
    fo.fused_sgd_update_ref(want_w, g, want_m, 0.05, 1e-4, momentum, nesterov)
    got_w, got_m = w.clone(), m.clone()
    fo.fused_sgd_update_multi([got_w], [g], [got_m], fo.scalar_vector(0.05, "cpu"), 1e-4,
                              momentum, nesterov)
    assert torch.equal(got_w, want_w) and torch.equal(got_m, want_m)
    skip_w, skip_m = w.clone(), m.clone()
    fo.fused_sgd_update_multi([skip_w], [g], [skip_m], fo.scalar_vector(0.05, "cpu", skip=True),
                              1e-4, momentum, nesterov)
    assert torch.equal(skip_w, w) and torch.equal(skip_m, m)


def test_plain_adam_reads_the_vector_and_its_skip_flag():
    rng = np.random.default_rng(4)
    w, g, m = (torch.from_numpy(rng.standard_normal(40).astype(np.float32)) for _ in range(3))
    v = torch.from_numpy(np.abs(rng.standard_normal(40)).astype(np.float32))
    want = [t.clone() for t in (w, m, v)]
    fo.fused_adam_update_ref(want[0], g, want[1], want[2], 0.01, 1e-4)
    got = [t.clone() for t in (w, m, v)]
    fo.fused_adam_update(got[0], g, got[1], got[2], fo.scalar_vector(0.01, "cpu"), 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    kept = [t.clone() for t in (w, m, v)]
    fo.fused_adam_update(kept[0], g, kept[1], kept[2], fo.scalar_vector(0.01, "cpu", True), 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(kept, (w, m, v)))


def test_the_vector_is_refused_in_another_shape_or_type():
    w = torch.zeros(4)
    with pytest.raises(ValueError, match="scalar vector"):
        fo.fused_sgd_update(w, w.clone(), None, torch.zeros(3))
    with pytest.raises(ValueError, match="scalar vector"):
        fo.fused_adam_update(w, w.clone(), w.clone(), w.clone(), torch.zeros(2, dtype=torch.float64))


def test_disable_graphs_nests_and_the_cpu_step_is_eager():
    assert graphs_enabled()
    with disable_graphs():
        with disable_graphs():
            assert not graphs_enabled()
        assert not graphs_enabled()
    assert graphs_enabled()
    m, inp = _mlp(ft, 1, "sgd")
    _steps(m, inp, 2, *_batch())
    assert m._step_graph is None  # a CPU model never captures


def test_set_batch_copies_into_the_staged_buffers():
    m, inp = _mlp(ft, 1, "sgd")
    x, y = _batch()
    m.set_batch({inp: x}, y)
    bufs = {k: v.data_ptr() for k, v in m._batch.items()}
    x2, y2 = _batch(seed=6)
    m.set_batch({inp: x2}, y2)
    assert {k: v.data_ptr() for k, v in m._batch.items()} == bufs
    np.testing.assert_array_equal(m._batch[f"in_{inp.guid}"].numpy(), x2)
    x2[0, 0] = 123.0  # the staged batch is a copy, not the caller's array
    assert m._batch[f"in_{inp.guid}"][0, 0] != 123.0
    m.set_batch({inp: x[:16]}, y[:16])  # another shape: new buffers
    assert m._batch["label"].shape[0] == 16


class _FakeCuda:
    """Stand-ins for the torch.cuda calls StepGraph makes, recording them;
    a fake graph's replay runs what was captured again, so a CPU model
    steps through StepGraph's control flow with real arithmetic."""

    def __init__(self, monkeypatch):
        self.events = []
        fake = self

        handles = iter(range(1, 1 << 30))

        class Graph:
            def __init__(self):
                self.fn = None
                self.pool_id = (0, next(handles))  # a private pool per graph

            def pool(self):
                return self.pool_id

            def replay(self):
                fake.events.append("replay")
                self.fn()

        class Stream:
            def __init__(self, device=None, priority=0):
                pass

            def wait_stream(self, other):
                fake.events.append("wait")

        @contextlib.contextmanager
        def stream(s):
            fake.events.append("side stream")
            yield

        @contextlib.contextmanager
        def graph(g, stream=None, capture_error_mode="global"):
            fake.events.append("capture")
            fake.modes.append(capture_error_mode)
            fake.collecting.append(gc.isenabled())
            fake.capturing = g
            yield
            fake.capturing = None

        monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
        monkeypatch.setattr(torch.cuda, "Stream", Stream)
        monkeypatch.setattr(torch.cuda, "stream", stream)
        monkeypatch.setattr(torch.cuda, "graph", graph)
        monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces",
                            lambda: fake.events.append("clear cublas"), raising=False)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
        monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        self.capturing = None
        self.modes = []  # each capture's capture_error_mode
        self.collecting = []  # whether the cycle collector ran during each capture

    def step(self, calls):
        def run():
            calls.append("step")
            if self.capturing is not None:
                self.capturing.fn = run
        return run


def test_step_graph_runs_eager_then_captures_then_replays(monkeypatch):
    from flexflow_tpu_torch.runtime.step_graph import StepGraph

    fake = _FakeCuda(monkeypatch)
    calls = []
    g = StepGraph(torch.device("cpu"))
    step = fake.step(calls)
    g.run("a", step)  # a new signature: one eager step on a side stream
    assert calls == ["step"] and g.graph is None
    assert fake.events == ["wait", "side stream", "wait"]
    g.run("a", step)  # captured (recorded, not run), then replayed at once
    assert (g.captures, g.replays) == (1, 1)
    # cuBLAS's workspaces are dropped before and after: the capture's own
    # is made in the graph's pool, and none outlives it
    assert fake.events[3:] == ["clear cublas", "capture", "clear cublas", "replay"]
    g.run("a", step)
    assert (g.captures, g.replays, len(calls)) == (1, 2, 4)
    first = g.pool
    assert first == g.graph.pool() and fake.modes == ["global"]  # the graph's own pool
    # no collection during a capture (it could destroy a dropped model's
    # graph); the collector runs again after it
    assert fake.collecting == [False] and gc.isenabled()
    g.run("b", step)  # another signature drops the graph, and its pool
    assert g.graph is None and g.key == "b" and (g.captures, g.replays) == (1, 2)
    assert g.pool is None and g.pool_bytes() is None
    g.run("b", step)  # a recapture has a pool of its own
    assert g.pool == g.graph.pool() != first

    def broken():
        raise RuntimeError("operation not permitted when stream is capturing")
    g.run("c", lambda: None)
    fake.events.clear()
    with pytest.raises(RuntimeError, match="capturing"):
        g.run("c", broken)  # a failed capture raises; nothing runs eagerly instead
    assert g.graph is None and fake.events == ["clear cublas", "capture", "clear cublas"]
    # a decode graph captures thread-locally: a replica captures while others replay
    from flexflow_tpu_torch.runtime.decode_graph import DecodeGraph
    d = DecodeGraph(torch.device("cpu"), step)
    d.run("step", step)
    d.run("step", step)
    assert d.captures == 1 and fake.modes[-1] == "thread_local"


def test_a_model_on_the_compiled_step_trains_as_the_eager_one(monkeypatch):
    """The model's graph path through StepGraph (fake graphs that replay
    what they captured) against disable_graphs(): the same weights, and the
    graph dropped by init_layers and by a batch of another shape."""
    from flexflow_tpu_torch.runtime.step_graph import StepGraph

    _FakeCuda(monkeypatch)
    monkeypatch.setattr(ft.FFModel, "_use_graph",
                        lambda self: not self._sharded and graphs_enabled())

    def capture(self, step):  # record the step: the fake replay runs it again
        self.graph = torch.cuda.CUDAGraph()
        self.graph.fn = step
        self.captures += 1
    monkeypatch.setattr(StepGraph, "_capture", capture)
    x, y = _batch()
    graph, inp = _mlp(ft, 2, "adam")
    eager, einp = _mlp(ft, 2, "adam")
    graph.set_batch({inp: x}, y)
    eager.set_batch({einp: x}, y)
    for i in range(4):
        if i == 2:
            graph.optimizer.next_epoch()
            eager.optimizer.next_epoch()
        graph.train_iteration()
        with disable_graphs():
            eager.train_iteration()
    g = graph._step_graph
    assert (g.captures, g.replays) == (1, 3) and eager._step_graph is None
    gw, ew = _weights(graph), _weights(eager)
    for key in gw:
        np.testing.assert_array_equal(gw[key], ew[key], err_msg=str(key))
    assert graph.get_metrics().train_all == eager.get_metrics().train_all == 4 * BATCH
    graph.set_batch({inp: x[:16]}, y[:16])
    graph.train_iteration()
    assert g.graph is None and g.key is not None
    graph.train_iteration()
    assert g.graph is not None
    graph.init_layers(seed=1)
    assert g.graph is None and g.key is None


def test_a_lowered_model_on_the_compiled_step_trains_as_per_op(monkeypatch):
    """A lowered model (FFConfig.lowered) through StepGraph's control flow:
    the first step runs the compiled region eagerly (and compiles it), the
    capture records it and each replay runs it again, so 4 steps compile
    one graph and end at per-op dispatch's weights bit for bit."""
    from flexflow_tpu_torch.runtime.step_graph import StepGraph

    _FakeCuda(monkeypatch)
    monkeypatch.setattr(ft.FFModel, "_use_graph",
                        lambda self: not self._sharded and graphs_enabled())

    def capture(self, step):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.fn = step
        self.captures += 1
    monkeypatch.setattr(StepGraph, "_capture", capture)
    x, y = _batch()
    graph, inp = _mlp(ft, 1, "sgd", lowered=True)
    eager, einp = _mlp(ft, 1, "sgd")
    graph.set_batch({inp: x}, y)
    eager.set_batch({einp: x}, y)
    for _ in range(4):
        graph.train_iteration()
        with disable_graphs():
            eager.train_iteration()
    g = graph._step_graph
    assert (g.captures, g.replays) == (1, 3)
    assert graph._lowering.graphs == {"train_step": 1} and eager._lowering is None
    gw, ew = _weights(graph), _weights(eager)
    for key in gw:
        np.testing.assert_array_equal(gw[key], ew[key], err_msg=str(key))


def test_a_graph_dump_counts_each_kernel_node():
    """ROADMAP C15's exact count: the kernel nodes of a CUDA graph's debug
    dump (one captured on an H100: a flash forward, a cuBLAS GEMM, two
    fills, a clamp and one fused SGD launch), read by name; a Triton
    kernel that inductor named after the custom ops it fuses is none of
    this repo's kernels."""
    import os

    import chip_smoke
    from flexflow_tpu_torch.runtime.step_graph import dump_kernel_names

    path = os.path.join(os.path.dirname(__file__), "golden", "cuda_graph_dump.dot")
    with open(path) as f:
        names = dump_kernel_names(f.read())
    assert len(names) == 6
    assert names[1].startswith("sm80_xmma_gemm_f32f32")
    assert chip_smoke.node_launches(names) == {"flash_fwd": 1, "fused_sgd_update": 1}
    assert chip_smoke.kernel_of(
        "triton_per_fused__to_copy_clone_flash_bwd_dkdv_flash_bwd_dq_mul_sum_16") is None
    assert chip_smoke.kernel_of(
        "void (anonymous namespace)::flash_bwd_dkdv_mma_kernel<64, true, 64>(...)") == \
        "flash_bwd_dkdv"
    assert dump_kernel_names("digraph dot {\n}\n") == []
