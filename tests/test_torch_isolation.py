"""The port stands alone: no jax and nothing of flexflow_tpu, and no silent
CPU fallback."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "flexflow_tpu_torch")


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    # the card's scripts that drive the port (the observability layer's
    # cost on the compiled step)
    yield os.path.join(ROOT, "tools", "telemetry_cost.py")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(_port_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_source_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flexflow_tpu"), f"{path} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, flexflow_tpu_torch, flexflow_tpu_torch.models.alexnet, "
            "flexflow_tpu_torch.models.transformer, "
            "flexflow_tpu_torch.kernels.flash_attention, flexflow_tpu_torch.convert, "
            "flexflow_tpu_torch.parallel.strategy, flexflow_tpu_torch.parallel.distributed, "
            "flexflow_tpu_torch.runtime.checkpoint, flexflow_tpu_torch.runtime.resilience, "
            "flexflow_tpu_torch.runtime.step_graph, flexflow_tpu_torch.simulator.population, "
            "flexflow_tpu_torch.simulator.memory, flexflow_tpu_torch.tools.calibrate, "
            "flexflow_tpu_torch.tools.offline_search, flexflow_tpu_torch.ops.lstm, "
            "flexflow_tpu_torch.ops.moe, flexflow_tpu_torch.models.resnet, "
            "flexflow_tpu_torch.models.inception, flexflow_tpu_torch.models.dlrm, "
            "flexflow_tpu_torch.models.candle_uno, flexflow_tpu_torch.models.nmt, "
            "flexflow_tpu_torch.runtime.decode_graph, flexflow_tpu_torch.serving, "
            "flexflow_tpu_torch.serving.config, flexflow_tpu_torch.serving.queue, "
            "flexflow_tpu_torch.serving.kvpool, flexflow_tpu_torch.serving.engine, "
            "flexflow_tpu_torch.serving.api, flexflow_tpu_torch.observability, "
            "flexflow_tpu_torch.observability.stepstats, "
            "flexflow_tpu_torch.observability.memplane, "
            "flexflow_tpu_torch.observability.agreement, "
            "flexflow_tpu_torch.observability.opprof, "
            "flexflow_tpu_torch.observability.searchtrace, "
            "flexflow_tpu_torch.runtime.profiling, flexflow_tpu_torch.tools.trace_report, "
            "flexflow_tpu_torch.tools.health_report; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flexflow_tpu')); print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ft.FFConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ft.FFModel(ft.FFConfig())
    assert ft.FFModel(ft.FFConfig(device="cpu")).device.type == "cpu"


def test_device_flag_parses():
    cfg = ft.FFConfig()
    assert cfg.parse_args(["-b", "8", "--device", "cpu", "--bf16", "--fused-optimizer",
                           "extra"]) == ["extra"]
    assert (cfg.batch_size, cfg.device, cfg.compute_dtype, cfg.fused_optimizer) == \
        (8, "cpu", "bfloat16", True)


# knobs the SOAP slice ported: the strategy files compile now (without a
# process group the machine is one device, so a 2-part config falls back
# to data parallelism over it); two workers on a one-device machine raise
SOAP_KNOBS = [("import_strategy_file", "s.pb"), ("export_strategy_file", "s.pb"),
              ("workers_per_node", 2)]
# knobs the compiled-step, search and observability slices ported: they
# compile and train a step
STEP_KNOBS = [("grad_accum_steps", 2), ("remat", True), ("search_budget", 10),
              ("telemetry", True), ("profiling", True)]


@pytest.mark.parametrize("field,value", [
    ("search_budget", 10), ("search_pipeline", True), ("grad_accum_steps", 2),
    ("remat", True), ("zero_optimizer", True), ("sparse_host_embeddings", True),
    ("lowered", True), ("telemetry", True), ("profiling", True), *SOAP_KNOBS,
])
def test_knobs_outside_the_slice_raise(field, value, tmp_path, monkeypatch):
    """Knobs of features outside the port so far raise at compile; the
    strategy files the SOAP slice brought in compile, and a worker count
    the machine does not have raises; gradient accumulation, remat and the
    strategy search compile and take a step."""
    from flexflow_tpu_torch.parallel.strategy import (load_strategies_from_file,
                                                      save_strategies_to_file)

    monkeypatch.chdir(tmp_path)
    if field == "import_strategy_file":
        save_strategies_to_file(value, {"fc": ft.ParallelConfig(dims=(2, 1))})
    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu", **{field: value}))
    x = m.create_tensor((2, 4))
    m.dense(x, 3, name="fc")
    if (field, value) in STEP_KNOBS:
        from flexflow_tpu_torch.observability import events

        try:
            m.compile(ft.SGDOptimizer(lr=0.1))
            m.init_layers(seed=0)
            m.set_batch({x: np.ones((2, 4), np.float32)}, np.zeros((2, 1), np.int32))
            m.train_iteration()
            assert m.get_metrics().train_all == 2
            # telemetry writes its trace (into the test's directory)
            assert (m._telemetry is not None) == (field == "telemetry")
        finally:
            events.reset_active()
        if field == "telemetry":
            assert '"name": "step"' in (tmp_path / "ff_trace.jsonl").read_text()
        return
    if (field, value) not in SOAP_KNOBS:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            m.compile(ft.SGDOptimizer(lr=0.1))
        return
    if field == "workers_per_node":
        with pytest.raises(ValueError, match="machine has 1 device"):
            m.compile(ft.SGDOptimizer(lr=0.1))
        return
    m.compile(ft.SGDOptimizer(lr=0.1))
    assert m.machine.num_devices == 1 and m.ops[0].pc.dims == (1, 1)
    if field == "export_strategy_file":
        assert load_strategies_from_file(value) == {"fc": m.ops[0].pc}


@pytest.mark.parametrize("field,value,match", [
    ("search_engine", "native", "ROADMAP A8b"),
    ("search_pipeline", True, "ROADMAP A9"),
])
def test_unported_search_options_raise(field, value, match):
    """The native annealer and the pipeline search raise at compile, naming
    the ROADMAP item that brings each, even beside a search budget."""
    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu", search_budget=10, **{field: value}))
    m.dense(m.create_tensor((2, 4)), 3, name="fc")
    with pytest.raises(NotImplementedError, match=match):
        m.compile(ft.SGDOptimizer(lr=0.1))


@pytest.mark.parametrize("name", ["machine_v5e.json", "measured_v5e.json", "PERF_LEDGER.jsonl"])
def test_no_port_source_names_the_tpu_files_or_the_ledger(name):
    """The port reads only its own H100 machine and measurement files: no
    module of it (nor chip_smoke.py) names the JAX package's v5e fit or
    measurements, or the perf ledger."""
    for path in _port_sources():
        with open(path) as f:
            assert name not in f.read(), f"{os.path.relpath(path, ROOT)} names {name}"


def test_env_knobs_and_unported_entry_points_raise(monkeypatch, tmp_path):
    """Decoding and the engine run on one device, the engine with its
    telemetry hooks; decoding on a mesh, the replica pool (ROADMAP A11) and
    the chaos knob (A10) raise, naming their items."""
    from flexflow_tpu_torch.observability.events import EventLog
    from flexflow_tpu_torch.models.transformer import build_transformer
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    lm = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    build_transformer(lm, 2, seq_length=8, num_layers=1, embed_dim=16, num_heads=2,
                      vocab_size=16)
    lm.compile(ft.SGDOptimizer(lr=0.1))
    lm.init_layers(seed=0)
    assert lm.generate([[1], [2]], 4).shape == (2, 4)
    InferenceEngine(lm, max_batch=1, max_seq=8)
    log = EventLog(str(tmp_path / "serve.jsonl"))
    with InferenceEngine(lm, max_batch=1, max_seq=8, telemetry=log) as eng:
        req = eng.submit([1, 2], 3)
        assert req.result(60).shape == (3,) and req.trace is not None
    log.close()
    assert '"serve_request_done"' in (tmp_path / "serve.jsonl").read_text()
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        from flexflow_tpu_torch.serving import ReplicaPool  # noqa: F401
    for var, value in (("FF_SERVE_MAX_QUEUE", "64"), ("FF_SERVE_REPLICAS", "4")):
        monkeypatch.setenv(var, value)  # a pool knob is refused, not ignored
        with pytest.raises(NotImplementedError, match=f"{var}.*ROADMAP A11"):
            InferenceEngine(lm, max_batch=1, max_seq=8)
        monkeypatch.delenv(var)
    monkeypatch.setattr(ft.FFModel, "_sharded", property(lambda self: True))
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        lm.generate([[1], [2]], 4)
    monkeypatch.undo()
    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    m.dense(m.create_tensor((2, 4)), 3)
    monkeypatch.setenv("FF_CHAOS", "step:1=nan_loss")
    with pytest.raises(NotImplementedError, match="FF_CHAOS"):
        m.compile(ft.SGDOptimizer(lr=0.1))


def test_unported_attention_and_transformer_options_raise():
    from flexflow_tpu_torch.models.transformer import build_transformer
    from flexflow_tpu_torch.ops.base import FwdCtx

    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    x = m.create_tensor((2, 8, 32))
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        m.multihead_attention(x, num_heads=4, dropout=0.1)
    # the MoE blocks build now; a strategy that splits the experts raises
    moe = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    build_transformer(moe, 2, seq_length=8, num_layers=2, embed_dim=32, num_heads=4,
                      vocab_size=16, moe_every=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        next(op for op in moe.ops if op.name == "moe_1").check_config(ft.ParallelConfig(dims=(1, 2, 1)))
    # kv-cached decoding is ported: one token at position 0 attends only to
    # itself, as the causal forward's first position does
    m.multihead_attention(x, num_heads=4, causal=True)
    mha = m.ops[-1]
    m.compile(ft.SGDOptimizer(lr=0.1))
    m.init_layers(seed=0)
    params = {k: v.detach() for k, v in m._params[mha.name].items()}
    xs = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0))
    cache = mha.init_cache(2, 8, torch.float32)
    assert cache["k"].shape == (2, 4, 8, 8) and not cache["k"].any()
    ys, _ = mha.decode(params, [xs[:, :1]] * 3, cache, torch.tensor(0), FwdCtx())
    torch.testing.assert_close(ys[0], mha.forward(params, [xs] * 3, FwdCtx())[0][:, :1],
                               rtol=1e-5, atol=1e-6)


def _reference_public_methods():
    import inspect

    import flexflow_tpu as ff

    return sorted(n for n, v in inspect.getmembers(ff.FFModel)
                  if not n.startswith("_") and callable(v))


def test_every_reference_entry_point_exists_or_names_its_roadmap_item():
    """Each public FFModel method of the JAX package is in the port, or
    raises NotImplementedError naming the ROADMAP item that brings it
    (never an AttributeError or a TypeError)."""
    from flexflow_tpu_torch.model import _UNPORTED_METHODS

    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    for name in _reference_public_methods():
        assert callable(getattr(ft.FFModel, name, None)), f"FFModel.{name} is missing"
        if name in _UNPORTED_METHODS:
            with pytest.raises(NotImplementedError, match=r"ROADMAP A\d+"):
                getattr(m, name)(1, 2, 3, x=4)
    assert not {"save", "load", "print_layers", "get_strategies"} & set(_UNPORTED_METHODS)


def test_print_layers_and_get_strategies_match_the_reference_on_alexnet(capsys):
    import jax

    import flexflow_tpu as ff
    from flexflow_tpu.models.alexnet import build_alexnet as jax_build_alexnet
    from flexflow_tpu_torch.models.alexnet import build_alexnet

    outputs, strategies = [], []
    for pkg, build in ((ff, jax_build_alexnet), (ft, build_alexnet)):
        extra = dict(device="cpu") if pkg is ft else dict(workers_per_node=1)
        m = pkg.FFModel(pkg.FFConfig(batch_size=2, **extra))
        build(m, 2, height=63, width=63)
        machine = pkg.Machine(devices=jax.devices()[:1]) if pkg is ff else None
        m.print_layers()  # before compile: no configs
        m.compile(pkg.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", ["accuracy"],
                  machine=machine)
        m.print_layers()
        outputs.append(capsys.readouterr().out)
        strategies.append({k: tuple(pc.dims) for k, pc in m.get_strategies().items()})
    assert outputs[1] == outputs[0]
    assert "layer[0] conv1 (Conv2D) out=(2, 15, 15, 64) pc=[1, 1, 1, 1]" in outputs[0]
    assert strategies[1] == strategies[0]


@pytest.mark.parametrize("prefetch", [False, True])
def test_dataloader_takes_the_prefetch_argument(prefetch):
    """The reference's ``prefetch`` argument never raises TypeError: False
    loads as usual, True raises NotImplementedError naming its item."""
    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    x = m.create_tensor((2, 4))
    m.dense(x, 3)
    m.compile(ft.SGDOptimizer(lr=0.1))
    data = (np.zeros((4, 4), np.float32), np.zeros((4, 1), np.int32))
    if not prefetch:
        ft.DataLoader(m, {x: data[0]}, data[1], prefetch=prefetch).next_batch(m)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        ft.DataLoader(m, {x: data[0]}, data[1], prefetch=prefetch)
