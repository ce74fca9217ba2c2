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
    # cost on the compiled step, the hetero DLRM's step on a mesh)
    yield os.path.join(ROOT, "tools", "telemetry_cost.py")
    yield os.path.join(ROOT, "tools", "hetero_dlrm_profile.py")


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
            "flexflow_tpu_torch.ops.conv2d, flexflow_tpu_torch.parallel.collectives, "
            "flexflow_tpu_torch.parallel.mesh, flexflow_tpu_torch.simulator.machine, "
            "flexflow_tpu_torch.simulator.delta, flexflow_tpu_torch.optimizers, "
            "flexflow_tpu_torch.simulator.native_search, flexflow_tpu_torch.utils.native, "
            "flexflow_tpu_torch.tools.perf_ledger, flexflow_tpu_torch.tools.search_bench, "
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
            "flexflow_tpu_torch.tools.health_report, flexflow_tpu_torch.serving.pool, "
            "flexflow_tpu_torch.serving.autoscaler, flexflow_tpu_torch.testing, "
            "flexflow_tpu_torch.testing.chaos, flexflow_tpu_torch.testing.fleet, "
            "flexflow_tpu_torch.tools.serve_report, flexflow_tpu_torch.tools.loadgen, "
            "flexflow_tpu_torch.tools.fleet_bench, flexflow_tpu_torch.parallel.pipeline, "
            "flexflow_tpu_torch.parallel.pipeline_plan, flexflow_tpu_torch.ops.pipeline, "
            "flexflow_tpu_torch.runtime.host_tables, "
            "flexflow_tpu_torch.simulator.pipeline_search, "
            "flexflow_tpu_torch.tools.dlrm_strategy, "
            "flexflow_tpu_torch.tools.report_configs, flexflow_tpu_torch.tools.profile_report, "
            "flexflow_tpu_torch.tools.opbench, flexflow_tpu_torch.tools.memory_report, "
            "flexflow_tpu_torch.tools.timeline_export, flexflow_tpu_torch.tools.soap_report, "
            "flexflow_tpu_torch.observability.chipwatch, flexflow_tpu_torch.tools.doctor, "
            "flexflow_tpu_torch.parallel.lowering; "
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
# knobs the compiled-step, search, observability, pipeline, host-table,
# SOAP-space and lowering slices ported: they compile and train a step (on
# one device the pipeline search finds no ring, a model with no host-placed
# table has no row to gather, ZeRO-1 has no second device to split the
# state over, and the lowered step is one compiled region)
STEP_KNOBS = [("grad_accum_steps", 2), ("remat", True), ("search_budget", 10),
              ("telemetry", True), ("profiling", True), ("search_pipeline", True),
              ("sparse_host_embeddings", True), ("zero_optimizer", True), ("lowered", True)]


@pytest.mark.parametrize("field,value", [
    ("search_budget", 10), ("search_pipeline", True), ("grad_accum_steps", 2),
    ("remat", True), ("zero_optimizer", True), ("sparse_host_embeddings", True),
    ("lowered", True), ("telemetry", True), ("profiling", True), *SOAP_KNOBS,
])
def test_knobs_outside_the_slice_raise(field, value, tmp_path, monkeypatch):
    """The name is older than the port's last refusal (the lowering, ported
    since): the strategy files the SOAP slice brought in compile, and a
    worker count the machine does not have raises; gradient accumulation,
    remat, the strategy search, the pipeline search, the host tables' knob,
    ZeRO-1 and the whole-graph lowering compile and take a step."""
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
            assert (m._lowering is not None) == (field == "lowered")
        finally:
            events.reset_active()
        if field == "telemetry":
            assert '"name": "step"' in (tmp_path / "ff_trace.jsonl").read_text()
        return
    assert (field, value) in SOAP_KNOBS
    if field == "workers_per_node":
        with pytest.raises(ValueError, match="machine has 1 device"):
            m.compile(ft.SGDOptimizer(lr=0.1))
        return
    m.compile(ft.SGDOptimizer(lr=0.1))
    assert m.machine.num_devices == 1 and m.ops[0].pc.dims == (1, 1)
    if field == "export_strategy_file":
        assert load_strategies_from_file(value) == {"fc": m.ops[0].pc}


@pytest.mark.parametrize("field,value,match", [
    ("search_engine", "native", "native search over 1 GPU(s), budget 10"),
    ("search_pipeline", True, "ROADMAP A9"),
])
def test_unported_search_options_raise(field, value, match, capsys):
    """The name is older than both: the native annealer (ROADMAP A8b, ported)
    searches at compile beside a search budget and the model trains; the
    pipeline search (ROADMAP A9, ported) runs beside the dimension search:
    on one device it finds no ring, so the model keeps the searched
    strategy and trains."""
    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu", search_budget=10, **{field: value}))
    x = m.create_tensor((2, 4))
    m.dense(x, 3, name="fc")
    if field == "search_pipeline":
        from flexflow_tpu_torch.simulator import pipeline_search

        calls = []
        real = pipeline_search.search_pipeline
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pipeline_search, "search_pipeline",
                       lambda model, **kw: calls.append(kw) or real(model, **kw))
            m.compile(ft.SGDOptimizer(lr=0.1))
        assert len(calls) == 1 and m._pipeline_req is None and m._pipeline_plan is None
    else:
        m.compile(ft.SGDOptimizer(lr=0.1))
        assert match in capsys.readouterr().out
    m.init_layers(seed=0)
    m.set_batch({x: np.ones((2, 4), np.float32)}, np.zeros((2, 1), np.int32))
    m.train_iteration()
    assert m.get_metrics().train_all == 2


@pytest.mark.parametrize("name", ["machine_v5e.json", "measured_v5e.json", "PERF_LEDGER.jsonl"])
def test_no_port_source_names_the_tpu_files_or_the_ledger(name):
    """The port reads only its own H100 machine and measurement files: no
    module of it (nor chip_smoke.py) names the JAX package's v5e fit or
    measurements, or the perf ledger."""
    for path in _port_sources():
        with open(path) as f:
            assert name not in f.read(), f"{os.path.relpath(path, ROOT)} names {name}"


def _default_output_paths():
    """(tool, default path) of every file a port tool writes when the
    caller names none."""
    from flexflow_tpu_torch.observability import chipwatch
    from flexflow_tpu_torch.tools import perf_ledger, profile_report, report_configs, soap_report

    yield "soap_report --out", soap_report.DEFAULT_OUT
    yield "profile_report --out", profile_report.DEFAULT_OUT
    yield "chipwatch --cache", chipwatch.MEASURED_CACHE
    yield "chipwatch refit", chipwatch.default_fit_path(chipwatch.MEASURED_CACHE)
    yield "soap_report keys", report_configs.report_keys_path()
    yield "perf_ledger", perf_ledger.default_path()


@pytest.mark.parametrize("tool,path", list(_default_output_paths()), ids=lambda x: str(x))
def test_no_default_output_path_lands_on_a_pre_port_file(tool, path, monkeypatch):
    """A tool's default output either lies in the port's package or names
    no file that the repo holds, and never one the JAX package's tools write
    (REPORT_SOAP.md, PROFILE_v5e.md) or anything under flexflow_tpu/."""
    full = os.path.normpath(os.path.join(ROOT, path))
    assert os.path.basename(full) not in ("REPORT_SOAP.md", "PROFILE_v5e.md"), tool
    assert not full.startswith(os.path.join(ROOT, "flexflow_tpu") + os.sep), tool
    if not full.startswith(PORT + os.sep):
        assert not os.path.exists(full), f"{tool} defaults to {path}, a file of the repo"


def test_env_knobs_and_unported_entry_points_raise(monkeypatch, tmp_path):
    """Decoding and the engine run on one device, the engine with its
    telemetry hooks, and an FF_CHAOS spec at any of the seven sites is
    accepted at compile (a misspelled site is a ValueError); decoding on a
    mesh (a one-rank gloo group here) gives the one-device tokens."""
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
    want = lm.generate([[1], [2]], 4)
    from flexflow_tpu_torch.parallel import distributed
    distributed.initialize("cpu", init_method=f"file://{tmp_path / 'pg'}", world_size=1,
                           rank=0)
    try:
        mesh_lm = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
        build_transformer(mesh_lm, 2, seq_length=8, num_layers=1, embed_dim=16, num_heads=2,
                          vocab_size=16)
        mesh_lm.compile(ft.SGDOptimizer(lr=0.1))
        mesh_lm.init_layers(seed=0)
        assert mesh_lm._sharded
        np.testing.assert_array_equal(mesh_lm.generate([[1], [2]], 4), want)
    finally:
        distributed.shutdown()
    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    m.dense(m.create_tensor((2, 4)), 3)
    monkeypatch.setenv("FF_CHAOS", "serve:3=replica_kill;serve:p0.1=error")
    m.compile(ft.SGDOptimizer(lr=0.1))
    assert m._chaos is not None and m._chaos.spec == "serve:3=replica_kill;serve:p0.1=error"
    for spec in ("step:1=nan_loss", "serve:2=error;sync:1=hang",
                 "data:1=error;ckpt_save:1=io_error;ckpt_restore:2=io_error;"
                 "resharding:4=device_loss:2"):
        monkeypatch.setenv("FF_CHAOS", spec)
        m.compile(ft.SGDOptimizer(lr=0.1))
        assert m._chaos.spec == spec
    monkeypatch.setenv("FF_CHAOS", "stpe:1=nan_loss")
    with pytest.raises(ValueError, match="unknown site 'stpe'"):
        m.compile(ft.SGDOptimizer(lr=0.1))


def test_unported_attention_and_transformer_options_raise():
    from flexflow_tpu_torch.models.transformer import build_transformer
    from flexflow_tpu_torch.ops.base import FwdCtx

    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    x = m.create_tensor((2, 8, 32))
    # attention dropout is ported: the op draws its mask from the step's
    # generator (tests/test_torch_stateful_ops.py trains with it)
    m.multihead_attention(x, num_heads=4, dropout=0.1)
    assert m.ops[-1].draws_random and m.ops[-1].dropout == 0.1
    # the MoE blocks build, and a strategy that splits the experts is one
    # the op runs: two expert parts in lockstep give the unsplit output
    moe = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    build_transformer(moe, 2, seq_length=8, num_layers=2, embed_dim=32, num_heads=4,
                      vocab_size=16, moe_every=2)
    mop = next(op for op in moe.ops if op.name == "moe_1")
    mop.check_config(ft.ParallelConfig(dims=(1, 2, 1)))
    assert mop.legalize_pc(ft.ParallelConfig(dims=(1, 2, 1))).dims == (1, 2, 1)
    gen = torch.Generator().manual_seed(1)
    mparams = {w.name: torch.randn(w.dims, generator=gen) for w in mop.weights}
    mx = torch.randn(2, 8, 32, generator=gen)
    torch.testing.assert_close(mop.forward_parts(mparams, mx, 1, 2),
                               mop.forward(mparams, [mx], FwdCtx())[0])
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
    """Each public FFModel method of the JAX package is in the port (the
    legacy v2 builders included: the port refuses none of them by name), and
    an unknown name is an AttributeError, not a silent stand-in."""
    import flexflow_tpu_torch.model as port_model

    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    for name in _reference_public_methods():
        assert callable(getattr(ft.FFModel, name, None)), f"FFModel.{name} is missing"
        assert callable(getattr(m, name)), f"FFModel.{name} is not bound"
    assert not hasattr(port_model, "_UNPORTED_METHODS")
    for name in ("conv2d_v2", "pool2d_v2", "dense_v2", "flat_v2"):
        assert isinstance(getattr(m, name)(*_V2_ARGS[name]), port_model.LayerHandle), name
    with pytest.raises(AttributeError):
        m.conv3d_v2  # noqa: B018 - no such builder in either package


_V2_ARGS = {"conv2d_v2": ("c", 3, 8, 3, 3, 1, 1, 1, 1), "pool2d_v2": ("p", 2, 2, 2, 2, 0, 0),
            "dense_v2": ("d", 4, 2), "flat_v2": ("f",)}


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
    """The reference's ``prefetch`` argument is taken either way, and the
    batch staged with it is the batch staged without it."""
    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    x = m.create_tensor((2, 4))
    m.dense(x, 3)
    m.compile(ft.SGDOptimizer(lr=0.1))
    data = (np.arange(16, dtype=np.float32).reshape(4, 4),
            np.arange(4, dtype=np.int32).reshape(4, 1))
    staged = []
    for flag in (False, prefetch):
        dl = ft.DataLoader(m, {x: data[0]}, data[1], prefetch=flag)
        dl.next_batch(m)
        dl.next_batch(m)
        dl.close()
        staged.append({k: v.clone() for k, v in m._batch.items()})
    assert staged[0].keys() == staged[1].keys()
    for k, v in staged[0].items():
        assert torch.equal(v, staged[1][k])
    assert staged[1]["label"].flatten().tolist() == [2, 3]
