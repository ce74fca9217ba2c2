"""The port's simulator against the JAX package's, on the CPU.

Both packages build the same graph (AlexNet, the decoder transformer) and
cost it on the same machine and the same cost table: a test-local machine
model (``RefMachine``) hands the port the JAX package's calibrated TPU
model (its topology, constants and ``dcn_spill_time``), under the port's
field names, and both cost models read the JAX package's measured cache
as "tpu" entries, with their local caches in a temporary directory.  The
port's code carries no TPU model; this harness does.

* ``Simulator.simulate_runtime`` equals the reference's exactly (``==``),
  for data parallelism and 20 random legal strategies, at 4, 16 and 64
  devices; for the rest of the zoo at its small test sizes (ResNet-50,
  Inception-v3, DLRM, CANDLE-Uno, NMT with its shared embedding, the MoE
  transformer), data parallelism and 5 random strategies of the port's
  search at 8 devices, and the memory model alike.  The random strategies split convs and pools on height and width
  too, as the reference's search does (``spatial_splits``): the port's
  search leaves those splits out until it computes them split, but the
  simulator prices any plan, an imported one included;
* the delta simulator equals the full rebuild exactly over random
  propose/commit/rollback walks, both weight-sync modes;
* ``memory_per_device`` equals the reference's;
* a measurement on the CPU is tagged "cpu" and never read as a "cuda"
  entry, and a cost model refuses to measure for another platform;
* the H100 node model: NVSwitch transfers, the NVLink ring, one node only,
  the calibration file and its label.
"""

import json
import math
import os
import random

import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.models import candle_uno as jax_candle
from flexflow_tpu.models import dlrm as jax_dlrm
from flexflow_tpu.models import inception as jax_inception
from flexflow_tpu.models import nmt as jax_nmt
from flexflow_tpu.models import resnet as jax_resnet
from flexflow_tpu.models.alexnet import build_alexnet as jax_build_alexnet
from flexflow_tpu.models.transformer import build_transformer as jax_build_transformer
from flexflow_tpu.simulator import memory as jax_memory
from flexflow_tpu.simulator.cost_model import CostModel as JaxCostModel
from flexflow_tpu.simulator.machine import TPUMachineModel
from flexflow_tpu.simulator.simulator import Simulator as JaxSimulator
from flexflow_tpu_torch.models import candle_uno, dlrm, inception, nmt, resnet
from flexflow_tpu_torch.models.alexnet import build_alexnet
from flexflow_tpu_torch.models.transformer import build_transformer
from flexflow_tpu_torch.simulator import memory
from flexflow_tpu_torch.simulator.cost_model import CostModel
from flexflow_tpu_torch.simulator.delta import DeltaSimulator
from flexflow_tpu_torch.simulator.machine import H100MachineModel
from flexflow_tpu_torch.simulator import search
from flexflow_tpu_torch.simulator import simulator as simulator_module
from flexflow_tpu_torch.simulator.search import random_parallel_config
from flexflow_tpu_torch.simulator.simulator import Simulator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5E_MEASURED = os.path.join(ROOT, "flexflow_tpu", "simulator", "measured_v5e.json")
# small shapes that every degree up to 64 can still split
SMALL_LM = dict(seq_length=64, num_layers=2, embed_dim=128, num_heads=8, vocab_size=512)
# the rest of the zoo at the sizes of tests/test_torch_models.py: (port
# builder, JAX builder, builder arguments)
ZOO = {
    "resnet": (resnet.build_resnet50, jax_resnet.build_resnet50, dict(height=64, width=64)),
    "inception": (inception.build_inception_v3, jax_inception.build_inception_v3, {}),
    "dlrm": (dlrm.build_dlrm, jax_dlrm.build_dlrm,
             dict(embedding_sizes=[100, 100, 50], embedding_bag_size=2, sparse_feature_size=8,
                  mlp_bot=[4, 16, 8], mlp_top=[32, 16, 1])),
    "candle_uno": (candle_uno.build_candle_uno, jax_candle.build_candle_uno,
                   dict(dense_layers=[32] * 3, dense_feature_layers=[32] * 3)),
    "nmt": (nmt.build_nmt, jax_nmt.build_nmt,
            dict(seq_length=6, num_layers=2, hidden_size=16, embed_size=16, vocab_size=64)),
    "transformer_moe": (build_transformer, jax_build_transformer,
                        dict(seq_length=16, num_layers=2, embed_dim=64, num_heads=4,
                             vocab_size=64, moe_every=1, num_experts=4)),
}


@pytest.fixture
def spatial_splits(monkeypatch):
    """The port's proposals with the reference's height and width splits of
    convs and pools."""
    for op_type in ("Conv2D", "Pool2D"):
        monkeypatch.setitem(search._SPLITTABLE, op_type, (0, 1, 2))
    search._splittable_dims_cached.cache_clear()
    yield
    search._splittable_dims_cached.cache_clear()


class RefMachine:
    """The JAX package's calibrated TPU model under the port's names."""

    def __init__(self, nd):
        self.ref = r = TPUMachineModel.calibrated(num_devices=nd)
        self.num_devices = nd
        self.peak_flops = r.peak_flops
        self.hbm_bandwidth = r.hbm_bandwidth
        self.kernel_launch_overhead = r.kernel_launch_overhead
        self.matmul_efficiency = r.mxu_efficiency
        self.backward_multiplier = r.backward_multiplier
        self.op_efficiency = r.op_efficiency
        self.op_backward_multiplier = r.op_backward_multiplier
        self.hbm_capacity = r.hbm_capacity
        self.transfer_time = r.transfer_time
        self.allreduce_time = r.allreduce_time
        self.dcn_spill_time = r.dcn_spill_time


def build_pair(name, batch, nd, **lm):
    """The same graph in both packages, each sized for ``nd`` devices."""
    jm = ff.FFModel(ff.FFConfig(batch_size=batch, workers_per_node=nd))
    pm = ft.FFModel(ft.FFConfig(batch_size=batch, workers_per_node=nd, device="cpu"))
    if name == "alexnet":
        jax_build_alexnet(jm, batch)
        build_alexnet(pm, batch)
    elif name in ZOO:
        port_build, jax_build, kw = ZOO[name]
        jax_build(jm, batch, **kw)
        port_build(pm, batch, **kw)
    else:
        jax_build_transformer(jm, batch, **lm)
        build_transformer(pm, batch, **lm)
    assert [(o.name, o._type, o.output.dims, [w.dims for w in o.weights]) for o in jm.ops] == \
        [(o.name, o._type, o.output.dims, [w.dims for w in o.weights]) for o in pm.ops]
    return jm, pm


def cost_pair(nd, tmp_path):
    """(reference machine, reference cost model, port machine, port cost
    model) reading the same measured cache, local caches in ``tmp_path``."""
    mm, pmm = TPUMachineModel.calibrated(num_devices=nd), RefMachine(nd)
    jc = JaxCostModel(mm, cache_path=str(tmp_path / "jax_cache.json"))
    pc = CostModel(pmm, cache_path=str(tmp_path / "port_cache.json"),
                   measured_cache_path=V5E_MEASURED, target_platform="tpu")
    return mm, jc, pmm, pc


def as_jax(strategies):
    return {k: ff.ParallelConfig(dims=v.dims, device_ids=v.device_ids)
            for k, v in strategies.items()}


def random_strategies(model, nd, rng):
    return {op.name: op.legalize_pc(random_parallel_config(op, nd, rng, model=model))
            for op in model.ops}


def dp(model, nd):
    return {op.name: ft.ParallelConfig.data_parallel(op.output.num_dims, nd)
            for op in model.ops}


@pytest.mark.parametrize("name,nd", [("alexnet", 4), ("alexnet", 16), ("alexnet", 64),
                                     ("transformer", 4), ("transformer", 16),
                                     ("transformer", 64)])
def test_simulate_runtime_equals_the_reference_exactly(name, nd, tmp_path, spatial_splits):
    jm, pm = build_pair(name, 64, nd, **SMALL_LM)
    mm, jc, pmm, pc = cost_pair(nd, tmp_path)
    jsim, psim = JaxSimulator(mm, jc), Simulator(pmm, pc)
    rng = random.Random(nd)
    plans = [dp(pm, nd)] + [random_strategies(pm, nd, rng) for _ in range(20)]
    assert any(pc_.dims[0] < nd for s in plans[1:] for pc_ in s.values())
    for s in plans:
        assert psim.simulate_runtime(pm, s) == jsim.simulate_runtime(jm, as_jax(s))


@pytest.mark.parametrize("name", sorted(ZOO))
def test_simulated_step_of_the_zoo_equals_the_reference(name, tmp_path):
    """Each new model at its small size, 8 devices: the data-parallel step
    and 5 random strategies of the port's search, simulated alike, both
    weight-sync modes; the memory model alike (SGD momentum)."""
    nd = 8
    jm, pm = build_pair(name, 64, nd)
    mm, jc, pmm, pc = cost_pair(nd, tmp_path)
    rng = random.Random(nd)
    plans = [dp(pm, nd)] + [random_strategies(pm, nd, rng) for _ in range(5)]
    for overlap in (False, True):
        jsim = JaxSimulator(mm, jc, overlap_backward_update=overlap)
        psim = Simulator(pmm, pc, overlap_backward_update=overlap)
        for s in plans:
            assert psim.simulate_runtime(pm, s) == jsim.simulate_runtime(jm, as_jax(s))
    for s in plans[:2]:
        got = memory.memory_per_device(pm, s, machine_model=pmm,
                                       optimizer=ft.SGDOptimizer(lr=0.1, momentum=0.9))
        want = jax_memory.memory_per_device(jm, as_jax(s), machine_model=pmm.ref,
                                            optimizer=ff.SGDOptimizer(lr=0.1, momentum=0.9))
        assert got == want


def test_a_shared_weight_is_synchronized_once(tmp_path, monkeypatch):
    """NMT's decoder embedding reads the encoder's table: it adds the
    table's reads to its own cost, as the JAX package prices it, but no
    second all-reduce and no second copy in memory."""
    nd = 4
    _, pm = build_pair("nmt", 64, nd)
    _, _, pmm, pc = cost_pair(nd, tmp_path)
    owner, sharer = pm.ops[0], pm.ops[1]
    assert sharer.share_from is owner and not sharer.weights
    plan = dp(pm, nd)
    synced = []
    groups = simulator_module.weight_groups

    def spy(op, pc_, wi):
        synced.append((op.name, op.weights[wi].name))
        return groups(op, pc_, wi)

    monkeypatch.setattr(simulator_module, "weight_groups", spy)
    base = Simulator(pmm, pc).simulate_runtime(pm, plan)
    assert synced.count(("embed_src", "weight")) == 1
    assert not any(name == sharer.name for name, _ in synced)
    assert pc._analytic(sharer, plan[sharer.name], "forward") == \
        pc._analytic(owner, plan[owner.name], "forward")
    # each device holds one f32 master copy of every weight, the table once
    mem = memory.memory_per_device(pm, plan, machine_model=pmm)
    weights = sum(math.prod(w.dims) for op in pm.ops for w in op.weights)
    assert mem["per_device"][0]["params"] == 4 * weights
    assert mem["by_op"][sharer.name]["bytes"] < mem["by_op"][owner.name]["bytes"]
    assert base > 0


@pytest.mark.parametrize("name,nd,overlap", [("alexnet", 16, False), ("alexnet", 16, True),
                                             ("transformer", 8, False),
                                             ("transformer", 64, True)])
def test_delta_equals_the_full_rebuild_exactly(name, nd, overlap, tmp_path, spatial_splits):
    _, pm = build_pair(name, 64, nd, **SMALL_LM)
    _, _, pmm, pc = cost_pair(nd, tmp_path)
    sim = Simulator(pmm, pc, overlap_backward_update=overlap)
    start = {k: v.with_device_ids(tuple(range(nd))) for k, v in dp(pm, nd).items()}
    delta = DeltaSimulator(sim, pm)
    assert delta.reset(start) == sim.simulate_runtime(pm, start)
    cur = dict(start)
    rng = random.Random(12345)
    for _ in range(40):
        op = rng.choice(pm.ops)
        new = op.legalize_pc(random_parallel_config(op, nd, rng, model=pm))
        trial = dict(cur, **{op.name: new})
        assert delta.propose(op.name, new) == sim.simulate_runtime(pm, trial)
        if rng.random() < 0.4:
            delta.commit()
            cur = trial
        else:
            delta.rollback()
    assert delta.reset(cur) == sim.simulate_runtime(pm, cur)


@pytest.mark.parametrize("name,nd", [("alexnet", 8), ("transformer", 16)])
def test_memory_per_device_equals_the_reference(name, nd, tmp_path, spatial_splits):
    jm, pm = build_pair(name, 64, nd, **SMALL_LM)
    pmm = RefMachine(nd)
    rng = random.Random(5)
    for s in (dp(pm, nd), random_strategies(pm, nd, rng), random_strategies(pm, nd, rng)):
        for port_opt, jax_opt in ((None, None),
                                  (ft.SGDOptimizer(lr=0.1, momentum=0.9),
                                   ff.SGDOptimizer(lr=0.1, momentum=0.9)),
                                  (ft.AdamOptimizer(alpha=1e-3), ff.AdamOptimizer(alpha=1e-3))):
            got = memory.memory_per_device(pm, s, machine_model=pmm, optimizer=port_opt)
            want = jax_memory.memory_per_device(jm, as_jax(s), machine_model=pmm.ref,
                                                optimizer=jax_opt)
            assert got == want


def test_memory_counts_optimizer_slots_by_name():
    assert memory.optimizer_slots(None) == 1
    assert memory.optimizer_slots(ft.SGDOptimizer(lr=0.1)) == 0
    assert memory.optimizer_slots(ft.SGDOptimizer(lr=0.1, momentum=0.9)) == 1
    assert memory.optimizer_slots(ft.AdamOptimizer()) == 2
    pm = ft.FFModel(ft.FFConfig(batch_size=8, workers_per_node=2, device="cpu"))
    pm.dense(pm.create_tensor((8, 16)), 32, name="fc")
    got = memory.memory_per_device(pm, machine_model=H100MachineModel(num_devices=2))
    # 16x32 + 32 weights, f32 master + grad + one slot, a ring buffer (dp 2)
    assert got["per_device"][0]["params"] == 4 * (16 * 32 + 32)
    assert got["per_device"][0]["staging"] == 4 * (16 * 32 + 32)
    assert got["capacity_bytes"] == 80_000_000_000


def _dense_model(out_dim=32):
    m = ft.FFModel(ft.FFConfig(batch_size=8, workers_per_node=2, device="cpu"))
    m.dense(m.create_tensor((8, 16)), out_dim, name="fc")
    return m


def test_a_cpu_measurement_is_never_read_as_a_cuda_entry(tmp_path):
    cache = str(tmp_path / "cache.json")
    m = _dense_model()
    op = m.ops[0]
    pc = ft.ParallelConfig(dims=(2, 1), device_ids=(0, 1))
    mm = H100MachineModel(num_devices=2)
    cpu = CostModel(mm, measure=True, device="cpu", target_platform="cpu", cache_path=cache,
                    measured_cache_path=str(tmp_path / "none.json"))
    t = cpu.op_time(op, pc, "backward")
    assert cpu.stats["measured_runs"] == 1 and t > 0
    with open(cache) as f:
        entries = json.load(f)
    assert len(entries) == 2  # forward and backward, one measurement
    assert all(v["platform"] == "cpu" and v["device"] == "cpu" and v["measured"]
               for v in entries.values())
    cuda = CostModel(mm, cache_path=cache, measured_cache_path=cache)
    assert cuda.target_platform == "cuda" and cuda._measured == {}
    assert cuda.op_time(op, pc, "backward") == cuda._analytic(op, pc, "backward")
    assert cuda.stats == {"measured_hits": 0, "measured_runs": 0, "learned": 0, "analytic": 1}
    with pytest.raises(ValueError, match="cannot stand for"):
        CostModel(mm, measure=True, device="cpu", target_platform="cuda")


def test_a_failed_measurement_raises(tmp_path, monkeypatch):
    """A measurement that fails is an error, never a silent roofline."""
    op = _dense_model().ops[0]

    def broken(pc):
        def fn(params, xs, ctx):
            raise RuntimeError("kernel launch failed")
        return fn

    monkeypatch.setattr(op, "part_forward", broken)
    cache = tmp_path / "c.json"
    cost = CostModel(H100MachineModel(num_devices=2), measure=True, device="cpu",
                     target_platform="cpu", cache_path=str(cache),
                     measured_cache_path=str(tmp_path / "none.json"))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        cost.op_time(op, ft.ParallelConfig(dims=(2, 1), device_ids=(0, 1)), "forward")
    assert cost.stats["analytic"] == 0 and not cache.exists()


def test_embedding_is_measured_on_indices_over_its_table(tmp_path, monkeypatch):
    """Token ids are drawn over the table's rows, not all one row (which
    would send every gradient row to one place)."""
    m = ft.FFModel(ft.FFConfig(batch_size=8, workers_per_node=2, device="cpu"))
    m.embedding(m.create_tensor((8, 16), dtype="int32"), 100, 32, aggr="none", name="embed")
    op = m.ops[0]
    seen = []
    forward = op.part_forward

    def spy(pc):
        fn = forward(pc)

        def run(params, xs, ctx):
            seen.append(xs[0].clone())
            return fn(params, xs, ctx)
        return run

    monkeypatch.setattr(op, "part_forward", spy)
    cost = CostModel(H100MachineModel(num_devices=2), measure=True, device="cpu",
                     target_platform="cpu", cache_path=str(tmp_path / "c.json"),
                     measured_cache_path=str(tmp_path / "none.json"))
    assert cost.op_time(op, ft.ParallelConfig(dims=(2, 1, 1)), "backward") > 0
    ids = seen[0]
    assert tuple(ids.shape) == (4, 16) and ids.dtype == torch.int64
    assert 0 <= int(ids.min()) and int(ids.max()) < 100 and len(torch.unique(ids)) > 20
    assert all(torch.equal(ids, s) for s in seen)  # one draw, reused


def test_measurement_times_one_part_of_a_head_split(tmp_path):
    """A head-split attention is timed on its whole heads and weight
    columns (the part's sub-shape), not the whole op divided by n."""
    m = ft.FFModel(ft.FFConfig(batch_size=2, workers_per_node=4, device="cpu"))
    m.multihead_attention(m.create_tensor((2, 16, 32), nchw=False), num_heads=4, causal=True)
    op = m.ops[0]
    pc = op.legalize_pc(ft.ParallelConfig(dims=(1, 1, 2)))
    assert [tuple(hi - lo + 1 for lo, hi in op.weight_tile(pc, w, 0)) for w in range(4)] == \
        [(32, 16)] * 4
    cost = CostModel(H100MachineModel(num_devices=4), measure=True, device="cpu",
                     target_platform="cpu", cache_path=str(tmp_path / "c.json"))
    assert cost.op_time(op, pc, "forward") > 0 and cost.stats["measured_runs"] == 1
    params = {w.name: torch.zeros(tuple(hi - lo + 1 for lo, hi in op.weight_tile(pc, i, 0)))
              for i, w in enumerate(op.weights)}
    out = op.part_forward(pc)(params, [torch.zeros(2, 16, 32)] * 3, None)
    assert tuple(out.shape) == cost._sub_output_shape(op, pc) == (2, 16, 16)


def test_h100_node_model():
    mm = H100MachineModel(num_devices=8)
    assert mm.source == "spec (unfitted)" and not mm.fitted
    assert (mm.peak_flops, mm.hbm_bandwidth, mm.hbm_capacity) == (989e12, 3.35e12, 80e9)
    # any pair is one NVSwitch hop
    assert mm.transfer_time(0, 1, 450e6) == mm.transfer_time(0, 7, 450e6) == 1e-3
    assert mm.transfer_time(3, 3, 1e9) == 0.0
    assert mm.allreduce_time([0, 1, 2, 3], 450e6) == pytest.approx(2 * 3 / 4 * 1e-3)
    assert mm.allreduce_time([5], 1e9) == 0.0
    assert mm.dcn_spill_time((8, 1), 1e9) == 0.0
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        H100MachineModel(num_devices=16)


def test_calibrated_reads_the_fit_and_names_the_card(tmp_path):
    path = tmp_path / "machine_h100.json"
    assert H100MachineModel.calibrated(path=str(path)).source == "spec (unfitted)"
    path.write_text(json.dumps({"matmul_efficiency": 0.42, "kernel_launch_overhead": 8e-6,
                                "op_efficiency": {"Conv2D": 0.3}, "fit_log_rmse": 0.2,
                                "device": "NVIDIA H100 80GB HBM3",
                                "power_limit": "700.00 W"}))
    mm = H100MachineModel.calibrated(path=str(path), num_devices=4,
                                     kernel_launch_overhead=1e-6)
    assert (mm.matmul_efficiency, mm.op_efficiency, mm.num_devices) == (0.42, {"Conv2D": 0.3}, 4)
    assert mm.kernel_launch_overhead == 1e-6  # explicit arguments win
    assert mm.fitted and mm.source == "fitted on NVIDIA H100 80GB HBM3, power limit 700.00 W"
