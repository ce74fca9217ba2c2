"""Analytic FLOPs of a dense layer count every row a sample holds (the
port's ``Linear.flops_per_sample``), and the simulator's roofline reads
them: on a (B, S, in) input a sample is S rows of ``2·in·out`` each.

The JAX package counts a dense layer once a sample whatever the input's
rank (its ``ops/linear.py``).  The comparisons below hold the port
against the reference with that count patched in this process only
(``count_every_row`` from tests/test_torch_telemetry.py); no file of the
JAX package changes.
"""

import random

import pytest

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.ops.linear import Linear
from flexflow_tpu_torch.ops.moe import ExpertMLP

from test_torch_simulator import SMALL_LM, as_jax, build_pair, cost_pair, dp, random_strategies
from test_torch_telemetry import count_every_row


@pytest.mark.parametrize("dims,rows", [((4, 12), 1), ((4, 8, 12), 8), ((8, 20, 12), 20)])
def test_linear_counts_every_row(dims, rows):
    m = ft.FFModel(ft.FFConfig(batch_size=dims[0], device="cpu"))
    y = m.dense(m.create_tensor(dims), 7, name="fc")
    op = m.ops[-1]
    assert isinstance(op, Linear) and y.dims == dims[:-1] + (7,)
    assert op.flops_per_sample() == 2.0 * 12 * 7 * rows


def test_dense_counts_as_the_expert_mlp_does():
    """A 3-D dense layer counts its rows as ExpertMLP counts its tokens."""
    m = ft.FFModel(ft.FFConfig(batch_size=2, device="cpu"))
    x = m.create_tensor((2, 16, 32))
    m.dense(x, 64, name="fc")
    m.expert_mlp(x, num_experts=4, hidden_size=64, name="moe")
    fc, moe = m.ops
    assert isinstance(moe, ExpertMLP)
    assert fc.flops_per_sample() == 16 * 2.0 * 32 * 64
    router = 16 * 2.0 * 32 * 4
    assert moe.flops_per_sample() == router + 16 * moe.capacity_factor * 4.0 * 32 * 64


@pytest.mark.parametrize("nd", [1, 4])
def test_roofline_equals_the_reference_counting_every_row(nd, tmp_path, monkeypatch):
    """The cost model's analytic fallback (``CostModel._analytic``) of every
    op of a transformer under data parallelism and random strategies equals
    the reference's with its dense count patched, forward and backward."""
    count_every_row(monkeypatch)
    jm, pm = build_pair("transformer", 16, nd, **SMALL_LM)
    _, jc, _, pc = cost_pair(nd, tmp_path)
    rng = random.Random(nd)
    plans = [dp(pm, nd)] + [random_strategies(pm, nd, rng) for _ in range(5)]
    dense = [op.name for op in pm.ops if isinstance(op, Linear) and len(op.output.dims) == 3]
    assert dense
    for plan in plans:
        jplan = as_jax(plan)
        for jop, op in zip(jm.ops, pm.ops):
            for which in ("forward", "backward"):
                assert pc._analytic(op, plan[op.name], which) == \
                    jc._analytic(jop, jplan[op.name], which), (op.name, which)
