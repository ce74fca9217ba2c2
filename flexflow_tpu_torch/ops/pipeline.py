"""Pipeline-parallel stacked-dense operator (PyTorch port of
``flexflow_tpu/ops/pipeline.py``).

A stack of ``num_stages`` identical (d -> d, activation) dense stages
whose ``ParallelConfig`` dim 1 is the pipeline degree (SOAP's Operator
dimension; the reference pins ops to GPUs, nmt/nmt.cc:269-308).  On a
mesh with a degree above 1 each rank of the pipe group holds its slot's
consecutive stages (the weights' stage dim is split over the pipe mesh
dims) and the batch flows through ``parallel.pipeline.gpipe``.  At degree
1, or on one device, the stages run in order (``sequential_stages``), so
on one card the op trains through the compiled step.  A strategy changes
where the stages run, not what they compute.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch.distributed.tensor import Partial

from .base import FwdCtx, Op
from ..config import ParallelConfig
from ..initializers import DefaultWeightInitializer, ZeroInitializer


class PipelineMLP(Op):
    _type = "PipelineMLP"

    def __init__(self, model, input_tensor, num_stages: int, num_microbatches: int = 4,
                 activation: str = "relu", name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        d = input_tensor.dims[-1]
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.activation = activation
        # the stage (leading) dim splits over config dim 1, the pipeline
        # degree; d x d stages keep one bundle shape on every hop
        self._add_weight("kernel", (num_stages, d, d), DefaultWeightInitializer(),
                         partition_dims=(1, None, None))
        self._add_weight("bias", (num_stages, d), ZeroInitializer(), partition_dims=(1, None))
        self._add_output(input_tensor.dims)

    def _stage(self, p, h):
        y = torch.matmul(h, p["kernel"].to(h.dtype)) + p["bias"].to(h.dtype)
        if self.activation == "relu":
            y = torch.relu(y)
        elif self.activation == "tanh":
            y = torch.tanh(y)
        return y

    def _pipe_degree(self) -> int:
        pc = getattr(self, "pc", None)
        return pc.dims[1] if pc is not None and len(pc.dims) > 1 else 1

    def _config_dim_bound(self, i: int):
        """Config dim 1 is the pipeline degree: legal when it divides
        ``num_stages`` (the stage split and the ring both need it), not the
        feature width."""
        if i == 1:
            return self.num_stages
        return super()._config_dim_bound(i)

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        from ..parallel.pipeline import sequential_stages

        tree = {"kernel": params["kernel"], "bias": params["bias"]}
        return [sequential_stages(self._stage, tree, xs[0])]

    def constraint_pc(self) -> ParallelConfig:
        """Config dim 1 is the pipeline degree, not a feature split: the
        output is split over the batch only (replicated over the pipe)."""
        return ParallelConfig(self.pc.device_type,
                              (self.pc.dims[0],) + (1,) * (len(self.pc.dims) - 1),
                              self.pc.device_ids)

    def compute_placements(self, machine, output_idx: int = 0) -> tuple:
        return machine.spec_for_config(self.constraint_pc(), self.output.num_dims)

    def forward_sharded(self, machine, params, xs, ctx: FwdCtx) -> List:
        degree = self._pipe_degree()
        if degree <= 1:
            return super().forward_sharded(machine, params, xs, ctx)
        from ..parallel.pipeline import Spec, gpipe, microbatches, sequential_stages

        dp = self.pc.dims[0]
        batch_axes, pipe_axes = machine.axes_for_degrees([dp, degree])
        names = machine.axis_names
        out_pl = self.compute_placements(machine)
        # the input as the output is split (over the batch); only slot 0
        # reads it, so its gradient is a sum over the pipe dims
        x = machine.redistribute(xs[0], out_pl)
        xl = x.to_local(grad_placements=tuple(
            Partial() if n in pipe_axes else p for n, p in zip(names, out_pl)))
        # each rank's stages; their gradients sum over the batch parts
        local = {}
        for w in self.weights:
            v = params[w.name]
            local[w.name] = v.to_local(grad_placements=tuple(
                Partial() if n in batch_axes else p for n, p in zip(names, v.placements)))

        def slot(p, hs, micro_idx):
            return [sequential_stages(self._stage, p, hs[0])]

        specs = [[Spec(tuple(xl.shape[1:]), xl.dtype)]] * degree
        m = microbatches(xl.shape[0], self.num_microbatches)
        y, = gpipe([slot] * degree, local, [xl], m, specs, group=machine.group(pipe_axes))
        return [machine.from_local(y, out_pl)]

    def flops_per_sample(self):
        d = self.output.dims[-1]
        per_tok = 2.0 * d * d * self.num_stages
        if len(self.output.dims) == 3:
            per_tok *= self.output.dims[1]
        return per_tok
