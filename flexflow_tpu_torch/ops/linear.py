"""Linear (dense) operator (PyTorch port of ``flexflow_tpu/ops/linear.py``).

The kernel is ``(in, out)`` as in the JAX package.  Under bf16 the
float32 kernel is cast per use and ``torch.matmul`` accumulates in f32
inside cuBLAS, the counterpart of ``preferred_element_type=float32``.
On a mesh, an output-dim split is column parallelism: the kernel is split
on its columns and each device computes its columns of the output.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .base import FwdCtx, Op
from .conv2d import ActiMode, apply_activation
from ..initializers import DefaultBiasInitializer, DefaultWeightInitializer


class Linear(Op):
    _type = "Dense"
    mixes_features = True

    def __init__(self, model, input_tensor, out_dim: int,
                 activation: str = ActiMode.NONE, use_bias: bool = True,
                 kernel_initializer=None, bias_initializer=None,
                 share_with=None, name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        in_dim = input_tensor.dims[-1]
        lead = input_tensor.dims[:-1]
        self.activation = activation
        self.use_bias = use_bias
        self._add_output(lead + (out_dim,), input_tensor.dtype)
        out_cfg_dim = len(lead)  # channel dim of the output
        if self._share(share_with, lambda sw: isinstance(sw, Linear) and sw.use_bias == use_bias
                       and sw.weights[0].dims == (in_dim, out_dim)):
            return
        self._add_weight("kernel", (in_dim, out_dim),
                         kernel_initializer or DefaultWeightInitializer(),
                         partition_dims=(None, out_cfg_dim))
        if use_bias:
            self._add_weight("bias", (out_dim,),
                             bias_initializer or DefaultBiasInitializer(),
                             partition_dims=(out_cfg_dim,))

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        x = xs[0]
        y = torch.matmul(x, params["kernel"].to(x.dtype))
        if self.use_bias:
            y = y + params["bias"].to(y.dtype)
        return [apply_activation(y, self.activation)]

    def flops_per_sample(self):
        return 2.0 * self.inputs[0].dims[-1] * self.output.dims[-1]

    def input_ranges(self, j, pc, part_idx):
        """Every out-channel part reads the whole input feature dim (the
        reference replicates the input per channel shard, linear.cu:174-185)."""
        rng = super().input_ranges(j, pc, part_idx)
        rng[-1] = (0, self.inputs[0].dims[-1] - 1)
        return rng
