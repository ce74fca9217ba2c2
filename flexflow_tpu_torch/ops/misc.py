"""Flat and Softmax (PyTorch port of part of ``flexflow_tpu/ops/misc.py``).

Concat, Dropout, ElementUnary/Binary, BatchNorm and MSELoss are not
ported yet (ROADMAP A2).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .base import FwdCtx, Op


class Flat(Op):
    """(B, H, W, C) -> (B, H*W*C), in NHWC element order like the JAX
    package (not the reference's CHW order)."""

    _type = "Flat"

    def __init__(self, model, input_tensor, name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        n = input_tensor.dims[0]
        flat = 1
        for d in input_tensor.dims[1:]:
            flat *= d
        self._add_output((n, flat), input_tensor.dtype)

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        return [xs[0].reshape(xs[0].shape[0], -1)]


class Softmax(Op):
    """Max-subtracted softmax in f32 (reference: CUDNN_SOFTMAX_ACCURATE).
    A cross-entropy loss reads this op's *input* (see losses.py)."""

    _type = "Softmax"

    def __init__(self, model, input_tensor, name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        self._add_output(input_tensor.dims, input_tensor.dtype)

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        return [torch.softmax(xs[0].float(), dim=-1).to(xs[0].dtype)]
