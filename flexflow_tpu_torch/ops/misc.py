"""Flat, Softmax, ElementUnary and ElementBinary (PyTorch port of part of
``flexflow_tpu/ops/misc.py``).

Concat, Dropout, BatchNorm and MSELoss are not ported yet (ROADMAP A2).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from .base import FwdCtx, Op


class Flat(Op):
    """(B, H, W, C) -> (B, H*W*C), in NHWC element order like the JAX
    package (not the reference's CHW order)."""

    _type = "Flat"
    unsplit_dims = (1,)

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

    @property
    def unsplit_dims(self):
        return (self.output.num_dims - 1,)

    def __init__(self, model, input_tensor, name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        self._add_output(input_tensor.dims, input_tensor.dtype)

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        return [torch.softmax(xs[0].float(), dim=-1).to(xs[0].dtype)]


_UNARY = {
    "exp": torch.exp,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": F.elu,
    "identity": lambda x: x,
}


class ElementUnary(Op):
    """Elementwise exp/relu/sigmoid/tanh/elu/identity."""

    _type = "ElementUnary"

    def __init__(self, model, input_tensor, op_name: str, name: Optional[str] = None):
        if op_name not in _UNARY:
            raise ValueError(f"unknown unary op {op_name}")
        super().__init__(model, [input_tensor], name)
        self.op_name = op_name
        self._add_output(input_tensor.dims, input_tensor.dtype)

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        return [_UNARY[self.op_name](xs[0])]


_BINARY = {
    "add": torch.add,
    "subtract": torch.sub,
    "multiply": torch.mul,
    "divide": torch.div,
}


class ElementBinary(Op):
    """Elementwise add/subtract/multiply/divide of two tensors of one shape."""

    _type = "ElementBinary"

    def __init__(self, model, x, y, op_name: str, name: Optional[str] = None):
        if op_name not in _BINARY:
            raise ValueError(f"unknown binary op {op_name}")
        if x.dims != y.dims:
            raise ValueError(f"element binary shape mismatch: {x.dims} vs {y.dims}")
        super().__init__(model, [x, y], name)
        self.op_name = op_name
        self._add_output(x.dims, x.dtype)

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        return [_BINARY[self.op_name](xs[0], xs[1])]
