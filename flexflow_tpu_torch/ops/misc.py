"""Flat, Softmax, Concat, ElementUnary and ElementBinary (PyTorch port of
part of ``flexflow_tpu/ops/misc.py``).

Dropout, BatchNorm and MSELoss are not ported yet (ROADMAP A2).
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


class Concat(Op):
    """Concatenation along ``axis``, in native (NHWC) order: the model
    builder maps a reference NCHW channel axis to it.  On a mesh a split of
    the concatenated axis is computed whole (its parts straddle the
    inputs) and then split."""

    _type = "Concat"

    def __init__(self, model, input_tensors, axis: int, name: Optional[str] = None):
        super().__init__(model, list(input_tensors), name)
        self.axis = axis
        base = list(input_tensors[0].dims)
        base[axis] = sum(t.dims[axis] for t in input_tensors)
        for t in input_tensors[1:]:
            for d in range(len(base)):
                if d != axis and t.dims[d] != base[d]:
                    raise ValueError(f"concat shape mismatch at dim {d}: {t.dims} vs {base}")
        self._add_output(tuple(base), input_tensors[0].dtype)

    @property
    def unsplit_dims(self):
        return (self.axis,)

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        return [torch.cat(xs, dim=self.axis)]

    def input_ranges(self, j, pc, part_idx):
        """Output tile ranges shifted by the input's offset along the
        concat axis, clipped to that input's extent."""
        tile = self.output_tile(pc, part_idx)
        off = sum(t.dims[self.axis] for t in self.inputs[:j])
        in_dims = self.inputs[j].dims
        rng = []
        for i, (lo, hi) in enumerate(tile):
            if i == self.axis:
                lo, hi = max(0, lo - off), min(in_dims[i] - 1, hi - off)
            rng.append((lo, hi))
        return rng


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
