"""Flat, Softmax, Concat, Dropout, ElementUnary, ElementBinary, BatchNorm
and MSELoss (PyTorch port of ``flexflow_tpu/ops/misc.py``).

Dropout draws its keep mask from the step's generator (``FwdCtx.rng``,
the model's device generator), once per step; BatchNorm keeps running
moments as statistics beside the parameters (``init_stats``), updated
through ``FwdCtx.stats_out`` in training.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from ..initializers import ConstantInitializer, ZeroInitializer
from ..parallel.collectives import all_reduce_sum
from .base import FwdCtx, Op, dropout


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


class Dropout(Op):
    """Each element kept with probability ``1 - rate`` and scaled by its
    inverse in training, the identity otherwise (the reference's
    cudnnDropout).  The mask comes from the model's generator, seeded by
    ``FFConfig.seed``; ``seed`` is kept for the JAX package's signature,
    where it is folded into the op's key, and does not change the port's
    draws."""

    _type = "Dropout"

    def __init__(self, model, input_tensor, rate: float, seed: int = 0,
                 name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        self.rate = float(rate)
        self.seed = seed
        self._add_output(input_tensor.dims, input_tensor.dtype)

    @property
    def draws_random(self) -> bool:
        return self.rate > 0.0

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        return [dropout(xs[0], self.rate, ctx, self)]


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


class BatchNorm(Op):
    """Per-channel normalization over every other dim (the reference's
    cudnnBatchNorm in spatial mode), learned scale and shift, an optional
    fused ReLU.  Training normalizes by the batch's mean and (biased)
    variance and moves the running moments toward them with momentum 0.1;
    evaluation normalizes by the running moments.  On a mesh the moments
    are those of the whole batch, as GSPMD gives the JAX package: the sums
    are all-reduced over the ranks that split the other dims.  Channels are
    computed whole (a channel split is applied to the output), so each
    rank holds every channel's statistics."""

    _type = "BatchNorm"
    MOMENTUM = 0.1
    EPS = 1e-5
    has_running_stats = True

    def __init__(self, model, input_tensor, relu: bool = True, name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        self.relu = relu
        c = input_tensor.dims[-1]
        self._add_output(input_tensor.dims, input_tensor.dtype)
        cdim = len(input_tensor.dims) - 1
        self._add_weight("scale", (c,), ConstantInitializer(1.0), partition_dims=(cdim,))
        self._add_weight("bias", (c,), ZeroInitializer(), partition_dims=(cdim,))

    @property
    def unsplit_dims(self):
        return (self.output.num_dims - 1,)

    def init_stats(self, device):
        c = self.inputs[0].dims[-1]
        return {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        return [self._normalize(params, xs[0], ctx, None)]

    def local_forward(self, machine, out_pl):
        names = [n for n, p in zip(machine.axis_names, out_pl) if isinstance(p, Shard)]
        if not names:
            return self.forward
        group = machine.group(names)
        return lambda params, xs, ctx: [self._normalize(params, xs[0], ctx, group)]

    def _moments(self, xf, group):
        """Batch mean and biased variance per channel (over ``group``'s
        ranks too when given: the sums are all-reduced)."""
        axes = tuple(range(xf.dim() - 1))
        if group is None:
            mean = xf.mean(axes)
            return mean, (xf - mean).square().mean(axes)
        count = xf.numel() // xf.shape[-1] * torch.distributed.get_world_size(group)
        mean = all_reduce_sum(xf.sum(axes), group) / count
        return mean, all_reduce_sum((xf - mean).square().sum(axes), group) / count

    def _normalize(self, params, x, ctx: FwdCtx, group):
        xf = x.float()
        if ctx.training:
            mean, var = self._moments(xf, group)
            if ctx.stats_out is not None:
                old, m = ctx.stats_in[self.name], BatchNorm.MOMENTUM
                ctx.stats_out[self.name] = {
                    "mean": (1 - m) * old["mean"] + m * mean.detach(),
                    "var": (1 - m) * old["var"] + m * var.detach()}
        else:
            st = ctx.stats_in[self.name]
            mean, var = st["mean"], st["var"]
        y = (xf - mean) * torch.rsqrt(var + BatchNorm.EPS) * params["scale"] + params["bias"]
        y = y.to(x.dtype)
        return F.relu(y) if self.relu else y


class MSELoss(Op):
    """The legacy mean-squared-error op (the reference's mse_loss.cu, before
    its ``Loss`` classes): the sum of squared differences of its two
    inputs, over the batch size when ``reduction`` is "average", as a (1,)
    float32 tensor."""

    _type = "MSELoss"

    def __init__(self, model, logit, label, reduction: str = "average",
                 name: Optional[str] = None):
        super().__init__(model, [logit, label], name)
        self.reduction = reduction
        self._add_output((1,), "float32")

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        diff = xs[0].float() - xs[1].float()
        sq = (diff * diff).sum()
        if self.reduction == "average":
            sq = sq / xs[0].shape[0]
        return [sq.reshape(1)]
