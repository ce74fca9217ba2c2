"""Conv2D / Pool2D operators (PyTorch port of ``flexflow_tpu/ops/conv2d.py``).

Activations stay NHWC and conv kernels HWIO at the op's surface, as in
the JAX package.  The convolution itself is ``F.conv2d`` on
``x.permute(0, 3, 1, 2)``: an NHWC-contiguous tensor permuted to NCHW has
``channels_last`` strides, the layout cuDNN runs on Hopper's tensor cores,
so the permute is free.  Shape formula as in conv_2d.cu:100-101:
``out = 1 + (in + 2*pad - kernel) / stride``.

On a mesh a convolution or a pool computes each part's output tile
alone, over the batch, the channels, the height and the width.  A height
or width split reads only the input rectangle of its tile, halo included
(``input_ranges``): the rows and columns that other parts hold come from
``halo_exchange`` (parallel/collectives.py), one exchange along the
height, then one along the width among the parts of the same rows, so the
corners come along.  The input's rows are held as DTensor splits them
(``chunk_bounds``: uneven where the size does not divide, 229 rows in 4
parts of 58, 58, 58 and 55), so each part's receive ranges follow from
the real bounds, from any part, neighbour or not.  Padding is applied by
hand, only where a tile's window crosses the true image edge: an interior
tile reads its neighbours' rows instead (zeros for a convolution, -inf
for max pooling, and for average pooling only the image's elements count
in the divisor).  ``forward_tiles`` runs the same tiles in lockstep in one
process (``halo_exchange`` with no group).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from .base import FwdCtx, Op
from ..initializers import DefaultBiasInitializer, DefaultWeightInitializer
from ..parallel.collectives import halo_exchange
from ..parallel.mesh import chunk_bounds


class ActiMode:
    NONE = "none"
    RELU = "relu"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    GELU = "gelu"


def apply_activation(x: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if not activation or activation == ActiMode.NONE:
        return x
    if activation == ActiMode.RELU:
        return F.relu(x)
    if activation == ActiMode.SIGMOID:
        return torch.sigmoid(x)
    if activation == ActiMode.TANH:
        return torch.tanh(x)
    if activation == ActiMode.GELU:
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form
    raise ValueError(f"unknown activation {activation}")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _Windowed(Op):
    """What a convolution and a pool share on a height or width split: the
    window rows of an output tile, the exchange that gathers them and the
    tile's own computation (``_tile``, on an NHWC rectangle with the image
    edge's padding given explicitly)."""

    def _window(self, axis: int, o_lo: int, o_hi: int) -> Tuple[int, int]:
        """The input rows (axis 0) or columns (axis 1) output rows
        ``o_lo..o_hi`` read, padding included (may fall outside the image)."""
        s, p, k = self.stride[axis], self.padding[axis], self.kernel[axis]
        return o_lo * s - p, o_hi * s - p + k - 1

    def _plan(self, axis: int, parts: int):
        """Per part of ``parts`` along ``axis``: the clipped input range its
        tile reads and its (before, after) edge padding."""
        size = self.inputs[0].dims[1 + axis]
        tile = self.output.dims[1 + axis] // parts
        need, pads = [], []
        for q in range(parts):
            lo, hi = self._window(axis, q * tile, (q + 1) * tile - 1)
            need.append((max(0, lo), min(size - 1, hi)))
            pads.append((max(0, -lo), max(0, hi - (size - 1))))
        return need, pads

    def _tile(self, params, x: torch.Tensor, pads) -> torch.Tensor:
        """The op on an NHWC input rectangle whose padding ``pads`` ((top,
        bottom), (left, right)) is only what crosses the image's edge."""
        raise NotImplementedError

    def exchanges_on_host(self) -> bool:
        return any(d > 1 for d in self.pc.dims[1:3])  # a halo exchange

    def local_forward(self, machine, out_pl):
        """Each part's output tile from its input rectangle: one halo
        exchange per split spatial dim, then ``_tile``."""
        if not any(isinstance(p, Shard) and p.dim in (1, 2) for p in out_pl):
            return self.forward
        in_pl = self.input_placements(out_pl, 0)
        steps = []
        for axis in (0, 1):
            names, sizes, idx = machine.split_of(in_pl, 1 + axis)
            parts = math.prod(sizes)
            need, pads = self._plan(axis, parts)
            owned = chunk_bounds(self.inputs[0].dims[1 + axis], sizes)
            group = machine.group(names) if parts > 1 else None
            steps.append((group, need, owned, pads[idx], owned[idx]))

        def fwd(params, xs, ctx):
            x = xs[0]
            for axis, (group, need, owned, _, own) in enumerate(steps):
                if group is None:
                    continue
                if x.shape[1 + axis] != own[1] - own[0] + 1:
                    raise RuntimeError(f"{self.name}: this part holds {x.shape[1 + axis]} "
                                       f"input rows on dim {1 + axis}, DTensor's split "
                                       f"gives {own[1] - own[0] + 1}")
                x = halo_exchange(x, 1 + axis, need, owned, group)
            return [self._tile(params, x, (steps[0][3], steps[1][3]))]

        return fwd

    def forward_tiles(self, params, x: torch.Tensor, parts_h: int, parts_w: int,
                      rects: Optional[list] = None) -> torch.Tensor:
        """The op's output computed as ``parts_h`` x ``parts_w`` tiles in
        lockstep in one process: the input split as DTensor splits it, each
        tile's rectangle gathered by ``halo_exchange`` with no group, each
        tile computed alone (``_tile``), the tiles put together.  ``rects``,
        when given, receives each tile's input rectangle (row-major over the
        tiles)."""
        plans = [self._plan(0, parts_h), self._plan(1, parts_w)]
        owned = [chunk_bounds(self.inputs[0].dims[1], [parts_h]),
                 chunk_bounds(self.inputs[0].dims[2], [parts_w])]
        rows = [x.narrow(1, lo, hi - lo + 1) for lo, hi in owned[0]]
        rows = halo_exchange(rows, 1, plans[0][0], owned[0], None)
        out = []
        for i, r in enumerate(rows):
            cols = [r.narrow(2, lo, hi - lo + 1) for lo, hi in owned[1]]
            cols = halo_exchange(cols, 2, plans[1][0], owned[1], None)
            tiles = []
            for j, c in enumerate(cols):
                if rects is not None:
                    rects.append(c)
                tiles.append(self._tile(params, c, (plans[0][1][i], plans[1][1][j])))
            out.append(torch.cat(tiles, 2))
        return torch.cat(out, 1)


class Conv2D(_Windowed):
    _type = "Conv2D"
    mixes_features = True

    def __init__(self, model, input_tensor, out_channels: int,
                 kernel_h: int, kernel_w: int, stride_h: int, stride_w: int,
                 padding_h: int, padding_w: int, activation: str = ActiMode.NONE,
                 use_bias: bool = True, groups: int = 1,
                 kernel_initializer=None, bias_initializer=None,
                 share_with=None, name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        n, h, w, cin = input_tensor.dims
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (padding_h, padding_w)
        self.activation = activation
        self.use_bias = use_bias
        self.groups = groups
        out_h = 1 + (h + 2 * padding_h - kernel_h) // stride_h
        out_w = 1 + (w + 2 * padding_w - kernel_w) // stride_w
        self._add_output((n, out_h, out_w, out_channels), input_tensor.dtype)
        kshape = (kernel_h, kernel_w, cin // groups, out_channels)
        if self._share(share_with, lambda sw: isinstance(sw, Conv2D) and sw.use_bias == use_bias
                       and sw.weights[0].dims == kshape):
            return
        self._add_weight(
            "kernel", kshape,
            kernel_initializer or DefaultWeightInitializer(),
            partition_dims=(None, None, None, 3))
        if use_bias:
            self._add_weight("bias", (out_channels,),
                             bias_initializer or DefaultBiasInitializer(),
                             partition_dims=(3,))

    @property
    def unsplit_dims(self):
        # a grouped conv's output channels need their own input group
        return () if self.groups == 1 else (3,)

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        return [self._conv(params, xs[0], self.padding)]

    def _conv(self, params, x: torch.Tensor, padding) -> torch.Tensor:
        kernel = params["kernel"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
        bias = params["bias"].to(x.dtype) if self.use_bias else None
        y = F.conv2d(_nchw(x), kernel, bias, stride=self.stride,
                     padding=padding, groups=self.groups)
        return apply_activation(_nhwc(y), self.activation)

    def _tile(self, params, x, pads):
        (top, bottom), (left, right) = pads
        if top or bottom or left or right:
            x = F.pad(x, (0, 0, left, right, top, bottom))  # zeros, NHWC
        return self._conv(params, x, 0)

    def flops_per_sample(self):
        _, oh, ow, oc = self.output.dims
        kh, kw = self.kernel
        cin = self.inputs[0].dims[3]
        return 2.0 * oh * ow * oc * kh * kw * (cin // self.groups)

    def input_ranges(self, j, pc, part_idx):
        """The input rectangle of an output tile, halo included (the
        reference's implicit Legion halo, conv_2d.cu:173-211)."""
        n, ih, iw, cin = self.inputs[0].dims
        (n_lo, n_hi), (oh_lo, oh_hi), (ow_lo, ow_hi), _ = self.output_tile(pc, part_idx)
        sh, sw = self.stride
        ph, pw = self.padding
        kh, kw = self.kernel
        h_lo = max(0, oh_lo * sh - ph)
        h_hi = min(ih - 1, oh_hi * sh - ph + kh - 1)
        w_lo = max(0, ow_lo * sw - pw)
        w_hi = min(iw - 1, ow_hi * sw - pw + kw - 1)
        return [(n_lo, n_hi), (h_lo, h_hi), (w_lo, w_hi), (0, cin - 1)]


class PoolType:
    MAX = "max"
    AVG = "avg"


class Pool2D(_Windowed):
    _type = "Pool2D"

    def __init__(self, model, input_tensor, kernel_h: int, kernel_w: int,
                 stride_h: int, stride_w: int, padding_h: int, padding_w: int,
                 pool_type: str = PoolType.MAX, activation: str = ActiMode.NONE,
                 name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        n, h, w, c = input_tensor.dims
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (padding_h, padding_w)
        self.pool_type = pool_type
        self.activation = activation
        out_h = 1 + (h + 2 * padding_h - kernel_h) // stride_h
        out_w = 1 + (w + 2 * padding_w - kernel_w) // stride_w
        self._add_output((n, out_h, out_w, c), input_tensor.dtype)

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        x = xs[0]
        if self.pool_type == PoolType.MAX:
            # max_pool2d pads with -inf, as the JAX package's reduce_window
            y = F.max_pool2d(_nchw(x), self.kernel, self.stride, self.padding)
        else:
            # padding excluded from the divisor (cuDNN's
            # AVERAGE_COUNT_EXCLUDE_PADDING in the reference); summed in f32
            y = F.avg_pool2d(_nchw(x).float(), self.kernel, self.stride, self.padding,
                             count_include_pad=False).to(x.dtype)
        return [apply_activation(_nhwc(y), self.activation)]

    def _tile(self, params, x, pads):
        (top, bottom), (left, right) = pads
        edge = (0, 0, left, right, top, bottom)
        if self.pool_type == PoolType.MAX:
            y = F.max_pool2d(_nchw(F.pad(x, edge, value=float("-inf"))), self.kernel,
                             self.stride)
        else:
            # window sums over the count of the image's own elements in each
            # window (the padding is left out of the divisor), in f32
            xs = _nchw(F.pad(x.float(), edge))
            ones = _nchw(F.pad(torch.ones_like(x[:1, :, :, :1], dtype=torch.float32), edge))
            y = (F.avg_pool2d(xs, self.kernel, self.stride, divisor_override=1)
                 / F.avg_pool2d(ones, self.kernel, self.stride, divisor_override=1)).to(x.dtype)
        return apply_activation(_nhwc(y), self.activation)

    def flops_per_sample(self):
        _, oh, ow, c = self.output.dims
        return float(oh * ow * c * self.kernel[0] * self.kernel[1])
