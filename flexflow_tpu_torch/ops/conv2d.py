"""Conv2D / Pool2D operators (PyTorch port of ``flexflow_tpu/ops/conv2d.py``).

Activations stay NHWC and conv kernels HWIO at the op's surface, as in
the JAX package.  The convolution itself is ``F.conv2d`` on
``x.permute(0, 3, 1, 2)``: an NHWC-contiguous tensor permuted to NCHW has
``channels_last`` strides, the layout cuDNN runs on Hopper's tensor cores,
so the permute is free.  Shape formula as in conv_2d.cu:100-101:
``out = 1 + (in + 2*pad - kernel) / stride``.

On a mesh a convolution or a pool computes split over the batch and the
channels; a height or width split in its config is computed whole (the
window crosses shard edges) and then split, as GSPMD computes it.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from .base import FwdCtx, Op
from ..initializers import DefaultBiasInitializer, DefaultWeightInitializer


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


class Conv2D(Op):
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
        return (1, 2) if self.groups == 1 else (1, 2, 3)

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        x = xs[0]
        kernel = params["kernel"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
        bias = params["bias"].to(x.dtype) if self.use_bias else None
        y = F.conv2d(_nchw(x), kernel, bias, stride=self.stride,
                     padding=self.padding, groups=self.groups)
        return [apply_activation(_nhwc(y), self.activation)]

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


class Pool2D(Op):
    _type = "Pool2D"
    unsplit_dims = (1, 2)

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

    def flops_per_sample(self):
        _, oh, ow, c = self.output.dims
        return float(oh * ow * c * self.kernel[0] * self.kernel[1])
