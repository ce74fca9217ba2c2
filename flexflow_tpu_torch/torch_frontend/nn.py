"""Torch-like frontend (the JAX package's ``torch_frontend/nn.py`` on the
port's ``FFModel``).

Mirrors the reference torch-style module API
(reference: python/flexflow/torch/nn/modules/module.py:18-50): a user
subclasses ``Module``, assigns layer attributes in ``__init__`` and chains
them in ``forward``; ``Module.apply`` (here: ``build``) maps each attr to
the corresponding named core layer.  The reference only supports Conv2d /
MaxPool2d / Linear / Flatten; activations are added here for completeness.
The specs describe layers only: they are not ``torch.nn`` modules, and
``build`` lowers them onto an ``FFModel`` on ``config.device`` (CUDA unless
the caller's ``FFConfig`` asks for the CPU).
"""

from __future__ import annotations

from typing import Optional

from ..config import FFConfig
from ..model import FFModel


class _LayerSpec:
    def lower(self, ff, t, name):
        raise NotImplementedError

    def __call__(self, t):
        # inside Module.forward a spec is applied to a symbolic handle;
        # _Tracer handles the actual dispatch
        return t.apply(self)


class Conv2d(_LayerSpec):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True):
        k = kernel_size if isinstance(kernel_size, tuple) else (kernel_size,) * 2
        s = stride if isinstance(stride, tuple) else (stride,) * 2
        p = padding if isinstance(padding, tuple) else (padding,) * 2
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel, self.stride, self.padding = k, s, p
        self.bias = bias

    def lower(self, ff, t, name):
        return ff.conv2d(t, self.out_channels, *self.kernel, *self.stride,
                         *self.padding, use_bias=self.bias, name=name)


class MaxPool2d(_LayerSpec):
    def __init__(self, kernel_size, stride=None, padding=0):
        k = kernel_size if isinstance(kernel_size, tuple) else (kernel_size,) * 2
        s = stride if stride is not None else kernel_size
        s = s if isinstance(s, tuple) else (s,) * 2
        p = padding if isinstance(padding, tuple) else (padding,) * 2
        self.kernel, self.stride, self.padding = k, s, p

    def lower(self, ff, t, name):
        return ff.pool2d(t, *self.kernel, *self.stride, *self.padding, name=name)


class Linear(_LayerSpec):
    def __init__(self, in_features, out_features, bias=True):
        self.in_features, self.out_features = in_features, out_features
        self.bias = bias

    def lower(self, ff, t, name):
        return ff.dense(t, self.out_features, use_bias=self.bias, name=name)


class Flatten(_LayerSpec):
    def lower(self, ff, t, name):
        return ff.flat(t, name=name)


class AvgPool2d(_LayerSpec):
    def __init__(self, kernel_size, stride=None, padding=0):
        k = kernel_size if isinstance(kernel_size, tuple) else (kernel_size,) * 2
        s = stride if stride is not None else kernel_size
        s = s if isinstance(s, tuple) else (s,) * 2
        p = padding if isinstance(padding, tuple) else (padding,) * 2
        self.kernel, self.stride, self.padding = k, s, p

    def lower(self, ff, t, name):
        return ff.pool2d(t, *self.kernel, *self.stride, *self.padding,
                         pool_type="avg", name=name)


class BatchNorm2d(_LayerSpec):
    def __init__(self, num_features, eps=1e-5, momentum=0.1):
        self.num_features = num_features
        self.eps, self.momentum = eps, momentum

    def lower(self, ff, t, name):
        return ff.batch_norm(t, relu=False, name=name)


class Dropout(_LayerSpec):
    def __init__(self, p=0.5):
        self.p = p

    def lower(self, ff, t, name):
        return ff.dropout(t, self.p, name=name)


class ReLU(_LayerSpec):
    def lower(self, ff, t, name):
        return ff.relu(t, name=name)


class Sigmoid(_LayerSpec):
    def lower(self, ff, t, name):
        return ff.sigmoid(t, name=name)


class Tanh(_LayerSpec):
    def lower(self, ff, t, name):
        return ff.tanh(t, name=name)


class Softmax(_LayerSpec):
    def lower(self, ff, t, name):
        return ff.softmax(t, name=name)


class _Tracer:
    """Symbolic handle passed through Module.forward."""

    def __init__(self, ff, tensor, module):
        self._ff = ff
        self.tensor = tensor
        self._module = module

    def apply(self, spec):
        name = self._module._spec_names.get(id(spec))
        out = spec.lower(self._ff, self.tensor, name)
        return _Tracer(self._ff, out, self._module)


class Module:
    """User-subclassed model container (reference module.py)."""

    def forward(self, x):
        raise NotImplementedError

    def _collect_specs(self):
        self._spec_names = {}
        for attr, val in vars(self).items():
            if isinstance(val, _LayerSpec):
                self._spec_names[id(val)] = attr

    def build(self, input_shape, config: Optional[FFConfig] = None) -> FFModel:
        """Lower this module onto a core FFModel.  ``input_shape`` is
        reference-ordered (N, C, H, W) or (N, F)."""
        self._collect_specs()
        ff = FFModel(config or FFConfig())
        inp = ff.create_tensor(input_shape)
        tracer = _Tracer(ff, inp, self)
        out = self.forward(tracer)
        self._input_tensor = inp
        self._output_tensor = out.tensor
        return ff

    __call__ = forward
