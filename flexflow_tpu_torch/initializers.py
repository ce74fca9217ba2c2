"""Weight initializers (PyTorch port of ``flexflow_tpu/initializers.py``).

Each initializer draws from an explicit ``torch.Generator``.
``FFModel.init_layers`` seeds one generator per (op, weight) from the run
seed and ``crc32("op/weight")``, as the JAX package folds that salt into
its key, so a graph initializes the same way whatever else was built.
The generator lives on the CPU and the values move to the model's device
afterwards, so a CPU run and a GPU run start from identical weights.  The
values differ from the JAX package's threefry streams; parity tests carry
weights across with ``convert.load_jax_params`` instead.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


class Initializer:
    def __call__(self, generator: torch.Generator, shape: Tuple[int, ...],
                 dtype=torch.float32) -> torch.Tensor:
        raise NotImplementedError


def _uniform(generator, shape, dtype, lo, hi):
    return torch.rand(tuple(shape), generator=generator, dtype=dtype) * (hi - lo) + lo


class GlorotUniform(Initializer):
    """U(-s, s) with s = sqrt(6/(fan_in+fan_out)); conv kernels are HWIO
    (fan_in = h*w*cin, fan_out = h*w*cout), dense kernels (cin, cout)."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    @staticmethod
    def _fans(shape: Sequence[int]) -> Tuple[float, float]:
        if len(shape) == 4:
            rf = shape[0] * shape[1]
            return float(rf * shape[2]), float(rf * shape[3])
        if len(shape) == 2:
            return float(shape[0]), float(shape[1])
        if len(shape) == 1:
            return float(shape[0]), float(shape[0])
        recept = 1
        for d in shape[1:-1]:
            recept *= d
        return float(shape[0] * recept), float(shape[-1] * recept)

    def __call__(self, generator, shape, dtype=torch.float32):
        fan_in, fan_out = self._fans(shape)
        scale = math.sqrt(6.0 / max(1.0, fan_in + fan_out))
        return _uniform(generator, shape, dtype, -scale, scale)


class ZeroInitializer(Initializer):
    def __call__(self, generator, shape, dtype=torch.float32):
        return torch.zeros(tuple(shape), dtype=dtype)


class ConstantInitializer(Initializer):
    def __init__(self, value: float):
        self.value = value

    def __call__(self, generator, shape, dtype=torch.float32):
        return torch.full(tuple(shape), self.value, dtype=dtype)


class UniformInitializer(Initializer):
    def __init__(self, seed: int = 0, min_val: float = 0.0, max_val: float = 1.0):
        self.seed = seed
        self.min_val = min_val
        self.max_val = max_val

    def __call__(self, generator, shape, dtype=torch.float32):
        return _uniform(generator, shape, dtype, self.min_val, self.max_val)


class NormInitializer(Initializer):
    def __init__(self, seed: int = 0, mean: float = 0.0, stddev: float = 1.0):
        self.seed = seed
        self.mean = mean
        self.stddev = stddev

    def __call__(self, generator, shape, dtype=torch.float32):
        return self.mean + self.stddev * torch.randn(tuple(shape), generator=generator,
                                                     dtype=dtype)


DefaultWeightInitializer = GlorotUniform
DefaultBiasInitializer = ZeroInitializer
