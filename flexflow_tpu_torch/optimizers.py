"""Optimizers (PyTorch port of ``flexflow_tpu/optimizers.py``).

Update rules match the reference kernels (optimizer_kernel.cu:23-40,
:206-225).  State mirrors the parameter tree, ``{slot: {op: {weight:
tensor}}}``, with the JAX package's slot names ("v" for SGD momentum,
"m"/"v" for Adam), so state carries across as a copy.

Updates are in place.  With ``fused`` (set by ``FFModel.compile`` from
``FFConfig.fused_optimizer``) the update goes through the hand-written
kernels of ``kernels/fused_optimizer.py``: SGD in one launch per step over
all leaves, Adam one launch per leaf; otherwise the plain tensor update
runs.  Adam's ``alpha_t`` starts at ``alpha`` with no bias
correction and only ``next_epoch()`` advances it, as in the reference.

The step's time-varying scalar (``lr``, ``alpha_t``) also lives in one
small float32 vector per device, ``(value, skip)`` (``scalars(device)``),
which the fused kernels and the plain update read on the device: the
counterpart of the TPU kernels' SMEM operand.  Setting ``lr`` or advancing
``next_epoch()`` writes the new value into every such vector in place
(a fill on the device's current stream), outside any captured step, so a
CUDA graph of the step (runtime/step_graph.py) reads it at its next
replay.  The non-finite guard writes ``skip`` inside the step.
``hparams()`` still returns the host floats, and ``apply`` takes either.

On a mesh the parameters and the state are DTensors (the state with its
weight's placements) and every update runs on the local shards, the
counterpart of the JAX package's ``_shardwise``: the SGD launch's table
holds the local shards' addresses and sizes, and Adam launches once per
local shard.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from .kernels.fused_optimizer import (fused_adam_update, fused_adam_update_ref,
                                      fused_sgd_update_multi, fused_sgd_update_multi_ref,
                                      scalar_vector)

Params = Dict[str, Dict[str, torch.Tensor]]
OptState = Dict[str, Params]
HParams = Dict[str, Any]


def _zeros_like(params: Params) -> Params:
    return {opn: {wn: torch.zeros_like(w) for wn, w in ws.items()}
            for opn, ws in params.items()}


def _local(t: torch.Tensor) -> torch.Tensor:
    """The shard of a DTensor that this device holds (its storage: updates
    in place reach the DTensor); a plain tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


class Optimizer:
    """Base optimizer: state is a dict of params-shaped trees."""

    def init_state(self, params: Params) -> OptState:
        raise NotImplementedError

    def hparams(self) -> HParams:
        """Current time-varying scalars (lr, alpha_t) as host floats."""
        raise NotImplementedError

    def _step_size(self) -> float:
        """The value ``scalars`` holds: lr (SGD) or alpha_t (Adam)."""
        raise NotImplementedError

    def scalars(self, device) -> torch.Tensor:
        """This optimizer's scalar vector ``(step size, skip)`` on
        ``device``, made at its first request (call it outside a captured
        step) and then kept: a graph captures its address."""
        key = str(torch.device(device))
        if key not in self._vecs:
            self._vecs[key] = scalar_vector(self._step_size(), device)
        return self._vecs[key]

    def _publish(self) -> None:
        """Write the current step size into every scalar vector, in place."""
        for vec in self._vecs.values():
            vec[:1].fill_(self._step_size())

    def apply(self, params: Params, grads: Params, state: OptState,
              hparams: HParams) -> Tuple[Params, OptState]:
        """Update ``params`` and ``state`` in place; returns both.
        ``hparams`` is ``hparams()`` or ``{"scalars": scalars(device)}``."""
        raise NotImplementedError

    def next_epoch(self) -> None:
        """Per-epoch hook: Adam advances its bias-correction schedule."""


class SGDOptimizer(Optimizer):
    def __init__(self, model=None, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self._vecs: Dict[str, torch.Tensor] = {}
        self.lr = lr
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)
        self.weight_decay = float(weight_decay)
        self.fused = False

    @property
    def lr(self) -> float:
        return self._lr

    @lr.setter
    def lr(self, value: float) -> None:
        self._lr = float(value)
        self._publish()

    def _step_size(self):
        return self._lr

    def init_state(self, params):
        return {"v": _zeros_like(params)} if self.momentum > 0.0 else {}

    def hparams(self):
        return {"lr": self.lr}

    @torch.no_grad()
    def apply(self, params, grads, state, hparams):
        update = fused_sgd_update_multi if self.fused else fused_sgd_update_multi_ref
        names = [(opn, wn) for opn, ws in params.items() for wn in ws]
        bufs = state.get("v")
        update([_local(params[o][n]) for o, n in names], [_local(grads[o][n]) for o, n in names],
               None if bufs is None else [_local(bufs[o][n]) for o, n in names],
               hparams.get("scalars", hparams.get("lr")), self.weight_decay, self.momentum,
               self.nesterov)
        return params, state


class AdamOptimizer(Optimizer):
    def __init__(self, model=None, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0, epsilon: float = 1e-8):
        self._vecs: Dict[str, torch.Tensor] = {}
        self.alpha = float(alpha)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.weight_decay = float(weight_decay)
        self.epsilon = float(epsilon)
        # the reference's alpha_t/beta1_t/beta2_t fields (include/optimizer.h)
        self.beta1_t = 1.0
        self.beta2_t = 1.0
        self.alpha_t = self.alpha
        self.fused = False

    @property
    def alpha_t(self) -> float:
        return self._alpha_t

    @alpha_t.setter
    def alpha_t(self, value: float) -> None:
        self._alpha_t = float(value)
        self._publish()

    def _step_size(self):
        return self._alpha_t

    def next_epoch(self):
        self.beta1_t *= self.beta1
        self.beta2_t *= self.beta2
        self.alpha_t = self.alpha * (1.0 - self.beta2_t) ** 0.5 / (1.0 - self.beta1_t)

    def init_state(self, params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    def hparams(self):
        return {"alpha_t": self.alpha_t}

    @torch.no_grad()
    def apply(self, params, grads, state, hparams):
        update = fused_adam_update if self.fused else fused_adam_update_ref
        for opn, ws in params.items():
            for wn, w in ws.items():
                update(_local(w), _local(grads[opn][wn]), _local(state["m"][opn][wn]),
                       _local(state["v"][opn][wn]), hparams.get("scalars", hparams.get("alpha_t")),
                       self.weight_decay, self.beta1, self.beta2, self.epsilon)
        return params, state
