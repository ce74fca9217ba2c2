"""Operator base class (PyTorch port of ``flexflow_tpu/ops/base.py``).

An op is shape inference and weight declaration at construction, plus a
``forward(params, xs, ctx)`` over tensors.  The backward pass comes from
autograd; no op writes one by hand.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from ..tensor import Parameter, Tensor


@dataclasses.dataclass
class FwdCtx:
    """Per-call context threaded through op forwards."""

    training: bool = False


class Op:
    """Graph node: inputs -> outputs with optional weights."""

    _type: str = "Op"

    def __init__(self, model, inputs: Sequence[Tensor], name: Optional[str] = None):
        self.model = model
        self.guid = model._next_op_guid()
        # Reference auto-names ops "<Type>_<guid>" (src/runtime/model.cc:142-144).
        self.name = name if name else f"{self._type}_{self.guid}"
        self.inputs: List[Tensor] = list(inputs)
        self.weights: List[Parameter] = []
        self.outputs: List[Tensor] = []

    def _add_output(self, dims, dtype="float32") -> Tensor:
        t = Tensor(dims=tuple(dims), dtype=dtype, owner_op=self, owner_idx=len(self.outputs))
        self.outputs.append(t)
        return t

    def _add_weight(self, name, dims, initializer, partition_dims=None,
                    dtype="float32") -> Parameter:
        p = Parameter(name=name, dims=tuple(dims), dtype=dtype,
                      initializer=initializer, owner_op=self,
                      partition_dims=partition_dims)
        self.weights.append(p)
        return p

    @property
    def output(self) -> Tensor:
        return self.outputs[0]

    def forward(self, params: Dict[str, torch.Tensor], xs: List[torch.Tensor],
                ctx: FwdCtx) -> List[torch.Tensor]:
        raise NotImplementedError

    def flops_per_sample(self) -> float:
        """Analytic forward FLOPs per sample."""
        return 0.0

    def __repr__(self):
        ins = ",".join(str(t.dims) for t in self.inputs)
        outs = ",".join(str(t.dims) for t in self.outputs)
        return f"{self._type}({self.name}: {ins} -> {outs})"


def refuse_shared_weights(share_with) -> None:
    if share_with is not None:
        raise NotImplementedError(
            "weight sharing (share_with) is not ported yet: it arrives with "
            "the LSTM/NMT ops (ROADMAP A9)")
