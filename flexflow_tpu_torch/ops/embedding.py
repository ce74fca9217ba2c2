"""Embedding operator (PyTorch port of ``flexflow_tpu/ops/embedding.py``).

A gather of table rows (``F.embedding``), whose backward scatter-add comes
from autograd; the JAX package leaves the same gather to XLA, so it is a
library call here too.  Input is (B, num_indices) int; aggregation SUM or
AVG over the ``num_indices`` dim, or NONE to keep it (a token sequence).
The output is cast to the model's compute dtype.  With ``share_with`` the
op reads another embedding's table (NMT's decoder reads the encoder's).
A host-placed table lives in host memory (``runtime/host_tables.py``).
On a mesh the gather runs on local ids and the local columns of the
table.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from .base import FwdCtx, Op
from ..initializers import GlorotUniform


class AggrMode:
    NONE = "none"
    SUM = "sum"
    AVG = "avg"


class Embedding(Op):
    _type = "Embedding"
    mixes_features = True  # the table's columns are the output's last dim

    def __init__(self, model, input_tensor, num_entries: int, out_dim: int,
                 aggr: str = AggrMode.SUM, kernel_initializer=None,
                 share_with=None, name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        self.num_entries = num_entries
        self.out_dim = out_dim
        self.aggr = aggr
        batch = input_tensor.dims[0]
        if aggr == AggrMode.NONE and (len(input_tensor.dims) != 2 or input_tensor.dims[1] != 1):
            self._add_output(input_tensor.dims + (out_dim,), "float32")  # keep the sequence dim
        else:
            self._add_output((batch, out_dim), "float32")
        if self._share(share_with, lambda sw: isinstance(sw, Embedding) and
                       (sw.num_entries, sw.out_dim) == (num_entries, out_dim)):
            return
        self._add_weight("weight", (num_entries, out_dim),
                         kernel_initializer or GlorotUniform(),
                         partition_dims=(None, len(self.output.dims) - 1))

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        emb = F.embedding(xs[0].long(), params["weight"])  # (B, I, D), or (B, D) for (B,) ids
        if self.aggr == AggrMode.SUM and emb.ndim == 3:
            emb = emb.sum(1)
        elif self.aggr == AggrMode.AVG and emb.ndim == 3:
            emb = emb.mean(1)
        elif self.aggr == AggrMode.NONE and emb.ndim == 3 and self.output.num_dims == 2:
            emb = emb[:, 0, :]
        return [emb.to(self.model.compute_dtype)]

    def flops_per_sample(self):
        n_idx = self.inputs[0].dims[1] if len(self.inputs[0].dims) > 1 else 1
        return float(n_idx * self.out_dim)
