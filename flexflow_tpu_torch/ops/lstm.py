"""LSTM operator (PyTorch port of ``flexflow_tpu/ops/lstm.py``; reference:
nmt/lstm.cu).

The input projection of every time step is one ``(B*T, E) x (E, 4H)``
matmul; only the recurrent ``h x (H, 4H)`` product runs inside the
``T``-step loop, as the JAX package's ``lax.scan``.  Gate order (i, f, g,
o); the gates, the cell state and the carried ``h`` are float32, and the
matmuls run in the compute dtype (f32 accumulation inside cuBLAS under
bf16).  On a CUDA device the loop is unrolled into the step's CUDA graph
(runtime/step_graph.py), so it costs the host nothing after the capture.

Inputs:  x (B, T, E) [+ optional h0 (B, H), c0 (B, H)]
Outputs: y (B, T, H), h_T (B, H), c_T (B, H)

``share_with`` reads another LSTM's weights.  On a mesh the op computes a
batch split on local shards; the JAX package's hidden split (config dim
2, an all-gather of ``h`` each step) is not ported (ROADMAP A9).
``decode`` advances a cached f32 (h, c) one token at a time, as the JAX
package's (ops/lstm.py:126-160 there).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .base import FwdCtx, Op
from ..initializers import DefaultWeightInitializer, ZeroInitializer


class LSTM(Op):
    _type = "LSTM"
    mixes_features = True  # w_ih maps the input's features to the gates

    def __init__(self, model, input_tensor, hidden_size: int, hx=None, cx=None,
                 share_with: Optional[Op] = None, name: Optional[str] = None):
        inputs = [input_tensor]
        if (hx is None) != (cx is None):
            raise ValueError("provide both hx and cx or neither")
        if hx is not None:
            inputs += [hx, cx]
        super().__init__(model, inputs, name)
        b, t, e = input_tensor.dims
        h = hidden_size
        self.hidden_size = h
        self.has_state_inputs = hx is not None
        self._add_output((b, t, h), input_tensor.dtype)   # y
        self._add_output((b, h), input_tensor.dtype)      # h_T
        self._add_output((b, h), input_tensor.dtype)      # c_T
        if self._share(share_with, lambda sw: isinstance(sw, LSTM) and sw.hidden_size == h):
            return
        # the 4H gate dim splits with the output's hidden dim (config dim 2)
        self._add_weight("w_ih", (e, 4 * h), DefaultWeightInitializer(),
                         partition_dims=(None, 2))
        self._add_weight("w_hh", (h, 4 * h), DefaultWeightInitializer(),
                         partition_dims=(None, 2))
        self._add_weight("bias", (4 * h,), ZeroInitializer(), partition_dims=(2,))

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        x = xs[0]
        b, t, _ = x.shape
        # h from the weight: the cost model times one part of a hidden split
        # with its column slice of the weights; the carry then stays H wide
        # and each step's part output is tiled up to it (the JAX package's
        # stand-in for the per-step all-gather)
        h = params["w_ih"].shape[1] // 4
        dt = x.dtype
        w_ih = params["w_ih"].to(dt)
        w_hh = params["w_hh"].to(dt)
        bias = params["bias"].float()
        h_full = w_hh.shape[0]
        if self.has_state_inputs:
            h_prev, c = xs[1].float(), xs[2].float()
            if h != h_full:
                c = c[:, :h]
        else:
            h_prev = torch.zeros(b, h_full, device=x.device)
            c = torch.zeros(b, h, device=x.device)
        xz = torch.matmul(x.reshape(b * t, -1), w_ih).float().reshape(b, t, 4 * h) + bias
        ys = []
        for s in range(t):
            z = xz[:, s] + torch.matmul(h_prev.to(dt), w_hh).float()
            h_new, c = self._gates(z, c, h)
            h_prev = h_new if h == h_full else h_new.repeat(1, h_full // h)
            ys.append(h_new)
        y = torch.stack(ys, dim=1).to(dt)
        return [y, ys[-1].to(dt), c.to(dt)]

    @staticmethod
    def _gates(z: torch.Tensor, c_prev: torch.Tensor, h: int):
        """The cell from pre-activation gates z (B, 4H): (h_new, c_new)."""
        z = z.reshape(z.shape[0], 4, h)
        i, f, g, o = z[:, 0], z[:, 1], z[:, 2], z[:, 3]
        c_new = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new

    def check_config(self, pc) -> None:
        if len(pc.dims) > 2 and pc.dims[2] > 1:
            raise NotImplementedError(
                f"{self.name}: the LSTM's hidden split (config dim 2, an all-gather of h "
                "each step) is not ported yet (ROADMAP A9)")

    def init_cache(self, batch_size: int, max_len: int, dtype):
        h = self.hidden_size
        dev = self.model.device
        return {"h": torch.zeros(batch_size, h, device=dev),
                "c": torch.zeros(batch_size, h, device=dev)}

    def decode(self, params, xs, cache, pos, ctx: FwdCtx):
        """One recurrence step on a (B, 1, E) input, advancing the cached f32
        (h, c) in place.  At position 0 the carry is seeded from the hx/cx
        graph inputs (the encoder's final state), per row when ``pos`` is a
        vector.  A full-sequence input (an encoder pass) runs ``forward``."""
        x = xs[0]
        if x.shape[1] != 1:
            return self.forward(params, xs, ctx), cache
        dt = x.dtype
        w_ih = params["w_ih"].to(dt)
        w_hh = params["w_hh"].to(dt)
        h = w_ih.shape[1] // 4
        h0, c0 = cache["h"], cache["c"]
        if self.has_state_inputs:
            at0 = (pos == 0)[:, None] if pos.dim() else pos == 0
            h0 = torch.where(at0, xs[1].float(), h0)
            c0 = torch.where(at0, xs[2].float(), c0)
        z = torch.matmul(x[:, 0, :], w_ih).float() + params["bias"].float()
        z = z + torch.matmul(h0.to(dt), w_hh).float()
        h_new, c_new = self._gates(z, c0, h)
        cache["h"].copy_(h_new)
        cache["c"].copy_(c_new)
        return [h_new[:, None, :].to(dt), h_new.to(dt), c_new.to(dt)], cache

    def flops_per_sample(self):
        _, t, e = self.inputs[0].dims
        h = self.hidden_size
        return 2.0 * t * (e + h) * 4 * h

    def _config_dim_bound(self, i: int):
        """Time (dim 1) never splits: the recurrence is sequential."""
        if i == 1:
            return 1
        return super()._config_dim_bound(i)

    def input_ranges(self, j, pc, part_idx):
        """Batch-tiled only: every hidden part reads the whole input
        features and the whole h0/c0."""
        in_dims = self.inputs[j].dims
        b_lo, b_hi = self.output_tile(pc, part_idx)[0]
        return [(b_lo, b_hi)] + [(0, s - 1) for s in in_dims[1:]]
