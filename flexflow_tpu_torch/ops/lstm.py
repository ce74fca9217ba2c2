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
batch split and a hidden split (config dim 2) on local shards.  A part of
a hidden split of degree k computes its H/k slice of every gate from its
columns of ``w_ih``, ``w_hh`` and ``bias``, and each of the T steps
all-gathers the full h (B, H) that ``w_hh``'s contraction reads
(``all_gather_dim``; the backward reduce-scatters its gradient).  The
logical gate dim is [i | f | g | o], 4H wide; a contiguous split of it
would give part 0 of 2 the whole i and f gates, so under a hidden split
the weights are stored gate-blocked (``stored``): part p's columns are
[i_p | f_p | g_p | o_p].  ``get_parameter``, ``set_parameter``,
checkpoints, ``convert`` and the strategy codec see the logical layout.
h_T and c_T are computed split on their hidden dim and then placed as the
op's config places a rank-2 output.  ``forward_parts`` runs the same parts
in lockstep in one process.  ``decode`` advances a cached f32 (h, c) one
token at a time, as the JAX package's (ops/lstm.py:126-160 there).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch.distributed.tensor import Replicate, Shard

from .base import FwdCtx, Op
from ..initializers import DefaultWeightInitializer, ZeroInitializer
from ..parallel.collectives import all_gather_dim

GATED = ("w_ih", "w_hh", "bias")  # the weights whose last dim is the 4H gates


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

    # -- the hidden split ---------------------------------------------------
    @staticmethod
    def _hidden_degree(pc) -> int:
        return pc.dims[2] if pc is not None and len(pc.dims) > 2 else 1

    def stored(self, w_name: str, value: torch.Tensor, inverse: bool = False) -> torch.Tensor:
        """A gated weight in the op's stored layout, or with ``inverse``
        back in the logical one.  Gate-blocked for the op's hidden degree
        k: stored column ``p * 4H/k + g * H/k + j`` is logical column
        ``g * H + p * H/k + j`` (gate g of part p's hidden unit j), a
        transpose of the (gate, part) dims."""
        k = self._hidden_degree(getattr(self, "pc", None))
        if k == 1 or w_name not in GATED:
            return value
        lead, hp = value.shape[:-1], self.hidden_size // k
        blocks = (k, 4) if inverse else (4, k)
        return value.reshape(*lead, *blocks, hp).transpose(-3, -2).reshape(*lead, 4 * k * hp)

    def compute_placements(self, machine, output_idx: int = 0) -> tuple:
        """y under the op's config; h_T and c_T split as y is on the batch
        and the hidden dim (each part computed its slice)."""
        pl = machine.spec_for_config(self.pc, 3)
        if output_idx == 0:
            return pl
        return tuple(Shard(1) if isinstance(p, Shard) and p.dim == 2 else p for p in pl)

    def weight_placements(self, w, out_pl) -> tuple:
        """A sharer of another hidden degree than its owner reads the
        owner's gated weights whole and takes its own parts' columns."""
        if (self.share_from is not None and w.name in GATED
                and self._hidden_degree(self.share_from.pc) != self._hidden_degree(self.pc)):
            return tuple(Replicate() for _ in out_pl)
        return super().weight_placements(w, out_pl)

    def local_forward(self, machine, out_pl):
        k = self._hidden_degree(self.pc)
        owner_k = self._hidden_degree(self.share_from.pc) if self.share_from else k
        if k == 1 and owner_k == 1:
            return self.forward
        names, _, part = machine.split_of(out_pl, 2)
        group = machine.group(names) if k > 1 else None

        def fwd(params, xs, ctx):
            if owner_k != k:  # the owner's whole gated weights, to this op's parts
                params = dict(params)
                for n in GATED:
                    logical = self.share_from.stored(n, params[n], inverse=True)
                    params[n] = self._part_columns(logical, k, part)
            if k == 1:
                return self.forward(params, xs, ctx)
            return self._forward_parts([params], xs, [part], k,
                                       lambda hs: all_gather_dim(hs[0], 1, group))

        return fwd

    def _part_columns(self, logical: torch.Tensor, k: int, part: int) -> torch.Tensor:
        """Part ``part`` of ``k``'s gate-blocked columns of a logical gated
        weight: its H/k slice of each gate."""
        lead, hp = logical.shape[:-1], self.hidden_size // k
        return logical.reshape(*lead, 4, k, hp)[..., part, :].reshape(*lead, 4 * hp)

    def forward_parts(self, params, xs: List[torch.Tensor], k: int, ctx: FwdCtx = None):
        """The op as ``k`` hidden parts in lockstep in one process, from the
        logical weights: each part's gate columns, one h gather a step (a
        concatenation), the parts' outputs put together on the hidden dim."""
        parts = [{n: (self._part_columns(v, k, p) if n in GATED else v)
                  for n, v in params.items()} for p in range(k)]
        return self._forward_parts(parts, xs, list(range(k)), k,
                                   lambda hs: all_gather_dim(hs, 1, None))

    def _forward_parts(self, parts, xs, idx, k: int, gather):
        """The recurrence of the hidden parts ``idx`` (weights ``parts``, in
        the gate-blocked layout) of a ``k``-way split; ``gather(h_parts)``
        gives the full h (B, H) from the parts' new h.  Returns [y, h_T,
        c_T], each the parts' slices put together on the hidden dim."""
        x = xs[0]
        b, t, _ = x.shape
        hp = self.hidden_size // k
        dt = x.dtype
        if self.has_state_inputs:
            h_prev = xs[1].float()
            cs = [xs[2].float()[:, p * hp:(p + 1) * hp] for p in idx]
        else:
            h_prev = torch.zeros(b, self.hidden_size, device=x.device)
            cs = [torch.zeros(b, hp, device=x.device) for _ in idx]
        xzs = [(torch.matmul(x.reshape(b * t, -1), w["w_ih"].to(dt)).float()
                .reshape(b, t, 4 * hp) + w["bias"].float()) for w in parts]
        whh = [w["w_hh"].to(dt) for w in parts]
        ys = [[] for _ in idx]
        for s in range(t):
            hs = []
            for j in range(len(idx)):
                z = xzs[j][:, s] + torch.matmul(h_prev.to(dt), whh[j]).float()
                h_new, cs[j] = self._gates(z, cs[j], hp)
                ys[j].append(h_new)
                hs.append(h_new.to(dt))
            h_prev = gather(hs)
        y = torch.cat([torch.stack(v, dim=1) for v in ys], 2).to(dt)
        return [y, torch.cat([v[-1] for v in ys], 1).to(dt), torch.cat(cs, 1).to(dt)]

    def _cache_hidden(self) -> int:
        """The hidden units whose (h, c) this rank caches: all of them, or
        on a mesh this rank's part of the hidden split."""
        m = self.model
        if not m._sharded:
            return self.hidden_size
        _, sizes, _ = m.machine.split_of(self.decode_placements(m.machine), 2)
        return self.hidden_size // math.prod(sizes)

    def init_cache(self, batch_size: int, max_len: int, dtype):
        h = self._cache_hidden()
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
        h_prev = cache["h"]
        if self.has_state_inputs:
            h_prev = torch.where(self._at0(pos), xs[1].float(), h_prev)
        return self._decode_part(params, xs, cache, pos, h_prev, slice(None)), cache

    @staticmethod
    def _at0(pos):
        return (pos == 0)[:, None] if pos.dim() else pos == 0

    def _decode_part(self, params, xs, cache, pos, h_prev, cols: slice):
        """The step of the hidden units ``cols`` (weights in their
        gate-blocked layout) from the whole h (B, H): their new (h, c) into
        the cache, returned as [y, h_T, c_T] of those units."""
        x = xs[0]
        dt = x.dtype
        w_ih = params["w_ih"].to(dt)
        h = w_ih.shape[1] // 4
        c0 = cache["c"]
        if self.has_state_inputs:
            c0 = torch.where(self._at0(pos), xs[2].float()[:, cols], c0)
        z = torch.matmul(x[:, 0, :], w_ih).float() + params["bias"].float()
        z = z + torch.matmul(h_prev.to(dt), params["w_hh"].to(dt)).float()
        h_new, c_new = self._gates(z, c0, h)
        cache["h"].copy_(h_new)
        cache["c"].copy_(c_new)
        return [h_new[:, None, :].to(dt), h_new.to(dt), c_new.to(dt)]

    def decode_sharded(self, machine, params, xs, cache, pos, ctx: FwdCtx):
        """``decode`` on a mesh: under a hidden split of degree k this rank
        caches its (B, H/k) part of (h, c), all-gathers h once a token (as
        the training forward does a step) and computes its units from its
        gate-blocked columns; a full-sequence input runs the forward with
        its rows whole."""
        out_pl = self.decode_placements(machine)
        if xs[0].shape[1] != 1:
            fwd = self.local_forward(machine, out_pl)
            return self._decode_on_shards(machine, params, xs,
                                          lambda p, ls: fwd(p, ls, ctx)), cache
        k = self._hidden_degree(self.pc)
        owner_k = self._hidden_degree(self.share_from.pc) if self.share_from else k
        names, _, part = machine.split_of(out_pl, 2)
        group = machine.group(names) if k > 1 else None
        hp = self.hidden_size // k

        def step(p, ls):
            if owner_k != k:  # the owner's whole gated weights, to this op's part
                p = dict(p)
                for n in GATED:
                    p[n] = self._part_columns(self.share_from.stored(n, p[n], inverse=True),
                                              k, part)
            h_prev = cache["h"] if group is None else all_gather_dim(cache["h"], 1, group)
            if self.has_state_inputs:
                h_prev = torch.where(self._at0(pos), ls[1].float(), h_prev)
            return self._decode_part(p, ls, cache, pos, h_prev,
                                     slice(part * hp, (part + 1) * hp))

        return self._decode_on_shards(machine, params, xs, step), cache

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
