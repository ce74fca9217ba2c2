"""Mixture-of-experts MLP (PyTorch port of ``flexflow_tpu/ops/moe.py``).

Switch routing, top-1, with the router in float32: each token goes to
``argmax(softmax(x @ router))``, weighted by that gate; an expert takes at
most ``capacity = ceil(tokens / E * capacity_factor)`` tokens in token
order, and the tokens past it are dropped (output 0; the caller adds the
residual).  Dispatch and combine are the JAX package's dense one-hot
einsums over an (S, E, C) tensor, so the routing, the drops and the
results match it.  Every shape is static and nothing reads the device
from the host (no ``.item()``, no boolean indexing), so the op runs inside
a captured CUDA graph.

On a mesh the op computes a batch split and an expert split (config dim
1, the expert parallel degree ep) on local shards.  The capacity and each
token's place in its expert's queue are the global batch's: every batch
part adds the token counts of the parts before it (one all-gather of E
counts), so a strategy changes placement, not results.  Under an expert
split the tokens stay replicated in the ep group and every part routes
them all, so the routing and the dropped tokens are the unsplit op's; a
part holds and computes only its E/ep experts (``w_in``, ``b_in``,
``w_out``, ``b_out`` split on the expert dim, the router replicated), and
its output is its experts' summand of the combine, a ``Partial`` on the
ep mesh dims that the output's placement sums (one all-reduce of the
(tokens, D) output; its backward hands every part the whole gradient).
Against an ``all_to_all`` of the dispatched tokens, this moves the output
once instead of the (E, C, D) slots twice, and needs no second routing
exchange; ``forward_parts`` runs the same parts in lockstep in one
process.  ``decode`` routes dropless, as the JAX package's.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
from torch.distributed.tensor import Partial

from .base import FwdCtx, Op
from .conv2d import apply_activation
from ..config import ParallelConfig
from ..initializers import DefaultWeightInitializer, ZeroInitializer


class ExpertMLP(Op):
    _type = "ExpertMLP"
    mixes_features = True  # the router and w_in read every feature

    def __init__(self, model, input_tensor, num_experts: int, hidden_size: int,
                 capacity_factor: float = 1.25, activation: str = "relu",
                 name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        dims = input_tensor.dims
        d = dims[-1]
        self.num_experts = int(num_experts)
        self.hidden_size = int(hidden_size)
        self.capacity_factor = float(capacity_factor)
        self.activation = activation
        e, h = self.num_experts, self.hidden_size
        # the expert dim splits with config dim 1 (the expert degree)
        self._add_weight("router", (d, e), DefaultWeightInitializer())
        self._add_weight("w_in", (e, d, h), DefaultWeightInitializer(),
                         partition_dims=(1, None, None))
        self._add_weight("b_in", (e, h), ZeroInitializer(), partition_dims=(1, None))
        self._add_weight("w_out", (e, h, d), DefaultWeightInitializer(),
                         partition_dims=(1, None, None))
        self._add_weight("b_out", (e, d), ZeroInitializer(), partition_dims=(1, None))
        self._add_output(dims, input_tensor.dtype)

    @property
    def unsplit_dims(self):
        # a token's output needs all of its features: only the batch splits
        return tuple(range(1, self.output.num_dims))

    def _config_dim_bound(self, i: int):
        """Config dim 1 is the expert degree: it must divide num_experts."""
        if i == 1:
            return self.num_experts
        return super()._config_dim_bound(i)

    def constraint_pc(self) -> ParallelConfig:
        """The output is split on the batch only."""
        return ParallelConfig(dims=(self.pc.dims[0],) + (1,) * (self.output.num_dims - 1))

    def capacity(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.num_experts * self.capacity_factor))

    def route(self, xf: torch.Tensor, router: torch.Tensor, slots: int, cap: int,
              offsets: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        """Top-1 routing of the tokens ``xf`` (S, D), in float32: the expert
        index (S,), the gate (S,), the keep mask (S, E) (the chosen expert,
        if the token's place in its queue is within ``cap``) and each
        token's slot (S, ``slots``), one-hot."""
        e = router.shape[1]
        gates = torch.softmax(torch.matmul(xf.float(), router.float()), dim=-1)
        idx, gate = torch.argmax(gates, dim=-1), gates.amax(dim=-1)
        onehot = (idx[:, None] == torch.arange(e, device=xf.device)).float()  # (S, E)
        pos = torch.cumsum(onehot, dim=0) * onehot  # 1-based place in this part
        gpos = pos if offsets is None else pos + offsets(onehot.sum(0)) * onehot
        keep = (gpos > 0) & (gpos <= cap)
        slot_idx = (pos - 1.0).clamp(0, slots - 1).long().amax(dim=-1)
        slot = (slot_idx[:, None] == torch.arange(slots, device=xf.device)).float()
        return idx, gate, keep, slot

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        return [self._forward(params, xs[0], 1, None)]

    def _forward(self, params, x: torch.Tensor, parts: int,
                 offsets: Optional[Callable[[torch.Tensor], torch.Tensor]],
                 experts: Optional[slice] = None, keep_out: Optional[list] = None
                 ) -> torch.Tensor:
        """The layer on ``x``, which is one of ``parts`` equal batch parts;
        ``offsets(counts)`` gives, per expert, the tokens the parts before
        this one route there.  With ``experts``, the weights are those
        experts' alone and the result is their summand of the output.
        ``keep_out`` receives the keep mask (S, E)."""
        shape = x.shape
        d = shape[-1]
        dt = x.dtype
        xf = x.reshape(-1, d)
        s = xf.shape[0]
        cap = self.capacity(s * parts)
        slots = cap if parts == 1 else min(cap, s)  # a part keeps at most s
        _, gate, keep, slot = self.route(xf, params["router"], slots, cap, offsets)
        if keep_out is not None:
            keep_out.append(keep)
        if experts is not None:
            keep = keep[:, experts]
        disp = keep.float()[:, :, None] * slot[:, None, :]  # (S, E, C)
        expert_in = torch.einsum("sec,sd->ecd", disp, xf.float())
        hmid = torch.einsum("ecd,edh->ech", expert_in.to(dt), params["w_in"].to(dt))
        hmid = apply_activation(hmid + params["b_in"].to(hmid.dtype)[:, None, :],
                                self.activation)
        y_e = torch.einsum("ech,ehd->ecd", hmid, params["w_out"].to(dt))
        y_e = y_e + params["b_out"].to(y_e.dtype)[:, None, :]
        comb = disp * gate[:, None, None]
        y = torch.einsum("sec,ecd->sd", comb, y_e.float()).to(dt)
        return y.reshape(shape)

    def forward_sharded(self, machine, params, xs, ctx: FwdCtx) -> List:
        full_pl = machine.spec_for_config(self.pc, self.output.num_dims)
        ep_names, ep_sizes, ep_idx = machine.split_of(full_pl, 1)
        ep = math.prod(ep_sizes)
        batch_only = self.compute_placements(machine)
        # the tokens replicated over the ep dims, each part's output there
        # a summand of the combine
        out_pl = tuple(Partial() if n in ep_names else p
                       for n, p in zip(machine.axis_names, batch_only))
        parts = self.pc.dims[0]
        names = [w.name for w in self.weights]
        args = [(xs[0], self.input_placements(batch_only, 0))]
        args += [(params[w.name], self.weight_placements(w, full_pl)) for w in self.weights]
        batch_pl = machine.batch_sharding(parts)
        me = machine.batch_index(parts)
        per = self.num_experts // ep
        experts = slice(ep_idx * per, (ep_idx + 1) * per) if ep > 1 else None

        def offsets(counts):
            every = machine.from_local(counts[None], batch_pl).full_tensor()  # (parts, E)
            return every[:me].sum(0)

        def local(x, *ws):
            return self._forward(dict(zip(names, ws)), x, parts,
                                 offsets if parts > 1 else None, experts)

        return [machine.local_call(local, args, out_pl)]

    def forward_parts(self, params, x: torch.Tensor, dp: int, ep: int,
                      keep_out: Optional[list] = None) -> torch.Tensor:
        """The layer as ``dp`` batch parts x ``ep`` expert parts in lockstep
        in one process: each batch part routes its tokens at the global
        batch's capacity and queue places, each expert part computes its
        experts' summand, the summands are added and the batch parts put
        together.  ``keep_out`` receives each batch part's keep mask."""
        xs = list(torch.chunk(x, dp, 0))
        counts = []
        for xp in xs:  # each part's routed-token counts, for the queue offsets
            idx, _, _, _ = self.route(xp.reshape(-1, x.shape[-1]), params["router"], 1, 1)
            counts.append(torch.bincount(idx, minlength=self.num_experts).float())
        per = self.num_experts // ep
        ys = []
        for i, xp in enumerate(xs):
            def offsets(c, i=i):
                return sum(counts[:i], torch.zeros_like(c))
            y = 0
            for q in range(ep):
                sl = slice(q * per, (q + 1) * per)
                local = {n: (v if n == "router" else v[sl]) for n, v in params.items()}
                y = y + self._forward(local, xp, dp, offsets if dp > 1 else None,
                                      sl if ep > 1 else None,
                                      keep_out if q == 0 else None)
            ys.append(y)
        return torch.cat(ys, 0)

    def decode(self, params, xs, cache, pos, ctx: FwdCtx):
        """Dropless routing for decoding (the JAX package's ops/moe.py:140-165):
        each token goes to its chosen expert, with no capacity cut (a step
        routes only B tokens, and a cut would silently zero some).  Every
        expert is computed for every token and the one-hot gate picks one;
        equal to ``forward`` wherever its capacity drops nothing."""
        return [self._decode(params, xs[0], None)], cache

    def _decode(self, params, x: torch.Tensor, experts: Optional[slice]) -> torch.Tensor:
        """The dropless layer on ``x``; with ``experts``, the weights are
        those experts' alone and the result is their summand of it."""
        shape = x.shape
        dt = x.dtype
        xf = x.reshape(-1, shape[-1])
        e = params["router"].shape[1]
        gates = torch.softmax(torch.matmul(xf.float(), params["router"].float()), dim=-1)
        gate = gates.amax(dim=-1)
        onehot = (torch.argmax(gates, dim=-1)[:, None]
                  == torch.arange(e, device=x.device)).float()  # (S, E); ties: first
        if experts is not None:
            onehot = onehot[:, experts]
        h = torch.einsum("sd,edh->seh", xf, params["w_in"].to(dt))
        h = apply_activation(h + params["b_in"].to(h.dtype)[None, :, :], self.activation)
        y_e = torch.einsum("seh,ehd->sed", h, params["w_out"].to(dt))
        y_e = y_e + params["b_out"].to(y_e.dtype)[None, :, :]
        y = torch.einsum("se,sed->sd", onehot * gate[:, None], y_e.float()).to(dt)
        return y.reshape(shape)

    def decode_sharded(self, machine, params, xs, cache, pos, ctx: FwdCtx):
        """``decode`` on a mesh: every rank routes the whole step's tokens
        (the router replicated, so the choice and its tie-break are the
        unsplit op's), runs its E/ep experts, and the output is their
        summand, a ``Partial`` on the ep mesh dims summed where it is read
        (the training forward's combine)."""
        full_pl = machine.spec_for_config(self.pc, self.output.num_dims)
        ep_names, ep_sizes, ep_idx = machine.split_of(full_pl, 1)
        ep = math.prod(ep_sizes)
        out_pl = tuple(Partial() if n in ep_names else p
                       for n, p in zip(machine.axis_names, self.decode_placements(machine)))
        per = self.num_experts // ep
        experts = slice(ep_idx * per, (ep_idx + 1) * per) if ep > 1 else None
        names = [w.name for w in self.weights]
        args = [(xs[0], self.input_placements(self.decode_placements(machine), 0))]
        args += [(params[w.name], self.weight_placements(w, full_pl)) for w in self.weights]

        def local(x, *ws):
            return self._decode(dict(zip(names, ws)), x, experts)

        return [machine.local_call(local, args, out_pl)], cache

    def flops_per_sample(self):
        dims = self.output.dims
        d = dims[-1]
        tokens_per_sample = 1
        for dim in dims[1:-1]:
            tokens_per_sample *= dim
        h = self.hidden_size
        # the router and one expert's two projections per token, with the
        # capacity's slack
        return tokens_per_sample * (2.0 * d * self.num_experts
                                    + self.capacity_factor * 4.0 * d * h)
