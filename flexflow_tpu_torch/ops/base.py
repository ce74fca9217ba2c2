"""Operator base class (PyTorch port of ``flexflow_tpu/ops/base.py``).

An op is shape inference and weight declaration at construction, plus a
``forward(params, xs, ctx)`` over tensors.  The backward pass comes from
autograd; no op writes one by hand.

On a mesh (``parallel/mesh.py``) ``forward_sharded`` runs the same
``forward`` on local shards, under the op's config with the output dims
it cannot compute split (``unsplit_dims``) computed whole; each weight is
split as the output dim its ``partition_dims`` names.  An op whose parts
need the mesh returns its own per-part function from ``local_forward``
(a convolution's halo exchange, the LSTM's h gather, BatchNorm's moments),
and an op may store a weight in another layout than the logical one
(``stored``: the LSTM's gate-blocked columns), which the model's state
paths convert at their edges.  ``legalize_pc`` clamps a config to one the
op can execute.  A decode step on a mesh (``decode_sharded``,
``decode_paged_sharded``) computes under ``decode_placements``: the
training placements with the sample and sequence dims folded to
``Replicate``, each weight as the training forward holds it.

The simulator (``simulator/``) reads an op through its tiling hooks, as
the JAX package's does: ``output_tile``, ``input_ranges`` and
``weight_tile`` give the rectangles one part of a config writes, reads and
holds, and ``part_forward`` what one part computes (the cost model times
it on the card).

Weight sharing (``share_with``, the reference's SharedVariable): a sharing
op declares no weights of its own and reads its owner's, under the
owner's name (``param_key``), so the parameter tree, the optimizer and a
checkpoint hold the weight once and autograd sums the gradients of its
uses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from ..config import ParallelConfig
from ..parallel.mesh import fold
from ..tensor import Parameter, Tensor


@dataclasses.dataclass
class FwdCtx:
    """Per-call context threaded through op forwards: whether the call
    trains, the generator that random draws come from (the model's device
    generator in a training step), and the running statistics read
    (``stats_in``) and, in training, the updated ones (``stats_out``), each
    ``{op name: {name: tensor}}`` (the JAX package's ops/base.py:30-41)."""

    training: bool = False
    rng: Optional[torch.Generator] = None
    stats_in: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
    stats_out: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
    # op guid -> its keep mask, drawn once per call (``keep_mask``), or
    # drawn before the call (a lowered step's, ``draw_masks``)
    masks: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    # a list: the call only records each draw's (op guid, shape, keep) in
    # order and draws nothing (``FFModel._draw_masks``'s probe)
    plan: Optional[list] = None

    def keep_mask(self, op: "Op", shape, keep: float, device) -> torch.Tensor:
        """``op``'s dropout keep mask for this call (True with probability
        ``keep``), drawn from ``rng`` at the first ask and the same tensor
        at every later one: a rematerialized op's recompute in the backward
        reads the mask its forward drew, so no generator state is replayed.
        Ops draw in graph order, one draw each, so a step's masks follow
        from the generator's state before it."""
        mask = self.masks.get(op.guid)
        if mask is None:
            if self.plan is not None:
                self.plan.append((op.guid, tuple(shape), float(keep)))
                mask = torch.ones(shape, dtype=torch.bool, device=device)
            elif self.rng is None:
                raise RuntimeError(f"op {op.name} draws a dropout mask, but the call has "
                                   "no generator (FwdCtx.rng)")
            else:
                mask = torch.rand(shape, generator=self.rng, device=device) < keep
            self.masks[op.guid] = mask
        return mask


def draw_masks(plan, rng: torch.Generator, device) -> Dict[int, torch.Tensor]:
    """The keep masks of a recorded ``plan`` (``FwdCtx.plan``), drawn from
    ``rng`` in its order: what the op walk would draw, drawn before a
    compiled region that cannot draw from a generator itself."""
    return {guid: torch.rand(shape, generator=rng, device=device) < keep
            for guid, shape, keep in plan}


def dropout(x: torch.Tensor, rate: float, ctx: FwdCtx, op: "Op") -> torch.Tensor:
    """``x`` with each element kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``, else zero (``jnp.where(mask, x / keep,
    0)`` of the JAX package); the identity outside training or at rate 0."""
    if rate <= 0.0 or not ctx.training:
        return x
    keep = 1.0 - rate
    mask = ctx.keep_mask(op, x.shape, keep, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Op:
    """Graph node: inputs -> outputs with optional weights."""

    _type: str = "Op"
    # output dims computed whole on a mesh (a window or a normalization
    # crosses them); the output is then split by the config afterwards
    unsplit_dims: Tuple[int, ...] = ()
    # the weights map the input's last dim to the output's (dense, conv,
    # embedding, attention): the input's last dim is never split
    mixes_features: bool = False
    # running statistics updated in training (``init_stats``): such an op
    # is never rematerialized
    has_running_stats: bool = False

    def __init__(self, model, inputs: Sequence[Tensor], name: Optional[str] = None):
        self.model = model
        self.guid = model._next_op_guid()
        # Reference auto-names ops "<Type>_<guid>" (src/runtime/model.cc:142-144).
        self.name = name if name else f"{self._type}_{self.guid}"
        self.inputs: List[Tensor] = list(inputs)
        self.weights: List[Parameter] = []
        self.outputs: List[Tensor] = []
        # the op whose weights this one reads (share_with), else None
        self.share_from: Optional["Op"] = None

    @property
    def param_key(self) -> str:
        """Key into the parameter tree: the owning op's name."""
        return self.share_from.name if self.share_from is not None else self.name

    @property
    def param_weights(self) -> List[Parameter]:
        """The weights this op's forward reads: its own, or its owner's."""
        return self.share_from.weights if self.share_from is not None else self.weights

    def _share(self, share_with: Optional["Op"], same) -> bool:
        """Adopt ``share_with`` (or its owner, when it shares itself) as
        this op's weight owner if given; ``same(owner)`` says whether the
        owner's weights fit this op.  Returns whether it shares."""
        if share_with is None:
            return False
        owner = share_with.share_from or share_with
        if not same(owner):
            raise ValueError(f"share_with must be a {self._type} of identical shape")
        self.share_from = owner
        return True

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

    def exchanges_on_host(self) -> bool:
        """Whether this op's forward on a mesh, under its config, exchanges
        data through ``parallel/collectives.py`` (c10d calls in autograd
        functions, which dynamo cannot trace) besides DTensor's own
        collectives: a lowered step then compiles the regions on either
        side of each exchange (``FFModel._traceable``)."""
        return False

    @property
    def draws_random(self) -> bool:
        """Whether the training forward draws from ``FwdCtx.rng``."""
        return False

    def init_stats(self, device) -> Dict[str, torch.Tensor]:
        """The op's running statistics, float32 on ``device`` (empty for an
        op that keeps none)."""
        return {}

    # -- autoregressive decoding (FFModel.generate, serving/engine.py) ------
    def init_cache(self, batch_size: int, max_len: int, dtype):
        """The op's decode cache (a dict of tensors on the model's device);
        None for a stateless op."""
        return None

    def decode(self, params, xs: List[torch.Tensor], cache, pos, ctx: FwdCtx):
        """One decode step at sequence position ``pos`` (a 0-dim or a (B,)
        int64 tensor on the device): ``xs`` carry one time step (B, 1, ...).
        Returns (ys, cache); a cache is written in place, so a captured step
        finds it where it was.  Default: the stateless forward."""
        return self.forward(params, xs, ctx), cache

    def flops_per_sample(self) -> float:
        """Analytic forward FLOPs per sample."""
        return 0.0

    # -- partitioning ------------------------------------------------------
    def constraint_pc(self) -> ParallelConfig:
        """The config that places this op's output."""
        return self.pc

    def _config_dim_bound(self, i: int) -> Optional[int]:
        """The size config dim ``i``'s degree must divide (None: no bound)."""
        return self.output.dims[i] if i < self.output.num_dims else None

    def legalize_pc(self, pc: ParallelConfig) -> ParallelConfig:
        """Clamp a config to one this op can execute: each degree must
        divide its bound, else it drops to the largest degree that does
        (the reference asserts)."""
        dims = list(pc.dims)
        changed = False
        for i, d in enumerate(dims):
            bound = self._config_dim_bound(i)
            if bound is not None and bound % d != 0:
                dims[i] = math.gcd(d, bound)
                changed = True
        if not changed:
            return pc
        npc = ParallelConfig(pc.device_type, tuple(dims), memory_types=pc.memory_types)
        return npc.with_device_ids(tuple(range(npc.num_parts())))

    def stored(self, w_name: str, value: torch.Tensor, inverse: bool = False) -> torch.Tensor:
        """Weight ``w_name`` (or its optimizer state) in the layout the op
        stores it in under its config, from the logical layout; with
        ``inverse``, back.  The identity, but for the LSTM's gated weights
        under a hidden split."""
        return value

    def check_config(self, pc: ParallelConfig) -> None:
        """Raise when the port cannot run this op under ``pc`` (a split
        the JAX package computes that the port does not yet)."""

    def compute_placements(self, machine, output_idx: int = 0) -> tuple:
        """The placements ``forward_sharded`` computes output
        ``output_idx`` under."""
        return fold(machine.spec_for_config(self.pc, self.outputs[output_idx].num_dims),
                    self.unsplit_dims)

    def input_placements(self, out_pl, i: int) -> tuple:
        """Input ``i`` split as the output is, but for dims it lacks and,
        for ops that mix features, its last dim."""
        rank = self.inputs[i].num_dims
        whole = self.output.num_dims - 1 if self.mixes_features else None
        return tuple(Replicate() if isinstance(p, Shard) and (p.dim >= rank or p.dim == whole)
                     else p for p in out_pl)

    def weight_placements(self, w: Parameter, out_pl) -> tuple:
        """Weight dim j split where output dim ``partition_dims[j]`` is
        (under the op's config: how the weight is stored, as
        ``_param_spec_tree`` of the JAX package's model.py places it).  A
        sharing op reads the owner's weight, stored under the owner's
        config, at these placements (a redistribution where they differ)."""
        return tuple(Shard(w.partition_dims.index(p.dim))
                     if isinstance(p, Shard) and p.dim in w.partition_dims else Replicate()
                     for p in out_pl)

    def local_forward(self, machine, out_pl):
        """What ``forward_sharded`` runs on the local shards: ``forward``,
        unless the op needs the mesh (a statistic over a split dim)."""
        return self.forward

    def forward_sharded(self, machine, params, xs, ctx: FwdCtx) -> List:
        """``forward`` on the local shards of DTensor inputs and weights;
        each output is a DTensor placed by ``compute_placements``."""
        out_pls = [self.compute_placements(machine, i) for i in range(len(self.outputs))]
        fwd = self.local_forward(machine, out_pls[0])
        return self._on_shards(machine, params, xs, out_pls, out_pls[0],
                               lambda p, ls: fwd(p, ls, ctx))

    def _on_shards(self, machine, params, xs, out_pls, weight_out_pl, fn) -> List:
        """``fn(params, xs)`` on this rank's shards: input ``i`` placed as
        ``input_placements(out_pls[0], i)``, each weight as
        ``weight_placements(w, weight_out_pl)``; the outputs come back as
        DTensors placed ``out_pls``."""
        weights = self.param_weights
        names = [w.name for w in weights]
        args = [(x, self.input_placements(out_pls[0], i)) for i, x in enumerate(xs)]
        args += [(params[w.name], self.weight_placements(w, weight_out_pl)) for w in weights]
        n = len(xs)

        def local(*ls):
            return fn(dict(zip(names, ls[n:])), list(ls[:n]))

        return machine.local_call(local, args, out_pls)

    # -- decoding on a mesh (FFModel._run_graph_decode when sharded) --------
    def decode_placements(self, machine, output_idx: int = 0) -> tuple:
        """The placements a decode step computes output ``output_idx``
        under: the training ones (``compute_placements``) with the sample
        dim and, on a rank-3 or higher output, the sequence dim folded to
        ``Replicate``.  A step carries one token of B rows, and B need not
        divide a degree; heads, columns, hidden parts and experts stay
        split."""
        nd = self.outputs[output_idx].num_dims
        return fold(self.compute_placements(machine, output_idx), (0, 1) if nd >= 3 else (0,))

    def _decode_on_shards(self, machine, params, xs, fn) -> List:
        """``fn(params, xs)`` on this rank's shards for a decode step: the
        inputs whole over their rows, each weight as the training forward
        holds it (no rank reads more of a weight than its training shard),
        the outputs placed by ``decode_placements``."""
        out_pls = [self.decode_placements(machine, i) for i in range(len(self.outputs))]
        return self._on_shards(machine, params, xs, out_pls, self.compute_placements(machine),
                               fn)

    def decode_sharded(self, machine, params, xs, cache, pos, ctx: FwdCtx):
        """``decode`` on a mesh: DTensor inputs and weights, DTensor outputs
        under ``decode_placements``, the cache this rank's plain tensors.
        Default, for a stateless op: its training forward on the local
        shards (``local_forward``, with the collectives it needs)."""
        fwd = self.local_forward(machine, self.decode_placements(machine))
        return self._decode_on_shards(machine, params, xs, lambda p, ls: fwd(p, ls, ctx)), cache

    # -- tiling hooks (the simulator's comm model; the reference's
    # get_output_tensor_shape / get_input_tensor_shape, model.cc:333-380) --
    @staticmethod
    def _grid_coord(pc: ParallelConfig, part_idx: int) -> Tuple[int, ...]:
        coord = []
        rem = part_idx
        for d in reversed(pc.dims):
            coord.append(rem % d)
            rem //= d
        return tuple(reversed(coord))

    def output_tile(self, pc: ParallelConfig, part_idx: int, output_idx: int = 0):
        """Per-dim (lo, hi) inclusive ranges of this part's output tile."""
        dims = self.outputs[output_idx].dims
        coord = self._grid_coord(pc, part_idx)
        out = []
        for i, size in enumerate(dims):
            deg = pc.dims[i] if i < len(pc.dims) else 1
            c = coord[i] if i < len(coord) else 0
            tile = size // deg
            out.append((c * tile, (c + 1) * tile - 1))
        return out

    def input_ranges(self, j: int, pc: ParallelConfig, part_idx: int):
        """Per-dim (lo, hi) ranges of input ``j`` this part reads: each dim
        scaled from the output tile when the ranks match, else the batch dim
        tiled and the rest read whole."""
        in_dims = self.inputs[j].dims
        out_dims = self.outputs[0].dims
        tile = self.output_tile(pc, part_idx)
        rng = []
        if len(in_dims) == len(out_dims):
            for i, isz in enumerate(in_dims):
                osz = out_dims[i]
                lo, hi = tile[i]
                if isz == osz:
                    rng.append((lo, hi))
                else:
                    rng.append((lo * isz // osz,
                                min(isz - 1, -((-(hi + 1) * isz) // osz) - 1)))
        else:
            b_lo, b_hi = tile[0]
            rng.append((b_lo * in_dims[0] // out_dims[0],
                        (b_hi + 1) * in_dims[0] // out_dims[0] - 1))
            for isz in in_dims[1:]:
                rng.append((0, isz - 1))
        return rng

    def weight_tile(self, pc: ParallelConfig, w_idx: int, part_idx: int):
        """Per-dim ranges of weight ``w_idx`` this part holds: the whole
        range on replicated dims, the part's slice on split ones."""
        w = self.param_weights[w_idx]
        coord = self._grid_coord(pc, part_idx)
        out = []
        for i, size in enumerate(w.dims):
            pd = w.partition_dims[i]
            if pd is None or pd >= len(pc.dims) or pc.dims[pd] == 1:
                out.append((0, size - 1))
            else:
                deg = pc.dims[pd]
                c = coord[pd]
                tile = size // deg
                out.append((c * tile, (c + 1) * tile - 1))
        return out

    def part_input_shapes(self, pc: ParallelConfig) -> List[Tuple[int, ...]]:
        """The shapes of the inputs one part of ``pc`` computes from."""
        return [tuple(hi - lo + 1 for lo, hi in self.input_ranges(j, pc, 0))
                for j in range(len(self.inputs))]

    def part_forward(self, pc: ParallelConfig):
        """``fn(params, xs, ctx) -> tensor``: what one part of ``pc``
        computes from inputs of ``part_input_shapes`` and its
        ``weight_tile`` weights."""
        return lambda params, xs, ctx: self.forward(params, xs, ctx)[0]

    def __repr__(self):
        ins = ",".join(str(t.dims) for t in self.inputs)
        outs = ",".join(str(t.dims) for t in self.outputs)
        return f"{self._type}({self.name}: {ins} -> {outs})"

