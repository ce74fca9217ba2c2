"""Differentiable collectives over a ``torch.distributed`` process group.

What GSPMD and ``shard_map`` give the JAX package for free (``ppermute``,
``all_to_all`` and ``psum`` carry transpose rules), the port writes as
``torch.autograd.Function``s around the c10d calls:

- ``ring_shift``: every rank sends its tensor to the next rank of the
  group and receives the previous rank's, the send and the receive in one
  ``batch_isend_irecv`` so that the ring cannot deadlock; the backward
  sends the gradient the other way round.
- ``all_to_all``: chunk ``j`` of dim 0 goes to rank ``j`` and chunk ``j``
  of the result came from rank ``j`` (``all_to_all_single`` over equal
  chunks), which is its own adjoint.
- ``all_reduce_sum``: the sum over the group on every rank; its backward
  sums the gradients, as the loss is the sum of every rank's part.
- ``all_gather_dim``: the group's parts concatenated along a dim, on
  every rank; its backward is the reduce-scatter of the gradient (each
  rank gets the sum of every rank's gradient of its own part).
- ``halo_exchange``: a part's rows along a dim rebuilt from the parts that
  own them (the rows an output tile's window reads, halo included), in one
  ``batch_isend_irecv``; its backward sends each received row's gradient
  back to its owner and adds it into the owner's rows.

``broadcast_plan`` is no autograd function: it hands a host-side plan (a
fixed-layout int64 CPU tensor) from a leader rank to the others over a
gloo group, waiting a bounded time (the serving engine's lockstep on a
mesh, serving/engine.py).

The tensors are this rank's plain tensors (a DTensor's local shard), on
the group's device: gloo groups take CPU tensors, NCCL groups CUDA ones.
``all_gather_dim`` and ``halo_exchange`` also take ``group=None`` with a
list of every part's tensor, in part order: the parts then run in
lockstep in one process (as ``parallel/pipeline.gpipe(group=None)``), the
exchange is slicing and concatenation, and autograd carries the backward.
"""

from __future__ import annotations

import datetime
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

# the single-tensor collectives under their current names (older torch
# has only the *_tensor ones)
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def group_ranks(group) -> List[int]:
    """The global ranks of ``group``, in group-rank order."""
    return dist.get_process_group_ranks(group)


def _shift(x: torch.Tensor, group, hops: int) -> torch.Tensor:
    ranks = group_ranks(group)
    n, me = len(ranks), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, ranks[(me + hops) % n], group),
        dist.P2POp(dist.irecv, out, ranks[(me - hops) % n], group)])
    for r in reqs:
        r.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """The previous rank's ``x`` (rank ``r`` receives rank ``r - 1``'s,
    modulo the group size); differentiable."""
    return _RingShift.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of shape ``(n, ...)`` for a group of ``n`` ranks: result chunk
    ``j`` is rank ``j``'s chunk for this rank; differentiable."""
    if x.shape[0] != dist.get_world_size(group):
        raise ValueError(f"all_to_all needs dim 0 of {tuple(x.shape)} to be the group size "
                         f"{dist.get_world_size(group)}")
    return _AllToAll.apply(x, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, on every rank; differentiable."""
    return _AllReduceSum.apply(x, group)


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        front = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * front.shape[0],) + tuple(front.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _all_gather_single(out, front, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        front = g.movedim(ctx.dim, 0).contiguous()
        out = torch.empty((front.shape[0] // n,) + tuple(front.shape[1:]),
                          dtype=g.dtype, device=g.device)
        _reduce_scatter_single(out, front, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def all_gather_dim(x, dim: int, group):
    """The parts of ``x`` over ``group`` concatenated along ``dim``, in
    group-rank order, on every rank (equal parts); differentiable.  With
    ``group=None``, ``x`` is the list of every part and the result is
    their concatenation."""
    if group is None:
        return torch.cat(list(x), dim)
    return _AllGatherDim.apply(x, dim, group)


Ranges = Sequence[Tuple[int, int]]


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    """The inclusive range both ``a`` and ``b`` cover (empty: hi < lo)."""
    return max(a[0], b[0]), min(a[1], b[1])


def halo_plan(need: Ranges, owned: Ranges) -> List[List[Tuple[int, int]]]:
    """``plan[dst][src]``: the inclusive global rows part ``dst`` needs
    that part ``src`` owns (hi < lo where there are none).  ``owned`` must
    tile the dim in part order and each ``need`` be one contiguous range,
    so a part's pieces, taken in source order, are its rows in order."""
    return [[_overlap(n, o) for o in owned] for n in need]


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, need, owned, group):
        ranks = dist.get_process_group_ranks(group)
        me = dist.get_rank(group)
        plan = halo_plan(need, owned)
        ctx.dim, ctx.group, ctx.plan, ctx.me, ctx.ranks = dim, group, plan, me, ranks
        ctx.own_lo, ctx.rows = owned[me][0], x.shape[dim]
        pieces, ops = [], []
        for src, (lo, hi) in enumerate(plan[me]):
            if hi < lo:
                continue
            if src == me:
                pieces.append(x.narrow(dim, lo - owned[me][0], hi - lo + 1))
                continue
            shape = list(x.shape)
            shape[dim] = hi - lo + 1
            buf = torch.empty(shape, dtype=x.dtype, device=x.device)
            ops.append(dist.P2POp(dist.irecv, buf, ranks[src], group))
            pieces.append(buf)
        for dst, row in enumerate(plan):
            lo, hi = row[me]
            if dst != me and hi >= lo:
                piece = x.narrow(dim, lo - owned[me][0], hi - lo + 1).contiguous()
                ops.append(dist.P2POp(dist.isend, piece, ranks[dst], group))
        if ops:
            for r in dist.batch_isend_irecv(ops):
                r.wait()
        return torch.cat(pieces, dim)

    @staticmethod
    def backward(ctx, g):
        dim, plan, me, ranks, group = ctx.dim, ctx.plan, ctx.me, ctx.ranks, ctx.group
        shape = list(g.shape)
        shape[dim] = ctx.rows
        gx = torch.zeros(shape, dtype=g.dtype, device=g.device)
        ops, back, at = [], [], 0
        for src, (lo, hi) in enumerate(plan[me]):
            if hi < lo:
                continue
            piece = g.narrow(dim, at, hi - lo + 1)
            at += hi - lo + 1
            if src == me:
                gx.narrow(dim, lo - ctx.own_lo, hi - lo + 1).add_(piece)
            else:
                ops.append(dist.P2POp(dist.isend, piece.contiguous(), ranks[src], group))
        for dst, row in enumerate(plan):
            lo, hi = row[me]
            if dst != me and hi >= lo:
                shape[dim] = hi - lo + 1
                buf = torch.empty(shape, dtype=g.dtype, device=g.device)
                ops.append(dist.P2POp(dist.irecv, buf, ranks[dst], group))
                back.append((lo, hi, buf))
        if ops:
            for r in dist.batch_isend_irecv(ops):
                r.wait()
        for lo, hi, buf in back:
            gx.narrow(dim, lo - ctx.own_lo, hi - lo + 1).add_(buf)
        return gx, None, None, None, None


def halo_exchange(x, dim: int, need: Ranges, owned: Ranges, group):
    """This part's rows ``need[me]`` along ``dim`` (inclusive global
    bounds), made of its own rows and those the other parts of ``group``
    own; ``owned[p]`` is part ``p``'s inclusive range, and ``x`` holds
    this part's.  Every part sends what each other part needs of its rows
    and receives what it needs, in one ``batch_isend_irecv``, whether or
    not the two are neighbours; differentiable.  With ``group=None``,
    ``x`` is the list of every part and the result is the list of every
    part's rows."""
    if group is None:
        plan = halo_plan(need, owned)
        return [torch.cat([x[src].narrow(dim, lo - owned[src][0], hi - lo + 1)
                           for src, (lo, hi) in enumerate(row) if hi >= lo], dim)
                for row in plan]
    return _HaloExchange.apply(x, dim, [tuple(r) for r in need],
                               [tuple(r) for r in owned], group)


def gather_rows_(w: torch.Tensor, lo: int, hi: int, groups) -> None:
    """Every rank's rows ``lo:hi`` of ``w`` (dim 0, equal row slices)
    gathered into ``w`` in place: after ZeRO-1's update of each rank's row
    slice, the whole weight again.  ``groups`` are the process groups of
    the mesh dims the rows are split over, innermost first (a row block of
    the outer dims is split over the inner ones): one all-gather each, in
    group-rank order.  Not differentiable (an optimizer step)."""
    for group in groups:
        block = (hi - lo) * dist.get_world_size(group)
        first = lo // block * block
        _all_gather_single(w[first:first + block], w[lo:hi].clone(), group=group)
        lo, hi = first, first + block


def broadcast_plan(plan: torch.Tensor, src: int, group, timeout_s: float) -> None:
    """``plan`` (an int64 CPU tensor of a layout every rank knows) from
    global rank ``src`` to every rank of the gloo ``group``, in place: no
    pickling and no device round trip.  Raises (``RuntimeError``) when it
    has not completed within ``timeout_s`` seconds: a leader that stopped
    sending, or a rank that left."""
    work = dist.broadcast(plan, src, group=group, async_op=True)
    work.wait(timeout=datetime.timedelta(seconds=timeout_s))
