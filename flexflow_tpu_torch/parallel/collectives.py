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

The tensors are this rank's plain tensors (a DTensor's local shard), on
the group's device: gloo groups take CPU tensors, NCCL groups CUDA ones.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


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
