"""Sequence parallelism: ring attention and Ulysses all-to-all (PyTorch
port of ``flexflow_tpu/parallel/sequence.py``).

When a MultiHeadAttention config splits the sequence (dim 1) over a group
of ranks, each rank holds the q/k/v rows of its sequence block, and
attention runs as

- **ring attention**: the K/V blocks rotate one hop a step round the group
  (``collectives.ring_shift``: one ``batch_isend_irecv`` of the send and
  the receive, NCCL peer to peer on the card), and each step folds the
  local q block's attention against the block it holds into a running
  (out, logsumexp) pair; memory stays O(S_local^2) while the attention
  spans the whole sequence;
- **Ulysses**: an ``all_to_all`` re-shards sequence to heads, attention
  runs over the whole sequence on H / n heads, and a second one re-shards
  back; it needs the heads divisible by the group size.

Each block's attention is the flash kernels' (``kernels/flash_attention.py``:
K3 forward, K4/K5 backward; their plain versions on CPU tensors).  The
ring merges the blocks through the lse K3 returns, so its gradient reaches
K4/K5 as their ``g_lse`` term, which the JAX package's flash VJP drops
(ROADMAP C1): a ring gradient is held against ``mha_reference`` autodiff.
``use_flash=False`` runs ``blockwise_attention`` instead, the JAX package's
masked, offset path.  Rows that saw no keys carry an lse of at most
``NEG_INF / 2`` and weigh nothing in a merge.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..kernels.flash_attention import NEG_INF, flash_attention
from .collectives import all_to_all, ring_shift

_EMPTY_THRESH = NEG_INF / 2  # an lse below this means "the row saw no keys yet"


def _merge_partials(o1, lse1, o2, lse2):
    """Fold two normalized blockwise-softmax partials (out, lse) into one:
    a logsumexp-weighted average, in float32.  A row with
    lse <= NEG_INF / 2 saw no keys and weighs 0."""
    e1 = (lse1 > _EMPTY_THRESH).float()
    e2 = (lse2 > _EMPTY_THRESH).float()
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(m <= _EMPTY_THRESH, torch.zeros_like(m), m)
    a1 = e1 * torch.exp(torch.clamp(lse1 - m_safe, max=0.0))
    a2 = e2 * torch.exp(torch.clamp(lse2 - m_safe, max=0.0))
    denom = a1 + a2
    empty = denom == 0.0
    denom_safe = torch.where(empty, torch.ones_like(denom), denom)
    o = (o1 * a1[..., None] + o2 * a2[..., None]) / denom_safe[..., None]
    lse = torch.where(empty, torch.full_like(m, NEG_INF), m_safe + torch.log(denom_safe))
    return o, lse


def blockwise_attention(q, k, v, *, scale: Optional[float] = None, causal: bool = False,
                        q_offset: int = 0, k_offset: int = 0):
    """Attention of one (q block, k block) pair in float32: (normalized out
    in q's dtype, lse).  The offsets are the blocks' first sequence
    positions, so a causal mask holds across blocks."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        q_pos = q_offset + torch.arange(s.shape[-2], device=s.device)
        k_pos = k_offset + torch.arange(s.shape[-1], device=s.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    m_safe = torch.where(m <= _EMPTY_THRESH, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None])
    if causal:
        p = torch.where(s <= _EMPTY_THRESH, torch.zeros_like(p), p)
    l = p.sum(-1)
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    out = torch.matmul(p, v.float()) / l_safe[..., None]
    lse = torch.where(empty, torch.full_like(l, NEG_INF), m_safe + torch.log(l_safe))
    return out.to(q.dtype), lse


def ring_block_attention(q, k, v, idx: int, step: int, n: int, *, causal: bool,
                         scale: float, use_flash: bool = True):
    """The attention of ring rank ``idx``'s q block against the K/V block
    it holds at ``step``, which came from rank ``(idx - step) mod n``:
    (out, float32 lse).  Causal: the diagonal block (step 0) is a causal
    K3, an earlier block (``idx >= step``) a full one, and a later block is
    masked whole: nothing is launched, and the result is zeros with an lse
    of NEG_INF."""
    if not use_flash:
        src = (idx - step) % n
        s_loc = q.shape[2]
        return blockwise_attention(q, k, v, scale=scale, causal=causal,
                                   q_offset=idx * s_loc, k_offset=src * s_loc)
    if causal and step > 0 and idx < step:
        return (torch.zeros_like(q),
                torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=q.device))
    return flash_attention(q, k, v, scale=scale, causal=causal and step == 0, return_lse=True)


class _Tie(torch.autograd.Function):
    """``o`` unchanged, with ``kv`` as an input whose gradient is zero: it
    puts every rotation on the path to the loss, so that each rank runs
    every rotation's backward (and its exchange) even where a causal ring
    used no block after some step."""

    @staticmethod
    def forward(ctx, o, kv):
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ring_attention(q, k, v, group, *, causal: bool = False, scale: Optional[float] = None,
                   use_flash: bool = True):
    """Ring attention over the sequence blocks of ``group``'s ranks.

    q, k, v: (B, H, S_local, D), this rank's block of a sequence split in
    group-rank order.  Step 0 attends the local block; each later step
    rotates K/V one hop (this rank receives the previous rank's block) and
    merges.  Equal to attention over the gathered sequence; the result is
    in q's dtype, the merges in float32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    o, lse = ring_block_attention(q, k, v, idx, 0, n, causal=causal, scale=scale,
                                  use_flash=use_flash)
    o = o.float()
    kv = torch.stack([k, v])  # one message a hop; each half stays contiguous
    for step in range(1, n):
        kv = ring_shift(kv, group)
        o_s, lse_s = ring_block_attention(q, kv[0], kv[1], idx, step, n, causal=causal,
                                          scale=scale, use_flash=use_flash)
        o, lse = _merge_partials(o, lse, o_s, lse_s)
    if n > 1:
        o = _Tie.apply(o, kv)
    return o.to(q.dtype)


def _seq_to_heads(x, group):
    """(B, H, S_local, D) sequence blocks -> (B, H / n, S, D) head blocks."""
    n = dist.get_world_size(group)
    b, h, s, d = x.shape
    y = all_to_all(x.reshape(b, n, h // n, s, d).transpose(0, 1), group)
    return y.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


def _heads_to_seq(x, group):
    """(B, H / n, S, D) head blocks -> (B, H, S_local, D) sequence blocks."""
    n = dist.get_world_size(group)
    b, h, s, d = x.shape
    y = all_to_all(x.reshape(b, h, n, s // n, d).permute(2, 0, 1, 3, 4), group)
    return y.transpose(0, 1).reshape(b, n * h, s // n, d)


def ulysses_attention(q, k, v, group, *, causal: bool = False,
                      scale: Optional[float] = None, use_flash: bool = True):
    """DeepSpeed-Ulysses sequence parallelism: q, k, v (B, H, S_local, D)
    are re-sharded to (B, H / n, S, D), attention runs over the whole
    sequence, and the result is re-sharded back.  H must divide by n."""
    n = dist.get_world_size(group)
    if q.shape[1] % n:
        raise ValueError(f"Ulysses attention needs the {q.shape[1]} heads this rank holds "
                         f"to divide by the sequence group's {n} ranks")
    qh, kh, vh = (_seq_to_heads(t, group).contiguous() for t in (q, k, v))
    if use_flash:
        oh = flash_attention(qh, kh, vh, scale=scale, causal=causal)
    else:
        oh, _ = blockwise_attention(qh, kh, vh, scale=scale, causal=causal)
    return _heads_to_seq(oh, group).contiguous()


def sequence_parallel_attention(q, k, v, machine, degrees: Sequence[int], *,
                                causal: bool = False, scale: Optional[float] = None,
                                mode: str = "ring", use_flash: bool = True):
    """Ring or Ulysses attention on this rank's shards (B_local, H_local,
    S_local, D) of an attention op whose config has per-dim ``degrees``
    (batch, sequence, heads) on ``machine``'s mesh.  The sequence group is
    the mesh dims ``axes_for_degrees`` gives config dim 1, several of them
    acting as one flattened ring in row-major order.  This is the entry
    ``MultiHeadAttention.forward_sharded`` calls when its config splits
    the sequence."""
    degrees = (list(degrees) + [1, 1, 1])[:3]
    group = machine.group(machine.axes_for_degrees(degrees)[1])
    if mode == "ring":
        fn = ring_attention
    elif mode == "ulysses":
        fn = ulysses_attention
    else:
        raise ValueError(f"unknown sequence-parallel mode {mode!r} (expected 'ring' or "
                         "'ulysses')")
    return fn(q, k, v, group, causal=causal, scale=scale, use_flash=use_flash)


def ring_rank_attention(q, k, v, idx: int, n: int, *, causal: bool = False,
                        scale: Optional[float] = None, use_flash: bool = True):
    """What ring rank ``idx`` of ``n`` computes, with every K/V block at
    hand: q (B, H, S / n, D) against k, v (B, H, S, D) cut into ``n``
    blocks, visited in the ring's order and merged as the ring merges.
    The cost model times a sequence part with it (rank ``n - 1`` of a
    causal ring does the most work)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ks, vs = k.chunk(n, dim=2), v.chunk(n, dim=2)
    o = lse = None
    for step in range(n):
        src = (idx - step) % n
        o_s, lse_s = ring_block_attention(q, ks[src].contiguous(), vs[src].contiguous(), idx,
                                          step, n, causal=causal, scale=scale,
                                          use_flash=use_flash)
        o, lse = (o_s.float(), lse_s) if o is None else _merge_partials(o, lse, o_s, lse_s)
    return o.to(q.dtype)
