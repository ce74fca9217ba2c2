"""LayerNorm and multi-head attention (PyTorch port of
``flexflow_tpu/ops/attention.py``).

``LayerNorm`` is plain PyTorch in f32, as the JAX package's is plain jnp.
``MultiHeadAttention`` projects with ``(in, E)`` weights (cast per use, f32
accumulation inside cuBLAS under bf16), splits heads to (B, H, S, D) and
runs ``kernels/flash_attention.py``: on CUDA tensors the hand-written
forward and backward kernels, on CPU tensors their plain versions.

On a mesh, attention under ``(dp, sp, tp)`` computes on this device's
batch rows and heads: q/k/v come from the column shards of
``wq``/``wk``/``wv``, the flash kernels run on the local (b, h, s, D)
tensors, and ``wo`` takes the gathered heads column-parallel.  A sequence
split (sp > 1) of self-attention runs ring or Ulysses attention over the
ranks that split the sequence (``parallel/sequence.py``, the op's
``seq_parallel_mode``); cross-attention (Sq != Sk) splits only q's rows
and reads the whole K/V on every part, as the JAX package's does.
Attention dropout masks the heads' output before ``wo`` (``FwdCtx.rng``).

Decoding (``decode``, ``decode_paged``) is the JAX package's: plain f32
products over a static kv cache (dense ``(B, H, S, D)`` or a block pool
``(N, H, block, D)``), later positions masked.  Every write lands in place
at device-resident positions, so a decode step can be captured as a CUDA
graph (runtime/decode_graph.py).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from .base import FwdCtx, Op, dropout
from ..initializers import ConstantInitializer, DefaultWeightInitializer, ZeroInitializer
from ..kernels.flash_attention import flash_attention
from ..parallel.mesh import fold
from ..parallel.sequence import ring_rank_attention, sequence_parallel_attention


class LayerNorm(Op):
    """Normalize over the last dim with learned scale/shift, in f32."""

    _type = "LayerNorm"

    @property
    def unsplit_dims(self):
        return (self.output.num_dims - 1,)

    def __init__(self, model, input_tensor, eps: float = 1e-5,
                 elementwise_affine: bool = True, name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        self.eps = eps
        self.affine = elementwise_affine
        dims = input_tensor.dims
        self._add_output(dims, input_tensor.dtype)
        if elementwise_affine:
            feat_cfg_dim = len(dims) - 1
            self._add_weight("scale", (dims[-1],), ConstantInitializer(1.0),
                             partition_dims=(feat_cfg_dim,))
            self._add_weight("bias", (dims[-1],), ZeroInitializer(),
                             partition_dims=(feat_cfg_dim,))

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        x = xs[0]
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * params["scale"].float() + params["bias"].float()
        return [y.to(x.dtype)]

    def flops_per_sample(self):
        return 8.0 * float(math.prod(self.output.dims[1:]))


class MultiHeadAttention(Op):
    """Scaled-dot-product multi-head attention with QKV/output projections.

    query/key/value: (B, Sq, E) / (B, Sk, E) / (B, Sk, E); output
    (B, Sq, E).  ``causal`` adds the autoregressive mask and needs
    Sq == Sk (ROADMAP C2).  ``dropout`` masks the heads' output in
    training; ``seq_parallel_mode`` ("ring" or "ulysses") is how a
    sequence split runs."""

    _type = "MultiHeadAttention"
    mixes_features = True

    def __init__(self, model, query, key, value, embed_dim: int,
                 num_heads: int, causal: bool = False,
                 dropout: float = 0.0, use_bias: bool = False,
                 kernel_initializer=None, seq_parallel_mode: str = "ring",
                 name: Optional[str] = None):
        if seq_parallel_mode not in ("ring", "ulysses"):
            raise ValueError(f"seq_parallel_mode must be 'ring' or 'ulysses', got "
                             f"{seq_parallel_mode!r}")
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must divide by num_heads")
        if causal and query.dims[1] != key.dims[1]:
            raise ValueError("causal attention needs Sq == Sk (ROADMAP C2), got "
                             f"{query.dims[1]} and {key.dims[1]}")
        super().__init__(model, [query, key, value], name)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.dropout = float(dropout)
        self.use_bias = use_bias
        self.seq_parallel_mode = seq_parallel_mode
        b, sq, _ = query.dims
        self._add_output((b, sq, embed_dim), query.dtype)
        init = kernel_initializer or DefaultWeightInitializer()
        for wname, in_dim in (("wq", query.dims[-1]), ("wk", key.dims[-1]),
                              ("wv", value.dims[-1])):
            self._add_weight(wname, (in_dim, embed_dim), init, partition_dims=(None, 2))
        self._add_weight("wo", (embed_dim, embed_dim), init, partition_dims=(None, 2))
        if use_bias:
            for bname in ("bq", "bk", "bv", "bo"):
                self._add_weight(bname, (embed_dim,), ZeroInitializer(), partition_dims=(2,))

    def _proj(self, params, x, w, b):
        y = torch.matmul(x, params[w].to(x.dtype))
        if self.use_bias:
            y = y + params[b].to(y.dtype)
        return y

    def _config_dim_bound(self, i: int):
        """The feature split (dim 2) splits the heads: its degree must
        divide num_heads, so that each part holds whole heads."""
        if i == 2:
            return self.num_heads
        return super()._config_dim_bound(i)

    @property
    def draws_random(self) -> bool:
        return self.dropout > 0.0

    def _degrees(self, pc=None):
        """The config's (batch, sequence, heads) degrees."""
        pc = pc if pc is not None else getattr(self, "pc", None)
        dims = list(pc.dims) if pc is not None else []
        return (dims + [1, 1, 1])[:3]

    def check_config(self, pc) -> None:
        """Ulysses re-shards the sequence over the heads each part holds:
        a sequence split of a Ulysses op needs them divisible by it."""
        _, sp, tp = self._degrees(pc)
        if (sp > 1 and self.seq_parallel_mode == "ulysses"
                and self.inputs[0].dims[1] == self.inputs[1].dims[1]
                and (self.num_heads // tp) % sp):
            raise ValueError(
                f"{self.name}: Ulysses attention under sequence degree {sp} and head degree "
                f"{tp} needs the {self.num_heads} / {tp} heads of a part divisible by {sp}")

    def _attend(self, params, q_in, k_in, v_in, attention=None):
        """The q/k/v projections and attention: (B, S, h*D) for the h heads
        whose columns ``params`` holds.  ``attention(qh, kh, vh)`` computes
        the heads' output from (B, h, S, D) tensors; by default the flash
        kernels over what this device holds."""
        D = self.head_dim

        def split(t):  # (B, S, h*D) -> (B, h, S, D), contiguous for the kernels
            return t.reshape(t.shape[0], t.shape[1], -1, D).transpose(1, 2).contiguous()

        qh = split(self._proj(params, q_in, "wq", "bq"))
        kh = split(self._proj(params, k_in, "wk", "bk"))
        vh = split(self._proj(params, v_in, "wv", "bv"))
        if attention is None:
            oh = flash_attention(qh, kh, vh, causal=self.causal, scale=1.0 / math.sqrt(D))
        else:
            oh = attention(qh, kh, vh)
        return oh.transpose(1, 2).reshape(oh.shape[0], oh.shape[2], -1)

    def _out(self, params, heads, ctx: FwdCtx):
        """Dropout over the heads' output (training only), then ``wo``."""
        return self._proj(params, dropout(heads, self.dropout, ctx, self), "wo", "bo")

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        return [self._out(params, self._attend(params, *xs), ctx)]

    def exchanges_on_host(self) -> bool:
        return self._degrees()[1] > 1  # ring or Ulysses over a split sequence

    def forward_sharded(self, machine, params, xs, ctx: FwdCtx):
        return self._sharded_forward(machine, params, xs, ctx, self.compute_placements(machine),
                                     self._degrees()[1] > 1 and machine.num_devices > 1)

    def _local_weights(self, params, names, out_pl):
        """The weights ``names`` the op has: their names and (DTensor,
        placements) pairs under ``out_pl``."""
        ws = [w for w in self.weights if w.name in names]
        return [w.name for w in ws], [(params[w.name], self.weight_placements(w, out_pl))
                                      for w in ws]

    def _sharded_forward(self, machine, params, xs, ctx: FwdCtx, out_pl, seq_split: bool):
        """The forward on local shards, its output placed ``out_pl``; with
        ``seq_split`` a split sequence runs ring or Ulysses attention."""
        in_pl = self.input_placements(out_pl, 0)
        kv_pl, attention = in_pl, None
        degrees = self._degrees()
        if seq_split:
            if self.inputs[0].dims[1] == self.inputs[1].dims[1]:
                def attention(qh, kh, vh):
                    return sequence_parallel_attention(
                        qh, kh, vh, machine, degrees, causal=self.causal,
                        scale=1.0 / math.sqrt(self.head_dim), mode=self.seq_parallel_mode)
            else:  # cross-attention: each part's q rows against the whole K/V
                kv_pl = fold(in_pl, (1,))
        names, wargs = self._local_weights(params, ("wq", "wk", "wv", "bq", "bk", "bv"), out_pl)
        heads = machine.local_call(
            lambda q, k, v, *ws: self._attend(dict(zip(names, ws)), q, k, v, attention),
            [(xs[0], in_pl), (xs[1], kv_pl), (xs[2], kv_pl)] + wargs, out_pl)
        return [self._sharded_out(machine, params, heads, ctx, out_pl)]

    def _sharded_out(self, machine, params, heads, ctx: FwdCtx, out_pl):
        """``wo`` over the gathered heads, column-parallel."""
        names_o, wargs_o = self._local_weights(params, ("wo", "bo"), out_pl)
        return machine.local_call(
            lambda o, *ws: self._out(dict(zip(names_o, ws)), o, ctx),
            [(heads, self.input_placements(out_pl, 0))] + wargs_o, out_pl)

    def flops_per_sample(self):
        _, sq, e = self.output.dims
        sk = self.inputs[1].dims[1]
        proj = 2.0 * sq * e * e * 4
        attn = 2.0 * self.num_heads * sq * sk * self.head_dim * 2
        return proj + attn

    def input_ranges(self, j, pc, part_idx):
        # K/V are read along the whole sequence by every part
        rng = super().input_ranges(j, pc, part_idx)
        if j in (1, 2):
            rng[1] = (0, self.inputs[j].dims[1] - 1)
        return rng

    def part_input_shapes(self, pc):
        # the projections read every feature of their inputs
        return [shape[:-1] + (t.dims[-1],)
                for shape, t in zip(super().part_input_shapes(pc), self.inputs)]

    def part_forward(self, pc):
        """One part: the q/k/v projections and attention of its heads, then
        the output projection of its columns over the gathered heads of
        every part (under a head split a copy stands in for the gather).
        Under a sequence split of self-attention, its q block attends the
        K/V blocks as the ring's last rank does, block by block with the
        merges (``ring_rank_attention``), which does the most work of a
        causal ring; a Ulysses part does as much work as a ring part."""
        _, sp, k = self._degrees(pc)
        if k == 1 and sp == 1:
            return super().part_forward(pc)
        attention = None
        if sp > 1 and self.inputs[0].dims[1] == self.inputs[1].dims[1]:
            def attention(qh, kh, vh):
                return ring_rank_attention(qh, kh, vh, sp - 1, sp, causal=self.causal,
                                           scale=1.0 / math.sqrt(self.head_dim))

        def fwd(params, xs, ctx):
            heads = self._attend(params, *xs, attention)
            return self._out(params, heads.repeat(1, 1, k) if k > 1 else heads, ctx)
        return fwd

    # -- kv-cached decoding (the JAX package's ops/attention.py:161-275) -----
    def _cache_heads(self) -> int:
        """The heads whose k/v this rank caches: all of them, or on a mesh
        this rank's part of the head split (``decode_placements``)."""
        m = self.model
        if not m._sharded:
            return self.num_heads
        _, sizes, _ = m.machine.split_of(self.decode_placements(m.machine), 2)
        return self.num_heads // math.prod(sizes)

    def init_cache(self, batch_size: int, max_len: int, dtype):
        shp = (batch_size, self._cache_heads(), max_len, self.head_dim)
        dev = self.model.device
        return {"k": torch.zeros(shp, dtype=dtype, device=dev),
                "v": torch.zeros(shp, dtype=dtype, device=dev)}

    def init_paged_cache(self, num_blocks: int, block_size: int, dtype):
        """Block-pool k/v shared by every slot: the block id indexes dim 0.
        Block 0 is the garbage sink (serving/kvpool.py): idle lanes write
        and read it, masked."""
        return self.init_cache(num_blocks, block_size, dtype)

    def _decode_heads(self, params, xs, what: str):
        """This step's q, k, v as (B, h, 1, D) for the heads whose columns
        ``params`` holds; refuses what has no cache semantics (a non-causal
        single-token self-attention)."""
        q_in, k_in, v_in = xs
        if not self.causal:
            raise ValueError(f"{what}: op {self.name!r} is non-causal single-token "
                             "self-attention, which is not decodable")
        b = q_in.shape[0]

        def split(t):
            return t.reshape(b, 1, -1, self.head_dim).transpose(1, 2)

        return (split(self._proj(params, q_in, "wq", "bq")),
                split(self._proj(params, k_in, "wk", "bk")),
                split(self._proj(params, v_in, "wv", "bv")))

    def _attend_cached(self, qh, keys, values, pos_v, dtype):
        """q over a (B, h, L, D) cache in f32, positions past each row's
        ``pos`` masked with -1e30 (their softmax weights are exactly 0): the
        heads' output (B, 1, h * D), before ``wo``.  ``keys``/``values`` are
        made contiguous, so a window of the dense cache and a gathered
        paged window of the same length run the same products."""
        b, _, L, _ = keys.shape
        scale = 1.0 / math.sqrt(self.head_dim)
        scores = torch.matmul(qh.float(), keys.contiguous().float().transpose(-1, -2)) * scale
        valid = torch.arange(L, device=keys.device)[None, None, None, :] \
            <= pos_v[:, None, None, None]
        probs = torch.softmax(torch.where(valid, scores, -1e30), dim=-1)
        out = torch.matmul(probs, values.contiguous().float()).to(dtype)
        return out.transpose(1, 2).reshape(b, 1, -1)

    def _cached_heads(self, params, xs, cache, pos, tables):
        """One token's heads over the cache: this step's k/v written at
        ``pos`` (a 0-dim tensor, or one position per row) into the dense
        cache, or with block ``tables`` (B, W) into block ``tables[row, pos
        // block_size]`` of the pool, whose W blocks are then gathered per
        row in table (= position) order; later positions masked."""
        qh, kh, vh = self._decode_heads(params, xs, "generate" if tables is None
                                        else "decode_paged")
        q_in = xs[0]
        b = q_in.shape[0]
        pos_v = pos.expand(b) if pos.dim() == 0 else pos
        rows = torch.arange(b, device=q_in.device)
        if tables is None:
            # index_put_ at device positions: nothing is read back to the host
            cache["k"][rows, :, pos_v, :] = kh[:, :, 0, :].to(cache["k"].dtype)
            cache["v"][rows, :, pos_v, :] = vh[:, :, 0, :].to(cache["v"].dtype)
            return self._attend_cached(qh, cache["k"], cache["v"], pos_v, q_in.dtype)
        _, h, bs, d = cache["k"].shape
        w = tables.shape[1]
        bidx, roff = tables[rows, pos_v // bs], pos_v % bs
        cache["k"][bidx, :, roff, :] = kh[:, :, 0, :].to(cache["k"].dtype)
        cache["v"][bidx, :, roff, :] = vh[:, :, 0, :].to(cache["v"].dtype)

        def window(pool):  # (B, W, h, bs, D) -> (B, h, W * bs, D)
            return pool[tables].transpose(1, 2).reshape(b, h, w * bs, d)

        return self._attend_cached(qh, window(cache["k"]), window(cache["v"]), pos_v,
                                   q_in.dtype)

    @staticmethod
    def _single_token(xs) -> bool:
        return xs[0].shape[1] == 1 and xs[1].shape[1] == 1

    def decode(self, params, xs, cache, pos, ctx: FwdCtx):
        """kv-cached single-token attention: write this step's k/v at
        ``pos`` (a 0-dim tensor, or one position per row), then attend over
        the whole static cache with later positions masked.  A full-sequence
        input (an encoder re-run, or cross-attention over full k/v) is
        stateless and runs ``forward``."""
        if not self._single_token(xs):
            return self.forward(params, xs, ctx), cache
        heads = self._cached_heads(params, xs, cache, pos, None)
        return [self._proj(params, heads, "wo", "bo")], cache

    def decode_paged(self, params, xs, cache, pos, tables, ctx: FwdCtx):
        """Single-token attention over a paged cache (``_cached_heads``).

        ``tables``: (B, W) int64 block ids; ``pos``: (B,) or 0-dim."""
        if not self._single_token(xs):
            raise ValueError(f"decode_paged: op {self.name!r} got a full-sequence input; "
                             "paged decode is single-token only")
        heads = self._cached_heads(params, xs, cache, pos, tables)
        return [self._proj(params, heads, "wo", "bo")], cache

    def decode_sharded(self, machine, params, xs, cache, pos, ctx: FwdCtx):
        """``decode`` on a mesh: this rank's heads, their k/v in its cache
        (B, h, S, D), then ``wo`` over the gathered heads as the training
        forward runs it.  A sequence split folds away (a one-token step
        attends the whole cache); a full-sequence input (cross-attention
        over a static encoder output) runs the forward with its rows whole."""
        return self._decode_sharded(machine, params, xs, cache, pos, None, ctx)

    def decode_paged_sharded(self, machine, params, xs, cache, pos, tables, ctx: FwdCtx):
        """``decode_paged`` on a mesh: the pool (N, h, block, D) holds this
        rank's heads."""
        if not self._single_token(xs):
            raise ValueError(f"decode_paged: op {self.name!r} got a full-sequence input; "
                             "paged decode is single-token only")
        return self._decode_sharded(machine, params, xs, cache, pos, tables, ctx)

    def _decode_sharded(self, machine, params, xs, cache, pos, tables, ctx: FwdCtx):
        out_pl = self.decode_placements(machine)
        if not self._single_token(xs):
            return self._sharded_forward(machine, params, xs, ctx, out_pl, False), cache
        in_pl = self.input_placements(out_pl, 0)
        names, wargs = self._local_weights(params, ("wq", "wk", "wv", "bq", "bk", "bv"), out_pl)
        heads = machine.local_call(
            lambda q, k, v, *ws: self._cached_heads(dict(zip(names, ws)), [q, k, v], cache,
                                                    pos, tables),
            [(xs[0], in_pl), (xs[1], in_pl), (xs[2], in_pl)] + wargs, out_pl)
        return [self._sharded_out(machine, params, heads, ctx, out_pl)], cache
