"""LayerNorm and multi-head attention (PyTorch port of
``flexflow_tpu/ops/attention.py``).

``LayerNorm`` is plain PyTorch in f32, as the JAX package's is plain jnp.
``MultiHeadAttention`` projects with ``(in, E)`` weights (cast per use, f32
accumulation inside cuBLAS under bf16), splits heads to (B, H, S, D) and
runs ``kernels/flash_attention.py``: on CUDA tensors the hand-written
forward and backward kernels, on CPU tensors their plain versions.

On a mesh, attention under ``(dp, 1, tp)`` computes on this device's batch
rows and heads: q/k/v come from the column shards of ``wq``/``wk``/``wv``,
the flash kernels run on the local (b, h, S, D) tensors, and ``wo`` takes
the gathered heads column-parallel.  Sequence parallelism (ring,
Ulysses; ROADMAP A7) and attention dropout are not ported yet and raise.

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

from .base import FwdCtx, Op
from ..initializers import ConstantInitializer, DefaultWeightInitializer, ZeroInitializer
from ..kernels.flash_attention import flash_attention


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
    Sq == Sk (ROADMAP C2)."""

    _type = "MultiHeadAttention"
    mixes_features = True

    def __init__(self, model, query, key, value, embed_dim: int,
                 num_heads: int, causal: bool = False,
                 dropout: float = 0.0, use_bias: bool = False,
                 kernel_initializer=None, seq_parallel_mode: str = "ring",
                 name: Optional[str] = None):
        if dropout > 0.0:
            raise NotImplementedError("attention dropout is not ported yet (ROADMAP A2)")
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
        self.use_bias = use_bias
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

    def _refuse_sequence_split(self) -> None:
        pc = getattr(self, "pc", None)
        if pc is not None and len(pc.dims) > 1 and pc.dims[1] > 1:
            raise NotImplementedError("sequence-parallel attention (ring, Ulysses) is not "
                                      "ported yet (ROADMAP A7)")

    def _attend(self, params, q_in, k_in, v_in):
        """The q/k/v projections and flash attention: (B, S, h*D) for the
        h heads whose columns ``params`` holds."""
        D = self.head_dim

        def split(t):  # (B, S, h*D) -> (B, h, S, D), contiguous for the kernels
            return t.reshape(t.shape[0], t.shape[1], -1, D).transpose(1, 2).contiguous()

        qh = split(self._proj(params, q_in, "wq", "bq"))
        kh = split(self._proj(params, k_in, "wk", "bk"))
        vh = split(self._proj(params, v_in, "wv", "bv"))
        oh = flash_attention(qh, kh, vh, causal=self.causal, scale=1.0 / math.sqrt(D))
        return oh.transpose(1, 2).reshape(oh.shape[0], oh.shape[2], -1)

    def forward(self, params, xs: List[torch.Tensor], ctx: FwdCtx):
        self._refuse_sequence_split()
        return [self._proj(params, self._attend(params, *xs), "wo", "bo")]

    def forward_sharded(self, machine, params, xs, ctx: FwdCtx):
        self._refuse_sequence_split()
        out_pl = self.compute_placements(machine)
        in_pl = self.input_placements(out_pl, 0)

        def local_weights(names):
            ws = [w for w in self.weights if w.name in names]
            return [w.name for w in ws], [(params[w.name], self.weight_placements(w, out_pl))
                                          for w in ws]

        names, wargs = local_weights(("wq", "wk", "wv", "bq", "bk", "bv"))
        heads = machine.local_call(
            lambda q, k, v, *ws: self._attend(dict(zip(names, ws)), q, k, v),
            [(x, in_pl) for x in xs] + wargs, out_pl)
        names_o, wargs_o = local_weights(("wo", "bo"))
        return [machine.local_call(
            lambda o, *ws: self._proj(dict(zip(names_o, ws)), o, "wo", "bo"),
            [(heads, in_pl)] + wargs_o, out_pl)]

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
        """One part of a head split: the q/k/v projections and attention of
        its heads, then the output projection of its columns over the
        gathered heads of every part (a copy stands in for the gather)."""
        k = pc.dims[2] if len(pc.dims) > 2 else 1
        if k == 1:
            return super().part_forward(pc)

        def fwd(params, xs, ctx):
            heads = self._attend(params, *xs)
            return self._proj(params, heads.repeat(1, 1, k), "wo", "bo")
        return fwd

    # -- kv-cached decoding (the JAX package's ops/attention.py:161-275) -----
    def init_cache(self, batch_size: int, max_len: int, dtype):
        shp = (batch_size, self.num_heads, max_len, self.head_dim)
        dev = self.model.device
        return {"k": torch.zeros(shp, dtype=dtype, device=dev),
                "v": torch.zeros(shp, dtype=dtype, device=dev)}

    def init_paged_cache(self, num_blocks: int, block_size: int, dtype):
        """Block-pool k/v shared by every slot: the block id indexes dim 0.
        Block 0 is the garbage sink (serving/kvpool.py): idle lanes write
        and read it, masked."""
        return self.init_cache(num_blocks, block_size, dtype)

    def _decode_heads(self, params, xs, what: str):
        """This step's q, k, v as (B, H, 1, D); refuses what has no cache
        semantics (a non-causal single-token self-attention)."""
        q_in, k_in, v_in = xs
        if not self.causal:
            raise ValueError(f"{what}: op {self.name!r} is non-causal single-token "
                             "self-attention, which is not decodable")
        b = q_in.shape[0]

        def split(t):
            return t.reshape(b, 1, self.num_heads, self.head_dim).transpose(1, 2)

        return (split(self._proj(params, q_in, "wq", "bq")),
                split(self._proj(params, k_in, "wk", "bk")),
                split(self._proj(params, v_in, "wv", "bv")))

    def _attend_cached(self, params, qh, keys, values, pos_v, dtype):
        """q over a (B, H, L, D) cache in f32, positions past each row's
        ``pos`` masked with -1e30 (their softmax weights are exactly 0), then
        the output projection.  ``keys``/``values`` are made contiguous, so
        a window of the dense cache and a gathered paged window of the same
        length run the same products."""
        b, _, L, _ = keys.shape
        scale = 1.0 / math.sqrt(self.head_dim)
        scores = torch.matmul(qh.float(), keys.contiguous().float().transpose(-1, -2)) * scale
        valid = torch.arange(L, device=keys.device)[None, None, None, :] \
            <= pos_v[:, None, None, None]
        probs = torch.softmax(torch.where(valid, scores, -1e30), dim=-1)
        out = torch.matmul(probs, values.contiguous().float()).to(dtype)
        out = out.transpose(1, 2).reshape(b, 1, self.embed_dim)
        return [self._proj(params, out, "wo", "bo")]

    def decode(self, params, xs, cache, pos, ctx: FwdCtx):
        """kv-cached single-token attention: write this step's k/v at
        ``pos`` (a 0-dim tensor, or one position per row), then attend over
        the whole static cache with later positions masked.  A full-sequence
        input (an encoder re-run, or cross-attention over full k/v) is
        stateless and runs ``forward``."""
        q_in, k_in, _ = xs
        if q_in.shape[1] != 1 or k_in.shape[1] != 1:
            return self.forward(params, xs, ctx), cache
        qh, kh, vh = self._decode_heads(params, xs, "generate")
        b = q_in.shape[0]
        pos_v = pos.expand(b) if pos.dim() == 0 else pos
        rows = torch.arange(b, device=q_in.device)
        # index_put_ at device positions: nothing is read back to the host
        cache["k"][rows, :, pos_v, :] = kh[:, :, 0, :].to(cache["k"].dtype)
        cache["v"][rows, :, pos_v, :] = vh[:, :, 0, :].to(cache["v"].dtype)
        return self._attend_cached(params, qh, cache["k"], cache["v"], pos_v,
                                   q_in.dtype), cache

    def decode_paged(self, params, xs, cache, pos, tables, ctx: FwdCtx):
        """Single-token attention over a paged cache: write this step's k/v
        into block ``tables[row, pos // block_size]``, gather the W blocks
        of each row's table in table (= position) order and attend over
        W * block_size positions, masked as the dense path.

        ``tables``: (B, W) int64 block ids; ``pos``: (B,) or 0-dim."""
        q_in, k_in, _ = xs
        if q_in.shape[1] != 1 or k_in.shape[1] != 1:
            raise ValueError(f"decode_paged: op {self.name!r} got a full-sequence input; "
                             "paged decode is single-token only")
        qh, kh, vh = self._decode_heads(params, xs, "decode_paged")
        b = q_in.shape[0]
        bs = cache["k"].shape[2]
        w = tables.shape[1]
        pos_v = pos.expand(b) if pos.dim() == 0 else pos
        rows = torch.arange(b, device=q_in.device)
        bidx, roff = tables[rows, pos_v // bs], pos_v % bs
        cache["k"][bidx, :, roff, :] = kh[:, :, 0, :].to(cache["k"].dtype)
        cache["v"][bidx, :, roff, :] = vh[:, :, 0, :].to(cache["v"].dtype)
        h, d = self.num_heads, self.head_dim

        def window(pool):  # (B, W, H, bs, D) -> (B, H, W * bs, D)
            return pool[tables].transpose(1, 2).reshape(b, h, w * bs, d)

        return self._attend_cached(params, qh, window(cache["k"]), window(cache["v"]),
                                   pos_v, q_in.dtype), cache
