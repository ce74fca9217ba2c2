"""Decoder-only transformer LM (PyTorch port of
``flexflow_tpu/models/transformer.py``).

The same graph calls and op names as the JAX package, so weights carry
across with ``convert.load_jax_params``.  Attention runs on the port's
flash kernels (``kernels/flash_attention.py``).  With ``moe_every`` = k,
every k-th block's MLP is a Switch mixture of ``num_experts`` experts
(``ops/moe.py``).
"""

from __future__ import annotations

import numpy as np

from ..model import FFModel
from ..ops.embedding import AggrMode


def build_transformer(ff: FFModel, batch_size: int, seq_length: int = 256,
                      num_layers: int = 4, embed_dim: int = 512,
                      num_heads: int = 8, mlp_ratio: int = 4,
                      vocab_size: int = 32000, dropout: float = 0.0,
                      moe_every: int = 0, num_experts: int = 8):
    """Returns (tokens_tensor, positions_tensor, softmax_output).

    tokens/positions: (B, S) int32, positions 0..S-1 per row.  Labels are
    next-token ids, shape (B, S) int32."""
    tok = ff.create_tensor((batch_size, seq_length), name="tokens",
                           dtype="int32", nchw=False)
    pos = ff.create_tensor((batch_size, seq_length), name="positions",
                           dtype="int32", nchw=False)

    x = ff.embedding(tok, vocab_size, embed_dim, aggr=AggrMode.NONE, name="tok_embed")
    p = ff.embedding(pos, seq_length, embed_dim, aggr=AggrMode.NONE, name="pos_embed")
    x = ff.add(x, p, name="embed_add")

    for i in range(num_layers):
        h = ff.layer_norm(x, name=f"ln1_{i}")
        h = ff.multihead_attention(h, num_heads=num_heads, causal=True,
                                   dropout=dropout, name=f"attn_{i}")
        x = ff.add(x, h, name=f"res_attn_{i}")
        h = ff.layer_norm(x, name=f"ln2_{i}")
        if moe_every and (i + 1) % moe_every == 0:
            # dropped tokens ride the residual
            h = ff.expert_mlp(h, num_experts=num_experts, hidden_size=embed_dim * mlp_ratio,
                              activation="gelu", name=f"moe_{i}")
        else:
            h = ff.dense(h, embed_dim * mlp_ratio, activation="gelu", name=f"mlp_up_{i}")
            h = ff.dense(h, embed_dim, name=f"mlp_down_{i}")
        x = ff.add(x, h, name=f"res_mlp_{i}")

    x = ff.layer_norm(x, name="ln_f")
    logits = ff.dense(x, vocab_size, name="lm_head")
    out = ff.softmax(logits, name="softmax")
    return tok, pos, out


def synthetic_lm_batch(batch_size: int, seq_length: int, vocab_size: int,
                       seed: int = 0):
    """(tokens, positions, next-token labels) for a synthetic LM step, the
    same numbers as the JAX package's recipe."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab_size, size=(batch_size, seq_length)).astype(np.int32)
    posa = np.broadcast_to(np.arange(seq_length, dtype=np.int32),
                           (batch_size, seq_length)).copy()
    labels = np.roll(toks, -1, axis=1).astype(np.int32)
    return toks, posa, labels
