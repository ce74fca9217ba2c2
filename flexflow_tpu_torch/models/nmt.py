"""NMT LSTM seq2seq, built exactly as the JAX package builds it
(``flexflow_tpu/models/nmt.py``; reference: the nmt/ mini-framework).

Reference defaults (nmt/nmt.cc:34-44): batch 64 a worker, 2 layers, seq
20, hidden = embed = 2048, vocab 20k.  Full-sequence LSTM ops
(ops/lstm.py); ``embed_dst`` shares ``embed_src``'s table
(``share_with``, the reference's SharedVariable); each encoder layer's
final (h, c) seeds its decoder layer; the vocabulary projection is one
(B*T, H) x (H, V) matmul, and softmax and cross-entropy meet in the loss.
"""

from __future__ import annotations

import numpy as np

from ..model import FFModel


def build_nmt(ff: FFModel, batch_size: int, seq_length: int = 20,
              num_layers: int = 2, hidden_size: int = 2048,
              embed_size: int = 2048, vocab_size: int = 20 * 1024):
    """Returns (src_tensor, dst_tensor, softmax_output).

    Labels are the decoder targets, shape (B, seq_length) int32.
    """
    src = ff.create_tensor((batch_size, seq_length), name="src",
                           dtype="int32", nchw=False)
    dst = ff.create_tensor((batch_size, seq_length), name="dst",
                           dtype="int32", nchw=False)

    from ..ops.embedding import AggrMode

    src_emb = ff.embedding(src, vocab_size, embed_size, aggr=AggrMode.NONE,
                           name="embed_src")
    embed_op = ff.ops[-1]
    dst_emb = ff.embedding(dst, vocab_size, embed_size, aggr=AggrMode.NONE,
                           share_with=embed_op, name="embed_dst")

    # Encoder stack; each layer's final (h, c) seeds the decoder layer.
    enc = src_emb
    states = []
    for layer in range(num_layers):
        enc, h, c = ff.lstm(enc, hidden_size, name=f"enc_lstm{layer}")
        states.append((h, c))
    dec = dst_emb
    for layer in range(num_layers):
        h, c = states[layer]
        dec, _, _ = ff.lstm(dec, hidden_size, hx=h, cx=c,
                            name=f"dec_lstm{layer}")

    logits = ff.dense(dec, vocab_size, name="vocab_proj")
    out = ff.softmax(logits, name="softmax_dp")
    return src, dst, out


def synthetic_batch(batch_size: int, seq_length: int, vocab_size: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, vocab_size, size=(batch_size, seq_length), dtype=np.int32)
    dst = rng.integers(0, vocab_size, size=(batch_size, seq_length), dtype=np.int32)
    labels = rng.integers(0, vocab_size, size=(batch_size, seq_length), dtype=np.int32)
    return src, dst, labels


def greedy_translate(model, src_tensor, dst_tensor, src_tokens, max_len: int,
                     bos_id: int = 1):
    """Greedy seq2seq decoding: encode ``src_tokens`` and emit ``max_len``
    target tokens from ``bos_id``, through ``FFModel.generate``: the source
    is a fixed extra input (the encoder runs once a call) and the decoder
    LSTMs advance their cached (h, c) one token at a time."""
    src_tokens = np.asarray(src_tokens, np.int32)
    prompt = np.full((src_tokens.shape[0], 1), bos_id, np.int32)
    return model.generate(prompt, max_len, tokens_input=dst_tensor, positions_input=None,
                          extra_inputs={src_tensor: src_tokens})
