"""DLRM, built exactly as the JAX package builds it
(``flexflow_tpu/models/dlrm.py``; reference: examples/cpp/DLRM/
dlrm.cc:26-150).

Sparse+dense recommender: per-table embeddings (SUM bags), bottom/top MLPs,
concat feature interaction, MSE loss.  Defaults mirror run_random.sh:3-8:
8 tables of 1M rows, sparse dim 64, bot 64-512-512-64,
top 576-1024-1024-1024-1.

The tables live on the device by default, the JAX package's default, and
their gradients are dense.  A CPU-typed strategy for a table (the
reference's hetero DLRM, ``tools/dlrm_strategy.py --hetero``) keeps it in
pinned host memory: under plain SGD, or with
``FFConfig.sparse_host_embeddings`` set, each step gathers only the
batch's rows (runtime/host_tables.py); otherwise the table streams to the
card and back every step.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from ..initializers import NormInitializer, UniformInitializer
from ..model import FFModel
from ..ops.conv2d import ActiMode
from ..ops.embedding import AggrMode


def create_mlp(ff: FFModel, x, ln: Sequence[int], sigmoid_layer: int, seed: int = 0):
    # Reference initializers (dlrm.cc:29-37): weights ~ N(0, sqrt(2/(m+n))),
    # bias ~ N(0, sqrt(2/n)); sigmoid at one layer, relu elsewhere.
    t = x
    for i in range(len(ln) - 1):
        w_std = math.sqrt(2.0 / (ln[i + 1] + ln[i]))
        b_std = math.sqrt(2.0 / ln[i + 1])
        act = ActiMode.SIGMOID if i == sigmoid_layer else ActiMode.RELU
        t = ff.dense(t, ln[i + 1], activation=act,
                     kernel_initializer=NormInitializer(seed, 0.0, w_std),
                     bias_initializer=NormInitializer(seed, 0.0, b_std))
    return t


def create_emb(ff: FFModel, x, input_dim: int, output_dim: int, idx: int):
    rng = math.sqrt(1.0 / input_dim)
    return ff.embedding(x, input_dim, output_dim, aggr=AggrMode.SUM,
                        kernel_initializer=UniformInitializer(idx, -rng, rng),
                        name=f"embedding{idx}")


def build_dlrm(ff: FFModel, batch_size: int,
               embedding_sizes: Optional[List[int]] = None,
               embedding_bag_size: int = 1,
               sparse_feature_size: int = 64,
               mlp_bot: Optional[List[int]] = None,
               mlp_top: Optional[List[int]] = None):
    """Returns (sparse_inputs, dense_input, final_sigmoid_output)."""
    embedding_sizes = embedding_sizes or [1000000] * 8
    mlp_bot = mlp_bot or [64, 512, 512, 64]
    mlp_top = mlp_top or [576, 1024, 1024, 1024, 1]

    sparse_inputs = [
        ff.create_tensor((batch_size, embedding_bag_size), name=f"embedding{i}",
                         dtype="int32", nchw=False)
        for i in range(len(embedding_sizes))]
    dense_input = ff.create_tensor((batch_size, mlp_bot[0]), name="dense",
                                   nchw=False)

    x = create_mlp(ff, dense_input, mlp_bot, sigmoid_layer=-1)
    ly = [create_emb(ff, s, embedding_sizes[i], sparse_feature_size, i)
          for i, s in enumerate(sparse_inputs)]
    z = ff.concat([x] + ly, axis=1)  # "cat" feature interaction
    p = create_mlp(ff, z, mlp_top, sigmoid_layer=len(mlp_top) - 2)
    return sparse_inputs, dense_input, p


def synthetic_batch(batch_size: int, embedding_sizes: List[int],
                    embedding_bag_size: int, dense_dim: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    sparse = [rng.integers(0, v, size=(batch_size, embedding_bag_size), dtype=np.int32)
              for v in embedding_sizes]
    dense = rng.standard_normal((batch_size, dense_dim), dtype=np.float32)
    labels = rng.integers(0, 2, size=(batch_size, 1)).astype(np.float32)
    return sparse, dense, labels
