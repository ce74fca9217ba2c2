"""DLRM strategy generators (PyTorch port of
``flexflow_tpu/tools/dlrm_strategy.py``; reference: src/runtime/
dlrm_strategy.cc and dlrm_strategy_hetero.cc, standalone binaries that
write protobuf strategy files for the DLRM example).

Two modes, as the two reference binaries:

  * homogeneous (``generate``): each embedding table pinned to one GPU
    round-robin (dims (1, 1), device ``i % devices``,
    dlrm_strategy.cc:184-189), the concat split across nodes, the MLPs
    data parallel over every GPU;
  * hetero (``generate_hetero``): the tables on the host (a CPU device
    type and host memory, dlrm_strategy_hetero.cc:28-35), which the port
    runs as row-sparse host tables (runtime/host_tables.py), the compute
    ops data parallel.

The files are the JAX package's byte for byte (wire-compatible with the
reference's strategy.proto) and hold dims in the reference's order, so
they load with ``--import-reference-order`` like the reference tools'.

    python -m flexflow_tpu_torch.tools.dlrm_strategy --gpu 4 --node 2 [--hetero]
        [--emb 8] [-o out.pb]
"""

from __future__ import annotations

import argparse
from typing import Dict

from ..config import DeviceType, ParallelConfig
from ..parallel.strategy import save_strategies_to_file


def generate(gpus_per_node: int, num_nodes: int,
             num_embeddings: int = 24) -> Dict[str, ParallelConfig]:
    """The homogeneous strategy (dlrm_strategy.cc main, :175-213).  Dims
    are in the reference's order (sample dim last): (c, n) is n sample
    parts by c channel parts."""
    total = gpus_per_node * num_nodes
    out: Dict[str, ParallelConfig] = {}
    for i in range(num_embeddings):
        out[f"embedding{i}"] = ParallelConfig(DeviceType.GPU, (1, 1), (i % total,),
                                              ("hbm", "hbm", "hbm"))
    out["concat"] = ParallelConfig(DeviceType.GPU, (1, num_nodes),
                                   tuple(i * gpus_per_node for i in range(num_nodes)),
                                   ("hbm", "hbm"))
    out["linear"] = ParallelConfig(DeviceType.GPU, (1, total), tuple(range(total)),
                                   ("hbm", "hbm", "hbm"))
    out["mse_loss"] = ParallelConfig(DeviceType.GPU, (1, total), tuple(range(total)), ("hbm",))
    return out


def generate_hetero(gpus: int = 1, cpus: int = 1,
                    num_embeddings: int = 8) -> Dict[str, ParallelConfig]:
    """The heterogeneous strategy: the tables on the host
    (dlrm_strategy_hetero.cc)."""
    out: Dict[str, ParallelConfig] = {}
    for i in range(num_embeddings):
        base = ParallelConfig.host_rowsparse()
        out[f"embedding{i}"] = ParallelConfig(base.device_type, base.dims, (i % cpus,),
                                              base.memory_types)
    for name in ("linear", "mse_loss", "concat"):
        out[name] = ParallelConfig(DeviceType.GPU, (1, gpus), tuple(range(gpus)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpu", type=int, default=1, help="GPUs per node (the reference's flag)")
    ap.add_argument("--node", type=int, default=1)
    ap.add_argument("--cpu", type=int, default=1, help="hetero: host count")
    ap.add_argument("--emb", type=int, default=None, help="embedding tables")
    ap.add_argument("--hetero", action="store_true")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)

    if args.hetero:
        nemb = args.emb or 8
        strategies = generate_hetero(args.gpu, args.cpu, nemb)
        default_name = f"dlrm_strategy_{nemb}nEmb_{args.cpu}cpu_{args.gpu}gpu.pb"
    else:
        nemb = args.emb or 24
        strategies = generate(args.gpu, args.node, nemb)
        default_name = f"dlrm_strategy_gpu_{args.gpu}_node_{args.node}.pb"
    out = args.output or default_name
    save_strategies_to_file(out, strategies)
    print(f"wrote {len(strategies)} op strategies to {out}")
    return out


if __name__ == "__main__":
    main()
