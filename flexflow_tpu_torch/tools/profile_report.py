"""Per-op profile report of a model on the card (PyTorch port of the JAX
package's ``tools/profile_report.py``).

Measures each op of a model standalone (the ``measure_compute_time``
analogue, ``runtime/profiling.op_profile``: the simulator's timer,
``CostModel._measure_real``, each op's forward and backward between CUDA
events behind a held stream) and writes a markdown table of forward and
backward ms, analytic GFLOP (``flops_per_sample()`` times the batch: a
dense layer counts every leading dim), achieved TFLOP/s and share of the
standalone total: the committed form of the reference's ``--profiling``
per-op printouts (conv_2d.cu:448-473).  The attention ops of the
transformer run the flash kernels (forward, dK/dV, dQ) in every measured
iteration.

    python -m flexflow_tpu_torch.tools.profile_report alexnet \\
        --batch-size 256 --out PROFILE_H100.md
    python -m flexflow_tpu_torch.tools.profile_report transformer --batch-size 16
    python -m flexflow_tpu_torch.tools.profile_report alexnet --batch-size 2 --device cpu

Runs on the card unless ``--device cpu``; the header names the card and
its power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

DEFAULT_OUT = "PROFILE_H100.md"


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", default="alexnet", nargs="?")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)

    import flexflow_tpu_torch as ft
    from ..runtime.profiling import op_profile
    from ..simulator.cost_model import card_label
    from .offline_search import build_model

    model = build_model(args.model, args.batch_size, 1, args.device, args.compute_dtype)
    model.compile(ft.SGDOptimizer(model, lr=0.001), ft.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                  [ft.MetricsType.ACCURACY])
    prof = op_profile(model)
    where = "{} ({})".format(*card_label()) if model.device.type == "cuda" else "cpu"

    total = sum(v.get("forward_ms", 0) + v.get("backward_ms", 0) for v in prof.values())
    lines = [
        f"# Per-op profile — {args.model}, batch {args.batch_size}, "
        f"{args.compute_dtype}, {where}",
        "",
        f"Standalone per-op timings (measure_compute_time analogue); the "
        f"compiled train step overlaps/fuses across ops, so the sum "
        f"({total:.2f} ms) upper-bounds the real step.",
        "",
        "| op | fwd ms | bwd ms | GFLOP (fwd) | fwd TFLOPS | % of total |",
        "|---|---|---|---|---|---|",
    ]
    rows = []
    for op in model.ops:
        v = prof.get(op.name, {})
        fwd = v.get("forward_ms", 0.0)
        bwd = v.get("backward_ms", 0.0)
        gflop = op.flops_per_sample() * op.output.dims[0] / 1e9
        tf = (gflop / fwd) if fwd > 0 else 0.0
        share = 100.0 * (fwd + bwd) / total if total else 0.0
        lines.append(f"| {op.name} | {fwd:.3f} | {bwd:.3f} | {gflop:.2f} | "
                     f"{tf:.1f} | {share:.1f}% |")
        rows.append({"op": op.name, "type": op._type, "forward_ms": fwd, "backward_ms": bwd,
                     "gflop": gflop, "trains": bool(op.param_weights)
                     or any(t.owner_op is not None for t in op.inputs)})
    lines.append("")
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"profiled {len(prof)} ops ({total:.2f} ms standalone total) -> {args.out}")
    return {"rows": rows, "total_ms": total, "device": where}


if __name__ == "__main__":
    main()
