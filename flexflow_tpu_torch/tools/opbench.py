"""Standalone per-operator micro-benchmark harness (PyTorch port of the JAX
package's ``tools/opbench.py``).

Counterpart of the reference's op benchmark rig (tests/ops.{h,cu}: a
separate Legion binary that times individual operators over given
shapes).  Each op is built alone on an ``FFModel`` and timed on the card
by the simulator's own timer, ``CostModel._measure_real`` (the fragments
``observability/opprof.py`` and ``runtime/profiling.op_profile`` time):
inputs and weights drawn from a seeded generator, the forward, then the
backward through autograd (the weights' gradients: a graph input takes
none, as in the JAX harness), each between CUDA events behind a held
stream, the median of ``--iters`` iterations after the warm-up.  Prints
per-op forward and forward+backward ms and the achieved GFLOP/s
(forward: ``flops_per_sample() x batch``; forward+backward: three times
that).

    python -m flexflow_tpu_torch.tools.opbench                 # standard suite
    python -m flexflow_tpu_torch.tools.opbench conv2d --batch 64 --in-shape 3,224,224 \\
        --out-channels 64 --kernel 11 --stride 4 --pad 2
    python -m flexflow_tpu_torch.tools.opbench linear --batch 64 --in-shape 4096 \\
        --out-dim 4096 --compute-dtype bfloat16
    python -m flexflow_tpu_torch.tools.opbench --device cpu    # a CPU host

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple


def _build(op_type: str, batch: int, in_shape: Tuple[int, ...], args):
    """Build a one-op model; returns (model, input tensors, op)."""
    import flexflow_tpu_torch as ft

    cfg = ft.FFConfig(batch_size=batch, device=getattr(args, "device", "cuda"),
                      compute_dtype=getattr(args, "compute_dtype", "float32"))
    model = ft.FFModel(cfg)
    dims = (batch,) + in_shape
    if op_type == "embedding":
        x = model.create_tensor(dims, dtype="int32", name="in")
    else:
        x = model.create_tensor(dims, name="in")
    inputs = [x]
    if op_type == "conv2d":
        model.conv2d(x, args.out_channels, args.kernel, args.kernel,
                     args.stride, args.stride, args.pad, args.pad, name="op")
    elif op_type == "pool2d":
        model.pool2d(x, args.kernel, args.kernel, args.stride, args.stride, 0, 0, name="op")
    elif op_type == "linear":
        model.dense(x, args.out_dim, name="op")
    elif op_type == "embedding":
        model.embedding(x, args.num_entries, args.out_dim, name="op")
    elif op_type == "batch_norm":
        model.batch_norm(x, relu=False, name="op")
    elif op_type == "softmax":
        model.softmax(x, name="op")
    elif op_type == "flat":
        model.flat(x, name="op")
    elif op_type == "concat":
        y = model.create_tensor(dims, name="in2")
        inputs.append(y)
        model.concat([x, y], axis=1, name="op")
    elif op_type == "add":
        y = model.create_tensor(dims, name="in2")
        inputs.append(y)
        model.add(x, y, name="op")
    elif op_type == "relu":
        model.relu(x, name="op")
    elif op_type == "dropout":
        model.dropout(x, rate=0.5, name="op")
    else:
        raise SystemExit(f"unknown op {op_type!r}")
    op = model.ops[-1]
    return model, inputs, op


def bench_op(op_type: str, batch: int, in_shape: Tuple[int, ...], args,
             iters: int = 10) -> dict:
    """``{"fwd": (seconds, GFLOP/s), "fwd+bwd": (seconds, GFLOP/s)}`` of the
    op alone on ``args.device`` (default cuda) in ``args.compute_dtype``
    (default float32), the median of ``iters`` timed iterations."""
    from ..config import ParallelConfig
    from ..observability.opprof import fragment_timer

    model, _, op = _build(op_type, batch, in_shape, args)
    pc = op.legalize_pc(ParallelConfig.data_parallel(op.output.num_dims, 1))
    fwd, bwd = fragment_timer(model)._measure_real(op, pc, iters=iters)
    flops = op.flops_per_sample() * batch
    results = {}
    for which, dt, eff_flops in (("fwd", fwd, flops), ("fwd+bwd", fwd + bwd, 3.0 * flops)):
        results[which] = (dt, eff_flops / dt / 1e9 if dt > 0 else 0.0)
    return results


_SUITE = [
    # (op, batch, in_shape, overrides): AlexNet/DLRM-flavoured shapes
    # mirroring the reference harness's coverage (the JAX package's suite).
    ("conv2d", 64, (3, 224, 224),
     dict(out_channels=64, kernel=11, stride=4, pad=2)),
    ("conv2d", 64, (192, 27, 27),
     dict(out_channels=384, kernel=3, stride=1, pad=1)),
    ("pool2d", 64, (64, 55, 55), dict(kernel=3, stride=2)),
    ("linear", 64, (9216,), dict(out_dim=4096)),
    ("linear", 256, (512,), dict(out_dim=512)),
    ("embedding", 256, (1,), dict(num_entries=1000000, out_dim=64)),
    ("batch_norm", 64, (64, 56, 56), {}),
    ("softmax", 64, (1000,), {}),
    ("concat", 64, (512,), {}),
    ("add", 64, (1024,), {}),
    ("relu", 64, (4096,), {}),
    ("flat", 64, (256, 6, 6), {}),
]


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("op", nargs="?", default=None,
                   help="op to bench (default: standard suite)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--in-shape", default="3,224,224",
                   help="comma-separated input shape without batch dim")
    p.add_argument("--out-channels", type=int, default=64)
    p.add_argument("--kernel", type=int, default=3)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--pad", type=int, default=0)
    p.add_argument("--out-dim", type=int, default=4096)
    p.add_argument("--num-entries", type=int, default=1000000)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.op:
        shape = tuple(int(v) for v in args.in_shape.split(","))
        jobs = [(args.op, args.batch, shape, {})]
    else:
        jobs = _SUITE

    print(f"{'op':12s} {'shape':22s} {'fwd ms':>9s} {'GF/s':>8s} "
          f"{'fwd+bwd ms':>11s} {'GF/s':>8s}")
    rows = []
    for op_type, batch, in_shape, over in jobs:
        job_args = argparse.Namespace(**{**vars(args), **over})
        r = bench_op(op_type, batch, in_shape, job_args, iters=args.iters)
        f_ms, f_gf = r["fwd"]
        b_ms, b_gf = r["fwd+bwd"]
        shape_s = "x".join(str(s) for s in (batch,) + in_shape)
        print(f"{op_type:12s} {shape_s:22s} {f_ms * 1e3:9.3f} {f_gf:8.1f} "
              f"{b_ms * 1e3:11.3f} {b_gf:8.1f}")
        rows.append({"op": op_type, "shape": shape_s, "fwd_ms": f_ms * 1e3, "fwd_gflops": f_gf,
                     "fwd_bwd_ms": b_ms * 1e3, "fwd_bwd_gflops": b_gf})
    return rows


if __name__ == "__main__":
    main()
