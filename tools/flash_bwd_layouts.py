#!/usr/bin/env python3
"""The bf16 flash dK/dV kernel's register layouts, timed on one NVIDIA H100.

    python3 tools/flash_bwd_layouts.py

The bf16 dK/dV kernel (flash_bwd_dkdv_mma_kernel in
flexflow_tpu_torch/kernels/csrc/flash_attention.cu) takes two layout
parameters: kHold, whether a warp holds the A fragments of its keys (K, V)
in registers or reads them from the staged tiles at every k16 step, and
QC, the q columns of one pass over a q-tile (64, or two passes of 32).  The
port holds them and makes one pass at head dims up to 64 (the first
layout below), and reads them in two passes at 128.  This script builds
the production source with a C entry for each layout at head dim 64,
prints ptxas's registers and spills for each, checks each against the
plain version with chip_smoke.py's bf16 tolerance, and times each at the
transformer's shape (16, 8, 512, 64), bf16, causal, with chip_smoke.py's
device timing, in two passes in opposite orders.  Needs one card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from flexflow_tpu_torch.kernels import _build  # noqa: E402
from flexflow_tpu_torch.kernels import flash_attention as fa  # noqa: E402

SHAPE = (16, 8, 512, 64)
# (name, C template arguments after D); the first is the port's at D = 64
LAYOUTS = [("dkdv hold K/V, 64 q columns a pass", "true, 64"),
           ("dkdv hold K/V, 32 q columns a pass", "true, 32"),
           ("dkdv read K/V, 64 q columns a pass", "false, 64"),
           ("dkdv read K/V, 32 q columns a pass", "false, 32")]
ENTRY = """
extern "C" int ff_layout_{i}(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv,
                             int bh, int s, float scale, void* stream) {{
  return (int)launch_tc(flash_bwd_dkdv_mma_kernel<64, {args}>, bh * tiles(s),
                        dkdv_mma_smem<64>(), reinterpret_cast<cudaStream_t>(stream),
                        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
                        delta, nullptr, (bf16*)dk, (bf16*)dv, bh, s, s, scale, true);
}}
"""


def build_layouts():
    """The production source plus one causal C entry for each layout, built
    with the production flags; returns the library and ptxas's report."""
    with open(os.path.join(_build.CSRC_DIR, fa.SOURCE)) as f:
        src = f.read()
    for i, (_, args) in enumerate(LAYOUTS):
        src += ENTRY.format(i=i, args=args)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "flash_bwd_layouts.cu")
    with open(path, "w") as f:
        f.write(src)
    out = path[:-3] + ".so"
    r = subprocess.run([_build.nvcc(), *_build.BASE_FLAGS, "-o", out, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stderr}")
    lib = ctypes.CDLL(out)
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for i in range(len(LAYOUTS)):
        fn = getattr(lib, f"ff_layout_{i}")
        fn.argtypes = [p, p, p, p, p, p, p, p, i32, i32, f32, p]
        fn.restype = i32
    return lib, r.stdout + r.stderr


def registers(log_text):
    """{mangled dK/dV kernel name: 'registers, spills'} from ptxas."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if "dkdv_mma_kernel" in m.group(1) else None
        elif name and ("registers" in line or "spill" in line):
            out[name] = (out.get(name, "") + " " + line.strip()).strip()
    return out


def main():
    if not torch.cuda.is_available():
        print("flash_bwd_layouts: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    cs.log(f"[env] {cs.nvidia_smi_line()}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib, log_text = build_layouts()
    for name, regs in sorted(registers(log_text).items()):
        if "Li64E" in name:
            cs.log(f"[ptxas] {name}: {regs}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = cs.attn_inputs(SHAPE, torch.bfloat16, gen)
    scale = SHAPE[-1] ** -0.5
    o, lse = fa.flash_fwd_ref(q, k, v, scale, True)
    delta = (o.float() * do.float()).sum(-1)
    dk_ref, dv_ref = fa.flash_bwd_dkdv_ref(q, k, v, do, lse, delta, None, scale, True)
    b, h, s, _ = SHAPE
    dk, dv = torch.empty_like(k), torch.empty_like(v)

    def call(i):
        rc = getattr(lib, f"ff_layout_{i}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, s, scale,
            torch.cuda.current_stream().cuda_stream)
        _build.raise_on(rc, LAYOUTS[i][0])

    tol = cs.FLASH_TOL[torch.bfloat16]
    for i, (name, _) in enumerate(LAYOUTS):
        call(i)
        torch.cuda.synchronize()
        err = max(cs.worst_err(dk, dk_ref, tol, f"dK {name}"),
                  cs.worst_err(dv, dv_ref, tol, f"dV {name}"))
        cs.log(f"[check] {name:36s} max_abs_err {err:.3e}")
    order = list(range(len(LAYOUTS)))
    ms = {i: [] for i in order}
    for i in order + order[::-1]:
        ms[i].append(cs.cuda_time_ms(lambda: call(i), 50))
    for i, (name, args) in enumerate(LAYOUTS):
        cs.log(f"[time] {name:36s} <64, {args}>  {ms[i][0]:.4f} / {ms[i][1]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
