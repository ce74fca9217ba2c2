#!/usr/bin/env python3
"""What the bf16 flash forward's P hi + lo split costs, on one NVIDIA H100.

    python3 tools/flash_fwd_p_split.py

The port's bf16 forward (flash_fwd_mma_kernel in
flexflow_tpu_torch/kernels/csrc/flash_attention.cu) feeds the f32
probabilities P to the tensor cores as two bf16 terms, hi and lo, so its
P V product is two products.  This script builds a copy of that source
with the lo products removed (P rounded to bf16 once, as PyTorch's SDPA
does; the port never uses it) and times both beside SDPA's forward at the
transformer's shape (16, 8, 512, 64), causal and not, with the same
device timing as chip_smoke.py.  It prints each one's time and its
largest error against the plain f32 version.  Needs one card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from flexflow_tpu_torch.kernels import _build  # noqa: E402
from flexflow_tpu_torch.kernels import flash_attention as fa  # noqa: E402

SHAPE = (16, 8, 512, 64)
LO_PRODUCTS = ("        mma_16816(acc[2 * dp], pl, b[0], b[1]);\n",
               "        mma_16816(acc[2 * dp + 1], pl, b[2], b[3]);\n")


def build_hi_only():
    """The production source without the lo products, built with the
    production flags, plus a C entry for head dim 64."""
    with open(os.path.join(_build.CSRC_DIR, fa.SOURCE)) as f:
        src = f.read()
    for line in LO_PRODUCTS:
        if src.count(line) != 1:
            raise RuntimeError(f"expected one {line.strip()!r} in {fa.SOURCE}")
        src = src.replace(line, "")
    src += """
extern "C" int ff_flash_fwd_hi_only(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int bh, int sq, int sk, float scale, int causal,
                                    void* stream) {
  return (int)launch_fwd<64>(1, q, k, v, o, lse, bh, sq, sk, scale, causal != 0,
                             reinterpret_cast<cudaStream_t>(stream));
}
"""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "flash_fwd_hi_only.cu")
    with open(path, "w") as f:
        f.write(src)
    out = path[:-3] + ".so"
    r = subprocess.run([_build.nvcc(), *_build.BASE_FLAGS, "-o", out, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stderr}")
    lib = ctypes.CDLL(out)
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ff_flash_fwd_hi_only.argtypes = [p, p, p, p, p, i32, i32, i32, f32, i32, p]
    lib.ff_flash_fwd_hi_only.restype = i32
    return lib


def main():
    if not torch.cuda.is_available():
        print("flash_fwd_p_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    cs.log(f"[env] {cs.nvidia_smi_line()}; torch {torch.__version__}")
    fa.build()
    lib = build_hi_only()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, _ = cs.attn_inputs(SHAPE, torch.bfloat16, gen)
    scale = SHAPE[-1] ** -0.5

    def hi_only(causal):
        b, h, s, _ = SHAPE
        o, lse = torch.empty_like(q), torch.empty(SHAPE[:3], device="cuda")
        rc = lib.ff_flash_fwd_hi_only(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                      lse.data_ptr(), b * h, s, s, scale, int(causal),
                                      torch.cuda.current_stream().cuda_stream)
        _build.raise_on(rc, "hi-only forward")
        return o, lse

    for causal in (True, False):
        versions = {"hi + lo (the port)": lambda: fa.flash_fwd(q, k, v, scale, causal),
                    "hi only (not used)": lambda: hi_only(causal),
                    "SDPA": lambda: (torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, scale=scale), None)}
        o_ref, _ = fa.flash_fwd_ref(q, k, v, scale, causal)
        for name, fn in versions.items():
            err = (fn()[0].float() - o_ref.float()).abs().max().item()
            ms = [cs.cuda_time_ms(fn, 50) for _ in range(2)]
            cs.log(f"causal={int(causal)}  {name:20s} {ms[0]:.4f} / {ms[1]:.4f} ms  "
                   f"max |O - plain f32| {err:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
