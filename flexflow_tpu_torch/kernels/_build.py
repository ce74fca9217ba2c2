"""Build a CUDA source of ``kernels/csrc`` into a plain-C shared library.

Route (b) of the port's kernel build: ``nvcc`` for ``sm_90a`` into a
``.so`` with a C interface, at first use (never at import), into
``flexflow_tpu_torch/_build/`` (listed in ``.gitignore``), loaded with
``ctypes``.  The library's name carries a hash of the source and the
flags, so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Sequence

from torch.distributed.tensor import DTensor

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; "
                           "the port's CUDA kernels are built from source")
    return path


def build(source: str, flags: Sequence[str] = (), force: bool = False) -> dict:
    """Compile ``csrc/<source>`` with ``BASE_FLAGS + flags``.

    Returns the library's path, the build seconds (0 when an existing build
    was reused) and the compiler's output (``-Xptxas -v``: registers and
    spills per kernel)."""
    src = os.path.join(CSRC_DIR, source)
    flags = [*BASE_FLAGS, *flags]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libff_{os.path.splitext(source)[0]}_{digest}.so")
    if os.path.exists(out) and not force:
        return {"path": out, "seconds": 0.0, "log": ""}
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    r = subprocess.run([nvcc(), *flags, "-o", tmp, src], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (rc {r.returncode}):\n"
                           f"{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return {"path": out, "seconds": seconds, "log": r.stdout + r.stderr}


def load(source: str, flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``source`` if needed and load it; callers keep the handle."""
    return ctypes.CDLL(build(source, flags)["path"])


def refuse_dtensor(*tensors) -> None:
    """Kernel wrappers take plain tensors: on a mesh the caller passes each
    shard's ``.to_local()``, so no kernel reads a shard's storage as if it
    were the whole tensor."""
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError("a kernel wrapper takes plain tensors, not a DTensor: "
                            "pass the local shard (.to_local())")


def raise_on(rc: int, name: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaGetLastError()``."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
