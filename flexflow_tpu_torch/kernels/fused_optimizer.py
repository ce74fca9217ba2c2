"""Fused SGD / Adam parameter updates: hand-written CUDA kernels for Hopper.

Replaces the Pallas TPU kernels ``_sgd_kernel`` and ``_adam_kernel`` of
``flexflow_tpu/kernels/fused_optimizer.py``.  The CUDA source is
``csrc/fused_optimizer.cu``; it says what bounds the kernels (device-memory
bytes) and how they are laid out.  It is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``flexflow_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded
with ``ctypes``.

Each wrapper updates ``w`` (and its state) in place.  It refuses a
``DTensor``: a caller on a mesh passes each shard's ``.to_local()``, so
no kernel reads a shard's storage as if it were the whole tensor.  On a
CUDA tensor it
launches its kernel on the current stream, raises if the launch was
refused, and adds one to its ``launches`` count.  On a CPU tensor it runs
the plain PyTorch version beside it (``*_ref``), which is also the
optimizer's ``fused=False`` path.  There is no fallback from one to the
other.

SGD takes a whole optimizer step in one launch (``fused_sgd_update_multi``,
counted on ``fused_sgd_update.launches``); ``fused_sgd_update``, the JAX
package's name, is the same launch over one leaf.  Adam launches once per
leaf.

The time-varying scalar (``lr`` for SGD, ``alpha_t`` for Adam) is either a
float or the optimizer's scalar vector: a float32 tensor ``(value, skip)``
on the leaves' device (``scalar_vector``), the counterpart of the TPU
kernels' SMEM operand.  The kernels read it from device memory, so a launch
captured in a CUDA graph follows a value written into the vector between
replays; when ``skip`` is not 0 they return without writing, and the plain
versions select the old values (``torch.where``), so a skipped step leaves
every leaf bitwise as it was.  A float is put into a fresh vector (two
fills on the stream, no host synchronization).
"""

from __future__ import annotations

import array
import ctypes
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from . import _build
from ._build import refuse_dtensor

SOURCE = "fused_optimizer.cu"
# -fmad=false: no multiply-add contraction, so each kernel performs the
# same rounded IEEE operations as its plain PyTorch version and the two
# agree to the bit (the work is bound by memory, not by arithmetic).
NVCC_FLAGS = ["-fmad=false"]

_lib_handle: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> dict:
    """Compile ``csrc/fused_optimizer.cu`` into the build directory
    (``_build.build``: path, build seconds and the ptxas report)."""
    return _build.build(SOURCE, NVCC_FLAGS, force=force)


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load(SOURCE, NVCC_FLAGS)
        p, i64, f32, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
        lib.ff_fused_sgd_update_multi.argtypes = [ctypes.POINTER(i64), i32, i64, p, f32,
                                                  f32, i32, p]
        lib.ff_fused_sgd_update_multi.restype = i32
        lib.ff_fused_adam_update.argtypes = [p, p, p, p, i64, p, f32, f32, f32, f32,
                                             f32, f32, p]
        lib.ff_fused_adam_update.restype = i32
        _lib_handle = lib
    return _lib_handle


def _check(w: torch.Tensor, *others: torch.Tensor) -> None:
    refuse_dtensor(w, *others)
    for t in (w, *others):
        if t.dtype != torch.float32:
            raise TypeError(f"fused optimizer operands must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused optimizer operands must be contiguous")
        if t.device != w.device:
            raise ValueError(f"operands on different devices: {t.device} vs {w.device}")
        if t.numel() != w.numel():
            raise ValueError(f"operand sizes differ: {t.numel()} vs {w.numel()}")
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {w.device}")


def _leaf_rows(ws, gs, ms):
    """``_check`` on every (w, g[, m]) leaf, all on ``ws[0]``'s device, at a
    few tensor calls per operand (this runs on every optimizer step); a
    failing leaf goes through ``_check`` for its message.  Returns (w, g,
    m, n) per leaf: addresses (m's 0 when it is None) and element count."""
    if ws[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ws[0].device}")
    dev, f32 = ws[0].get_device(), torch.float32
    rows = []
    for w, g, m in zip(ws, gs, ms):
        n = w.numel()
        if not (type(w) is not DTensor and type(g) is not DTensor and type(m) is not DTensor
                and w.dtype is f32 and g.dtype is f32 and w.is_contiguous() and g.is_contiguous()
                and g.numel() == n and w.get_device() == dev and g.get_device() == dev
                and (m is None or (m.dtype is f32 and m.is_contiguous() and m.numel() == n
                                   and m.get_device() == dev))):
            _check(w, g, *(() if m is None else (m,)))
            raise ValueError(f"leaves on different devices: {w.device} vs {ws[0].device}")
        rows.append((w.data_ptr(), g.data_ptr(), 0 if m is None else m.data_ptr(), n))
    return rows


# ---------------------------------------------------------------- scalars

def scalar_vector(value: float, device, skip: bool = False) -> torch.Tensor:
    """The float32 vector ``(value, skip)`` the kernels read their step
    size and skip flag from, made on ``device`` with fills only (no copy
    from the host, so the stream is never waited on)."""
    vec = torch.zeros(2, dtype=torch.float32, device=device)
    vec[:1].fill_(float(value))
    if skip:
        vec[1:].fill_(1.0)
    return vec


def _scalars(s, device) -> torch.Tensor:
    """``s`` as a scalar vector on ``device``: a float gets a fresh one."""
    if not isinstance(s, torch.Tensor):
        return scalar_vector(s, device)
    refuse_dtensor(s)
    if s.dtype != torch.float32 or s.shape != (2,) or s.device != torch.device(device):
        raise ValueError("the scalar vector must be float32 (value, skip) on the leaves' "
                         f"device {device}, got {s.dtype} {tuple(s.shape)} on {s.device}")
    return s


def _keep_if_skipped(skip, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``old`` where the step is skipped, else ``new``: a select, so a
    skipped step is bitwise."""
    return new if skip is None else torch.where(skip, old, new)


def _step_and_skip(s, device):
    """(step size, skip predicate or None) of a float or a scalar vector:
    the plain versions compute with the vector's 0-d entries, as f32."""
    if not isinstance(s, torch.Tensor):
        return s, None
    s = _scalars(s, device)
    return s[0], s[1] != 0


# ---------------------------------------------------------------- SGD (K1)

def fused_sgd_update_ref(w, g, m, lr, wd=0.0, momentum=0.0, nesterov=False) -> None:
    """Plain PyTorch SGD step, in place (optimizers.py:202-216 of the JAX
    package).  ``m`` is unused, and may be None, when momentum is 0.
    ``lr`` is a float or a scalar vector (its skip flag keeps w and m)."""
    lr, skip = _step_and_skip(lr, w.device)
    gt = g + wd * w
    if momentum > 0.0:
        m_new = m * momentum + gt
        step = gt + momentum * m_new if nesterov else m_new
        m.copy_(_keep_if_skipped(skip, m, m_new))
    else:
        step = gt
    w.copy_(_keep_if_skipped(skip, w, w - lr * step))


def fused_sgd_update_multi_ref(ws, gs, ms, lr, wd=0.0, momentum=0.0,
                               nesterov=False) -> None:
    """Plain PyTorch SGD step over a list of leaves: ``fused_sgd_update_ref``
    on each.  ``ms`` may be None when momentum is 0."""
    for w, g, m in zip(ws, gs, ms if ms is not None else [None] * len(ws)):
        fused_sgd_update_ref(w, g, m, lr, wd, momentum, nesterov)


# The multi-tensor launch's table (csrc/fused_optimizer.cu, SgdTable): at
# most SGD_TABLE_CAPACITY leaves a launch (kMaxLeaves there), each cut into
# chunks of SGD_CHUNK elements (a multiple of 4), one block a chunk.
SGD_TABLE_CAPACITY = 64
SGD_CHUNK = 16384


def sgd_launch_plan(numels):
    """The launches of one SGD step over leaves of ``numels`` elements: per
    launch a list of (leaf index, first chunk), leaves in order, zero-size
    leaves skipped, at most ``SGD_TABLE_CAPACITY`` leaves a launch, chunks
    counted from 0 in each launch.  The kernel runs one block per chunk
    and gives block b to the last leaf whose first chunk is at or before b."""
    launches, leaves, first = [], [], 0
    for i, n in enumerate(numels):
        if n == 0:
            continue
        if len(leaves) == SGD_TABLE_CAPACITY:
            launches.append(leaves)
            leaves, first = [], 0
        leaves.append((i, first))
        first += -(-n // SGD_CHUNK)
    if leaves:
        launches.append(leaves)
    return launches


def fused_sgd_update_multi(ws, gs, ms, lr, wd=0.0, momentum=0.0, nesterov=False) -> None:
    """One fused SGD step over a list of parameter leaves, updating each
    ``w`` (and ``m``) in place: one kernel launch per
    ``SGD_TABLE_CAPACITY`` leaves.  ``ms`` may be None when momentum is 0:
    no state is touched.  ``lr`` is a float or a scalar vector.  The table
    is built anew on every call, from the tensors' current addresses
    (gradients are fresh tensors each eager step); it is a kernel argument,
    so a CUDA graph that captured the launch keeps the addresses it saw,
    which stay right only because a replay writes its gradients to the same
    addresses of the graph's memory pool (runtime/step_graph.py)."""
    use_m = momentum > 0.0
    if ms is None:
        if use_m:
            raise ValueError("momentum > 0 needs a momentum buffer per leaf")
        ms = [None] * len(ws)
    if not len(ws) == len(gs) == len(ms):
        raise ValueError(f"leaf lists differ in length: {len(ws)}, {len(gs)}, {len(ms)}")
    if not ws:
        return
    rows = _leaf_rows(ws, gs, ms if use_m else [None] * len(ws))
    if ws[0].device.type == "cpu":
        fused_sgd_update_multi_ref(ws, gs, ms, lr, wd, momentum, nesterov)
        return
    lib = _lib()
    scalars = _scalars(lr, ws[0].device)
    with torch.cuda.device(ws[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for launch in sgd_launch_plan([row[3] for row in rows]):
            table = array.array("q")  # (w, g, m, n, first chunk) per leaf, as the C entry reads
            for i, first in launch:
                table.extend(rows[i])
                table.append(first)
            rc = lib.ff_fused_sgd_update_multi(
                ctypes.cast(table.buffer_info()[0], ctypes.POINTER(ctypes.c_int64)),
                len(launch), SGD_CHUNK, scalars.data_ptr(), wd, momentum,
                int(bool(nesterov)), stream)
            _build.raise_on(rc, "fused_sgd_update")
            fused_sgd_update.launches += 1


def fused_sgd_update(w, g, m, lr, wd=0.0, momentum=0.0, nesterov=False) -> None:
    """One fused SGD step on a parameter leaf, updating ``w`` and ``m`` in
    place: the multi-tensor launch over one leaf.  ``m`` may be None when
    momentum is 0: no state is touched."""
    fused_sgd_update_multi([w], [g], [m], lr, wd, momentum, nesterov)


fused_sgd_update.launches = 0


# --------------------------------------------------------------- Adam (K2)

def fused_adam_update_ref(w, g, m, v, alpha_t, wd=0.0, beta1=0.9, beta2=0.999,
                          eps=1e-8) -> None:
    """Plain PyTorch Adam step, in place (optimizers.py:275-284 of the JAX
    package); ``alpha_t`` carries the bias correction, and is a float or a
    scalar vector (its skip flag keeps w, m and v)."""
    alpha_t, skip = _step_and_skip(alpha_t, w.device)
    gt = g + wd * w
    m_new = beta1 * m + (1.0 - beta1) * gt
    v_new = beta2 * v + (1.0 - beta2) * gt * gt
    w_new = w - alpha_t * m_new / (torch.sqrt(v_new) + eps)
    m.copy_(_keep_if_skipped(skip, m, m_new))
    v.copy_(_keep_if_skipped(skip, v, v_new))
    w.copy_(_keep_if_skipped(skip, w, w_new))


def fused_adam_update(w, g, m, v, alpha_t, wd=0.0, beta1=0.9, beta2=0.999,
                      eps=1e-8) -> None:
    """One fused Adam step on a parameter leaf, updating ``w``, ``m`` and
    ``v`` in place; ``alpha_t`` is a float or a scalar vector."""
    _check(w, g, m, v)
    if w.device.type == "cpu":
        fused_adam_update_ref(w, g, m, v, alpha_t, wd, beta1, beta2, eps)
        return
    if w.numel() == 0:
        return
    scalars = _scalars(alpha_t, w.device)
    with torch.cuda.device(w.device):
        rc = _lib().ff_fused_adam_update(
            w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), w.numel(),
            scalars.data_ptr(), wd, beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "fused_adam_update")
    fused_adam_update.launches += 1


fused_adam_update.launches = 0
