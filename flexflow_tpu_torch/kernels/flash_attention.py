"""Flash attention: hand-written CUDA kernels for Hopper, with their plain
PyTorch versions and the autograd function around them.

Replaces the Pallas TPU kernels of ``flexflow_tpu/kernels/flash_attention.py``:
``flash_fwd`` the forward ``_fwd_kernel``, ``flash_bwd_dkdv`` the
``_bwd_dkdv_kernel`` and ``flash_bwd_dq`` the ``_bwd_dq_kernel``.  The CUDA
source is ``csrc/flash_attention.cu``; it says what bounds the kernels and
how they are laid out.  It is built with ``nvcc`` for ``sm_90a`` at first
use (``kernels/_build.py``) and loaded with ``ctypes``.

Tensors are (B, H, S, D), float32 or bfloat16, contiguous; the logsumexp
``lse``, ``delta = rowsum(O * dO)`` and the lse cotangent ``g_lse`` are
(B, H, Sq) float32.  Causal masking is top-left (``q_idx >= k_idx``), as in
the TPU kernel.  The backward kernels take ``g_lse``:
``dS = p * (dP - delta + g_lse) * scale``, which the JAX package's VJP drops
(ROADMAP C1); ``None`` means zero.

Each wrapper refuses a ``DTensor`` (a caller on a mesh passes the local
shard, ``.to_local()``) and allocates its outputs with ``torch.empty``.
On a CUDA tensor
it launches its kernel on the current stream, raises if the launch was
refused, and adds one to its ``launches`` count.  On a CPU tensor it runs the
plain PyTorch version beside it (``*_ref``).  There is no fallback from one
to the other.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from ._build import refuse_dtensor

SOURCE = "flash_attention.cu"
NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (16, 32, 64, 128)  # compiled into csrc/flash_attention.cu

_lib_handle: Optional[ctypes.CDLL] = None
_plain = False


def build(force: bool = False) -> dict:
    """Compile ``csrc/flash_attention.cu`` into the build directory
    (``_build.build``: path, build seconds and the ptxas report)."""
    return _build.build(SOURCE, force=force)


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load(SOURCE)
        p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ff_flash_fwd.argtypes = [p, p, p, p, p, i32, i32, i32, i32, i32, f32, i32, p]
        lib.ff_flash_bwd_dkdv.argtypes = [p, p, p, p, p, p, p, p, p, i32, i32, i32, i32,
                                          i32, f32, i32, p]
        lib.ff_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, p, i32, i32, i32, i32, i32,
                                        f32, i32, p]
        for fn in (lib.ff_flash_fwd, lib.ff_flash_bwd_dkdv, lib.ff_flash_bwd_dq):
            fn.restype = i32
        _lib_handle = lib
    return _lib_handle


# ------------------------------------------------------------------ checks

def _check(q, k, v, do=None, rows=()) -> None:
    """Operands every version takes: (B, H, S, D) q/k/v (and dO like q) of
    one supported dtype, on one CPU or CUDA device, contiguous; per-row
    (B, H, Sq) float32 tensors in ``rows`` (None allowed)."""
    mats = [q, k, v] + ([do] if do is not None else [])
    refuse_dtensor(*mats, *rows)
    for t in mats:
        if t.dim() != 4:
            raise ValueError(f"attention operands are (B, H, S, D), got shape {tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise TypeError(f"attention operands must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"attention operands differ in dtype: {t.dtype} vs {q.dtype}")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "do not match")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} does not match q {tuple(q.shape)}")
    for t in rows:
        if t is not None and (t.dtype != torch.float32 or t.shape != q.shape[:3]):
            raise ValueError(f"per-row operands must be float32 {tuple(q.shape[:3])}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for t in mats + [t for t in rows if t is not None]:
        if not t.is_contiguous():
            raise ValueError("attention operands must be contiguous")
        if t.device != q.device:
            raise ValueError(f"operands on different devices: {t.device} vs {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def check_kernel_operands(q: torch.Tensor, *others: torch.Tensor) -> None:
    """What the CUDA kernels add to ``_check``: a compiled head dim, sizes
    that fit their int32 indexing, and 16-byte aligned operands (the bf16
    kernels copy rows in 16-byte words)."""
    d = q.shape[3]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} is not compiled into the flash kernels "
                         f"(compiled: {KERNEL_HEAD_DIMS})")
    for t in (q, *others):
        if t.numel() >= 2**31:
            raise ValueError("attention operand too large for the kernels' int32 indexing")
        if t.data_ptr() % 16:
            raise ValueError("attention operands must be 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ------------------------------------------------------------------ plain versions

def _scores(q, k, scale, causal):
    """f32 scores q k^T * scale; masked entries (k_idx > q_idx when causal,
    top-left as the kernel) are -inf."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, -math.inf)
    return s


def flash_fwd_ref(q, k, v, scale: float, causal: bool):
    """Plain PyTorch version of the forward kernel: (O, lse).  A row that
    sees no key gives O = 0 and lse = -1e30."""
    if k.shape[2] == 0:
        return torch.zeros_like(q), q.new_full(q.shape[:3], NEG_INF, dtype=torch.float32)
    s = _scores(q, k, scale, causal)
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    empty = l == 0
    o = torch.matmul(p, v.float()) / torch.where(empty, torch.ones_like(l), l)
    lse = torch.where(empty, torch.full_like(l, NEG_INF), m + torch.log(l))
    return o.to(q.dtype), lse.squeeze(-1)


def _probs_and_dscores(q, k, v, do, lse, delta, g_lse, scale, causal):
    p = torch.exp(_scores(q, k, scale, causal) - lse.unsqueeze(-1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    dd = delta if g_lse is None else delta - g_lse
    return p, p * (dp - dd.unsqueeze(-1)) * scale


def flash_bwd_dkdv_ref(q, k, v, do, lse, delta, g_lse, scale: float, causal: bool):
    """Plain PyTorch version of the dK/dV kernel: (dK, dV)."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, g_lse, scale, causal)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, g_lse, scale: float, causal: bool):
    """Plain PyTorch version of the dQ kernel."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, g_lse, scale, causal)
    return torch.matmul(ds, k.float()).to(q.dtype)


# ------------------------------------------------------------------ kernels

def flash_fwd(q, k, v, scale: float, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward (K3): O in q's dtype and lse (B, H, Sq) float32."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, scale, causal)
    check_kernel_operands(q, k, v)
    b, h, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().ff_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b * h, sq, k.shape[2], d, DTYPES[q.dtype], scale, int(bool(causal)),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_bwd_dkdv(q, k, v, do, lse, delta, g_lse, scale: float, causal: bool):
    """dK and dV (K4) for the output cotangent ``do`` and the lse
    cotangent ``g_lse`` (None: zero); ``delta = rowsum(O * dO)``."""
    _check(q, k, v, do, (lse, delta, g_lse))
    if q.device.type == "cpu":
        return flash_bwd_dkdv_ref(q, k, v, do, lse, delta, g_lse, scale, causal)
    check_kernel_operands(q, k, v, do)
    b, h, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = _lib().ff_flash_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(g_lse), dk.data_ptr(), dv.data_ptr(), b * h, sq,
            k.shape[2], d, DTYPES[q.dtype], scale, int(bool(causal)),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "flash_bwd_dkdv")
    flash_bwd_dkdv.launches += 1
    return dk, dv


flash_bwd_dkdv.launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, g_lse, scale: float, causal: bool):
    """dQ (K5) for the same cotangents as ``flash_bwd_dkdv``."""
    _check(q, k, v, do, (lse, delta, g_lse))
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, g_lse, scale, causal)
    check_kernel_operands(q, k, v, do)
    b, h, sq, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib().ff_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(g_lse), dq.data_ptr(), b * h, sq, k.shape[2], d,
            DTYPES[q.dtype], scale, int(bool(causal)),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


# ------------------------------------------------------------------ autograd

class _Flash(torch.autograd.Function):
    """The counterpart of the JAX package's ``_flash`` custom VJP
    (flash_attention.py:309-320), with the lse cotangent kept."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, plain):
        fwd = flash_fwd_ref if plain else flash_fwd
        o, lse = fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal, ctx.plain = scale, causal, plain
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None and g_lse is None:
            return None, None, None, None, None, None
        do = torch.zeros_like(o) if do is None else do.to(o.dtype).contiguous()
        if g_lse is not None:
            g_lse = g_lse.float().contiguous()
        delta = (o.float() * do.float()).sum(-1)
        dkdv, dqf = ((flash_bwd_dkdv_ref, flash_bwd_dq_ref) if ctx.plain
                     else (flash_bwd_dkdv, flash_bwd_dq))
        dk, dv = dkdv(q, k, v, do, lse, delta, g_lse, ctx.scale, ctx.causal)
        dq = dqf(q, k, v, do, lse, delta, g_lse, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


@contextlib.contextmanager
def plain_versions():
    """Route ``flash_attention`` through the plain versions on any device,
    to hold a model's kernel path against its plain path."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def flash_attention(q, k, v, *, causal: bool = False, scale: Optional[float] = None,
                    return_lse: bool = False):
    """Fused attention softmax(q k^T * scale [+ causal mask]) v over
    (B, H, S, D); with ``return_lse`` also the per-row logsumexp (B, H, Sq),
    whose gradient flows (unlike the JAX package's, ROADMAP C1)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = _Flash.apply(q, k, v, float(scale), bool(causal), _plain)
    return (o, lse) if return_lse else o


def mha_reference(q, k, v, *, causal: bool = False, scale: Optional[float] = None):
    """Unfused reference attention (a numerics oracle).  Its causal mask is
    bottom-right (``tril(k = Sk - Sq)``), as the JAX package's; it agrees
    with the kernels' top-left mask when Sq == Sk (ROADMAP C2)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(sk - sq)
        s = s.masked_fill(~keep, NEG_INF)
    return torch.matmul(torch.softmax(s, -1), v.float()).to(q.dtype)
