"""Public wrapper of the RMSNorm kernel, for any leading shape, as
``repro.kernels.rmsnorm.ops.rmsnorm``.

A CUDA tensor goes to the hand-written Hopper kernel (``csrc/rmsnorm.cu``),
launched on the current stream.  A CPU tensor goes to the plain PyTorch
version (``ref.rmsnorm_ref``).  There is no other path: a CUDA input the
kernel does not take raises.

The scale may be float32 or bfloat16: the kernel reads float32, so a bf16
scale is cast first (d elements), as ``repro.models.layers.apply_norm``
casts it.

Under autograd (grad enabled and ``x`` or ``scale`` requiring it) a CUDA
call goes through ``RMSNormFn``: the same kernel forward, and the closed-form
backward in float32 as PyTorch ops (with rstd = rsqrt(mean(x²) + eps),
x̂ = x·rstd and s the scale: dx = rstd·(g·s − x̂·mean(g·s·x̂)), dscale =
Σ g·x̂).  The CPU path stays the plain version under plain autograd.

A ``DTensor`` x runs through ``local_map`` with its rows sharded as they
are and ``d`` whole (a shard of ``d`` is gathered first), the scale
replicated; the scale's gradient is then a partial sum over the mesh
dimensions that shard the rows.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .. import as_dtensor, is_dtensor, kernel_placements, on_card
from ..build import load
from .ref import rmsnorm_ref

# Launches of the CUDA kernel since the count was last set to 0.  The CPU
# path never counts.
launches = 0
_count_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load("rmsnorm")
        lib.rmsnorm_fwd.restype = ctypes.c_int
        lib.rmsnorm_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def rmsnorm_cuda(x, scale, eps: float = 1e-6) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors (no CPU path)."""
    global launches
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError("rmsnorm_cuda: x and scale must lie on one CUDA "
                         "device")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm: the CUDA kernel takes float32 or bfloat16 "
                        f"x, got {x.dtype}")
    d = x.shape[-1]
    if scale.dtype not in _DTYPE_CODES or tuple(scale.shape) != (d,):
        raise TypeError(f"rmsnorm: the CUDA kernel takes a float32 or "
                        f"bfloat16 scale of shape ({d},), got {scale.dtype} "
                        f"{tuple(scale.shape)}")
    x2 = x.reshape(-1, d)
    if x2.stride(1) != 1:
        raise ValueError("rmsnorm: the last dim must be contiguous")
    # The kernel reads a float32 scale; a bf16 one (bf16 weights) is cast
    # first, d elements, as the reference's apply_norm casts it.
    scale = scale.float().contiguous()
    N = x2.shape[0]
    y = torch.empty((N, d), dtype=x.dtype, device=x.device)
    if N == 0 or d == 0:
        return y.reshape(x.shape)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rmsnorm_fwd(x2.data_ptr(), y.data_ptr(), scale.data_ptr(),
                             _DTYPE_CODES[x.dtype], N, d, x2.stride(0),
                             y.stride(0), float(eps), stream)
    if rc != 0:
        raise RuntimeError("rmsnorm kernel launch failed: "
                           + lib.rmsnorm_error_string(rc).decode())
    with _count_lock:
        launches += 1
    return y.reshape(x.shape)


class RMSNormFn(torch.autograd.Function):
    """The kernel's forward with a closed-form backward.  Saves x and the
    scale; the backward recomputes the per-row rstd in float32."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_cuda(x, scale, eps)

    @staticmethod
    def backward(ctx, gy):
        x, scale = ctx.saved_tensors
        d = x.shape[-1]
        xf = x.reshape(-1, d).float()
        rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + ctx.eps)
        xhat = xf * rstd
        g = gy.reshape(-1, d).float()
        gs = g * scale.float()
        dx = rstd * (gs - xhat * (gs * xhat).mean(-1, keepdim=True))
        dscale = (g * xhat).sum(0)
        return dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype), None


def _rmsnorm_sharded(x, scale, eps: float):
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    rows = tuple(range(x.ndim - 1))
    xp = kernel_placements(x, rows)
    rep = (Replicate(),) * mesh.ndim
    dscale = tuple(Partial() if p.is_shard() else Replicate() for p in xp)
    fn = local_map(rmsnorm, out_placements=list(xp),
                   in_placements=(xp, rep, None),
                   in_grad_placements=(xp, dscale, None), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(x, as_dtensor(scale, mesh), eps)


def rmsnorm(x, scale, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,) -> x's shape and dtype.

    The CUDA kernel for CUDA tensors (through ``RMSNormFn`` where autograd
    needs the gradient), the plain version for CPU tensors; a ``DTensor``
    goes to either on each rank's shard."""
    if is_dtensor(x):
        return _rmsnorm_sharded(x, scale, eps)
    if not on_card(x):
        return rmsnorm_ref(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFn.apply(x, scale, eps)
    return rmsnorm_cuda(x, scale, eps)
