"""Public wrapper of the WKV6 kernel, in the (B, T, H, hd) layout of
``repro.kernels.rwkv6.ops.wkv6``.

A CUDA tensor goes to the hand-written Hopper kernel (``csrc/wkv6.cu``),
launched on the current stream; it reads the (B, T, H, hd) layout through
strides, so no head-major copy is made.  The kernel stages time through a
ring of chunk buffers filled by asynchronous copies (``cp.async``) when
T > 1 and every input is 16-byte aligned, and by plain loads otherwise
(decode's T = 1, unaligned views); ``uses_ring`` tells which.  A CPU
tensor goes to the plain PyTorch version (``ref.wkv6_ref``).  There is no
other path: a CUDA input the kernel does not take raises.  The launch is the operator
``repro_torch::wkv6_fwd`` (``torch.library.custom_op``), whose fake gives
the outputs' shapes: a fake CUDA tensor (the dry run's,
``launch.dryrun``) passes through it and launches nothing, and
``launch.hlostats`` counts it as one kernel by ``cost``, never as the
plain version's per-step loop; an eager call on plain tensors with no
dispatch mode active launches directly (``kernels.direct_launch``).

``DTensor`` inputs run through ``local_map`` with the batch or the heads
sharded (u and the state follow the heads, the state the batch too) and
time and hd whole; any other placement is redistributed first.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .. import (as_dtensor, direct_launch, is_dtensor, kernel_placements,
               on_card, refuse_grad)
from ..build import load
from .ref import wkv6_ref

# Launches of the CUDA kernel since the count was last set to 0, and those
# of them with T = 1 (decode steps).  The CPU path never counts.
launches = 0
launches_t1 = 0
_count_lock = threading.Lock()

SUPPORTED_HEAD_DIMS = (16, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load("wkv6")
        for fn in (lib.wkv6_fwd, lib.wkv6_uses_ring):
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
        lib.wkv6_error_string.restype = ctypes.c_char_p
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4:
        raise ValueError("wkv6: r, k, v, w must be (B, T, H, hd)")
    B, _, H, hd = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"wkv6: {name} {tuple(t.shape)} does not match "
                             f"r {tuple(r.shape)}")
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"wkv6: u must be (H, hd) = ({H}, {hd}), got "
                         f"{tuple(u.shape)}")
    if tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"wkv6: s0 must be (B, H, hd, hd), got "
                         f"{tuple(s0.shape)}")


def wkv6_plain(r, k, v, w, u, s0):
    """The plain version in the (B, T, H, hd) layout, on any device."""
    _check(r, k, v, w, u, s0)
    B, T, H, hd = r.shape
    def flat(x):
        return x.transpose(1, 2).reshape(B * H, T, hd)
    y, sT = wkv6_ref(flat(r), flat(k), flat(v), flat(w),
                     u[None].expand(B, H, hd).reshape(B * H, hd),
                     s0.reshape(B * H, hd, hd))
    y = y.reshape(B, H, T, hd).transpose(1, 2).reshape(B, T, H * hd)
    return y, sT.reshape(B, H, hd, hd)


def _check_cuda(r, k, v, w, u, s0) -> None:
    """What the kernel takes, from shapes, types and devices alone (a fake
    tensor's too)."""
    _check(r, k, v, w, u, s0)
    if r.device.type != "cuda" or any(t.device != r.device
                                      for t in (k, v, w, u, s0)):
        raise ValueError("wkv6_cuda: every tensor must lie on one CUDA "
                         "device")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPE_CODES:
        raise TypeError(f"wkv6: the CUDA kernel takes r, k, v of one type, "
                        f"float32 or bfloat16; got {r.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if w.dtype != torch.float32 or s0.dtype != torch.float32:
        raise TypeError(f"wkv6: the decay w and the state s0 must be "
                        f"float32, got {w.dtype} and {s0.dtype}")
    B, T, H, hd = r.shape
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"wkv6: the CUDA kernel takes hd in "
                         f"{SUPPORTED_HEAD_DIMS}, got {hd}")
    if min(t.stride(3) for t in (r, k, v, w)) != 1:
        raise ValueError("wkv6: the head dim must be contiguous")
    if B * H == 0:
        raise ValueError("wkv6: empty batch or head count")


def _kernel_args(r, k, v, w, u, s0):
    """The outputs (y, sT), the C function's arguments but the stream, and
    the contiguous u and s0 those arguments point into, to be kept alive
    until the launch; for checked CUDA inputs."""
    B, T, H, hd = r.shape
    u = u.float().contiguous()
    s0 = s0.contiguous()
    y = torch.empty((B, T, H, hd), dtype=r.dtype, device=r.device)
    sT = torch.empty_like(s0)
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
            _DTYPE_CODES[r.dtype], B, T, H, hd,
            r.stride(0), r.stride(1), r.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            w.stride(0), w.stride(1), w.stride(2),
            y.stride(0), y.stride(1), y.stride(2))
    return y, sT, args, (u, s0)


def uses_ring(r, k, v, w, u, s0) -> bool:
    """Whether ``wkv6_cuda`` on these CUDA inputs fills the kernel's ring
    of chunk buffers by asynchronous copies (T > 1, every input 16-byte
    aligned) or by plain loads.  Launches nothing."""
    _check_cuda(r, k, v, w, u, s0)
    _, _, args, _ = _kernel_args(r, k, v, w, u, s0)
    return bool(_library().wkv6_uses_ring(*args, None))


def wkv6_cuda(r, k, v, w, u, s0):
    """The Hopper kernel on CUDA tensors (no CPU path), through the
    ``repro_torch::wkv6_fwd`` operator: a fake CUDA tensor gets the
    outputs' shapes and launches nothing."""
    _check_cuda(r, k, v, w, u, s0)
    B, T, H, hd = r.shape
    launch = _launch if direct_launch(r, k, v, w, u, s0) else wkv6_fwd
    y, sT = launch(r, k, v, w, u, s0)
    return y.reshape(B, T, H * hd), sT


def _launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor,
            s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch on checked inputs: y (B, T, H, hd), sT (B, H, hd, hd)."""
    global launches, launches_t1
    y, sT, args, _alive = _kernel_args(r, k, v, w, u, s0)
    lib = _library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.wkv6_fwd(*args, stream)
    if rc != 0:
        raise RuntimeError("wkv6 kernel launch failed: "
                           + lib.wkv6_error_string(rc).decode())
    with _count_lock:
        launches += 1
        launches_t1 += r.shape[1] == 1
    return y, sT


wkv6_fwd = torch.library.custom_op("repro_torch::wkv6_fwd", _launch,
                                   mutates_args=(), device_types="cuda")


@wkv6_fwd.register_fake
def _(r, k, v, w, u, s0):
    return r.new_empty(r.shape), s0.new_empty(s0.shape)


def cost(r, k, v, w, u, s0, out) -> tuple:
    """(flops, bytes) of one launch, for ``launch.hlostats``: 5·hd² float32
    operations a token and head (r^T S, then w S + k v^T), and each
    operand read or written once."""
    B, T, H, hd = r.shape
    nbytes = sum(t.numel() * t.element_size()
                 for t in (r, k, v, w, u, s0, *out))
    return 5 * hd * hd * B * T * H, nbytes


def _wkv6_sharded(r, k, v, w, u, s0):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = r.device_mesh
    pl = kernel_placements(r, (0, 2))

    def follow(batch, heads, other=Replicate()):
        return tuple(batch if p.is_shard(0) else heads if p.is_shard(2)
                     else other for p in pl)
    up = follow(Replicate(), Shard(0))
    sp = follow(Shard(0), Shard(1))
    fn = local_map(wkv6, out_placements=(pl, sp),
                   in_placements=(pl, pl, pl, pl, up, sp),
                   in_grad_placements=(pl, pl, pl, pl,
                                       follow(Partial(), Shard(0)), sp),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(*(as_dtensor(t, mesh) for t in (r, k, v, w, u, s0)))


def wkv6(r, k, v, w, u, s0):
    """r/k/v/w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd) float32.
    Returns (y (B, T, H*hd) in r's dtype, s_final (B, H, hd, hd) float32).

    The CUDA kernel for CUDA tensors, the plain version for CPU tensors; a
    ``DTensor`` goes to either on each rank's shard."""
    if is_dtensor(r):
        return _wkv6_sharded(r, k, v, w, u, s0)
    if not on_card(r):
        return wkv6_plain(r, k, v, w, u, s0)
    refuse_grad("wkv6", "rwkv6 trains on the CPU only until the recurrence "
                "has one", r, k, v, w, u, s0)
    return wkv6_cuda(r, k, v, w, u, s0)
