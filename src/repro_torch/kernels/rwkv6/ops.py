"""Public wrapper of the WKV6 kernels, in the (B, T, H, hd) layout of
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

Under autograd (grad enabled and an input requiring it) a call goes
through ``WKV6Fn``: the forward also keeps the state before every
``ref.CHUNK``-th step (``repro_torch::wkv6_fwd_save``), and the backward
is the hand-written kernel of ``csrc/wkv6_bwd.cu``
(``repro_torch::wkv6_bwd``), which starts each chunk of time from its kept
state; a head's blocks form a thread block cluster and add their partial
sums in shared memory.  It too stages time by ``cp.async`` when every
input is 16-byte aligned and by plain loads otherwise (``uses_ring_bwd``).
On a CPU tensor both directions are the plain versions
(``ref.wkv6_ref_saving``, ``ref.wkv6_bwd_ref``).

``DTensor`` inputs run through ``local_map`` with the batch or the heads
sharded (u and the state follow the heads, the state the batch too) and
time and hd whole; any other placement is redistributed first.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from .. import (as_dtensor, direct_launch, is_dtensor, kernel_placements,
               on_card)
from ..build import load
from .ref import n_chunks, wkv6_bwd_ref, wkv6_ref, wkv6_ref_saving

# Launches of the CUDA kernels since the counts were last set to 0: the
# forward (with or without kept states), those of them with T = 1 (decode
# steps), and the backward.  The CPU path never counts.
launches = 0
launches_t1 = 0
launches_bwd = 0
_count_lock = threading.Lock()

SUPPORTED_HEAD_DIMS = (16, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_bwd_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load("wkv6")
        for fn in (lib.wkv6_fwd, lib.wkv6_uses_ring):
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
        lib.wkv6_error_string.restype = ctypes.c_char_p
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _bwd_library():
    global _bwd_lib
    if _bwd_lib is None:
        lib = load("wkv6_bwd")
        args = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
        for fn, extra in ((lib.wkv6_bwd, []), (lib.wkv6_bwd_uses_ring, []),
                          (lib.wkv6_bwd_skipping, [ctypes.c_int])):
            fn.restype = ctypes.c_int
            fn.argtypes = args + extra
        lib.wkv6_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.wkv6_bwd_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.wkv6_bwd_error_string.restype = ctypes.c_char_p
        lib.wkv6_bwd_error_string.argtypes = [ctypes.c_int]
        _bwd_lib = lib
    return _bwd_lib


def _check(r, k, v, w, u, s0=None) -> None:
    """Shapes; s0 None leaves the state out (the backward's check)."""
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
    if s0 is not None and tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"wkv6: s0 must be (B, H, hd, hd), got "
                         f"{tuple(s0.shape)}")


def _heads_major(x):
    """(B, T, H, hd) -> (B * H, T, hd)."""
    B, T, H, hd = x.shape
    return x.transpose(1, 2).reshape(B * H, T, hd)


def _per_head(u, B):
    """u (H, hd) -> (B * H, hd)."""
    return u[None].expand(B, *u.shape).reshape(B * u.shape[0], u.shape[1])


def wkv6_plain(r, k, v, w, u, s0):
    """The plain version in the (B, T, H, hd) layout, on any device."""
    _check(r, k, v, w, u, s0)
    B, T, H, hd = r.shape
    y, sT = wkv6_ref(*map(_heads_major, (r, k, v, w)), _per_head(u, B),
                     s0.reshape(B * H, hd, hd))
    y = y.reshape(B, H, T, hd).transpose(1, 2).reshape(B, T, H * hd)
    return y, sT.reshape(B, H, hd, hd)


def wkv6_plain_saving(r, k, v, w, u, s0):
    """``wkv6_plain`` that also returns the states the backward starts
    from: (y, sT, states (B, H, n_chunks(T), hd, hd) float32)."""
    _check(r, k, v, w, u, s0)
    B, T, H, hd = r.shape
    y, sT, states = wkv6_ref_saving(*map(_heads_major, (r, k, v, w)),
                                    _per_head(u, B),
                                    s0.reshape(B * H, hd, hd))
    y = y.reshape(B, H, T, hd).transpose(1, 2).reshape(B, T, H * hd)
    return (y, sT.reshape(B, H, hd, hd),
            states.reshape(B, H, n_chunks(T), hd, hd))


def wkv6_bwd_plain(r, k, v, w, u, states, dy, dsT=None):
    """The plain backward in the (B, T, H, hd) layout, on any device: dy
    (B, T, H, hd) or (B, T, H * hd), dsT (B, H, hd, hd) or None.  Returns
    (dr, dk, dv (B, T, H, hd) in r's, k's and v's dtypes; dw (B, T, H, hd),
    du (H, hd) and ds0 (B, H, hd, hd) float32); du sums over the batch."""
    B, T, H, hd = r.shape
    g = wkv6_bwd_ref(*map(_heads_major, (r, k, v, w)), _per_head(u, B),
                     states.reshape(B * H, -1, hd, hd),
                     _heads_major(dy.reshape(r.shape)),
                     None if dsT is None else dsT.reshape(B * H, hd, hd))
    dr, dk, dv, dw = (x.reshape(B, H, T, hd).transpose(1, 2) for x in g[:4])
    return (dr, dk, dv, dw, g[4].reshape(B, H, hd).sum(0),
            g[5].reshape(B, H, hd, hd))


def _check_cuda(r, k, v, w, u, s0=None) -> None:
    """What the kernels take, from shapes, types and devices alone (a fake
    tensor's too); s0 None leaves the state out."""
    _check(r, k, v, w, u, s0)
    state = () if s0 is None else (s0,)
    if r.device.type != "cuda" or any(t.device != r.device
                                      for t in (k, v, w, u, *state)):
        raise ValueError("wkv6_cuda: every tensor must lie on one CUDA "
                         "device")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPE_CODES:
        raise TypeError(f"wkv6: the CUDA kernel takes r, k, v of one type, "
                        f"float32 or bfloat16; got {r.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.dtype != torch.float32 for t in (w, *state)):
        raise TypeError(f"wkv6: the decay w and the state s0 must be "
                        f"float32, got {w.dtype} and "
                        f"{state[0].dtype if state else None}")
    B, T, H, hd = r.shape
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"wkv6: the CUDA kernel takes hd in "
                         f"{SUPPORTED_HEAD_DIMS}, got {hd}")
    if min(t.stride(3) for t in (r, k, v, w)) != 1:
        raise ValueError("wkv6: the head dim must be contiguous")
    if B * H == 0:
        raise ValueError("wkv6: empty batch or head count")


def _strides(*tensors) -> tuple:
    """The (B, T, H) element strides of each (B, T, H, hd) tensor."""
    return tuple(s for t in tensors for s in t.stride()[:3])


def _kernel_args(r, k, v, w, u, s0, save: bool = False):
    """The outputs (y, sT, and with ``save`` the kept states), the C
    function's arguments but the stream, and the contiguous u and s0 those
    arguments point into, to be kept alive until the launch; for checked
    CUDA inputs."""
    B, T, H, hd = r.shape
    u = u.float().contiguous()
    s0 = s0.contiguous()
    y = torch.empty((B, T, H, hd), dtype=r.dtype, device=r.device)
    sT = torch.empty_like(s0)
    states = (torch.empty((B, H, n_chunks(T), hd, hd), dtype=torch.float32,
                          device=r.device) if save else None)
    outs = (y, sT) + ((states,) if save else ())
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
            states.data_ptr() if save else None,
            _DTYPE_CODES[r.dtype], B, T, H, hd,
            *_strides(r, k, v, w, y))
    return outs, args, (u, s0)


def uses_ring(r, k, v, w, u, s0) -> bool:
    """Whether ``wkv6_cuda`` on these CUDA inputs fills the kernel's ring
    of chunk buffers by asynchronous copies (T > 1, every input 16-byte
    aligned) or by plain loads.  Launches nothing."""
    _check_cuda(r, k, v, w, u, s0)
    _, args, _ = _kernel_args(r, k, v, w, u, s0)
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


def wkv6_cuda_saving(r, k, v, w, u, s0):
    """``wkv6_cuda`` that also keeps the state before every ``ref.CHUNK``-th
    step, through ``repro_torch::wkv6_fwd_save``: (y (B, T, H * hd), sT,
    states (B, H, n_chunks(T), hd, hd) float32).  y and sT are bitwise
    those of ``wkv6_cuda``."""
    _check_cuda(r, k, v, w, u, s0)
    B, T, H, hd = r.shape
    launch = (_launch_saving if direct_launch(r, k, v, w, u, s0)
              else wkv6_fwd_save)
    y, sT, states = launch(r, k, v, w, u, s0)
    return y.reshape(B, T, H * hd), sT, states


def _forward(r, k, v, w, u, s0, save: bool):
    global launches, launches_t1
    outs, args, _alive = _kernel_args(r, k, v, w, u, s0, save)
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
    return outs


def _launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor,
            s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch on checked inputs: y (B, T, H, hd), sT (B, H, hd, hd)."""
    return _forward(r, k, v, w, u, s0, save=False)


def _launch_saving(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch on checked inputs that also keeps the states: y, sT and
    states (B, H, n_chunks(T), hd, hd)."""
    return _forward(r, k, v, w, u, s0, save=True)


wkv6_fwd = torch.library.custom_op("repro_torch::wkv6_fwd", _launch,
                                   mutates_args=(), device_types="cuda")
wkv6_fwd_save = torch.library.custom_op(
    "repro_torch::wkv6_fwd_save", _launch_saving, mutates_args=(),
    device_types="cuda")


@wkv6_fwd.register_fake
def _(r, k, v, w, u, s0):
    return r.new_empty(r.shape), s0.new_empty(s0.shape)


@wkv6_fwd_save.register_fake
def _(r, k, v, w, u, s0):
    B, T, H, hd = r.shape
    return (r.new_empty(r.shape), s0.new_empty(s0.shape),
            s0.new_empty((B, H, n_chunks(T), hd, hd)))


def _check_bwd_cuda(r, k, v, w, u, states, dy, dsT) -> None:
    B, T, H, hd = r.shape
    _check_cuda(r, k, v, w, u)
    if tuple(states.shape) != (B, H, n_chunks(T), hd, hd) \
            or states.dtype != torch.float32:
        raise ValueError(f"wkv6_bwd: states must be float32 "
                         f"{(B, H, n_chunks(T), hd, hd)}, got {states.dtype} "
                         f"{tuple(states.shape)}")
    if tuple(dy.shape) != tuple(r.shape) or dy.dtype != r.dtype \
            or dy.stride(3) != 1:
        raise ValueError(f"wkv6_bwd: dy must be {tuple(r.shape)} {r.dtype} "
                         f"with a contiguous head dim, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    if dsT is not None and (tuple(dsT.shape) != (B, H, hd, hd)
                            or dsT.dtype != torch.float32):
        raise ValueError(f"wkv6_bwd: dsT must be float32 {(B, H, hd, hd)}")
    if any(t.device != r.device for t in (states, dy)
           + (() if dsT is None else (dsT,))):
        raise ValueError("wkv6_bwd: every tensor must lie on one CUDA "
                         "device")


def wkv6_bwd_cuda(r, k, v, w, u, states, dy, dsT=None):
    """The backward kernel on CUDA tensors (no CPU path), through the
    ``repro_torch::wkv6_bwd`` operator: ``wkv6_bwd_plain``'s arguments and
    results, from the states of ``wkv6_cuda_saving``."""
    dy = dy.reshape(r.shape).to(r.dtype)
    if dy.stride(3) != 1:
        dy = dy.contiguous()
    _check_bwd_cuda(r, k, v, w, u, states, dy, dsT)
    launch = (_launch_bwd if direct_launch(r, k, v, w, u, states, dy, dsT)
              else wkv6_bwd)
    return launch(r, k, v, w, u, states, dy, dsT)


def _bwd_args(r, k, v, w, u, states, dy, dsT):
    """The outputs (dr, dk, dv, dw, du, ds0), the C function's arguments
    but the stream, and the tensors those arguments point into, to be kept
    alive until the launch; for checked CUDA inputs."""
    B, T, H, hd = r.shape
    lib = _bwd_library()
    u = u.float().contiguous()
    states = states.contiguous()
    dsT = None if dsT is None else dsT.contiguous()
    dr, dk, dv = (torch.empty((B, T, H, hd), dtype=r.dtype, device=r.device)
                  for _ in range(3))
    dw = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    du = torch.empty((H, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    scratch = torch.empty(lib.wkv6_bwd_scratch_floats(B, T, H, hd),
                          dtype=torch.float32, device=r.device)
    args = (*(t.data_ptr() for t in (r, k, v, w, u, states, dy)),
            None if dsT is None else dsT.data_ptr(),
            *(t.data_ptr() for t in (dr, dk, dv, dw, du, ds0, scratch)),
            _DTYPE_CODES[r.dtype], B, T, H, hd, *_strides(r, k, v, w, dy))
    return (dr, dk, dv, dw, du, ds0), args, (u, states, dsT, scratch)


def _run_bwd(fn, r, args, *extra) -> None:
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(*args, stream, *extra)
    if rc != 0:
        raise RuntimeError("wkv6 backward kernel launch failed: "
                           + _bwd_library().wkv6_bwd_error_string(rc).decode())


def uses_ring_bwd(r, k, v, w, u, states, dy, dsT=None) -> bool:
    """Whether ``wkv6_bwd_cuda`` on these CUDA inputs stages time by
    ``cp.async`` (every input 16-byte aligned) or by plain loads.
    Launches nothing."""
    dy = dy.reshape(r.shape)
    _check_bwd_cuda(r, k, v, w, u, states, dy, dsT)
    _, args, _alive = _bwd_args(r, k, v, w, u, states, dy, dsT)
    return bool(_bwd_library().wkv6_bwd_uses_ring(*args, None))


def wkv6_bwd_cuda_skipping(r, k, v, w, u, states, dy, dsT, skip: int):
    """For timing the backward kernel's parts: one launch with its walk
    (the consumers' recompute and walk and the dv warp's sums; ``skip``
    1), its epilogue's sums and stores (2) or both (3) left out, every
    hand-over still made.  Its outputs are not the gradients, and it is
    not counted in ``launches_bwd``."""
    dy = dy.reshape(r.shape)
    _check_bwd_cuda(r, k, v, w, u, states, dy, dsT)
    outs, args, _alive = _bwd_args(r, k, v, w, u, states, dy, dsT)
    _run_bwd(_bwd_library().wkv6_bwd_skipping, r, args, skip)
    return outs


def _launch_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, states: torch.Tensor,
                dy: torch.Tensor, dsT: Optional[torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backward (two kernels) on checked inputs: dr, dk, dv (B, T, H,
    hd) in r's dtype, dw (B, T, H, hd), du (H, hd), ds0 (B, H, hd, hd)."""
    global launches_bwd
    outs, args, _alive = _bwd_args(r, k, v, w, u, states, dy, dsT)
    _run_bwd(_bwd_library().wkv6_bwd, r, args)
    with _count_lock:
        launches_bwd += 1
    return outs


wkv6_bwd = torch.library.custom_op("repro_torch::wkv6_bwd", _launch_bwd,
                                   mutates_args=(), device_types="cuda")


@wkv6_bwd.register_fake
def _(r, k, v, w, u, states, dy, dsT):
    B, T, H, hd = r.shape
    f32 = dict(dtype=torch.float32)
    return (r.new_empty(r.shape), r.new_empty(r.shape), r.new_empty(r.shape),
            r.new_empty(r.shape, **f32), r.new_empty((H, hd), **f32),
            r.new_empty((B, H, hd, hd), **f32))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def cost(r, k, v, w, u, s0, out) -> tuple:
    """(flops, bytes) of one forward launch, for ``launch.hlostats``:
    5·hd² float32 operations a token and head (r^T S, then w S + k v^T),
    and each operand (the kept states too) read or written once."""
    B, T, H, hd = r.shape
    return 5 * hd * hd * B * T * H, _nbytes(r, k, v, w, u, s0, *out)


def cost_bwd(r, k, v, w, u, states, dy, dsT, out) -> tuple:
    """(flops, bytes) of one backward, for ``launch.hlostats``: 13·hd²
    float32 operations a token and head (the recompute's w S + k v, then
    S dy, G v, G ⊙ S, G k and w G + r dy), and each operand, the kept
    states included, read or written once."""
    B, T, H, hd = r.shape
    return 13 * hd * hd * B * T * H, _nbytes(r, k, v, w, u, states, dy, dsT,
                                             *out)


class WKV6Fn(torch.autograd.Function):
    """The WKV6 recurrence with its backward: the kernels on CUDA tensors
    (the forward keeps the state every ``ref.CHUNK`` steps), the plain
    versions on CPU tensors.  Saves r, k, v, w, u and the kept states."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        forward = wkv6_cuda_saving if on_card(r) else wkv6_plain_saving
        y, sT, states = forward(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, states)
        ctx.s0_dtype = s0.dtype
        ctx.set_materialize_grads(False)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        r, k, v, w, u, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        backward = wkv6_bwd_cuda if on_card(r) else wkv6_bwd_plain
        grads = backward(r, k, v, w, u, states, dy, dsT)
        dtypes = (r.dtype, k.dtype, v.dtype, w.dtype, u.dtype, ctx.s0_dtype)
        return tuple(g.to(dt) if need else None for g, dt, need
                     in zip(grads, dtypes, ctx.needs_input_grad))


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

    The CUDA kernel for CUDA tensors, the plain version for CPU tensors,
    through ``WKV6Fn`` where autograd needs a gradient; a ``DTensor`` goes
    to either on each rank's shard."""
    if is_dtensor(r):
        return _wkv6_sharded(r, k, v, w, u, s0)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, w, u, s0)):
        return WKV6Fn.apply(r, k, v, w, u, s0)
    if not on_card(r):
        return wkv6_plain(r, k, v, w, u, s0)
    return wkv6_cuda(r, k, v, w, u, s0)
