"""Public wrapper of the norm-shift-mix kernel: rwkv6's LayerNorm, token
shift and static mixes at one site of a block, in one pass.

    outs, new_shift = norm_shift_mix(x, shift, scale, bias, mixes, eps)

x (B, S, d) is the residual stream, ``shift`` (B, d) float32 the previous
chunk's last normalised row, ``scale`` and ``bias`` (d) the LayerNorm's
parameters, ``mixes`` K (d,) mix vectors (K <= 5: the time mix's r, k, v,
g and w, or the channel mix's k and r).  ``outs`` are K mixed inputs (B, S,
d) in x's dtype, ``new_shift`` (B, d) float32 the normalised last row.
Row by row, with h_t = LN(x_t) in x's dtype and h_{-1} = shift in it:
out_{i,t} = h_{t-1} + (h_t - h_{t-1}) * m_i, m_i in x's dtype.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/norm_shift_mix.cu``), launched on the current stream: one launch
whatever K and S (decode is S = 1), the mixes computed in float32 and
rounded once.  A CPU tensor goes to the plain version (``ref``), bit for
bit the eager composition the blocks ran before the kernel, under plain
autograd where a gradient is needed.  A CUDA input the kernel does not
take raises.

Under autograd (grad enabled and an input requiring it: training) a CUDA
call goes through ``NormShiftMixFn``: the same kernel forward, and a
closed-form backward in float32 as PyTorch ops.  With x̂ = (x - mu)·rstd,
h = T(x̂·scale + bias), h_prev its shift and g_i the gradient of mix i:
dh_t = Σ_i g_{i,t}·m_i + Σ_i g_{i,t+1}·(1 - m_i) (plus the new shift's
gradient at t = S - 1), dshift = Σ_i g_{i,0}·(1 - m_i), dm_i =
Σ g_i·(h - h_prev), dscale = Σ dh·x̂, dbias = Σ dh, and dx = rstd·(dy -
mean(dy) - x̂·mean(dy·x̂)) with dy = dh·scale (the rounding to T passes
the gradient straight through).  The launch is
the operator ``repro_torch::norm_shift_mix`` (``torch.library.custom_op``),
whose fake gives the outputs' shapes: a fake CUDA tensor (the dry run's)
passes through it and launches nothing, and ``launch.hlostats`` counts it
as one kernel by ``cost``; an eager call on plain tensors with no dispatch
mode active launches directly (``kernels.direct_launch``).

A ``DTensor`` x runs through ``local_map`` with its batch sharded as it is
and S and d whole (a shard of either is gathered first); the shift follows
the batch, the parameters are replicated.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .. import (as_dtensor, direct_launch, is_dtensor, kernel_placements,
               on_card)
from ..build import load
from .ref import norm_shift_mix_ref

# Launches of the CUDA kernel since the count was last set to 0.  The CPU
# path never counts.
launches = 0
_count_lock = threading.Lock()

MAX_MIXES = 5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load("norm_shift_mix")
        lib.norm_shift_mix_fwd.restype = ctypes.c_int
        lib.norm_shift_mix_fwd.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_longlong, ctypes.c_float,
                                      ctypes.c_void_p])
        lib.norm_shift_mix_rows.restype = ctypes.c_int
        lib.norm_shift_mix_rows.argtypes = [ctypes.c_longlong]
        lib.norm_shift_mix_error_string.restype = ctypes.c_char_p
        lib.norm_shift_mix_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _check_cuda(x, shift, scale, bias, mixes) -> None:
    """What the kernel takes, from shapes, types and devices alone (a fake
    tensor's too)."""
    if x.dim() != 3:
        raise ValueError(f"norm_shift_mix: x must be (B, S, d), got "
                         f"{tuple(x.shape)}")
    B, _, d = x.shape
    if x.device.type != "cuda" or any(
            t.device != x.device for t in (shift, scale, bias, *mixes)):
        raise ValueError("norm_shift_mix_cuda: every tensor must lie on one "
                         "CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"norm_shift_mix: the CUDA kernel takes float32 or "
                        f"bfloat16 x, got {x.dtype}")
    if not 1 <= len(mixes) <= MAX_MIXES:
        raise ValueError(f"norm_shift_mix: 1 to {MAX_MIXES} mixes, got "
                         f"{len(mixes)}")
    if tuple(shift.shape) != (B, d):
        raise ValueError(f"norm_shift_mix: shift must be (B, d) = ({B}, "
                         f"{d}), got {tuple(shift.shape)}")
    for name, t in (("scale", scale), ("bias", bias),
                    *(("a mix", m) for m in mixes)):
        if tuple(t.shape) != (d,):
            raise ValueError(f"norm_shift_mix: {name} must be ({d},), got "
                             f"{tuple(t.shape)}")
    vec = 16 // x.element_size()
    if d % vec or -(-d // (32 * vec)) > 16:
        raise ValueError(f"norm_shift_mix: the CUDA kernel takes d a "
                         f"multiple of {vec} up to {512 * vec} for "
                         f"{x.dtype}, got {d}")
    if x.stride(2) != 1:
        raise ValueError("norm_shift_mix: the last dim must be contiguous")


def _stacked_cuda(x, shift, scale, bias, mixes, eps: float):
    """The checked launch: (outs (K, B, S, d) in x's dtype, new_shift (B,
    d) float32)."""
    mixes = list(mixes)
    _check_cuda(x, shift, scale, bias, mixes)
    # float32 and contiguous, as the kernel reads them: no-ops for the
    # model's float32 parameters and states.
    shift, scale, bias = (t.float().contiguous() for t in (shift, scale,
                                                           bias))
    mixes = [m.float().contiguous() for m in mixes]
    launch = (_launch if direct_launch(x, shift, scale, bias, *mixes)
              else norm_shift_mix_op)
    return launch(x, shift, scale, bias, mixes, float(eps))


def norm_shift_mix_cuda(x, shift, scale, bias, mixes, eps: float = 1e-6):
    """The Hopper kernel on CUDA tensors (no CPU path), through the
    ``repro_torch::norm_shift_mix`` operator: a fake CUDA tensor gets the
    outputs' shapes and launches nothing.  Returns (the K mixed inputs,
    new_shift), the mixed inputs views of one (K, B, S, d) tensor."""
    outs, new_shift = _stacked_cuda(x, shift, scale, bias, mixes, eps)
    return outs.unbind(0), new_shift


def _launch(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor, mixes: list[torch.Tensor],
            eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch on checked inputs (float32 and contiguous shift, scale,
    bias and mixes): outs (K, B, S, d) in x's dtype, new_shift (B, d)
    float32."""
    global launches
    B, S, d = x.shape
    K = len(mixes)
    outs = torch.empty((K, B, S, d), dtype=x.dtype, device=x.device)
    new_shift = torch.empty((B, d), dtype=torch.float32, device=x.device)
    ptrs = [m.data_ptr() for m in mixes] + [None] * (MAX_MIXES - K)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.norm_shift_mix_fwd(
            x.data_ptr(), shift.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), *ptrs, outs.data_ptr(), new_shift.data_ptr(),
            _DTYPE_CODES[x.dtype], B, S, d, K, x.stride(0), x.stride(1),
            float(eps), stream)
    if rc != 0:
        raise RuntimeError("norm_shift_mix kernel launch failed: "
                           + lib.norm_shift_mix_error_string(rc).decode())
    with _count_lock:
        launches += 1
    return outs, new_shift


def rows_per_warp(n_rows: int) -> int:
    """The rows a warp the kernel walks for ``n_rows`` = B * S rows on the
    current device."""
    return int(_library().norm_shift_mix_rows(n_rows))


norm_shift_mix_op = torch.library.custom_op(
    "repro_torch::norm_shift_mix", _launch, mutates_args=(),
    device_types="cuda")


@norm_shift_mix_op.register_fake
def _(x, shift, scale, bias, mixes, eps):
    B, S, d = x.shape
    return (x.new_empty((len(mixes), B, S, d)),
            x.new_empty((B, d), dtype=torch.float32))


def cost(x, shift, scale, bias, mixes, eps, out) -> tuple:
    """(flops, bytes) of one launch, for ``launch.hlostats``: about 7
    float32 operations an element of x for the LayerNorm and 2 an element
    of each output for its mix, and each operand read or written once (the
    halo rows, a few per cent of x, not counted).  The kernel is bound by
    its bytes."""
    outs, new_shift = out
    params = (shift, scale, bias, *mixes, outs, new_shift)
    nbytes = x.numel() * x.element_size() + sum(
        t.numel() * t.element_size() for t in params)
    return 7 * x.numel() + 2 * outs.numel(), nbytes


def norm_shift_mix_backward(x, shift, scale, bias, mixes, eps: float,
                            g_outs, g_shift):
    """The closed-form gradients (module docstring) of (outs, new_shift)
    with respect to (x, shift, scale, bias, each mix), in float32 and
    returned in each input's dtype.  ``g_outs`` (K, B, S, d) or None,
    ``g_shift`` (B, d) or None: a gradient that is None is 0."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(xf.var(-1, keepdim=True, unbiased=False) + eps)
    xhat = (xf - mu) * rstd
    dh = torch.zeros_like(xf)
    dshift = torch.zeros_like(shift, dtype=torch.float32)
    dmixes = [torch.zeros_like(m, dtype=torch.float32) for m in mixes]
    if g_outs is not None:
        # the kernel's h and h_prev, rounded to x's dtype as it rounds them
        h = (xhat * scale.float() + bias.float()).to(x.dtype).float()
        hp = torch.cat([shift.to(x.dtype).float()[:, None], h[:, :-1]], 1)
        diff = h - hp
        dhp = torch.zeros_like(xf)
        for i, m in enumerate(mixes):
            g = g_outs[i].float()
            mb = m.to(x.dtype).float()
            dh += g * mb
            dhp += g * (1.0 - mb)
            dmixes[i] = (g * diff).sum((0, 1))
        dshift = dhp[:, 0]
        dh[:, :-1] += dhp[:, 1:]
    if g_shift is not None:
        dh[:, -1] += g_shift.float()
    dscale = (dh * xhat).sum((0, 1))
    dbias = dh.sum((0, 1))
    dy = dh * scale.float()
    dx = rstd * (dy - dy.mean(-1, keepdim=True)
                 - xhat * (dy * xhat).mean(-1, keepdim=True))
    return (dx.to(x.dtype), dshift.to(shift.dtype), dscale.to(scale.dtype),
            dbias.to(bias.dtype), [dm.to(m.dtype)
                                   for dm, m in zip(dmixes, mixes)])


class NormShiftMixFn(torch.autograd.Function):
    """The kernel's forward with the closed-form backward.  Saves x, the
    shift and the parameters; the backward recomputes the row statistics
    and h in float32.  Returns (outs (K, B, S, d), new_shift)."""

    @staticmethod
    def forward(ctx, x, shift, scale, bias, eps: float, *mixes):
        ctx.save_for_backward(x, shift, scale, bias, *mixes)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return _stacked_cuda(x, shift, scale, bias, mixes, eps)

    @staticmethod
    def backward(ctx, g_outs, g_shift):
        x, shift, scale, bias, *mixes = ctx.saved_tensors
        dx, dshift, dscale, dbias, dmixes = norm_shift_mix_backward(
            x, shift, scale, bias, mixes, ctx.eps, g_outs, g_shift)
        return (dx, dshift, dscale, dbias, None, *dmixes)


def _norm_shift_mix_sharded(x, shift, scale, bias, mixes, eps: float):
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    xp = kernel_placements(x, (0,))
    sp = tuple(p if p.is_shard() else Replicate() for p in xp)
    rep = (Replicate(),) * mesh.ndim
    dpar = tuple(Partial() if p.is_shard() else Replicate() for p in xp)
    params = [scale, bias, *mixes]
    fn = local_map(
        norm_shift_mix, out_placements=(xp,) * len(mixes) + (sp,),
        in_placements=(xp, sp) + (rep,) * len(params) + (None,),
        in_grad_placements=(xp, sp) + (dpar,) * len(params) + (None,),
        device_mesh=mesh, redistribute_inputs=True)
    out = fn(x, as_dtensor(shift, mesh), as_dtensor(scale, mesh),
             as_dtensor(bias, mesh), [as_dtensor(m, mesh) for m in mixes],
             eps)
    return tuple(out[0]), out[1]


def norm_shift_mix(x, shift, scale, bias, mixes, eps: float = 1e-6):
    """x: (B, S, d); shift: (B, d) float32; scale, bias: (d,); mixes: K
    (d,) vectors.  Returns (a tuple of K mixed inputs (B, S, d) in x's
    dtype, new_shift (B, d) float32).

    The CUDA kernel for CUDA tensors (through ``NormShiftMixFn`` where
    autograd needs the gradient), the plain version for CPU tensors; a
    ``DTensor`` goes to either on each rank's shard."""
    mixes = list(mixes)
    if is_dtensor(x):
        return _norm_shift_mix_sharded(x, shift, scale, bias, mixes, eps)
    if not on_card(x):
        return norm_shift_mix_ref(x, shift, scale, bias, mixes, eps)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, shift, scale, bias, *mixes)):
        outs, new_shift = NormShiftMixFn.apply(x, shift, scale, bias,
                                               float(eps), *mixes)
        return outs.unbind(0), new_shift
    return norm_shift_mix_cuda(x, shift, scale, bias, mixes, eps)
