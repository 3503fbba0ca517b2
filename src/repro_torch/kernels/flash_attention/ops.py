"""Public wrapper of the flash-attention kernel, in the (B, S, H, hd) layout
of ``repro.kernels.flash_attention.ops.flash_attention``.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/flash_attention.cu``), launched on the current stream — inside the
scheduler that is the lane's stream: bfloat16 to the tensor-core kernel,
which loads q, k and v with TMA and so needs 16-byte-aligned bases and
(B, S, H) strides, float32 to the SIMT kernel.  A CPU tensor goes to the plain
PyTorch version (``ref.attention_ref``).  There is no other path: a CUDA
input the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .. import on_card, refuse_grad
from ..build import load
from .ref import attention_ref

# Launches of the CUDA kernel since the count was last set to 0.  The CPU
# path never counts.
launches = 0
_count_lock = threading.Lock()

SUPPORTED_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load("flash_attention")
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_void_p])
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, H, hd)")
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if H % k.shape[2]:
        raise ValueError("flash_attention: H must be a multiple of Hkv")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError("flash_attention: the CUDA kernel takes float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes hd in "
                         f"{SUPPORTED_HEAD_DIMS}, got {hd}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v lie on different devices")
    if min(q.stride(3), k.stride(3), v.stride(3)) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    if q.dtype == torch.bfloat16 and q.device.type == "cuda":
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16 or any(
                    (st * x.element_size()) % 16 for st in _strides(x)):
                raise ValueError(
                    f"flash_attention: bf16 {name} needs a 16-byte-aligned "
                    f"base and (B, S, H) strides, got strides "
                    f"{tuple(x.stride())} (the kernel loads it with TMA)")


def _strides(x):
    """(B, S, H) strides in elements, a size-1 dim's replaced by hd (its
    stride is never stepped, and the TMA map wants a multiple of 16
    bytes)."""
    return [st if n > 1 else x.shape[3]
            for st, n in zip(x.stride()[:3], x.shape[:3])]


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors (no CPU path)."""
    global launches
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_cuda: tensors must lie on a CUDA "
                         "device")
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], B, H, Hkv, Sq, Sk, hd,
            *_strides(q), *_strides(k), *_strides(v), *_strides(o),
            float(hd ** -0.5), int(bool(causal)), int(window),
            float(softcap), stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    with _count_lock:
        launches += 1
    return o


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd) -> (B, Sq, H, hd).

    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if not on_card(q):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    refuse_grad("flash_attention", "train with use_flash=False (the "
                "reference's Pallas kernel has no VJP either)", q, k, v)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap)
