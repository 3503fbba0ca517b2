"""Public wrapper of the flash-attention kernel, in the (B, S, H, hd) layout
of ``repro.kernels.flash_attention.ops.flash_attention``.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/flash_attention.cu``), launched on the current stream — inside the
scheduler that is the lane's stream: bfloat16 to the tensor-core kernel,
which loads q, k and v with TMA and so needs 16-byte-aligned bases and
(B, S, H) strides, float32 to the SIMT kernel.  Both kernels take hd 64,
128, 192 and 256 (``SUPPORTED_HEAD_DIMS``); any other hd up to 256 is
zero-padded to the next of them inside the launch, which passes the
unpadded hd's scale and returns a view of the output's first hd columns
(the kernel runs; this is no fallback), and a larger hd raises.  A CPU
tensor goes to the plain PyTorch version (``ref.attention_ref``).  There is no other path: a CUDA
input the kernel does not take raises.  The launch is the operator
``repro_torch::flash_attention_fwd`` (``torch.library.custom_op``), whose
fake gives the output's shape: a fake CUDA tensor (the dry run's,
``launch.dryrun``) passes through it and launches nothing, and
``launch.hlostats`` counts it as one kernel by ``cost``; an eager call on
plain tensors with no dispatch mode active launches directly
(``kernels.direct_launch``).

``DTensor`` inputs run through ``local_map`` with the batch or the heads
sharded and S and hd whole; heads stay sharded only where the KV heads
split by the same factor (each rank's query heads then read its own KV
heads), and any other placement is redistributed first.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch
import torch.nn.functional as F

from .. import direct_launch, is_dtensor, on_card, on_shards, refuse_grad
from ..build import load
from .ref import attention_ref

# Launches of the CUDA kernel since the count was last set to 0.  The CPU
# path never counts.
launches = 0
_count_lock = threading.Lock()

# Head dims the kernels take as they are; any other up to the largest is
# zero-padded to the next of them (``padded_head_dim``).
SUPPORTED_HEAD_DIMS = (64, 128, 192, 256)
MAX_HEAD_DIM = SUPPORTED_HEAD_DIMS[-1]
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


def padded_head_dim(hd: int) -> int:
    """The head dim the kernel runs ``hd`` at: the least of
    ``SUPPORTED_HEAD_DIMS`` not below it."""
    for n in SUPPORTED_HEAD_DIMS:
        if hd <= n:
            return n
    raise ValueError(f"flash_attention: the CUDA kernel takes hd up to "
                     f"{MAX_HEAD_DIM}, got {hd}")


def pad_head_dim(x: torch.Tensor, hdp: int) -> torch.Tensor:
    """(B, S, H, hd) ``x`` with zero columns appended up to ``hdp``."""
    return F.pad(x, (0, hdp - x.shape[3]))


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
    padded_head_dim(hd)                   # raises past MAX_HEAD_DIM
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v lie on different devices")
    if min(q.stride(3), k.stride(3), v.stride(3)) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")


def _check_tma(q, k, v) -> None:
    """bf16 operands are loaded with TMA: 16-byte-aligned bases and (B, S,
    H) strides (a real tensor's pointers; run in the launch)."""
    if q.dtype != torch.bfloat16:
        return
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
    """The Hopper kernel on CUDA tensors (no CPU path), through the
    ``repro_torch::flash_attention_fwd`` operator: a fake CUDA tensor gets
    the output's shape and launches nothing."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_cuda: tensors must lie on a CUDA "
                         "device")
    launch = _launch if direct_launch(q, k, v) else flash_attention_fwd
    return launch(q, k, v, bool(causal), int(window), float(softcap))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, softcap: float) -> torch.Tensor:
    """One launch on checked (B, S, H, hd) operands, padded on hd to the
    kernel's next head dim where it is not one of them."""
    global launches
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    hdp = padded_head_dim(hd)
    if hdp != hd:
        q, k, v = (pad_head_dim(x, hdp) for x in (q, k, v))
    _check_tma(q, k, v)
    o = torch.empty((B, Sq, H, hdp), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], B, H, Hkv, Sq, Sk, hdp,
            *_strides(q), *_strides(k), *_strides(v), *_strides(o),
            float(hd ** -0.5), int(causal), window, softcap, stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    with _count_lock:
        launches += 1
    return o if hdp == hd else o[..., :hd]


flash_attention_fwd = torch.library.custom_op(
    "repro_torch::flash_attention_fwd", _launch, mutates_args=(),
    device_types="cuda")


@flash_attention_fwd.register_fake
def _(q, k, v, causal, window, softcap):
    return q.new_empty(q.shape)


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the kernel's mask lets through: key j of query
    i where j <= i (causal) and i - j < window (a window)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq,
                                                                  np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _bytes(x, hd: int) -> int:
    """Bytes of (B, S, H, ·) ``x`` at head dim ``hd``."""
    return x.numel() // x.shape[3] * hd * x.element_size()


def cost(q, k, v, causal, window, softcap, o) -> tuple:
    """(flops, bytes) of one launch, for ``launch.hlostats``, at the head
    dim the kernel runs (``padded_head_dim``): the two products of each
    visible pair, 4·hd a head, and q, k, v and the output moved once.  A
    padded call adds its copies: q, k and v read and written padded (the
    output is returned as a view of its first hd columns)."""
    B, Sq, H, hd = q.shape
    hdp = padded_head_dim(hd)
    flops = 4 * B * H * hdp * visible_pairs(Sq, k.shape[1], causal, window)
    nbytes = sum(_bytes(t, hdp) for t in (q, k, v, o))
    if hdp != hd:
        nbytes += sum(_bytes(t, hd) + _bytes(t, hdp) for t in (q, k, v))
    return flops, nbytes


def _flash_sharded(q, k, v, causal: bool, window: int, softcap: float):
    return on_shards(flash_attention, q, k, v, causal=causal, window=window,
                     softcap=softcap)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd) -> (B, Sq, H, hd).

    The CUDA kernel for CUDA tensors, the plain version for CPU tensors; a
    ``DTensor`` goes to either on each rank's shard."""
    if is_dtensor(q):
        return _flash_sharded(q, k, v, causal, window, softcap)
    if not on_card(q):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    refuse_grad("flash_attention", "train with use_flash=False (the "
                "reference's Pallas kernel has no VJP either)", q, k, v)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap)
