"""Operations and bytes of one launch of each hand-written kernel, copied
from the port's ``cost`` functions (``kernels/*/ops.py``) as they stand in
the port the benchmark was defined on, and the peak each is held to."""
from __future__ import annotations

from typing import Tuple

from . import peaks

FLASH_HEAD_DIMS = (64, 128, 192, 256)


def wkv6(B: int, T: int, H: int, hd: int, rkv_bytes: int = 2,
         w_bytes: int = 4) -> Tuple[int, int]:
    """The WKV6 forward on (B, T, H, hd) r, k, v (``rkv_bytes`` each, y
    the same) and w (``w_bytes``), float32 u (H, hd), s0 and the final
    state (B, H, hd, hd): 5·hd² float32 operations a token and head (r^T
    S, then w S + k v^T), each operand read or written once."""
    flops = 5 * hd * hd * B * T * H
    nbytes = (B * T * H * hd * (4 * rkv_bytes + w_bytes) + H * hd * 4
              + 2 * B * H * hd * hd * 4)
    return flops, nbytes


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs that a causal mask and a window let through."""
    total = 0
    for i in range(Sq):
        hi = min(i, Sk - 1) if causal else Sk - 1
        lo = max(i - window + 1, 0) if window > 0 else 0
        total += max(hi - lo + 1, 0)
    return total


def padded_head_dim(hd: int) -> int:
    return min(h for h in FLASH_HEAD_DIMS if h >= hd)


def flash(B: int, Sq: int, Sk: int, H: int, Hkv: int, hd: int,
          causal: bool = True, window: int = 0,
          elt: int = 2) -> Tuple[int, int]:
    """Flash attention at the head dim the kernel runs: 4·hd operations a
    visible pair and head; q, k, v and the output moved once at that head
    dim, and where hd is padded, q, k and v read and written by the
    padding copies too."""
    hdp = padded_head_dim(hd)
    flops = 4 * B * H * hdp * visible_pairs(Sq, Sk, causal, window)
    rows = (2 * B * Sq * H, 2 * B * Sk * Hkv)        # q and o; k and v
    nbytes = sum(rows) * hdp * elt
    if hdp != hd:
        nbytes += (B * Sq * H + 2 * B * Sk * Hkv) * (hd + hdp) * elt
    return flops, nbytes


def rmsnorm(N: int, d: int, elt: int = 2) -> Tuple[int, int]:
    """RMSNorm of N rows of d: four operations an element, x and y moved
    once, the float32 scale read once."""
    return 4 * N * d, 2 * N * d * elt + 4 * d


# the peak each kernel's operations are held to
PEAK_FLOPS = {"wkv6": peaks.F32_FLOPS, "flash": peaks.BF16_FLOPS,
              "rmsnorm": peaks.F32_FLOPS}
