"""Plain PyTorch version of the WKV6 kernel: the recurrence as a loop over
time in float32, in the kernel's (BH, T, hd) layout."""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, s0):
    """r/k/v/w: (BH, T, hd); u: (BH, hd); s0: (BH, hd, hd) float32.
    Returns (y (BH, T, hd) in r's dtype, s_final (BH, hd, hd) float32)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[:, :, None]
    S = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, None] * vf[:, t, None, :]
        ys.append(torch.einsum("bi,bij->bj", rf[:, t], S + uf * kv))
        S = wf[:, t, :, None] * S + kv
    y = torch.stack(ys, 1) if ys else torch.zeros_like(rf)
    return y.to(r.dtype), S
