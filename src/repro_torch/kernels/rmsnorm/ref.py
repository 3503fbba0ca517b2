"""Plain PyTorch version of the RMSNorm kernel."""
from __future__ import annotations

import torch


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """x: (..., d); scale: (d,).  float32 inside, output in x's dtype."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)
