"""Plain PyTorch version of the norm-shift-mix kernel: the eager
composition rwkv6's blocks ran before the kernel, unchanged, op for op.

``layer_norm`` is the LayerNorm arithmetic (float32 statistics, the output
in x's dtype), which ``models.layers.Norm``'s LayerNorm branch calls too;
``shift_mix`` is the token shift (a ``torch.cat`` of the previous chunk's
last row before the sequence) and each mix ``h * m + h_prev * (1 - m)``
with ``m`` cast to h's dtype."""
from __future__ import annotations

import torch


def layer_norm(x, scale, bias, eps: float = 1e-6):
    """x: (..., d); scale, bias: (d,).  float32 inside, output in x's
    dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def shift_mix(h, shift, mixes):
    """h: (B, S, d), already normalised; shift: (B, d), the previous
    chunk's last row; mixes: K (d,) vectors.  Returns (the K mixed inputs
    (B, S, d) in h's dtype, h's last row in float32)."""
    h_prev = torch.cat([shift.to(h.dtype)[:, None, :], h[:, :-1, :]], dim=1)
    outs = []
    for m in mixes:
        m = m.to(h.dtype)
        outs.append(h * m + h_prev * (1.0 - m))
    return tuple(outs), h[:, -1, :].float()


def norm_shift_mix_ref(x, shift, scale, bias, mixes, eps: float = 1e-6):
    """x: (B, S, d); shift: (B, d) float32; scale, bias: (d,); mixes: K
    (d,) vectors.  Returns (K mixed inputs (B, S, d) in x's dtype, the
    normalised last row (B, d) float32)."""
    return shift_mix(layer_norm(x, scale, bias, eps), shift, mixes)
