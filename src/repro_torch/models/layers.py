"""Shared neural layers: norms, rotary embeddings, MLP variants, inits.

Parameters are stored in f32 in the reference's (in, out) layout and cast
to the activation dtype at every matmul (``x @ w.to(x.dtype)``), as
``repro.models.layers`` does with ``.astype(x.dtype)``.

RMSNorm (``Norm``'s rmsnorm branch and the qk-norm ``rms_norm_heads``) goes
through ``kernels.rmsnorm.ops.rmsnorm``: the hand-written kernel on a CUDA
tensor, its plain version (``ref.rmsnorm_ref``) on a CPU tensor.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor

from ..kernels import is_dtensor, kernel_placements
from ..kernels.rmsnorm.ops import rmsnorm
from ..sharding.context import use_weight


def normal_init(shape, generator: Optional[torch.Generator], device,
                scale: float = 0.02, dtype=torch.float32) -> nn.Parameter:
    """N(0, scale²) weights drawn from ``generator``; with no generator the
    weight is left uninitialized for a caller that fills it (``convert``)."""
    if generator is None:
        return _param(torch.empty(shape, device=device, dtype=dtype))
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * scale
    return _param(w.to(dtype))


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ----------------------------------------------------------------- norms
class Norm(nn.Module):
    def __init__(self, cfg, d: int, device, dtype=torch.float32) -> None:
        super().__init__()
        self.kind = cfg.norm
        self.scale = _param(torch.ones(d, device=device, dtype=dtype))
        if cfg.norm == "layernorm":
            self.bias = _param(torch.zeros(d, device=device, dtype=dtype))

    def forward(self, x, eps: float = 1e-6):
        if self.kind == "rmsnorm":
            return rmsnorm(x, self.scale, eps)
        if is_dtensor(x):     # the row statistics need whole rows
            x = x.redistribute(placements=kernel_placements(
                x, tuple(range(x.ndim - 1))))
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * self.scale.float() + self.bias.float()
        return y.to(x.dtype)


def rms_norm_heads(x, scale, eps: float = 1e-6):
    """qk-norm: RMSNorm over the head dimension (qwen3)."""
    return rmsnorm(x, scale, eps)


# ------------------------------------------------------------------ rope
_FREQS: Dict[tuple, torch.Tensor] = {}


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """The reference's numpy frequency table, uploaded once per device: an
    upload from pageable memory on every call would synchronize the calling
    lane's stream once per layer and step."""
    key = (head_dim, float(theta), device)
    freqs = _FREQS.get(key)
    if freqs is None:
        host = 1.0 / (theta ** (np.arange(0, head_dim // 2, dtype=np.float32)
                                * 2.0 / head_dim))
        freqs = torch.from_numpy(np.asarray(host, np.float32)).to(device)
        if isinstance(freqs, FakeTensor):   # a dry run's: never kept
            return freqs
        if freqs.is_cuda:   # complete before another lane's stream reads it
            torch.cuda.current_stream(device).synchronize()
        _FREQS[key] = freqs
    return freqs


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2)."""
    freqs = _rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, hd); cos/sin: (..., S, hd//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ------------------------------------------------------------------- mlp
class MLP(nn.Module):
    def __init__(self, cfg, d: int, d_ff: int, generator, device,
                 dtype=torch.float32) -> None:
        super().__init__()
        self.kind = cfg.mlp
        self.w_in = normal_init((d, d_ff), generator, device, dtype=dtype)
        self.w_out = normal_init((d_ff, d), generator, device,
                                 scale=float(0.02 / np.sqrt(2 * cfg.n_layers)),
                                 dtype=dtype)
        if cfg.mlp in ("swiglu", "geglu"):
            self.w_gate = normal_init((d, d_ff), generator, device,
                                      dtype=dtype)

    def forward(self, x):
        h = x @ use_weight(self.w_in.to(x.dtype), (None, "model"))
        if self.kind == "swiglu":
            g = x @ use_weight(self.w_gate.to(x.dtype), (None, "model"))
            h = F.silu(g) * h
        elif self.kind == "geglu":
            g = x @ use_weight(self.w_gate.to(x.dtype), (None, "model"))
            h = F.gelu(g, approximate="tanh") * h
        elif self.kind == "relu2":                 # nemotron squared-ReLU
            h = torch.square(F.relu(h))
        else:                                      # gelu (starcoder2)
            h = F.gelu(h, approximate="tanh")
        return h @ use_weight(self.w_out.to(x.dtype), ("model", None))
