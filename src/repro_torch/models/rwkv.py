"""RWKV6 "Finch" token mixer and channel mix: the port of
``repro.models.rwkv`` (arXiv:2404.05892).

State per head: S (hd x hd, float32); per step
    y_t = r_t · (S_{t-1} + (u ⊙ k_t) v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
with w_t = exp(-exp(ŵ_t)) data-dependent through a LoRA on the shifted
input, built in float32.

Both modes run the recurrence through ``kernels.rwkv6.ops.wkv6``: the
hand-written kernel on the card, the plain loop on the CPU.  Sequence mode
(prefill) gives it the whole prompt; decode gives it T = 1 with r, k, v in
float32, so that y reaches the group norm in float32 as the reference's
single plain step (``_wkv_step``) leaves it.  The reference's chunked
``jax.checkpoint`` scan exists only for the backward pass and is not
carried over: under grad ``wkv6`` goes through ``WKV6Fn``, whose forward
keeps the state every 16 steps and whose backward (the backward kernel
on the card, the plain loop on the CPU) recomputes each chunk from it.

A state is a dict ``{"shift", "wkv"}`` (the block adds ``"cmix_shift"``);
``apply_rwkv_seq`` and ``apply_rwkv_step`` replace its entries in place and
return it, where the reference returns a new dict.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rwkv6.ops import wkv6
from ..sharding.context import merge_heads, split_heads, use_weight
from .layers import _param, normal_init


def _full(d: int, value: float, device, dtype) -> nn.Parameter:
    return _param(torch.full((d,), value, device=device, dtype=dtype))


class TimeMix(nn.Module):
    """The reference's ``init_rwkv`` parameters, under the same names."""

    def __init__(self, cfg, generator, device, dtype=torch.float32) -> None:
        super().__init__()
        d = cfg.d_model
        hd = cfg.ssm.head_dim
        lora = max(32, d // 16)
        for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w"):
            setattr(self, name, _full(d, 0.5, device, dtype))
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, normal_init((d, d), generator, device,
                                            dtype=dtype))
        # data-dependent decay LoRA: d -> lora -> d
        self.w_decay_a = normal_init((d, lora), generator, device,
                                     dtype=dtype)
        self.w_decay_b = normal_init((lora, d), generator, device,
                                     dtype=dtype)
        self.decay_base = _full(d, 0.0, device, dtype)
        self.bonus_u = normal_init((d // hd, hd), generator, device,
                                   scale=0.1, dtype=dtype)
        self.ln_x_scale = _full(d, 1.0, device, dtype)


class ChannelMix(nn.Module):
    """The reference's ``init_channel_mix`` parameters (the rwkv FFN)."""

    def __init__(self, cfg, generator, device, dtype=torch.float32) -> None:
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.mix_k = _full(d, 0.5, device, dtype)
        self.mix_r = _full(d, 0.5, device, dtype)
        self.wk = normal_init((d, ff), generator, device, dtype=dtype)
        self.wv = normal_init((ff, d), generator, device, dtype=dtype)
        self.wr = normal_init((d, d), generator, device, dtype=dtype)


def init_rwkv_state(cfg, batch: int, device) -> dict:
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    return {"shift": torch.zeros((batch, d), dtype=torch.float32,
                                 device=device),
            "wkv": torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32,
                               device=device)}


def _mix(x, x_prev, m):
    return x * m + x_prev * (1.0 - m)


def _projections(p: TimeMix, x, x_prev, dtype):
    def mix(m):
        return _mix(x, x_prev, m.to(dtype))
    def col(w):
        return use_weight(w.to(dtype), (None, "model"))
    r = mix(p.mix_r) @ col(p.wr)
    k = mix(p.mix_k) @ col(p.wk)
    v = mix(p.mix_v) @ col(p.wv)
    g = mix(p.mix_g) @ col(p.wg)
    dec = torch.tanh(mix(p.mix_w) @ p.w_decay_a.to(dtype)) \
        @ p.w_decay_b.to(dtype)
    w = torch.exp(-torch.exp(p.decay_base.float() + dec.float()))
    return r, k, v, g, w


def _group_norm(x, scale, H: int):
    """LayerNorm per head over hd (RWKV's ln_x), eps 64e-5; output in x's
    dtype."""
    xs = split_heads(x, H, x.shape[-1] // H).float()
    mu = xs.mean(-1, keepdim=True)
    var = xs.var(-1, keepdim=True, unbiased=False)
    y = (xs - mu) * torch.rsqrt(var + 64e-5)
    return (merge_heads(y) * scale.float()).to(x.dtype)


def apply_rwkv_seq(cfg, p: TimeMix, x, state) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d), sequence mode (prefill); the recurrence goes through
    the WKV6 kernel with s0 = state["wkv"]."""
    B, S, d = x.shape
    hd = cfg.ssm.head_dim
    H = d // hd
    x_prev = torch.cat([state["shift"].to(x.dtype)[:, None, :],
                        x[:, :-1, :]], dim=1)
    r, k, v, g, w = _projections(p, x, x_prev, x.dtype)
    def heads(t):
        return split_heads(t, H, hd)
    y, s_final = wkv6(heads(r), heads(k), heads(v), heads(w),
                      p.bonus_u.float(), state["wkv"])
    y = _group_norm(y.reshape(B * S, d), p.ln_x_scale, H).reshape(B, S, d)
    y = y * F.silu(g)
    out = y @ use_weight(p.wo.to(x.dtype), ("model", None))
    state["shift"] = x[:, -1, :].float()
    state["wkv"] = s_final
    return out, state


def apply_rwkv_step(cfg, p: TimeMix, x, state) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d), decode mode: one O(1) state update, the WKV6 kernel at
    T = 1.  r, k, v go in as float32, so y comes out unrounded."""
    B, _, d = x.shape
    hd = cfg.ssm.head_dim
    H = d // hd
    xt = x[:, 0, :]
    r, k, v, g, w = _projections(p, xt, state["shift"].to(x.dtype), x.dtype)
    def head(t):
        return split_heads(t.float()[:, None], H, hd)
    y, S_new = wkv6(head(r), head(k), head(v), head(w), p.bonus_u.float(),
                    state["wkv"])
    y = _group_norm(y.reshape(B, d), p.ln_x_scale, H).to(x.dtype)
    y = y * F.silu(g)
    out = (y @ use_weight(p.wo.to(x.dtype), ("model", None)))[:, None, :]
    state["shift"] = xt.float()
    state["wkv"] = S_new
    return out, state


def apply_channel_mix(cfg, p: ChannelMix, x, shift_state):
    """x: (B, S, d); shift_state: (B, d), the last token of the previous
    chunk.  Returns (out, the last token of x)."""
    x_prev = torch.cat([shift_state.to(x.dtype)[:, None, :], x[:, :-1, :]],
                       dim=1)
    xk = _mix(x, x_prev, p.mix_k.to(x.dtype))
    xr = _mix(x, x_prev, p.mix_r.to(x.dtype))
    k = torch.square(F.relu(
        xk @ use_weight(p.wk.to(x.dtype), (None, "model"))))
    r = torch.sigmoid(xr @ use_weight(p.wr.to(x.dtype), (None, None)))
    return r * (k @ use_weight(p.wv.to(x.dtype), ("model", None))), \
        x[:, -1, :]
