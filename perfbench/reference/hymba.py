"""Hymba (arXiv:2411.13676) as the configuration states it, in plain
float32 PyTorch: in every layer, grouped-query attention over a causal
sliding window with rotary positions and a selective-scan (Mamba) head
read the same RMS-normalised input and are averaged; then a SwiGLU
feed-forward.  The scan is walked step by step:
    h_t = exp(Δ_t A) ⊙ h_{t-1} + Δ_t u_t B_t,   y_t = C_t · h_t + D u_t.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from .common import MM, Spec, const, normal, rms_norm

RMS_EPS = 1e-6
# B_t and C_t of order one, so that the scan's state and not the D skip
# alone sets the Mamba head's output: at 0.02 a scan that drops its state
# moves the served tokens no more than bfloat16 rounding does.
BC_STD = 0.1
QUERY_BLOCK = 512      # queries whose window is scored at once
STEP_BLOCK = 256       # scan steps whose states are held at once


def param_specs(m: dict) -> List[Spec]:
    d, ff, V, L = m["d_model"], m["d_ff"], m["vocab"], m["n_layers"]
    hd = m.get("head_dim") or d // m["n_heads"]
    s = m["ssm"]
    inner, N = s["expand"] * d, s["state_dim"]
    specs = [normal("embed", (V, d)), const("final_norm.scale", (d,), 1),
             normal("lm_head", (d, V))]
    for i in range(L):
        b = f"blocks.{i}."
        specs += [const(b + "ln1.scale", (d,), 1),
                  normal(b + "attn.wq", (d, m["n_heads"] * hd)),
                  normal(b + "attn.wk", (d, m["n_kv_heads"] * hd)),
                  normal(b + "attn.wv", (d, m["n_kv_heads"] * hd)),
                  normal(b + "attn.wo", (m["n_heads"] * hd, d)),
                  normal(b + "mamba.w_in", (d, 2 * inner)),
                  normal(b + "mamba.w_dt", (inner, 1), 0.1),
                  Spec(b + "mamba.dt_bias", (inner,),
                       ("mamba_dt_bias", 1e-3, 1e-1)),
                  normal(b + "mamba.w_B", (inner, N), BC_STD),
                  normal(b + "mamba.w_C", (inner, N), BC_STD),
                  Spec(b + "mamba.A_log", (inner, N), ("log_arange", N)),
                  const(b + "mamba.D", (inner,), 1),
                  normal(b + "mamba.conv_w", (s["conv_dim"], inner), 0.2),
                  normal(b + "mamba.w_out", (inner, d)),
                  const(b + "ln2.scale", (d,), 1),
                  normal(b + "ffn.w_in", (d, ff)),
                  normal(b + "ffn.w_gate", (d, ff)),
                  normal(b + "ffn.w_out", (ff, d), 0.02 / math.sqrt(2 * L))]
    return specs


def head(weights: dict, m: dict) -> torch.Tensor:
    return weights["lm_head"]


def _rope(x, theta: float):
    """x (n, T, heads, hd): the two halves of each head rotated by
    position t at frequencies theta^(-2j/hd)."""
    T, hd = x.shape[1], x.shape[-1]
    j = torch.arange(hd // 2, dtype=torch.float32, device=x.device)
    freqs = 1.0 / theta ** (j * 2.0 / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def window_attention(q, k, v, window: int):
    """q (n, T, H, hd), k and v (n, T, Hkv, hd): key j is visible to query
    i where j <= i and i - j < window; query head h reads key head
    h // (H / Hkv).  Returns (n, T, H * hd)."""
    n, T, H, hd = q.shape
    g = H // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    out = torch.empty_like(q)
    pos = torch.arange(T, device=q.device)
    for q0 in range(0, T, QUERY_BLOCK):
        q1 = min(T, q0 + QUERY_BLOCK)
        k0 = max(0, q0 - window + 1)
        s = torch.einsum("nqhd,nkhd->nhqk", q[:, q0:q1], k[:, k0:q1]) \
            * hd ** -0.5
        dist = pos[q0:q1, None] - pos[None, k0:q1]
        s = s.masked_fill(~((dist >= 0) & (dist < window)), float("-inf"))
        out[:, q0:q1] = torch.einsum("nhqk,nkhd->nqhd", s.softmax(-1),
                                     v[:, k0:q1])
    return out.reshape(n, T, H * hd)


def mamba(p, x, mm: MM, conv_dim: int):
    """The selective-scan head on (n, T, d) input x."""
    n, T, _ = x.shape
    uz = mm(x, p("w_in"))
    inner = uz.shape[-1] // 2
    u, z = uz[..., :inner], uz[..., inner:]
    pad = torch.cat([u.new_zeros((n, conv_dim - 1, inner)), u], dim=1)
    cw = p("conv_w")
    u = F.silu(sum(pad[:, i:i + T] * cw[i] for i in range(conv_dim)))
    dt = F.softplus(u * p("w_dt")[:, 0] + p("dt_bias"))
    Bm, Cm = mm(u, p("w_B")), mm(u, p("w_C"))
    A = -torch.exp(p("A_log"))
    N = A.shape[-1]
    y = torch.empty_like(u)
    h = u.new_zeros((n, inner, N))
    for t0 in range(0, T, STEP_BLOCK):
        t1 = min(T, t0 + STEP_BLOCK)
        dtb = dt[:, t0:t1].transpose(0, 1)                   # (L, n, inner)
        decay = torch.exp(dtb[..., None] * A)
        drive = ((dtb * u[:, t0:t1].transpose(0, 1))[..., None]
                 * Bm[:, t0:t1].transpose(0, 1)[:, :, None, :])
        hs = torch.empty((t1 - t0 + 1, n, inner, N), dtype=u.dtype,
                         device=u.device)
        hs[0] = h
        for j in range(t1 - t0):
            torch.addcmul(drive[j], decay[j], hs[j], out=hs[j + 1])
        y[:, t0:t1] = torch.einsum("tbis,bts->bti", hs[1:],
                                   Cm[:, t0:t1])
        h = hs[-1].clone()
        del decay, drive, hs
    y = (y + u * p("D")) * F.silu(z)
    return mm(y, p("w_out"))


def hidden(weights: dict, m: dict, tokens: torch.Tensor, mm: MM):
    """(n, T, d) final normalised hidden states of (n, T) prompts."""
    W = weights
    n, T = tokens.shape
    H, Hkv = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    x = W["embed"][tokens.long()]
    for i in range(m["n_layers"]):
        def p(name):
            return W[f"blocks.{i}.{name}"]
        h = rms_norm(x, p("ln1.scale"), RMS_EPS)
        q = _rope(mm(h, p("attn.wq")).reshape(n, T, H, hd), m["rope_theta"])
        k = _rope(mm(h, p("attn.wk")).reshape(n, T, Hkv, hd),
                  m["rope_theta"])
        v = mm(h, p("attn.wv")).reshape(n, T, Hkv, hd)
        a = mm(window_attention(q, k, v, m["sliding_window"]), p("attn.wo"))
        del q, k, v
        s = mamba(lambda name: p("mamba." + name), h, mm,
                  m["ssm"]["conv_dim"])
        x = x + 0.5 * (a + s)
        del a, s, h
        h = rms_norm(x, p("ln2.scale"), RMS_EPS)
        x = x + mm(F.silu(mm(h, p("ffn.w_gate"))) * mm(h, p("ffn.w_in")),
                   p("ffn.w_out"))
        del h
    return rms_norm(x, W["final_norm.scale"], RMS_EPS)
