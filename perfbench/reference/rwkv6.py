"""RWKV-6 "Finch" (arXiv:2404.05892) as the configuration states it, in
plain float32 PyTorch: token shift with static mixes, the data-dependent
decay through its LoRA, the WKV recurrence walked step by step, the
per-head group norm, the gated output, the channel mix.

Per head, with S a (hd x hd) state that starts at zero,
    y_t = r_t · (S_{t-1} + (u ⊙ k_t) v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ,   w_t = exp(-exp(ŵ_t)).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from .common import MM, Spec, const, layer_norm, normal, shifted

LN_EPS = 1e-6
GROUP_NORM_EPS = 64e-5
STEP_BLOCK = 256       # steps whose states are held at once


def param_specs(m: dict) -> List[Spec]:
    d, ff, V = m["d_model"], m["d_ff"], m["vocab"]
    hd = m["ssm"]["head_dim"]
    lora = max(32, d // 16)
    specs = [normal("embed", (V, d)), const("final_norm.scale", (d,), 1),
             const("final_norm.bias", (d,), 0), normal("lm_head", (d, V))]
    for i in range(m["n_layers"]):
        b = f"blocks.{i}."
        specs += [const(b + "ln1.scale", (d,), 1),
                  const(b + "ln1.bias", (d,), 0)]
        specs += [const(b + f"rwkv.mix_{c}", (d,), 0.5) for c in "rkvgw"]
        specs += [normal(b + f"rwkv.w{c}", (d, d)) for c in "rkvgo"]
        specs += [normal(b + "rwkv.w_decay_a", (d, lora)),
                  normal(b + "rwkv.w_decay_b", (lora, d)),
                  Spec(b + "rwkv.decay_base", (d,),
                       ("rwkv6_decay", i, m["n_layers"])),
                  Spec(b + "rwkv.bonus_u", (d // hd, hd),
                       ("rwkv6_bonus", i, m["n_layers"])),
                  const(b + "rwkv.ln_x_scale", (d,), 1),
                  const(b + "ln2.scale", (d,), 1),
                  const(b + "ln2.bias", (d,), 0),
                  const(b + "cmix.mix_k", (d,), 0.5),
                  const(b + "cmix.mix_r", (d,), 0.5),
                  normal(b + "cmix.wk", (d, ff)),
                  normal(b + "cmix.wv", (ff, d)),
                  normal(b + "cmix.wr", (d, d))]
    return specs


def head(weights: dict, m: dict) -> torch.Tensor:
    return weights["lm_head"]


def wkv(r, k, v, w, u, H: int):
    """The recurrence over (n, T, d) float32 r, k, v, w; u (H, hd).
    Returns y (n, T, d)."""
    n, T, d = r.shape
    hd = d // H
    r, k, v, w = (t.reshape(n, T, H, hd).transpose(0, 1) for t in
                  (r, k, v, w))                            # (T, n, H, hd)
    y = ((r * u * k).sum(-1, keepdim=True) * v).contiguous()
    S = torch.zeros((n, H, hd, hd), dtype=r.dtype, device=r.device)
    for t0 in range(0, T, STEP_BLOCK):
        t1 = min(T, t0 + STEP_BLOCK)
        kv = k[t0:t1, ..., None] * v[t0:t1, ..., None, :]
        wb = w[t0:t1, ..., None].contiguous()
        states = torch.empty((t1 - t0 + 1, n, H, hd, hd), dtype=r.dtype,
                             device=r.device)
        states[0] = S
        for j in range(t1 - t0):
            torch.addcmul(kv[j], wb[j], states[j], out=states[j + 1])
        y[t0:t1] += torch.einsum("tnhi,tnhij->tnhj", r[t0:t1], states[:-1])
        S = states[-1].clone()
        del kv, wb, states
    return y.transpose(0, 1).reshape(n, T, d)


def _group_norm(y, scale, H: int):
    n, T, d = y.shape
    ys = y.reshape(n, T, H, d // H)
    mu = ys.mean(-1, keepdim=True)
    var = ys.var(-1, keepdim=True, unbiased=False)
    return ((ys - mu) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(
        n, T, d) * scale


def hidden(weights: dict, m: dict, tokens: torch.Tensor, mm: MM):
    """(n, T, d) final normalised hidden states of (n, T) prompts."""
    W = weights
    d = m["d_model"]
    H = d // m["ssm"]["head_dim"]
    x = W["embed"][tokens.long()]
    for i in range(m["n_layers"]):
        def p(name):
            return W[f"blocks.{i}.{name}"]
        h = layer_norm(x, p("ln1.scale"), p("ln1.bias"), LN_EPS)
        hp = shifted(h)

        def mix(c):
            m_ = p(f"rwkv.mix_{c}")
            return h * m_ + hp * (1 - m_)
        r, k, v, g = (mm(mix(c), p(f"rwkv.w{c}")) for c in "rkvg")
        dec = mm(torch.tanh(mm(mix("w"), p("rwkv.w_decay_a"))),
                 p("rwkv.w_decay_b"))
        w = torch.exp(-torch.exp(p("rwkv.decay_base") + dec))
        y = wkv(r, k, v, w, p("rwkv.bonus_u"), H)
        y = _group_norm(y, p("rwkv.ln_x_scale"), H) * F.silu(g)
        x = x + mm(y, p("rwkv.wo"))
        del r, k, v, g, w, y, h, hp
        h = layer_norm(x, p("ln2.scale"), p("ln2.bias"), LN_EPS)
        hp = shifted(h)
        xk = h * p("cmix.mix_k") + hp * (1 - p("cmix.mix_k"))
        xr = h * p("cmix.mix_r") + hp * (1 - p("cmix.mix_r"))
        kk = torch.square(F.relu(mm(xk, p("cmix.wk"))))
        x = x + torch.sigmoid(mm(xr, p("cmix.wr"))) * mm(kk, p("cmix.wv"))
        del h, hp, xk, xr, kk
    return layer_norm(x, W["final_norm.scale"], W["final_norm.bias"], LN_EPS)
