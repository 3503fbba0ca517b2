"""Plain PyTorch version of the flash-attention kernel: materialized-softmax
attention in f32 with the kernel's masking semantics."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale: float = None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd) -> (B, Sq, H, hd).  Scores
    are scaled by ``scale``, by default hd^-0.5 (a call on head dims padded
    with zeros passes the unpadded hd's)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Sq, Hkv, g, hd).float()
    kf = k.float()
    vf = v.float()
    scale = hd ** -0.5 if scale is None else scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg * scale, kf)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, vf)
    return o.reshape(B, Sq, H, hd).to(q.dtype)
