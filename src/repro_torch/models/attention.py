"""Grouped-query attention: full/sliding-window causal, bidirectional
(the encoder's), cross (encoder-decoder) and cached decode.

The causal full-sequence path goes to the hand-written flash kernel
(``kernels/flash_attention``) when ``use_flash`` is set; otherwise it takes
the materialized ``_sdpa`` or, for long sequences, the blocked
``_sdpa_chunked`` — both plain PyTorch with the reference's numerics (bf16
operands, f32 scores and softmax).  Autograd differentiates ``_sdpa``
directly; ``_sdpa_chunked`` is ``ChunkedAttention``, whose backward
recomputes score blocks as the reference's custom VJP does.  The flash
kernel has no backward (nor has the reference's): a CUDA call under grad
raises.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.flash_attention.ops import flash_attention
from .layers import _param, apply_rope, normal_init, rms_norm_heads, \
    rope_angles

NEG_INF = -1e30
CHUNKED_THRESHOLD = 2048


class Attention(nn.Module):
    """``cross=True`` is an encoder-decoder cross-attention: no q/k-norm."""

    def __init__(self, cfg, generator, device, dtype=torch.float32,
                 cross: bool = False) -> None:
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        self.wq = normal_init((d, cfg.n_heads * hd), generator, device,
                              dtype=dtype)
        self.wk = normal_init((d, cfg.n_kv_heads * hd), generator, device,
                              dtype=dtype)
        self.wv = normal_init((d, cfg.n_kv_heads * hd), generator, device,
                              dtype=dtype)
        self.wo = normal_init((cfg.n_heads * hd, d), generator, device,
                              dtype=dtype)
        if cfg.qk_norm and not cross:
            self.q_norm = _param(torch.ones(hd, device=device, dtype=dtype))
            self.k_norm = _param(torch.ones(hd, device=device, dtype=dtype))
        else:
            self.q_norm = self.k_norm = None


def _project_qkv(cfg, p: Attention, xq, xkv):
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    hd = cfg.hd
    q = (xq @ p.wq.to(xq.dtype)).reshape(B, Sq, cfg.n_heads, hd)
    k = (xkv @ p.wk.to(xq.dtype)).reshape(B, Skv, cfg.n_kv_heads, hd)
    v = (xkv @ p.wv.to(xq.dtype)).reshape(B, Skv, cfg.n_kv_heads, hd)
    if p.q_norm is not None:
        q = rms_norm_heads(q, p.q_norm)
        k = rms_norm_heads(k, p.k_norm)
    return q, k, v


def _sdpa(cfg, q, k, v, mask):
    """q: (B,Sq,H,hd), k/v: (B,Skv,Hkv,hd), mask: (Sq,Skv) or (B,1,Sq,Skv)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Sq, Hkv, g, hd)
    scale = hd ** -0.5
    # bf16 operands, f32 products and sums (preferred_element_type=f32)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", (qg * scale).float(),
                          k.float())
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    if mask is not None:
        mask = mask[None, None, None] if mask.dim() == 2 else mask[:, :, None]
        logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return o.reshape(B, Sq, H * hd)


def _block_scores(qblk, kblk, qi, kj, q_chunk, kv_chunk, *, causal, window,
                  softcap):
    """Masked (softcapped) score block in f32, (B, Hkv, g, qc, kc).  qblk
    pre-scaled.  Returns (s, the softcap's tanh or None, mask)."""
    dev = qblk.device
    s = torch.einsum("bqhgd,bkhd->bhgqk", qblk.float(), kblk.float())
    t = None
    if softcap > 0:
        t = torch.tanh(s / softcap)
        s = t * softcap
    q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
    k_pos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
    mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=dev)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    return s, t, mask


def _chunked_forward(q, k, v, causal, window, softcap, q_chunk, kv_chunk):
    """Blocked online-softmax attention (the forward of the reference's
    ``_chunked_attention``): the (Sq, Skv) scores never materialize.
    Returns (out (B, Sq, H*hd) in q's dtype, lse (B, Hkv, g, Sq) f32)."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    scale = hd ** -0.5
    dev = q.device
    qs = (q * scale).reshape(B, Sq, Hkv, g, hd)
    outs, lses = [], []
    for qi in range(nq):
        qblk = qs[:, qi * q_chunk:(qi + 1) * q_chunk]
        m = torch.full((B, Hkv, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, g, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, g, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        for kj in range(nk):
            kblk = k[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            vblk = v[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            s, _, _ = _block_scores(qblk, kblk, qi, kj, q_chunk, kv_chunk,
                                    causal=causal, window=window,
                                    softcap=softcap)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vblk.dtype), vblk)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H * hd))
    return (torch.cat(outs, dim=1).to(q.dtype), torch.cat(lses, dim=-1))


def _chunked_backward(q, k, v, out, lse, dout, causal, window, softcap,
                      q_chunk, kv_chunk):
    """The reference's ``_chunked_bwd``: D = rowsum(dO·O), then a dq pass
    over q blocks and a dk/dv pass over kv blocks, each recomputing its
    score blocks from q, k and the saved log-sum-exp."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    scale = hd ** -0.5

    do = dout.reshape(B, Sq, Hkv, g, hd).float()
    og = out.reshape(B, Sq, Hkv, g, hd).float()
    D = torch.einsum("bqhgd,bqhgd->bhgq", do, og)          # (B, Hkv, g, Sq)
    qs = (q * scale).reshape(B, Sq, Hkv, g, hd)

    def q_rows(t, qi):
        return t[:, qi * q_chunk:(qi + 1) * q_chunk]

    def kv_rows(t, kj):
        return t[:, kj * kv_chunk:(kj + 1) * kv_chunk]

    def p_and_ds(qi, kj):
        qblk, doblk = q_rows(qs, qi), q_rows(do, qi)
        kblk, vblk = kv_rows(k, kj), kv_rows(v, kj)
        sl = slice(qi * q_chunk, (qi + 1) * q_chunk)
        s, t, mask = _block_scores(qblk, kblk, qi, kj, q_chunk, kv_chunk,
                                   causal=causal, window=window,
                                   softcap=softcap)
        p = torch.exp(s - lse[..., sl, None])                # (B,h,g,qc,kc)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", doblk, vblk.float())
        ds = p * (dp - D[..., sl, None])
        if softcap > 0:
            ds = ds * (1.0 - t * t)          # the softcap's tanh gradient
        ds = torch.where(mask[None, None, None], ds, 0.0)
        return p, ds

    # pass 1: dq, over q blocks (inner over kv)
    dqs = []
    for qi in range(nq):
        dq = torch.zeros((B, q_chunk, Hkv, g, hd), dtype=torch.float32,
                         device=q.device)
        for kj in range(nk):
            _, ds = p_and_ds(qi, kj)
            dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds,
                                   kv_rows(k, kj).float())
        dqs.append(dq * scale)
    dq = torch.cat(dqs, dim=1).reshape(B, Sq, H, hd).to(q.dtype)

    # pass 2: dk/dv, over kv blocks (inner over q)
    dks, dvs = [], []
    for kj in range(nk):
        dk = torch.zeros((B, kv_chunk, Hkv, hd), dtype=torch.float32,
                         device=k.device)
        dv = torch.zeros_like(dk)
        for qi in range(nq):
            p, ds = p_and_ds(qi, kj)
            dk = dk + torch.einsum("bhgqk,bqhgd->bkhd", ds,
                                   q_rows(qs, qi).float())
            dv = dv + torch.einsum("bhgqk,bqhgd->bkhd", p, q_rows(do, qi))
        dks.append(dk)
        dvs.append(dv)
    dk = torch.cat(dks, dim=1).to(k.dtype)
    dv = torch.cat(dvs, dim=1).to(v.dtype)
    return dq, dk, dv


class ChunkedAttention(torch.autograd.Function):
    """The reference's ``_chunked_attention`` with its custom VJP: the
    forward saves q, k, v, the output and the per-row log-sum-exp, and the
    backward recomputes the score blocks (O(S·d) memory, not O(S²))."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_chunk, kv_chunk):
        out, lse = _chunked_forward(q, k, v, causal, window, softcap,
                                    q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, softcap, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _chunked_backward(q, k, v, out, lse, dout, *ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def _sdpa_chunked(cfg, q, k, v, *, causal: bool = True, window: int = 0,
                  q_chunk: int = 512, kv_chunk: int = 1024):
    Sq, Skv = q.shape[1], k.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    while Sq % q_chunk:
        q_chunk //= 2
    while Skv % kv_chunk:
        kv_chunk //= 2
    return ChunkedAttention.apply(q, k, v, causal, window,
                                  float(cfg.logit_softcap), q_chunk, kv_chunk)


def causal_mask(Sq: int, Skv: int, window: int = 0, offset: int = 0,
                device=None):
    """(Sq, Skv) boolean: query i attends key j iff j <= i+offset and, with a
    sliding window, i+offset - j < window."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    kj = torch.arange(Skv, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= (qi - kj) < window
    return m


def attend_full(cfg, p: Attention, x, positions, *, window: int = 0,
                use_flash: bool = False, bidirectional: bool = False):
    """Self-attention over a full sequence (train / prefill).

    Returns (out, (k, v)) so prefill can seed the decode cache.
    """
    q, k, v = _project_qkv(cfg, p, x, x)
    cos, sin = rope_angles(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    S = x.shape[1]
    if use_flash and not bidirectional:
        o = flash_attention(q, k, v, window=window,
                            softcap=cfg.logit_softcap)
        o = o.reshape(*o.shape[:2], -1)
    elif S >= CHUNKED_THRESHOLD:
        # long sequences: blocked online softmax (O(S^2) logits never
        # materialize)
        o = _sdpa_chunked(cfg, q, k, v, causal=not bidirectional,
                          window=window)
    else:
        mask = None if bidirectional else causal_mask(S, S, window,
                                                      device=x.device)
        o = _sdpa(cfg, q, k, v, mask)
    return o @ p.wo.to(x.dtype), (k, v)


def attend_cross(cfg, p: Attention, x, kv_src):
    """Cross-attention (encoder-decoder): no rope, no mask (the whole
    source).  Returns (out, (k, v)) so prefill can fill the cross cache."""
    q, k, v = _project_qkv(cfg, p, x, kv_src)
    o = _sdpa(cfg, q, k, v, None)
    return o @ p.wo.to(x.dtype), (k, v)


def attend_cross_decode(cfg, p: Attention, x, cache):
    """One token's cross-attention against the cached ``cross_k`` and
    ``cross_v``: ``wq`` only, no rope."""
    q = (x @ p.wq.to(x.dtype)).reshape(x.shape[0], 1, cfg.n_heads, cfg.hd)
    o = _sdpa(cfg, q, cache["cross_k"].to(x.dtype),
              cache["cross_v"].to(x.dtype), None)
    return o @ p.wo.to(x.dtype)


def init_kv_cache(cfg, batch: int, max_len: int, device,
                  dtype=torch.bfloat16):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attend_decode(cfg, p: Attention, x, cache, pos: int, *, window: int = 0):
    """Single-token decode against a KV cache.

    x: (B, 1, d); cache: dict(k,v) of (B, Smax, Hkv, hd), updated in place
    (the reference returns updated copies); pos: int — the index of the new
    token (same for the whole batch).
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(cfg, p, x, x)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = rope_angles(posv, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)
    k, v = cache["k"], cache["v"]
    Smax = k.shape[1]
    ring = window > 0 and Smax <= window     # ring buffer (slot = pos % W)
    # dynamic_update_slice clamps the start so the update fits
    slot = min(pos % Smax if ring else pos, Smax - 1)
    k[:, slot:slot + 1] = k_new.to(k.dtype)
    v[:, slot:slot + 1] = v_new.to(v.dtype)
    kj = torch.arange(Smax, device=x.device)[None, :]
    if ring:
        # every resident slot is within the window by construction; only
        # not-yet-written slots (early decode) are masked out
        m = (kj <= pos) | (pos >= Smax)
    else:
        m = kj <= pos                   # (1, Smax) == (Sq=1, Skv)
        if window > 0:
            m &= (pos - kj) < window
    o = _sdpa(cfg, q, k.to(x.dtype), v.to(x.dtype), m)
    return o @ p.wo.to(x.dtype), {"k": k, "v": v}
