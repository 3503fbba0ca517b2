"""Mamba-style selective SSM head of the Hymba hybrid blocks
(arXiv:2411.13676: parallel attention + SSM heads, ssm_state=16): the port
of ``repro.models.mamba``.

Diagonal selective scan (S6): per channel c and state n
    h_t = exp(-Δ_t A) ⊙ h_{t-1} + Δ_t B_t u_t
    y_t = C_t · h_t + D u_t
with Δ, B, C input-dependent.  Decode is an O(1) state update.

Sequence mode keeps the reference's chunking: chunks of 256 steps (halved
until they divide S), walked in order with the state carried, and within a
chunk a log-depth scan with the reference's ``combine``.  PyTorch has no
``associative_scan``, so the chunk's scan is Hillis–Steele: log2(chunk)
elementwise rounds over shifted slices, out of place so that autograd goes
through it; the carried state is folded in after the scan (h_t = X_t +
D_t h0, with D_t the decays' running product).  Under autograd each chunk
is recomputed in the backward pass (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint(chunk_body)`` does.  The decays' running
product is never taken as exp of a cumulative sum: each step's decay
reaches exp(-16 Δ), and exp of a 256-step sum's negation overflows.

Decay, drive and the state are float32; ``y`` goes back to the activation
dtype before the ``D`` skip and the ``silu(z)`` gate.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import _param, normal_init

CHUNK = 256


class Mamba(nn.Module):
    """The reference's ``init_mamba`` leaves, with its shapes."""

    def __init__(self, cfg, generator, device, dtype=torch.float32) -> None:
        super().__init__()
        d = cfg.d_model
        s = cfg.ssm
        inner = s.expand * d
        self.w_in = normal_init((d, 2 * inner), generator, device,
                                dtype=dtype)                       # u, z
        self.w_dt = normal_init((inner, 1), generator, device, scale=0.1,
                                dtype=dtype)
        self.dt_bias = _param(torch.zeros(inner, device=device, dtype=dtype))
        self.w_B = normal_init((inner, s.state_dim), generator, device,
                               dtype=dtype)
        self.w_C = normal_init((inner, s.state_dim), generator, device,
                               dtype=dtype)
        n = torch.arange(1, s.state_dim + 1, dtype=torch.float32,
                         device=device)
        self.A_log = _param(torch.log(n[None, :].repeat(inner, 1)).to(dtype))
        self.D = _param(torch.ones(inner, device=device, dtype=dtype))
        self.conv_w = normal_init((s.conv_dim, inner), generator, device,
                                  scale=0.2, dtype=dtype)
        self.w_out = normal_init((inner, d), generator, device, dtype=dtype)


def init_mamba_state(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    """float32 ``h`` (B, inner, N) and ``conv`` (B, conv_dim - 1, inner)."""
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    return {"h": torch.zeros((batch, inner, s.state_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.conv_dim - 1, inner),
                                dtype=torch.float32, device=device)}


def _features(cfg, p: Mamba, u_conv):
    """Input-dependent SSM parameters from the conv'd activation."""
    dt = F.softplus(u_conv * p.w_dt.to(u_conv.dtype)[:, 0]
                    + p.dt_bias.to(u_conv.dtype))
    B = u_conv @ p.w_B.to(u_conv.dtype)
    C = u_conv @ p.w_C.to(u_conv.dtype)
    return dt, B, C


def _causal_conv_seq(p: Mamba, u, conv_state):
    """Depthwise causal conv over time. u: (B, S, inner)."""
    k = p.conv_w.shape[0]
    pad = torch.cat([conv_state.to(u.dtype), u], dim=1)   # (B, S+k-1, inner)
    out = torch.zeros_like(u)
    cw = p.conv_w.to(u.dtype)
    for i in range(k):
        out = out + pad[:, i:i + u.shape[1], :] * cw[i][None, None, :]
    return F.silu(out), pad[:, -(k - 1):, :]


def _scan(d, x):
    """Inclusive scan of (d, x) pairs over dim 1 with the reference's
    ``combine(a, b) = (da·db, xb + db·xa)``, a earlier than b: Hillis–Steele
    rounds, each combining every element with the one ``off`` before it.
    Returns (running decay product D_t, X_t).

    Without autograd each round writes into fresh tensors (``out=``); under
    autograd it concatenates, the same arithmetic, at the cost of copying
    the whole tensor once more a round."""
    L = d.shape[1]
    grad = torch.is_grad_enabled() and (d.requires_grad or x.requires_grad)
    off = 1
    while off < L:
        if grad:
            x = torch.cat([x[:, :off], torch.addcmul(
                x[:, off:], d[:, off:], x[:, :-off])], dim=1)
            d = torch.cat([d[:, :off], d[:, off:] * d[:, :-off]], dim=1)
        else:
            nx, nd = torch.empty_like(x), torch.empty_like(d)
            nx[:, :off] = x[:, :off]
            nd[:, :off] = d[:, :off]
            torch.addcmul(x[:, off:], d[:, off:], x[:, :-off],
                          out=nx[:, off:])
            torch.mul(d[:, off:], d[:, :-off], out=nd[:, off:])
            x, d = nx, nd
        off *= 2
    return d, x


def _chunk_body(h0, dchunk, xchunk, cchunk):
    """One chunk: (B, c, inner, N) decays and drives, (B, c, N) C.
    Returns (the state after the chunk, y (B, c, inner))."""
    dcum, xs = _scan(dchunk, xchunk)
    hs = torch.addcmul(xs, dcum, h0[:, None])
    yc = torch.einsum("bsin,bsn->bsi", hs, cchunk)
    return hs[:, -1], yc


def apply_mamba_seq(cfg, p: Mamba, x, state) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d); state: {"h", "conv"}.  Returns (out (B, S, d), the new
    state, float32)."""
    B, S, d = x.shape
    inner = cfg.ssm.expand * d
    uz = x @ p.w_in.to(x.dtype)
    u, z = uz[..., :inner], uz[..., inner:]
    u, conv_state = _causal_conv_seq(p, u, state["conv"])
    dt, Bm, Cm = _features(cfg, p, u)

    A = -torch.exp(p.A_log.float())                          # (inner, N)
    dt32 = dt.float()
    decay = torch.exp(dt32[..., None] * A[None, None])       # (B,S,i,N)
    drive = (dt32 * u.float())[..., None] * Bm.float()[:, :, None, :]
    c32 = Cm.float()

    chunk = CHUNK
    while S % chunk:
        chunk //= 2
    remat = torch.is_grad_enabled() and decay.requires_grad
    h = state["h"]
    ys = []
    for c0 in range(0, S, chunk):
        args = (h, decay[:, c0:c0 + chunk], drive[:, c0:c0 + chunk],
                c32[:, c0:c0 + chunk])
        if remat:
            h, yc = checkpoint(_chunk_body, *args, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            h, yc = _chunk_body(*args)
        ys.append(yc)
    y = torch.cat(ys, dim=1)
    y = y.to(x.dtype) + u * p.D.to(x.dtype)[None, None]
    y = y * F.silu(z)
    out = y @ p.w_out.to(x.dtype)
    return out, {"h": h, "conv": conv_state.float()}


def apply_mamba_step(cfg, p: Mamba, x, state) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d) decode — O(1) update."""
    inner = cfg.ssm.expand * x.shape[-1]
    uz = x[:, 0] @ p.w_in.to(x.dtype)
    u_raw, z = uz[..., :inner], uz[..., inner:]
    window = torch.cat([state["conv"].to(x.dtype), u_raw[:, None, :]], dim=1)
    u = F.silu(torch.einsum("bki,ki->bi", window, p.conv_w.to(x.dtype)))
    dt, Bm, Cm = _features(cfg, p, u)
    A = -torch.exp(p.A_log.float())
    dt32 = dt.float()
    decay = torch.exp(dt32[..., None] * A[None])
    h = decay * state["h"] + (dt32 * u.float())[..., None] \
        * Bm.float()[:, None, :]
    y = torch.einsum("bin,bn->bi", h, Cm.float()).to(x.dtype)
    y = y + u * p.D.to(x.dtype)[None]
    y = y * F.silu(z)
    out = (y @ p.w_out.to(x.dtype))[:, None, :]
    return out, {"h": h, "conv": window[:, 1:, :].float()}
