"""Plain PyTorch versions of the WKV6 kernels: the recurrence and its
backward as loops over time in float32, in the kernels' (BH, T, hd)
layout."""
from __future__ import annotations

import torch

# Steps between the states the saving forward keeps (the CUDA kernel's
# chunk of time, kCT): state c is S before step c * CHUNK.
CHUNK = 16


def n_chunks(T: int) -> int:
    return -(-T // CHUNK)


def _scan(r, k, v, w, u, s0, save: bool):
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[:, :, None]
    S = s0.float()
    ys, states = [], []
    for t in range(r.shape[1]):
        if save and t % CHUNK == 0:
            states.append(S)
        kv = kf[:, t, :, None] * vf[:, t, None, :]
        ys.append(torch.einsum("bi,bij->bj", rf[:, t], S + uf * kv))
        S = wf[:, t, :, None] * S + kv
    y = torch.stack(ys, 1) if ys else torch.zeros_like(rf)
    if not save:
        return y.to(r.dtype), S
    saved = torch.stack(states, 1) if states else S.new_zeros(
        (S.shape[0], 0) + S.shape[1:])
    return y.to(r.dtype), S, saved


def wkv6_ref(r, k, v, w, u, s0):
    """r/k/v/w: (BH, T, hd); u: (BH, hd); s0: (BH, hd, hd) float32.
    Returns (y (BH, T, hd) in r's dtype, s_final (BH, hd, hd) float32)."""
    return _scan(r, k, v, w, u, s0, save=False)


def wkv6_ref_saving(r, k, v, w, u, s0):
    """``wkv6_ref`` that also keeps the state before every CHUNK-th step:
    (y, s_final, states (BH, n_chunks(T), hd, hd) float32), the states
    the backward starts each chunk from."""
    return _scan(r, k, v, w, u, s0, save=True)


def wkv6_bwd_ref(r, k, v, w, u, states, dy, dsT=None):
    """The backward of ``wkv6_ref`` from the saving forward's ``states``:
    per (b, h), with G_T = dsT (zero when None), walking t = T .. 1,

        dr_t = S_{t-1} dy_t + u ⊙ k_t (v_t · dy_t)
        dk_t = u ⊙ r_t (v_t · dy_t) + G_t v_t
        dv_t = (Σ_i r_t[i] u_i k_t[i]) dy_t + G_tᵀ k_t
        dw_t[i] = Σ_j G_t[i, j] S_{t-1}[i, j]
        du += r_t ⊙ k_t (v_t · dy_t)
        G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ

    and ds0 = G_0.  Each chunk recomputes its S_{t-1} forward from its
    saved state first, as the kernel does.  r/k/v/w/dy: (BH, T, hd); u:
    (BH, hd); states (BH, n_chunks(T), hd, hd) and dsT (BH, hd, hd)
    float32.  Returns (dr, dk, dv in r's, k's and v's dtypes; dw (BH, T,
    hd), du (BH, hd) and ds0 (BH, hd, hd) float32)."""
    rf, kf, vf, wf, dyf = (t.float() for t in (r, k, v, w, dy))
    uf = u.float()
    BH, T, hd = rf.shape
    G = (torch.zeros((BH, hd, hd), dtype=torch.float32, device=rf.device)
         if dsT is None else dsT.float())
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for c in reversed(range(n_chunks(T))):
        t0, t1 = c * CHUNK, min(T, (c + 1) * CHUNK)
        S, prev = states[:, c].float(), []
        for t in range(t0, t1):
            prev.append(S)
            S = wf[:, t, :, None] * S + kf[:, t, :, None] * vf[:, t, None, :]
        for t in reversed(range(t0, t1)):
            Sp = prev[t - t0]
            vdy = (vf[:, t] * dyf[:, t]).sum(-1, keepdim=True)
            ru = (rf[:, t] * uf * kf[:, t]).sum(-1, keepdim=True)
            dr[:, t] = torch.einsum("bij,bj->bi", Sp, dyf[:, t]) \
                + uf * kf[:, t] * vdy
            dk[:, t] = uf * rf[:, t] * vdy \
                + torch.einsum("bij,bj->bi", G, vf[:, t])
            dv[:, t] = ru * dyf[:, t] + torch.einsum("bij,bi->bj", G, kf[:, t])
            dw[:, t] = (G * Sp).sum(-1)
            du = du + rf[:, t] * kf[:, t] * vdy
            G = wf[:, t, :, None] * G + rf[:, t, :, None] * dyf[:, t, None, :]
    return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, G
