"""Mixture-of-Experts FFN of the port (dbrx 16e/top-4; qwen2-moe 60e/top-4
+ shared), step for step ``repro.models.moe``.

Capacity-based dispatch through a scatter and a gather rather than one-hot
einsums, grouped by batch row: each row scatters its own routed tokens
into per-expert buffers of ``cap`` slots (Switch-style capacity, with the
same tokens dropped as the reference: queue positions come from a stable
sort of the token-major expert ids).  The reference scatters with an
out-of-bounds slot ``E * cap`` that ``mode="drop"`` discards and gathers
back with ``mode="fill"`` zeros; here that slot is one trash row, sliced
off before the expert FFN, and a zero row appended before the gather.

Expert weights carry a leading expert axis, are stored in f32 and cast to
the activation dtype at every call, as the reference does.  The expert
products are plain batched ``einsum``s (the reference leaves them to XLA,
outside any Pallas kernel).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import as_dtensor, is_dtensor, kernel_placements
from ..sharding.context import shard_activations, use_weight
from .layers import MLP, normal_init


class MoE(nn.Module):
    """Router (d, E) f32, expert weights ``w_in``/``w_gate`` (E, d, f) and
    ``w_out`` (E, f, d), and a shared ``MLP`` of width ``d_ff_expert *
    n_shared_experts`` where the config has shared experts."""

    def __init__(self, cfg, generator, device, dtype=torch.float32) -> None:
        super().__init__()
        e = cfg.moe
        d = cfg.d_model
        self.cfg = cfg
        self.router = normal_init((d, e.n_experts), generator, device,
                                  dtype=torch.float32)
        self.w_in = normal_init((e.n_experts, d, e.d_ff_expert), generator,
                                device, dtype=dtype)
        self.w_out = normal_init((e.n_experts, e.d_ff_expert, d), generator,
                                 device, dtype=dtype)
        if cfg.mlp in ("swiglu", "geglu"):
            self.w_gate = normal_init((e.n_experts, d, e.d_ff_expert),
                                      generator, device, dtype=dtype)
        self.shared = (MLP(cfg, d, e.d_ff_expert * e.n_shared_experts,
                           generator, device, dtype)
                       if e.n_shared_experts else None)

    def forward(self, x):
        return apply_moe(self.cfg, self, x)


def capacity(cfg, S: int) -> int:
    """Slots per expert and batch row: ``S * k * cf / E``, at least ``k``
    and at most ``S``."""
    e = cfg.moe
    return min(int(max(e.top_k, S * e.top_k * e.capacity_factor
                       / e.n_experts)), S)


def _router_logits(x, w):
    """(B, S, d) x (d, E) -> (B, S, E) in f32; a ``DTensor`` on each rank's
    tokens with the router whole (its product's backward then never
    reshapes a sharded token axis)."""
    def logits(x, w):
        return torch.einsum("bsd,de->bse", x.float(), w)
    if not is_dtensor(x):
        return logits(x, w)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = kernel_placements(x, (0, 1))
    rep = (Replicate(),) * len(pl)
    dw = tuple(Partial() if p.is_shard() else Replicate() for p in pl)
    return local_map(logits, out_placements=list(pl), in_placements=(pl, rep),
                     in_grad_placements=(pl, dw), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, as_dtensor(w, x.device_mesh))


def route(cfg, router, x) -> Dict[str, torch.Tensor]:
    """Softmax router in f32, top-k, renormalised gates, and each routed
    token's slot in its expert's buffer.

    x: (B, S, d).  Returns ``logits``, ``probs`` (B, S, E) f32, ``gates``
    and ``expert_ids`` (B, S, k), and over the flattened (B, S*k) routed
    tokens ``keep`` (inside the capacity) and ``slot`` (``expert * cap +
    position``, or the trash slot ``E * cap`` where dropped)."""
    e = cfg.moe
    B, S, _ = x.shape
    logits = _router_logits(x, use_weight(router, (None, None)))
    probs = torch.softmax(logits, dim=-1)
    gates, expert_ids = torch.topk(probs, e.top_k, dim=-1)     # (B, S, k)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)

    cap = capacity(cfg, S)
    Tk = S * e.top_k
    flat_ids = expert_ids.reshape(B, Tk)
    # Position of each routed token within its expert's queue: a stable
    # sort keeps token-major order inside each expert, so the first ``cap``
    # tokens routed to an expert are kept, as in the reference.
    order = torch.argsort(flat_ids, dim=1, stable=True)
    sorted_ids = flat_ids.gather(1, order)
    # per-row expert counts by comparison, as the reference counts them
    # (a scatter into fresh zeros has no DTensor form in place)
    iota_e = torch.arange(e.n_experts, dtype=flat_ids.dtype, device=x.device)
    counts = (flat_ids[:, :, None] == iota_e).sum(1)            # (B, E)
    starts = torch.cumsum(counts, dim=1) - counts               # (B, E)
    ranks_sorted = (torch.arange(Tk, device=x.device)[None, :]
                    - starts.gather(1, sorted_ids))
    pos = torch.empty_like(flat_ids).scatter(1, order, ranks_sorted)
    keep = pos < cap
    slot = torch.where(keep, flat_ids * cap + pos,
                       torch.full_like(flat_ids, e.n_experts * cap))
    return dict(logits=logits, probs=probs, gates=gates,
                expert_ids=expert_ids, keep=keep, slot=slot, cap=cap)


_EP_IN = (("model", None, None), (None, None, "model"))
_EP_OUT = (("model", None, None), (None, "model", None))


def _expert_ffn(cfg, p: MoE, x):
    """x: (B, E, C, d) -> (B, E, C, d), batched over row and expert.
    Expert weights are constrained to EP (expert axis over "model") when
    the expert count divides, else to TP on the expert FFN dim."""
    h = torch.einsum("becd,edf->becf", x,
                     use_weight(p.w_in.to(x.dtype), *_EP_IN))
    if cfg.mlp == "swiglu":
        g = torch.einsum("becd,edf->becf", x,
                         use_weight(p.w_gate.to(x.dtype), *_EP_IN))
        h = F.silu(g) * h
    elif cfg.mlp == "geglu":
        g = torch.einsum("becd,edf->becf", x,
                         use_weight(p.w_gate.to(x.dtype), *_EP_IN))
        h = F.gelu(g, approximate="tanh") * h
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("becf,efd->becd", h,
                        use_weight(p.w_out.to(x.dtype), *_EP_OUT))


def _zeros_as(x, shape):
    """Zeros of ``shape`` in ``x``'s type and place; for a ``DTensor`` x,
    made shard by shard in its batch layout (``new_zeros`` on a
    ``DTensor`` makes the whole global tensor on every rank: 60 GiB for
    dbrx's expert buffer at 32k tokens)."""
    if not is_dtensor(x):
        return x.new_zeros(shape)
    from torch.distributed.tensor import zeros
    return zeros(shape, dtype=x.dtype, device_mesh=x.device_mesh,
                 placements=kernel_placements(x, (0,)))


def apply_moe(cfg, p: MoE, x) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (out, aux).  ``aux`` holds the reference's
    load-balance and router z losses (``moe_aux``, ``moe_z``, f32 scalars)
    and ``moe_kept``, the routed tokens each batch row kept (B,), all left
    on ``x``'s device."""
    e = cfg.moe
    B, S, d = x.shape
    r = route(cfg, p.router, x)
    cap, slot, keep = r["cap"], r["slot"], r["keep"]
    Tk = S * e.top_k
    idx = slot[..., None].expand(B, Tk, d)

    # Scatter: row E * cap is the trash row of the dropped tokens.
    xrep = shard_activations(
        x.repeat_interleave(e.top_k, dim=1))                   # (B, S*k, d)
    idx = shard_activations(idx)
    buf = shard_activations(_zeros_as(x, (B, e.n_experts * cap + 1, d)))
    buf = shard_activations(buf.scatter(1, idx, xrep))
    expert_in = buf[:, :-1].reshape(B, e.n_experts, cap, d)

    expert_out = _expert_ffn(cfg, p, expert_in)

    # Gather back (a dropped token reads the appended zero row) and
    # combine with the gates.
    flat_out = shard_activations(torch.cat(
        [expert_out.reshape(B, e.n_experts * cap, d),
         _zeros_as(x, (B, 1, d))], dim=1))
    routed = shard_activations(flat_out.gather(1, idx))
    gates = (r["gates"].reshape(B, Tk) * keep).to(x.dtype)
    combined = (routed * gates[..., None]).reshape(B, S, e.top_k, d).sum(2)

    if p.shared is not None:
        combined = combined + p.shared(x)

    # aux losses (Switch-style load balance + router z-loss)
    density = F.one_hot(r["expert_ids"], e.n_experts).float().mean((0, 1, 2))
    density_proxy = r["probs"].mean((0, 1))
    aux = {
        "moe_aux": e.n_experts * torch.sum(density * density_proxy)
        * e.aux_loss,
        "moe_z": torch.mean(torch.logsumexp(r["logits"], -1) ** 2)
        * e.router_z_loss,
        "moe_kept": keep.sum(1),
    }
    return combined, aux
