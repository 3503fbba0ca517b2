"""AdamW with global-norm clipping, warmup-cosine schedule, and optional
8-bit (blockwise-quantized) first/second moments: the port of
``repro.optim.adamw``.

The reference returns new parameters and a new state; here ``update``
writes both in place under ``torch.no_grad()``.  Parameters are a mapping
of name to tensor, or an ``nn.Module`` (its named parameters).  The
schedule and the bias corrections are computed on the host in float32, as
the reference computes them on the device; the update of each leaf runs on
the leaf's device.

A leaf counts as a matrix, for the decoupled weight decay and the q8
moments, when it has two axes or more *in the reference's layout*.  The
reference stacks every block parameter of an LM with a leading layer axis,
so a block's norm scale is a matrix there; a module says so through
``reference_ndim(name)`` (``models.transformer.LM`` does), and the optimizer
then treats the leaf as the reference does.  Quantizing along the last axis
only makes a stacked leaf's codes the stack of its layers' codes.

On a mesh (``DTensor`` parameters) the q8 codes (..., nb, 128) and scales
(..., nb) are ``DTensor``s laid out by ``sharding.rules.q8_specs`` (the
reference's ``opt_leaf_sharding``): each rank dequantizes, updates and
requantizes its own blocks, and every block lies inside one shard.  Where
the blocks' layout differs from the parameter's (fewer ranks on the block
axis, or blocks that pad the last axis) the values are redistributed to
the parameter's layout for the update and back.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 128


# ----------------------------------------------------------------------
# blockwise int8 quantization
# ----------------------------------------------------------------------
def quantize_q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise-absmax int8 quantization along the LAST axis only.

    codes: int8 of shape (*lead, nb, BLOCK); scales: f32 (*lead, nb)."""
    if x.dim() == 0:
        x = x[None]
    *lead, last = x.shape
    pad = (-last) % BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    nb = (last + pad) // BLOCK
    xb = x.reshape(*lead, nb, BLOCK)
    scale = torch.clamp_min(xb.abs().amax(-1) / 127.0, 1e-12)
    codes = torch.clamp(torch.round(xb / scale[..., None]), -127, 127
                        ).to(torch.int8)
    return codes, scale.float()


def dequantize_q8(codes: torch.Tensor, scales: torch.Tensor,
                  shape) -> torch.Tensor:
    xb = codes.float() * scales[..., None]
    *lead, nb, blk = xb.shape
    full = xb.reshape(*lead, nb * blk)
    shape = tuple(shape)
    last = shape[-1] if shape else 1
    if nb * blk != last:
        full = full[..., :last]
    return full.reshape(shape)


class Q8State(NamedTuple):
    codes: torch.Tensor
    scales: torch.Tensor


Moment = Union[torch.Tensor, Q8State]


# ----------------------------------------------------------------------
@dataclass
class AdamWState:
    """``step`` counts the updates applied; ``m`` and ``v`` map each leaf's
    name to its moment (a float32 tensor, or a ``Q8State``)."""
    step: int
    m: Dict[str, Moment]
    v: Dict[str, Moment]


def named_leaves(params) -> List[Tuple[str, torch.Tensor, int]]:
    """(name, tensor, rank in the reference's layout) of every leaf of a
    mapping or an ``nn.Module``."""
    if isinstance(params, torch.nn.Module):
        ref_ndim = getattr(params, "reference_ndim", None)
        return [(n, p, ref_ndim(n) if ref_ndim else p.dim())
                for n, p in params.named_parameters()]
    return [(n, p, p.dim()) for n, p in params.items()]


class AdamW:
    def __init__(self, lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: float = 1.0, warmup: int = 100,
                 total_steps: int = 10_000, quantized: bool = False):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.warmup, self.total_steps = warmup, total_steps
        self.quantized = quantized

    # -- schedule -------------------------------------------------------
    def schedule(self, step: int) -> float:
        """The learning rate at ``step``, in float32 as the reference
        computes it."""
        f32 = np.float32
        step = f32(step)
        warm = np.minimum(step / f32(max(1, self.warmup)), f32(1.0))
        prog = np.clip((step - f32(self.warmup))
                       / f32(max(1, self.total_steps - self.warmup)),
                       f32(0.0), f32(1.0))
        cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * prog))
        return float(f32(self.lr) * warm * (f32(0.1) + f32(0.9) * cos))

    # -- state ----------------------------------------------------------
    def _zeros_like(self, p: torch.Tensor, ndim: int) -> Moment:
        if self.quantized and ndim >= 2:
            if hasattr(p, "device_mesh"):
                return _q8_zeros_on_shards(p)
            return Q8State(*quantize_q8(torch.zeros_like(
                p, dtype=torch.float32)))
        # zeros_like keeps a DTensor parameter's placements
        return torch.zeros_like(p, dtype=torch.float32)

    def init(self, params) -> AdamWState:
        leaves = named_leaves(params)
        return AdamWState(
            step=0,
            m={n: self._zeros_like(p, nd) for n, p, nd in leaves},
            v={n: self._zeros_like(p, nd) for n, p, nd in leaves})

    # -- update ---------------------------------------------------------
    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params) -> dict:
        """One step: writes the parameters and ``state`` in place and
        returns the metrics ``grad_norm`` (a float32 tensor on the
        parameters' device) and ``lr`` (a float, known on the host: no
        upload).  A leaf missing from ``grads``, or ``None`` there, has a
        zero gradient."""
        leaves = named_leaves(params)
        step = state.step + 1
        lr = self.schedule(step)
        g_of = {n: (grads.get(n) if grads.get(n) is not None
                    else torch.zeros_like(p, dtype=torch.float32))
                for n, p, _ in leaves}

        # global-norm clip (f32 accumulation)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g_of[n].float()))
                               for n, _, _ in leaves))
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)

        b1, b2 = self.b1, self.b2
        f32 = np.float32
        c1 = float(f32(1.0) - f32(b1) ** f32(step))
        c2 = float(f32(1.0) - f32(b2) ** f32(step))
        for n, p, ndim in leaves:
            g = g_of[n].float() * scale
            m, v = state.m[n], state.v[n]
            is_q = isinstance(m, Q8State)
            mf = _dequantize(m, p) if is_q else m
            vf = _dequantize(v, p) if is_q else v
            mf.mul_(b1).add_(g, alpha=1 - b1)
            vf.mul_(b2).add_(g.square_(), alpha=1 - b2)
            del g
            delta = (mf / c1).div_((vf / c2).sqrt_().add_(self.eps))
            if ndim >= 2:  # decoupled weight decay on matrices only
                delta.add_(p.float(), alpha=self.weight_decay)
            # p + (-lr * delta) is p - lr * delta, one rounding each
            if p.dtype == torch.float32:
                p.add_(delta.mul_(-lr))
            else:
                p.copy_((p.float() + delta.mul_(-lr)).to(p.dtype))
            del delta
            if is_q:
                state.m[n] = _quantize(mf, m)
                state.v[n] = _quantize(vf, v)
        state.step = step
        return {"grad_norm": gnorm, "lr": lr}


# ----------------------------------------------------------------------
# q8 moments of DTensor parameters: the blocks laid out by
# ``sharding.rules.q8_specs``, each rank's blocks dequantized, updated and
# requantized on its own shard
# ----------------------------------------------------------------------
def _q8_zeros_on_shards(p) -> Q8State:
    """The q8 zeros of DTensor ``p``: codes 0 and scales 1e-12 (what
    ``quantize_q8`` gives for zeros), made on each rank's shard."""
    from torch.distributed.tensor import zeros
    from ..sharding.rules import NamedSharding, q8_specs, spec_of
    mesh = p.device_mesh
    nb = -(-p.shape[-1] // BLOCK)
    lead = tuple(p.shape[:-1])
    cs, ss = q8_specs(spec_of(p.placements, mesh, p.dim()),
                      lead + (nb, BLOCK), lead + (nb,), mesh)
    codes = zeros(lead + (nb, BLOCK), dtype=torch.int8, device_mesh=mesh,
                  placements=NamedSharding(mesh, cs).placements)
    scales = zeros(lead + (nb,), dtype=torch.float32, device_mesh=mesh,
                   placements=NamedSharding(mesh, ss).placements)
    return Q8State(codes, scales.add_(1e-12))


def _element_placements(q: Q8State, padded: bool) -> tuple:
    """The placements of a q8 moment's values (..., nb * BLOCK): the block
    axis's shards on the last axis (replicated there when the blocks pad
    the parameter's last axis), the leading axes' as the codes'."""
    from torch.distributed.tensor import Replicate, Shard
    nbdim = q.codes.dim() - 2
    return tuple((Replicate() if padded else Shard(nbdim))
                 if pl.is_shard(nbdim) else pl for pl in q.codes.placements)


def _dequantize(q: Q8State, p) -> torch.Tensor:
    """A q8 moment's values in ``p``'s shape (and, for a DTensor ``p``, its
    layout)."""
    if not hasattr(p, "device_mesh"):
        return dequantize_q8(q.codes, q.scales, p.shape)
    from torch.distributed.tensor import DTensor
    mesh = p.device_mesh
    last = p.shape[-1]
    padded = q.codes.shape[-2] * BLOCK != last
    if padded:       # whole block rows on each rank, then the padding cut
        codes = q.codes.redistribute(placements=_element_placements(
            q, True)).to_local()
        scales = q.scales.redistribute(placements=_element_placements(
            q, True)).to_local()
        local = (codes.float() * scales[..., None]).reshape(
            *codes.shape[:-2], -1)[..., :last]
    else:
        codes, scales = q.codes.to_local(), q.scales.to_local()
        local = (codes.float() * scales[..., None]).reshape(
            *codes.shape[:-2], -1)
    vals = DTensor.from_local(local, mesh, _element_placements(q, padded),
                              run_check=False)
    return vals.redistribute(placements=p.placements)


def _quantize(x: torch.Tensor, like: Q8State) -> Q8State:
    """``x`` quantized as ``quantize_q8`` does, in ``like``'s layout where
    ``like`` is a DTensor moment."""
    if not hasattr(like.codes, "device_mesh"):
        return Q8State(*quantize_q8(x))
    from torch.distributed.tensor import DTensor
    mesh = like.codes.device_mesh
    padded = like.codes.shape[-2] * BLOCK != x.shape[-1]
    local = x.redistribute(placements=_element_placements(
        like, padded)).to_local()
    codes, scales = quantize_q8(local)
    if padded:       # every rank holds all blocks: keep its own
        rep = _element_placements(like, True)
        return Q8State(
            DTensor.from_local(codes, mesh, rep, run_check=False)
            .redistribute(placements=like.codes.placements),
            DTensor.from_local(scales, mesh, rep, run_check=False)
            .redistribute(placements=like.scales.placements))
    return Q8State(
        DTensor.from_local(codes, mesh, like.codes.placements,
                           run_check=False),
        DTensor.from_local(scales, mesh, like.scales.placements,
                           run_check=False))
