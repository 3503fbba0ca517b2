"""Gradient compression with error feedback: the port of
``repro.optim.compress``.

Int8 blockwise quantization of gradients before the data-parallel
reduction, with per-rank error-feedback accumulators (Seide et al. / 1-bit
Adam lineage): the quantization residual is carried into the next step, so
the *expected* update is unbiased and convergence is preserved.

``compressed_psum`` runs on every rank of ``group`` with that rank's own
gradients (where the reference runs inside ``shard_map`` with an
``axis_name``: PyTorch has no named axes inside a traced body).  The
dequantized values are bf16; the reduction sums them in float32, as the
reference's ``psum(q.astype(float32))`` does, and divides by the group's
size.  A bf16 ``all_reduce`` would round every partial sum of the ring to
bf16 and miss the reference's mean by far more than float32's rounding.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from .adamw import dequantize_q8, quantize_q8


def compress_with_feedback(grad: torch.Tensor, err: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize (grad + err) to int8 blocks; return (dequantized bf16,
    new_err).  grad/err: f32 tensors of equal shape."""
    g = grad.float() + err
    codes, scales = quantize_q8(g)
    deq = dequantize_q8(codes, scales, g.shape)
    new_err = g - deq
    return deq.to(torch.bfloat16), new_err


def _process_group(group):
    """A process group, or the group of a 1-D ``DeviceMesh`` (a mesh
    dimension, ``mesh["data"]``)."""
    if hasattr(group, "get_group"):
        return group.get_group()
    return group


def compressed_psum(grads: Dict[str, torch.Tensor],
                    errs: Dict[str, torch.Tensor], group=None):
    """Error-feedback compressed data-parallel mean-reduction over
    ``group`` (a process group or a mesh dimension; None is the world).

    ``grads`` and ``errs`` map leaf names to this rank's float32 tensors.
    Returns (reduced f32 grads, new error-feedback state), both keyed as
    ``grads``."""
    pg = _process_group(group)
    n = dist.get_world_size(pg)
    red, new_errs = {}, {}
    for name, g in grads.items():
        q, new_errs[name] = compress_with_feedback(g, errs[name])
        total = q.float()
        dist.all_reduce(total, group=pg)
        red[name] = total / n
    return red, new_errs


def init_error_feedback(params) -> Dict[str, torch.Tensor]:
    """Zero float32 error-feedback state for a mapping of tensors or an
    ``nn.Module``'s named parameters."""
    items = (params.named_parameters() if isinstance(params, torch.nn.Module)
             else params.items())
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in items}
