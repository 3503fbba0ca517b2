"""Train, prefill and decode steps used by the trainer, the launcher and
the serving engine: the port of ``repro.runtime.steps``.

``make_train_step`` builds the full step: gradient accumulation over
microbatches (``.grad`` is the f32 accumulator), per-block remat, AdamW
(optionally 8-bit state), MoE aux losses.  Where the reference returns a
new ``TrainState``, this step updates the model and the optimizer state in
place and returns the same ``TrainState``.

Under ``sharding.context.sharding_rules(mesh)``, with the model's
parameters placed as ``DTensor``s (``sharding.rules.param_sharding``), the
same step runs sharded: each micro-batch's gradients and the accumulator are
constrained to the parameters' storage sharding
(``constrain_like_params``), and the metrics come back as full tensors.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..models import (LM, cross_entropy_loss, forward_decode, forward_prefill,
                      forward_train)
from ..models.config import ArchConfig
from ..kernels import is_dtensor, kernel_placements
from ..models.convert import whole
from ..optim import AdamW, AdamWState
from ..sharding.context import constrain_like_params


class TrainState(NamedTuple):
    params: LM
    opt: AdamWState


def make_loss_fn(cfg: ArchConfig, use_flash: bool = False,
                 remat: bool = True, seq_shard: bool = False):
    def loss_fn(params, micro_batch):
        logits, aux = forward_train(cfg, params, micro_batch,
                                    use_flash=use_flash, remat=remat,
                                    seq_shard=seq_shard)
        loss = cross_entropy_loss(logits, micro_batch["labels"])
        total = loss + aux["moe_aux"] + aux["moe_z"]
        return total, {"ce_loss": loss, **aux}
    return loss_fn


def make_train_step(cfg: ArchConfig, optimizer: AdamW, *,
                    use_flash: bool = False, remat: bool = True,
                    seq_shard: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch`` leaves are shaped (accum, micro_batch, ...): the step runs the
    backward pass of each microbatch in turn, accumulating f32 gradients,
    divides them by ``accum``, then applies one optimizer update.  Metrics:
    ``loss`` (mean ce loss) and ``grad_norm``, float32 tensors on the
    model's device, and ``lr``.
    """
    loss_fn = make_loss_fn(cfg, use_flash, remat, seq_shard)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        model = state.params
        model.requires_grad_(True)
        accum = batch["tokens"].shape[0]
        named = dict(model.named_parameters())
        # .grad is the f32 accumulator; None stands for its zeros
        for p in named.values():
            p.grad = None
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            total, metrics = loss_fn(model, mb)
            total.backward()
            # keep the accumulator in FSDP storage sharding: DP sync
            # becomes a reduce-scatter, not an all-reduce
            acc = constrain_like_params({n: p.grad for n, p in named.items()
                                         if p.grad is not None})
            for n, g in acc.items():
                if g is not named[n].grad:
                    named[n].grad = g
            loss_sum = loss_sum + whole(metrics["ce_loss"].detach())
        grads = {}
        for n, p in named.items():
            if p.grad is not None:
                grads[n] = p.grad.div_(accum)
        metrics = optimizer.update(grads, state.opt, model)
        metrics["grad_norm"] = whole(metrics["grad_norm"])
        for p in named.values():
            p.grad = None
        metrics["loss"] = loss_sum / accum
        return state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, use_flash: bool = False):
    def prefill_step(params, batch, cache):
        return forward_prefill(cfg, params, batch, cache, use_flash=use_flash)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def serve_step(params, tokens, cache, pos: int):
        """One new token for the whole batch against the caches (KV
        caches or recurrent states)."""
        logits, cache = forward_decode(cfg, params, tokens, cache, pos)
        # argmax gives int64 in torch where jnp.argmax gives int32
        next_tokens = _argmax_rows(logits)[:, None].to(torch.int32)
        return next_tokens, logits, cache
    return serve_step


def _argmax_rows(logits):
    """argmax over the vocab of (B, V) logits; a ``DTensor``'s on each
    rank's rows, the vocab gathered whole first."""
    if not is_dtensor(logits):
        return torch.argmax(logits, dim=-1)
    from torch.distributed.tensor.experimental import local_map
    pl = kernel_placements(logits, (0,))
    return local_map(lambda t: torch.argmax(t, dim=-1),
                     out_placements=list(pl), in_placements=(pl,),
                     device_mesh=logits.device_mesh,
                     redistribute_inputs=True)(logits)
