"""Train, prefill and decode steps used by the trainer, the launcher and
the serving engine: the port of ``repro.runtime.steps``.

``make_train_step`` builds the full step: gradient accumulation over
microbatches (``.grad`` is the f32 accumulator), per-block remat, AdamW
(optionally 8-bit state), MoE aux losses.  Where the reference returns a
new ``TrainState``, this step updates the model and the optimizer state in
place and returns the same ``TrainState``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..models import (LM, cross_entropy_loss, forward_decode, forward_prefill,
                      forward_train)
from ..models.config import ArchConfig
from ..optim import AdamW, AdamWState


class TrainState(NamedTuple):
    params: LM
    opt: AdamWState


def make_loss_fn(cfg: ArchConfig, use_flash: bool = False,
                 remat: bool = True):
    def loss_fn(params, micro_batch):
        logits, aux = forward_train(cfg, params, micro_batch,
                                    use_flash=use_flash, remat=remat)
        loss = cross_entropy_loss(logits, micro_batch["labels"])
        total = loss + aux["moe_aux"] + aux["moe_z"]
        return total, {"ce_loss": loss, **aux}
    return loss_fn


def make_train_step(cfg: ArchConfig, optimizer: AdamW, *,
                    use_flash: bool = False, remat: bool = True):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch`` leaves are shaped (accum, micro_batch, ...): the step runs the
    backward pass of each microbatch in turn, accumulating f32 gradients,
    divides them by ``accum``, then applies one optimizer update.  Metrics:
    ``loss`` (mean ce loss) and ``grad_norm``, float32 tensors on the
    model's device, and ``lr``.
    """
    loss_fn = make_loss_fn(cfg, use_flash, remat)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        model = state.params
        model.requires_grad_(True)
        accum = batch["tokens"].shape[0]
        for p in model.parameters():
            p.grad = None
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            total, metrics = loss_fn(model, mb)
            total.backward()
            loss_sum = loss_sum + metrics["ce_loss"].detach()
        grads = {}
        for n, p in model.named_parameters():
            if p.grad is not None:
                grads[n] = p.grad.div_(accum)
        metrics = optimizer.update(grads, state.opt, model)
        for p in model.parameters():
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
        next_tokens = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        return next_tokens, logits, cache
    return serve_step
