"""Prefill and decode steps used by the serving engine.

The training step of ``repro.runtime.steps`` belongs to the training slice
(ROADMAP A5) and is not ported yet.
"""
from __future__ import annotations

import torch

from ..models import forward_decode, forward_prefill
from ..models.config import ArchConfig


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
