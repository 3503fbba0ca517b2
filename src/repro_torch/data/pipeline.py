"""Deterministic synthetic token pipeline: the port of
``repro.data.pipeline``, numpy only, with batches equal to the reference's
bit for bit.

Host-side batch generation is deliberately a *host computation* so the
trainer can overlap it (and its H2D transfer) with the previous step's
device compute — the paper's transfer/compute overlap applied to the
training loop.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np

from ..models.config import ArchConfig


class SyntheticTokenStream:
    """Reproducible stream: batch(step) is a pure function of (seed, step) —
    this is what makes checkpoint-restart exactly resumable."""

    def __init__(self, cfg: ArchConfig, seq_len: int, global_batch: int,
                 accum: int = 1, seed: int = 0,
                 host_latency_s: float = 0.0) -> None:
        if global_batch % accum:
            raise ValueError(f"global_batch {global_batch} is not a multiple "
                             f"of accum {accum}")
        self.cfg = cfg
        self.seq = seq_len
        self.micro = global_batch // accum
        self.accum = accum
        self.seed = seed
        self.host_latency_s = host_latency_s

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        if self.host_latency_s:
            time.sleep(self.host_latency_s)
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % 2**31)
        cfg = self.cfg
        shape = (self.accum, self.micro, self.seq + 1)
        toks = rng.randint(0, cfg.vocab, size=shape).astype(np.int32)
        out = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        if cfg.n_encoder_layers:
            out["frames"] = rng.randn(self.accum, self.micro, self.seq // 4,
                                      cfg.d_model).astype(np.float32)
        if cfg.frontend == "vision":
            out["patches"] = rng.randn(self.accum, self.micro,
                                       cfg.n_frontend_tokens,
                                       cfg.d_model).astype(np.float32) * 0.02
        return out

    def nbytes(self) -> int:
        b = self.batch(0)
        return sum(v.nbytes for v in b.values())


def batch_specs(cfg: ArchConfig, seq_len: int, global_batch: int,
                accum: int = 1):
    """(shape, dtype) of each leaf of one training batch: the reference's
    ``ShapeDtypeStruct``s as plain tuples."""
    micro = global_batch // accum
    specs = {
        "tokens": ((accum, micro, seq_len), np.int32),
        "labels": ((accum, micro, seq_len), np.int32),
    }
    if cfg.n_encoder_layers:
        specs["frames"] = ((accum, micro, seq_len // 4, cfg.d_model),
                           np.float32)
    if cfg.frontend == "vision":
        specs["patches"] = ((accum, micro, cfg.n_frontend_tokens,
                             cfg.d_model), np.float32)
    return specs
