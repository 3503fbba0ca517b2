"""Serving launcher: the port of ``repro.launch.serve`` on one device.

Prefill, then batched greedy decode, with bf16 weights from a seeded
generator and bf16 caches.  The batch is made as the reference makes it:
random prompt tokens, plus ``prompt_len // 4`` encoder frames for an
encoder-decoder model and 256 patch embeddings (x 0.02) for a vision
model, from ``np.random.RandomState(0)`` in the reference's order.
Attention takes the plain path (``use_flash=False``, as the reference's
``make_prefill_step(cfg)``); RMSNorm takes its kernel on the card.  The
reference's mesh flag (``--model-parallel``) belongs to the multi-device
slice.  Runs on the card unless ``--device cpu``; on the CPU use
``--reduced``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_12b \\
        --reduced --batch 2 --prompt-len 32 --new-tokens 16 --device cpu

``generate`` is the body, for a caller that brings its own config (a depth
cut) or model.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import LM, init_cache, init_lm
from repro_torch.models.config import ArchConfig
from repro_torch.runtime.steps import make_decode_step, make_prefill_step


def make_batch(cfg: ArchConfig, batch: int, prompt_len: int) -> dict:
    """The reference launcher's host batch: tokens, then frames or
    patches, drawn in that order from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    out = {"tokens": rng.randint(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)}
    if cfg.n_encoder_layers:
        out["frames"] = rng.randn(batch, prompt_len // 4,
                                  cfg.d_model).astype(np.float32)
    if cfg.frontend == "vision":
        out["patches"] = rng.randn(batch, cfg.n_frontend_tokens,
                                   cfg.d_model).astype(np.float32) * 0.02
    return out


def generate(cfg: ArchConfig, *, batch: int = 2, prompt_len: int = 32,
             new_tokens: int = 16, device="cuda",
             model: Optional[LM] = None) -> dict:
    """Prefill and ``new_tokens - 1`` greedy decode steps.  Returns the
    generated tokens (B, new_tokens) int32 on the host, the logits of
    every step (the prefill's first; f32 (B, V) each, on ``device``), the
    model, the device batch and the seconds from prefill to the last
    token on the host."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: device='cuda' but no CUDA device is "
                           "available; pass device='cpu'")
    if model is None:
        model = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                        device=device, dtype=torch.bfloat16)
    max_len = prompt_len + new_tokens
    cross = prompt_len // 4 if cfg.n_encoder_layers else 0
    cache = init_cache(cfg, batch, max_len, device, cross_len=cross)
    host = make_batch(cfg, batch, prompt_len)
    dev = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)

    t0 = time.time()
    logits, cache = prefill(model, dev, cache)
    steps = [logits]
    nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
    generated = [nxt.cpu().numpy()]
    for i in range(new_tokens - 1):
        nxt, logits, cache = decode(model, nxt, cache, prompt_len + i)
        steps.append(logits)
        generated.append(nxt.cpu().numpy())
    dt = time.time() - t0
    return {"tokens": np.concatenate(generated, axis=1), "logits": steps,
            "model": model, "batch": dev, "seconds": dt}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3_12b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: --device cuda but no CUDA device is "
                         "available; pass --device cpu")
    cfg = get_config(args.arch, reduced=args.reduced)
    out = generate(cfg, batch=args.batch, prompt_len=args.prompt_len,
                   new_tokens=args.new_tokens, device=device)
    toks = args.batch * args.new_tokens
    dt = out["seconds"]
    print(f"device {device} | generated {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s)")
    print("sample:", out["tokens"][0][:12])


if __name__ == "__main__":
    main()
