"""Serving launcher: the port of ``repro.launch.serve``.

Prefill, then batched greedy decode on a mesh (``--model-parallel``; bf16
weights from a seeded generator, placed per ``sharding.rules``, and bf16
caches sharded as ``cache_sharding`` says), under ``sharding_rules(mesh)``.
The batch is made as the reference makes it: random prompt tokens, plus
``prompt_len // 4`` encoder frames for an encoder-decoder model and 256
patch embeddings (x 0.02) for a vision model, from
``np.random.RandomState(0)`` in the reference's order.
Attention takes the plain path (``use_flash=False``, as the reference's
``make_prefill_step(cfg)``); RMSNorm (and rwkv6's WKV6) take their
kernels on the card, on each rank's shard.  Without a process group the
launcher makes a world of one rank (NCCL on the card, gloo on the CPU: a
(1, 1) mesh), which serves on plain tensors (the same tokens, without
``DTensor``'s host cost on every operation); under ``torchrun
--nproc-per-node N`` it uses torchrun's world.  Runs on the card unless
``--device cpu``; on the CPU use ``--reduced``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_12b \\
        --reduced --batch 2 --prompt-len 32 --new-tokens 16 --device cpu

``generate`` is the body, for a caller that brings its own config (a depth
cut), model or mesh (without one it runs on plain tensors).
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch.mesh import init_world, make_mesh_for, mesh_axes
from repro_torch.models import LM, init_cache, init_lm
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import whole
from repro_torch.runtime.steps import make_decode_step, make_prefill_step
from repro_torch.sharding.context import sharding_rules
from repro_torch.sharding.rules import (NamedSharding, batch_spec,
                                        cache_sharding, logical_to_physical,
                                        param_sharding)


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
             model: Optional[LM] = None, mesh=None) -> dict:
    """Prefill and ``new_tokens - 1`` greedy decode steps.  Returns the
    generated tokens (B, new_tokens) int32 on the host, the logits of
    every step (the prefill's first; f32 (B, V) each, on ``device``), the
    model, the device batch and the seconds from prefill to the last
    token on the host.  With ``mesh`` the model, caches and batch are
    placed on it and the steps run under ``sharding_rules(mesh)``; the
    logits come back whole."""
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
    rules = contextlib.nullcontext()
    if mesh is not None:
        logical_to_physical(mesh, model, param_sharding(model, mesh))
        cache = logical_to_physical(mesh, cache, cache_sharding(cache, mesh))
        bspec = batch_spec(mesh)
        dev = {k: logical_to_physical(mesh, v, NamedSharding(mesh, bspec[k]))
               for k, v in dev.items()}
        rules = sharding_rules(mesh)

    t0 = time.time()
    with rules:
        logits, cache = prefill(model, dev, cache)
        steps = [whole(logits)]
        nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
        generated = [whole(nxt).cpu().numpy()]
        for i in range(new_tokens - 1):
            nxt, logits, cache = decode(model, nxt, cache, prompt_len + i)
            steps.append(whole(logits))
            generated.append(whole(nxt).cpu().numpy())
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
    ap.add_argument("--model-parallel", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: --device cuda but no CUDA device is "
                         "available; pass --device cpu")
    made = init_world(device)
    try:
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        cfg = get_config(args.arch, reduced=args.reduced)
        mesh = make_mesh_for(dist.get_world_size(), args.model_parallel)
        rank = dist.get_rank()
        out = generate(cfg, batch=args.batch, prompt_len=args.prompt_len,
                       new_tokens=args.new_tokens, device=device,
                       mesh=mesh if mesh.size() > 1 else None)
    finally:
        if made:
            dist.destroy_process_group()
    if rank:                         # one copy of the lines, from rank 0
        return
    toks = args.batch * args.new_tokens
    dt = out["seconds"]
    print(f"device {args.device} | generated {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s)")
    print("sample:", out["tokens"][0][:12])
    print(f"mesh {mesh_axes(mesh)}")


if __name__ == "__main__":
    main()
