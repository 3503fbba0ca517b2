"""Counts the PyTorch operations (aten calls, views included) and the
hand-written kernels' launches that one ``ServingEngine`` decode step
issues, per layer and per step: the host's work per decode token.  The
steps are the engine's own (``make_prefill_step`` with flash on the card,
``make_decode_step``), on a cache made as the engine makes it.  The count
at two depths gives the per-layer cost; the rest lies outside the layers
(embedding, final norm, head, argmax).

On the card (the default) the published widths run at depths of 2 and 4
layer groups with float32 weights, as the engine serves them; a CUDA
kernel's launch is one call through its wrapper, whose own bookkeeping
operations are counted.  ``--device cpu`` (with ``--reduced``) counts the
plain versions instead: each RMSNorm is several operations there.

    PYTHONPATH=src python scripts/torch_op_count.py hymba_1_5b qwen3_32b
    PYTHONPATH=src python scripts/torch_op_count.py --device cpu --reduced
"""
from __future__ import annotations

import argparse
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.rmsnorm import ops as rmsnorm
from repro_torch.kernels.rwkv6 import ops as wkv6
from repro_torch.models import init_cache, init_lm
from repro_torch.runtime.steps import make_decode_step, make_prefill_step

KERNELS = {"flash_attention": flash, "rmsnorm": rmsnorm, "wkv6": wkv6}


class _Count(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def decode_ops(arch: str, n_layers: int, device: str, reduced: bool,
               prompt: int = 64) -> tuple:
    """(aten operations, kernel launches) of the second decode step of a
    batch of 2 after a ``prompt``-token prefill, at ``n_layers``."""
    cfg = dataclasses.replace(get_config(arch, reduced=reduced),
                              n_layers=n_layers)
    if cfg.n_encoder_layers:
        raise ValueError(f"{arch}: the serving engine takes tokens only, and "
                         f"an encoder-decoder needs frames")
    model = init_lm(cfg, torch.Generator(device).manual_seed(0),
                    device=device)
    prefill = make_prefill_step(cfg, use_flash=device == "cuda")
    decode = make_decode_step(cfg)
    toks = torch.randint(0, cfg.vocab, (2, prompt), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    toks = toks.to(device)
    with torch.no_grad():
        cache = init_cache(cfg, 2, prompt + 2, device)
        logits, cache = prefill(model, {"tokens": toks}, cache)
        nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
        nxt, _, cache = decode(model, nxt, cache, prompt)
        for mod in KERNELS.values():
            mod.launches = 0
        with _Count() as count:
            decode(model, nxt, cache, prompt + 1)
    launches = sum(mod.launches for mod in KERNELS.values())
    del model, cache
    if device == "cuda":
        torch.cuda.empty_cache()
    return count.n, launches


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("archs", nargs="*", default=["hymba_1_5b"])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_op_count: --device cuda but no CUDA device "
                           "is available; pass --device cpu --reduced")
    for arch in args.archs:
        full = get_config(arch)
        g = full.layer_group
        (a, ka), (b, kb) = (decode_ops(arch, m * g, args.device,
                                       args.reduced) for m in (2, 4))
        per_layer, k_layer = (b - a) / (2 * g), (kb - ka) / (2 * g)
        print(f"{arch} on {args.device}: {per_layer:.1f} aten operations "
              f"and {k_layer:.1f} kernel launches a layer and decode step, "
              f"{a - per_layer * 2 * g:.0f} and {ka - k_layer * 2 * g:.0f} "
              f"outside the layers; {a + per_layer * (full.n_layers - 2 * g):.0f}"
              f" operations a step at the published {full.n_layers} layers")


if __name__ == "__main__":
    main()
