"""Host time of a call through each hand-written kernel's wrapper on the
card, at the serving paths' decode shapes, and of one qwen3_32b decode
step (full width, 2 layers, batch 2) through the engine's step functions.

RMSNorm at qwen3_32b's decode shapes (the Norm's (2, 1, 5120) and the
q-norm's (2, 1, 64, 128), bf16 rows, float32 scale), WKV6 at rwkv6_1_6b's
decode step (B 2, T 1, H 32, hd 64) and flash attention at a short prefill
(B 2, S 16, H 64 / Hkv 8, hd 128, bf16).  A wrapper's time is the host
clock over 500 calls issued back to back, without a synchronize inside
(the device runs these kernels in a few microseconds, so the host's issue
rate is what is measured), the median of 5 rounds; the decode step's is
its wall with a synchronize, the median of 20 steps.

    PYTHONPATH=src python scripts/torch_wrapper_cost.py
    python scripts/torch_wrapper_cost.py --src build/parent/src --label parent

``--src`` imports ``repro_torch`` from another checkout's ``src`` (an
earlier commit's wrappers, timed in the same process layout).  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time


def wrapper_us(fn, args, calls: int = 500, rounds: int = 5) -> float:
    import torch
    for _ in range(50):
        fn(*args)
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


def decode_step_ms(steps: int = 20) -> float:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_lm
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    cfg = dataclasses.replace(get_config("qwen3_32b"), n_layers=2)
    model = init_lm(cfg, torch.Generator("cuda").manual_seed(0),
                    device="cuda")
    prefill = make_prefill_step(cfg, use_flash=True)
    decode = make_decode_step(cfg)
    toks = torch.randint(0, cfg.vocab, (2, 64), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0)).cuda()
    cache = init_cache(cfg, 2, 64 + steps + 4, "cuda")
    logits, cache = prefill(model, {"tokens": toks}, cache)
    nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
    walls = []
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, _, cache = decode(model, nxt, cache, 64 + i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    del model, cache
    torch.cuda.empty_cache()
    return statistics.median(walls[2:])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None,
                    help="a checkout's src directory to import from")
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch_wrapper_cost: needs a CUDA device")
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.rwkv6 import ops as wkv
    g = torch.Generator("cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    f32 = torch.float32
    cases = {
        "rmsnorm (2, 1, 5120)": (rms.rmsnorm, (rnd(2, 1, 5120),
                                               rnd(5120, dtype=f32))),
        "rmsnorm q-norm (2, 1, 64, 128)": (rms.rmsnorm, (
            rnd(2, 1, 64, 128), rnd(128, dtype=f32))),
        "wkv6 decode (2, 1, 32, 64)": (wkv.wkv6, (
            rnd(2, 1, 32, 64, dtype=f32), rnd(2, 1, 32, 64, dtype=f32),
            rnd(2, 1, 32, 64, dtype=f32),
            torch.rand((2, 1, 32, 64), generator=g, device="cuda") * 0.5
            + 0.4, rnd(32, 64, dtype=f32), rnd(2, 32, 64, 64, dtype=f32))),
        "flash (2, 16, 64/8, 128)": (flash.flash_attention, (
            rnd(2, 16, 64, 128), rnd(2, 16, 8, 128), rnd(2, 16, 8, 128))),
    }
    out = {"label": args.label}
    with torch.no_grad():
        for name, (fn, a) in cases.items():
            out[name] = wrapper_us(fn, a)
            print(f"[{args.label}] {name}: {out[name]:.2f} us a call "
                  f"(host)")
        out["qwen3 decode step ms"] = decode_step_ms()
    print(f"[{args.label}] qwen3_32b decode step (2 layers, batch 2): "
          f"{out['qwen3 decode step ms']:.3f} ms")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
