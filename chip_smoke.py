#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Three phases, each of which raises on failure (nothing is caught):

1. build: compiles every CUDA kernel of the port from ``src/repro_torch``
   with ``nvcc`` (one process per source, all at once) into ``build/``;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it and a few more (ragged S, hd=256 with a
   sliding window, softcap with MQA, float32), with its time, the plain
   version's time, one PyTorch library call's time and the card's bound;
3. serving: the main path, LM serving through the scheduler.  Full-width
   ``qwen3_32b`` cut to 4 layers, random weights from a seeded generator,
   8 requests of 1024-token prompts in batches of 2 on CUDA-stream lanes.
   Checks the tokens, the lanes and that every prefill attention went
   through the hand-written kernel.

``--profile`` adds two warm serving runs, the second under ``torch.profiler``,
and a run under the serial policy.

Prints the card's name and power limit, one ``{"kernels": [...]}`` JSON line
and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository beside it, it exits non-zero and prints no result.
Imports neither ``jax`` nor the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core rate, HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 2e-5}     # as tests/test_kernels.py

# The kernel phase: (name, B, S, H, Hkv, hd, dtype, causal, window, softcap).
# The first case is the shape the serving phase gives the kernel.
FLASH_CASES = [
    ("qwen3_32b prefill", 2, 1024, 64, 8, 128, "bfloat16", True, 0, 0.0),
    ("gemma3 local hd256", 2, 2048, 16, 8, 256, "bfloat16", True, 1024, 0.0),
    ("softcap MQA ragged", 1, 1000, 8, 1, 64, "bfloat16", True, 0, 30.0),
    ("f32 window ragged", 1, 333, 4, 2, 128, "float32", True, 100, 0.0),
    ("f32 non-causal window", 2, 256, 4, 2, 64, "float32", False, 64, 20.0),
]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(S: int, causal: bool, window: int) -> int:
    import numpy as np
    q = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    mask = np.ones((S, S), bool)
    if causal:
        mask &= k <= q
    if window > 0:
        mask &= (q - k) < window
    return int(mask.sum())


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.compile_all()
    print(f"[build] {len(logs)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    timing = None
    for (label, B, S, H, Hkv, hd, dt, causal, window, softcap) in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((B, S, n, hd), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
                   for n in (H, Hkv, Hkv))
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = attention_ref(q.float(), k.float(), v.float(), **kw)
        err = (got.float() - ref).abs()
        tol = TOL[dt]
        bad = int((err > tol + tol * ref.abs()).sum())
        worst = max(worst, float(err.max()))
        print(f"[kernels] flash_attention {label}: B={B} S={S} H={H} "
              f"Hkv={Hkv} hd={hd} {dt} causal={causal} window={window} "
              f"softcap={softcap}: max_abs_err={float(err.max()):.3e} "
              f"(tol {tol}), {bad} elements out of tolerance")
        if bad or not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention disagrees with "
                                 f"attention_ref on {label}")
        if timing is None:   # the serving shape
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            kernel_ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw),
                                iters=20)
            plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw), iters=5)
            library_ms = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
            flops = 4 * B * H * hd * visible_pairs(S, causal, window)
            nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, got))
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
            timing = dict(ms=kernel_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                          library_ms=library_ms,
                          bound_ms=max(t_ops, t_bytes) * 1e3,
                          bound_by="operations" if t_ops >= t_bytes
                          else "bytes", flops=flops, bytes=nbytes)
            print(f"[kernels] flash_attention at the serving shape: "
                  f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"SDPA {library_ms:.4f} ms, bound {timing['bound_ms']:.4f} "
                  f"ms ({timing['bound_by']}; {flops:.4e} FLOP, "
                  f"{nbytes:.4e} B)")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:30",
                max_abs_err=worst, **timing)


def device_busy_us(events) -> tuple:
    """(union of device-kernel intervals, first start to last end), in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type.name == "CUDA")
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, (spans[-1][1] - spans[0][0]) if spans else 0.0


def profile_serving(eng, prompts, card: str) -> None:
    """Two more flushes of the same requests on the warm engine: one timed,
    one under ``torch.profiler`` for the device busy share and the kernels
    that take the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p)
    eng.flush()
    eng.collect()
    torch.cuda.synchronize()
    print(f"[profile] warm run: wall {time.perf_counter() - t0:.4f} s "
          f"({card})")
    # The same requests under the serial policy (GrCUDA's baseline: one
    # lane, each batch waited for before the next is issued), warm.
    from repro_torch.core import make_scheduler
    from repro_torch.runtime import ServingEngine
    serial = ServingEngine(eng.cfg, eng.params_v.device,
                           batch_size=eng.batch, max_new_tokens=eng.max_new,
                           scheduler=make_scheduler("serial"))
    for rep in ("cold", "warm"):
        t0 = time.perf_counter()
        for p in prompts:
            serial.submit(p)
        serial.flush()
        serial.collect()
        torch.cuda.synchronize()
        print(f"[profile] serial policy, {rep} run: wall "
              f"{time.perf_counter() - t0:.4f} s ({card})")
    serial.sched.close()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p)
        eng.flush()
        eng.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, span = device_busy_us(prof.events())
    print(f"[profile] warm run under the profiler: wall {wall:.4f} s, "
          f"device busy {busy / 1e6:.4f} s over a {span / 1e6:.4f} s device "
          f"span, idle share of the wall {1 - busy / 1e6 / wall:.4f} ({card})")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40)
    for line in table.splitlines():
        print(f"[profile] {line}")


def phase_serving(card: str, profile: bool = False) -> int:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import init_cache, init_lm
    from repro_torch.runtime import (ServingEngine, make_decode_step,
                                     make_prefill_step)

    cfg = dataclasses.replace(get_config("qwen3_32b"), n_layers=4)
    batch, new, plen, n_req = 2, 16, 1024, 8
    t0 = time.perf_counter()
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    torch.cuda.synchronize()
    print(f"[serving] {cfg.name} at full width, {cfg.n_layers} layers: "
          f"{sum(p.numel() for p in model.parameters()):,} f32 parameters, "
          f"init {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, plen).astype(np.int32)
               for _ in range(n_req)]
    prompts[6] = prompts[1].copy()        # same prompt in another batch

    # Direct call of the port's prefill and decode, outside the scheduler,
    # on the first batch (this also warms the card up).
    prefill = make_prefill_step(cfg, use_flash=True)
    decode = make_decode_step(cfg)
    toks = torch.from_numpy(np.stack(prompts[:batch])).cuda()
    cache = init_cache(cfg, batch, plen + new, "cuda")
    logits_flash, cache = prefill(model, {"tokens": toks}, cache)
    nxt = torch.argmax(logits_flash, -1)[:, None].to(torch.int32)
    direct = [nxt]
    for i in range(new - 1):
        nxt, _, cache = decode(model, nxt, cache, plen + i)
        direct.append(nxt)
    direct = torch.cat(direct, 1).cpu().numpy()
    logits_plain, _ = make_prefill_step(cfg, use_flash=False)(
        model, {"tokens": toks}, init_cache(cfg, batch, plen + new, "cuda"))
    lerr = float((logits_flash - logits_plain).abs().max())
    lscale = float(logits_plain.abs().max())
    print(f"[serving] prefill logits, flash vs plain attention: max abs "
          f"diff {lerr:.3e} at logit scale {lscale:.3e}")
    # The bf16 tolerance 2e-2, relative to the logit scale: at full width
    # the logits reach several units, where one bf16 step is 0.03 and the
    # two paths round the attention output at different places.
    if not lerr <= TOL["bfloat16"] * lscale:
        raise AssertionError("prefill logits with use_flash=True and False "
                             "disagree beyond the bf16 tolerance")
    del cache, logits_plain
    torch.cuda.synchronize()

    eng = ServingEngine(cfg, model, batch_size=batch, max_new_tokens=new)
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0                      # count the main path only
    t0 = time.perf_counter()
    reqs = [eng.submit(p) for p in prompts]
    eng.flush()
    done = eng.collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches
    stats = eng.stats()
    overlap = eng.sched.timeline.overlap_metrics()
    peak = torch.cuda.max_memory_allocated()
    if profile:
        profile_serving(eng, prompts, card)
    eng.close()

    n_batches = n_req // batch
    print(f"[serving] {n_req} requests, {n_batches} batches: wall "
          f"{wall:.4f} s, {n_req * new / wall:.2f} generated tok/s, "
          f"{n_req * (plen + new) / wall:.2f} prompt+generated tok/s, "
          f"lanes_created {stats['lanes_created']}, flash launches "
          f"{launches}, peak device memory {peak / 2**30:.3f} GiB "
          f"({card})")
    print(f"[serving] overlap_metrics {json.dumps(overlap)} ({card})")
    if len(done) != n_req or any(r.result is None or r.result.shape != (new,)
                                 for r in reqs):
        raise AssertionError("a request came back without a (16,) result")
    if stats["lanes_created"] < 2:
        raise AssertionError(f"only {stats['lanes_created']} lane(s)")
    if launches != cfg.n_layers * n_batches:
        raise AssertionError(f"flash kernel launched {launches} times, "
                             f"expected {cfg.n_layers * n_batches}")
    if not np.array_equal(reqs[1].result, reqs[6].result):
        raise AssertionError("identical prompts gave different tokens")
    got = np.stack([r.result for r in reqs[:batch]])
    if not np.array_equal(got, direct):
        raise AssertionError(f"served tokens {got} differ from the direct "
                             f"prefill/decode call {direct}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    flash = phase_kernels()
    flash["launches"] = phase_serving(card, profile="--profile" in sys.argv)
    print(f"[done] {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"kernels": [flash]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
