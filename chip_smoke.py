#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Five phases, each of which raises on failure (nothing is caught):

1. build: compiles every CUDA kernel of the port from ``src/repro_torch``
   with ``nvcc`` (one process per source, all at once) into ``build/``,
   prints ptxas's register and spill report and counts the flash library's
   tensor-core instructions (HGMMA, HMMA) with ``cuobjdump -sass``;
2. kernels: each kernel (flash attention, RMSNorm, WKV6) against its plain
   PyTorch version on the card, at the shapes the serving phases give it
   and a few more (ragged lengths, other head dims, T = 1, float32), with
   its time, the plain version's time, one PyTorch library call's time
   where one computes the same function, and the card's bound; WKV6 also
   at a state-carry split and a repeat run, both held bitwise;
3. qwen3 serving: LM serving through the scheduler.  Full-width
   ``qwen3_32b`` cut to 4 layers, random weights from a seeded generator,
   8 requests of 1024-token prompts in batches of 2 on CUDA-stream lanes.
   Checks the tokens, the lanes and that every prefill attention and every
   RMSNorm went through the hand-written kernels;
4. rwkv serving: the same requests served by ``rwkv6_1_6b`` at full width
   and full depth (24 layers).  Checks the tokens, the lanes, that every
   recurrence (each prefill, and each decode step at T = 1) went through
   the WKV6 kernel, and the prefill logits against the plain recurrence
   after 2 to 24 layers, in float32 and bf16;
5. benchsuite: the paper's six workloads (VEC, B&S, IMG, ML, HITS, DL) at
   their full size (scale 1.0), data made from seed 0, each run through the
   scheduler under the serial and then the parallel policy on CUDA-stream
   lanes (a warm run each, then timed runs in the order serial, parallel,
   parallel, serial).  Holds every result against the port's
   ``run_reference`` on the card, serial against parallel, and VEC and B&S
   against float64 closed forms; prints what one upload costs on the host
   and, per workload, the walls, the speedup, the lanes, the overlap
   metrics, the peak device memory and the port's simulated speedup on the
   paper's three GPUs, then the geomean of the measured speedups beside the
   paper's 1.44.  A parallel run on one lane fails; a slow one does not.

Each serving phase sets every kernel's launch count to 0 just before it
serves and reads the counts just after.  ``--profile`` adds, to each
serving phase, two warm runs, the second under ``torch.profiler``, and runs
under the serial policy; to each benchsuite workload, one more parallel run
under ``torch.profiler``, from whose trace it prints the device's busy and
idle share, the streams that ran kernels (fewer than two fails), the share
of kernel time with kernels on two streams or more, and the share of
host-to-device copy time that overlapped a kernel.

Prints the card's name and power limit, one ``{"kernels": [...]}`` JSON line
and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository beside it, it exits non-zero and prints no result.
Imports neither ``jax`` nor the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core rate, float32
# rate outside the tensor cores, HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 2e-5}     # as tests/test_kernels.py
# WKV6 in float32 sums 64-term products in another order than the plain
# loop, over up to a thousand steps: 1e-4 absolute beside 2e-5 relative.
WKV_ATOL = {"bfloat16": 2e-2, "float32": 1e-4}

# The kernel phase: (name, B, S, H, Hkv, hd, dtype, causal, window, softcap).
# The first case is the shape the serving phase gives the kernel.
FLASH_CASES = [
    ("qwen3_32b prefill", 2, 1024, 64, 8, 128, "bfloat16", True, 0, 0.0),
    ("gemma3 local hd256", 2, 2048, 16, 8, 256, "bfloat16", True, 1024, 0.0),
    ("softcap MQA ragged", 1, 1000, 8, 1, 64, "bfloat16", True, 0, 30.0),
    ("f32 window ragged", 1, 333, 4, 2, 128, "float32", True, 100, 0.0),
    ("f32 non-causal window", 2, 256, 4, 2, 64, "float32", False, 64, 20.0),
]
# (name, B, T, H, hd, dtype of r, k, v); w, u and the state are float32.
# The first case is the prefill shape of the rwkv serving phase, the
# second its decode step; both are timed.
WKV_CASES = [
    ("rwkv6_1_6b prefill", 2, 1024, 32, 64, "bfloat16"),
    ("rwkv6_1_6b decode", 2, 1, 32, 64, "float32"),
    ("f32 ragged T", 1, 333, 4, 64, "float32"),
    ("T=1 (one-token prefill)", 2, 1, 32, 64, "bfloat16"),
    ("reduced hd16 f32 ragged", 2, 37, 4, 16, "float32"),
    ("hd128 bf16 ragged", 1, 50, 2, 128, "bfloat16"),
]
# The WKV6 kernel's instantiations: r/k/v type x head dim x with or without
# the asynchronous copies.  ptxas must report no spill in any of them.
WKV_KERNELS = 12
# (name, shape of x, dtype); scale is float32.  The first three are the
# shapes of the qwen3 serving phase; the first is the row's timing.
RMS_CASES = [
    ("qwen3_32b prefill Norm", (2048, 5120), "bfloat16"),
    ("qwen3_32b prefill q-norm", (131072, 128), "bfloat16"),
    ("qwen3_32b decode Norm", (2, 5120), "bfloat16"),
    ("f32 d=1001", (37, 1001), "float32"),
]


def kernel_ops() -> dict:
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.rmsnorm import ops as rmsnorm
    from repro_torch.kernels.rwkv6 import ops as wkv6
    return {"flash_attention": flash, "rmsnorm": rmsnorm, "wkv6": wkv6}


def reset_launches() -> None:
    for mod in kernel_ops().values():
        mod.launches = 0
    kernel_ops()["wkv6"].launches_t1 = 0


def read_launches() -> dict:
    counts = {name: mod.launches for name, mod in kernel_ops().items()}
    counts["wkv6_t1"] = kernel_ops()["wkv6"].launches_t1
    return counts


def bound(flops: float, nbytes: float, peak_flops: float) -> dict:
    """The least time for the work: operations at the peak rate of their
    type or bytes at the HBM rate, whichever is larger."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes, ops_ms=t_ops * 1e3,
                bytes_ms=t_bytes * 1e3)


def check_close(what: str, got, ref, rtol: float, atol: float) -> float:
    """Max abs error of ``got`` against ``ref``; raises past the
    tolerance or on a value that is not finite."""
    import torch
    err = (got.float() - ref.float()).abs()
    bad = int((err > atol + rtol * ref.float().abs()).sum())
    worst = float(err.max()) if err.numel() else 0.0
    print(f"[kernels] {what}: max_abs_err={worst:.3e} (rtol {rtol}, atol "
          f"{atol}), {bad} elements out of tolerance")
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{what} disagrees with its plain version")
    return worst


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2, args=((),),
            graph: bool = True) -> float:
    """Mean time of ``fn(*args[i % len(args)])`` over ``iters`` calls, on
    CUDA events.  With ``graph`` the calls are captured once in a CUDA
    graph and the graph's replay is timed: the device time, free of the
    host's cost of issuing each call (which bounds small kernels when
    issued one by one).  Without it, the calls are issued eagerly.
    Several argument sets larger than the 50 MB L2 cache together make
    each call find its inputs in HBM, as in the model."""
    import torch

    def run():
        for i in range(iters):
            fn(*args[i % len(args)])
    for i in range(warmup):
        fn(*args[i % len(args)])
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            run()
        g.replay()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
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


def sass_counts(lib_path) -> dict:
    """Tensor-core instructions in a built library's SASS, counted from
    ``cuobjdump -sass`` of the toolkit that built it: HGMMA (wgmma) and HMMA
    (mma.sync).  Raises if ``cuobjdump`` is missing."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool})")
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    lines = sass.splitlines()
    return {op: sum(f" {op}." in ln or f" {op} " in ln for ln in lines)
            for op in ("HGMMA", "HMMA")}


def ptxas_report(text: str) -> list:
    """(kernel, registers, spill stores, spill loads) per kernel of an
    ``nvcc -Xptxas -v`` log, names demangled by ``c++filt`` where the
    machine has it."""
    import re
    import shutil
    rows, name, spill = [], None, ("?", "?")
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, m.group(1), *spill])
            name, spill = None, ("?", "?")
    tool = shutil.which("c++filt")
    if tool and rows:
        names = subprocess.run([tool], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout
        names = names.split("\n")
        for r, n in zip(rows, names):
            n = n.replace("(anonymous namespace)::", "")
            r[0] = n.split("(")[0].removeprefix("void ") or r[0]
    return rows


def phase_build() -> dict:
    """Builds every kernel library, prints ptxas's registers and spills per
    kernel; returns the flash library's SASS tensor-core counts."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.compile_all()
    print(f"[build] {len(logs)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib, text in logs.items():
        rows = ptxas_report(text)
        for kernel, regs, stores, loads in rows:
            print(f"[build] {lib}: {kernel}: {regs} registers, {stores} bytes "
                  f"spill stores, {loads} bytes spill loads")
        if lib == "wkv6" and text:   # "" when built by an earlier run
            spills = [r for r in rows if r[2] != "0" or r[3] != "0"]
            if len(rows) != WKV_KERNELS or spills:
                raise AssertionError(
                    f"wkv6: ptxas reported {len(rows)} kernels (expected "
                    f"{WKV_KERNELS}), spilling: {spills}")
        for line in text.splitlines():
            if "warning" in line or "error" in line:
                print(f"[build] {lib}: {line.strip()}")
    counts = sass_counts(build.library_path("flash_attention"))
    print(f"[build] flash_attention SASS tensor-core instructions: "
          f"{json.dumps(counts)}")
    if not counts["HGMMA"]:
        raise AssertionError("the flash library holds no HGMMA instruction")
    return counts


def phase_flash(sass: dict) -> dict:
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
        worst = max(worst, check_close(
            f"flash_attention {label}: B={B} S={S} H={H} Hkv={Hkv} hd={hd} "
            f"{dt} causal={causal} window={window} softcap={softcap}", got,
            ref, TOL[dt], TOL[dt]))
        if timing is None:   # the serving shape
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            kernel_ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw),
                                iters=20)
            eager_ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw),
                               iters=20, graph=False)
            plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw), iters=5)
            library_ms = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
            flops = 4 * B * H * hd * visible_pairs(S, causal, window)
            nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, got))
            timing = dict(ms=kernel_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                          library_ms=library_ms,
                          **bound(flops, nbytes, PEAK_BF16_FLOPS))
            print(f"[kernels] flash_attention at the serving shape: "
                  f"kernel {kernel_ms:.4f} ms (issued eagerly "
                  f"{eager_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"SDPA {library_ms:.4f} ms, bound {timing['bound_ms']:.4f} "
                  f"ms ({timing['bound_by']}; {flops:.4e} FLOP, "
                  f"{nbytes:.4e} B)")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:30",
                max_abs_err=worst, **timing,
                bf16_kernel="flash_fwd_wgmma_kernel",
                f32_kernel="flash_fwd_simt_kernel", sass=sass)


def wkv6_timing(ops, args, y, sT, label: str, iters: int,
                plain_iters: int) -> dict:
    """The WKV6 kernel's time on ``args`` (CUDA-graph replay, and issued
    eagerly), the plain version's, and the card's bound for the call."""
    r, k, v, w, u, s0 = args
    B, T, H, hd = r.shape
    kernel_ms = time_ms(lambda: ops.wkv6(*args), iters=iters)
    eager_ms = time_ms(lambda: ops.wkv6(*args), iters=iters, graph=False)
    plain_ms = time_ms(lambda: ops.wkv6_plain(*args), iters=plain_iters,
                       warmup=1)
    # The function needs 5 float32 operations per (i, j) of S, per token
    # and head: r^T S (a multiply and an add), then w S + k v^T (two
    # multiplies and an add); r (u * k) v is O(hd).
    flops = 5 * hd * hd * B * T * H
    nbytes = sum(t.numel() * t.element_size()
                 for t in (r, k, v, w, u, s0, y, sT))
    t = dict(ms=kernel_ms, eager_ms=eager_ms, plain_ms=plain_ms,
             library_ms=None, **bound(flops, nbytes, PEAK_F32_FLOPS))
    print(f"[kernels] wkv6 {label}: kernel {kernel_ms:.4f} ms (issued "
          f"eagerly {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
          f"none (no PyTorch call computes WKV6); bytes {nbytes:.4e} B = "
          f"{t['bytes_ms']:.4f} ms at the HBM rate, {flops:.4e} float32 "
          f"FLOP = {t['ops_ms']:.4f} ms at the float32 rate; bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
          f"{t['bound_ms'] / kernel_ms:.3f} of it reached")
    return t


def phase_wkv6() -> dict:
    import torch
    from repro_torch.kernels.rwkv6 import ops

    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    worst, timing, decode = 0.0, None, None
    for i, (label, B, T, H, hd, dt) in enumerate(WKV_CASES):
        dtype = getattr(torch, dt)
        r, k, v = (randn(B, T, H, hd).mul(0.5).to(dtype) for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, T, H, hd) * 0.5))   # float32
        u = randn(H, hd) * 0.3
        s0 = randn(B, H, hd, hd) * 0.1                          # nonzero
        args = (r, k, v, w, u, s0)
        y, sT = ops.wkv6(*args)
        torch.cuda.synchronize()
        want_y, want_s = ops.wkv6_plain(r.float(), k.float(), v.float(), w,
                                        u, s0)
        what = (f"wkv6 {label}: B={B} T={T} H={H} hd={hd} r/k/v {dt}, w f32"
                f", {'with' if ops.uses_ring(*args) else 'without'} the "
                f"asynchronous copies")
        worst = max(worst,
                    check_close(what + " (y)", y, want_y, TOL[dt],
                                WKV_ATOL[dt]),
                    check_close(what + " (state)", sT, want_s, TOL["float32"],
                                WKV_ATOL["float32"]))
        if i == 1:
            decode = wkv6_timing(ops, args, y, sT, "at the decode shape",
                                 iters=200, plain_iters=50)
        if i != 0:
            continue
        # The prefill shape: the state carried across a split that is not
        # a multiple of the kernel's 16-step chunk, and a repeat run.
        h = 517
        y1, s_mid = ops.wkv6(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, s0)
        y2, s_end = ops.wkv6(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u,
                             s_mid)
        if not (torch.equal(torch.cat([y1, y2], 1), y)
                and torch.equal(s_end, sT)):
            raise AssertionError("wkv6 over two parts with the state "
                                 "carried differs from one call")
        y_again, s_again = ops.wkv6(*args)
        if not (torch.equal(y_again, y) and torch.equal(s_again, sT)):
            raise AssertionError("two runs of wkv6 on the same inputs "
                                 "differ")
        print(f"[kernels] wkv6 {label}: two calls split at t={h} with the "
              f"state carried equal one call exactly; a second run equals "
              f"the first exactly")
        timing = wkv6_timing(ops, args, y, sT, "at the serving shape",
                             iters=20, plain_iters=2)
    return dict(name="wkv6", route="cuda",
                source="src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
                replaces="src/repro/kernels/rwkv6/kernel.py:23",
                max_abs_err=worst, **timing,
                decode={k: decode[k] for k in ("ms", "eager_ms", "plain_ms",
                                               "bound_ms", "bound_by")})


def phase_rmsnorm() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, shapes = 0.0, []
    for i, (label, shape, dt) in enumerate(RMS_CASES):
        dtype = getattr(torch, dt)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        scale = torch.randn(shape[-1], generator=gen, device="cuda") * 0.1 + 1
        got = ops.rmsnorm(x, scale)
        torch.cuda.synchronize()
        worst = max(worst, check_close(
            f"rmsnorm {label}: x {shape} {dt}, scale f32", got,
            rmsnorm_ref(x.float(), scale), TOL[dt], TOL[dt]))
        if i >= 3:
            continue
        # Time the serving shapes, each call on inputs out of L2.
        nbytes = 2 * x.numel() * x.element_size() + scale.numel() * 4
        copies = [(x.clone(), scale)
                  for _ in range(min(16, int(1e8 // nbytes) + 1))]
        kernel_ms = time_ms(ops.rmsnorm, iters=50, args=copies)
        eager_ms = time_ms(ops.rmsnorm, iters=50, args=copies, graph=False)
        plain_ms = time_ms(rmsnorm_ref, iters=20, args=copies)
        lib_args = [(c, (shape[-1],), scale.to(dtype), 1e-6)
                    for c, _ in copies]
        library_ms = time_ms(F.rms_norm, iters=50, args=lib_args)
        row = dict(shape=list(shape), ms=kernel_ms, eager_ms=eager_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   **bound(4 * x.numel(), nbytes, PEAK_F32_FLOPS))
        print(f"[kernels] rmsnorm {label}: kernel {kernel_ms:.4f} ms (issued "
              f"eagerly {eager_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, F.rms_norm {library_ms:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {nbytes:.4e} B)")
        shapes.append(row)
        del copies, lib_args
    timing = {k: v for k, v in shapes[0].items() if k != "shape"}
    return dict(name="rmsnorm", route="cuda",
                source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm/kernel.py:16",
                max_abs_err=worst, **timing, shapes=shapes)


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


def profile_serving(eng, prompts, card: str, tag: str) -> None:
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
    print(f"[profile {tag}] warm run: wall {time.perf_counter() - t0:.4f} s "
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
        print(f"[profile {tag}] serial policy, {rep} run: wall "
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
    print(f"[profile {tag}] warm run under the profiler: wall {wall:.4f} s, "
          f"device busy {busy / 1e6:.4f} s over a {span / 1e6:.4f} s device "
          f"span, idle share of the wall {1 - busy / 1e6 / wall:.4f} ({card})")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40)
    for line in table.splitlines():
        print(f"[profile {tag}] {line}")


def make_prompts(cfg, n_req: int, plen: int):
    """Seeded random prompts; request 6 repeats request 1 in another
    batch."""
    import numpy as np
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, plen).astype(np.int32)
               for _ in range(n_req)]
    prompts[6] = prompts[1].copy()
    return prompts


def direct_call(cfg, model, toks, new: int, use_flash: bool = False):
    """Greedy tokens of the port's prefill and decode called directly,
    outside the scheduler, and the prefill logits."""
    import torch
    from repro_torch.models import init_cache
    from repro_torch.runtime import make_decode_step, make_prefill_step
    prefill = make_prefill_step(cfg, use_flash=use_flash)
    decode = make_decode_step(cfg)
    B, plen = toks.shape
    logits, cache = prefill(model, {"tokens": toks},
                            init_cache(cfg, B, plen + new, "cuda"))
    nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
    out = [nxt]
    for i in range(new - 1):
        nxt, _, cache = decode(model, nxt, cache, plen + i)
        out.append(nxt)
    return torch.cat(out, 1).cpu().numpy(), logits


def check_logits(tag: str, what: str, got, want,
                 rtol: float = TOL["bfloat16"]) -> None:
    """Max abs diff within ``rtol`` of the logit scale (by default the
    bf16 tolerance 2e-2: at full width the logits reach several units,
    where one bf16 step is 0.03, and the two paths round at different
    places).  ``rtol=None`` prints the diff without checking it."""
    import torch
    lerr = float((got - want).abs().max())
    lscale = float(want.abs().max())
    held = "not checked" if rtol is None else f"tolerance {rtol}"
    print(f"[{tag}] prefill logits, {what}: max abs diff {lerr:.3e} at "
          f"logit scale {lscale:.3e} ({lerr / lscale:.3e} of it; {held})")
    if not torch.isfinite(got).all() or (rtol is not None
                                         and lerr > rtol * lscale):
        raise AssertionError(f"prefill logits, {what}, disagree beyond "
                             f"{rtol} of the logit scale")


def logits_by_depth(cfg, model, toks, depths, dtype) -> dict:
    """The prefill's last-token logits read out (final norm and head)
    after each of ``depths`` blocks, with the residual stream in
    ``dtype``."""
    import torch
    from repro_torch.models import init_cache
    from repro_torch.models import transformer as T
    B, plen = toks.shape
    positions = torch.arange(plen, device=toks.device)[None, :]
    out = {}
    with torch.no_grad():
        x = T._embed(cfg, model, toks).to(dtype)
        for i, (blk, c) in enumerate(
                zip(model.blocks, init_cache(cfg, B, plen, toks.device)), 1):
            x = T.apply_block_seq(cfg, blk, x, positions, cache=c)
            if i in depths:
                out[i] = T._logits(cfg, model,
                                   model.final_norm(x[:, -1:, :]))[:, 0]
    return out


def serve_and_check(tag: str, cfg, model, prompts, batch: int, new: int,
                    direct, card: str, profile: bool) -> dict:
    """Serve ``prompts`` through the scheduler with every kernel's launch
    count set to 0 just before; returns the counts read just after.
    Raises unless every request got ``new`` tokens, two lanes or more were
    used, identical prompts got identical tokens and the first batch's
    tokens equal ``direct``."""
    import numpy as np
    import torch
    from repro_torch.runtime import ServingEngine
    eng = ServingEngine(cfg, model, batch_size=batch, max_new_tokens=new)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                      # count the main path only
    t0 = time.perf_counter()
    reqs = [eng.submit(p) for p in prompts]
    eng.flush()
    done = eng.collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = eng.stats()
    overlap = eng.sched.timeline.overlap_metrics()
    peak = torch.cuda.max_memory_allocated()
    if profile:
        profile_serving(eng, prompts, card, tag)
    eng.close()

    n_req, plen = len(prompts), len(prompts[0])
    print(f"[{tag}] {n_req} requests, {n_req // batch} batches: wall "
          f"{wall:.4f} s, {n_req * new / wall:.2f} generated tok/s, "
          f"{n_req * (plen + new) / wall:.2f} prompt+generated tok/s, "
          f"lanes_created {stats['lanes_created']}, launches "
          f"{json.dumps(launches)}, peak device memory "
          f"{peak / 2**30:.3f} GiB ({card})")
    print(f"[{tag}] overlap_metrics {json.dumps(overlap)} ({card})")
    if len(done) != n_req or any(r.result is None or r.result.shape != (new,)
                                 for r in reqs):
        raise AssertionError(f"a request came back without a ({new},) "
                             f"result")
    if stats["lanes_created"] < 2:
        raise AssertionError(f"only {stats['lanes_created']} lane(s)")
    if not np.array_equal(reqs[1].result, reqs[6].result):
        raise AssertionError("identical prompts gave different tokens")
    got = np.stack([r.result for r in reqs[:batch]])
    if not np.array_equal(got, direct):
        raise AssertionError(f"served tokens {got} differ from the direct "
                             f"prefill/decode call {direct}")
    return launches


def expect_launches(launches: dict, want: dict) -> None:
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} kernel launched {launches[name]} "
                                 f"times on the main path, expected {n}")


def phase_qwen3(card: str, profile: bool = False) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm

    cfg = dataclasses.replace(get_config("qwen3_32b"), n_layers=4)
    batch, new, plen, n_req = 2, 16, 1024, 8
    t0 = time.perf_counter()
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    torch.cuda.synchronize()
    print(f"[qwen3] {cfg.name} at full width, {cfg.n_layers} layers: "
          f"{sum(p.numel() for p in model.parameters()):,} f32 parameters, "
          f"init {time.perf_counter() - t0:.2f} s")
    prompts = make_prompts(cfg, n_req, plen)
    # The first batch called directly (this also warms the card up), and
    # its prefill logits with the flash kernel against plain attention.
    toks = torch.from_numpy(np.stack(prompts[:batch])).cuda()
    direct, logits_flash = direct_call(cfg, model, toks, new, use_flash=True)
    _, logits_plain = direct_call(cfg, model, toks, 1, use_flash=False)
    check_logits("qwen3", "flash vs plain attention", logits_flash,
                 logits_plain)
    del logits_plain
    torch.cuda.synchronize()

    launches = serve_and_check("qwen3", cfg, model, prompts, batch, new,
                               direct, card, profile)
    n_batches = n_req // batch
    # Per forward call (the prefill and each of new - 1 decode steps):
    # ln1, ln2, q-norm and k-norm in every layer, and the final norm.
    expect_launches(launches, {
        "flash_attention": cfg.n_layers * n_batches,
        "rmsnorm": (4 * cfg.n_layers + 1) * new * n_batches,
        "wkv6": 0})
    return launches


def phase_rwkv(card: str, profile: bool = False) -> dict:
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.models import init_lm
    from repro_torch.models import rwkv as R

    cfg = get_config("rwkv6_1_6b")            # full width and depth
    batch, new, plen, n_req = 2, 16, 1024, 8
    t0 = time.perf_counter()
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    torch.cuda.synchronize()
    print(f"[rwkv] {cfg.name} at full width, {cfg.n_layers} layers: "
          f"{sum(p.numel() for p in model.parameters()):,} f32 parameters, "
          f"init {time.perf_counter() - t0:.2f} s")
    prompts = make_prompts(cfg, n_req, plen)
    toks = torch.from_numpy(np.stack(prompts[:batch])).cuda()
    direct, _ = direct_call(cfg, model, toks, new)
    # The served model's prefill with the WKV6 kernel against the plain
    # recurrence, read out after 2, 4, 8, 16 and 24 layers.  With float32
    # activations only the kernel's float32 sums in another order differ;
    # with random weights each layer amplifies that (on an H100, 2e-6 of
    # the logit scale after 2 layers, 9e-5 after 24), so 1e-3 is held at
    # every depth, twenty times under the bf16 tolerance.  With the served
    # bf16 activations the two paths also round y to bf16 apart in a few
    # elements, which depth amplifies alike (0.8% after 2 layers, 15% after
    # 24): the bf16 tolerance is held at 2 layers and the rest printed.
    depths = (2, 4, 8, 16, cfg.n_layers)
    for dtype, rtol, held in ((torch.float32, 1e-3, depths),
                              (torch.bfloat16, TOL["bfloat16"], depths[:1])):
        got = logits_by_depth(cfg, model, toks, depths, dtype)
        with mock.patch.object(R, "wkv6", ops.wkv6_plain):
            want = logits_by_depth(cfg, model, toks, depths, dtype)
        for n in depths:
            check_logits("rwkv", f"WKV6 kernel vs plain recurrence, {n} "
                         f"layers, {str(dtype)[6:]} activations", got[n],
                         want[n], rtol if n in held else None)
        del got, want
    torch.cuda.synchronize()

    launches = serve_and_check("rwkv", cfg, model, prompts, batch, new,
                               direct, card, profile)
    # One recurrence per layer in each batch's prefill and in each of its
    # new - 1 decode steps (T = 1); the family has no attention and
    # layernorm only.
    n_batches = n_req // batch
    expect_launches(launches, {"wkv6": cfg.n_layers * n_batches * new,
                               "wkv6_t1": cfg.n_layers * n_batches
                               * (new - 1),
                               "flash_attention": 0, "rmsnorm": 0})
    return launches


# The benchsuite phase: full size, iterations per run (the same for every
# workload), and the simulator's settings of benchmarks/bench_speedup.py.
BENCH_SCALE = 1.0
BENCH_ITERS = 4
SIM_SCALE, SIM_ITERS = 0.05, 6
PAPER_GEOMEAN = 1.44
# Serial against parallel and against run_reference: the same kernels on
# the same card, so equal but for HITS's atomic sums (tests/test_benchsuite.py
# holds serial against parallel alike).
BENCH_TOL = dict(rtol=1e-5, atol=1e-6)
# VEC's float32 sums against float64: 1e-6 of the sum of the magnitudes
# summed.  B&S in float64 against scipy's float64 formula.
VEC_CLOSED_RTOL = 1e-6
BS_CLOSED_TOL = dict(rtol=1e-10, atol=1e-10)


def hold(what: str, got: dict, want: dict, rtol: float, atol: float) -> float:
    """Max abs difference of every array of ``got`` against ``want``;
    raises past ``atol + rtol * |want|`` or on a value that is not
    finite."""
    import numpy as np
    worst = 0.0
    for k, ref in want.items():
        # float arrays keep their type (a float32 difference of two close
        # float32 values is exact); integers are compared as float64
        g, r = np.asarray(got[k]), np.asarray(ref)
        if g.dtype.kind != "f" or r.dtype.kind != "f":
            g, r = g.astype(np.float64), r.astype(np.float64)
        if g.shape != r.shape or not np.isfinite(g).all():
            raise AssertionError(f"{what} {k}: shape {g.shape} (want "
                                 f"{r.shape}) or a value not finite")
        err = np.abs(g - r)
        bad = int((err > atol + rtol * np.abs(r)).sum())
        worst = max(worst, float(err.max()) if err.size else 0.0)
        if bad:
            raise AssertionError(f"{what} {k}: {bad} elements out of "
                                 f"tolerance (rtol {rtol}, atol {atol})")
    return worst


def run_workload(bench, data, policy: str) -> dict:
    """One run of ``bench`` through a fresh scheduler on CUDA lanes: its
    results, the wall (host clock, ending in a device synchronize), the
    lanes, the overlap metrics, the peak device memory, and the count and
    summed host-clock time of its upload and kernel elements."""
    import torch
    from repro_torch.core import make_scheduler
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s = make_scheduler(policy, device="cuda")
    try:
        t0 = time.perf_counter()
        out = bench.build(s, data, gpu=None, iters=BENCH_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = {k: [sp.t1 - sp.t0 for sp in s.timeline.spans
                     if sp.kind == k] for k in ("h2d", "compute")}
        return dict(out=out, wall=wall, lanes=s.stats()["lanes_created"],
                    overlap=s.timeline.overlap_metrics(),
                    peak=torch.cuda.max_memory_allocated(),
                    elements={k: [len(v), sum(v)] for k, v in spans.items()})
    finally:
        s.close()


def upload_cost(card: str) -> None:
    """What one upload of VEC's size (25 M float32, 95.4 MiB) costs, three
    times over: from pageable memory (host clock, synchronized); the
    executor's staged path, its host copy into pinned memory (host clock)
    and its DMA (CUDA events); and the executor's whole call until it
    returns and until the copy has finished."""
    import numpy as np
    import torch
    from repro_torch.core.executor import _to_device
    x = np.random.RandomState(0).rand(25_000_000).astype(np.float32)
    dev = torch.device("cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = {k: [] for k in ("pageable_ms", "pin_copy_ms", "dma_ms",
                           "staged_return_ms", "staged_done_ms")}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(x).to(dev, non_blocking=True)
        torch.cuda.synchronize()
        out["pageable_ms"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        pinned = torch.from_numpy(x).pin_memory()
        out["pin_copy_ms"].append((time.perf_counter() - t0) * 1e3)
        start.record()
        pinned.to(dev, non_blocking=True)
        end.record()
        end.synchronize()
        out["dma_ms"].append(start.elapsed_time(end))
        t0 = time.perf_counter()
        y = _to_device(x, dev)
        out["staged_return_ms"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        out["staged_done_ms"].append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(y.cpu(), torch.from_numpy(x)):
            raise AssertionError("the staged upload changed the data")
    print(f"[bench] one 95.4 MiB upload, three times: "
          f"{json.dumps(out)} ({card})")


def simulated_speedups(bench) -> dict:
    """Serial over parallel makespan on the port's simulator for the
    paper's three GPUs, as ``benchmarks/bench_speedup.py`` computes it."""
    from repro_torch.benchsuite import GPUS
    from repro_torch.benchsuite.costmodel import sim_hardware
    from repro_torch.core import make_scheduler
    data = bench.make_data(SIM_SCALE)
    out = {}
    for gname, gpu in GPUS.items():
        t = {}
        for policy in ("serial", "parallel"):
            s = make_scheduler(policy, simulate=True,
                               hw=sim_hardware(gpu, policy))
            bench.build(s, data, gpu=gpu, iters=SIM_ITERS)
            t[policy] = s.timeline.makespan
            s.close()
        out[gname] = t["serial"] / t["parallel"]
    return out


def trace_stats(trace_path: str, wall_s: float) -> dict:
    """Device activity of one ``torch.profiler`` chrome trace: busy and
    idle share of the wall, the streams that ran kernels, the share of
    kernel time with kernels on two streams or more at once, and the share
    of host-to-device copy time that overlapped a kernel."""
    from repro_torch.core.timeline import (_intersect, _k_overlap, _measure,
                                           _union)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels, h2d, other, pageable = {}, [], [], 0
    for e in events:
        if e.get("ph") != "X":
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        cat = e.get("cat", "")
        if cat == "kernel":
            kernels.setdefault(e["args"]["stream"], []).append(span)
        elif cat == "gpu_memcpy" and "HtoD" in e["name"]:
            h2d.append(span)
            pageable += "Pageable" in e["name"]
        elif cat in ("gpu_memcpy", "gpu_memset"):
            other.append(span)
    per_stream = [s for v in kernels.values() for s in _union(v)]
    u_kern = _union(per_stream)
    u_h2d = _union(h2d)
    busy_us = _measure(_union(per_stream + h2d + other))
    t_kern, t_h2d = _measure(u_kern), _measure(u_h2d)
    return dict(
        busy_share=busy_us / 1e6 / wall_s,
        idle_share=1 - busy_us / 1e6 / wall_s,
        kernel_streams=len(kernels),
        kernels=sum(len(v) for v in kernels.values()),
        multi_stream_kernel_share=(_measure(_k_overlap(per_stream, 2))
                                   / t_kern if t_kern else 0.0),
        h2d_copies=len(h2d), h2d_pageable=pageable, h2d_ms=t_h2d / 1e3,
        h2d_overlapping_kernel_share=(_measure(_intersect(u_h2d, u_kern))
                                      / t_h2d if t_h2d else 0.0))


def profile_workload(name: str, bench, data, card: str) -> None:
    """One more parallel run under ``torch.profiler``; its trace goes to
    ``build/profile/``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = run_workload(bench, data, "parallel")
    out_dir = os.path.join(ROOT, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"bench_{name.replace('&', '')}.json")
    prof.export_chrome_trace(path)
    st = trace_stats(path, run["wall"])
    print(f"[profile bench {name}] parallel run under the profiler: wall "
          f"{run['wall']:.4f} s, {json.dumps(st)}, upload elements "
          f"{run['elements']['h2d'][0]} ({card})")
    if st["kernel_streams"] < 2:
        raise AssertionError(f"{name}: every kernel of the parallel run ran "
                             f"on one stream")


def phase_benchsuite(card: str, profile: bool = False) -> None:
    import numpy as np
    import torch
    from repro_torch.benchsuite import BENCHMARKS, GPUS

    t_phase = time.perf_counter()
    upload_cost(card)
    speedups, sims = {}, {}
    for name, bench in BENCHMARKS.items():
        t0 = time.perf_counter()
        data = bench.make_data(BENCH_SCALE, seed=0)
        t_data = time.perf_counter() - t0
        ref = bench.run_reference(data, iters=BENCH_ITERS, device="cuda")
        for policy in ("serial", "parallel"):
            run_workload(bench, data, policy)               # warm
        # Timed in the order serial, parallel, parallel, serial: the walls
        # of one policy spread by up to 4x from run to run (the host's
        # copies into pinned memory, and pinned blocks the caching host
        # allocator adds when more uploads are in flight than before).
        runs = {"serial": [], "parallel": []}
        for policy in ("serial", "parallel", "parallel", "serial"):
            runs[policy].append(run_workload(bench, data, policy))
        (ser, ser2), (par, par2) = runs["serial"], runs["parallel"]
        walls = {k: [r["wall"] for r in v] for k, v in runs.items()}
        errs = {f"{k}_vs_reference": max(
            hold(f"{name} {k} vs run_reference", r["out"], ref, **BENCH_TOL)
            for r in v) for k, v in runs.items()}
        errs["parallel_vs_serial"] = max(
            hold(f"{name} parallel vs serial", p["out"], q["out"],
                 **BENCH_TOL) for p, q in ((par, ser), (par2, ser2)))
        if name == "VEC":
            exact = bench.closed_form(data, iters=BENCH_ITERS)
            scale = np.sum(np.abs(data["x1"].astype(np.float64) ** 2
                                  - data["x2"].astype(np.float64) ** 2))
            errs["vs_float64_closed_form"] = hold(
                f"{name} vs float64", par["out"], exact, 0.0,
                VEC_CLOSED_RTOL * scale)
        elif name == "B&S":
            errs["vs_float64_closed_form"] = hold(
                f"{name} vs float64", par["out"],
                bench.closed_form(data, iters=BENCH_ITERS), **BS_CLOSED_TOL)
        if par["lanes"] < 2:
            raise AssertionError(f"{name}: the parallel run used "
                                 f"{par['lanes']} lane(s)")
        sims[name] = simulated_speedups(bench)
        speedups[name] = (sum(walls["serial"]) / sum(walls["parallel"]))
        nbytes = sum(v.nbytes for v in data.values())
        print(f"[bench {name}] scale {BENCH_SCALE}, {BENCH_ITERS} "
              f"iterations, data {nbytes / 2**20:.1f} MiB made in "
              f"{t_data:.2f} s: serial {json.dumps(walls['serial'])} s, "
              f"parallel {json.dumps(walls['parallel'])} s, speedup (of the "
              f"means) {speedups[name]:.4f}, lanes {par['lanes']}, peak "
              f"device memory {par['peak'] / 2**30:.3f} GiB (serial "
              f"{ser['peak'] / 2**30:.3f}) ({card})")
        print(f"[bench {name}] overlap_metrics parallel "
              f"{json.dumps(par['overlap'])}, serial "
              f"{json.dumps(ser['overlap'])}")
        print(f"[bench {name}] elements [count, summed host-clock s]: "
              f"parallel {json.dumps(par['elements'])}, serial "
              f"{json.dumps(ser['elements'])}")
        print(f"[bench {name}] max abs err {json.dumps(errs)}")
        print(f"[bench {name}] simulated speedup (port's simulator, scale "
              f"{SIM_SCALE}, {SIM_ITERS} iterations; not the card) "
              f"{json.dumps(sims[name])}")
        if profile:
            profile_workload(name, bench, data, card)
        if speedups[name] < 1.0:
            print(f"[bench {name}] finding: the parallel policy is slower "
                  f"than the serial one on this card")
        del data, ref, runs, ser, ser2, par, par2
        gc.collect()
        torch.cuda.empty_cache()

    def geomean(vals):
        return float(np.exp(np.mean(np.log(np.asarray(vals)))))
    sim_gm = {g: geomean([v[g] for v in sims.values()]) for g in GPUS}
    print(f"[bench] geomean speedup of the six workloads on this card "
          f"{geomean(list(speedups.values())):.4f} (paper: {PAPER_GEOMEAN} "
          f"on its GPUs); simulated geomean {json.dumps(sim_gm)}, overall "
          f"{geomean(list(sim_gm.values())):.4f} ({card})")
    print(f"[bench] phase {time.perf_counter() - t_phase:.2f} s")


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
    profile = "--profile" in sys.argv
    t0 = time.perf_counter()
    sass = phase_build()
    rows = [phase_flash(sass), phase_rmsnorm(), phase_wkv6()]
    launches = phase_qwen3(card, profile)
    # The qwen3 engine's reference cycles hold its weights until collected.
    gc.collect()
    torch.cuda.empty_cache()
    rwkv = phase_rwkv(card, profile)
    gc.collect()
    torch.cuda.empty_cache()
    phase_benchsuite(card, profile)
    for row in rows:
        row["launches"] = (rwkv if row["name"] == "wkv6" else launches)[
            row["name"]]
        if row["name"] == "wkv6":
            row["launches_decode"] = rwkv["wkv6_t1"]
            row["launches_prefill"] = rwkv["wkv6"] - rwkv["wkv6_t1"]
    print(f"[done] {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
