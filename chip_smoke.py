#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Thirteen phases, each of which raises on failure (nothing is caught):

1. build: compiles every CUDA kernel of the port from ``src/repro_torch``
   with ``nvcc`` (one process per source, all at once) into ``build/``,
   prints ptxas's register and spill report (a spill in any instantiation
   of flash attention, the WKV6 forward or its backward, or a count of
   them other than expected, fails) and counts the flash library's
   tensor-core instructions (HGMMA, HMMA) with ``cuobjdump -sass``;
2. kernels: each kernel (flash attention, RMSNorm, WKV6 and its backward)
   against its plain PyTorch version on the card, at the shapes the
   serving and training phases give it and a few more (ragged lengths,
   other head dims, flash's hd 16 padded, T = 1, float32), with its time
   at the serving shapes (flash also at gemma3's hd 256 and nemotron's hd
   192 in bf16 and float32), the plain version's
   time, one PyTorch library call's time where one computes the same
   function, and the card's bound; WKV6 also at a state-carry split and a
   repeat run, both held bitwise; its backward from the states its
   forward keeps (y and sT of that forward bitwise the forward's), with a
   repeat run held bitwise;
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
   paper's 1.44.  A parallel run on one lane fails; a slow one does not;
6. analysis: the access-mode checker over the port's shipped declarations
   (no issue; the IMG filter cache cleared first, and a blur and a Sobel
   run on the card after it); each workload of phase 5, on phase 5's data,
   under the parallel policy with ``sanitize=True`` (a warm run, then two
   timed runs and two with the const canary off), held equal to phase
   5's parallel runs, with no race and every issued element checked, the
   walls beside the unsanitized ones (the sanitizer's overhead; with
   ``--profile`` also one sanitized run under the profiler); the digest
   of a const operand of VEC's and of ML's size timed on the card and
   held equal to the host's digest of the same bytes; seeded faults on
   the card (a kernel writing its ``const`` operand in
   place, two writers of one array on two lanes), each of which must
   raise; VEC and B&S captured and replayed under ``sanitize=True`` with
   ``verify()``, and an out-of-core capture rewritten by the plan
   optimizer under ``sanitize=True``; bf16 managed arrays moved host to
   device to host bit for bit;
7. moe and daemon: (a) ``qwen2_moe_a2_7b`` as published (24 layers, 60
   experts top-4 and 4 shared, MHA attention) with random weights from a
   seeded generator serves the requests of phases 3 and 4; checks the
   tokens, the lanes, the launches of flash attention and RMSNorm, each
   layer's kept-token count, and the prefill logits with both kernels
   against their plain versions after 2 to 24 layers; (b)
   ``python -m repro_torch.daemon serve --device cuda`` in a process of
   its own, driven through ``DaemonClient`` and the CLI: chain jobs at
   2**24 and ``serve_lm`` jobs equal to the same work in-process, a sleep
   job paused, resumed and cancelled, stats, drain, shutdown and
   ``jobs --audit``; then ``benchmarks/bench_daemon.py``'s ipc, spike and
   calm scenarios at their full sizes with their gates;
8. training, in a process of its own (the ``[memory]`` lines say what
   each earlier phase leaves allocated), which
   asserts that under 1 GiB is allocated when it starts: (a) RMSNorm's autograd function (the kernel's forward, the closed-form
   backward) at the training shapes of (b), and the chunked attention's
   backward in float32 at S 2048, against autograd through their plain
   versions; (b) ``TaskGraphTrainer`` on ``qwen3_32b`` at full width cut
   to 2 layers, random weights from seed 0: 8 steps (seq 128, global
   batch 8, accum 2, AdamW f32, remat, parallel policy), checking finite
   losses, the first against its reckoned value and RMSNorm's launches a
   step, then 5 steps under the serial policy (losses equal) and
   ``run_with_restart(8, fail_at=5)`` with one 30 GB checkpoint (its last
   loss equal); prints the step time, tok/s, peak memory and the
   scheduler's stats, and with ``--profile`` one step under the profiler;
   (c) ``python -m repro_torch.launch.train --reduced`` on the card, 12
   steps, then 6 and 12 resumed from its checkpoint: the resumed
   ``step N:`` lines equal the uninterrupted ones; and the same launcher
   on the reduced ``rwkv6_1_6b`` (hd 16), 12 steps; (d)
   ``TaskGraphTrainer`` on ``rwkv6_1_6b`` at full width and depth (24
   layers), random weights from seed 0: 6 steps (seq 1024, global batch 8,
   accum 2, AdamW f32, remat, parallel policy) through the WKV6 forward
   and backward kernels with every plain version refused, checking finite
   losses, the first against its reckoned value and both kernels' launches
   a step, then 3 steps under the serial policy (losses equal), and one
   step's gradients at full width cut to 2 layers against the same step
   through autograd of the plain recurrence, with float32 activations
   (held per leaf and over all leaves) and with bf16 ones (held against
   the float32 gradients no farther than the plain path's); prints the
   step time, tok/s and peak memory. In (a) also WKV6's autograd function at (d)'s
   micro-batch shape against autograd through the plain recurrence;
9. families, in a process of its own: (a) ``hymba_1_5b`` as published (32
   hybrid layers of sliding-window attention and Mamba heads, 6.6 GB f32)
   serves 8 requests of 2048 tokens (the window of 1024 binds in the flash
   kernel and prefill rolls the ring buffer), with the prefill logits of
   flash against plain attention after 2 and 32 layers in float32 and
   bf16, the launch counts, and the serial policy against four lanes in
   turns; (b) ``python -m repro_torch.launch.serve`` on
   ``seamless_m4t_medium`` as published, as a subprocess whose lines go
   through and whose exit code is asserted; (c) ``internvl2_76b`` at full
   width cut to 8 of its 80 layers (bf16, 18 GB) through
   ``launch.serve.generate`` with its 256 patch embeddings: the patch
   positions, RMSNorm on bf16 scales against its plain version, the
   launch counts;
10. the mesh, in a process of its own over an NCCL world of one rank, a
   (1, 1) ``("data", "model")`` mesh (the round has one card: values on
   meshes of several ranks are held on the CPU by the gloo tests), which
   asserts that under 1 GiB is allocated when it starts: (a) phase 8b's
   model and batch, 3 steps of ``make_train_step`` on plain tensors, then
   3 with the parameters as ``DTensor``s under ``sharding_rules``: losses
   and every parameter equal to rtol 1e-5, RMSNorm 34 launches a step
   through ``local_map``, step times and peak memory; (b) a
   ``SpaceSharedRunner`` on ``SubmeshPool()`` runs two prefills of phase
   3's model bit for bit equal to direct calls, under one declared
   identity; (c) ``launch.serve.main`` on ``rwkv6_1_6b`` as published
   with ``--model-parallel 2``: its lines, served on plain tensors (a
   world of one rank), then ``launch.serve.generate`` with the model on
   the (1, 1) mesh, WKV6 through ``local_map`` and its tokens equal to
   the launcher's sample;
   (d) ``compressed_psum`` on a full-width gradient leaf equal to
   ``compress_with_feedback``'s values, timed beside a plain
   ``all_reduce``.  In (a), (b) and (c) a plain version of a kernel
   called on the card fails the phase;
11. the dry run, in a process of its own: (a) ``python -m
   repro_torch.launch.dryrun`` on ``qwen3_32b`` x train_4k on (16, 16),
   ``nemotron_4_340b`` x train_4k on (2, 16, 16) with q8 moments and
   ``rwkv6_1_6b`` x long_500k and x train_4k on (16, 16), each in a
   process of its own on fake CUDA tensors in a fake world of 256 or 512
   ranks: each cell's roofline terms, peak and trace time, every kernel
   counted as launches of its operator (WKV6 once a layer in decode; in
   training its forward twice and its backward once a layer and
   microbatch: no plain loop); (b) phase 8b's cell
   (``qwen3_32b`` at full width, 2 layers, seq 128, batch 8, accum 2) on
   the (1, 1) mesh of an NCCL world of one rank, counted on fake tensors
   by ``build_cell`` and ``count_step``, then the same step run on the
   card under the same counter: the flops equal to 1e-6, RMSNorm 34
   launches, the predicted peak against ``max_memory_allocated()`` of the
   counted step and of the step without the counter (ratios held in
   ``PEAK_RATIO`` and ``PEAK_RATIO_UNCOUNTED``), the step's time beside
   the counted roofline terms and its share of the bf16 peak; a plain
   version of a kernel called on the card fails the phase;
12. configurations, in a process of its own (run right after phase 4,
   while this process holds least on the card): ``gemma3_12b`` (12 of 48
   layers, prompts of 2048, so its window of 1024 binds, and two global
   layers), ``starcoder2_15b`` (8 of 40), ``nemotron_4_340b`` (2 of 96,
   hd 192, bf16 weights) and ``dbrx_132b`` (4 of 40; 16 experts top-4) at
   full width, f32 weights from seed 0 but nemotron's, each serving phase
   3's 8 requests in batches of 2 with 16 new tokens: the prefill logits
   with flash against the plain attention (float32 and bf16 activations,
   as phase 9a; dbrx's bf16 ones held only up to the first layer whose
   routing the two paths split, its flash shape in phase 2), the tokens
   equal to a direct call under both
   policies, the launch counts the model implies (flash a layer a batch;
   RMSNorm for gemma3's norms and qk-norms, none for the three LayerNorm
   configs), the parameter count, init time, tok/s, the four-lane and
   serial walls and the peak memory; a plain version of a kernel called
   on the card fails the phase;
13. the core runtime, in a process of its own, on CUDA-stream lanes at the
   size of phase 5's operands: (a) 32 random DAG programs
   (``tests/_torch_core_programs.py``: 6 float32 arrays of 16 Mi
   elements, 14 kernels of every access-mode pattern), each issued with
   every element in flight under the parallel policy (edges, lanes,
   events and stats equal the simulator's, one CUDA stream a lane), then
   free-running under both policies (timed): the three runs bitwise
   equal, numpy's values within rtol 1e-6; (b) §IV-C's host access: a
   host read of an array another lane owns beside a 200 ms kernel
   returns in under 20 ms, a host write to an array that kernel reads
   waits for it; (c) the out-of-core pipeline, 8 chunks of 1 GiB (a 24
   GiB working set, n halved until the host holds three times it)
   through an 8 GiB budget under the parallel policy with the plan
   optimizer, eagerly and in 3 captured episodes: right values, spills
   and reloads, ``verify(physical=True)`` green, the card's allocation at
   its peak within the budget and a chunk, and after each episode within
   64 MiB of the bytes the ledger says are installed; the wall, the bytes
   spilled and reloaded and the effective upload rate beside one pinned
   DMA's; (d) the memory suite's concurrent sync-against-launch stress
   and capture demotion at 64 MiB arrays; (e) eight independent matmuls
   on the lanes, then the card back at the phase's baseline within 64
   MiB once every scheduler is closed.

Each serving phase, phase 8b's and 8d's first runs and 9c's launcher run
set every kernel's launch count to 0 just before it runs and reads the
counts just after.
``--profile`` adds, to each serving phase, two warm runs, the second under
``torch.profiler``, and runs under the serial policy; to phase 8b one
profiled step; to each benchsuite workload, one more parallel run
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

import contextlib
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

# The kernel phase: (name, B, S, H, Hkv, hd, dtype, causal, window,
# softcap, timed), where timed is the key of the case's timing in the row
# or None.  The timed cases are the shapes the serving phases give the
# kernel (qwen3: GQA groups of 8; qwen2-moe: MHA, H = Hkv = 16; hymba:
# groups of 5 at hd 64 with a window of 1024 that binds at S 2048; gemma3's
# local layers at hd 256, window 1024 at S 2048; nemotron's hd 192, groups
# of 12) and the float32 kernel at nemotron's shape; the first is the
# row's timing.  starcoder2's and dbrx's prefill shapes, which phase 12
# serves, are held here too, untimed.  hd 16 is a reduced config's, padded
# to 64 by the wrapper.
FLASH_CASES = [
    ("qwen3_32b prefill", 2, 1024, 64, 8, 128, "bfloat16", True, 0, 0.0,
     "gqa"),
    ("qwen2_moe prefill MHA", 2, 1024, 16, 16, 128, "bfloat16", True, 0,
     0.0, "mha"),
    ("hymba_1_5b prefill window", 2, 2048, 25, 5, 64, "bfloat16", True,
     1024, 0.0, "hymba"),
    ("gemma3_12b prefill local hd256", 2, 2048, 16, 8, 256, "bfloat16", True,
     1024, 0.0, "gemma3"),
    ("nemotron_4_340b prefill hd192", 2, 1024, 96, 8, 192, "bfloat16", True,
     0, 0.0, "nemotron"),
    ("nemotron_4_340b shape f32 hd192", 2, 1024, 96, 8, 192, "float32",
     True, 0, 0.0, "nemotron_f32"),
    ("starcoder2_15b prefill", 2, 1024, 48, 4, 128, "bfloat16", True, 0,
     0.0, None),
    ("dbrx_132b prefill", 2, 1024, 48, 8, 128, "bfloat16", True, 0, 0.0,
     None),
    ("softcap MQA ragged", 1, 1000, 8, 1, 64, "bfloat16", True, 0, 30.0,
     None),
    ("f32 window ragged", 1, 333, 4, 2, 128, "float32", True, 100, 0.0,
     None),
    ("f32 non-causal window", 2, 256, 4, 2, 64, "float32", False, 64, 20.0,
     None),
    ("f32 hd192 window ragged", 1, 333, 8, 2, 192, "float32", True, 100,
     0.0, None),
    ("padded hd16 MQA ragged", 2, 77, 4, 1, 16, "bfloat16", True, 0, 0.0,
     None),
]
# The flash library's instantiations: the float32 kernel at 4 head dims,
# the bf16 kernel at 4 head dims with and without the softcap.  ptxas must
# report no spill in any of them.
FLASH_KERNELS = 12
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
# The WKV6 backward's: the cluster kernel for each r/k/v type, head dim and
# with or without the asynchronous copies, and du's kernel.
WKV_BWD_KERNELS = 13
# (name, B, T, H, hd, dtype of r, k, v, nonzero s0 and dsT).  The first is
# rwkv6_1_6b's training shape (phase 8d's micro-batch: B 4, seq 1024),
# timed, with a zero s0 and no dsT as the training loss gives it.
WKV_BWD_CASES = [
    ("rwkv6_1_6b training", 4, 1024, 32, 64, "bfloat16", False),
    ("f32 s0 and dsT", 2, 256, 8, 64, "float32", True),
    ("f32 ragged T", 1, 333, 4, 64, "float32", True),
    ("hd16 ragged", 2, 37, 4, 16, "bfloat16", True),
    ("hd128 ragged", 1, 50, 2, 128, "bfloat16", True),
    ("f32 hd128 past a chunk", 1, 17, 2, 128, "float32", True),
]
# The backward's tolerances, each of the scale of its output (its largest
# element): bf16 dr, dk and dv are rounded to bf16 (2^-8 relative); float32
# outputs sum the same products in another order over up to a thousand
# steps.
WKV_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# (name, shape of x, dtype[, dtype of the scale: float32 where not given]).
# All but the last are the shapes of the serving phases (qwen3, qwen2-moe,
# hymba, and internvl's bf16 scales from the serving launcher's bf16
# weights), each timed; the first is the row's timing.
RMS_CASES = [
    ("qwen3_32b prefill Norm", (2048, 5120), "bfloat16"),
    ("qwen3_32b prefill q-norm", (131072, 128), "bfloat16"),
    ("qwen3_32b decode Norm", (2, 5120), "bfloat16"),
    ("qwen2_moe prefill Norm", (2048, 2048), "bfloat16"),
    ("qwen2_moe decode Norm", (2, 2048), "bfloat16"),
    ("hymba_1_5b prefill Norm", (4096, 1600), "bfloat16"),
    ("hymba_1_5b decode Norm", (2, 1600), "bfloat16"),
    ("internvl2_76b prefill Norm", (2048, 8192), "bfloat16", "bfloat16"),
    ("f32 d=1001", (37, 1001), "float32"),
]
RMS_TIMED = len(RMS_CASES) - 1


def kernel_ops() -> dict:
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.rmsnorm import ops as rmsnorm
    from repro_torch.kernels.rwkv6 import ops as wkv6
    return {"flash_attention": flash, "rmsnorm": rmsnorm, "wkv6": wkv6}


def reset_launches() -> None:
    for mod in kernel_ops().values():
        mod.launches = 0
    kernel_ops()["wkv6"].launches_t1 = 0
    kernel_ops()["wkv6"].launches_bwd = 0


def read_launches() -> dict:
    counts = {name: mod.launches for name, mod in kernel_ops().items()}
    counts["wkv6_t1"] = kernel_ops()["wkv6"].launches_t1
    counts["wkv6_bwd"] = kernel_ops()["wkv6"].launches_bwd
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


def visible_mask(S: int, causal: bool, window: int):
    """(S, S) boolean on the card: query i sees key j."""
    import torch
    q = torch.arange(S, device="cuda")[:, None]
    k = torch.arange(S, device="cuda")[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device="cuda")
    if causal:
        mask &= k <= q
    if window > 0:
        mask &= (q - k) < window
    return mask


def visible_pairs(S: int, causal: bool, window: int) -> int:
    return int(visible_mask(S, causal, window).sum())


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
        want = {"wkv6": WKV_KERNELS, "wkv6_bwd": WKV_BWD_KERNELS,
                "flash_attention": FLASH_KERNELS}
        if lib in want and text:   # "" when built by an earlier run
            spills = [r for r in rows if r[2] != "0" or r[3] != "0"]
            if len(rows) != want[lib] or spills:
                raise AssertionError(
                    f"{lib}: ptxas reported {len(rows)} kernels (expected "
                    f"{want[lib]}), spilling: {spills}")
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
    timed = {}
    for (label, B, S, H, Hkv, hd, dt, causal, window, softcap,
         key) in FLASH_CASES:
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
        if key is not None:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            # SDPA with the same mask: is_causal without a window, else
            # the causal window as a boolean mask
            lib_mask = dict(is_causal=True) if not window else dict(
                attn_mask=visible_mask(S, causal, window))
            kernel_ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw),
                                iters=20)
            eager_ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw),
                               iters=20, graph=False)
            plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw), iters=5)
            library_ms = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True, **lib_mask), iters=20)
            flops = 4 * B * H * hd * visible_pairs(S, causal, window)
            nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, got))
            peak = PEAK_BF16_FLOPS if dt == "bfloat16" else PEAK_F32_FLOPS
            timing = dict(shape=label, ms=kernel_ms, eager_ms=eager_ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          **bound(flops, nbytes, peak))
            timed[key] = timing
            print(f"[kernels] flash_attention at the {label} shape: "
                  f"kernel {kernel_ms:.4f} ms (issued eagerly "
                  f"{eager_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"SDPA {library_ms:.4f} ms, bound {timing['bound_ms']:.4f} "
                  f"ms ({timing['bound_by']}; {flops:.4e} FLOP, "
                  f"{nbytes:.4e} B)")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:30",
                max_abs_err=worst,
                **{k: v for k, v in timed["gqa"].items() if k != "shape"},
                **{k: t for k, t in timed.items() if k != "gqa"},
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


GRAD_NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def phase_wkv6_bwd() -> dict:
    """The WKV6 backward kernel against its plain version on the card, from
    the same states kept by the forward kernel, at WKV_BWD_CASES: each
    gradient within WKV_BWD_TOL of its scale, the saving forward's y and
    sT bitwise those of the forward without saving and its states those of
    the plain saving forward, and a second backward bitwise the first.
    The training shape is timed: the backward, the plain backward, the
    forward with and without kept states, and the card's bound."""
    import torch
    from repro_torch.kernels.rwkv6 import ops

    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    worst, timing = 0.0, None
    for i, (label, B, T, H, hd, dt, nonzero) in enumerate(WKV_BWD_CASES):
        dtype = getattr(torch, dt)
        r, k, v = (randn(B, T, H, hd).mul(0.5).to(dtype) for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, T, H, hd) * 0.5))   # float32
        u = randn(H, hd) * 0.3
        s0 = randn(B, H, hd, hd) * 0.1 if nonzero else torch.zeros(
            (B, H, hd, hd), device="cuda")
        dy = randn(B, T, H * hd).to(dtype)
        dsT = randn(B, H, hd, hd) * 0.1 if nonzero else None
        args = (r, k, v, w, u, s0)
        what = (f"wkv6_bwd {label}: B={B} T={T} H={H} hd={hd} r/k/v {dt}, "
                f"s0 {'nonzero' if nonzero else 'zero'}, dsT "
                f"{'given' if nonzero else 'absent'}")
        y, sT = ops.wkv6_cuda(*args)
        ys, sTs, states = ops.wkv6_cuda_saving(*args)
        if not (torch.equal(ys, y) and torch.equal(sTs, sT)):
            raise AssertionError(f"{what}: the saving forward's y or sT "
                                 f"differ from the forward's")
        _, _, want_states = ops.wkv6_plain_saving(*args)
        check_close(f"{what} (kept states)", states, want_states,
                    TOL["float32"], WKV_ATOL["float32"])
        got = ops.wkv6_bwd_cuda(r, k, v, w, u, states, dy, dsT)
        torch.cuda.synchronize()
        want = ops.wkv6_bwd_plain(r, k, v, w, u, states, dy, dsT)
        for name, g, ref in zip(GRAD_NAMES, got, want):
            if g.dtype != ref.dtype or g.shape != ref.shape:
                raise AssertionError(f"{what}: {name} is {g.dtype} "
                                     f"{tuple(g.shape)}, the plain version's "
                                     f"{ref.dtype} {tuple(ref.shape)}")
            tol = WKV_BWD_TOL[str(g.dtype)[6:]]
            scale = float(ref.float().abs().max())
            worst = max(worst, check_close(f"{what} ({name}, scale "
                                           f"{scale:.3e})", g, ref, tol,
                                           tol * scale))
        again = ops.wkv6_bwd_cuda(r, k, v, w, u, states, dy, dsT)
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            raise AssertionError(f"{what}: two backward runs differ")
        print(f"[kernels] {what}: the saving forward's y and sT equal the "
              f"forward's exactly; a second backward equals the first "
              f"exactly")
        if i != 0:
            continue
        bwd = (r, k, v, w, u, states, dy, dsT)
        bwd_ms = time_ms(lambda: ops.wkv6_bwd_cuda(*bwd), iters=20)
        # the kernel with its walk (the consumers' and the dv warp's sums),
        # its epilogue's sums and stores, or both left out
        parts = {name: time_ms(lambda s=skip: ops.wkv6_bwd_cuda_skipping(
                     *bwd, s), iters=20)
                 for name, skip in (("no_walk_ms", 1), ("no_epilogue_ms", 2),
                                    ("staging_only_ms", 3))}
        eager_ms = time_ms(lambda: ops.wkv6_bwd_cuda(*bwd), iters=20,
                           graph=False)
        plain_ms = time_ms(lambda: ops.wkv6_bwd_plain(*bwd), iters=1,
                           warmup=1)
        fwd_ms = time_ms(lambda: ops.wkv6_cuda(*args), iters=20)
        save_ms = time_ms(lambda: ops.wkv6_cuda_saving(*args), iters=20)
        flops, nbytes = ops.cost_bwd(r, k, v, w, u, states,
                                     dy.reshape(r.shape), dsT, got)
        timing = dict(ms=bwd_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                      library_ms=None, fwd_ms=fwd_ms, fwd_saving_ms=save_ms,
                      **parts, **bound(flops, nbytes, PEAK_F32_FLOPS))
        print(f"[kernels] wkv6_bwd at the training shape: kernel "
              f"{bwd_ms:.4f} ms (issued eagerly {eager_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, library none (no PyTorch call computes "
              f"WKV6's backward); bytes {nbytes:.4e} B = "
              f"{timing['bytes_ms']:.4f} ms at the HBM rate, {flops:.4e} "
              f"float32 FLOP = {timing['ops_ms']:.4f} ms at the float32 "
              f"rate; bound {timing['bound_ms']:.4f} ms "
              f"({timing['bound_by']}), {timing['bound_ms'] / bwd_ms:.3f} of "
              f"it reached; the forward {fwd_ms:.4f} ms, keeping states "
              f"{save_ms:.4f} ms")
        print(f"[kernels] wkv6_bwd parts, timed alone at the training shape: "
              f"without the walk {parts['no_walk_ms']:.4f} ms, without the "
              f"epilogue's sums {parts['no_epilogue_ms']:.4f} ms, staging "
              f"and hand-overs only {parts['staging_only_ms']:.4f} ms")
    return dict(name="wkv6_bwd", route="cuda",
                source="src/repro_torch/kernels/rwkv6/csrc/wkv6_bwd.cu",
                replaces="src/repro/kernels/rwkv6/kernel.py:53",
                replaces_note="no TPU kernel: the backward of wkv6_bh, which "
                              "the reference takes by differentiating its "
                              "lax.scan (src/repro/models/rwkv.py:111)",
                max_abs_err=worst, **timing)


def phase_rmsnorm() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, shapes = 0.0, []
    for i, (label, shape, dt, *scale_dt) in enumerate(RMS_CASES):
        dtype = getattr(torch, dt)
        sdt = scale_dt[0] if scale_dt else "float32"
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        scale = (torch.randn(shape[-1], generator=gen, device="cuda") * 0.1
                 + 1).to(getattr(torch, sdt))
        got = ops.rmsnorm(x, scale)
        torch.cuda.synchronize()
        worst = max(worst, check_close(
            f"rmsnorm {label}: x {shape} {dt}, scale {sdt}", got,
            rmsnorm_ref(x.float(), scale), TOL[dt], TOL[dt]))
        if i >= RMS_TIMED:
            continue
        # Time the serving shapes, each call on inputs out of L2.
        nbytes = (2 * x.numel() * x.element_size()
                  + scale.numel() * scale.element_size())
        copies = [(x.clone(), scale)
                  for _ in range(min(16, int(1e8 // nbytes) + 1))]
        kernel_ms = time_ms(ops.rmsnorm, iters=50, args=copies)
        eager_ms = time_ms(ops.rmsnorm, iters=50, args=copies, graph=False)
        plain_ms = time_ms(rmsnorm_ref, iters=20, args=copies)
        lib_args = [(c, (shape[-1],), scale.to(dtype), 1e-6)
                    for c, _ in copies]
        library_ms = time_ms(F.rms_norm, iters=50, args=lib_args)
        row = dict(shape=list(shape), scale=sdt, ms=kernel_ms,
                   eager_ms=eager_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   **bound(4 * x.numel(), nbytes, PEAK_F32_FLOPS))
        print(f"[kernels] rmsnorm {label}: kernel {kernel_ms:.4f} ms (issued "
              f"eagerly {eager_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, F.rms_norm {library_ms:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {nbytes:.4e} B)")
        shapes.append(row)
        del copies, lib_args
    timing = {k: v for k, v in shapes[0].items()
              if k not in ("shape", "scale")}
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


def flush_wall(eng, prompts) -> float:
    """Submits ``prompts`` to ``eng``, flushes and collects: the wall to
    the last token, host clock ending in a synchronize."""
    import torch
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p)
    eng.flush()
    eng.collect()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def serial_policy_walls(cfg, model, prompts, batch: int, new: int,
                        runs: int) -> list:
    """The same requests under the serial policy (GrCUDA's baseline: one
    lane, each batch waited for before the next is issued) on a new
    engine, ``runs`` times in a row: their walls."""
    from repro_torch.core import make_scheduler
    from repro_torch.runtime import ServingEngine
    serial = ServingEngine(cfg, model, batch_size=batch, max_new_tokens=new,
                           scheduler=make_scheduler("serial"))
    walls = [flush_wall(serial, prompts) for _ in range(runs)]
    serial.close()
    return walls


def profile_serving(eng, prompts, card: str, tag: str) -> None:
    """Two more flushes of the same requests on the warm engine: one timed,
    one under ``torch.profiler`` for the device busy share and the kernels
    that take the device time; between them the serial policy's walls,
    cold and warm."""
    from torch.profiler import ProfilerActivity, profile
    print(f"[profile {tag}] warm run: wall {flush_wall(eng, prompts):.4f} s "
          f"({card})")
    walls = serial_policy_walls(eng.cfg, eng.params_v.device, prompts,
                                eng.batch, eng.max_new, 2)
    for rep, wall in zip(("cold", "warm"), walls):
        print(f"[profile {tag}] serial policy, {rep} run: wall "
              f"{wall:.4f} s ({card})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = flush_wall(eng, prompts)
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


def logits_by_depth(cfg, model, toks, depths, dtype, use_flash=False,
                    aux=None, patches=None) -> dict:
    """The prefill's last-token logits read out (final norm and head)
    after each of ``depths`` blocks, with the residual stream in
    ``dtype``; an MoE model adds its aux losses and kept-token counts to
    ``aux`` where one is given; a vision model takes ``patches``."""
    import torch
    from repro_torch.models import init_cache
    from repro_torch.models import transformer as T
    B, plen = toks.shape
    positions = torch.arange(plen, device=toks.device)[None, :]
    out = {}
    with torch.no_grad():
        x = T._embed(cfg, model, toks, patches).to(dtype)
        for i, (blk, c) in enumerate(
                zip(model.blocks, init_cache(cfg, B, plen, toks.device)), 1):
            x = T.apply_block_seq(cfg, blk, x, positions, cache=c,
                                  use_flash=use_flash, aux=aux)
            if i in depths:
                out[i] = T._logits(cfg, model,
                                   model.final_norm(x[:, -1:, :]))[:, 0]
    return out


def serve_and_check(tag: str, cfg, model, prompts, batch: int, new: int,
                    direct, card: str, profile: bool,
                    policy: str = "parallel") -> dict:
    """Serve ``prompts`` through the scheduler under ``policy`` with every
    kernel's launch count set to 0 just before; returns the counts read
    just after.  Raises unless every request got ``new`` tokens, two lanes
    or more were used (the parallel policy), identical prompts got
    identical tokens and the first batch's tokens equal ``direct``."""
    import numpy as np
    import torch
    from repro_torch.core import make_scheduler
    from repro_torch.runtime import ServingEngine
    sched = make_scheduler("serial") if policy == "serial" else None
    eng = ServingEngine(cfg, model, batch_size=batch, max_new_tokens=new,
                        scheduler=sched)
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
    print(f"[{tag}] {policy} policy, {n_req} requests, {n_req // batch} "
          f"batches: wall "
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
    if policy == "parallel" and stats["lanes_created"] < 2:
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
                               "flash_attention": 0, "rmsnorm": 0,
                               "wkv6_bwd": 0})
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
# The most the benchsuite phase may leave allocated once its schedulers are
# closed and its data dropped (the IMG filter cache holds a few KiB).
BENCH_LEFT = 2**28
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


def run_workload(bench, data, policy: str, sanitize: bool = False,
                 canary: bool = True) -> dict:
    """One run of ``bench`` through a fresh scheduler on CUDA lanes: its
    results, the wall (host clock, ending in a device synchronize), the
    lanes, the overlap metrics, the peak device memory, the count and
    summed host-clock time of its upload and kernel elements, the elements
    the lanes ran and the scheduler's stats after a ``sync``.  With
    ``sanitize`` and not ``canary`` the sanitizer tracks versions only
    (its const canary off), to tell the two costs apart."""
    import torch
    from repro_torch.core import make_scheduler
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s = make_scheduler(policy, device="cuda", sanitize=sanitize)
    if sanitize:
        s.sanitizer.checksums = canary
    try:
        t0 = time.perf_counter()
        out = bench.build(s, data, gpu=None, iters=BENCH_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s.sync()
        spans = {k: [sp.t1 - sp.t0 for sp in s.timeline.spans
                     if sp.kind == k] for k in ("h2d", "compute")}
        stats = s.stats()
        return dict(out=out, wall=wall, lanes=stats["lanes_created"],
                    overlap=s.timeline.overlap_metrics(),
                    peak=torch.cuda.max_memory_allocated(),
                    elements={k: [len(v), sum(v)] for k, v in spans.items()},
                    issued=sum(sp.lane is not None
                               for sp in s.timeline.spans),
                    stats=stats)
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


def profile_workload(name: str, bench, data, card: str,
                     sanitize: bool = False) -> None:
    """One more parallel run under ``torch.profiler``; its trace goes to
    ``build/profile/``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = run_workload(bench, data, "parallel", sanitize=sanitize)
    out_dir = os.path.join(ROOT, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    tag = "sanitized_" if sanitize else ""
    path = os.path.join(out_dir,
                        f"bench_{tag}{name.replace('&', '')}.json")
    prof.export_chrome_trace(path)
    st = trace_stats(path, run["wall"])
    print(f"[profile bench {name}] parallel run{' sanitized' * sanitize} "
          f"under the profiler: wall "
          f"{run['wall']:.4f} s, {json.dumps(st)}, upload elements "
          f"{run['elements']['h2d'][0]} ({card})")
    if st["kernel_streams"] < 2:
        raise AssertionError(f"{name}: every kernel of the parallel run ran "
                             f"on one stream")


def phase_benchsuite(card: str, profile: bool = False) -> dict:
    """Phase 5, and phase 6's sanitized run of each workload on its data;
    returns the sanitizer's wall ratios per workload."""
    import numpy as np
    import torch
    from repro_torch.benchsuite import BENCHMARKS, GPUS

    t_phase = time.perf_counter()
    upload_cost(card)
    speedups, sims, overheads = {}, {}, {}
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
        overheads[name] = sanitized_run(name, bench, data, (par, par2), card,
                                        profile)
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
    return overheads


# The analysis phase.  The sanitized runs hold phase 5's tolerance; the
# plans run at a small scale of their own.
PLAN_SCALE = 0.01
# VEC's inputs (25 M float32) and ML's const input (1.2 M x 200 float32),
# the largest operand the canary digests in phase 5's workloads.
DIGEST_SHAPES = ((25_000_000,), (1_200_000, 200))


def sanitized_run(name: str, bench, data, plain, card: str,
                  profile: bool = False) -> dict:
    """Parallel runs of ``bench`` with ``sanitize=True`` on phase 5's data:
    a warm one, then timed in the order sanitized, versions only (the
    const canary off), versions only, sanitized.  Each run's results equal
    phase 5's parallel runs, with no race and every element the lanes ran
    checked.  Prints the walls; returns each kind's mean wall over the
    mean of phase 5's parallel walls."""
    run_workload(bench, data, "parallel", sanitize=True)          # warm
    runs = {"sanitized": [], "versions only": []}
    for kind in ("sanitized", "versions only", "versions only",
                 "sanitized"):
        runs[kind].append(run_workload(bench, data, "parallel",
                                       sanitize=True,
                                       canary=kind == "sanitized"))
    err = 0.0
    for kind, rs in runs.items():
        for r in rs:
            st = r["stats"]
            err = max(err, hold(f"{name} {kind} vs unsanitized", r["out"],
                                plain[0]["out"], **BENCH_TOL))
            if st["sanitizer_races_detected"]:
                raise AssertionError(f"{name}: the sanitizer saw "
                                     f"{st['sanitizer_races_detected']} "
                                     f"races")
            if st["sanitizer_elements_checked"] != r["issued"]:
                raise AssertionError(
                    f"{name}: the sanitizer checked "
                    f"{st['sanitizer_elements_checked']} elements, the "
                    f"lanes ran {r['issued']}")
    base = [p["wall"] for p in plain]
    walls = {k: [r["wall"] for r in rs] for k, rs in runs.items()}
    ratios = {k: (sum(v) / len(v)) / (sum(base) / len(base))
              for k, v in walls.items()}
    san = runs["sanitized"][0]
    digests = san["stats"]["sanitizer_digests"]
    per_digest_ms = (sum(walls["sanitized"]) - sum(walls["versions only"])
                     ) / len(walls["sanitized"]) / digests * 1e3
    print(f"[analysis {name}] parallel walls: sanitized "
          f"{json.dumps(walls['sanitized'])} s, versions only "
          f"{json.dumps(walls['versions only'])} s, unsanitized "
          f"{json.dumps(base)} s (phase 5); over unsanitized "
          f"{json.dumps(ratios)}; {san['issued']} elements checked and "
          f"{digests} const digests a run, sanitized minus versions only "
          f"{per_digest_ms:.3f} ms a digest; 0 races, max abs err "
          f"{err:.3g}, peak device memory {san['peak'] / 2**30:.3f} GiB "
          f"({card})")
    print(f"[analysis {name}] elements [count, summed host-clock s]: "
          f"sanitized {json.dumps(san['elements'])}, versions only "
          f"{json.dumps(runs['versions only'][0]['elements'])}, "
          f"unsanitized {json.dumps(plain[0]['elements'])}")
    if profile:
        profile_workload(name, bench, data, card, sanitize=True)
    return ratios


def lint_then_run(card: str) -> None:
    """The mode checker over the shipped declarations, then IMG's blur and
    Sobel on the card: a filter cache the trace left a fake or meta tensor
    in, under a real device, would fail them."""
    import importlib

    import torch
    import torch.nn.functional as F
    from repro_torch.analysis.cli import _LINT_MODULES
    from repro_torch.analysis.modes import lint_functions
    from repro_torch.benchsuite import kernels as K
    for mod in _LINT_MODULES:
        importlib.import_module(mod)
    K._FILTERS.clear()
    t0 = time.perf_counter()
    reports = lint_functions()
    lint_s = time.perf_counter() - t0
    issues = [str(i) for r in reports for i in r.issues]
    skipped = sum(r.skipped is not None for r in reports)
    print(f"[analysis] lint: {len(reports)} declarations, "
          f"{len(reports) - skipped} analysed, {skipped} skipped, "
          f"{len(issues)} issues, {lint_s:.2f} s")
    if issues or len(reports) - skipped < 20:
        raise AssertionError(f"lint: {issues or 'too few analysed'}")
    from torch._subclasses.fake_tensor import FakeTensor
    poisoned = sorted(str(k) for k, w in K._FILTERS.items()
                      if k[1].type == "cuda" or w.device != k[1]
                      or isinstance(w, FakeTensor))
    if poisoned:
        raise AssertionError(f"the lint left filters under {poisoned}")
    gen = torch.Generator("cuda").manual_seed(0)
    img = torch.rand(2048, 2048, device="cuda", generator=gen)

    def conv(k):
        k = torch.from_numpy(k).to("cuda")
        return F.conv2d(img[None, None], k[None, None], padding="same")[0, 0]
    blur = K.BLUR_L.fn(img, None)
    ex, ey = conv(K._sobel_x()), conv(K._sobel_x().T.copy())
    g = torch.sqrt(ex * ex + ey * ey)
    for what, got, want in (
            ("BLUR_L", blur, conv(K._gauss_kernel(13, 5.0))),
            ("SOBEL", K.SOBEL.fn(img, None), g / (torch.max(g) + 1e-6))):
        if not torch.equal(got, want):
            raise AssertionError(f"{what} after the lint differs from the "
                                 f"same convolution made afresh")
    print("[analysis] BLUR_L and SOBEL after the lint: equal to the same "
          "convolutions made afresh, on the card")


def digest_cost(card: str) -> None:
    """One digest of a const operand of VEC's and of ML's size on the
    card: CUDA-event time, host time until the result is on the host, and
    the temporary device memory it takes; the host's digest of the same
    bytes must be equal."""
    import torch
    from repro_torch.analysis.sanitizer import _Digester, digest, resolve
    d = _Digester()
    for shape in DIGEST_SHAPES:
        t = torch.rand(shape, device="cuda")
        resolve(d.pending(t, "warm"))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        dev_ms, host_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            start.record()
            pending = d.pending(t, "timed")
            end.record()
            resolve(pending)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
        extra = (torch.cuda.max_memory_allocated() - base) / 2**20
        if resolve(d.pending(t, "card")) != digest(t.cpu().numpy()):
            raise AssertionError("the card's and the host's digests of "
                                 "equal bytes differ")
        nbytes = t.numel() * 4
        print(f"[analysis] digest of a {nbytes / 2**20:.0f} MiB float32 "
              f"operand: device {json.dumps(dev_ms)} ms "
              f"({nbytes / min(dev_ms) / 1e6:.0f} GB/s of operand), host "
              f"until resolved {json.dumps(host_ms)} ms, temporary device "
              f"memory {extra:.1f} MiB ({card})")
        del t


def seeded_faults(card: str) -> None:
    """A kernel that writes its ``const`` CUDA operand in place, and two
    writers of one array submitted on two lanes with no edge between
    them: the sanitizer must raise for each."""
    import threading

    import numpy as np
    import torch
    from repro_torch.analysis import SanitizerError
    from repro_torch.core import function, make_scheduler, out
    from repro_torch.core.element import ComputationalElement

    def expect(what: str, needle: str, fn) -> None:
        try:
            fn()
        except SanitizerError as exc:
            if needle not in str(exc):
                raise
            print(f"[analysis] seeded {what}: SanitizerError "
                  f"{str(exc)[:110]!r}...")
            return
        raise AssertionError(f"seeded {what}: no SanitizerError")

    n = (1 << 24) + 5                 # two digest chunks
    s = make_scheduler("parallel", device="cuda", sanitize=True)
    try:
        x = s.array(np.ones(n, np.float32), name="cx")
        y = s.array(shape=(n,), dtype=np.float32, name="cy")

        def mutates(a, _o):
            a.add_(1.0)
            return a * 2.0
        function(mutates, modes=("const", "out"), name="bad_mutates",
                 scheduler=s)(x, y)
        expect("write through const", "write through const on array 'cx'",
               s.sync)
    finally:
        s.close()

    s = make_scheduler("parallel", device="cuda", sanitize=True)
    try:
        a = s.array(np.ones(1 << 20, np.float32), name="ra")
        started = threading.Event()

        def slow(_o):
            started.set()
            torch.cuda._sleep(200_000_000)
            return torch.zeros(1 << 20, device="cuda")
        e1 = ComputationalElement(fn=slow, args=(out(a),), name="W1")
        e2 = ComputationalElement(
            fn=lambda _o: torch.ones(1 << 20, device="cuda"),
            args=(out(a),), name="W2")
        s.executor.submit(e1, 0, ())
        if not started.wait(60.0):
            raise AssertionError("the first writer never started")
        s.executor.submit(e2, 1, ())
        expect("two writers on two lanes", "WAW",
               lambda: s.executor.wait(e2))
        s.executor.wait(e1)
    finally:
        s.close()


def plans_on_card(card: str) -> None:
    """VEC and B&S captured and replayed under ``sanitize=True`` (each plan
    verified at capture time), ``verify()`` after; an out-of-core capture
    under a memory budget, which the plan optimizer rewrites and verifies
    under ``sanitize=True``."""
    from repro_torch.benchsuite import (BENCHMARKS, build_outofcore,
                                        verify_outofcore, working_set_bytes)
    from repro_torch.core import make_scheduler
    for name in ("VEC", "B&S"):
        bench = BENCHMARKS[name]
        data = bench.make_data(PLAN_SCALE, seed=0)
        ref = bench.run_reference(data, iters=1, device="cuda")
        s = make_scheduler("parallel", device="cuda", sanitize=True)
        try:
            for ep in range(2):
                with s.capture(name):
                    res = bench.build(s, data, gpu=None, iters=1)
                s.sync()
                hold(f"{name} plan episode {ep}", res, ref, **BENCH_TOL)
            s.verify()
            st = s.stats()
        finally:
            s.close()
        if (st["plan_records"], st["plan_replays"]) != (1, 1) \
                or st["sanitizer_races_detected"]:
            raise AssertionError(f"{name}: {st['plan_records']} records, "
                                 f"{st['plan_replays']} replays, "
                                 f"{st['sanitizer_races_detected']} races")
        print(f"[analysis] {name} (scale {PLAN_SCALE}): recorded, replayed, "
              f"verify() green, {st['sanitizer_elements_checked']} elements "
              f"sanitized, 0 races")
    chunks, n = 6, 1 << 20
    s = make_scheduler("parallel", device="cuda", sanitize=True,
                       plan_optimize=True,
                       memory_budget=working_set_bytes(chunks, n) // 2)
    try:
        for _ in range(3):
            with s.capture("ooc"):
                arrs = build_outofcore(s, chunks=chunks, n=n)
            s.sync()
        plan = s.plan_cache.candidates("ooc")[0]
        ok = verify_outofcore(arrs)
        s.verify()
        st = s.stats()
    finally:
        s.close()
    if not (plan.optimized and plan.mem_scheduled and ok) \
            or st["plan_replays"] != 2 or st["sanitizer_races_detected"]:
        raise AssertionError(
            f"out-of-core plan: optimized {plan.optimized}, mem_scheduled "
            f"{plan.mem_scheduled}, results {ok}, {st['plan_replays']} "
            f"replays, {st['sanitizer_races_detected']} races")
    print(f"[analysis] out-of-core capture under a budget: rewritten by the "
          f"plan optimizer and verified, 2 replays, "
          f"{st['mem_evicts_scheduled']} evictions scheduled, results right")


def bf16_round_trip(card: str) -> None:
    """A bf16 host array (``ml_dtypes.bfloat16``) up to the card and back
    through a kernel that rewrites it, and a kernel's bf16 ``out`` argument
    read on the host: every bit kept."""
    import ml_dtypes
    import numpy as np
    import torch
    from repro_torch.core import function, make_scheduler
    n = (1 << 20) + 3
    bits = np.random.RandomState(0).randint(0, 1 << 15, size=n).astype(
        np.uint16)                                    # finite, positive
    s = make_scheduler("parallel", device="cuda")
    try:
        x = s.array(bits.view(ml_dtypes.bfloat16), name="bx")
        y = s.array(shape=(n,), dtype=ml_dtypes.bfloat16, name="by")
        seen = {}

        def dbl(a, _o):
            seen["in"], seen["out"] = a, (a * 2).to(torch.bfloat16)
            return seen["out"]
        function(dbl, modes=("const", "out"), name="dbl", scheduler=s)(x, y)
        function(lambda a: a.clone(), modes=("inout",), name="touch",
                 scheduler=s)(x)
        host_dtype = str(np.asarray(y).dtype)
        got_y = np.asarray(y).view(np.uint16)
        got_x = np.asarray(x).view(np.uint16)      # read back off the card

        def host_bits(t):
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        checks = {"upload": np.array_equal(host_bits(seen["in"]), bits),
                  "out read": np.array_equal(got_y, host_bits(seen["out"])),
                  "round trip": np.array_equal(got_x, bits)}
    finally:
        s.close()
    print(f"[analysis] bf16 managed arrays, {n} elements: "
          f"{json.dumps(checks)} (host mirror dtype {host_dtype})")
    if not all(checks.values()):
        raise AssertionError(f"bf16 round trip lost bits: {checks}")


def phase_analysis(card: str, overheads: dict) -> None:
    t_phase = time.perf_counter()
    lint_then_run(card)
    print(f"[analysis] sanitizer overhead, mean wall over the mean "
          f"unsanitized parallel wall: {json.dumps(overheads)} ({card})")
    digest_cost(card)
    seeded_faults(card)
    plans_on_card(card)
    bf16_round_trip(card)
    print(f"[analysis] phase {time.perf_counter() - t_phase:.2f} s")


def phase_moe(card: str, profile: bool = False) -> dict:
    """qwen2-moe served at full width and depth: 60 experts top-4 and 4
    shared experts in each of 24 layers, MHA (H = Hkv = 16) attention
    through the flash kernel and every norm through RMSNorm."""
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import init_lm, layers

    cfg = get_config("qwen2_moe_a2_7b")            # as published
    if cfg.qk_norm or cfg.n_kv_heads != cfg.n_heads:
        raise AssertionError("qwen2-moe is MHA without qk-norm")
    batch, new, plen, n_req = 2, 16, 1024, 8
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[moe] {cfg.name} at full width, {cfg.n_layers} layers, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} + "
          f"{cfg.moe.n_shared_experts} shared: {n_params:,} f32 parameters "
          f"({n_params * 4 / 1e9:.2f} GB), init "
          f"{time.perf_counter() - t0:.2f} s")
    prompts = make_prompts(cfg, n_req, plen)
    toks = torch.from_numpy(np.stack(prompts[:batch])).cuda()
    t0 = time.perf_counter()
    direct, _ = direct_call(cfg, model, toks, new, use_flash=True)
    print(f"[moe] direct prefill and {new - 1} decode steps "
          f"{time.perf_counter() - t0:.2f} s")
    # The served model's prefill with the flash and RMSNorm kernels against
    # plain attention and the plain RMSNorm, read out after 2 to 24 layers.
    # Each layer routes each token to its top-4 experts and drops what
    # overflows a capacity, so a rounding difference that flips one choice
    # moves the queue of every later token of that expert: the difference
    # grows with depth.  The bf16 tolerance is held on the served logits
    # (all 24 layers); the shallower read-outs are printed.
    t0 = time.perf_counter()
    depths = (2, 4, 8, 16, cfg.n_layers)
    kaux, paux = {}, {}
    got = logits_by_depth(cfg, model, toks, depths, torch.bfloat16,
                          use_flash=True, aux=kaux)
    with mock.patch.object(layers, "rmsnorm", rmsnorm_ref):
        want = logits_by_depth(cfg, model, toks, depths, torch.bfloat16,
                               use_flash=False, aux=paux)
    for n in depths:
        check_logits("moe", f"flash and RMSNorm kernels vs their plain "
                     f"versions, {n} layers", got[n], want[n],
                     TOL["bfloat16"] if n == cfg.n_layers else None)
    # Each layer's kept routed tokens per batch row, read back once.
    kept = torch.stack(kaux["moe_kept"]).cpu().numpy()      # (layers, B)
    kept_plain = torch.stack(paux["moe_kept"]).cpu().numpy()
    routed = plen * cfg.moe.top_k
    differ = [i for i in range(cfg.n_layers)
              if not np.array_equal(kept[i], kept_plain[i])]
    print(f"[moe] prefill kept routed tokens per layer and row (of "
          f"{routed}; capacity factor {cfg.moe.capacity_factor}): min "
          f"{kept.min()}, mean {kept.mean():.1f}, max {kept.max()}; "
          f"dropped {1 - kept.sum() / (routed * kept.size):.4f} of them; "
          f"layers whose kept counts differ from the plain run's: "
          f"{differ}; aux losses moe_aux {float(kaux['moe_aux']):.6f}, "
          f"moe_z {float(kaux['moe_z']):.6f} "
          f"({time.perf_counter() - t0:.2f} s)")
    if kept.shape != (cfg.n_layers, batch) or not (
            (kept > 0) & (kept <= routed)).all():
        raise AssertionError(f"kept-token counts out of (0, {routed}]: "
                             f"{kept.tolist()}")
    del got, want, kaux, paux
    torch.cuda.synchronize()
    peak_direct = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    launches = serve_and_check("moe", cfg, model, prompts, batch, new,
                               direct, card, profile)
    n_batches = n_req // batch
    # Per forward call (the prefill and each of new - 1 decode steps):
    # ln1 and ln2 in every layer, and the final norm; no qk-norm.
    expect_launches(launches, {
        "flash_attention": cfg.n_layers * n_batches,
        "rmsnorm": (2 * cfg.n_layers + 1) * new * n_batches,
        "wkv6": 0})
    print(f"[moe] peak device memory of the direct calls "
          f"{peak_direct / 2**30:.3f} GiB, of the served run "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; serving "
          f"and checks {time.perf_counter() - t0:.2f} s ({card})")
    print(f"[moe] phase {time.perf_counter() - t_phase:.2f} s")
    return launches


# The daemon phase: chain jobs at the size of a real vector job, and the
# daemon benchmark's three scenarios at its full (non-smoke) sizes.
DAEMON_CHAIN = {"n": 4, "size": 1 << 24, "digest": True}
DAEMON_LM = {"requests": 4, "prompt_len": 16, "new_tokens": 4,
             "batch_size": 2}
IPC_JOBS, IPC_PARAMS = 20, {"n": 8, "size": 65536, "digest": True}
IPC_WARM_S = 1.0          # two cooldown windows of back-to-back jobs
IPC_MAX_RATIO = 2.0
SPIKE_WAVES, SPIKE_WAVE_SIZE, SPIKE_SERVICE_S = 4, 12, 0.02
CALM_JOBS = 16


def daemon_cli(sock: str, *args, timeout: float = 300):
    """``python -m repro_torch.daemon --socket sock ...`` in a process of
    its own; raises unless it exits 0, returns its standard output."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.daemon", "--socket", sock,
         *args], capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": SRC})
    if proc.returncode != 0:
        raise AssertionError(f"daemon CLI {args} exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return proc.stdout


def direct_serve_lm(seed: int) -> list:
    """What the daemon's ``serve_lm`` job computes, called in-process: the
    reduced default model from ``seed`` on the card, its own engine."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.runtime import ServingEngine
    cfg = get_config("qwen2_moe_a2_7b", reduced=True)
    model = init_lm(cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
    rng = np.random.RandomState(seed)
    with ServingEngine(cfg, model, batch_size=DAEMON_LM["batch_size"],
                       max_new_tokens=DAEMON_LM["new_tokens"],
                       device="cuda", use_flash=False) as eng:
        reqs = [eng.submit(rng.randint(0, cfg.vocab, DAEMON_LM["prompt_len"]))
                for _ in range(DAEMON_LM["requests"])]
        eng.drain()
    return [[int(t) for t in r.result] for r in reqs]


def wait_state(client, job_id: str, state: str, timeout: float = 60.0):
    deadline = time.monotonic() + timeout
    while client.status(job_id)["state"] != state:
        if time.monotonic() > deadline:
            raise AssertionError(f"job {job_id} never reached {state}")
        time.sleep(0.01)


def daemon_on_card(card: str, tmp: str) -> None:
    """A daemon serving on the card in a process of its own, driven from
    here through ``DaemonClient`` and from the CLI: chain and ``serve_lm``
    jobs equal to in-process runs, a sleep job paused, resumed and
    cancelled, stats, drain and shutdown, then the journal's audit."""
    from repro_torch.core import make_scheduler
    from repro_torch.daemon import DaemonClient
    from repro_torch.daemon.jobs import run_job
    from repro_torch.daemon.lifecycle import validate_history
    t_start = time.perf_counter()
    sock, store = os.path.join(tmp, "d.sock"), os.path.join(tmp, "j.jsonl")
    chains = [dict(DAEMON_CHAIN, seed=seed) for seed in range(3)]
    with make_scheduler("parallel", device="cuda") as s:
        t0 = time.perf_counter()
        want = [run_job(s, "chain", spec) for spec in chains]
        t_in = time.perf_counter() - t0
    want_lm = {seed: direct_serve_lm(seed) for seed in (0, 1)}
    print(f"[daemon] in-process runs {time.perf_counter() - t_start:.2f} s "
          f"(the chains {t_in:.2f} s)")
    log_path = os.path.join(tmp, "serve.log")

    def log_tail() -> str:
        with open(log_path) as fh:
            return fh.read()[-2000:]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        serve = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.daemon", "--socket", sock,
             "serve", "--device", "cuda", "--store", store],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": SRC},
            stdout=log, stderr=subprocess.STDOUT)
    try:
        while not os.path.exists(sock):
            if serve.poll() is not None:
                raise AssertionError(f"the daemon died at startup: "
                                     f"{log_tail()}")
            if time.perf_counter() - t0 > 120:
                raise AssertionError("the daemon never bound its socket")
            time.sleep(0.05)
        print(f"[daemon] serve --device cuda bound its socket in "
              f"{time.perf_counter() - t0:.2f} s")
        with DaemonClient(sock, connect_timeout=30) as c:
            t0 = time.perf_counter()
            ids = [c.submit("chain", spec)["job_id"] for spec in chains]
            got = [c.result(j, timeout=300) for j in ids]
            t_d = time.perf_counter() - t0
            lm_ids = {seed: c.submit("serve_lm", dict(DAEMON_LM, seed=seed),
                                     tenant="lm")["job_id"]
                      for seed in want_lm}
            got_lm = {seed: c.result(j, timeout=300)
                      for seed, j in lm_ids.items()}
            if got != want:
                raise AssertionError(f"daemon chain results {got} differ "
                                     f"from in-process {want}")
            for seed, res in got_lm.items():
                if res["generations"] != want_lm[seed]:
                    raise AssertionError(
                        f"serve_lm seed {seed}: daemon tokens "
                        f"{res['generations']} differ from a direct "
                        f"ServingEngine call {want_lm[seed]}")
            print(f"[daemon] {len(chains)} chain jobs (n={DAEMON_CHAIN['n']}"
                  f", size {DAEMON_CHAIN['size']}) equal run_job on an "
                  f"in-process CUDA scheduler bit for bit (sha256, sum, "
                  f"absmax): daemon {t_d:.4f} s, in-process {t_in:.4f} s "
                  f"({card})")
            print(f"[daemon] serve_lm (reduced qwen2-moe, default arch) "
                  f"seeds 0 and 1: tokens equal a direct ServingEngine "
                  f"call: {json.dumps(got_lm[0]['generations'])}")
            # The CLI from a process of its own.
            t0 = time.perf_counter()
            cli = json.loads(daemon_cli(
                sock, "submit", "chain",
                *[f"-p{k}={json.dumps(v)}" for k, v in chains[0].items()],
                "--wait"))
            if cli["state"] != "finished" or cli["result"] != want[0]:
                raise AssertionError(f"CLI chain job: {cli}")
            print(f"[daemon] CLI submit chain --wait: finished, equal to "
                  f"the in-process run ({time.perf_counter() - t0:.2f} s)")
            # Pause, resume and cancel a sleep job.
            jid = c.submit("sleep", {"total_s": 30.0,
                                     "steps": 600})["job_id"]
            wait_state(c, jid, "running")
            c.pause(jid)
            wait_state(c, jid, "paused")
            c.resume(jid)
            wait_state(c, jid, "running")
            c.cancel(jid)
            job = c.wait(jid, timeout=60)
            edges = [tuple(t[:2]) for t in job["transitions"]]
            if (job["state"] != "cancelled"
                    or ("running", "paused") not in edges
                    or ("paused", "running") not in edges
                    or validate_history([tuple(t) for t in
                                         job["transitions"]])):
                raise AssertionError(f"sleep job: {job}")
            print(f"[daemon] sleep job paused, resumed and cancelled: "
                  f"{edges}")
            st = c.stats()
            failed = [j for j in c.jobs() if j["state"] == "failed"]
            if failed:
                raise AssertionError(f"jobs ended FAILED: {failed}")
            print(f"[daemon] stats: server {json.dumps(st['server'])}, "
                  f"store by state {json.dumps(st['store']['by_state'])}, "
                  f"lanes {st['scheduler'].get('lanes_created')}, monitor "
                  f"utilization EWMA "
                  f"{st['monitor']['monitor_utilization_ewma']:.4f}")
            d = c.drain(timeout=60)
            if not d["drained"]:
                raise AssertionError(f"drain: {d}")
            c.shutdown()
        if serve.wait(timeout=120) != 0:
            raise AssertionError(f"the daemon exited {serve.returncode}: "
                                 f"{log_tail()}")
    finally:
        if serve.poll() is None:
            serve.kill()
            serve.wait()
    audit = json.loads(daemon_cli(sock, "jobs", "--audit", "--store", store))
    print(f"[daemon] jobs --audit: ok {audit['ok']}, {audit['records']} "
          f"records, {audit['jobs']} jobs, problems {audit['problems']}")
    if not audit["ok"]:
        raise AssertionError(f"journal audit: {audit}")


def _percentile(xs, q):
    ys = sorted(xs)
    if not ys:
        return 0.0
    k = (len(ys) - 1) * q
    lo = int(k)
    hi = min(lo + 1, len(ys) - 1)
    return ys[lo] + (ys[hi] - ys[lo]) * (k - lo)


def bench_ipc(card: str, tmp: str) -> dict:
    """``benchmarks/bench_daemon.py``'s ipc scenario in the port, on the
    card: identical warmed chain jobs run in-process and through an
    in-process daemon's socket.

    Two things of this process, not of the service boundary, would
    otherwise decide the ratio.  A job's own host time drifts by two to
    four times between stretches of twenty jobs (lane threads and the GIL,
    ROADMAP C2), so the paths run in turns, one job of each per seed, the
    in-process one first on even seeds.  Back-to-back jobs after an idle
    start read to the monitor as an arrival-rate spike, and the admission
    policy then defers dispatch for its cooldown window (0.5 s), so both
    paths are warmed in the same turns for ``IPC_WARM_S`` and until no
    cooldown is open; the defer events and spikes of the timed jobs are
    returned."""
    from repro_torch.core import make_scheduler
    from repro_torch.daemon import DaemonClient, DaemonServer
    from repro_torch.daemon.jobs import run_job
    sched = make_scheduler("parallel", device="cuda")
    srv = DaemonServer(os.path.join(tmp, "ipc.sock"),
                       store_path=os.path.join(tmp, "ipc.jsonl"),
                       sched_kw={"device": "cuda"}, workers=1,
                       monitor_interval_s=0.05).start()
    try:
        with DaemonClient(srv.socket_path) as c:
            def local(seed):
                run_job(sched, "chain", dict(IPC_PARAMS, seed=seed))

            def remote(seed):
                c.result(c.submit("chain", dict(IPC_PARAMS,
                                                seed=seed))["job_id"],
                         timeout=300)
            t0 = time.perf_counter()
            warm = 0
            while (time.perf_counter() - t0 < IPC_WARM_S
                   or srv.monitor.snapshot().spiking):
                local(999)
                remote(999)
                warm += 1
            before = (srv.policy.stats()["policy_defer_events"],
                      srv.monitor.stats()["monitor_spikes"])
            spent = {local: 0.0, remote: 0.0}
            for i in range(IPC_JOBS):
                for path in ((local, remote) if i % 2 == 0
                             else (remote, local)):
                    t0 = time.perf_counter()
                    path(i)
                    spent[path] += time.perf_counter() - t0
            defers = srv.policy.stats()["policy_defer_events"] - before[0]
            spikes = srv.monitor.stats()["monitor_spikes"] - before[1]
    finally:
        srv.stop()
        sched.close()
    in_proc_s, daemon_s = spent[local] / IPC_JOBS, spent[remote] / IPC_JOBS
    return {"jobs": IPC_JOBS, "in_process_us": in_proc_s * 1e6,
            "daemon_us": daemon_s * 1e6, "ratio": daemon_s / in_proc_s,
            "warm_pairs": warm, "defer_events": defers, "spikes": spikes}


def _spike_daemon(path: str):
    from repro_torch.daemon import (AdmissionPolicy, DaemonServer,
                                    RuntimeMonitor)
    return DaemonServer(
        path + ".sock", store_path=path + ".jsonl",
        sched_kw={"simulate": True}, workers=1,
        policy=AdmissionPolicy(max_queue_depth=24, spike_shed_depth=4,
                               shed_below_priority=1, max_running=1,
                               defer_backoff_s=0.01),
        monitor=RuntimeMonitor(interval_s=0.02, spike_factor=3.0,
                               spike_floor=2.0, rate_floor=50.0,
                               cooldown_s=1.0),
        monitor_interval_s=0.02).start()


def bench_admission(tmp: str) -> dict:
    """``benchmarks/bench_daemon.py``'s spike and calm scenarios in the
    port: a calm trickle then burst waves faster than the single worker
    drains, and the trickle alone."""
    from repro_torch.daemon import DaemonClient
    from repro_torch.daemon.lifecycle import JobState, validate_history
    job = {"total_s": SPIKE_SERVICE_S, "steps": 2}
    srv = _spike_daemon(os.path.join(tmp, "spike"))
    try:
        with DaemonClient(srv.socket_path) as c:
            calm, stormy = [], []
            for _ in range(4):
                calm.append(c.submit("sleep", job))
                time.sleep(SPIKE_SERVICE_S * 1.5)
            for _ in range(SPIKE_WAVES):
                for _ in range(SPIKE_WAVE_SIZE):
                    stormy.append(c.submit("sleep", job))
                time.sleep(0.08)
            srv.wait_idle(timeout=120)
            pol, mon = srv.policy.stats(), srv.monitor.stats()
            jobs = srv.store.jobs()
    finally:
        srv.stop()
    admitted = {r["job_id"] for r in stormy if r.get("ok")}
    sheds = [r for r in stormy if r.get("shed")]
    lat = [j.transitions[-1][2] - j.submit_t for j in jobs
           if j.job_id in admitted and j.state is JobState.FINISHED]
    spike = {
        "submitted": len(calm) + len(stormy),
        "calm_admitted": sum(bool(r.get("ok")) for r in calm),
        "storm_admitted": len(admitted), "shed": len(sheds),
        "shed_rate": len(sheds) / max(1, len(stormy)),
        "defer_events": pol["policy_defer_events"],
        "monitor_spikes": mon["monitor_spikes"],
        "p99_latency_s": _percentile(lat, 0.99),
        "p50_latency_s": _percentile(lat, 0.50),
        "bad_histories": [p for j in jobs
                          for p in validate_history(j.transitions)],
        "shed_reasons_ok": all(r.get("reason", "").startswith("shed:")
                               for r in sheds)}
    srv2 = _spike_daemon(os.path.join(tmp, "calm"))
    try:
        with DaemonClient(srv2.socket_path) as c:
            outcomes = []
            for _ in range(CALM_JOBS):
                outcomes.append(c.submit("sleep", job))
                time.sleep(SPIKE_SERVICE_S * 1.5)
            srv2.wait_idle(timeout=120)
            shed2 = srv2.policy.stats()["policy_shed"]
            finished = len(srv2.store.by_state(JobState.FINISHED))
    finally:
        srv2.stop()
    calm_res = {"submitted": len(outcomes),
                "admitted": sum(bool(r.get("ok")) for r in outcomes),
                "shed": shed2, "finished": finished}
    return {"spike": spike, "calm": calm_res}


def phase_daemon(card: str) -> None:
    import tempfile
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke-daemon-")
    daemon_on_card(card, tmp)
    ipc = bench_ipc(card, tmp)
    adm = bench_admission(tmp)
    spike, calm = adm["spike"], adm["calm"]
    print(f"[daemon] bench ipc: daemon {ipc['daemon_us']:.1f} us a job, "
          f"in-process {ipc['in_process_us']:.1f} us, ratio "
          f"{ipc['ratio']:.4f} (gate <= {IPC_MAX_RATIO}); after "
          f"{ipc['warm_pairs']} warm-up pairs, {ipc['defer_events']} defer "
          f"events and {ipc['spikes']} spikes in the timed jobs ({card})")
    print(f"[daemon] bench spike: shed {spike['shed']}/{spike['submitted']}"
          f" (rate {spike['shed_rate']:.4f}, gate > 0 and < 1), defer "
          f"events {spike['defer_events']} (gate > 0), spikes "
          f"{spike['monitor_spikes']} (gate >= 1), calm admitted "
          f"{spike['calm_admitted']}/4, p50 {spike['p50_latency_s']:.4f} s, "
          f"p99 {spike['p99_latency_s']:.4f} s, illegal histories "
          f"{len(spike['bad_histories'])}")
    print(f"[daemon] bench calm: admitted {calm['admitted']}/"
          f"{calm['submitted']}, shed {calm['shed']} (gate 0), finished "
          f"{calm['finished']}")
    gates = {
        "ipc ratio": ipc["ratio"] <= IPC_MAX_RATIO,
        "spike detected": spike["monitor_spikes"] >= 1,
        "sheds": spike["shed"] > 0,
        "defers": spike["defer_events"] > 0,
        "shed reasons": spike["shed_reasons_ok"],
        "partial shed rate": 0.0 < spike["shed_rate"] < 1.0,
        "storm job finished": spike["p99_latency_s"] > 0.0,
        "legal histories": not spike["bad_histories"],
        "trickle admitted": spike["calm_admitted"] == 4,
        "calm sheds nothing": (calm["shed"] == 0
                               and calm["admitted"] == calm["submitted"]
                               == calm["finished"]),
    }
    missed = [k for k, ok in gates.items() if not ok]
    if missed:
        raise AssertionError(f"bench_daemon gates missed: {missed}")
    print(f"[daemon] phase {time.perf_counter() - t_phase:.2f} s")


# The training phase.  8a: the autograd functions on the card at the
# training shapes of 8b (RMSNorm rows of (micro-batch tokens, d) for ln1,
# ln2 and the final norm, (tokens x heads, hd) for the q- and k-norms) and
# the chunked attention in float32 at S 2048.  8b: TaskGraphTrainer on the
# full-width qwen3_32b cut to 2 layers.  8c: the train CLI interrupted and
# resumed.
TRAIN_RMS_CASES = [("ln1, ln2, final_norm", (512, 5120)),
                   ("q_norm", (512 * 64, 128)), ("k_norm", (512 * 8, 128))]
# (label, window, softcap); causal, B 1, S 2048, H 8, Hkv 2, hd 128.
CHUNK_CASES = [("causal", 0, 0.0), ("causal window 1024", 1024, 0.0),
               ("causal softcap 30", 0, 30.0)]
# The chunked backward sums in another order than autograd through the
# materialized scores: 2e-5 of each output's scale in float32.
CHUNK_TOL = 2e-5
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 128, 8, 2, 8
# The argument that runs phase 8 alone, in the process the script starts
# for it.
TRAIN_ONLY = "--phase-8-process"
# A full-width save is 30.4 GB, and the run keeps what it writes to disk
# under 45 GiB (PERF.md §6): one save, at step 5; the restart run fails at
# 5, restores 5 and runs to 8.
FAIL_AT, CKPT_EVERY = 5, 5
# RMSNorm launches a step: ln1, ln2, q_norm and k_norm in each of 2 layers
# and the final norm in the forward (9), the blocks' 8 again in remat's
# recompute, for each of 2 micro-batches.
RMS_PER_STEP = (9 + 8) * TRAIN_ACCUM
# 8d: rwkv6_1_6b at full width and depth, seq 1024, global batch 8, accum
# 2 (micro-batches of 4: the backward kernel's training shape), 6 steps;
# 3 under the serial policy; the gradients of one step at 2 layers.
RWKV_SEQ, RWKV_BATCH, RWKV_ACCUM, RWKV_STEPS = 1024, 8, 2, 6
RWKV_SERIAL_STEPS, RWKV_GRAD_LAYERS = 3, 2
# Per-leaf and whole-model relative Frobenius norms of the kernel's
# gradients against the plain recurrence's, as
# tests/test_torch_train.py::test_loss_gradients_match_reference holds the
# port against the reference, with float32 activations: there the two
# paths differ only in the order of float32 sums (1.7e-4 over all leaves
# on an H100).  With the trainer's bf16 activations this step's gradients
# are rounding noise to 21% of their norm (the plain path's bf16 against
# its float32 gradients, PERF.md §6), and any two paths that round apart
# differ by about 3%: there the kernel path's distance from the float32
# gradients is held to at most GRAD_BF16_RATIO of the plain path's.
GRAD_LEAF_TOL, GRAD_ALL_TOL, GRAD_BF16_RATIO = 3e-2, 1.5e-2, 1.05


def train_autograd_on_card(card: str) -> None:
    """8a: RMSNorm's autograd function (kernel forward, closed-form
    backward) and the chunked attention's custom backward against
    autograd through their plain versions."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import attention as TA

    gen = torch.Generator(device="cuda").manual_seed(8)
    for label, shape in TRAIN_RMS_CASES:
        x0 = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        s0 = torch.randn(shape[-1], generator=gen, device="cuda") * 0.1 + 1
        gy = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        x, s = x0.clone().requires_grad_(True), s0.clone().requires_grad_(True)
        before = ops.launches
        y = ops.rmsnorm(x, s)
        if ops.launches != before + 1:
            raise AssertionError("RMSNorm under grad did not launch the "
                                 "kernel")
        y.backward(gy)
        xr, sr = x0.clone().requires_grad_(True), s0.clone().requires_grad_(
            True)
        yr = rmsnorm_ref(xr, sr)
        yr.backward(gy)
        what = f"train rmsnorm {label} {shape} bf16"
        check_close(f"{what} forward", y.detach(), yr.detach(),
                    TOL["bfloat16"], TOL["bfloat16"])
        # dx is rounded to bf16 like the forward; dscale sums rows in f32
        # in another order: 1e-4 of its scale.
        check_close(f"{what} dx", x.grad, xr.grad, TOL["bfloat16"],
                    TOL["bfloat16"])
        ds_scale = float(sr.grad.abs().max())
        check_close(f"{what} dscale", s.grad, sr.grad, 1e-4,
                    1e-4 * ds_scale)
    B, S, H, Hkv, hd = 1, 2048, 8, 2, 128
    for label, window, softcap in CHUNK_CASES:
        cfg = dc.replace(get_config("qwen3_32b"), logit_softcap=softcap)
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda")
        k = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda")
        v = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda")
        dout = torch.randn(B, S, H * hd, generator=gen, device="cuda")
        res = []
        for chunked in (True, False):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            if chunked:
                o = TA._sdpa_chunked(cfg, *leaves, causal=True,
                                     window=window)
            else:
                o = TA._sdpa(cfg, *leaves, TA.causal_mask(
                    S, S, window, device=q.device))
            o.backward(dout)
            res.append([o.detach()] + [t.grad for t in leaves])
        for name, got, want in zip(("out", "dq", "dk", "dv"), *res):
            scale = float(want.abs().max())
            check_close(f"train chunked attention {label} f32 S {S} GQA "
                        f"{H}/{Hkv} {name}", got, want, 0.0,
                        CHUNK_TOL * scale)
    train_wkv6_on_card(gen)
    torch.cuda.synchronize()
    print(f"[train] 8a: autograd functions agree with their plain versions "
          f"({card})")


def train_wkv6_on_card(gen) -> None:
    """8a's WKV6: ``WKV6Fn`` (the forward kernel keeping states, then the
    backward kernel) at 8d's micro-batch shape with a nonzero s0 and a
    cotangent on sT, against autograd through the plain recurrence."""
    import torch
    from repro_torch.kernels.rwkv6 import ops
    B, T, H, hd = 4, RWKV_SEQ, 32, 64
    r, k, v = (torch.randn(B, T, H, hd, generator=gen, device="cuda")
               .mul(0.5).to(torch.bfloat16) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, T, H, hd, generator=gen,
                                         device="cuda") * 0.5))
    u = torch.randn(H, hd, generator=gen, device="cuda") * 0.3
    s0 = torch.randn(B, H, hd, hd, generator=gen, device="cuda") * 0.1
    gy = torch.randn(B, T, H * hd, generator=gen, device="cuda").to(
        torch.bfloat16)
    gs = torch.randn(B, H, hd, hd, generator=gen, device="cuda") * 0.1
    args = (r, k, v, w, u, s0)
    leaves = [t.clone().requires_grad_(True) for t in args]
    before = (ops.launches, ops.launches_bwd)
    y, sT = ops.wkv6(*leaves)
    if (ops.launches, ops.launches_bwd) != (before[0] + 1, before[1]):
        raise AssertionError("WKV6 under grad did not launch the forward "
                             "kernel once")
    torch.autograd.backward([y, sT], [gy, gs])
    if ops.launches_bwd != before[1] + 1:
        raise AssertionError("WKV6's backward did not launch its kernel "
                             "once")
    ref = [t.clone().requires_grad_(True) for t in args]
    yr, sTr = ops.wkv6_plain(*ref)
    torch.autograd.backward([yr, sTr], [gy, gs])
    what = f"train WKV6Fn B={B} T={T} H={H} hd={hd} bf16"
    check_close(f"{what} y", y.detach(), yr.detach(), TOL["bfloat16"],
                TOL["bfloat16"])
    check_close(f"{what} sT", sT.detach(), sTr.detach(), TOL["float32"],
                WKV_ATOL["float32"])
    for name, got, want in zip(GRAD_NAMES, leaves, ref):
        tol = WKV_BWD_TOL[str(got.grad.dtype)[6:]]
        scale = float(want.grad.float().abs().max())
        check_close(f"{what} {name} against autograd through the plain "
                    f"recurrence (scale {scale:.3e})", got.grad, want.grad,
                    tol, tol * scale)


def free_card(after: str = "") -> int:
    """Collects garbage and returns cached device memory; after a phase,
    prints what the phase left allocated on the card.  Returns the bytes
    allocated."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if after:
        print(f"[memory] after {after}: {held / 2**30:.3f} GiB allocated")
    return held


def trainer_run(cfg, steps: int, seq: int = TRAIN_SEQ,
                batch: int = TRAIN_BATCH, accum: int = TRAIN_ACCUM, **kw):
    """A TaskGraphTrainer on the card (8b's seq, batch and accum unless
    given): its report, the train_step spans' seconds, the scheduler's
    stats and the peak device memory; the trainer's scheduler is shut down
    and its state freed."""
    import torch
    from repro_torch.runtime import TaskGraphTrainer
    torch.cuda.reset_peak_memory_stats()
    tr = TaskGraphTrainer(cfg, seq_len=seq, global_batch=batch,
                          accum=accum, device="cuda", **kw)
    rep = tr.run(steps, metrics_every=1)
    torch.cuda.synchronize()
    spans = [sp.t1 - sp.t0 for sp in tr.sched.timeline.spans
             if sp.name == "train_step"]
    stats = tr.sched.stats()
    tr.sched.shutdown()
    del tr
    free_card()
    return rep, spans, stats, torch.cuda.max_memory_allocated()


def profile_train_step(cfg, card: str, seq: int = TRAIN_SEQ,
                       global_batch: int = TRAIN_BATCH,
                       accum: int = TRAIN_ACCUM) -> None:
    """One step of the trainer's step function (8b's seq, batch and accum
    unless given), called directly after two warm steps, under
    ``torch.profiler``: the device busy share and the kernels that take
    the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.models import init_lm
    from repro_torch.optim import AdamW
    from repro_torch.runtime import TrainState, make_train_step
    opt = AdamW(lr=1e-3, warmup=10, total_steps=1000)
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    state = TrainState(model, opt.init(model))
    step = make_train_step(cfg, opt)
    stream = SyntheticTokenStream(cfg, seq, global_batch, accum=accum)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in stream.batch(0).items()}
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, span = device_busy_us(prof.events())
    print(f"[profile train] {cfg.name}, {cfg.n_layers} layers: one step "
          f"under the profiler: wall {wall:.4f} s, "
          f"device busy {busy / 1e6:.4f} s over a {span / 1e6:.4f} s device "
          f"span, busy share of the wall {busy / 1e6 / wall:.4f} ({card})")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=30)
    for line in table.splitlines():
        print(f"[profile train] {line}")
    del state, model, batch, prof
    free_card()


def train_full_width(card: str, profile: bool) -> dict:
    """8b: TaskGraphTrainer on qwen3_32b at full width, 2 layers; returns
    the kernels' launch counts of the uninterrupted run."""
    import math
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import GrScheduler

    cfg = dataclasses.replace(get_config("qwen3_32b"), n_layers=2)
    n_params = (2 * cfg.vocab * cfg.d_model + cfg.d_model + cfg.n_layers * (
        2 * cfg.d_model * (cfg.n_heads + cfg.n_kv_heads) * cfg.hd
        + 3 * cfg.d_model * cfg.d_ff + 2 * cfg.d_model + 2 * cfg.hd))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # Unit-RMS rows after the final norm against a head of std 0.02: each
    # logit has variance d * 0.02², so E[lse] = ln V + d * 0.02² / 2; the
    # z-loss adds 1e-4 * lse².
    lse = math.log(cfg.vocab) + cfg.d_model * 0.02 ** 2 / 2
    first_want = lse + 1e-4 * lse ** 2
    print(f"[train] 8b: {cfg.name} at full width, {cfg.n_layers} layers, "
          f"{n_params:,} f32 parameters ({16 * n_params / 1e9:.2f} GB with "
          f"gradients and two AdamW moments); seq {TRAIN_SEQ}, global batch "
          f"{TRAIN_BATCH}, accum {TRAIN_ACCUM}, remat, parallel policy")

    t0 = time.perf_counter()
    reset_launches()                      # count the main path only
    rep, spans, stats, peak = trainer_run(cfg, TRAIN_STEPS)
    launches = read_launches()
    wall = time.perf_counter() - t0
    losses = rep.losses
    steady = spans[2:]
    med = statistics.median(steady)
    print(f"[train] {TRAIN_STEPS} steps: losses {json.dumps(losses)}; first "
          f"{losses[0]:.4f} against {first_want:.4f} reckoned (ln V "
          f"{math.log(cfg.vocab):.4f})")
    print(f"[train] train_step spans (s) {json.dumps(spans)}: median after "
          f"the first two {med:.4f} s (min {min(steady):.4f}, max "
          f"{max(steady):.4f}), {tokens / med:.1f} tok/s; run wall "
          f"{wall:.2f} s with init; peak device memory {peak / 2**30:.3f} GiB "
          f"({peak / 1e9:.2f} GB); launches {json.dumps(launches)} ({card})")
    print(f"[train] scheduler stats {json.dumps(stats, default=str)}")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"losses not finite: {losses}")
    if abs(losses[0] - first_want) > 0.1:
        raise AssertionError(f"first loss {losses[0]} is not within 0.1 of "
                             f"{first_want:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    expect_launches(launches, {"rmsnorm": RMS_PER_STEP * TRAIN_STEPS,
                               "flash_attention": 0, "wkv6": 0,
                               "wkv6_bwd": 0})

    serial, sspans, _, _ = trainer_run(
        cfg, 5, scheduler=GrScheduler(policy="serial", device="cuda"))
    diff = float(np.max(np.abs(np.subtract(serial.losses, losses[:5]))))
    print(f"[train] serial policy, 5 steps: losses "
          f"{json.dumps(serial.losses)}; largest difference from the "
          f"parallel run {diff:.3e} (rtol 1e-5); median step "
          f"{statistics.median(sspans[2:]):.4f} s ({card})")
    np.testing.assert_allclose(serial.losses, losses[:5], rtol=1e-5)

    from repro_torch.runtime import TaskGraphTrainer
    tmp = tempfile.mkdtemp(prefix="smoke-train-")
    try:
        torch.cuda.reset_peak_memory_stats()
        tr = TaskGraphTrainer(cfg, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, accum=TRAIN_ACCUM,
                              ckpt_dir=tmp, ckpt_every=CKPT_EVERY,
                              device="cuda")
        t0 = time.perf_counter()
        rrep = tr.run_with_restart(TRAIN_STEPS, fail_at=FAIL_AT)
        rwall = time.perf_counter() - t0
        saved = os.path.join(tmp, f"step_{FAIL_AT}")
        size = sum(os.path.getsize(os.path.join(saved, f))
                   for f in os.listdir(saved))
        tr.sched.shutdown()
        del tr
        free_card()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rdiff = abs(rrep.losses[-1] - losses[-1])
    print(f"[train] run_with_restart({TRAIN_STEPS}, fail_at={FAIL_AT}), a "
          f"checkpoint every {CKPT_EVERY} steps: restarts "
          f"{rrep.restarts}, last loss {rrep.losses[-1]!r} against "
          f"{losses[-1]!r} uninterrupted, difference {rdiff:.3e} (rtol "
          f"1e-5); wall {rwall:.2f} s for {TRAIN_STEPS} steps, a save of "
          f"{size / 1e9:.2f} GB and a restore; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({card})")
    np.testing.assert_allclose(rrep.losses[-1], losses[-1], rtol=1e-5)
    if profile:
        profile_train_step(cfg, card)
    return launches


def rwkv6_gradients(cfg, plain: bool, f32: bool) -> tuple:
    """One micro-batch's loss and per-leaf float32 gradients of ``cfg``
    (random weights from seed 0, remat), through the WKV6 kernels or, with
    ``plain``, through autograd of the plain recurrence (``R.wkv6``
    patched, as phase 4 patches it); with ``f32`` the embedding's output,
    and so every activation after it, stays float32 instead of bf16."""
    from unittest import mock

    import torch
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.models import init_lm
    from repro_torch.models import rwkv as R
    from repro_torch.models import transformer as T
    from repro_torch.runtime.steps import make_loss_fn
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    model.requires_grad_(True)
    stream = SyntheticTokenStream(cfg, RWKV_SEQ, RWKV_BATCH,
                                  accum=RWKV_ACCUM)
    mb = {k: torch.from_numpy(v[0]).cuda()
          for k, v in stream.batch(0).items()}
    embed = T._embed
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(mock.patch.object(R, "wkv6", ops.wkv6_plain))
        if f32:
            stack.enter_context(mock.patch.object(
                T, "_embed", lambda *a, **k: embed(*a, **k).float()))
        total, _ = make_loss_fn(cfg, remat=True)(model, mb)
        total.backward()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    loss = float(total.detach())
    del model, total
    free_card()
    return loss, grads


def grad_distance(got: dict, want: dict) -> tuple:
    """(worst leaf, its relative Frobenius distance, the distance over all
    leaves) of ``got``'s gradients from ``want``'s."""
    import torch
    num = den = 0.0
    worst = ("", 0.0)
    for name, g in got.items():
        err = float(torch.linalg.vector_norm(g - want[name]))
        ref = float(torch.linalg.vector_norm(want[name]))
        rel = err / ref if ref else err
        worst = max(worst, (name, rel), key=lambda x: x[1])
        num += err ** 2
        den += ref ** 2
    return worst[0], worst[1], (num / den) ** 0.5


def train_rwkv6(card: str, profile: bool) -> dict:
    """8d: TaskGraphTrainer on rwkv6_1_6b at full width and depth through
    the WKV6 forward and backward kernels; returns the kernels' launch
    counts of the first run.  ``profile`` adds one profiled step."""
    import math
    import statistics

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import GrScheduler

    cfg = get_config("rwkv6_1_6b")
    n_params = cfg.param_count()
    tokens = RWKV_BATCH * RWKV_SEQ
    # Unit-variance rows after the final layernorm against a head of std
    # 0.02, as 8b reckons it: E[lse] = ln V + d * 0.02² / 2, and the
    # z-loss adds 1e-4 * lse².
    lse = math.log(cfg.vocab) + cfg.d_model * 0.02 ** 2 / 2
    first_want = lse + 1e-4 * lse ** 2
    print(f"[train] 8d: {cfg.name} at full width and depth, "
          f"{cfg.n_layers} layers, {n_params:,} f32 parameters "
          f"({16 * n_params / 1e9:.2f} GB with gradients and two AdamW "
          f"moments); seq {RWKV_SEQ}, global batch {RWKV_BATCH}, accum "
          f"{RWKV_ACCUM}, remat, parallel policy")
    t0 = time.perf_counter()
    reset_launches()                      # count the main path only
    with kernels_only_on_card():
        rep, spans, stats, peak = trainer_run(cfg, RWKV_STEPS, seq=RWKV_SEQ,
                                              batch=RWKV_BATCH,
                                              accum=RWKV_ACCUM)
    launches = read_launches()
    wall = time.perf_counter() - t0
    losses = rep.losses
    steady = spans[2:]
    med = statistics.median(steady)
    print(f"[train] 8d {RWKV_STEPS} steps: losses {json.dumps(losses)}; "
          f"first {losses[0]:.4f} against {first_want:.4f} reckoned (ln V "
          f"{math.log(cfg.vocab):.4f})")
    print(f"[train] 8d train_step spans (s) {json.dumps(spans)}: median "
          f"after the first two {med:.4f} s (min {min(steady):.4f}, max "
          f"{max(steady):.4f}), {tokens / med:.1f} tok/s; run wall "
          f"{wall:.2f} s with init; peak device memory "
          f"{peak / 2**30:.3f} GiB ({peak / 1e9:.2f} GB); launches "
          f"{json.dumps(launches)} ({card})")
    if len(losses) != RWKV_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"8d losses not finite: {losses}")
    if abs(losses[0] - first_want) > 0.1:
        raise AssertionError(f"8d first loss {losses[0]} is not within 0.1 "
                             f"of {first_want:.4f}")
    # WKV6 once a layer in each micro-batch's forward and again in remat's
    # recompute (both keep states: grad is on in both), its backward once
    # a layer and micro-batch; layernorm only, no attention.
    per_step = cfg.n_layers * RWKV_ACCUM
    expect_launches(launches, {"wkv6": 2 * per_step * RWKV_STEPS,
                               "wkv6_bwd": per_step * RWKV_STEPS,
                               "wkv6_t1": 0, "rmsnorm": 0,
                               "flash_attention": 0})

    serial, sspans, _, _ = trainer_run(
        cfg, RWKV_SERIAL_STEPS, seq=RWKV_SEQ, batch=RWKV_BATCH,
        accum=RWKV_ACCUM, scheduler=GrScheduler(policy="serial",
                                                device="cuda"))
    diff = float(np.max(np.abs(np.subtract(
        serial.losses, losses[:RWKV_SERIAL_STEPS]))))
    print(f"[train] 8d serial policy, {RWKV_SERIAL_STEPS} steps: losses "
          f"{json.dumps(serial.losses)}; largest difference from the "
          f"parallel run {diff:.3e} (rtol 1e-5); steps "
          f"{json.dumps(sspans)} s ({card})")
    np.testing.assert_allclose(serial.losses, losses[:RWKV_SERIAL_STEPS],
                               rtol=1e-5)

    cut = dataclasses.replace(cfg, n_layers=RWKV_GRAD_LAYERS)
    runs = {}
    for f32 in (True, False):
        with kernels_only_on_card():
            runs["kernel", f32] = rwkv6_gradients(cut, False, f32)
        runs["plain", f32] = rwkv6_gradients(cut, True, f32)
    act = {True: "float32", False: "bf16"}
    for f32 in (True, False):
        (loss_k, got), (loss_p, want) = runs["kernel", f32], runs["plain", f32]
        leaf, rel, whole = grad_distance(got, want)
        print(f"[train] 8d one step's gradients at full width cut to "
              f"{RWKV_GRAD_LAYERS} layers, {act[f32]} activations, the WKV6 "
              f"kernels against autograd through the plain recurrence: loss "
              f"{loss_k!r} against {loss_p!r}; worst leaf {leaf} {rel:.4e}, "
              f"all leaves {whole:.4e}, relative Frobenius ({card})")
        if f32 and (rel > GRAD_LEAF_TOL or whole > GRAD_ALL_TOL):
            raise AssertionError(f"8d float32 gradients differ: {leaf} "
                                 f"{rel:.3e} (held at {GRAD_LEAF_TOL}), all "
                                 f"{whole:.3e} (held at {GRAD_ALL_TOL})")
    truth = runs["plain", True][1]
    k_far = grad_distance(runs["kernel", False][1], truth)[2]
    p_far = grad_distance(runs["plain", False][1], truth)[2]
    print(f"[train] 8d bf16 gradients against the plain float32 ones, all "
          f"leaves: kernel path {k_far:.4e}, plain path {p_far:.4e}, ratio "
          f"{k_far / p_far:.4f} (held at {GRAD_BF16_RATIO}) ({card})")
    if k_far > GRAD_BF16_RATIO * p_far:
        raise AssertionError(f"8d: the kernel path's bf16 gradients are "
                             f"{k_far:.3e} from the float32 ones, the plain "
                             f"path's {p_far:.3e}")
    del runs, truth
    free_card()
    if profile:
        profile_train_step(cfg, card, RWKV_SEQ, RWKV_BATCH, RWKV_ACCUM)
    return launches


def train_cli(card: str) -> None:
    """8c: ``python -m repro_torch.launch.train`` on the card, 12 steps
    uninterrupted, then 6 (the interruption) and 12 (the resume from the
    step-4 checkpoint) in a fresh directory; the resumed ``step N:`` lines
    must equal the uninterrupted ones character for character."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="smoke-train-cli-")
    env = dict(os.environ, PYTHONPATH=SRC)

    def run(d: str, steps: int) -> list:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "qwen3_32b", "--reduced", "--steps", str(steps), "--ckpt",
             os.path.join(tmp, d), "--ckpt-every", "4"],
            env=env, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise AssertionError(f"train CLI failed: {res.stdout}"
                                 f"{res.stderr}")
        lines = res.stdout.splitlines()
        print(f"[train] CLI --steps {steps} in {d}: "
              f"{time.perf_counter() - t0:.2f} s: {json.dumps(lines)}")
        return lines

    try:
        full = run("a", 12)
        run("b", 6)
        resumed = run("b", 12)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def steps(lines):
        return {ln.split(":")[0]: ln for ln in lines if ln.startswith("step ")}
    if not full[0].startswith("device: cuda"):
        raise AssertionError(f"the CLI did not run on the card: {full[0]}")
    if "resumed from step 4" not in resumed:
        raise AssertionError("the CLI did not resume from step 4")
    if list(steps(full)) != ["step 5", "step 10", "step 12"] \
            or steps(resumed) != steps(full):
        raise AssertionError(f"resumed lines {steps(resumed)} differ from "
                             f"the uninterrupted {steps(full)}")
    print(f"[train] 8c: the resumed run's step lines equal the "
          f"uninterrupted run's character for character ({card})")
    # rwkv6 through the launcher: the reduced config (hd 16) trains on the
    # card through both WKV6 kernels.
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "rwkv6_1_6b", "--reduced", "--steps", "12"], env=env,
        capture_output=True, text=True, timeout=300)
    lines = res.stdout.splitlines()
    print(f"[train] CLI rwkv6_1_6b --reduced --steps 12: "
          f"{time.perf_counter() - t0:.2f} s: {json.dumps(lines)}")
    if res.returncode != 0:
        raise AssertionError(f"rwkv6 train CLI failed: {res.stdout}"
                             f"{res.stderr}")
    if not lines or not lines[0].startswith("device: cuda"):
        raise AssertionError(f"the rwkv6 CLI did not run on the card: "
                             f"{lines[:1]}")
    got = steps(lines)
    if list(got) != ["step 5", "step 10", "step 12"] or not all(
            "loss=nan" not in ln and "loss=inf" not in ln
            for ln in got.values()):
        raise AssertionError(f"rwkv6 CLI step lines {got}")
    print(f"[train] 8c: rwkv6 trains through the launcher on the card "
          f"({card})")


def phase_train_process(profile: bool) -> dict:
    """Phase 8 in a process of its own, as phase 7b's daemon: the train
    state needs 44 GiB, and a new process starts with nothing cached or
    split on the card.
    Returns the kernels' launch counts of 8b's main path, which the child
    prints on its last line."""
    cmd = [sys.executable, os.path.abspath(__file__), TRAIN_ONLY]
    res = subprocess.run(cmd + (["--profile"] if profile else []),
                         capture_output=True, text=True, timeout=1000)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr)
    lines = res.stdout.splitlines()
    if res.returncode != 0 or not lines or not lines[-1].startswith("{"):
        raise AssertionError(f"phase 8 failed (exit {res.returncode})")
    return json.loads(lines[-1])


def phase_train(card: str, profile: bool = False) -> dict:
    import torch
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    print(f"[train] device memory allocated at the start: "
          f"{held / 2**30:.3f} GiB")
    if held >= 2**30:
        raise AssertionError("an earlier phase left over 1 GiB on the card")
    train_autograd_on_card(card)
    print(f"[train] 8a {time.perf_counter() - t_phase:.2f} s")
    t0 = time.perf_counter()
    launches = train_full_width(card, profile)
    print(f"[train] 8b {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    train_cli(card)
    print(f"[train] 8c {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rwkv = train_rwkv6(card, profile)
    print(f"[train] 8d {time.perf_counter() - t0:.2f} s")
    print(f"[train] phase {time.perf_counter() - t_phase:.2f} s")
    return {"qwen3": launches, "rwkv6": rwkv}


# The families phase, in a process of its own.  9a: hymba_1_5b as published
# through the serving engine, prompts of 2048 tokens so that the window of
# 1024 binds in flash and prefill rolls the ring buffer; 9b: the serving
# launcher on seamless_m4t_medium as published, as a subprocess; 9c:
# internvl2_76b at full width cut to 8 of its 80 layers (full depth is 141
# GB of bf16 weights, over the card's 80 GB) through the launcher's
# function, with its 256 patch embeddings.
FAMILIES_ONLY = "--phase-9-process"
HYMBA_PLEN = 2048
INTERNVL_LAYERS = 8
LAUNCH_PLEN = 1024
# Flash against plain attention in hymba's prefill, read out after 2 and
# 32 layers.  With float32 activations only the kernel's float32 sums in
# another order differ (held at 1e-3, as phase 4 holds WKV6).  With bf16
# activations the two paths round at different places and depth
# amplifies that; the plain path's own bf16 rounding, measured in the same
# run as its distance from the float32 path, is the drift that depth gives
# bf16 here: each depth holds the larger of 2e-2 and that drift.
HYMBA_DEPTHS = (2, 32)
F32_LOGIT_TOL = 1e-3


def flash_against_plain(tag: str, cfg, model, toks, depths) -> None:
    """The prefill's logits read out after each of ``depths`` layers with
    flash against the plain attention: with float32 activations (the
    float32 kernel) at ``F32_LOGIT_TOL``, with bf16 ones (the served path,
    the tensor-core kernel) at the larger of 2e-2 and the plain path's own
    bf16 drift from float32.  An MoE model routes each token to its top-k
    experts and drops what overflows a capacity, so a rounding difference
    that flips one choice moves every later token of that expert: its bf16
    logits are held at 2e-2 only at depths up to the first layer whose kept
    routed tokens differ between the two paths, and printed unchecked
    deeper (the kernel itself is held at the model's shape in phase 2)."""
    import numpy as np
    import torch
    runs, kept = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for flash in (True, False):
            aux = {} if cfg.moe is not None else None
            runs[dtype, flash] = logits_by_depth(cfg, model, toks, depths,
                                                 dtype, use_flash=flash,
                                                 aux=aux)
            if aux is not None:
                kept[dtype, flash] = torch.stack(aux["moe_kept"]).cpu().numpy()
    routed_alike = cfg.n_layers       # bf16 layers before the first split
    for dtype, flash in kept:
        if flash:
            differ = [i for i in range(cfg.n_layers) if not np.array_equal(
                kept[dtype, True][i], kept[dtype, False][i])]
            print(f"[{tag}] {str(dtype)[6:]} activations: layers whose "
                  f"kept routed tokens differ between flash and plain "
                  f"attention: {differ}")
            if dtype == torch.bfloat16 and differ:
                routed_alike = differ[0]
    for n in depths:
        check_logits(tag, f"flash vs plain attention, {n} layers, float32 "
                     f"activations", runs[torch.float32, True][n],
                     runs[torch.float32, False][n], F32_LOGIT_TOL)
        plain32 = runs[torch.float32, False][n]
        drift = float((runs[torch.bfloat16, False][n] - plain32).abs().max()
                      / plain32.abs().max())
        print(f"[{tag}] plain path, {n} layers: bf16 activations drift "
              f"{drift:.3e} of the logit scale from float32 ones")
        if cfg.moe is None:
            rtol = max(TOL["bfloat16"], drift)
        elif n <= routed_alike:
            rtol = TOL["bfloat16"]
        else:
            rtol = None
            print(f"[{tag}] {n} layers: layer {routed_alike} (from 0) "
                  f"keeps other routed tokens with flash than with plain "
                  f"attention in bf16, so the logits below are not held")
        check_logits(tag, f"flash vs plain attention, {n} layers, bf16 "
                     f"activations", runs[torch.bfloat16, True][n],
                     runs[torch.bfloat16, False][n], rtol)


def phase_hymba(card: str, profile: bool = False) -> dict:
    """hymba_1_5b as published: 32 hybrid layers, attention (H 25, Hkv 5,
    hd 64, window 1024) through the flash kernel in parallel with Mamba
    heads, every norm through RMSNorm."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm

    cfg = get_config("hymba_1_5b")
    batch, new, plen, n_req = 2, 16, HYMBA_PLEN, 8
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[hymba] {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, H {cfg.n_heads}/{cfg.n_kv_heads}, "
          f"window {cfg.sliding_window}, Mamba inner "
          f"{cfg.ssm.expand * cfg.d_model} x state {cfg.ssm.state_dim}): "
          f"{n_params:,} f32 parameters ({n_params * 4 / 1e9:.2f} GB), init "
          f"{time.perf_counter() - t0:.2f} s")
    prompts = make_prompts(cfg, n_req, plen)
    toks = torch.from_numpy(np.stack(prompts[:batch])).cuda()
    t0 = time.perf_counter()
    direct, _ = direct_call(cfg, model, toks, new, use_flash=True)
    print(f"[hymba] direct prefill and {new - 1} decode steps "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    flash_against_plain("hymba", cfg, model, toks, HYMBA_DEPTHS)
    print(f"[hymba] logits by depth {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    peak_direct = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    launches = serve_and_check("hymba", cfg, model, prompts, batch, new,
                               direct, card, profile)
    n_batches = n_req // batch
    # Per forward call (the prefill and each of new - 1 decode steps): ln1
    # and ln2 in every layer, and the final norm (no qk-norm; the Mamba
    # heads have no norm).  One flash call a layer in each prefill.
    expect_launches(launches, {
        "flash_attention": cfg.n_layers * n_batches,
        "rmsnorm": (2 * cfg.n_layers + 1) * new * n_batches,
        "wkv6": 0})
    print(f"[hymba] peak device memory of the direct calls "
          f"{peak_direct / 2**30:.3f} GiB, of the served run "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; serving "
          f"and checks {time.perf_counter() - t0:.2f} s ({card})")
    if not profile:                 # profile_serving printed them
        wall, = serial_policy_walls(cfg, model, prompts, batch, new, 1)
        print(f"[hymba] serial policy wall {wall:.4f} s ({card})")
    print(f"[hymba] phase 9a {time.perf_counter() - t_phase:.2f} s")
    return launches


def launcher_seamless(card: str) -> None:
    """``python -m repro_torch.launch.serve`` on seamless_m4t_medium as
    published (12 encoder and 12 decoder layers, vocab 256206, bf16
    weights): its two lines go through unchanged; its exit code is
    asserted."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = get_config("seamless_m4t_medium")
    n = sum(p.numel() for p in LM(cfg, torch.device("meta")).parameters())
    print(f"[seamless] {cfg.name} as published ({cfg.n_encoder_layers} "
          f"encoder + {cfg.n_layers} decoder layers, vocab {cfg.vocab}): "
          f"{n:,} parameters ({n * 2 / 1e9:.2f} GB in bf16)")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "seamless_m4t_medium", "--batch", "2", "--prompt-len",
           str(LAUNCH_PLEN), "--new-tokens", "16"]
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr)
    print(f"[seamless] {' '.join(cmd[1:])}: exit {res.returncode}, "
          f"{time.perf_counter() - t0:.2f} s with the process start "
          f"({card})")
    # numpy wraps the sample of 6-digit token ids over two lines, as the
    # reference's launcher prints it
    lines = res.stdout.splitlines()
    if res.returncode != 0 or not lines or not lines[0].startswith(
            "device cuda | generated 32 tokens in ") or not lines[
            1].startswith("sample: ["):
        raise AssertionError("the serving launcher failed on seamless")


def launcher_internvl(card: str) -> dict:
    """internvl2_76b at full width, 8 of 80 layers, through
    ``launch.serve.generate`` with its 256 patch embeddings: bf16 weights,
    so every RMSNorm takes a bf16 scale."""
    from unittest import mock

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.launch import serve
    from repro_torch.models import forward_prefill, init_cache, layers
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("internvl2_76b"),
                              n_layers=INTERNVL_LAYERS)
    B, new = 2, 16
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                      # count the main path only
    out = serve.generate(cfg, batch=B, prompt_len=LAUNCH_PLEN,
                         new_tokens=new, device="cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    model, dev = out["model"], out["batch"]
    n = sum(p.numel() for p in model.parameters())
    toks = B * new
    print(f"[internvl] {cfg.name} at full width, {cfg.n_layers} of 80 "
          f"layers: {n:,} bf16 parameters ({n * 2 / 1e9:.2f} GB); prompts "
          f"of {LAUNCH_PLEN} with {cfg.n_frontend_tokens} patch "
          f"embeddings: generated {toks} tokens in {out['seconds']:.2f} s "
          f"({toks / out['seconds']:.1f} tok/s), launches "
          f"{json.dumps(launches)}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({card})")
    print(f"[internvl] sample: {out['tokens'][0][:12]}")
    # ln1 and ln2 in each layer and the final norm, per forward call; the
    # launcher takes plain attention, as the reference's.
    expect_launches(launches, {"rmsnorm": (2 * cfg.n_layers + 1) * new,
                               "flash_attention": 0, "wkv6": 0})
    if out["tokens"].shape != (B, new) or not all(
            torch.isfinite(lg).all() for lg in out["logits"]):
        raise AssertionError("internvl: tokens or logits out of shape or "
                             "not finite")
    # The patch positions: the first 256 embeddings are the projected
    # patches, the rest the tokens'; the logits move with the patches.
    with torch.no_grad():
        x = T._embed(cfg, model, dev["tokens"], dev["patches"])
        proj = dev["patches"].bfloat16() @ model.frontend_proj
        plain = T._embed(cfg, model, dev["tokens"])
    P = cfg.n_frontend_tokens
    if not (torch.equal(x[:, :P], proj) and torch.equal(x[:, P:],
                                                        plain[:, P:])):
        raise AssertionError("internvl: the patch embeddings do not take "
                             "the first positions")

    def prefill(batch):
        cache = init_cache(cfg, B, LAUNCH_PLEN + 1, "cuda")
        return forward_prefill(cfg, model, batch, cache)[0]
    first = out["logits"][0]
    without = prefill({"tokens": dev["tokens"]})
    moved = float((first - without).abs().max() / first.abs().max())
    print(f"[internvl] prefill logits without the patches differ by "
          f"{moved:.3e} of the logit scale")
    if not moved > 0:
        raise AssertionError("internvl: the patches do not reach the logits")
    # The RMSNorm kernel on bf16 scales against its plain version, on the
    # served depth, held as phase 9a holds flash: with float32
    # activations at 1e-3; with bf16 ones at the larger of 2e-2 and the
    # plain path's own bf16 drift from float32 activations.  That drift is
    # large here (random weights give each projection a gain of 1.8 at d
    # 8192; tests/test_torch_families.py shows the reference drifting as
    # much), so the bf16 instantiation is also held call by call: each
    # norm of the bf16 prefill, on the inputs the served depth gives it,
    # against its plain version at the kernel phase's bf16 tolerance.
    n, args = cfg.n_layers, (cfg, model, dev["tokens"], (cfg.n_layers,))
    kernel_rmsnorm, calls = layers.rmsnorm, []

    def recorded(x, scale, eps=1e-6):
        y = kernel_rmsnorm(x, scale, eps)
        calls.append((y.flatten(), rmsnorm_ref(x.float(), scale,
                                               eps).flatten()))
        return y
    runs = {}
    for kernel in (True, False):
        for dtype in (torch.float32, torch.bfloat16):
            norm = (rmsnorm_ref if not kernel else recorded
                    if dtype == torch.bfloat16 else kernel_rmsnorm)
            with mock.patch.object(layers, "rmsnorm", norm):
                runs[kernel, dtype] = logits_by_depth(
                    *args, dtype, patches=dev["patches"])[n]
    if len(calls) != 2 * n + 1:
        raise AssertionError(f"internvl: {len(calls)} RMSNorm calls in a "
                             f"bf16 prefill of {n} layers")
    check_close(f"internvl: RMSNorm kernel, bf16 x and bf16 scale, each of "
                f"the {len(calls)} calls of a bf16 prefill of {n} layers "
                f"(x {tuple(dev['tokens'].shape)} x {cfg.d_model})",
                torch.cat([c[0] for c in calls]),
                torch.cat([c[1] for c in calls]), TOL["bfloat16"],
                TOL["bfloat16"])
    del calls
    print(f"[internvl] prefill logits read out by depth against the "
          f"launcher's: max abs diff "
          f"{float((runs[True, torch.bfloat16] - first).abs().max()):.3e}")
    plain32 = runs[False, torch.float32]
    check_logits("internvl", f"RMSNorm kernel (bf16 scales) vs its plain "
                 f"version, {n} layers, float32 activations",
                 runs[True, torch.float32], plain32, F32_LOGIT_TOL)
    drift = float((runs[False, torch.bfloat16] - plain32).abs().max()
                  / plain32.abs().max())
    print(f"[internvl] plain path, {n} layers: bf16 activations drift "
          f"{drift:.3e} of the logit scale from float32 ones")
    check_logits("internvl", f"RMSNorm kernel (bf16 scales) vs its plain "
                 f"version, {n} layers, bf16 activations",
                 runs[True, torch.bfloat16], runs[False, torch.bfloat16],
                 max(TOL["bfloat16"], drift))
    return launches


def phase_families(card: str, profile: bool = False) -> dict:
    import torch
    t_phase = time.perf_counter()
    print(f"[families] device memory allocated at the start: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    hymba = phase_hymba(card, profile)
    free_card("hymba serving")
    t0 = time.perf_counter()
    launcher_seamless(card)
    print(f"[families] 9b {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    internvl = launcher_internvl(card)
    free_card("internvl")
    print(f"[families] 9c {time.perf_counter() - t0:.2f} s")
    print(f"[families] phase {time.perf_counter() - t_phase:.2f} s")
    return {"hymba": hymba, "internvl": internvl}


def phase_families_process(profile: bool) -> dict:
    """Phase 9 in a process of its own, as phase 8: returns the kernels'
    launch counts of 9a's served run and 9c's launcher run, which the
    child prints on its last line."""
    cmd = [sys.executable, os.path.abspath(__file__), FAMILIES_ONLY]
    res = subprocess.run(cmd + (["--profile"] if profile else []),
                         capture_output=True, text=True, timeout=900)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr)
    lines = res.stdout.splitlines()
    if res.returncode != 0 or not lines or not lines[-1].startswith("{"):
        raise AssertionError(f"phase 9 failed (exit {res.returncode})")
    return json.loads(lines[-1])


# The mesh phase, in a process of its own: an NCCL world of one rank.
MESH_ONLY = "--phase-10-process"
MESH_STEPS = 3
PHASE8B_STEP_S = 0.196            # phase 8b's trainer step, PERF.md §6


@contextlib.contextmanager
def kernels_only_on_card():
    """Makes every kernel wrapper's plain version raise for the duration
    (on the card the plain version is never the path; WKV6's saving forward
    and backward too), and counts the wrappers' ``DTensor`` entries (their
    ``local_map`` calls)."""
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.rwkv6 import ops as wkv
    sharded = {"rmsnorm": 0, "flash_attention": 0, "wkv6": 0}
    saved = []

    def patch(mod, name, new):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, new)

    def refuse(name):
        def plain(*a, **k):
            raise AssertionError(f"the plain version of {name} ran on the "
                                 f"card")
        return plain

    def counting(name, fn):
        def entry(*a, **k):
            sharded[name] += 1
            return fn(*a, **k)
        return entry
    patch(rms, "rmsnorm_ref", refuse("rmsnorm"))
    patch(flash, "attention_ref", refuse("flash_attention"))
    patch(wkv, "wkv6_plain", refuse("wkv6"))
    patch(wkv, "wkv6_plain_saving", refuse("wkv6"))
    patch(wkv, "wkv6_bwd_plain", refuse("wkv6_bwd"))
    patch(rms, "_rmsnorm_sharded", counting("rmsnorm",
                                            rms._rmsnorm_sharded))
    patch(flash, "_flash_sharded", counting("flash_attention",
                                            flash._flash_sharded))
    patch(wkv, "_wkv6_sharded", counting("wkv6", wkv._wkv6_sharded))
    try:
        yield sharded
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mesh_train_step(card: str, mesh) -> dict:
    """10a: phase 8b's model and batch, 3 steps on plain tensors, then 3 on
    ``DTensor`` parameters over the (1, 1) mesh; equal to rtol 1e-5."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.models import init_lm
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import TrainState, make_train_step
    from repro_torch.sharding.context import sharding_rules
    from repro_torch.sharding.rules import (NamedSharding, batch_spec,
                                            logical_to_physical,
                                            param_sharding, place)

    cfg = dataclasses.replace(get_config("qwen3_32b"), n_layers=2)
    stream = SyntheticTokenStream(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                  accum=TRAIN_ACCUM)
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch(i).items()}
               for i in range(MESH_STEPS)]

    def run(sharded: bool):
        opt = AdamW(lr=3e-4, warmup=20, total_steps=100)
        torch.cuda.reset_peak_memory_stats()
        model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
        feed = batches
        if sharded:
            logical_to_physical(mesh, model, param_sharding(model, mesh))
            bs = batch_spec(mesh)
            feed = [{k: place(v, NamedSharding(mesh, (None,) + bs[k]))
                     for k, v in b.items()} for b in batches]
        state = TrainState(model, opt.init(model))
        step = make_train_step(cfg, opt)
        losses, times = [], []
        for b in feed:
            if sharded:
                with sharding_rules(mesh):
                    (_, met), dt = sync_time(lambda: step(state, b))
            else:
                (_, met), dt = sync_time(lambda: step(state, b))
            losses.append(float(met["loss"]))
            times.append(dt)
        t_copy = time.perf_counter()
        host = {n: (p.full_tensor() if sharded else p).detach().cpu()
                for n, p in model.named_parameters()}
        print(f"[mesh] 10a {'sharded' if sharded else 'plain'} run: "
              f"parameters to the host in "
              f"{time.perf_counter() - t_copy:.2f} s")
        placed = sum(hasattr(p, "device_mesh") for p in model.parameters())
        peak = torch.cuda.max_memory_allocated()
        del state, model, step, opt
        free_card()
        return losses, times, host, peak, placed

    losses0, times0, host0, peak0, _ = run(False)
    print(f"[mesh] 10a plain step: losses {json.dumps(losses0)}, step "
          f"times (s) {json.dumps(times0)}, peak {peak0 / 2**30:.3f} GiB "
          f"({card})")
    reset_launches()
    with kernels_only_on_card() as sharded_calls:
        losses1, times1, host1, peak1, placed = run(True)
    launches = read_launches()
    n_leaves = len(host0)
    if placed != n_leaves:
        raise AssertionError(f"{placed} of {n_leaves} parameters were "
                             f"DTensors")
    loss_diff = float(np.max(np.abs(np.subtract(losses1, losses0))))
    np.testing.assert_allclose(losses1, losses0, rtol=1e-5)
    worst, worst_name, n_equal = 0.0, "", 0
    t_cmp = time.perf_counter()
    for n, want in host0.items():
        got = host1[n]
        if torch.equal(got, want):
            n_equal += 1
            continue
        diff = (got - want).abs()
        d = float(diff.max())
        if d >= worst:
            worst, worst_name = d, n
        if not bool((diff <= 1e-5 * want.abs()).all()):
            raise AssertionError(f"{n}: sharded and plain parameters differ "
                                 f"beyond rtol 1e-5 (largest {d:.3e})")
    t_cmp = time.perf_counter() - t_cmp
    per_step = launches["rmsnorm"] / MESH_STEPS
    print(f"[mesh] 10a sharded step on the (1, 1) mesh: losses "
          f"{json.dumps(losses1)}, step times (s) {json.dumps(times1)} "
          f"(phase 8b's trainer step: {PHASE8B_STEP_S} s), peak "
          f"{peak1 / 2**30:.3f} GiB; largest loss difference {loss_diff:.3e},"
          f" largest parameter difference {worst:.3e} {worst_name}; "
          f"{n_equal} of {n_leaves} leaves bitwise equal (compared in "
          f"{t_cmp:.2f} s); launches "
          f"{json.dumps(launches)}, DTensor entries "
          f"{json.dumps(sharded_calls)} ({card})")
    expect_launches(launches, {"rmsnorm": RMS_PER_STEP * MESH_STEPS,
                               "flash_attention": 0, "wkv6": 0})
    if sharded_calls["rmsnorm"] != launches["rmsnorm"] or per_step != \
            RMS_PER_STEP:
        raise AssertionError("RMSNorm did not launch through local_map "
                             "at every call")
    return launches


def mesh_spacesharing(card: str) -> dict:
    """10b: two independent prefills of phase 3's model space-shared by a
    SpaceSharedRunner on SubmeshPool() (one card: one lane), bit for bit
    equal to direct calls, under one declared identity."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import ElementKind
    from repro_torch.models import init_cache, init_lm
    from repro_torch.runtime import make_prefill_step
    from repro_torch.runtime.spacesharing import (SpaceSharedRunner,
                                                  SubmeshPool)

    cfg = dataclasses.replace(get_config("qwen3_32b"), n_layers=4)
    plen = 1024
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    prefill = make_prefill_step(cfg, use_flash=True)

    def task(toks):
        logits, _ = prefill(model, {"tokens": toks},
                            init_cache(cfg, toks.shape[0], plen, "cuda"))
        return logits
    rng = np.random.RandomState(10)
    prompts = [rng.randint(0, cfg.vocab, (1, plen)).astype(np.int32)
               for _ in range(2)]
    direct = [task(torch.from_numpy(p).cuda()) for p in prompts]
    torch.cuda.synchronize()
    pool = SubmeshPool()
    runner = SpaceSharedRunner(pool)
    reset_launches()
    try:
        with kernels_only_on_card():
            t0 = time.perf_counter()
            results = [runner.submit(task, [runner.sched.array(
                p, name=f"prompt{i}")], name="prefill")
                for i, p in enumerate(prompts)]
            got = runner.gather(results)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_launches()
        keys = {e.fn_key for e in runner.sched._elements
                if e.kind is ElementKind.KERNEL}
        stats = runner.sched.stats()
    finally:
        runner.sched.shutdown()
    equal = [bool(torch.equal(g, d)) for g, d in zip(got, direct)]
    print(f"[mesh] 10b SubmeshPool() lanes {[str(x) for x in pool.lanes]}, "
          f"two prefills of {cfg.name} (full width, {cfg.n_layers} layers, "
          f"{plen} tokens): {wall:.3f} s, bitwise equal to direct calls "
          f"{equal}, fn_keys {len(keys)}, launches {json.dumps(launches)}, "
          f"lanes_created {stats['lanes_created']} ({card})")
    if not all(equal):
        raise AssertionError("space-shared prefills differ from direct calls")
    if len(keys) != 1 or None in keys:
        raise AssertionError(f"SpaceSharedRunner minted {keys}")
    expect_launches(launches, {"flash_attention": 2 * cfg.n_layers,
                               "rmsnorm": 2 * (4 * cfg.n_layers + 1),
                               "wkv6": 0})
    del model, direct, got
    free_card()
    return launches


def mesh_serve_cli(card: str, mesh) -> dict:
    """10c: ``launch.serve.main`` on rwkv6_1_6b as published with
    ``--model-parallel 2``: a world of one rank, served on plain tensors
    (the reference's two lines, no ``DTensor``); then ``generate`` with
    the same model placed on the (1, 1) mesh, every WKV6 through
    ``local_map``, its first row's tokens equal to the launcher's
    sample."""
    import io
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config("rwkv6_1_6b")
    # batch 2, prompt 32, 16 new tokens: one prefill and 15 decode steps
    # of WKV6 in each of the 24 layers
    want = {"wkv6": cfg.n_layers * 16, "wkv6_t1": cfg.n_layers * 15,
            "flash_attention": 0, "rmsnorm": 0}
    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with kernels_only_on_card() as plain_calls, \
            contextlib.redirect_stdout(buf):
        serve.main(["--arch", "rwkv6_1_6b", "--model-parallel", "2"])
    wall = time.perf_counter() - t0
    cli = read_launches()
    lines = buf.getvalue().splitlines()
    sys.stdout.write(buf.getvalue())
    print(f"[mesh] 10c serve --arch rwkv6_1_6b --model-parallel 2: "
          f"{wall:.2f} s with init; launches {json.dumps(cli)}, "
          f"DTensor entries {json.dumps(plain_calls)} ({card})")
    if not lines or not lines[0].startswith(
            "device cuda | generated 32 tokens in ") or \
            not lines[1].startswith("sample: [") or \
            lines[-1] != "mesh {'data': 1, 'model': 1}":
        raise AssertionError(f"the serve launcher's lines: {lines}")
    expect_launches(cli, want)
    if any(plain_calls.values()):
        raise AssertionError("the launcher's world of one rank placed "
                             "DTensors")
    free_card()
    reset_launches()
    with kernels_only_on_card() as sharded_calls:
        out = serve.generate(cfg, device="cuda", mesh=mesh)
    placed = read_launches()
    print(f"[mesh] 10c generate on the (1, 1) mesh: {out['seconds']:.2f} s "
          f"for 32 tokens ({32 / out['seconds']:.1f} tok/s); launches "
          f"{json.dumps(placed)}, DTensor entries "
          f"{json.dumps(sharded_calls)} ({card})")
    expect_launches(placed, want)
    if sharded_calls["wkv6"] != placed["wkv6"]:
        raise AssertionError("WKV6 did not launch through local_map at "
                             "every call")
    if lines[1] != f"sample: {np.asarray(out['tokens'][0][:12])}":
        raise AssertionError(f"the mesh's tokens {out['tokens'][0][:12]} "
                             f"differ from the launcher's {lines[1]}")
    del out
    free_card()
    return {k: cli[k] + placed[k] for k in cli}


def mesh_compressed_psum(card: str, mesh) -> None:
    """10d: compressed_psum over the NCCL world of one rank on a gradient
    leaf of phase 8b's width (the embedding's, vocab x d), equal to
    compress_with_feedback's values; timed beside a plain all_reduce."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.optim.compress import (compress_with_feedback,
                                            compressed_psum)
    cfg = get_config("qwen3_32b")
    gen = torch.Generator(device="cuda").manual_seed(10)
    g = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                    device="cuda") * 1e-3
    e = torch.randn_like(g) * 1e-5
    want, want_err = compress_with_feedback(g, e)
    (red, errs), dt = sync_time(
        lambda: compressed_psum({"g": g}, {"g": e}, mesh["data"]))
    if not (torch.equal(red["g"], want.float())
            and torch.equal(errs["g"], want_err)):
        raise AssertionError("compressed_psum differs from "
                             "compress_with_feedback on one rank")
    times, plain = [], []
    for _ in range(3):
        times.append(sync_time(lambda: compressed_psum(
            {"g": g}, {"g": e}, mesh["data"]))[1])
        buf = g.clone()
        plain.append(sync_time(lambda: dist.all_reduce(
            buf, group=mesh["data"].get_group()))[1])
    print(f"[mesh] 10d compressed_psum on ({cfg.vocab}, {cfg.d_model}) "
          f"f32 ({g.numel() * 4 / 1e9:.2f} GB): equal to "
          f"compress_with_feedback; seconds {json.dumps(times)} (first "
          f"{dt:.4f}) against a plain all_reduce {json.dumps(plain)} "
          f"({card})")
    del g, e, want, want_err, red, errs
    free_card()


def phase_mesh(card: str) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import (init_world, make_mesh_for,
                                         mesh_axes)
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    print(f"[mesh] device memory allocated at the start: "
          f"{held / 2**30:.3f} GiB")
    if held >= 2**30:
        raise AssertionError("an earlier phase left over 1 GiB on the card")
    init_world("cuda")
    try:
        mesh = make_mesh_for(dist.get_world_size(), 2)
        print(f"[mesh] world {dist.get_world_size()} ({dist.get_backend()}),"
              f" mesh {mesh_axes(mesh)} on {mesh.device_type}")
        t0 = time.perf_counter()
        launches = mesh_train_step(card, mesh)
        print(f"[mesh] 10a {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        space = mesh_spacesharing(card)
        print(f"[mesh] 10b {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        serve = mesh_serve_cli(card, mesh)
        print(f"[mesh] 10c {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        mesh_compressed_psum(card, mesh)
        print(f"[mesh] 10d {time.perf_counter() - t0:.2f} s")
    finally:
        dist.destroy_process_group()
    print(f"[mesh] phase {time.perf_counter() - t_phase:.2f} s")
    return {name: launches[name] + space[name] + serve[name]
            for name in ("flash_attention", "rmsnorm", "wkv6", "wkv6_bwd")}


def phase_mesh_process() -> dict:
    """Phase 10 in a process of its own, as phases 8 and 9: returns the
    kernels' launch counts of its main paths, which the child prints on
    its last line."""
    cmd = [sys.executable, os.path.abspath(__file__), MESH_ONLY]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr)
    lines = res.stdout.splitlines()
    if res.returncode != 0 or not lines or not lines[-1].startswith("{"):
        raise AssertionError(f"phase 10 failed (exit {res.returncode})")
    return json.loads(lines[-1])


# The dry run, in a process of its own: 11a three production cells of
# ``launch.dryrun`` on fake CUDA tensors in fake worlds of 256 and 512
# ranks, each in a process of its own, all at once; 11b phase 8b's step
# counted on fake tensors (``build_cell``, ``count_step``), then run on the
# card under the same counter over an NCCL world of one rank.
DRYRUN_ONLY = "--phase-11-process"
DRYRUN_CELLS = [("qwen3_32b", "train_4k", False),
                ("nemotron_4_340b", "train_4k", True),
                ("rwkv6_1_6b", "long_500k", False),
                ("rwkv6_1_6b", "train_4k", False)]
# Each cell's kernel calls a step: qwen3's RMSNorms (4 a layer and the
# final norm forward, the layers' 4 again in remat's recompute; 64 layers,
# 16 microbatches), none in nemotron's (LayerNorm, and training takes the
# plain attention), rwkv6's one WKV6 a layer (24) in a decode step, and in
# its train step (16 microbatches of 16 sequences) the WKV6 forward twice
# a layer (the forward and remat's recompute) and its backward once: the
# plain loops would count none.
DRYRUN_KERNELS = {("qwen3_32b", "train_4k"): {"rmsnorm": (2 * 4 * 64 + 1)
                                              * 16},
                  ("nemotron_4_340b", "train_4k"): {},
                  ("rwkv6_1_6b", "long_500k"): {"wkv6": 24},
                  ("rwkv6_1_6b", "train_4k"): {"wkv6": 2 * 24 * 16,
                                               "wkv6_bwd": 24 * 16}}
# 11b's predicted peak (the fake trace's MemTracker) over the card's
# max_memory_allocated(), in the counted step and in the same step run
# without the counter, is held inside these bands: 0.8146 and 1.0622 in
# the first runs (PERF.md §6), give or take 5%.  The counter's dispatch
# mode makes the card's step hold 13.3 GiB more.
PEAK_RATIO = (0.77, 0.86)
PEAK_RATIO_UNCOUNTED = (1.01, 1.11)


def dryrun_cells(card: str, out: str) -> None:
    """11a: each cell by ``python -m repro_torch.launch.dryrun`` in a
    process of its own; every kernel of a cell's path counted as launches
    of its operator (WKV6 at 24 a decode step, so no plain loop ran), q8
    moments in nemotron's."""
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = []
    t0 = time.perf_counter()
    for arch, shape, multi in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", out] + (
            ["--multi-pod"] if multi else [])
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      env=env))
    logs = [p.communicate(timeout=600)[0] for p in procs]
    wall = time.perf_counter() - t0
    for (arch, shape, multi), p, log in zip(DRYRUN_CELLS, procs, logs):
        sys.stdout.write("".join(line + "\n" for line in log.splitlines()
                                 if line.startswith(("[", "  "))))
        if p.returncode:
            sys.stdout.write(log[-3000:])
            raise AssertionError(f"dry run of {arch} x {shape} failed "
                                 f"(exit {p.returncode})")
        tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
        with open(os.path.join(out, tag + ".json")) as f:
            res = json.load(f)
        r, h, m = res["roofline"], res["hlo"], res["memory"]
        print(f"[dryrun] 11a {tag}: traced in {res['compile_s']} s; peak "
              f"{m['peak_bytes_per_device'] / 2**30:.2f} GiB a device "
              f"(fits {m['fits_hbm']}); compute {r['compute_s']:.6f} s, "
              f"memory {r['memory_s']:.6f} s, collective "
              f"{r['collective_s']:.6f} s -> {r['dominant']}, roofline "
              f"{r['roofline_fraction']:.4f}, useful "
              f"{r['useful_flops_ratio']:.4f}; kernels "
              f"{json.dumps(h['kernel_launches'])}; counted from H100 "
              f"datasheet constants, not measured ({card})")
        if h["kernel_launches"] != DRYRUN_KERNELS[arch, shape]:
            raise AssertionError(f"{tag}: kernels counted "
                                 f"{h['kernel_launches']}, not "
                                 f"{DRYRUN_KERNELS[arch, shape]}")
        if arch == "nemotron_4_340b" and not res["meta"]["quantized_opt"]:
            raise AssertionError("nemotron's train cell ran without q8 "
                                 "moments")
    print(f"[dryrun] 11a {len(DRYRUN_CELLS)} cells at once: {wall:.2f} s")


def dryrun_against_step(card: str) -> dict:
    """11b: phase 8b's cell counted on fake tensors, then the same step on
    the card under the same counter: the flops equal, the peak predicted
    beside the one measured, the step's time beside the roofline."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.launch.dryrun import roofline_terms, trace
    from repro_torch.launch.hlostats import count_step
    from repro_torch.launch.mesh import (PEAK_BF16_FLOPS, init_world,
                                         make_mesh_for)
    from repro_torch.launch.specs import build_cell, make_optimizer
    from repro_torch.models import init_lm
    from repro_torch.models.config import ShapeCell
    from repro_torch.runtime.steps import TrainState
    from repro_torch.sharding.rules import (NamedSharding, batch_spec,
                                            logical_to_physical,
                                            param_sharding, place)

    cfg = dataclasses.replace(get_config("qwen3_32b"), n_layers=2)
    cell = ShapeCell("phase 8b", TRAIN_SEQ, TRAIN_BATCH, "train")
    plan = (TRAIN_ACCUM, TRAIN_BATCH // TRAIN_ACCUM)
    init_world("cuda")
    try:
        mesh = make_mesh_for(dist.get_world_size(), 2)
        t0 = time.perf_counter()
        low = build_cell(cfg, cell, mesh, plan=plan)
        fake, peak = trace(low)
        t_fake = time.perf_counter() - t0
        step = low.fn          # the cell's step, run on the card's tensors
        del low
        predicted = peak["Total"]
        opt = make_optimizer(cfg)
        model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
        logical_to_physical(mesh, model, param_sharding(model, mesh))
        state = TrainState(model, opt.init(model))
        bs = batch_spec(mesh)
        stream = SyntheticTokenStream(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                      accum=TRAIN_ACCUM)
        batch = {k: place(torch.from_numpy(v).cuda(),
                          NamedSharding(mesh, (None,) + bs[k]))
                 for k, v in stream.batch(0).items()}
        # the peak of the step itself, with the state in place (making and
        # placing the weights holds some of them twice for a moment)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with kernels_only_on_card():
            real, dt_counted = sync_time(lambda: count_step(step, state,
                                                            batch))
        launches = read_launches()
        measured = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = [sync_time(lambda: step(state, batch))[1] for _ in range(3)]
        uncounted = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()
    rel = abs(real.flops - fake.flops) / fake.flops
    ratio = predicted / measured
    step_s = float(np.median(times))
    r = roofline_terms(fake, None, 1, cfg, cell)
    share = r["model_flops_per_device"] / (step_s * PEAK_BF16_FLOPS)
    print(f"[dryrun] 11b qwen3_32b full width, 2 layers, seq {TRAIN_SEQ}, "
          f"batch {TRAIN_BATCH}, accum {TRAIN_ACCUM} on a (1, 1) mesh: "
          f"fake count {fake.flops:.6e} flops in {t_fake:.2f} s, the card's "
          f"step under the counter {real.flops:.6e} flops (relative "
          f"difference {rel:.3e}) in {dt_counted:.2f} s; kernels counted "
          f"{json.dumps(dict(real.kernel_launches))}, launched "
          f"{json.dumps(launches)} ({card})")
    print(f"[dryrun] 11b peak: predicted {predicted / 2**30:.3f} GiB, "
          f"measured {measured / 2**30:.3f} GiB (max_memory_allocated over "
          f"the counted step), ratio {ratio:.4f}; the three steps without "
          f"the counter {uncounted / 2**30:.3f} GiB, ratio "
          f"{predicted / uncounted:.4f} ({card})")
    print(f"[dryrun] 11b step {step_s:.4f} s (steps {json.dumps(times)}) "
          f"against the counted roofline: compute {r['compute_s']:.6f} s, "
          f"memory {r['memory_s']:.6f} s, collective {r['collective_s']:.6f}"
          f" s ({r['dominant']}); model flops {r['model_flops_per_device']:.4e}"
          f" = {share:.4f} of the step at the bf16 peak ({card})")
    if rel > 1e-6:
        raise AssertionError(f"the card's step counted {real.flops} flops, "
                             f"the fake one {fake.flops}")
    expect_launches(launches, {"rmsnorm": RMS_PER_STEP, "flash_attention": 0,
                               "wkv6": 0, "wkv6_bwd": 0})
    if dict(real.kernel_launches) != {"rmsnorm": RMS_PER_STEP} or dict(
            fake.kernel_launches) != {"rmsnorm": RMS_PER_STEP}:
        raise AssertionError(f"kernels counted {dict(real.kernel_launches)} "
                             f"on the card, {dict(fake.kernel_launches)} "
                             f"fake")
    for r, band in ((ratio, PEAK_RATIO),
                    (predicted / uncounted, PEAK_RATIO_UNCOUNTED)):
        if not band[0] <= r <= band[1]:
            raise AssertionError(f"predicted over measured peak {r:.4f} "
                                 f"outside {band}")
    del model, state, batch
    free_card()
    return launches


def phase_dryrun(card: str) -> dict:
    import tempfile
    import torch
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    if held >= 2**30:
        raise AssertionError("an earlier phase left over 1 GiB on the card")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        dryrun_cells(card, out)
        print(f"[dryrun] 11a {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches = dryrun_against_step(card)
    print(f"[dryrun] 11b {time.perf_counter() - t0:.2f} s")
    print(f"[dryrun] phase {time.perf_counter() - t_phase:.2f} s")
    return launches


def phase_dryrun_process() -> dict:
    """Phase 11 in a process of its own, as phases 8 to 10: returns 11b's
    launch counts, which the child prints on its last line."""
    cmd = [sys.executable, os.path.abspath(__file__), DRYRUN_ONLY]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr)
    lines = res.stdout.splitlines()
    if res.returncode != 0 or not lines or not lines[-1].startswith("{"):
        raise AssertionError(f"phase 11 failed (exit {res.returncode})")
    return json.loads(lines[-1])


# Phase 12, in a process of its own: the four published configurations no
# other phase serves, at full width with their depth cut, as (arch, layers
# kept, prompt length, weight type).  gemma3 keeps 12 of 48 layers (two
# 5:1 groups, so two global layers) with prompts of 2048, so its window of
# 1024 binds.  nemotron keeps 2 of 96 with bf16 weights (32.7 GB): its
# embedding and head alone are 9.44e9 parameters, and with f32 weights
# each lane makes a bf16 copy of the 18.9 GB head at every step; on an
# H100 80GB that ran out of memory at 2 layers (65.4 GB) and peaked at
# 66.8 and 75.0 GiB at 1 layer, three lanes' copies at once.
CONFIGS_ONLY = "--phase-12-process"
CONFIG_CELLS = [("gemma3_12b", 12, 2048, "float32"),
                ("starcoder2_15b", 8, 1024, "float32"),
                ("nemotron_4_340b", 2, 1024, "bfloat16"),
                ("dbrx_132b", 4, 1024, "float32")]


def serve_config(card: str, arch: str, layers: int, plen: int,
                 dtype: str) -> dict:
    """One configuration at full width cut to ``layers``, with ``dtype``
    weights: a direct call, the prefill logits with flash against the
    plain attention (``flash_against_plain``), then the 8 requests served
    and checked under both policies, and the launch counts the model
    implies.  Every kernel's plain version raises meanwhile.  Returns the
    parallel policy's launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    tag = arch.split("_")[0]
    batch, new, n_req = 2, 16, 8
    t_cell = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with kernels_only_on_card():
        t0 = time.perf_counter()
        model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=getattr(torch, dtype))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        print(f"[{tag}] {cfg.name} at full width (d {cfg.d_model}, H "
              f"{cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.hd}, {cfg.norm}, "
              f"{cfg.mlp}), {layers} layers: {n_params:,} {dtype} "
              f"parameters ({nbytes / 1e9:.2f} GB), init "
              f"{time.perf_counter() - t0:.2f} s")
        prompts = make_prompts(cfg, n_req, plen)
        toks = torch.from_numpy(np.stack(prompts[:batch])).cuda()
        direct, _ = direct_call(cfg, model, toks, new, use_flash=True)
        # an MoE model's logits after every layer, so that the depths its
        # bf16 routing leaves alike are held (flash_against_plain)
        depths = (tuple(range(1, layers + 1)) if cfg.moe is not None
                  else (layers,))
        flash_against_plain(tag, cfg, model, toks, depths)
        torch.cuda.synchronize()
        peaks = [torch.cuda.max_memory_allocated()]
        launches = serve_and_check(tag, cfg, model, prompts, batch, new,
                                   direct, card, profile=False)
        peaks.append(torch.cuda.max_memory_allocated())
        serial = serve_and_check(tag, cfg, model, prompts, batch, new,
                                 direct, card, profile=False,
                                 policy="serial")
        peaks.append(torch.cuda.max_memory_allocated())
    n_batches = n_req // batch
    # Per forward call (the prefill and each of new - 1 decode steps) with
    # RMSNorm: ln1 and ln2 in every layer, q-norm and k-norm where the
    # config has them, and the final norm; a LayerNorm config none.  One
    # flash call a layer in each prefill.
    norms = (2 + 2 * cfg.qk_norm) * layers + 1 if cfg.norm == "rmsnorm" \
        else 0
    want = {"flash_attention": layers * n_batches,
            "rmsnorm": norms * new * n_batches, "wkv6": 0, "wkv6_bwd": 0}
    expect_launches(launches, want)
    expect_launches(serial, want)
    print(f"[{tag}] peak device memory of the direct calls "
          f"{peaks[0] / 2**30:.3f} GiB, of the whole cell "
          f"{max(peaks) / 2**30:.3f} GiB ({card})")
    del model
    free_card(arch)
    print(f"[{tag}] cell {time.perf_counter() - t_cell:.2f} s")
    return launches


def phase_configs(card: str) -> dict:
    import torch
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    if held >= 2**30:
        raise AssertionError("an earlier phase left over 1 GiB on the card")
    out = {cell[0]: serve_config(card, *cell) for cell in CONFIG_CELLS}
    print(f"[configs] phase {time.perf_counter() - t_phase:.2f} s")
    return out


def phase_configs_process() -> dict:
    """Phase 12 in a process of its own, as phases 8 to 11: returns each
    configuration's launch counts, which the child prints on its last
    line."""
    cmd = [sys.executable, os.path.abspath(__file__), CONFIGS_ONLY]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr)
    lines = res.stdout.splitlines()
    if res.returncode != 0 or not lines or not lines[-1].startswith("{"):
        raise AssertionError(f"phase 12 failed (exit {res.returncode})")
    return json.loads(lines[-1])


# Phase 13, in a process of its own: the paper's core runtime (DAG
# inference from access modes, lanes and events, the memory manager) on
# CUDA-stream lanes at the sizes of phase 5's operands.  13a: the random
# programs of tests/_torch_core_programs.py, 6 float32 arrays of 16 Mi
# elements (64 MiB each) and 14 kernels, 32 seeds under both policies.
CORE_ONLY = "--phase-13-process"
CORE_SEEDS, CORE_N = 32, 1 << 24
# 13b: the slow kernel's length, the array another lane owns, and the most
# a host read of it may take beside the slow kernel.  The read copies the
# whole array to pageable memory (64 MiB took 26.6 ms beside an H100 80GB
# HBM3), so the array read is 4 MiB.
CORE_SLOW_MS, CORE_READ_N, CORE_READ_LIMIT_S = 200.0, 1 << 20, 0.020
# 13c: 8 chunks of 2**28 float32 (1 GiB each, a working set of 24 GiB)
# through a budget of 8 GiB, eagerly and then in 3 captured episodes; n is
# halved until the host holds three times the working set.
OOC_CHUNKS, OOC_N, OOC_BUDGET, OOC_EPISODES = 8, 1 << 28, 8 << 30, 3
# What the card may hold beyond the ledger at a quiescent point, and beyond
# the phase's baseline once every scheduler is closed.
CORE_SLACK = 64 << 20


def core_programs(card: str) -> None:
    """13a: each program three times on CUDA lanes: under the parallel
    policy issued with every element in flight (its lanes held until the
    last element is issued), so that its edges, lanes, events and stats
    are the simulator's and each lane has a CUDA stream of its own; then
    free-running under the parallel and the serial policy, timed.  All
    three compute the same bits, and the free parallel run's values, read
    back through the runtime, are numpy's within rtol 1e-6.  The arrays
    start uniform and every kernel is elementwise, so numpy's program on
    one element gives every element's value."""
    import numpy as np
    import torch
    import repro_torch.api as gr
    import _torch_core_programs as progs

    # Array i starts holding i + 1; no run writes a host buffer in place
    # (no budget, so no write-back), so the runs share these.
    init = [np.full(CORE_N, i + 1.0, np.float32) for i in range(6)]

    def run(prog, policy, held):
        """One run: its elements, stats, lane streams, wall and the
        arrays' values on the card (and, free parallel, on the host)."""
        s = gr.make_scheduler(policy, device="cuda")
        try:
            gate = progs.hold_lanes(s, policy if held else "serial")
            arrays = [s.array(v, name=f"a{i}") for i, v in enumerate(init)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            progs.drive(gr, s, prog, arrays, progs.KERNELS)
            struct = progs.structure(s)
            gate.set()
            s.sync()
            wall = time.perf_counter() - t0
            stats = {k: s.stats()[k] for k in progs.STAT_KEYS}
            streams = {st.cuda_stream for w in s.executor._lanes.values()
                       for st in w._streams.values()}
            on_card = [a.device if a.device is not None
                       else torch.from_numpy(a.host).cuda() for a in arrays]
            host = ([np.asarray(a) for a in arrays]
                    if policy == "parallel" and not held else None)
        finally:
            s.close()
        return struct, stats, streams, wall, on_card, host

    run(progs.random_program(0), "parallel", False)         # warm
    run(progs.random_program(0), "serial", False)
    walls = {"parallel": [], "serial": []}
    lanes, events = [], []
    for seed in range(CORE_SEEDS):
        prog = progs.random_program(seed)
        held = run(prog, "parallel", True)
        free = run(prog, "parallel", False)
        serial = run(prog, "serial", False)
        for tag, policy, r in (("held", "parallel", held),
                               ("serial", "serial", serial)):
            struct, stats, streams = r[:3]
            want = progs.simulated(gr, policy, prog, n=CORE_N)
            if (struct, stats) != want:
                raise AssertionError(
                    f"13a seed {seed} {tag}: edges, lanes or stats differ "
                    f"from the simulator's: {stats} against {want[1]}")
            # the serial policy runs every element on one worker and
            # creates no lane
            made = max(1, stats["lanes_created"])
            if len(streams) != made:
                raise AssertionError(f"13a seed {seed} {tag}: {len(streams)} "
                                     f"CUDA streams for {made} lanes")
        lanes.append(held[1]["lanes_created"])
        events.append(held[1]["events_created"])
        walls["parallel"].append(free[3])
        walls["serial"].append(serial[3])
        for i, (h, f, q) in enumerate(zip(held[4], free[4], serial[4])):
            if not (torch.equal(h, f) and torch.equal(f, q)):
                raise AssertionError(f"13a seed {seed}: array {i} differs "
                                     f"between the runs")
        want_values = progs.numpy_program(prog, n=1)
        for i, (g, w) in enumerate(zip(free[5], want_values)):
            gt, w0 = torch.from_numpy(g), float(w[0])
            if not bool(((gt - w0).abs() <= 1e-6 * abs(w0)).all()):
                raise AssertionError(f"13a seed {seed}: array {i} differs "
                                     f"from numpy's {w0}")
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"[core] 13a {CORE_SEEDS} programs of 6 x 64 MiB arrays and 14 "
          f"kernels: held, free parallel and serial runs bitwise equal, "
          f"numpy's values within rtol 1e-6; the held runs' and the serial "
          f"runs' edges, lanes, events and stats equal the simulator's; "
          f"lanes {lanes}, events {events}")
    print(f"[core] 13a walls, issue to sync (s): parallel "
          f"{json.dumps(walls['parallel'])}; serial "
          f"{json.dumps(walls['serial'])}; medians parallel "
          f"{med['parallel']:.5f}, serial {med['serial']:.5f}, serial over "
          f"parallel {med['serial'] / med['parallel']:.4f} ({card})")


def core_host_access(card: str) -> None:
    """13b: §IV-C on CUDA streams.  A lane runs a kernel of about 200 ms
    (``torch.cuda._sleep``) that writes A and reads C; a host read of B,
    which another lane owns, returns without waiting for it, and a host
    write to C waits for it."""
    import numpy as np
    import torch
    from repro_torch.core import function, make_scheduler
    probe = 50_000_000
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    cycles = int(probe * CORE_SLOW_MS / start.elapsed_time(end))

    def slow(a, c):
        torch.cuda._sleep(cycles)
        return a + 1.0

    s = make_scheduler("parallel", device="cuda")
    try:
        A = s.array(np.zeros(CORE_N, np.float32), name="A")
        B = s.array(np.zeros(CORE_READ_N, np.float32), name="B")
        C = s.array(np.ones(CORE_N, np.float32), name="C")
        function(lambda a, b, c: (a, b), modes=("inout", "inout", "const"),
                 name="upload").with_options(scheduler=s)(A, B, C)
        s.sync()                        # all three on the card
        slow_fn = function(slow, modes=("inout", "const"), name="slow")
        fast_fn = function(lambda b: b + 2.0, modes=("inout",), name="fast")
        k_slow = slow_fn.with_options(scheduler=s)(A, C)
        k_fast = fast_fn.with_options(scheduler=s)(B)
        if k_slow.stream == k_fast.stream:
            raise AssertionError("13b: the two kernels share a lane")
        t0 = time.perf_counter()
        b0 = float(B[0])
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        C[0] = 7.0
        t_write = time.perf_counter() - t0
        a0 = float(A[0])
        fast_fn.with_options(scheduler=s)(B)
        s.sync()
        t0 = time.perf_counter()
        float(B[0])
        t_idle = time.perf_counter() - t0
    finally:
        s.close()
    print(f"[core] 13b host read of B ({CORE_READ_N * 4 >> 20} MiB) beside a "
          f"{CORE_SLOW_MS:.0f} ms kernel on another lane: {t_read * 1e3:.3f} "
          f"ms (with nothing running: {t_idle * 1e3:.3f} ms); host write to "
          f"C (64 MiB), which that kernel reads: {t_write * 1e3:.3f} ms "
          f"({card})")
    if (b0, a0) != (2.0, 1.0):
        raise AssertionError(f"13b: read {b0} and {a0}, want 2.0 and 1.0")
    if t_read >= CORE_READ_LIMIT_S:
        raise AssertionError(f"13b: the host read took {t_read * 1e3:.1f} "
                             f"ms, waiting for another lane")
    if t_write < 0.5 * CORE_SLOW_MS / 1e3:
        raise AssertionError(f"13b: the host write took {t_write * 1e3:.1f} "
                             f"ms, not waiting for the kernel reading C")


def host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise AssertionError("no MemAvailable in /proc/meminfo")


def pinned_dma_gbs(nbytes: int) -> float:
    """One upload of ``nbytes`` from pinned memory, timed by CUDA events,
    as phase 5's ``upload_cost`` times its DMA: GB/s."""
    import torch
    x = torch.empty(nbytes // 4, dtype=torch.float32).pin_memory()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    x.to("cuda", non_blocking=True)
    torch.cuda.synchronize()
    start.record()
    y = x.to("cuda", non_blocking=True)
    end.record()
    end.synchronize()
    del x, y
    return nbytes / (start.elapsed_time(end) / 1e3) / 1e9


def core_outofcore(card: str, base: int) -> None:
    """13c: the out-of-core pipeline at a working set three times the
    budget, on the parallel policy with the plan optimizer, eagerly and
    then in captured episodes: right values through the spills, the
    ledger equal to the bytes installed and the card's allocation within
    the budget and one chunk at every quiescent point."""
    import concurrent.futures
    import numpy as np
    import torch
    from repro_torch.benchsuite.outofcore import (build_outofcore,
                                                  verify_outofcore,
                                                  working_set_bytes)
    from repro_torch.core import make_scheduler
    from repro_torch.core.timeline import _measure, _union
    n = OOC_N
    avail = host_available_bytes()
    while 3 * working_set_bytes(OOC_CHUNKS, n) > avail:
        n //= 2
    ws = working_set_bytes(OOC_CHUNKS, n)
    chunk = 4 * n
    print(f"[core] 13c host MemAvailable {avail / 2**30:.1f} GiB: chunks "
          f"of {n} float32 ({chunk / 2**30:.3f} GiB), working set "
          f"{ws / 2**30:.1f} GiB" + (f" (cut from n = {OOC_N})"
                                     if n != OOC_N else ""))
    t0 = time.perf_counter()
    # a generator a chunk, filled in threads (numpy fills without the GIL)
    with concurrent.futures.ThreadPoolExecutor(OOC_CHUNKS) as pool:
        data = list(pool.map(
            lambda ss: np.random.default_rng(ss).random(n, dtype=np.float32),
            np.random.SeedSequence(0).spawn(OOC_CHUNKS)))
    print(f"[core] 13c data made in {time.perf_counter() - t0:.2f} s")
    dma = pinned_dma_gbs(chunk)
    s = make_scheduler("parallel", device="cuda", memory_budget=OOC_BUDGET,
                       plan_optimize=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        prev = {"mem_spill_bytes": 0, "mem_reload_bytes": 0}
        for ep in range(1 + OOC_EPISODES):
            tag = "eager" if ep == 0 else f"episode {ep}"
            first_span = len(s.timeline.spans)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ctx = (s.capture("ooc") if ep else contextlib.nullcontext())
            with ctx:
                arrays = build_outofcore(s, chunks=OOC_CHUNKS, n=n,
                                         data=data)
            s.sync()
            wall = time.perf_counter() - t0
            gc.collect()
            held = torch.cuda.memory_allocated() - base
            phys = sum(s.memory.physical_resident_bytes().values())
            report = s.memory.verify(physical=True, raise_on_drift=False)
            if not report.ok:
                raise AssertionError(f"13c {tag}: {report}")
            peak = torch.cuda.max_memory_allocated() - base
            if (max(held, peak) > OOC_BUDGET + chunk
                    or abs(held - phys) > CORE_SLACK):
                raise AssertionError(
                    f"13c {tag}: {held} bytes allocated ({peak} at the "
                    f"peak), {phys} installed, budget {OOC_BUDGET}")
            h2d = [(sp.t0, sp.t1) for sp in s.timeline.spans[first_span:]
                   if sp.kind == "h2d"]
            st = s.stats()
            spill = st["mem_spill_bytes"] - prev["mem_spill_bytes"]
            reload = st["mem_reload_bytes"] - prev["mem_reload_bytes"]
            prev = st
            t1 = time.perf_counter()
            if not verify_outofcore(arrays):
                raise AssertionError(f"13c {tag}: wrong values")
            t_verify = time.perf_counter() - t1
            if spill <= 0 or reload <= 0:
                raise AssertionError(f"13c {tag}: spilled {spill} bytes, "
                                     f"reloaded {reload}")
            up = OOC_CHUNKS * chunk + reload
            busy = _measure(_union(h2d))
            print(f"[core] 13c {tag}: wall {wall:.4f} s, spilled "
                  f"{spill / 2**30:.3f} GiB, reloaded {reload / 2**30:.3f} "
                  f"GiB, effective H2D {up / wall / 1e9:.3f} GB/s over the "
                  f"wall ({up / busy / 1e9 if busy else 0.0:.3f} GB/s while "
                  f"an upload ran) against one pinned DMA of a chunk at "
                  f"{dma:.3f} GB/s; allocated {held / 2**30:.3f} GiB, "
                  f"installed {phys / 2**30:.3f} GiB, peak "
                  f"{peak / 2**30:.3f} GiB, reserved "
                  f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB; verify "
                  f"{t_verify:.2f} s ({card})")
            del arrays
            gc.collect()
        st = s.stats()
        print(f"[core] 13c stats: spills {st['mem_spills']}, reloads "
              f"{st['mem_reloads']}, evict blocks {st['mem_evict_blocks']}, "
              f"plan records {st['plan_records']}, replays "
              f"{st['plan_replays']}")
        if st["plan_replays"] < 1:
            raise AssertionError("13c: no captured episode replayed")
    finally:
        s.close()


def core_concurrency(card: str) -> None:
    """13d: the memory suite's concurrency cases on CUDA lanes at 64 MiB
    arrays: four submitter threads racing a syncing one, and a host write
    demoting a replay mid-episode."""
    import repro_torch.api as gr
    from repro_torch.core import make_scheduler
    import _torch_core_programs as progs
    chunk = 4 * CORE_N
    t0 = time.perf_counter()
    s = make_scheduler("parallel", num_devices=2, device="cuda",
                       memory_budget=256 * chunk)
    try:
        progs.concurrent_stress(gr, s, n=CORE_N)
        st = s.stats()
    finally:
        s.close()
    print(f"[core] 13d concurrent stress: 4 threads x 12 stages of 64 MiB "
          f"arrays against 6 racing syncs, right and conserved, lanes "
          f"{st['lanes_created']}, {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    s = make_scheduler("parallel", device="cuda", memory_budget=64 * chunk)
    try:
        progs.capture_demotion(gr, s, n=CORE_N)
        st = s.stats()
    finally:
        s.close()
    print(f"[core] 13d capture demotion: replays {st['plan_replays']}, "
          f"bits and residency in lockstep, "
          f"{time.perf_counter() - t0:.2f} s")


def core_closing(card: str, base: int) -> None:
    """13e: eight independent matmuls on the lanes (each lane's stream and
    thread get a cuBLAS workspace), then every scheduler of the phase
    closed: the card holds what it held when the phase began."""
    import numpy as np
    import torch
    from repro_torch.core import function, make_scheduler
    mm = function(lambda a, b, o: a @ b, modes=("const", "const", "out"),
                  name="mm", outputs=0)
    rng = np.random.default_rng(0)
    s = make_scheduler("parallel", device="cuda")
    try:
        xs = [s.array(rng.random((4096, 4096), dtype=np.float32))
              for _ in range(16)]
        ys = [mm.with_options(scheduler=s)(xs[i], xs[i + 1])
              for i in range(0, 16, 2)]
        s.sync()
        lanes = s.stats()["lanes_created"]
        open_bytes = torch.cuda.memory_allocated() - base
        arrays = sum(a.nbytes for a in xs + ys)
        y0 = np.asarray(ys[0]).copy()
    finally:
        s.close()
    want = xs[0].host.astype(np.float64) @ xs[1].host.astype(np.float64)
    err = float(np.abs(y0 - want).max() / np.abs(want).max())
    del xs, ys, s
    gc.collect()
    left = torch.cuda.memory_allocated() - base
    print(f"[core] 13e {lanes} lanes of matmuls: {open_bytes / 2**20:.1f} "
          f"MiB allocated before close ({arrays / 2**20:.1f} MiB of arrays),"
          f" {left / 2**20:.3f} MiB after close and collection; max err "
          f"{err:.3e} of the largest product")
    if err > 1e-5:
        raise AssertionError(f"13e: matmul off by {err}")
    if left > CORE_SLACK:
        raise AssertionError(f"13e: {left} bytes stay allocated after the "
                             f"phase's schedulers closed")


def phase_core(card: str) -> dict:
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    t_phase = time.perf_counter()
    gc.collect()
    base = torch.cuda.memory_allocated()
    parts = (("13a", lambda: core_programs(card)),
             ("13b", lambda: core_host_access(card)),
             ("13c", lambda: core_outofcore(card, base)),
             ("13d", lambda: core_concurrency(card)),
             ("13e", lambda: core_closing(card, base)))
    for tag, run in parts:
        # Retired elements hold their arrays in parent-child cycles until a
        # collection, and each lane's stream caches its own freed blocks:
        # an earlier part's memory counts against no later part, and cuBLAS
        # (which allocates outside the cache) finds the card free.
        free_card()
        t0 = time.perf_counter()
        run()
        print(f"[core] {tag} {time.perf_counter() - t0:.2f} s")
    gc.collect()
    left = torch.cuda.memory_allocated() - base
    if left > CORE_SLACK:
        raise AssertionError(f"phase 13 left {left} bytes allocated")
    print(f"[core] phase {time.perf_counter() - t_phase:.2f} s")
    return {"left_bytes": left}


def phase_core_process() -> dict:
    """Phase 13 in a process of its own, as phases 8 to 12."""
    cmd = [sys.executable, os.path.abspath(__file__), CORE_ONLY]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr)
    lines = res.stdout.splitlines()
    if res.returncode != 0 or not lines or not lines[-1].startswith("{"):
        raise AssertionError(f"phase 13 failed (exit {res.returncode})")
    return json.loads(lines[-1])


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
    if TRAIN_ONLY in sys.argv:          # phase 8's own process
        print(json.dumps(phase_train(card, profile)))
        return 0
    if FAMILIES_ONLY in sys.argv:       # phase 9's own process
        print(json.dumps(phase_families(card, profile)))
        return 0
    if MESH_ONLY in sys.argv:           # phase 10's own process
        print(json.dumps(phase_mesh(card)))
        return 0
    if DRYRUN_ONLY in sys.argv:         # phase 11's own process
        print(json.dumps(phase_dryrun(card)))
        return 0
    if CONFIGS_ONLY in sys.argv:        # phase 12's own process
        print(json.dumps(phase_configs(card)))
        return 0
    if CORE_ONLY in sys.argv:           # phase 13's own process
        print(json.dumps(phase_core(card)))
        return 0
    t0 = time.perf_counter()
    sass = phase_build()
    rows = [phase_flash(sass), phase_rmsnorm(), phase_wkv6(),
            phase_wkv6_bwd()]
    launches = phase_qwen3(card, profile)
    # The qwen3 engine's reference cycles hold its weights until collected.
    free_card("qwen3 serving")
    rwkv = phase_rwkv(card, profile)
    free_card("rwkv serving")
    # while this process holds least on the card: nemotron's cell needs
    # most of it
    configs = phase_configs_process()
    overheads = phase_benchsuite(card, profile)
    # Closed schedulers leave nothing: the lanes' cuBLAS workspaces (32 MiB
    # a lane thread and stream that ran a matmul) go with the last one.
    if free_card("benchsuite") > BENCH_LEFT:
        raise AssertionError("the benchsuite left over 0.25 GiB allocated")
    phase_analysis(card, overheads)
    free_card("analysis")
    moe = phase_moe(card, profile)
    free_card("moe serving")
    phase_daemon(card)
    free_card("daemon")
    train = phase_train_process(profile)
    families = phase_families_process(profile)
    mesh = phase_mesh_process()
    dry = phase_dryrun_process()
    phase_core_process()
    for row in rows:
        name = row["name"]
        # each kernel's main path: serving (qwen3's, rwkv6's for the WKV6
        # forward), rwkv6's training for the WKV6 backward
        main_path = {"wkv6": rwkv, "wkv6_bwd": train["rwkv6"]}.get(
            name, launches)
        row["launches"] = main_path[name]
        row["launches_moe"] = moe[name]
        row["launches_train"] = train["qwen3"][name]
        row["launches_train_rwkv6"] = train["rwkv6"][name]
        row["launches_hymba"] = families["hymba"][name]
        row["launches_internvl"] = families["internvl"][name]
        row["launches_mesh"] = mesh[name]
        row["launches_dryrun_step"] = dry[name]
        row["launches_configs"] = {arch: c[name]
                                   for arch, c in configs.items()}
        if name == "wkv6":
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
