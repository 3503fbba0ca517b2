"""Multi-pod dry run: the port of ``repro.launch.dryrun``.

    python -m repro_torch.launch.dryrun --arch qwen3_32b --shape train_4k
    python -m repro_torch.launch.dryrun --both-meshes --jobs 8    # 80 cells
    python -m repro_torch.launch.dryrun --device cpu --reduced \\
        --arch gemma3_12b --shape train_4k

For each (arch x shape x production mesh) cell, ``run_cell`` builds the
cell (``launch.specs.build_cell``) on fake tensors in a fake world of 256 or
512 ranks (the ``fake`` process group over a ``FakeStore``: nothing is
allocated and no collective moves a byte), runs the port's own step once
under ``launch.hlostats.count_step`` and a ``MemTracker``, and reports the
peak bytes a device holds and whether they fit ``HBM_BYTES``, flops,
memory bytes and collective bytes a device, and a three-term roofline
against the H100's constants (``launch.mesh``).  All of it is counted from
datasheet constants, not measured.

``--device cuda`` (the default) makes the fake tensors CUDA tensors, so
each kernel wrapper takes its kernel's path (its operator's fake, counted
as one launch) and a prefill takes flash attention (every config's head
dim, up to 256), as the card's serving engine does; ``--device cpu`` takes
the plain versions, as the tests do.  ``--reduced`` runs the CPU
smoke-test configs.

Depth and accumulation are the reference's trip counts.  Full depth and all
microbatches on fake ``DTensor``s would dispatch millions of operations a
cell, so the step runs at one and two layer groups (the reference's scan
groups; an encoder-decoder's encoder cut in the same ratio) and, for a train
cell, with one and two microbatches; every count is bilinear in (groups,
microbatches) and is extrapolated exactly to the full depth and
accumulation (``extrapolate``).  A cell of at most two groups and two
microbatches runs as it is.  The peak memory is not linear in depth: what
a layer allocates and frees again peaks once whatever the depth, and the
order in which Python frees a layer's temporaries moves the traced peaks
by hundreds of MiB from one depth to the next.  So the peak is the highest
traced one plus, for each untraced group, what a group holds through the
whole step (``held_bytes``: its parameters, moments, caches, gradient
accumulators and remat's saved block inputs), the difference of that
count between the traces at two groups and at one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, cells, get_config
from ..models.config import SHAPES
from ..models.transformer import layer_kinds
from .hlostats import HLOStats, count_step, dtensor_bookkeeping, \
    in_bookkeeping
from .mesh import (HBM_BW, HBM_BYTES, INTERNODE_BW, NVLINK_BW,
                   PEAK_BF16_FLOPS, make_production_mesh, mesh_axes)
from .specs import build_cell, make_optimizer, plan_accum


def roofline_terms(stats: HLOStats, mem, chips: int, cfg, cell) -> dict:
    """Three-term roofline (§Roofline).  The counts are per device (each
    rank's local work).  The collective term divides each group's wire
    bytes by the slowest link it spans: NVLink within one domain, the
    inter-node fabric across domains."""
    compute_s = stats.flops / PEAK_BF16_FLOPS
    memory_s = stats.memory_bytes / HBM_BW
    collective_s = ((stats.wire_bytes - stats.wire_bytes_internode)
                    / NVLINK_BW + stats.wire_bytes_internode / INTERNODE_BW)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    # MODEL_FLOPS: 6*N*D for training, 2*N*D forward-only (per device)
    n_params = cfg.param_count(active_only=True)
    tokens = cell.seq_len * cell.global_batch if cell.kind != "decode" \
        else cell.global_batch
    factor = 6.0 if cell.kind == "train" else 2.0
    model_flops = factor * n_params * tokens / chips
    return {
        **terms,
        "dominant": dominant,
        "model_flops_per_device": model_flops,
        "hlo_flops_per_device": stats.flops,
        "useful_flops_ratio": model_flops / stats.flops if stats.flops else 0,
        "step_time_bound_s": max(terms.values()),
        "roofline_fraction": (compute_s / max(terms.values())
                              if max(terms.values()) > 0 else 0.0),
    }


# ----------------------------------------------------------------------
# depth and accumulation
# ----------------------------------------------------------------------
def cut_depth(cfg, groups: int):
    """``cfg`` cut to ``groups`` layer groups (an encoder cut in the same
    ratio)."""
    g = len(layer_kinds(cfg))
    full = cfg.n_layers // g
    enc, rem = divmod(cfg.n_encoder_layers * groups, full)
    if rem:
        raise ValueError(f"{cfg.name}: {cfg.n_encoder_layers} encoder layers "
                         f"do not cut evenly to {groups} of {full} groups")
    return dataclasses.replace(cfg, n_layers=groups * g,
                               n_encoder_layers=enc)


def _combine(terms) -> HLOStats:
    """sum(c * stats) over (c, stats) pairs."""
    out = HLOStats()
    for c, st in terms:
        out.flops += c * st.flops
        out.memory_bytes += c * st.memory_bytes
        out.wire_bytes += c * st.wire_bytes
        out.wire_bytes_internode += c * st.wire_bytes_internode
        for field in ("collective_bytes", "collective_counts",
                      "kernel_launches"):
            mine = getattr(out, field)
            for k, v in getattr(st, field).items():
                mine[k] += c * v
    for field in ("collective_counts", "kernel_launches"):
        mine = getattr(out, field)
        for k in list(mine):
            mine[k] = int(round(mine[k]))
    return out


def extrapolate(points: dict, groups: int, accum: int) -> HLOStats:
    """The count at ``groups`` layer groups and ``accum`` microbatches from
    counts at (1 or 2 groups) x (1 or 2 microbatches), each a bilinear
    function of the two.  ``points`` maps (g, a) to ``HLOStats``; a
    missing second point on an axis means that axis is already full."""
    two_g, two_a = (2, 1) in points, (1, 2) in points
    dg, da = groups - 1, accum - 1
    s11 = points[(1, 1)]
    terms = [(1.0, s11)]
    if two_g:
        terms += [(dg, points[(2, 1)]), (-dg, s11)]
    if two_a:
        terms += [(da, points[(1, 2)]), (-da, s11)]
    if two_g and two_a:
        terms += [(dg * da, points[(2, 2)]), (-dg * da, points[(2, 1)]),
                  (-dg * da, points[(1, 2)]), (dg * da, s11)]
    return _combine(terms)


# ----------------------------------------------------------------------
# memory
# ----------------------------------------------------------------------
def _mem_tracker():
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        """``MemTracker`` that leaves out ``DTensor``'s sharding
        propagation (under a ``FakeTensorMode`` it runs in the same fake
        mode as the step, on global shapes, and would count them) and keeps
        no per-module statistics (a module runs once a microbatch and
        again in remat's recompute)."""

        def _pre_fw_hook(self, module, inputs):
            pass

        def _post_fw_hook(self, module, inputs, outputs):
            pass

        def _pre_bw_hook(self, module, args):
            pass

        def _post_bw_hook(self, module, args):
            pass

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if in_bookkeeping():
                from torch.distributed.tensor import DTensor
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)
    return Tracker()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, torch.nn.Module):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in _tensors(getattr(x, f.name))]
    return []


def held_bytes(lowering) -> int:
    """Bytes a device holds through the cell's step: its arguments'
    local shards (parameters, moments, caches, the batch) and, for a train
    step, the float32 gradient accumulators (the parameters' size and
    layout) and, under remat, each block's saved input (a microbatch's
    local residual stream, bf16, its sequence split where it is
    sequence-sharded)."""
    seen, n = set(), 0
    for t in _tensors(lowering.arg_specs):
        for p in (t.parameters() if isinstance(t, torch.nn.Module)
                  else [t]):
            local = getattr(p, "_local_tensor", p)
            if id(local) not in seen:
                seen.add(id(local))
                n += local.numel() * local.element_size()
    meta = lowering.meta
    if "accum" not in meta:          # an inference cell
        return n
    model, batch = lowering.arg_specs[0].params, lowering.arg_specs[1]
    n += sum(getattr(p, "_local_tensor", p).numel() * 4
             for p in model.parameters())
    if not meta["remat"]:
        return n
    tokens = getattr(batch["tokens"], "_local_tensor", batch["tokens"])
    blocks = len(model.blocks) + len(model.encoder)
    return n + (blocks * tokens[0].numel() * model.cfg.d_model * 2
                // meta["seq_split"])


def _peak(snapshot) -> dict:
    """The peak's bytes by category on the device that peaked highest."""
    best = max(snapshot.values(), key=lambda s: s["Total"])
    return {str(getattr(k, "value", k)): int(v) for k, v in best.items()}


def trace(lowering, memory: bool = True) -> tuple:
    """(HLOStats, peak bytes by category or None) of one run of the cell's
    step; ``memory=False`` leaves out the ``MemTracker``, which about
    doubles a trace's time."""
    if not memory:
        with lowering.fake_mode:
            return count_step(lowering.fn, *lowering.arg_specs), None
    mt = _mem_tracker()
    with lowering.fake_mode:
        mt.track_external(*_tensors(lowering.arg_specs))
        with dtensor_bookkeeping(), mt:
            stats = count_step(lowering.fn, *lowering.arg_specs)
    return stats, _peak(mt.get_tracker_snapshot("peak"))


# ----------------------------------------------------------------------
def _fake_world(size: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def count_cell(cfg, cell, mesh, *, use_flash: bool = False, seq_shard=None,
               remat: bool = True, device: str = "cuda", plan=None) -> dict:
    """The counts of one cell on ``mesh``, from its step at one and two
    layer groups and microbatches, extrapolated to its full depth and
    accumulation: ``stats`` (``HLOStats``), ``peak_bytes`` and
    ``categories`` (a device's peak and its ``MemTracker`` categories),
    ``once`` (the one-group, one-microbatch count), ``seconds`` (tracing)
    and ``meta``.  ``plan`` ((accum, micro)) replaces ``plan_accum``'s."""
    groups = cfg.n_layers // len(layer_kinds(cfg))
    accum, micro = (plan or plan_accum(cell, mesh) if cell.kind == "train"
                    else (1, cell.global_batch))
    optimizer = make_optimizer(cfg)
    points, peaks, state = {}, {}, {}
    a_peak = min(2, accum)     # the peak: accumulators and activations
    t0 = time.time()
    for g in sorted({1, min(2, groups)}):
        for a in sorted({1, a_peak}):
            sub = cfg if g == groups else cut_depth(cfg, g)
            lowering = build_cell(
                sub, dataclasses.replace(cell, global_batch=micro * a)
                if cell.kind == "train" else cell, mesh,
                use_flash=use_flash, remat=remat, seq_shard=seq_shard,
                device=device, optimizer=optimizer, plan=(a, micro))
            points[(g, a)], peak = trace(lowering, memory=a == a_peak)
            if peak is not None:
                peaks[(g, a)] = peak
                state[g] = held_bytes(lowering)
            del lowering
    seconds = time.time() - t0
    # the peak: the highest traced one, and for each untraced group what
    # a group holds through the step (see the module's docstring)
    top = max(peaks, key=lambda p: peaks[p]["Total"])
    per_group = state[max(state)] - state[1] if len(state) > 1 else 0
    categories = dict(peaks[top])
    categories["untraced groups"] = max(groups - top[0], 0) * per_group
    peak_bytes = categories.pop("Total") + categories["untraced groups"]
    return {"stats": extrapolate(points, groups, accum),
            "peak_bytes": peak_bytes,
            "categories": categories, "once": points[(1, 1)],
            "seconds": seconds,
            "meta": {"accum": accum, "micro": micro,
                     "quantized_opt": optimizer.quantized, "groups": groups,
                     "traced": sorted(f"{g}x{a}" for g, a in points)}}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             use_flash=None, seq_shard=None, remat: bool = True,
             verbose: bool = True, device: str = "cuda",
             reduced: bool = False) -> dict:
    """One cell's JSON (the reference's keys).  ``use_flash`` defaults to
    the card's serving path (``ServingEngine``'s): flash attention in a
    prefill on ``cuda`` wherever the wrapper takes the head dim (up to
    256: every config, nemotron's 192 included, and a reduced config's 16,
    padded), the plain attention on the CPU; training never takes it (the
    kernel has no backward)."""
    cfg = get_config(arch, reduced=reduced)
    cell = SHAPES[shape_name]
    if use_flash is None:
        use_flash = device == "cuda" and cell.kind == "prefill"
    for c, skip in cells(arch):
        if c.name == shape_name and skip:
            return {"arch": arch, "shape": shape_name, "skipped": skip}

    _fake_world(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        chips = mesh.size()
        c = count_cell(cfg, cell, mesh, use_flash=use_flash,
                       seq_shard=seq_shard, remat=remat, device=device)
    finally:
        dist.destroy_process_group()
    stats, categories, t_trace = c["stats"], c["categories"], c["seconds"]
    peak_bytes = c["peak_bytes"]
    s11 = c["once"]
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": mesh_axes(mesh), "chips": chips,
        "compile_s": round(t_trace, 1),
        "memory": {"categories": categories,
                   "peak_bytes_per_device": peak_bytes,
                   "fits_hbm": bool(peak_bytes <= HBM_BYTES),
                   "hbm_fraction": peak_bytes / HBM_BYTES},
        "xla_cost_analysis": {"flops_once": s11.flops,
                              "bytes_once": s11.memory_bytes},
        "hlo": stats.as_dict(),
        "roofline": roofline_terms(stats, None, chips, cfg, cell),
        "meta": {**c["meta"], "device": device, "reduced": reduced,
                 "use_flash": use_flash},
    }
    if verbose:
        m, r = result["memory"], result["roofline"]
        print(f"[{arch} x {shape_name} x "
              f"{'2x16x16' if multi_pod else '16x16'}] trace {t_trace:.0f}s"
              f" | mem/device {m['peak_bytes_per_device'] / 2**30:.2f} GiB "
              f"({'fits' if m['fits_hbm'] else 'OVER'}) | "
              f"compute {r['compute_s'] * 1e3:.2f} ms, "
              f"memory {r['memory_s'] * 1e3:.2f} ms, "
              f"collective {r['collective_s'] * 1e3:.2f} ms -> "
              f"{r['dominant']} bound, roofline "
              f"{r['roofline_fraction']:.2f}, useful "
              f"{r['useful_flops_ratio']:.2f}")
        print(f"  memory at the peak: "
              f"{ {c: f'{b / 2**30:.2f} GiB' for c, b in categories.items()} }")
        print(f"  collectives: "
              f"{ {c: f'{b / 2**30:.2f} GiB' for c, b in stats.collective_bytes.items()} }"
              f" counts {dict(stats.collective_counts)}; kernels "
              f"{dict(stats.kernel_launches)}")
    return result


def _tag(arch, shape, mp) -> str:
    return f"{arch}__{shape}__{'multi' if mp else 'single'}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape cell (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--use-flash", action="store_true", default=None,
                    help="flash attention in prefill cells (the default on "
                         "cuda, as the card's serving engine)")
    ap.add_argument("--seq-shard", action="store_true", default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the fake tensors (cuda: the kernels' "
                         "path)")
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU smoke-test configs")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells at once, each in a process of its own")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: --device cuda but no CUDA device is "
                         "available (fake CUDA tensors need a CUDA build of "
                         "torch); pass --device cpu for the plain versions")

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    todo = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    if args.jobs > 1:
        failures = _run_parallel(todo, args)
    else:
        failures = []
        for arch, shape, mp in todo:
            tag = _tag(arch, shape, mp)
            try:
                res = run_cell(arch, shape, multi_pod=mp,
                               use_flash=args.use_flash,
                               seq_shard=args.seq_shard,
                               remat=not args.no_remat, device=args.device,
                               reduced=args.reduced)
            except Exception as e:
                traceback.print_exc()
                failures.append(tag)
                res = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "error": repr(e)}
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
            sys.stdout.flush()
    if failures:
        print("FAILURES:", failures, file=sys.stderr)
        sys.exit(1)
    print("dry-run complete")


def _run_parallel(todo, args) -> list:
    """Each cell in a ``python -m repro_torch.launch.dryrun`` process of its
    own (its own fake world), ``--jobs`` at a time."""
    flags = ["--out", args.out, "--device", args.device] + [
        f for f, on in (("--use-flash", args.use_flash),
                        ("--seq-shard", args.seq_shard),
                        ("--no-remat", args.no_remat),
                        ("--reduced", args.reduced)) if on]
    pending, running, failures = list(todo), [], []
    while pending or running:
        while pending and len(running) < args.jobs:
            arch, shape, mp = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape] + flags + (
                ["--multi-pod"] if mp else [])
            running.append((_tag(arch, shape, mp), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for tag, p in list(running):
            if p.poll() is None:
                continue
            running.remove((tag, p))
            sys.stdout.write(p.stdout.read())
            sys.stdout.flush()
            p.stdout.close()
            if p.returncode:
                failures.append(tag)
        time.sleep(0.5)
    return failures


if __name__ == "__main__":
    main()
