"""Training launcher: the port of ``repro.launch.train``.

Builds the device mesh (every rank of the world as (data, model) with
``--model-parallel``, or the production 16x16 / 2x16x16 meshes), shards the
train state per ``sharding.rules`` (``DTensor`` parameters, moments that
mirror them, the batch over the data axes), and drives the step loop under
``sharding_rules(mesh)`` with fault-tolerant checkpointing and exact
resume.  It prints ``step N: loss=... gnorm=... lr=...`` lines formatted as
the reference prints them, so that an interrupted and resumed run can be
held digit for digit against an uninterrupted one.

Without a process group the launcher makes a world of one rank (NCCL on
the card, gloo on the CPU; a (1, 1) mesh), and a world of one rank steps
on plain tensors: the same numbers, without ``DTensor``'s host cost on
every operation.  Under ``torchrun --nproc-per-node N`` it uses
torchrun's world, one card per rank; every rank takes part in a
checkpoint's gathers and rank 0 alone writes it under ``--ckpt``, which
every rank reads back on resume.  Runs on the card unless ``--device
cpu``; on the CPU use ``--reduced``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_32b \\
        --reduced --steps 20 --ckpt /tmp/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenStream
from repro_torch.launch.mesh import (init_world, make_mesh_for,
                                     make_production_mesh, mesh_axes)
from repro_torch.models import init_lm
from repro_torch.optim import AdamW
from repro_torch.runtime.steps import TrainState, make_train_step
from repro_torch.sharding.context import sharding_rules
from repro_torch.sharding.rules import (NamedSharding, batch_spec,
                                        logical_to_physical, param_sharding,
                                        place)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_32b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 (or 2x16x16 with --multi-pod) mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: --device cuda but no CUDA device is "
                         "available; pass --device cpu")
    made = init_world(device)
    try:
        _train(args, device)
    finally:
        if made:
            dist.destroy_process_group()


def _train(args, device) -> None:
    def say(*a) -> None:            # one copy of each line, from rank 0
        if dist.get_rank() == 0:
            print(*a)

    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.production_mesh:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
    else:
        mesh = make_mesh_for(dist.get_world_size(), args.model_parallel)
    say(f"device: {device.type} | mesh: {mesh_axes(mesh)} | "
          f"params(full-cfg) {cfg.param_count()/1e6:.1f}M")
    sharded = mesh.size() > 1        # one rank: plain tensors

    optimizer = AdamW(lr=3e-4, warmup=20, total_steps=max(100, args.steps))
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                     device=device)
    if sharded:
        logical_to_physical(mesh, params, param_sharding(params, mesh))
    state = TrainState(params, optimizer.init(params))
    stream = SyntheticTokenStream(cfg, args.seq, args.global_batch,
                                  accum=args.accum)
    bspec = batch_spec(mesh)
    b_sh = {k: NamedSharding(mesh, (None,) + bspec.get(k, (None, None)))
            for k in stream.batch(0)}
    train_step = make_train_step(cfg, optimizer)

    def step_fn(st, batch):
        with sharding_rules(mesh) if sharded else contextlib.nullcontext():
            return train_step(st, batch)

    ckpt = (CheckpointManager(args.ckpt, writer=dist.get_rank() == 0)
            if args.ckpt else None)
    start = 0
    if ckpt:
        # (step, state) resolved atomically: resuming the loop from a
        # different step than the restored state breaks exact resume.
        ck_step, ck_state, extra = ckpt.restore_latest(like=state)
        if ck_step is not None:
            saved_seed = extra.get("stream_seed")
            if saved_seed is not None and saved_seed != stream.seed:
                raise ValueError(
                    f"checkpoint was trained with stream seed "
                    f"{saved_seed}, this run has {stream.seed}: "
                    f"resume would not be exact")
            start, state = ck_step, ck_state
            say(f"resumed from step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in stream.batch(step).items()}
        if sharded:
            batch = {k: place(v, b_sh[k]) for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        if (step + 1) % 5 == 0 or step == args.steps - 1:
            say(f"step {step+1}: loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e}")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state, extra={"stream_seed": stream.seed})
    if ckpt:
        ckpt.wait()
        dist.barrier()               # rank 0's last checkpoint is on disk
    dt = time.time() - t0
    toks = (args.steps - start) * args.global_batch * args.seq
    say(f"done: {dt:.1f}s, {toks/dt:.0f} tok/s")


if __name__ == "__main__":
    main()
