"""Training launcher: the port of ``repro.launch.train`` on one device.

Drives the step loop with fault-tolerant checkpointing and exact resume,
and prints ``step N: loss=... gnorm=... lr=...`` lines formatted as the
reference prints them, so that an interrupted and resumed run can be held
digit for digit against an uninterrupted one.  The reference's mesh flags
(``--production-mesh``, ``--multi-pod``, ``--model-parallel``) belong to the
multi-device slice.  Runs on the card unless ``--device cpu``; on the CPU
use ``--reduced``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_32b \\
        --reduced --steps 20 --ckpt /tmp/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenStream
from repro_torch.models import init_lm
from repro_torch.optim import AdamW
from repro_torch.runtime.steps import TrainState, make_train_step


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
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: --device cuda but no CUDA device is "
                         "available; pass --device cpu")
    cfg = get_config(args.arch, reduced=args.reduced)
    print(f"device: {device} | params(full-cfg) "
          f"{cfg.param_count()/1e6:.1f}M")

    optimizer = AdamW(lr=3e-4, warmup=20, total_steps=max(100, args.steps))
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                     device=device)
    state = TrainState(params, optimizer.init(params))
    stream = SyntheticTokenStream(cfg, args.seq, args.global_batch,
                                  accum=args.accum)
    step_fn = make_train_step(cfg, optimizer)

    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
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
            print(f"resumed from step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in stream.batch(step).items()}
        state, metrics = step_fn(state, batch)
        if (step + 1) % 5 == 0 or step == args.steps - 1:
            print(f"step {step+1}: loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e}")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state, extra={"stream_seed": stream.seed})
    if ckpt:
        ckpt.wait()
    dt = time.time() - t0
    toks = (args.steps - start) * args.global_batch * args.seq
    print(f"done: {dt:.1f}s, {toks/dt:.0f} tok/s")


if __name__ == "__main__":
    main()
