"""End-to-end training example on the PyTorch/CUDA port: train an LM through
the TaskGraphTrainer, the paper's scheduler overlapping data loading / H2D /
compute / metrics / checkpointing at step granularity.

Default is an ~8M-param qwen3-family config (d_model 256, 4 layers, vocab
8192); ``--full`` takes the published config, which at 32.8B parameters
does not fit one 80 GB card (``python -m repro_torch.launch.train`` cuts
a config's depth instead).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 30
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --seq 32 --batch 2

On the card every RMSNorm runs the RMSNorm kernel (backward through its
autograd function).  Without a CUDA device and without ``--device cpu`` it
raises.
"""
import argparse
import dataclasses
import time

from repro_torch.configs import get_config
from repro_torch.optim import AdamW
from repro_torch.runtime import TaskGraphTrainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_32b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config (pod-scale!)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--d-model", type=int, default=256,
                    help="width of the reduced config (~8M params at 256)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and lanes live: cuda or cpu")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """The config and the trainer the example runs: returns (cfg,
    trainer).  Prints the config's line."""
    cfg = get_config(args.arch, reduced=not args.full)
    if not args.full:
        cfg = dataclasses.replace(cfg, d_model=args.d_model,
                                  n_heads=8, n_kv_heads=4, head_dim=32,
                                  d_ff=args.d_model * 4, n_layers=4,
                                  vocab=8192)
    n_params = cfg.param_count()
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M seq={args.seq} "
          f"batch={args.batch} accum={args.accum}")

    trainer = TaskGraphTrainer(
        cfg, seq_len=args.seq, global_batch=args.batch, accum=args.accum,
        optimizer=AdamW(lr=3e-4, warmup=20, total_steps=max(100, args.steps)),
        ckpt_dir=args.ckpt, ckpt_every=20, device=args.device)
    return cfg, trainer


def main(argv=None):
    """Trains ``--steps`` steps; returns the trainer's report."""
    args = parse_args(argv)
    _, trainer = build(args)
    try:
        t0 = time.time()
        report = trainer.run(args.steps, metrics_every=5)
        dt = time.time() - t0
        toks = args.steps * args.batch * args.seq
        print(f"steps={report.steps_run} wall={dt:.1f}s "
              f"tokens/s={toks/dt:.0f} stragglers={report.stragglers}")
        print("losses:", [round(loss, 3) for loss in report.losses])
        print("scheduler:", trainer.sched.stats())
    finally:
        trainer.sched.shutdown()
    return report


if __name__ == "__main__":
    main()
