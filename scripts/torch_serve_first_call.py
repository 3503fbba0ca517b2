"""Times the serving launcher's body, ``repro_torch.launch.serve.generate``,
three times in one process on the card: the first call pays every one-time
cost that falls inside the launcher's timed region (prefill to the last
token), the later ones show the steady state.  Prints one JSON line.

    PYTHONPATH=src python scripts/torch_serve_first_call.py \\
        --arch seamless_m4t_medium [--src path/to/other/checkout/src]

``--src`` times another checkout's package (a parent commit's, say) with
the same settings: batch 2, prompt 1024, 16 new tokens, as chip_smoke.py's
phase 9b runs the launcher.  Needs a card.
"""
import argparse
import json
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="seamless_m4t_medium")
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_first_call: needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    cfg = get_config(args.arch)
    seconds = []
    for _ in range(args.calls):
        out = generate(cfg, batch=2, prompt_len=1024, new_tokens=16,
                       device="cuda")
        seconds.append(out["seconds"])
        del out
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"src": args.src, "arch": args.arch,
                      "generate_seconds": seconds,
                      "distributed_tensor_imported":
                          "torch.distributed.tensor" in sys.modules,
                      "card": card}))


if __name__ == "__main__":
    main()
