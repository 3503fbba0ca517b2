"""Run one cell of ``BENCHMARK.json`` once on the card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--log PATH]

The last line of standard output is the result: one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end standard error.  Without
enough CUDA devices, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits with a code other than 0.
``--log`` writes each batch's dispatch and completion times and the
card's clocks, power and temperature before and after the window."""
import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--log", type=Path)
    args = ap.parse_args(argv)

    from perfbench import harness
    cell = harness.resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    log = {} if args.log else None
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START, log=log)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell.chips, **result["device"]}
    result["checks"] = checks
    if "serve_mfu.score" in result["metrics"]:
        smi = harness.nvidia_smi()
        print(f"serve_mfu.score {result['metrics']['serve_mfu.score']['value']}"
              f" % of 989e12 on {smi.get('name')}, power limit "
              f"{smi.get('power.limit')}", file=sys.stderr)
    if log is not None:
        log["result"] = result
        log.pop("samples")
        args.log.parent.mkdir(parents=True, exist_ok=True)
        args.log.write_text(json.dumps(log, indent=1))
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    # The script's own folder would shadow installed modules by its files'
    # names; the repository's root and its sources stand there instead.
    sys.path[0:1] = [str(REPO), str(REPO / "src")]
    sys.exit(main())
