"""The readings that a cell's limit is set from, in one process on the
card: for each seed, a run of the cell as ``run.py`` makes it (the gap of
every served token it compares), and for the control seeds the control,
the plain reference computed with float8 products in the program's place,
read by the same number at the same positions of the same requests.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 --control-seeds 1,2,3 [--per-length N] --out PATH

Samples come in the order they were drawn, grouped by length, so the first
``k`` of each length are the draw of a run that compares ``k``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--per-length", type=int,
                    help="requests compared a length (default: the mix's)")
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)

    import torch
    from perfbench import check, harness, weights
    from perfbench.reference.common import fp8_mm
    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    if args.per_length:
        cell.mix = dict(cell.mix, check_per_length=args.per_length)
    dev = torch.device("cuda")
    ref = harness.reference(cell.config["reference"])
    model = cell.config["model"]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        log = {}
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, log=log)
        row = {"seed": seed,
               "lengths": [len(x.tokens) for x in log["samples"]],
               "gaps": log["gaps"],
               "widest": max(log["gaps"]), "failed": res["failed"],
               "tokens_per_s": res["metrics"]["tokens_per_s"]["value"],
               "setup_s": log["setup_s"], "reference_s": log["reference_s"],
               "setup_phases": log["setup_phases"],
               "run_s": time.perf_counter() - t0}
        if seed in control:
            t1 = time.perf_counter()
            w = weights.make(ref.param_specs(model), seed, dev)
            row["control_gaps"] = [float(g) for g in check.served_gaps(
                ref, model, w, log["samples"], dev, control=fp8_mm)]
            row["control_widest"] = max(row["control_gaps"])
            del w
            torch.cuda.empty_cache()
            row["control_s"] = time.perf_counter() - t1
        print(json.dumps(row), flush=True)
        rows.append(row)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"workload": args.workload,
                                    "device": torch.cuda.get_device_name(0),
                                    "smi": harness.nvidia_smi(),
                                    "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.path[0:1] = [str(REPO), str(REPO / "src")]
    sys.exit(main())
