"""The dry run's cells as markdown tables, one a production mesh ((16, 16)
and (2, 16, 16)): a row an arch, a column a shape, from the JSON files
that ``python -m repro_torch.launch.dryrun --both-meshes --out DIR``
writes.

    python scripts/torch_dryrun_table.py build/dryrun

A cell reads "peak GiB a device (fits / OVER 80 GB), dominant term,
roofline fraction, useful flops ratio"; a skipped one "skip" and its
reason, shortened.  All of them are counted from H100 datasheet
constants, not measured.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ARCHS = ["seamless_m4t_medium", "gemma3_12b", "starcoder2_15b", "qwen3_32b",
         "nemotron_4_340b", "dbrx_132b", "qwen2_moe_a2_7b", "rwkv6_1_6b",
         "internvl2_76b", "hymba_1_5b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
SHORT = {"compute_s": "compute", "memory_s": "memory",
         "collective_s": "collective"}


def entry(path: Path) -> str:
    if not path.exists():
        return "missing"
    res = json.loads(path.read_text())
    if "skipped" in res:
        return "skip: full attention"
    if "error" in res:
        return "error"
    m, r = res["memory"], res["roofline"]
    return (f"{m['peak_bytes_per_device'] / 2**30:.1f} "
            f"{'fits' if m['fits_hbm'] else 'OVER'}, "
            f"{SHORT[r['dominant']]}, {r['roofline_fraction']:.3f}, "
            f"{r['useful_flops_ratio']:.3f}")


def main(argv=None) -> None:
    out = Path((argv or sys.argv[1:])[0])
    for mesh, name in (("single", "(16, 16)"), ("multi", "(2, 16, 16)")):
        print(f"{name}: peak GiB a device, dominant term, roofline "
              f"fraction, useful flops ratio\n")
        print("| arch | " + " | ".join(SHAPES) + " |")
        print("|---" * (len(SHAPES) + 1) + "|")
        for arch in ARCHS:
            cells = [entry(out / f"{arch}__{shape}__{mesh}.json")
                     for shape in SHAPES]
            print(f"| {arch} | " + " | ".join(cells) + " |")
        print()


if __name__ == "__main__":
    main()
