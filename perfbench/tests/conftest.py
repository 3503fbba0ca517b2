"""Shared pieces of the benchmark's tests: the import paths, tiny cells
that run on the CPU, and the fixture that decides whether a card is
there."""
import copy
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
# hymba's configuration and reference wait for a cell that can hold them
# (PERF.md, Open questions); the reference tests hold them to the port
# beside the benchmark's own cells.
MODELS = dict(BENCH, configs=BENCH["configs"] + [
    {"name": "hymba_1_5b", "file": "perfbench/configs/hymba_1_5b.json"}],
    workloads=BENCH["workloads"] + [
    {"name": "hymba.score_long", "config": "hymba_1_5b",
     "traffic": "score_long", "chips": 1}])


def tiny_model(model: dict) -> dict:
    """The configuration at a width the CPU runs in a second: the port's
    ``ArchConfig.reduced`` sizes."""
    m = copy.deepcopy(model)
    groups = m["n_heads"] // m["n_kv_heads"]
    m.update(n_layers=2, d_model=64, n_heads=4, head_dim=16, d_ff=128,
             vocab=256, n_kv_heads=max(1, 4 // max(1, groups)))
    if m.get("sliding_window"):
        m["sliding_window"] = 16
    m["ssm"] = dict(m["ssm"], head_dim=16, state_dim=4)
    return m


def tiny_cell(name: str, lengths=(16, 32, 64), limit=None):
    """The cell ``name`` of BENCHMARK.json, or hymba's, at a tiny width
    and short prompts, its cycle and batch as the mix states them, 4
    requests of each length compared (a cycle holds 4 of the longest)."""
    from perfbench import harness
    cell = harness.resolve(name, MODELS)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"] = tiny_model(cell.config["model"])
    cell.config["check"]["limit"] = limit
    cell.mix = dict(cell.mix, lengths=list(lengths), check_per_length=4)
    return cell


def wide_cell(name: str, limit=None):
    """The cell ``name`` at its published width with two layers, a small
    feed-forward and vocabulary, and prompts of 64 to 256 tokens: small
    enough for the CPU, wide enough that a fault in a recurrence moves the
    served tokens as it does at full size (at the tiny width the
    embedding alone sets them); 4 requests of each length compared."""
    from perfbench import harness
    cell = harness.resolve(name, BENCH)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(n_layers=2, d_ff=128, vocab=512)
    cell.config["check"]["limit"] = limit
    cell.mix = dict(cell.mix, lengths=[64, 128, 256], check_per_length=4)
    return cell


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
