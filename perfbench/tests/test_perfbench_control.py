"""The control, the plain reference computed with float8 products in the
program's place, comes out not correct: read by the cell's own number at
the served positions, at the test width on the CPU against the faults
test's limit, and on the card at the cell's own size against the cell's
limit."""
import numpy as np
import pytest
import torch

from conftest import BENCH, wide_cell
from perfbench import check, generator, harness, weights
from perfbench.reference.common import fp8_mm
from test_perfbench_faults import LIMIT

CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name, seed):
    torch.set_num_threads(4)
    cell = wide_cell(name, LIMIT)
    # Every served token of the cycle (28): at this width the 12 a run
    # compares do not always separate the control from sound runs.
    cell.mix = dict(cell.mix, check_per_length=16)
    log = {}
    res = harness.run_cell(cell, seed, 0.0, False, device="cpu", log=log)
    ref = harness.reference(cell.config["reference"])
    m = cell.config["model"]
    w = weights.make(ref.param_specs(m), seed, "cpu")
    widest = check.served_gaps(ref, m, w, log["samples"], "cpu",
                               control=fp8_mm).max()
    assert widest > LIMIT
    assert widest > 3 * res["checks"]["logit_gap"]["value"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6, 7])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cells_limit_on_the_card(name, seed, card):
    """As many prompts of each length as a run compares, at the cell's
    size, read at their last positions."""
    cell = harness.resolve(name, BENCH)
    m, mix = cell.config["model"], cell.mix
    ref = harness.reference(cell.config["reference"])
    per, batch = int(mix["check_per_length"]), int(mix["batch"])
    samples = []
    for i, L in enumerate(mix["lengths"]):
        rows = np.concatenate([generator.tokens(mix, m["vocab"], seed,
                                                10 * i + j, L)
                               for j in range(-(-per // batch))])[:per]
        samples += [check.Sample(row, 0) for row in rows]
    w = weights.make(ref.param_specs(m), seed, card)
    widest = check.served_gaps(ref, m, w, samples, card,
                               control=fp8_mm).max()
    assert np.isfinite(widest)
    assert widest > cell.config["check"]["limit"]
