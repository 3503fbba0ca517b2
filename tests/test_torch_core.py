"""Core runtime parity: the port's scheduler against ``repro.core``.

The simulator and the scheduling logic are deterministic pure Python, so the
same program must give the same DAG edges, lanes, devices and simulated
timeline in both packages, bit for bit — with and without a memory budget,
and through capture and replay.  The random programs without a budget, on
the simulator and on the real executor, are the cases of
``tests/test_torch_core_equivalence.py``.
"""
import numpy as np
import pytest
import torch

import repro.api as jgr
import repro_torch.api as tgr

from _torch_core_programs import (N, STAT_KEYS, drive, make_arrays,
                                  random_program, structure, timeline)


def _sim_run(gr, seed, **kw):
    s = gr.make_scheduler("parallel", simulate=True, **kw)
    drive(gr, s, random_program(seed), make_arrays(s))
    struct = structure(s)
    s.sync()
    out = struct, timeline(s), {k: s.stats().get(k) for k in STAT_KEYS}
    s.close()
    return out


@pytest.mark.parametrize("seed", [3, 5])
def test_simulator_parity_under_memory_budget(seed):
    """A budget of three arrays forces spills and reloads."""
    kw = dict(memory_budget=3 * N * 4)
    got, want = _sim_run(tgr, seed, **kw), _sim_run(jgr, seed, **kw)
    assert got == want
    assert any(kind == "d2h" for _, kind, *_ in want[1])


def _episodes(gr, n_episodes=4):
    s = gr.make_scheduler("parallel", simulate=True)
    sq = gr.function(lambda *a: None, modes=("const", "out"), name="SQ")
    red = gr.function(lambda *a: None, modes=("const", "const", "out"),
                      name="RED")
    for ep in range(n_episodes):
        with s.capture("vec"):
            x1 = s.array(np.ones(1024, np.float32), name=f"x1_{ep}")
            x2 = s.array(np.full(1024, 2.0, np.float32), name=f"x2_{ep}")
            y1 = s.array(shape=(1024,), dtype=np.float32, name=f"y1_{ep}")
            y2 = s.array(shape=(1024,), dtype=np.float32, name=f"y2_{ep}")
            z = s.array(shape=(1024,), dtype=np.float32, name=f"z_{ep}")
            with gr.runtime(scheduler=s):
                sq.with_options(cost_s=1e-4)(x1, y1)
                sq.with_options(cost_s=1e-4)(x2, y2)
                red.with_options(cost_s=1e-4)(y1, y2, z)
        s.sync()
    st = s.stats()
    out = (timeline(s), {k: st[k] for k in (
        "plan_records", "plan_replays", "plan_invalidations", "elements")})
    s.close()
    return out


def test_capture_replay_parity():
    got, want = _episodes(tgr), _episodes(jgr)
    assert got == want
    assert want[1]["plan_records"] == 1 and want[1]["plan_replays"] == 3


def test_cpu_lane_executor_runs_torch_tensors_on_lanes():
    """Uploaded values are torch tensors, a never-uploaded ``out`` argument
    arrives as a tensor, and a host read gets numpy back."""
    seen = []

    def k(a, o):
        seen.append((type(a), type(o)))
        return a + 1.0

    s = tgr.make_scheduler("parallel", device="cpu")
    try:
        x = s.array(np.arange(8, dtype=np.float32))
        y = s.array(shape=(8,), dtype=np.float32)
        with tgr.runtime(scheduler=s):
            tgr.function(k, modes=("const", "out"))(x, y)
        out = np.asarray(y)
    finally:
        s.close()
    assert seen == [(torch.Tensor, torch.Tensor)]
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    np.testing.assert_array_equal(out, np.arange(8, dtype=np.float32) + 1)
