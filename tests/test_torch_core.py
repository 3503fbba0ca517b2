"""Core runtime parity: the port's scheduler against ``repro.core``.

The simulator and the scheduling logic are deterministic pure Python, so the
same program must give the same DAG edges, lanes, devices and simulated
timeline in both packages, bit for bit — with and without a memory budget,
and through capture and replay.  The port's real executor on the CPU runs
torch kernels on lane threads and must compute what numpy computes.
"""
import numpy as np
import pytest
import torch

import repro.api as jgr
import repro_torch.api as tgr

N = 64


def random_program(seed: int, n_arrays: int = 6, n_kernels: int = 14):
    """A reproducible random DAG: (template, array indices, cost)."""
    rng = np.random.RandomState(seed)
    names = sorted(MODES)
    prog = []
    for _ in range(n_kernels):
        tname = names[rng.randint(len(names))]
        idxs = rng.choice(n_arrays, size=len(MODES[tname]), replace=False)
        cost = float(rng.choice([1e-5, 1e-4, 1e-3]))
        prog.append((tname, [int(j) for j in idxs], cost))
    return prog


MODES = {"copy2": ("const", "out"), "bump": ("inout",),
         "add": ("const", "const", "out"), "axpy": ("const", "inout"),
         "split": ("const", "out", "out")}

# Kernels the real executor runs on torch tensors; the same arithmetic on
# numpy arrays gives the expected values.
KERNELS = {
    "copy2": lambda a, _o: a * 2.0,
    "bump": lambda a: a + 1.0,
    "add": lambda a, b, _o: a + b,
    "axpy": lambda a, b: b + 0.5 * a,
    "split": lambda a, _o1, _o2: (a + 1.0, a - 1.0),
}


def _drive(gr, s, prog, kernels=None):
    arrays = [s.array(np.full(N, i + 1.0, np.float32), name=f"a{i}")
              for i in range(6)]
    kernels = kernels or {t: (lambda *a: None) for t in MODES}
    fns = {t: gr.function(kernels[t], modes=MODES[t], name=t) for t in MODES}
    with gr.runtime(scheduler=s):
        for i, (tname, idxs, cost) in enumerate(prog):
            fns[tname].with_options(name=f"k{i}_{tname}", cost_s=cost)(
                *(arrays[j] for j in idxs))
    return arrays


def _structure(s):
    return [(e.name, e.kind.value, e.stream, e.device,
             sorted(p.name for p in e.parents)) for e in s._elements]


def _timeline(s):
    return [(sp.name, sp.kind, sp.lane, sp.t0, sp.t1)
            for sp in s.timeline.spans]


STAT_KEYS = ("elements", "edges", "d2d_transfers", "lanes_created",
             "events_created")


def _sim_run(gr, seed, **kw):
    s = gr.make_scheduler("parallel", simulate=True, **kw)
    _drive(gr, s, random_program(seed))
    struct = _structure(s)
    s.sync()
    out = struct, _timeline(s), {k: s.stats().get(k) for k in STAT_KEYS}
    s.close()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
@pytest.mark.parametrize("num_devices", [1, 2])
def test_simulator_parity(seed, num_devices):
    kw = dict(num_devices=num_devices, placement="round-robin")
    assert _sim_run(tgr, seed, **kw) == _sim_run(jgr, seed, **kw)


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
    out = (_timeline(s), {k: st[k] for k in (
        "plan_records", "plan_replays", "plan_invalidations", "elements")})
    s.close()
    return out


def test_capture_replay_parity():
    got, want = _episodes(tgr), _episodes(jgr)
    assert got == want
    assert want[1]["plan_records"] == 1 and want[1]["plan_replays"] == 3


def _numpy_program(prog):
    vals = [np.full(N, i + 1.0, np.float32) for i in range(6)]
    for tname, idxs, _ in prog:
        args = [vals[j] for j in idxs]
        res = KERNELS[tname](*args)
        res = res if isinstance(res, tuple) else (res,)
        writable = [j for j, m in zip(idxs, MODES[tname]) if m != "const"]
        for j, r in zip(writable, res):
            vals[j] = np.asarray(r, np.float32)
    return vals


@pytest.mark.parametrize("seed", [0, 3])
def test_cpu_lane_executor_matches_numpy(seed):
    prog = random_program(seed, n_kernels=10)
    s = tgr.make_scheduler("parallel", device="cpu")
    try:
        arrays = _drive(tgr, s, prog, KERNELS)
        s.sync()
        got = [np.asarray(a).copy() for a in arrays]
        lanes = s.stats()["lanes_created"]
    finally:
        s.close()
    for g, w in zip(got, _numpy_program(prog)):
        np.testing.assert_array_equal(g, w)
    assert lanes >= 1


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
