"""GrFunction and legacy-launch equivalence in the port, the suite of
``tests/test_frontend_equivalence.py`` run on ``repro_torch``.

A random DAG program is driven through either surface of each package: the
declared ``GrFunction``s or the deprecated ``s.launch`` with per-call modes.
On the simulator the port must give, for each surface, the reference's DAG
edges, lanes, devices, stats and timeline bit for bit, and the legacy
surface the frontend's.  On the real executor (CPU lanes, torch kernels)
the port must compute what numpy computes, the reference's real executor's
values within rtol 1e-6, and the same values and edges on both surfaces.
Issued with every element in flight, the real executor's lanes and events
are the simulator's too.
"""
import numpy as np
import pytest

from _torch_memory_check import _verify_torch_memory_accounting  # noqa: F401

import repro.api as jgr
import repro_torch.api as tgr

from _torch_core_programs import (KERNELS, STAT_KEYS, drive, edges,
                                  hold_lanes, make_arrays, numpy_program,
                                  random_program, simulated, structure,
                                  timeline)

SURFACES = ["frontend", "legacy"]


def sim_run(gr, seed, surface, **kw):
    s = gr.make_scheduler("parallel", simulate=True, **kw)
    drive(gr, s, random_program(seed), make_arrays(s), surface=surface)
    struct = structure(s)
    s.sync()
    out = struct, timeline(s), {k: s.stats().get(k) for k in STAT_KEYS}
    s.close()
    return out


@pytest.mark.parametrize("surface", SURFACES)
@pytest.mark.parametrize("seed", [0, 1, 2, 7])
@pytest.mark.parametrize("num_devices", [1, 2])
def test_equivalence_sim(surface, seed, num_devices):
    """Identical DAG edges, lane and device assignments, stats and (bit
    for bit) timelines on 1- and 2-device simulators: the port's against
    the reference's on the same surface, and the legacy surface against
    the frontend."""
    kw = dict(num_devices=num_devices, placement="round-robin")
    got = sim_run(tgr, seed, surface, **kw)
    assert got == sim_run(jgr, seed, surface, **kw)
    if surface == "legacy":
        assert got == sim_run(tgr, seed, "frontend", **kw)


def _jax_kernels():
    import jax
    return {t: jax.jit(f) for t, f in KERNELS.items()}


def real_run(gr, seed, surface, kernels, **kw):
    """One program on a real executor: its edges, every array's values
    and the lanes it created (timing-dependent, so only counted)."""
    prog = random_program(seed, n_kernels=10)
    s = gr.make_scheduler("parallel", **kw)
    try:
        arrays = make_arrays(s)
        drive(gr, s, prog, arrays, kernels, surface=surface)
        got_edges = edges(s)
        s.sync()
        values = [np.asarray(a).copy() for a in arrays]
        lanes = s.stats()["lanes_created"]
    finally:
        s.close()
    return got_edges, values, lanes


@pytest.mark.parametrize("surface", SURFACES)
@pytest.mark.parametrize("seed", [0, 3])
def test_equivalence_real_executor(surface, seed):
    """The port on CPU lanes: numpy's values exactly, the reference's real
    executor's edges and values (rtol 1e-6), and on the legacy surface the
    frontend's edges and values bit for bit."""
    got_edges, got, lanes = real_run(tgr, seed, surface, KERNELS,
                                     device="cpu")
    assert lanes >= 1
    for g, w in zip(got, numpy_program(random_program(seed, n_kernels=10))):
        np.testing.assert_array_equal(g, w)
    want_edges, want, _ = real_run(jgr, seed, surface, _jax_kernels())
    assert got_edges == want_edges
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    if surface == "legacy":
        front_edges, front, _ = real_run(tgr, seed, "frontend", KERNELS,
                                         device="cpu")
        assert got_edges == front_edges
        for g, f in zip(got, front):
            np.testing.assert_array_equal(g, f)


@pytest.mark.parametrize("policy", ["parallel", "serial"])
@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_real_lanes_equal_simulator_when_issued_in_flight(policy, seed):
    """Issued with every element in flight, the real executor on CPU lanes
    makes the simulator's edges, lanes, events and stats and numpy's
    values; the port's simulator makes the reference's."""
    prog = random_program(seed)
    want = simulated(tgr, policy, prog)
    assert want == simulated(jgr, policy, prog)
    s = tgr.make_scheduler(policy, device="cpu")
    try:
        gate = hold_lanes(s, policy)
        arrays = make_arrays(s)
        drive(tgr, s, prog, arrays, KERNELS)
        got = structure(s)
        gate.set()
        s.sync()
        stats = {k: s.stats()[k] for k in STAT_KEYS}
        values = [np.asarray(a).copy() for a in arrays]
    finally:
        s.close()
    assert (got, stats) == want
    for g, w in zip(values, numpy_program(prog)):
        np.testing.assert_array_equal(g, w)
