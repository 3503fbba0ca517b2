"""The core runtime's real executor on CUDA-stream lanes: the real-executor
cases of ``tests/test_torch_core_{dag,streams,scheduler,memory,
equivalence}.py`` at small sizes on the card.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one.  The file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_core_cuda.py
"""
import gc
import time

import numpy as np
import pytest
import torch

import repro_torch.api as gr
from repro_torch.benchsuite.outofcore import (build_outofcore,
                                              verify_outofcore,
                                              working_set_bytes)
from repro_torch.core import const, function, inout, make_scheduler

from _torch_core_programs import (KERNELS, STAT_KEYS, capture_demotion,
                                  concurrent_stress, drive, hold_lanes,
                                  make_arrays, numpy_program, random_program,
                                  simulated, structure)

N = 1 << 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the lanes are CUDA streams")
    return torch.device("cuda")


def lane_streams(s):
    """The distinct CUDA streams the scheduler's lane workers made."""
    return {st.cuda_stream for w in s.executor._lanes.values()
            for st in w._streams.values()}


def run_program(prog, policy, n=N):
    """``prog`` on CUDA lanes, issued with every element in flight: its
    elements, stats, distinct lane streams and values."""
    s = make_scheduler(policy, device="cuda")
    try:
        gate = hold_lanes(s, policy)
        arrays = make_arrays(s, n=n)
        drive(gr, s, prog, arrays, KERNELS)
        struct = structure(s)
        gate.set()
        s.sync()
        stats = {k: s.stats()[k] for k in STAT_KEYS}
        streams = lane_streams(s)
        values = [np.asarray(a).copy() for a in arrays]
    finally:
        s.close()
    return struct, stats, streams, values


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_random_programs_on_cuda_lanes(card, seed):
    """Both policies compute the same bits, numpy's values within rtol
    1e-6, and the simulator's edges, lanes and stats, each lane on a
    CUDA stream of its own."""
    prog = random_program(seed)
    want = numpy_program(prog, n=N)
    runs = {p: run_program(prog, p) for p in ("parallel", "serial")}
    for policy, (struct, stats, streams, values) in runs.items():
        assert (struct, stats) == simulated(gr, policy, prog, n=N)
        # the serial policy runs every element on one worker, no lane
        assert len(streams) == max(1, stats["lanes_created"])
        for g, w in zip(values, want):
            np.testing.assert_allclose(g, w, rtol=1e-6)
    for p, q in zip(runs["parallel"][3], runs["serial"][3]):
        np.testing.assert_array_equal(p, q)


def sleep_cycles(ms: float) -> int:
    """Clock cycles ``torch.cuda._sleep`` spins for about ``ms``."""
    probe = 50_000_000
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    return int(probe * ms / start.elapsed_time(end))


def slow_kernel(cycles):
    def slow(a, _c):
        torch.cuda._sleep(cycles)
        return a + 1.0
    return slow


@pytest.mark.cuda
def test_host_read_syncs_only_owning_lane(card):
    """§IV-C on streams: a host read of an array another lane owns does not
    wait for a slow kernel; a host write to an array the slow kernel reads
    does."""
    cycles = sleep_cycles(200.0)
    s = make_scheduler("parallel", device="cuda")
    try:
        A = s.array(np.zeros(N, np.float32), name="A")
        B = s.array(np.zeros(N, np.float32), name="B")
        C = s.array(np.ones(N, np.float32), name="C")
        warm = function(lambda a, b, c: (a, b), modes=("inout", "inout",
                                                       "const"))
        warm.with_options(scheduler=s)(A, B, C)
        s.sync()                        # every array on the card
        s.launch(slow_kernel(cycles), [inout(A), const(C)], name="slow")
        s.launch(lambda b: b + 2.0, [inout(B)], name="fast")
        t0 = time.perf_counter()
        assert float(B[0]) == 2.0
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        C[0] = 7.0                      # WAR: waits for `slow`
        t_write = time.perf_counter() - t0
        assert float(A[0]) == 1.0
    finally:
        s.close()
    assert t_read < 0.02, f"host read took {t_read * 1e3:.1f} ms"
    assert t_write > 0.1, f"host write took {t_write * 1e3:.1f} ms"


@pytest.mark.cuda
def test_out_of_core_through_spills_on_cuda(card):
    """A working set twice the budget runs right through spills and
    reloads, with the ledger equal to the bytes installed and the card's
    allocation within the budget and one chunk."""
    chunks, n = 6, 1 << 20
    budget = working_set_bytes(chunks, n) // 2
    gc.collect()
    base = torch.cuda.memory_allocated()
    s = make_scheduler("parallel", memory_budget=budget, device="cuda",
                       plan_optimize=True)
    try:
        arrays = build_outofcore(s, chunks=chunks, n=n)
        s.sync()
        held = torch.cuda.memory_allocated() - base
        assert s.memory.verify(physical=True).ok
        phys = sum(s.memory.physical_resident_bytes().values())
        assert held <= budget + 4 * n, held
        assert abs(held - phys) <= 4 * n, (held, phys)
        assert verify_outofcore(arrays)
        st = s.stats()
        assert st["mem_spills"] >= 1 and st["mem_reloads"] >= 1
    finally:
        s.close()


@pytest.mark.cuda
def test_concurrent_sync_vs_launch_stress_on_cuda(card):
    s = make_scheduler("parallel", num_devices=2, device="cuda",
                       memory_budget=256 * 4 * N)
    try:
        concurrent_stress(gr, s, n=N)
    finally:
        s.close()


@pytest.mark.cuda
def test_capture_demotion_on_cuda(card):
    s = make_scheduler("parallel", memory_budget=64 * 4 * N, device="cuda")
    try:
        capture_demotion(gr, s, n=N)
    finally:
        s.close()


@pytest.mark.cuda
def test_close_returns_the_card_to_its_baseline(card):
    """Matmuls on several lanes leave nothing allocated once the scheduler
    is closed: neither the arrays nor the lanes' cuBLAS workspaces."""
    gc.collect()
    base = torch.cuda.memory_allocated()
    mm = function(lambda a, b, o: a @ b, modes=("const", "const", "out"),
                  name="mm", outputs=0)
    s = make_scheduler("parallel", device="cuda")
    try:
        rng = np.random.RandomState(0)
        xs = [s.array(rng.rand(256, 256).astype(np.float32))
              for _ in range(8)]
        ys = [mm.with_options(scheduler=s)(xs[i], xs[i + 1])
              for i in range(0, 8, 2)]
        s.sync()
        assert s.stats()["lanes_created"] >= 2
        got = np.asarray(ys[0])
    finally:
        s.close()
    np.testing.assert_allclose(got, np.asarray(xs[0].host) @ xs[1].host,
                               rtol=1e-4)
    del xs, ys, s
    gc.collect()
    assert torch.cuda.memory_allocated() <= base
