"""Scheduler-level tests in the port, the suites of
``tests/test_core_scheduler.py`` and ``tests/test_scheduler_extensions.py``
run on ``repro_torch.core``: real execution against numpy on CPU lanes,
the stream policies, host-sync granularity, the timing properties of the
simulator, kernel history, autotuning and the Chrome-trace export.

Every simulated case runs the same program through ``repro.core`` too and
asserts equal lanes, events, host clocks and makespans; the property test
of the timing holds each generated program's makespans equal to the
reference's under both policies.
"""
import json
import os
import tempfile

import numpy as np
import pytest
import torch
from _hypothesis_fallback import given, settings, st

from _torch_memory_check import _verify_torch_memory_accounting  # noqa: F401

import repro.core as J
import repro_torch.core as T


def both(run):
    got, want = run(T), run(J)
    assert got == want
    return got


# ----------------------------------------------------------------------
# Real-executor correctness: parallel execution == numpy semantics
# ----------------------------------------------------------------------

_OPS = {
    "add": lambda a, b: a + b,
    "mul": lambda a, b: a * b,
    "axpy": lambda a, b: 2.0 * a + b,
}


@st.composite
def random_program(draw):
    n_arrays = draw(st.integers(2, 4))
    n_ops = draw(st.integers(1, 10))
    ops = []
    for _ in range(n_ops):
        opname = draw(st.sampled_from(sorted(_OPS)))
        src_a = draw(st.integers(0, n_arrays - 1))
        src_b = draw(st.integers(0, n_arrays - 1))
        dst = draw(st.integers(0, n_arrays - 1))
        ops.append((opname, src_a, src_b, dst))
    return n_arrays, ops


@settings(max_examples=25, deadline=None)
@given(random_program())
def test_parallel_execution_matches_sequential_semantics(prog):
    n_arrays, ops = prog
    rng = np.random.RandomState(0)
    init = [rng.randn(32).astype(np.float32) for _ in range(n_arrays)]
    ref = [v.copy() for v in init]
    for opname, a, b, d in ops:
        ref[d] = _OPS[opname](ref[a], ref[b]).astype(np.float32)

    s = T.make_scheduler("parallel", device="cpu")
    try:
        arrs = [s.array(v.copy(), name=f"a{i}") for i, v in enumerate(init)]
        for opname, a, b, d in ops:
            s.launch(lambda x, y, _o, f=_OPS[opname]: f(x, y),
                     [T.const(arrs[a]), T.const(arrs[b]), T.out(arrs[d])],
                     name=opname)
        for i, arr in enumerate(arrs):
            np.testing.assert_allclose(np.asarray(arr), ref[i], rtol=1e-6,
                                       err_msg=f"array {i}")
    finally:
        s.close()


def test_serial_and_parallel_same_results():
    def run(policy):
        s = T.make_scheduler(policy, device="cpu")
        try:
            x = s.array(np.arange(64, dtype=np.float32), name="x")
            y = s.array(np.zeros(64, np.float32), name="y")
            z = s.array(np.zeros(64, np.float32), name="z")
            s.launch(lambda a, _: a * a, [T.const(x), T.out(y)], name="sq")
            s.launch(lambda a, _: a + 3, [T.const(x), T.out(z)], name="p3")
            s.launch(torch.add, [T.const(y), T.inout(z)], name="mix")
            return np.asarray(z).copy()
        finally:
            s.close()

    x = np.arange(64, dtype=np.float32)
    serial = run("serial")
    np.testing.assert_array_equal(serial, run("parallel"))
    np.testing.assert_array_equal(serial, x * x + (x + 3))


# ----------------------------------------------------------------------
# Stream-management policies (§IV-C)
# ----------------------------------------------------------------------

def _zeros(s, name, n=1024):
    return s.array(np.zeros(n, np.float32), name=name)


def test_first_child_inherits_parent_stream():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True)
        A, B = _zeros(s, "A"), _zeros(s, "B")
        k1 = s.launch(None, [c.inout(A)], name="K1", cost_s=1e-3)
        k2 = s.launch(None, [c.const(A), c.out(B)], name="K2", cost_s=1e-3)
        assert k2.stream == k1.stream          # first child inherits
        C = _zeros(s, "C")
        k3 = s.launch(None, [c.const(A), c.out(C)], name="K3", cost_s=1e-3)
        assert k3.stream != k1.stream          # the second gets another
        s.sync()
        return [k.stream for k in (k1, k2, k3)], s.timeline.makespan
    both(run)


def test_independent_kernels_get_distinct_lanes():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True)
        es = [s.launch(None, [c.inout(_zeros(s, f"X{i}"))], name=f"K{i}",
                       cost_s=1e-3) for i in range(4)]
        assert len({e.stream for e in es}) == 4
        s.sync()
        return [e.stream for e in es]
    both(run)


def test_fifo_lane_reuse_after_sync():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True)
        s.launch(None, [c.inout(_zeros(s, "X"))], name="K1", cost_s=1e-4)
        s.sync()
        before = s.streams.lanes_created
        k2 = s.launch(None, [c.inout(_zeros(s, "Y"))], name="K2",
                      cost_s=1e-4)
        s.sync()
        assert s.streams.lanes_created == before   # reused, not created
        return before, k2.stream
    both(run)


def test_event_count_matches_cross_lane_parents():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True)
        A, B, C = _zeros(s, "A"), _zeros(s, "B"), _zeros(s, "C")
        s.launch(None, [c.inout(A)], name="K1", cost_s=1e-3)
        s.launch(None, [c.inout(B)], name="K2", cost_s=1e-3)
        ev0 = s.streams.events_created
        k3 = s.launch(None, [c.const(A), c.const(B), c.out(C)], name="K3",
                      cost_s=1e-3)
        assert s.streams.events_created - ev0 == 1
        s.sync()
        return ev0, s.streams.events_created, k3.stream
    both(run)


# ----------------------------------------------------------------------
# Host-access synchronization granularity (§IV-B)
# ----------------------------------------------------------------------

def test_host_read_syncs_only_owning_lane():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True)
        A, B = _zeros(s, "A", 1 << 20), _zeros(s, "B")
        s.launch(None, [c.inout(A)], name="slow", cost_s=1.0)
        s.launch(None, [c.inout(B)], name="fast", cost_s=1e-4)
        _ = B[0]                    # must not wait for `slow`
        t_read = s.executor.host_time
        assert t_read < 0.5, f"host read waited for slow ({t_read})"
        s.sync()
        assert s.executor.host_time >= 1.0
        return t_read, s.executor.host_time
    both(run)


def test_host_write_waits_for_readers():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True)
        A, B = _zeros(s, "A"), _zeros(s, "B")
        s.launch(None, [c.const(A), c.out(B)], name="reader", cost_s=0.25)
        A[0] = 7.0                  # WAR: waits for `reader`
        t_write = s.executor.host_time
        assert t_write >= 0.25
        s.sync()
        return t_write
    both(run)


def test_consecutive_host_accesses_fast_path():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True)
        A = _zeros(s, "A")
        A[0] = 1.0
        A[1] = 2.0
        first = float(A[0])
        assert s.dag.num_elements == 0  # no DAG traffic for host accesses
        return first, s.executor.host_time
    both(run)


# ----------------------------------------------------------------------
# Timing properties (simulated): parallel never slower than serial
# ----------------------------------------------------------------------

@st.composite
def timed_program(draw):
    n = draw(st.integers(2, 10))
    ops = []
    for i in range(n):
        reads = draw(st.lists(st.integers(0, i - 1), max_size=2,
                              unique=True)) if i > 0 else []
        cost = draw(st.floats(1e-4, 5e-3))
        mb = draw(st.integers(0, 8))
        ops.append((reads, cost, mb * (1 << 20)))
    return ops


def _timed_makespan(c, ops, policy):
    s = c.make_scheduler(policy, simulate=True)
    outs = []
    for i, (reads, cost, nbytes) in enumerate(ops):
        y = s.array(np.zeros(max(1, nbytes // 4), np.float32), name=f"y{i}")
        args = [c.const(outs[r]) for r in reads] + [c.out(y)]
        s.launch(None, args, name=f"k{i}", cost_s=cost)
        outs.append(y)
    s.sync()
    return s.timeline.makespan


@settings(max_examples=40, deadline=None)
@given(timed_program())
def test_parallel_schedule_not_slower_than_serial(ops):
    ts, tp = both(lambda c: (_timed_makespan(c, ops, "serial"),
                             _timed_makespan(c, ops, "parallel")))
    assert tp <= ts * 1.001 + 1e-4, f"parallel {tp} slower than serial {ts}"


def test_oracle_not_slower_than_runtime_scheduler():
    def build(c, **kw):
        s = c.make_scheduler("parallel", simulate=True, **kw)
        prev = None
        for i in range(8):
            y = s.array(np.zeros(1 << 20, np.float32), name=f"y{i}")
            args = ([c.const(prev)] if prev is not None and i % 3 == 0
                    else []) + [c.out(y)]
            s.launch(None, args, name=f"k{i}", cost_s=1e-3)
            prev = y
        s.sync()
        return s.timeline.makespan

    t_runtime, t_oracle = both(lambda c: (build(c), build(c, oracle=True)))
    assert t_oracle <= t_runtime * 1.001 + 1e-6


# ----------------------------------------------------------------------
# History / straggler detection
# ----------------------------------------------------------------------

def test_history_and_straggler_detection():
    def run(c):
        h = c.KernelHistory(straggler_factor=3.0, min_samples=3)
        flags = [h.record("k", {"block": 128}, 1.0) for _ in range(5)]
        assert not any(flags)
        assert h.record("k", {"block": 128}, 10.0)        # straggler
        assert h.estimate("k", {"block": 128}) == pytest.approx(1.0)
        h.record("k", {"block": 32}, 0.5)
        assert h.best_config("k") == {"block": "32"}
        return (h.estimate("k", {"block": 128}),
                h.estimate("k", {"block": 32}), h.best_config("k"))
    both(run)


def test_overlap_metrics_bounds():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True)
        for i in range(5):
            X = s.array(np.zeros(2 << 20, np.float32), name=f"X{i}")
            Y = s.array(np.zeros(2 << 20, np.float32), name=f"Y{i}")
            s.launch(None, [c.const(X), c.out(Y)], name=f"K{i}", cost_s=2e-3)
        s.sync()
        m = s.timeline.overlap_metrics()
        for k, v in m.items():
            assert 0.0 <= v <= 1.0, (k, v)
        assert m["TOT"] > 0
        return m
    both(run)


# ----------------------------------------------------------------------
# Extensions: launch-config autotuning, Chrome-trace export
# ----------------------------------------------------------------------

def test_autotune_explores_then_exploits_best_config():
    costs = {32: 3e-3, 64: 1e-3, 128: 2e-3}

    def run(c):
        s = c.make_scheduler("parallel", simulate=True)
        choices = []
        for i in range(30):
            x = _zeros(s, f"a{i}")
            y = _zeros(s, f"b{i}")
            cfg = s._tune("k", {"block": [32, 64, 128]})
            choices.append(cfg["block"])
            s.launch(None, [c.const(x), c.out(y)], name="k",
                     cost_s=costs[cfg["block"]], block=cfg["block"])
            s.sync()
        assert set(choices[:6]) == {32, 64, 128}   # round-robin exploration
        assert all(ch == 64 for ch in choices[8:])  # locks in the fastest
        return choices, s.timeline.makespan
    both(run)


def test_chrome_trace_export():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True)
        for i in range(4):
            x = s.array(np.zeros(1 << 20, np.float32), name=f"x{i}")
            y = s.array(np.zeros(1 << 20, np.float32), name=f"y{i}")
            s.launch(None, [c.const(x), c.out(y)], name=f"k{i}", cost_s=1e-3)
        s.sync()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            s.timeline.to_chrome_trace(path)
            with open(path) as f:
                ev = json.load(f)["traceEvents"]
        assert any(e.get("cat") == "h2d" for e in ev)
        assert any(e.get("cat") == "compute" for e in ev)
        xs = [e for e in ev if e["ph"] == "X"]
        assert xs and all(e["dur"] > 0 for e in xs)
        return ev
    both(run)
