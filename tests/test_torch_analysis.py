"""The port's analysis passes (``repro_torch.analysis``) against ``repro``'s.

The happens-before verifier and the journal auditor are pure Python: on the
same programs the port must give the reference's violation strings and
audit records, string for string.  The sanitizer keeps the reference's
version-vector logic (its stats must match on a simulated program); its
const canary is the port's own (digests over integer views, on the value's
device).  The reference's mode checker is red on this JAX
(``jax.core.Literal``), so the port's checker is held against the verdicts
``tests/test_analysis.py`` expects.  Also here: the bf16 host/device round
trips of the port's core, against the reference's bytes.
"""
import dataclasses
import importlib
import json
import re
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch
from _hypothesis_fallback import given, settings, st

import repro.analysis as jan
import repro.api as jgr
import repro.core as jcore
import repro_torch.analysis as tan
import repro_torch.api as tgr
import repro_torch.core as tcore
from repro_torch.analysis import SanitizerError
from repro_torch.analysis.sanitizer import Sanitizer, digest
from repro_torch.core.element import ComputationalElement
from _torch_core_programs import MODES, random_program

BF16 = np.dtype(ml_dtypes.bfloat16)


# ----------------------------------------------------------------------
# Verifier: captured plans and their seeded mutations
# ----------------------------------------------------------------------

def _vec_episode(core, s, tag=""):
    const, out = core.const, core.out
    n = 256
    x1 = s.array(np.ones(n, np.float32), name=f"x1{tag}")
    x2 = s.array(np.full(n, 2.0, np.float32), name=f"x2{tag}")
    y1 = s.array(shape=(n,), dtype=np.float32, name=f"y1{tag}")
    y2 = s.array(shape=(n,), dtype=np.float32, name=f"y2{tag}")
    z = s.array(shape=(n,), dtype=np.float32, name=f"z{tag}")
    s.launch(None, [const(x1), out(y1)], name="SQ1", cost_s=1e-4)
    s.launch(None, [const(x2), out(y2)], name="SQ2", cost_s=1e-4)
    s.launch(None, [const(y1), const(y2), out(z)], name="RED", cost_s=1e-4)


def _plan_vec(core):
    s = core.make_scheduler("parallel", simulate=True)
    with s.capture("vec"):
        _vec_episode(core, s)
    return s


def _plan_task_parallel(core):
    bench = importlib.import_module(
        core.__name__.replace(".core", ".benchsuite"))
    s = core.make_scheduler("parallel", simulate=True, num_devices=2,
                            placement="round-robin", plan_optimize=True)
    with s.capture("tp"):
        bench.build_task_parallel(s, branches=3, chain=3, n=1 << 10)
    return s


def _plan_evict(core):
    """Budget of ~3.5 arrays; three inputs reused over two passes force
    evictions and reloads inside one captured episode."""
    n = 1 << 10
    s = core.make_scheduler("parallel", simulate=True,
                            memory_budget=int(n * 4 * 3.5))
    xs = [s.array(np.ones(n, np.float32), name=f"x{i}") for i in range(3)]
    with s.capture("reuse"):
        for rep in range(2):
            for i, x in enumerate(xs):
                y = s.array(shape=(n,), dtype=np.float32, name=f"y{rep}_{i}")
                s.launch(None, [core.const(x), core.out(y)],
                         name=f"K{rep}_{i}", cost_s=1e-4)
    return s


def _captured(build, core):
    s = build(core)
    plan = s.plan_cache.all_plans()[0]
    s.sync()
    s.shutdown()
    return plan


def _mutate(plan, idx, **changes):
    els = list(plan.elements)
    els[idx] = dataclasses.replace(els[idx], **changes)
    return dataclasses.replace(plan, elements=tuple(els))


def _plan_mutants(plan):
    """The plan and every seeded mutation of ``tests/test_analysis.py``
    that applies to it: each dropped wait event, each dropped wait event
    with its parent claim, an index scramble, and each suppressed reload
    of an evicted slot."""
    yield "green", plan
    for i, pe in enumerate(plan.elements):
        for ev in pe.wait_events:
            waits = tuple(e for e in pe.wait_events if e != ev)
            yield f"drop wait {ev}->{i}", _mutate(plan, i, wait_events=waits)
            yield f"drop edge {ev}->{i}", _mutate(
                plan, i, wait_events=waits,
                parents=tuple(p for p in pe.parents if p != ev))
    if len(plan.elements) > 1:
        yield "index scramble", _mutate(plan, 1, index=5)
    placing = ("transfer", "reload", "d2d")     # either package's kinds
    for i, pe in enumerate(plan.elements):
        if pe.kind.value != "evict":
            continue
        for slot, _m in pe.arg_slots:
            for j in range(i + 1, len(plan.elements)):
                pj = plan.elements[j]
                if pj.kind.value in placing and any(sl == slot
                                              for sl, _ in pj.arg_slots):
                    yield f"no reload {slot}@{j}", _mutate(
                        plan, j, arg_slots=tuple(
                            (sl, m) for sl, m in pj.arg_slots if sl != slot))


def _verdicts(verify, plan):
    return [(label, [(str(v), v.elements) for v in verify(mut)])
            for label, mut in _plan_mutants(plan)]


@pytest.mark.parametrize("build,kinds", [
    (_plan_vec, {"race", "parent-order", "structure"}),
    (_plan_task_parallel, {"race", "parent-order", "structure"}),
    (_plan_evict, {"liveness", "structure"}),
], ids=["vec", "task_parallel_planopt", "evict_reload"])
def test_verifier_plan_violations_match_reference(build, kinds):
    tplan, jplan = _captured(build, tcore), _captured(build, jcore)
    got, want = _verdicts(tan.verify_plan, tplan), _verdicts(
        jan.verify_plan, jplan)
    assert got == want
    assert got[0][1] == []                      # the captured plan is green
    seen = {s.split("]")[0][1:] for _l, vs in got for s, _e in vs}
    assert kinds <= seen, seen
    if build is _plan_task_parallel:
        assert tplan.optimized and jplan.optimized


def test_plan_verification_error_carries_violations():
    plan = _captured(_plan_vec, tcore)
    vs = tan.verify_plan(_mutate(plan, 1, index=5))
    err = tan.PlanVerificationError("vec", vs)
    jerr = jan.PlanVerificationError(
        "vec", jan.verify_plan(_mutate(_captured(_plan_vec, jcore), 1,
                                       index=5)))
    assert err.violations == vs and "structure" in str(err)
    assert str(err) == str(jerr)


# ----------------------------------------------------------------------
# Verifier: live windows
# ----------------------------------------------------------------------

def _normalized(violations, window):
    """Violations with element uids (process-wide counters, different in
    the two packages) replaced by window positions."""
    pos = {e.uid: i for i, e in enumerate(window)}

    def sub(m):
        return f"uid #{pos[int(m.group(1))]}"
    return [(re.sub(r"uid (\d+)", sub, str(v)),
             tuple(pos[u] for u in v.elements)) for v in violations]


def _dropped_edge_verdicts(an, window):
    out = []
    for child in window:
        for parent in list(child.parents):
            child.parents.remove(parent)
            try:
                out.append(((parent.name, child.name), _normalized(
                    an.verify_elements(window), window)))
            finally:
                child.parents.append(parent)
    return out


def _random_window(core, gr, seed):
    s = core.make_scheduler("parallel", simulate=True)
    arrays = [s.array(np.full(64, i + 1.0, np.float32), name=f"a{i}")
              for i in range(6)]
    fns = {t: gr.function(None, modes=MODES[t], name=t) for t in MODES}
    with gr.runtime(scheduler=s):
        for i, (tname, idxs, cost) in enumerate(random_program(seed)):
            fns[tname].with_options(name=f"k{i}_{tname}", cost_s=cost)(
                *(arrays[j] for j in idxs))
    window = list(s._elements)
    assert (jan if core is jcore else tan).verify_scheduler(s) == []
    s.sync()
    s.shutdown()
    return window


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_verifier_random_dag_windows_match_reference(seed):
    got = _dropped_edge_verdicts(tan, _random_window(tcore, tgr, seed))
    want = _dropped_edge_verdicts(jan, _random_window(jcore, jgr, seed))
    assert got == want
    assert any(vs for _edge, vs in got), "no dropped edge was ever flagged"


def test_live_window_green_then_dropped_parent_flagged():
    def run(core, an):
        s = core.make_scheduler("parallel", simulate=True)
        _vec_episode(core, s)
        assert an.verify_scheduler(s) == []
        window = list(s._elements)
        s.sync()
        s.shutdown()
        red = next(e for e in window if e.name == "RED")
        sq1 = next(e for e in window if e.name == "SQ1")
        assert sq1 in red.parents
        red.parents = [p for p in red.parents if p is not sq1]
        return _normalized(an.verify_elements(window), window)

    got = run(tcore, tan)
    assert got == run(jcore, jan)
    assert any("RAW" in msg for msg, _e in got), got


def test_live_window_host_barrier_and_serial_total_order():
    s = tcore.make_scheduler("serial", simulate=True)
    _vec_episode(tcore, s)
    assert tan.verify_scheduler(s) == []
    s.sync()
    s.shutdown()
    # Host reads bridge ordering across retired dependencies (CPU lanes).
    s = tcore.make_scheduler("parallel", device="cpu")
    y = s.array(shape=(8,), dtype=np.float32, name="hy")
    xs = s.array(np.ones(8, np.float32), name="hx")
    s.launch(lambda a, b: (a * 2.0,), [tcore.const(xs), tcore.out(y)],
             name="W1", cost_s=1e-4)
    float(y[0])
    s.launch(lambda a, b: (a * 3.0,), [tcore.const(xs), tcore.out(y)],
             name="W2", cost_s=1e-4)
    assert tan.verify_scheduler(s) == []
    s.verify()
    assert float(y[0]) == 3.0
    s.sync()
    s.shutdown()


# -- the two properties of tests/test_analysis_property.py, on the port --

_WRAP = ("const", "out", "inout")


def _build_window(codes):
    s = tcore.make_scheduler("parallel", simulate=True)
    pool = [s.array(np.ones(64, np.float32), name=f"p{i}") for i in range(3)]
    for k, code in enumerate(codes):
        wrap = getattr(tcore, _WRAP[(code // 3) % 3])
        s.launch(None, [wrap(pool[code % 3])], name=f"OP{k}", cost_s=1e-5)
    window = list(s._elements)
    s.sync()
    s.shutdown()
    return window


def _oracle_unordered_pairs(elements):
    """Independent O(n³) check: conflicting access pairs with no parent
    path between them, via full boolean matrix transitive closure."""
    n = len(elements)
    pos = {e.uid: i for i, e in enumerate(elements)}
    reach = [[False] * n for _ in range(n)]
    for j, e in enumerate(elements):
        for p in e.parents:
            i = pos.get(p.uid)
            if i is not None:
                reach[i][j] = True
    for k in range(n):
        rk = reach[k]
        for i in range(n):
            if reach[i][k]:
                ri = reach[i]
                for j in range(n):
                    if rk[j]:
                        ri[j] = True
    accesses = {}
    for i, e in enumerate(elements):
        for key, mode in e.arg_modes():
            accesses.setdefault(key, []).append((i, mode))
    unordered = set()
    for acc in accesses.values():
        for a in range(len(acc)):
            i, mi = acc[a]
            for b in range(a + 1, len(acc)):
                j, mj = acc[b]
                if mi.conflicts_with(mj) and not (reach[i][j]
                                                  or reach[j][i]):
                    unordered.add(frozenset((elements[i].uid,
                                             elements[j].uid)))
    return unordered


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 8), min_size=3, max_size=9))
def test_scheduler_dags_always_verify(codes):
    window = _build_window(codes)
    assert _oracle_unordered_pairs(window) == set()
    assert tan.verify_elements(window) == []


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 8), min_size=3, max_size=9))
def test_any_single_dropped_edge_matches_oracle_exactly(codes):
    window = _build_window(codes)
    mutants = 0
    for child in window:
        for parent in list(child.parents):
            child.parents.remove(parent)
            try:
                expected = _oracle_unordered_pairs(window)
                got = {frozenset(v.elements)
                       for v in tan.verify_elements(window)
                       if v.kind == "race"}
                assert got == expected, (
                    f"dropping {parent.name}->{child.name}: verifier "
                    f"reported {got}, oracle says {expected}")
                if expected:
                    mutants += 1
            finally:
                child.parents.append(parent)
    writes = sum(1 for e in window for _k, m in e.arg_modes() if m.writes)
    if writes >= 4:
        assert mutants >= 1, "no dropped edge ever uncovered a pair"


# ----------------------------------------------------------------------
# Sanitizer
# ----------------------------------------------------------------------

def _mk_element(args, name, cost=1e-3):
    return ComputationalElement(fn=None, args=tuple(args), name=name,
                                cost_s=cost)


def test_sanitizer_unit_detects_all_three_race_shapes():
    s = tcore.make_scheduler("parallel", simulate=True)
    a = s.array(np.ones(16, np.float32), name="a")
    const, out = tcore.const, tcore.out

    san = Sanitizer()
    san.pre_exec(_mk_element([out(a)], "W1"))
    with pytest.raises(SanitizerError, match="WAW"):
        san.pre_exec(_mk_element([out(a)], "W2"))

    san = Sanitizer()
    san.pre_exec(_mk_element([const(a)], "R"))
    with pytest.raises(SanitizerError, match="WAR"):
        san.pre_exec(_mk_element([out(a)], "W"))

    san = Sanitizer()
    san.pre_exec(_mk_element([out(a)], "W"))
    with pytest.raises(SanitizerError, match="RAW"):
        san.pre_exec(_mk_element([const(a)], "R"))
    assert san.races_detected == 1
    s.shutdown()


def test_sanitizer_detects_torn_read():
    s = tcore.make_scheduler("parallel", simulate=True)
    a = s.array(np.ones(16, np.float32), name="a")
    san = Sanitizer()
    r = _mk_element([tcore.const(a)], "R")
    san.pre_exec(r)
    san._state[r.args[0].key].version += 1      # a write the hooks never saw
    with pytest.raises(SanitizerError, match="torn read"):
        san.post_exec(r)
    s.shutdown()


def test_sanitizer_checksum_catches_write_through_const_on_host():
    s = tcore.make_scheduler("parallel", device="cpu")
    a = s.array(np.ones(16, np.float32), name="a")   # host-only value
    san = Sanitizer(checksums=True)
    e = _mk_element([tcore.const(a)], "R")
    san.pre_exec(e)
    a.host[0] += 1.0                  # in-place mutation the DAG cannot see
    with pytest.raises(SanitizerError, match="write through const"):
        san.post_exec(e)
    s.shutdown()


def test_sim_executor_overlap_raises_through_hooks():
    s = tcore.make_scheduler("parallel", simulate=True, sanitize=True)
    a = s.array(np.ones(16, np.float32), name="a")
    e1 = _mk_element([tcore.out(a)], "W1")
    e2 = _mk_element([tcore.out(a)], "W2")
    s.executor.submit(e1, 0, ())
    with pytest.raises(SanitizerError, match="WAW"):
        s.executor.submit(e2, 1, ())
    assert s.stats()["sanitizer_races_detected"] == 1


def test_sanitize_off_installs_no_hooks_and_is_bit_identical():
    def run(sanitize):
        s = tcore.make_scheduler("parallel", sanitize=sanitize, device="cpu")
        if not sanitize:
            assert s.executor.pre_exec is None
            assert s.executor.post_exec is None
            assert s.sanitizer is None
        x = s.array(np.linspace(0.25, 4.0, 512).astype(np.float32))
        y = s.array(shape=(512,), dtype=np.float32)
        z = s.array(shape=(512,), dtype=np.float32)
        sq = tgr.function(lambda a, b: (a * a,), modes=("const", "out"),
                          name="good_sq", scheduler=s)
        add = tgr.function(lambda a, b, c: (a + b,),
                           modes=("const", "const", "out"), name="good_add",
                           scheduler=s)
        sq(x, y)
        add(x, y, z)
        result = np.array(z)
        if sanitize:
            st_ = s.stats()
            assert st_["sanitizer_elements_checked"] > 0
            assert st_["sanitizer_races_detected"] == 0
        s.sync()
        s.shutdown()
        return result

    plain, sane = run(False), run(True)
    assert plain.tobytes() == sane.tobytes()


def test_sanitized_scheduler_runs_clean_scenarios_green():
    from repro_torch.benchsuite import build_task_parallel
    s = tcore.make_scheduler("parallel", simulate=True, sanitize=True)
    build_task_parallel(s, branches=3, chain=3, n=1 << 10)
    s.sync()
    st_ = s.stats()
    assert st_["sanitizer_elements_checked"] > 0
    assert st_["sanitizer_races_detected"] == 0
    with s.capture("tp2"):                    # verified at capture time
        build_task_parallel(s, branches=2, chain=2, n=1 << 10)
    s.sync()
    s.verify()
    s.shutdown()


def test_sanitized_plans_verify_on_cpu_lanes():
    """Capture-time and planopt plan verification under ``sanitize=True``
    on CPU lanes: VEC recorded and replayed, and an out-of-core capture
    under a budget that the plan optimizer rewrites; ``verify()`` after."""
    from repro_torch.benchsuite import (BENCHMARKS, build_outofcore,
                                        verify_outofcore, working_set_bytes)
    bench = BENCHMARKS["VEC"]
    data = bench.make_data(1e-4, seed=0)
    s = tcore.make_scheduler("parallel", device="cpu", sanitize=True)
    try:
        outs = []
        for _ in range(2):
            with s.capture("VEC"):
                outs.append(bench.build(s, data, gpu=None, iters=1))
            s.sync()
        s.verify()
        st_ = s.stats()
    finally:
        s.shutdown()
    assert (st_["plan_records"], st_["plan_replays"]) == (1, 1)
    assert st_["sanitizer_races_detected"] == 0
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])

    chunks, n = 6, 1 << 10
    s = tcore.make_scheduler("parallel", device="cpu", sanitize=True,
                             plan_optimize=True,
                             memory_budget=working_set_bytes(chunks, n) // 2)
    try:
        for _ in range(3):
            with s.capture("ooc"):
                arrs = build_outofcore(s, chunks=chunks, n=n)
            s.sync()
        plan = s.plan_cache.candidates("ooc")[0]
        assert plan.optimized and plan.mem_scheduled
        assert verify_outofcore(arrs)
        s.verify()
        assert s.stats()["plan_replays"] == 2
    finally:
        s.shutdown()


def test_sanitizer_stats_match_reference_on_simulated_program():
    """The reference's counters agree; the port adds ``sanitizer_digests``
    (0 here: the simulator has no values to digest)."""
    def run(core):
        bench = importlib.import_module(
            core.__name__.replace(".core", ".benchsuite"))
        s = core.make_scheduler("parallel", simulate=True, sanitize=True,
                                plan_optimize=True, num_devices=2,
                                placement="round-robin")
        bench.build_task_parallel(s, branches=3, chain=3, n=1 << 10)
        for _ in range(2):
            with s.capture("tp"):
                bench.build_locality_heavy(s, groups=2, iters=3, n=1 << 10)
            s.sync()
        st_ = s.stats()
        s.shutdown()
        return {k: v for k, v in st_.items() if k.startswith("sanitizer_")
                or k in ("elements", "plan_replays")}

    got, want = run(tcore), run(jcore)
    assert got.pop("sanitizer_digests") == 0
    assert got == want
    assert got["sanitizer_elements_checked"] > 0


def test_sanitizer_canary_catches_inplace_const_write_on_cpu_lanes():
    s = tcore.make_scheduler("parallel", device="cpu", sanitize=True)
    x = s.array(np.ones(16, np.float32), name="cx")
    y = s.array(shape=(16,), dtype=np.float32, name="cy")

    def mutates(a, _o):
        a.add_(1.0)
        return a * 2.0

    bad = tgr.function(mutates, modes=("const", "out"), name="bad_mutates",
                       scheduler=s)
    bad(x, y)
    with pytest.raises(SanitizerError, match="write through const on array "
                                             "'cx'"):
        s.sync()
    st_ = s.stats()
    assert st_["sanitizer_races_detected"] == 1
    assert st_["sanitizer_digests"] == 2        # before and after the kernel
    s.shutdown()


def test_sanitizer_waw_race_between_two_cpu_lanes():
    s = tcore.make_scheduler("parallel", device="cpu", sanitize=True)
    a = s.array(np.ones(16, np.float32), name="ra")
    started = threading.Event()

    def slow(_o):
        started.set()
        time.sleep(0.3)
        return torch.zeros(16)

    e1 = ComputationalElement(fn=slow, args=(tcore.out(a),), name="W1")
    e2 = ComputationalElement(fn=lambda _o: torch.ones(16),
                              args=(tcore.out(a),), name="W2")
    s.executor.submit(e1, 0, ())
    assert started.wait(10.0)
    s.executor.submit(e2, 1, ())
    with pytest.raises(SanitizerError, match="WAW"):
        s.executor.wait(e2)
    s.executor.wait(e1)
    s.shutdown()


def test_sanitizer_canary_refuses_a_value_it_cannot_digest():
    from repro_torch.core.managed import ManagedValue
    s = tcore.make_scheduler("parallel", device="cpu", sanitize=True)
    v = ManagedValue(s, object(), name="opaque")
    y = s.array(shape=(4,), dtype=np.float32)
    s.launch(lambda _v, _o: torch.zeros(4), [tcore.const(v), tcore.out(y)],
             name="K")
    with pytest.raises(SanitizerError, match="cannot digest"):
        s.sync()
    s.shutdown()


def _digest_cases():
    rng = np.random.RandomState(0)
    f32 = rng.randn(7, 9).astype(np.float32)
    return {
        "float32": f32,
        "float64": rng.randn(33),
        "int32": rng.randint(-9, 9, size=(5, 4)).astype(np.int32),
        "bool odd": rng.rand(13) > 0.5,
        "int8 odd": rng.randint(-100, 100, size=11).astype(np.int8),
        "float16 odd": rng.randn(5).astype(np.float16),
        "bf16": rng.randn(3, 5).astype(BF16),
        "empty": np.zeros((0, 3), np.float32),
    }


@pytest.mark.parametrize("case", sorted(_digest_cases()))
def test_digest_is_the_same_for_host_and_tensor_of_equal_bytes(case):
    from repro_torch.core.dtypes import to_tensor
    a = _digest_cases()[case]
    t = to_tensor(a).clone()
    assert digest(a) == digest(t)
    if a.size > 1:
        # one element changed, and two different elements swapped
        b = a.copy().reshape(-1)
        b[0] = b[1] if b[0] != b[1] else ~b[0] if b.dtype == bool \
            else b[0] + 1
        assert digest(b) != digest(a)
        flat = a.reshape(-1)
        i, j = next((i, j) for i in range(flat.size)
                    for j in range(i + 1, flat.size)
                    if flat.view(np.uint8)[i * a.itemsize:(i + 1) * a.itemsize]
                    .tobytes() != flat.view(np.uint8)[
                        j * a.itemsize:(j + 1) * a.itemsize].tobytes())
        c = flat.copy()
        c[i], c[j] = flat[j], flat[i]
        assert digest(c) != digest(a)


def test_digest_of_views_and_both_routes(monkeypatch):
    import repro_torch.analysis.sanitizer as san_mod
    a = np.arange(6 * 3001, dtype=np.float32).reshape(6, 3001) * 0.5
    t = torch.from_numpy(a.copy())
    whole = digest(a)
    assert digest(t.t()) == digest(np.ascontiguousarray(a.T))
    assert digest(t[1:4, 3:]) == digest(np.ascontiguousarray(a[1:4, 3:]))
    bf = t.to(torch.bfloat16)[:, 1:]           # odd storage offset, bf16
    assert digest(bf) == digest(bf.contiguous())
    assert digest({"w": t, "b": [t[0], 3]}) == digest({"w": a,
                                                      "b": [a[0], 3]})
    # The int8 matrix product (17 rows of 4 KiB or more) and the
    # elementwise route give the same digest.
    monkeypatch.setattr(san_mod, "_MM_MIN_ROWS", 1 << 30)
    assert digest(a) == whole == digest(t)


def test_digest_tells_uniform_changes_of_power_of_two_arrays_apart():
    """Sums modulo 2**32 lose constant arrays of floats like 1.0 and 2.0
    (23 trailing zero bits, times a power-of-two count); exact sums do
    not."""
    for n in (1 << 20, (1 << 20) + 3, 1 << 12):
        ones = np.ones(n, np.float32)
        assert digest(ones) != digest(ones * 2)
        assert digest(ones) != digest(np.zeros(n, np.float32))
    assert digest(np.zeros(8, np.float32)) != digest(np.zeros(9, np.float32))


# ----------------------------------------------------------------------
# Mode checker: the verdicts tests/test_analysis.py expects
# ----------------------------------------------------------------------

def _inplace_const(x, y):
    x.add_(1.0)
    return (x * 2.0,)


def _inplace_const_behind_the_trace(x, y):
    # A write no trace records (through numpy); only the concrete pass on
    # CPU tensors sees it, as the reference's read-only numpy probe does.
    if x.device.type == "cpu":
        x.numpy()[0] += 1.0
    return (x * 2.0,)


MODE_CASES = {
    "out_reads_input": (lambda x, y: (x + y,), ("const", "out"),
                        ("under", 1, None)),
    "inout_never_read": (lambda x, y: (x * 2.0,), ("const", "inout"),
                         ("over", 1, None)),
    "more_outputs_than_writable": (lambda x: (x * 2.0, x + 1.0),
                                   ("const",), ("under", None, None)),
    "declared_write_never_happens": (lambda x, y, z: (x * 2.0,),
                                     ("const", "out", "out"),
                                     ("over", None, None)),
    "inplace_const_mutation": (_inplace_const, ("const", "out"),
                               ("under", 0, "const")),
    "inplace_const_mutation_behind_the_trace": (
        _inplace_const_behind_the_trace, ("const", "out"),
        ("under", 0, "const")),
    "clean": (lambda x, y: (x * 2.0,), ("const", "out"), None),
    "shape_only_use_of_out": (lambda x, y: (torch.zeros_like(y) + x,),
                              ("const", "out"), None),
}


@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_mode_checker_seeded_verdicts(case):
    fn, modes, want = MODE_CASES[case]
    report = tan.analyze_function(
        tgr.function(fn, modes=modes, name=f"bad_{case}"))
    assert report.skipped is None, report.skipped
    if want is None:
        assert not report.issues, report.issues
        assert report.reads == (True, False)
        return
    kind, arg, declared = want
    assert any(i.kind == kind and (arg is None or i.arg == arg)
               and (declared is None or i.declared == declared)
               for i in report.issues), report.issues


def test_mode_checker_messages_are_the_references():
    """Each issue kind carries the reference checker's message."""
    import inspect

    import repro.analysis.modes as jmodes
    src = inspect.getsource(jmodes.analyze_function)
    for case in ("out_reads_input", "inout_never_read",
                 "more_outputs_than_writable",
                 "declared_write_never_happens", "inplace_const_mutation"):
        fn, modes, _ = MODE_CASES[case]
        for issue in tan.analyze_function(
                tgr.function(fn, modes=modes, name="bad_msg")).issues:
            head = re.split(r"\d", issue.message)[0][:40]
            assert head.replace("'", "\\'") in src or head in src, head


def test_mode_checker_skips_unanalyzable_never_errors():
    report = tan.analyze_function(
        tgr.function(None, modes=("inout",), name="bad_sim_only"))
    assert report.skipped and not report.issues
    report = tan.analyze_function(
        tgr.function(lambda x, y: (x.item() * y,), modes=("const", "out"),
                     name="bad_data_dependent"))
    assert report.skipped and not report.issues


def _shipped():
    from repro_torch.analysis.cli import _LINT_MODULES
    from repro_torch.core.frontend import GrFunction
    names = set()
    for mod in _LINT_MODULES:
        names |= {v.name for v in vars(importlib.import_module(mod)).values()
                  if isinstance(v, GrFunction)}
    return names


def test_mode_checker_zero_false_positives_on_shipped_declarations():
    names = _shipped()
    reports = [r for r in tan.lint_functions() if r.function in names]
    assert len(reports) >= 20, "lint swept almost nothing"
    assert sum(r.skipped is None for r in reports) >= 20
    bad = [str(i) for r in reports for i in r.issues]
    assert not bad, bad


def test_lint_leaves_no_trace_in_module_caches_and_kernels_still_run():
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch.benchsuite import kernels as K
    tan.lint_functions()
    for (name, dev, _dt), w in K._FILTERS.items():
        assert not isinstance(w, FakeTensor), name
        assert w.device == dev, (name, dev, w.device)
    img = torch.rand(8, 8, generator=torch.Generator().manual_seed(0))
    got = K.BLUR_S.fn(img, None)
    want = torch.nn.functional.conv2d(
        img[None, None], torch.from_numpy(K._gauss_kernel(3, 1.0))[None, None],
        padding="same")[0, 0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert K.SOBEL.fn(img, None).shape == (8, 8)


# ----------------------------------------------------------------------
# Journal auditor
# ----------------------------------------------------------------------

def _record(jid, edges, state, t0=100.0):
    trans = [[src, dst, t0 + i] for i, (src, dst) in enumerate(edges)]
    return {"t": t0, "job": {"job_id": jid, "kind": "sleep", "params": {},
                             "tenant": "default", "priority": 0,
                             "deadline_s": None, "submit_t": t0,
                             "state": state, "reason": "", "result": None,
                             "attempts": 1, "transitions": trans}}


_GOOD_EDGES = [("queued", "admitted"), ("admitted", "running"),
               ("running", "finished")]


def _journal_lines(case):
    if case == "clean":
        return [_record("j1", _GOOD_EDGES[:1], "admitted"),
                _record("j1", _GOOD_EDGES[:2], "running"),
                _record("j1", _GOOD_EDGES, "finished"),
                _record("j2", [("queued", "cancelled")], "cancelled")]
    if case == "torn_tail":
        return [_record("j1", _GOOD_EDGES[:1], "admitted"),
                _record("j1", _GOOD_EDGES[:2], "running"),
                _record("j1", _GOOD_EDGES, "finished"),
                '{"t": 1, "job": {"job_id": "j2", "trunca']
    if case == "illegal_edge":
        return [_record("j1", [("queued", "running"),
                               ("running", "finished")], "finished")]
    if case == "rewrite":
        return [_record("j1", _GOOD_EDGES[:2], "running"),
                _record("j1", [("queued", "cancelled")], "cancelled")]
    if case == "state_mismatch":
        return [_record("j1", _GOOD_EDGES, "running")]
    if case == "nonmonotone":
        rec = _record("j1", _GOOD_EDGES, "finished")
        rec["job"]["transitions"][2][2] = 1.0
        return [rec]
    if case == "torn_middle":
        return [_record("j1", _GOOD_EDGES[:1], "admitted"),
                '{"t": 1, "job": {"job_id": "j1", "trunc',
                _record("j1", _GOOD_EDGES[:2], "running")]
    assert case == "empty_history"
    return [_record("j1", [], "running")]


def _write_journal(tmp_path, lines, name="jobs.jsonl"):
    path = tmp_path / name
    path.write_text("".join((rec if isinstance(rec, str)
                             else json.dumps(rec)) + "\n" for rec in lines))
    return str(path)


JOURNAL_NEEDLES = {"clean": None, "torn_tail": None,
                   "illegal_edge": "illegal", "rewrite": "rewritten",
                   "state_mismatch": "last transition",
                   "nonmonotone": "precedes", "torn_middle": "torn record",
                   "empty_history": "empty transition"}


@pytest.mark.parametrize("case", list(JOURNAL_NEEDLES))
def test_journal_audit_matches_reference(case, tmp_path):
    path = _write_journal(tmp_path, _journal_lines(case))
    got = tan.audit_journal(path)
    assert got.to_json() == jan.audit_journal(path).to_json()
    needle = JOURNAL_NEEDLES[case]
    if needle is None:
        assert got.ok and got.jobs >= 1
        assert got.torn_tail == (case == "torn_tail")
    else:
        assert not got.ok
        assert any(needle in p for p in got.problems), got.problems


def test_journal_audit_of_a_missing_file_matches_reference(tmp_path):
    path = str(tmp_path / "absent.jsonl")
    assert tan.audit_journal(path).to_json() == \
        jan.audit_journal(path).to_json()


def test_ported_lifecycle_matches_reference():
    from repro.daemon import lifecycle as jl
    from repro_torch.daemon import lifecycle as tl
    assert [s.value for s in tl.JobState] == [s.value for s in jl.JobState]
    assert {k.value: sorted(v.value for v in vs)
            for k, vs in tl.LEGAL_TRANSITIONS.items()} == \
        {k.value: sorted(v.value for v in vs)
         for k, vs in jl.LEGAL_TRANSITIONS.items()}
    job = tl.JobRecord(job_id="j", kind="sleep", submit_t=1.0)
    job.transition(tl.JobState.ADMITTED, t=2.0)
    with pytest.raises(tl.IllegalTransitionError):
        job.transition(tl.JobState.QUEUED, t=3.0)
    bad = [("queued", "running", 1.0), ("running", "admitted", 0.5)]
    assert tl.validate_history(bad, check_times=True) == \
        jl.validate_history(bad, check_times=True)
    assert tl.JobRecord.from_json(job.to_json()).to_json() == job.to_json()


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

def test_cli_lint_exits_zero(capsys):
    from repro_torch.analysis.cli import main
    assert main(["lint"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"lint: \d+ declaration\(s\), 0 issue\(s\)", out), out


def test_cli_verify_plan_prints_the_references_lines(capsys):
    from repro.analysis.cli import main as jmain
    from repro_torch.analysis.cli import main as tmain

    def lines(main, argv):
        assert main(argv) == 0
        return [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("verify-plan:")]

    got = lines(tmain, ["verify-plan", "--device", "cpu"])
    assert got == lines(jmain, ["verify-plan"])
    assert got[-1] == "verify-plan: 0 violation(s)"


def test_cli_audit_journal_exit_codes(tmp_path, capsys):
    from repro.analysis.cli import main as jmain
    from repro_torch.analysis.cli import main as tmain
    clean = _write_journal(tmp_path, _journal_lines("clean"), "a.jsonl")
    bad = _write_journal(tmp_path, _journal_lines("torn_middle"), "b.jsonl")
    assert tmain(["audit-journal", clean]) == 0
    assert tmain(["audit-journal", clean, bad]) == 1
    out = capsys.readouterr().out
    assert "torn record" in out
    assert tmain(["audit-journal", "--json", bad]) == 1
    got = capsys.readouterr().out
    assert jmain(["audit-journal", "--json", bad]) == 1
    want = capsys.readouterr().out
    assert got.splitlines()[:-1] == want.splitlines()[:-1]


# ----------------------------------------------------------------------
# bf16 managed arrays across host and device (CPU lanes)
# ----------------------------------------------------------------------

def _bf16_program(core, gr, kernels, **kw):
    """Upload of a bf16 host array, a bf16 ``out`` placeholder written by
    a kernel, host reads, and (under a budget) spills and reloads."""
    n = 256
    rng = np.random.RandomState(3)
    s = core.make_scheduler("parallel", **kw)
    try:
        xs = [s.array(rng.randn(n).astype(BF16), name=f"bx{i}")
              for i in range(4)]
        ys = [s.array(shape=(n,), dtype=BF16, name=f"by{i}")
              for i in range(4)]
        f32 = s.array(shape=(n,), dtype=np.float32, name="bf32")
        dbl = gr.function(kernels["dbl"], modes=("const", "out"),
                          name="dbl", scheduler=s)
        widen = gr.function(kernels["widen"], modes=("const", "out"),
                            name="widen", scheduler=s)
        for x, y in zip(xs, ys):
            dbl(x, y)
        widen(xs[0], f32)
        # Read ys in reverse: under a budget the first ones were spilled.
        out = {f"y{i}": np.asarray(ys[i]).copy() for i in (3, 2, 1, 0)}
        out["f32"] = np.asarray(f32).copy()
        dbl(ys[0], xs[1])                       # a bf16 result read back in
        out["x1"] = np.asarray(xs[1]).copy()
        stats = s.stats()
        s.sync()
        return out, stats
    finally:
        s.shutdown()


def _jax_kernels():
    import jax.numpy as jnp
    return {"dbl": lambda a, _o: a * 2, "widen": lambda a, _o:
            a.astype(jnp.float32)}


TORCH_KERNELS = {"dbl": lambda a, _o: a * 2,
                 "widen": lambda a, _o: a.to(torch.float32)}


@pytest.mark.parametrize("spill", ["none", "flat", "compressed-host",
                                   "disk"])
def test_bf16_round_trips_on_cpu_lanes_match_reference(spill):
    kw = {}
    if spill != "none":
        kw["memory_budget"] = int(256 * 2 * 3.5)
    if spill in ("compressed-host", "disk"):
        kw["spill_tiers"] = [spill]
    got, gstats = _bf16_program(tcore, tgr, TORCH_KERNELS, device="cpu",
                                **kw)
    # The reference's disk tier cannot reload bf16 (np.load gives raw
    # 2-byte records); its unspilled run gives the same values.
    want, _ = _bf16_program(jcore, jgr, _jax_kernels(),
                            **({} if spill == "disk" else kw))
    for k, ref in want.items():
        assert got[k].dtype == ref.dtype, k
        assert got[k].tobytes() == ref.tobytes(), k
    assert got["y0"].dtype == BF16
    if spill in ("compressed-host", "disk"):
        assert gstats["mem_tiers"][spill]["spills"] > 0
    elif spill == "flat":
        assert gstats["mem_spills"] > 0


def test_bf16_host_read_without_ml_dtypes_raises_a_clear_error(monkeypatch):
    """numpy has no bfloat16: bringing a bf16 tensor to the host needs
    ``ml_dtypes``, imported then and not before; without it the read
    says so instead of failing deep inside numpy or torch."""
    import builtins

    from repro_torch.core.dtypes import to_numpy
    real_import = builtins.__import__

    def no_ml_dtypes(name, *a, **kw):
        if name == "ml_dtypes":
            raise ImportError("no module named ml_dtypes")
        return real_import(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_ml_dtypes)
    assert to_numpy(torch.ones(3)).dtype == np.float32
    with pytest.raises(ImportError, match="ml_dtypes"):
        to_numpy(torch.ones(3, dtype=torch.bfloat16))


def test_sanitized_serving_digests_the_weights_and_changes_no_token():
    """A ServingEngine on a sanitized scheduler (CPU lanes): the const
    canary digests the model (an ``nn.Module``) and the prompt tokens
    around every batch, sees no race, and the tokens equal an unsanitized
    engine's."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.runtime.serving import ServingEngine
    cfg = get_config("qwen3_32b", reduced=True)
    model = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, 8) for _ in range(4)]

    def serve(sanitize):
        s = tcore.make_scheduler("parallel", device="cpu", sanitize=sanitize)
        eng = ServingEngine(cfg, model, batch_size=2, max_new_tokens=3,
                            scheduler=s, device="cpu")
        try:
            reqs = [eng.submit(p) for p in prompts]
            eng.flush()
            eng.collect()
            return [r.result for r in reqs], s.stats()
        finally:
            eng.close()
            s.shutdown()

    (plain, _), (sane, st_) = serve(False), serve(True)
    assert st_["sanitizer_races_detected"] == 0
    assert st_["sanitizer_digests"] >= 2 * 2 * 2     # 2 batches, 2 const
    for a, b in zip(plain, sane):
        np.testing.assert_array_equal(a, b)
