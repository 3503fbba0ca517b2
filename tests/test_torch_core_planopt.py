"""Plan-time global optimizer of the port (``repro_torch.core.planopt``),
the suite of ``tests/test_planopt.py`` with torch kernels on CPU lanes:
identity guarantees, DAG-equivalence of rewritten plans, bit-identical
results on the real executor, Belady-vs-LRU traffic, and the signature
memoization."""
import numpy as np
import pytest

from _hypothesis_fallback import given, settings, st
from _torch_memory_check import _verify_torch_memory_accounting  # noqa: F401
from repro_torch.benchsuite.multidevice import build_locality_heavy
from repro_torch.benchsuite.outofcore import (build_outofcore,
                                              verify_outofcore,
                                              working_set_bytes)
from repro_torch.core import const, inout, make_scheduler, out
from repro_torch.core.frontend import function
from repro_torch.core.planopt import optimize_plan


def _capture_plan(s, name, builder):
    with s.capture(name):
        builder(s)
    s.sync()
    return s.plan_cache.candidates(name)[0]


def _span_key(s):
    return tuple((sp.name, sp.kind, sp.lane, sp.t0, sp.t1)
                 for sp in s.timeline.spans)


# ----------------------------------------------------------------------
# Identity guarantees: no rewrite -> the same plan object, and disabled /
# eager paths produce bit-identical timelines.
# ----------------------------------------------------------------------

def test_identity_when_nothing_to_improve():
    """Single device, unlimited memory: there is no cut to reduce and no
    schedule to rewrite — the optimizer must return the *same object*."""
    s = make_scheduler("parallel", simulate=True, plan_optimize=False)
    try:
        def build(sc):
            x = sc.array(np.ones(256, np.float32), name="ix")
            y = sc.array(shape=(256,), dtype=np.float32, name="iy")
            sc.launch(None, [const(x), out(y)], name="IK1", cost_s=1e-4)
            sc.launch(None, [inout(y)], name="IK2", cost_s=1e-4)
        plan = _capture_plan(s, "ident", build)
        assert optimize_plan(s, plan) is plan
        assert not plan.optimized and not plan.mem_scheduled
    finally:
        s.shutdown()


def test_eager_timeline_identical_with_optimizer_enabled():
    """The optimizer only runs at capture finalization: plain eager
    execution must be bit-identical whether the flag is on or off."""
    def run(opt):
        s = make_scheduler("parallel", simulate=True, num_devices=2,
                           plan_optimize=opt)
        try:
            build_locality_heavy(s, groups=2, iters=3, n=1 << 10)
            s.sync()
            return _span_key(s)
        finally:
            s.shutdown()
    assert run(True) == run(False)


def test_disabled_optimizer_is_pure_passthrough(monkeypatch):
    """``plan_optimize=False`` must equal an optimizer that returns its
    input unchanged — same spans, same plan flags — proving the capture
    hook itself adds nothing when disabled."""
    def run(opt):
        s = make_scheduler("parallel", simulate=True, num_devices=2,
                           plan_optimize=opt)
        try:
            for _ in range(3):
                with s.capture("pass"):
                    build_locality_heavy(s, groups=2, iters=3, n=1 << 10)
                s.sync()
            plans = s.plan_cache.candidates("pass")
            assert s.stats()["plan_replays"] == 2
            return _span_key(s), [p.optimized for p in plans]
        finally:
            s.shutdown()

    base = run(False)
    import repro_torch.core.planopt as planopt
    monkeypatch.setattr(planopt, "optimize_plan",
                        lambda sched, plan: plan)
    neutered = run(True)
    assert base == neutered


# ----------------------------------------------------------------------
# Property: the optimized plan is DAG-equivalent to the greedy one —
# every true data dependency (RAW/WAR/WAW) between original kernels is
# still ordered after the rewrite.
# ----------------------------------------------------------------------

def _order_pairs(plan):
    """(ancestor_name, descendant_name) for every ordered kernel pair."""
    anc = [set() for _ in plan.elements]
    for i, pe in enumerate(plan.elements):
        for p in pe.parents:
            anc[i].add(p)
            anc[i] |= anc[p]
    names = {i: plan.elements[i].name for i in plan.kernel_positions}
    return {(names[i], names[j])
            for j in plan.kernel_positions for i in anc[j] & names.keys()}


def _data_dep_pairs(plan):
    """The pairs that MUST stay ordered: per-slot RAW/WAR/WAW between the
    plan's kernels, derived from access modes alone (movement-element
    artifacts like read-read migration ordering are excluded — they are
    placement-dependent, not semantic)."""
    pairs, lw, readers = set(), {}, {}
    for i in plan.kernel_positions:
        pe = plan.elements[i]
        merged = {}
        for slot, mode in pe.arg_slots:
            prev = merged.get(slot)
            if prev is None or (mode.writes and not prev.writes):
                merged[slot] = mode
        for slot, mode in merged.items():
            if slot in lw and lw[slot] != pe.name:
                pairs.add((lw[slot], pe.name))      # RAW / WAW
            if mode.writes:
                for r in readers.get(slot, ()):
                    if r != pe.name:
                        pairs.add((r, pe.name))     # WAR
        for slot, mode in merged.items():
            if mode.writes:
                lw[slot] = pe.name
                readers[slot] = []
            else:
                readers.setdefault(slot, []).append(pe.name)
    return pairs


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10 ** 6))
def test_optimized_plan_is_dag_equivalent(seed):
    rng = np.random.RandomState(seed)
    narr = int(rng.randint(3, 7))
    ops = []
    for k in range(int(rng.randint(4, 12))):
        w = int(rng.randint(narr))
        nread = int(rng.randint(0, 3))
        reads = [int(x) for x in rng.choice(narr, size=nread, replace=False)]
        ops.append((k, [r for r in reads if r != w], w))

    s = make_scheduler("parallel", simulate=True, num_devices=2,
                       plan_optimize=False)
    try:
        def build(sc):
            arrs = [sc.array(np.zeros(256, np.float32), name=f"pa{i}")
                    for i in range(narr)]
            for k, reads, w in ops:
                args = [const(arrs[r]) for r in reads] + [inout(arrs[w])]
                sc.launch(None, args, name=f"pk{k}", cost_s=1e-4)
        plan = _capture_plan(s, f"prop{seed}", build)
        new = optimize_plan(s, plan)
        required = _data_dep_pairs(plan)
        assert required <= _order_pairs(plan)       # sanity: greedy has them
        assert required <= _order_pairs(new)        # the rewrite keeps them
        # Kernel sequence itself is preserved verbatim.
        assert [new.elements[i].name for i in new.kernel_positions] \
            == [plan.elements[i].name for i in plan.kernel_positions]
    finally:
        s.shutdown()


# ----------------------------------------------------------------------
# Real executor: optimized replays produce bit-identical results on 1-
# and 2-device configs, including budgeted (Belady) replays.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 2])
def test_optimized_replay_bit_identical_on_real_executor(ndev):
    sq = lambda a, _o: a * a + 1.0
    mix = lambda a, b, _o: a * 0.5 + b

    def run(opt):
        s = make_scheduler("parallel", num_devices=ndev, plan_optimize=opt,
                           device="cpu")
        try:
            outs = []
            for _ in range(3):
                rng = np.random.RandomState(11)
                x = s.array(rng.randn(256).astype(np.float32), name="bx")
                y = s.array(rng.randn(256).astype(np.float32), name="by")
                u = s.array(shape=(256,), dtype=np.float32, name="bu")
                v = s.array(shape=(256,), dtype=np.float32, name="bv")
                w = s.array(shape=(256,), dtype=np.float32, name="bw")
                with s.capture("bit"):
                    s.launch(sq, [const(x), out(u)], name="SQ1", cost_s=1e-4)
                    s.launch(sq, [const(y), out(v)], name="SQ2", cost_s=1e-4)
                    s.launch(mix, [const(u), const(v), out(w)], name="MIX",
                             cost_s=1e-4)
                outs.append(np.asarray(w).copy())
            assert s.stats()["plan_replays"] >= 1
            return outs
        finally:
            s.shutdown()

    for b, o in zip(run(False), run(True)):
        assert np.array_equal(b, o)


def test_optimized_budgeted_replay_correct_on_real_executor():
    ws = working_set_bytes(6, 1 << 10)
    s = make_scheduler("parallel", memory_budget=ws // 2, plan_optimize=True,
                       device="cpu")
    try:
        for _ in range(3):
            with s.capture("oocr"):
                arrs = build_outofcore(s, chunks=6, n=1 << 10)
            s.sync()
        st = s.stats()
        assert st["plan_replays"] == 2
        plans = s.plan_cache.candidates("oocr")
        assert plans and plans[0].optimized and plans[0].mem_scheduled
        assert st["mem_evicts_scheduled"] > 0
        assert verify_outofcore(arrs)
        assert s.memory.verify().ok
    finally:
        s.shutdown()


# ----------------------------------------------------------------------
# Belady vs reactive LRU on the out-of-core scenario (sim)
# ----------------------------------------------------------------------

def test_belady_reduces_spill_plus_reload_traffic():
    def run(opt):
        ws = working_set_bytes(6, 1 << 10)
        s = make_scheduler("parallel", simulate=True,
                           memory_budget=ws // 2, plan_optimize=opt)
        try:
            for _ in range(3):
                with s.capture("ooc"):
                    build_outofcore(s, chunks=6, n=1 << 10)
                s.sync()
            st = s.stats()
            assert st["plan_replays"] == 2      # the rewritten plan sticks
            return st
        finally:
            s.shutdown()

    lru = run(False)
    bel = run(True)
    assert bel["mem_spill_bytes"] <= lru["mem_spill_bytes"]
    assert (bel["mem_spill_bytes"] + bel["mem_reload_bytes"]
            < lru["mem_spill_bytes"] + lru["mem_reload_bytes"])
    assert bel["mem_evicts_scheduled"] > 0


# ----------------------------------------------------------------------
# Min-cut placement: D2D bytes drop, user pins are immovable
# ----------------------------------------------------------------------

def test_mincut_placement_cuts_d2d_bytes_and_keeps_results():
    from repro_torch.core.element import ElementKind

    def run(opt):
        s = make_scheduler("parallel", simulate=True, num_devices=2,
                           placement="round-robin", plan_optimize=opt)
        try:
            for _ in range(3):
                with s.capture("loc"):
                    build_locality_heavy(s, groups=2, iters=4, n=1 << 12)
                s.sync()
            plans = s.plan_cache.candidates("loc")
            d2d = sum(pe.transfer_bytes for p in plans for pe in p.elements
                      if pe.kind is ElementKind.D2D)
            return d2d, s.timeline.makespan, s.stats()["plan_replays"]
        finally:
            s.shutdown()

    d2d_g, mk_g, rep_g = run(False)
    d2d_o, mk_o, rep_o = run(True)
    assert rep_g == rep_o == 2
    assert d2d_g > 0                    # round-robin bounces the arrays
    assert d2d_o <= d2d_g * 0.8         # a reduction of 20% or more
    assert mk_o <= mk_g * (1 + 1e-9)


def test_user_pinned_kernels_never_move():
    stage = function(None, modes=("inout",), name="pin_k",
                     parallel_fraction=1.0)
    s = make_scheduler("parallel", simulate=True, num_devices=2,
                       placement="round-robin", plan_optimize=True)
    try:
        fn = stage.with_options(scheduler=s, cost_s=1e-4)
        with s.capture("pin"):
            x = s.array(np.zeros(1 << 12, np.float32), name="pinx")
            y = s.array(np.zeros(1 << 12, np.float32), name="piny")
            for i in range(4):
                fn.with_options(name=f"pinned_{i}", device=1)(x)
                fn.with_options(name=f"free_{i}")(y)
        s.sync()
        plan = s.plan_cache.candidates("pin")[0]
        for i in plan.kernel_positions:
            pe = plan.elements[i]
            if pe.name.startswith("pinned_"):
                assert pe.pinned and pe.device == 1
    finally:
        s.shutdown()


# ----------------------------------------------------------------------
# Satellite: memoized structural signature
# ----------------------------------------------------------------------

def test_plan_signature_memoized_and_stable():
    s = make_scheduler("parallel", simulate=True, plan_optimize=False)
    try:
        def build(sc):
            x = sc.array(np.ones(128, np.float32), name="sx")
            sc.launch(None, [inout(x)], name="SK", cost_s=1e-4)
        plan = _capture_plan(s, "sig", build)
        sig = plan.signature
        assert plan.signature is sig            # memoized, not re-walked
        assert hash(sig) == hash(plan.signature)
        # The raw tuple still compares equal (cache probes mix both forms).
        assert sig == (plan.elements, plan.slots, plan.device_mem)
    finally:
        s.shutdown()
