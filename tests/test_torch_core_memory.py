"""The device-memory manager in the port, the suite of
``tests/test_memory.py`` run on ``repro_torch.core``: budgeted placement,
transparent spill and evict, out-of-core workloads, capture and replay
under budgets, the conservation properties and the concurrency cases.

Each simulated case runs the same program through ``repro.core`` as well
and asserts equal pool stats, LRU order, eviction lists, placements,
``stats()`` and timelines, with the cyclic garbage collector off during
each run so that arrays leave the pools at the same points.  Array keys
differ between the packages (each
numbers its arrays from a process-wide counter), so keys are compared
relative to the scenario's first array.  The real-executor cases run on
CPU lanes with torch kernels; the out-of-core one also holds the port's
memory stats equal to the reference's real executor's.
"""
import gc
import threading
import time

import numpy as np
import pytest

from _hypothesis_fallback import given, settings, st
from _torch_memory_check import _verify_torch_memory_accounting  # noqa: F401

import repro.benchsuite.outofcore as JO
import repro.core as J
import repro_torch.benchsuite.outofcore as TO
import repro_torch.api as tgr
import repro_torch.core as T

from _torch_core_programs import (assert_conservation, capture_demotion,
                                  concurrent_stress)

N = 256
CHUNK = 4 * N
OOC = {T: TO, J: JO}


def _stage_fn(x, o):
    return x * 2.0 + 1.0


def _add_fn(a, b, o):
    return a + b


STAGES = {c: (c.function(_stage_fn, modes=("const", "out"),
                         name="mem_stage", outputs=0),
              c.function(_add_fn, modes=("const", "const", "out"),
                         name="mem_stage2", outputs=0)) for c in (T, J)}


def _stage(c, sched, cost_s=1e-4):
    return STAGES[c][0].with_options(scheduler=sched, cost_s=cost_s)


def _mem(sched):
    return {k: v for k, v in sched.stats().items() if k.startswith("mem_")}


def _spans(sched):
    return [(sp.name, sp.kind, sp.lane, sp.t0, sp.t1)
            for sp in sched.timeline.spans]


def _evicts(elements):
    """The EVICT elements in issue order: victim, bytes written back and
    parents by name."""
    return [(e.args[0].array.name, e.transfer_bytes,
             sorted(p.name for p in e.parents))
            for e in elements if e.kind.name == "EVICT"]


def _kernel_devices(elements):
    return [(e.name, e.device) for e in elements if e.kind.name == "KERNEL"]


def _pools(c, sched, first):
    """Each pool's resident bytes, peak and LRU order, keys relative to
    the scenario's first array."""
    base = c.dep_key(first)
    return [(p.resident_bytes, p.peak_bytes,
             [k - base for k in p.lru_keys()]) for p in sched.memory.pools]


def _without_collector(run, c):
    """``run(c)`` with the cyclic garbage collector off: an array that
    dies in a reference cycle then leaves its pool at the same point of
    the program in both packages, never when a collection happens to
    start."""
    gc.collect()
    gc.disable()
    try:
        return run(c)
    finally:
        gc.enable()


def both(run):
    got, want = _without_collector(run, T), _without_collector(run, J)
    assert got == want
    return got


def assert_stack_conservation(sched, arrays):
    """Device pools plus host-side tier residency account for exactly the
    device-valid and tier-backed bytes."""
    assert_conservation(sched, arrays)
    expect = sum(a.nbytes for a in arrays
                 if a.device_valid or getattr(a, "backing_tier", None))
    got = (sum(p.resident_bytes for p in sched.memory.pools)
           + sum(t.resident_bytes for t in sched.memory.tiers
                 if t.location == "host"))
    assert got == expect, f"stack: tracked {got} != actual {expect}"
    assert sched.memory.verify().ok


# ======================================================================
# MemoryPool unit behaviour
# ======================================================================

def test_pool_budget_lru_and_stats():
    def run(c):
        p = c.MemoryPool(0, budget_bytes=100)
        p.add(1, 40)
        p.add(2, 40)
        assert p.resident_bytes == 80 and p.peak_bytes == 80
        p.touch(1)                       # 2 becomes LRU
        assert p.lru_keys() == [2, 1]
        assert p.discard(2) == 40
        assert p.resident_bytes == 40 and p.peak_bytes == 80
        assert p.fits(100) and not p.fits(101)
        assert c.MemoryPool(0).fits(1 << 60)
        return p.stats(), p.lru_keys(), p.occupancy
    both(run)


def test_pool_re_add_updates_bytes():
    def run(c):
        p = c.MemoryPool(0)
        p.add(1, 10)
        p.add(1, 30)                     # same key, new size
        assert p.resident_bytes == 30
        return p.stats(), p.lru_keys()
    both(run)


# ======================================================================
# Spill/evict on the simulator and the real executor
# ======================================================================

def test_out_of_core_sim_spills_within_budget():
    def run(c):
        o = OOC[c]
        budget = o.working_set_bytes(6, N) // 2
        s_unl = c.make_scheduler("parallel", simulate=True)
        o.build_outofcore(s_unl, chunks=6, n=N)
        s_unl.sync()
        s = c.make_scheduler("parallel", simulate=True, memory_budget=budget)
        arrays = o.build_outofcore(s, chunks=6, n=N)
        evicts = _evicts(s._elements)
        s.sync()
        st = _mem(s)
        assert st["mem_spills"] >= 1
        assert st["mem_resident_bytes"] <= budget
        assert s.memory.pools[0].peak_bytes <= budget
        assert s.timeline.makespan <= 2.0 * s_unl.timeline.makespan
        assert_conservation(s, arrays["x"] + arrays["y"] + arrays["z"])
        assert any(sp.kind == "d2h" and sp.name.startswith("evict_")
                   for sp in s.timeline.spans)
        return (st, evicts, _spans(s), _spans(s_unl),
                _pools(c, s, arrays["x"][0]))
    both(run)


def _ooc_real(c, **kw):
    o = OOC[c]
    s = c.make_scheduler("parallel",
                         memory_budget=o.working_set_bytes(6, N) // 2, **kw)
    try:
        arrays = o.build_outofcore(s, chunks=6, n=N)
        assert o.verify_outofcore(arrays)
        s.sync()
        st = _mem(s)
        assert st["mem_spills"] >= 1
        evicted = [a for a in arrays["x"] + arrays["y"]
                   if not a.device_valid]
        assert evicted and all(a.device is None for a in evicted)
        assert_conservation(s, arrays["x"] + arrays["y"] + arrays["z"])
        assert s.memory.verify(physical=True).ok
        return st, [a.name for a in evicted]
    finally:
        s.close()


def test_out_of_core_real_correct_through_spills():
    """Right values through spills on CPU lanes; the spills, reloads and
    evicted chunks are the reference's real executor's."""
    assert _ooc_real(T, device="cpu") == _ooc_real(J)


def test_unlimited_budget_never_evicts_and_matches_timeline():
    """budget=None and an over-provisioned budget execute the identical
    schedule with zero spill stats."""
    def run(c):
        def one(budget):
            s = c.make_scheduler("parallel", simulate=True,
                                 memory_budget=budget)
            OOC[c].build_outofcore(s, chunks=4, n=N)
            s.sync()
            return _spans(s), _mem(s)
        spans_none, st_none = one(None)
        spans_big, st_big = one(1 << 40)
        assert spans_none == spans_big
        for st_ in (st_none, st_big):
            assert st_["mem_spills"] == 0 and st_["mem_evict_blocks"] == 0
        assert st_none["mem_peak_bytes"] == OOC[c].working_set_bytes(4, N)
        assert not c.make_scheduler("parallel", simulate=True).memory.bounded
        return spans_none, st_none, st_big
    both(run)


def test_evict_is_dag_ordered_after_readers():
    """The EVICT element depends on the victim's in-flight reader."""
    def run(c):
        s = c.make_scheduler("parallel", simulate=True,
                             memory_budget=2 * CHUNK)
        x = s.array(np.ones(N, np.float32), name="ev_x")
        _stage(c, s, cost_s=5e-3)(x)          # slow reader holds x busy
        y = s.array(np.ones(N, np.float32), name="ev_y")
        _stage(c, s, cost_s=1e-4)(y)          # needs 2 chunks: evicts x
        evicts = [e for e in s._elements if e.kind is c.ElementKind.EVICT]
        assert len(evicts) >= 1
        assert evicts[0].args[0].array is x
        kernels = [e for e in s._elements
                   if e.kind is c.ElementKind.KERNEL]
        assert kernels[0].uid in {p.uid for p in evicts[0].parents}
        seen = _evicts(s._elements)
        s.sync()
        assert not x.device_valid and x.host_valid
        return seen, _spans(s), _mem(s)
    both(run)


def test_real_uploads_wait_for_the_evictions_that_make_room():
    """On the real executor nothing lands on a device before the
    evictions submitted ahead of it there have finished: the upload that
    a budget made room for starts after the EVICT of a slow kernel's
    output, which the DAG orders only after that kernel.  Without the
    wait the device holds the budget and the new upload at once."""
    release = threading.Event()

    def slow(x, o):
        release.wait(10.0)
        return x * 2.0 + 1.0

    s = T.make_scheduler("parallel", device="cpu", memory_budget=2 * CHUNK)
    try:
        x = s.array(np.ones(N, np.float32), name="w_x")
        T.function(slow, modes=("const", "out"), name="slow",
                   outputs=0).with_options(scheduler=s)(x)
        y = s.array(np.full(N, 2.0, np.float32), name="w_y")
        z = _stage(T, s)(y)              # evicts x and the slow output
        time.sleep(0.1)
        release.set()
        s.sync()
        spans = s.timeline.spans
        evicts = [sp for sp in spans if sp.name.startswith("evict_")]
        (upload,) = [sp for sp in spans if sp.name == "h2d_w_y"]
        assert len(evicts) == 2
        assert upload.t0 >= max(sp.t1 for sp in evicts)
        np.testing.assert_array_equal(np.asarray(z), np.full(N, 5.0))
        assert_conservation(s, [x, y, z])
    finally:
        s.close()


def test_clean_copies_drop_without_spill_traffic():
    """Arrays whose host copy is still valid are dropped, not written
    back: evict_blocks counts them, spills do not."""
    def run(c):
        s = c.make_scheduler("parallel", simulate=True,
                             memory_budget=3 * CHUNK)
        xs = [s.array(np.ones(N, np.float32), name=f"cl_{i}")
              for i in range(3)]
        for x in xs[:2]:
            _stage(c, s)(x)
        evicts = _evicts(s._elements)
        s.sync()
        st = _mem(s)
        assert st["mem_evict_blocks"] >= 1
        dirty = [e for e in evicts if e[1] > 0]
        assert st["mem_spills"] == len(dirty)
        assert st["mem_evict_blocks"] == len(evicts)
        return st, evicts, _pools(c, s, xs[0])
    both(run)


# ======================================================================
# Budget-aware placement
# ======================================================================

def test_placement_refuses_overbudget_device():
    """Every policy refuses a device whose budget is smaller than the
    element's working set."""
    def run(c):
        s = c.make_scheduler("parallel", simulate=True, num_devices=2,
                             placement="round-robin",
                             memory_budget={0: CHUNK, 1: 64 * CHUNK})
        outs = [_stage(c, s)(s.array(np.ones(N, np.float32), name=f"pl_{i}"))
                for i in range(4)]
        placed = _kernel_devices(s._elements)
        s.sync()
        assert all(o._scheduler is s for o in outs)
        assert placed and all(d == 1 for _, d in placed)
        return placed, _mem(s)
    both(run)


def test_min_pressure_policy_balances_bytes():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True, num_devices=2,
                             placement="min-pressure",
                             memory_budget=8 * CHUNK)
        for i in range(6):
            _stage(c, s)(s.array(np.ones(N, np.float32), name=f"mp_{i}"))
        placed = _kernel_devices(s._elements)
        s.sync()
        per_dev = {d: sum(1 for _, k in placed if k == d) for d in (0, 1)}
        assert per_dev[0] == per_dev[1] == 3
        assert s.streams.placement.name == "min-pressure"
        return placed, _mem(s), _spans(s)
    both(run)


def test_min_pressure_degrades_to_min_load_when_unbounded():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True, num_devices=2,
                             placement="min-pressure")
        for i in range(4):
            _stage(c, s)(s.array(np.ones(N, np.float32), name=f"ml_{i}"))
        placed = _kernel_devices(s._elements)
        s.sync()
        assert {d for _, d in placed} == {0, 1}
        return placed
    both(run)


def test_oversized_working_set_raises():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True, memory_budget=CHUNK)
        x = s.array(np.ones(N, np.float32), name="big")
        with pytest.raises(c.DeviceOutOfMemoryError) as exc:
            _stage(c, s)(x)                  # needs 2 chunks, budget is 1
        return str(exc.value)
    both(run)


# ======================================================================
# Capture/replay under budgets
# ======================================================================

def test_capture_records_device_mem_and_replays_evicts():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True,
                             memory_budget=3 * CHUNK)
        for ep in range(3):
            with s.capture("oc_ep"):
                xs = [s.array(np.zeros(N, np.float32), name=f"ce{ep}_{i}")
                      for i in range(2)]
                for x in xs:
                    _stage(c, s)(x)
            s.sync()
        st = s.stats()
        assert st["plan_records"] == 1 and st["plan_replays"] == 2
        (plan,) = s.plan_cache.candidates("oc_ep")
        assert plan.device_mem and plan.device_mem[0][1] <= 3 * CHUNK
        kinds = [pe.kind.name for pe in plan.elements]
        assert "EVICT" in kinds
        assert st["mem_evict_blocks"] >= 3
        return (_mem(s), st["plan_records"], st["plan_replays"],
                list(plan.device_mem), kinds, _spans(s))
    both(run)


def test_replay_falls_back_to_eager_when_budget_shrinks():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True,
                             memory_budget=16 * CHUNK)

        seen = []

        def episode():
            with s.capture("shrink_ep"):
                xs = [s.array(np.zeros(N, np.float32),
                              name=f"sh{len(seen)}_{i}") for i in range(2)]
                for x in xs:
                    _stage(c, s)(x)
            s.sync()
            st = s.stats()
            seen.append((st["plan_replays"], st["plan_records"]))
            return seen[-1]
        episode()
        episode()
        assert s.stats()["plan_replays"] == 1
        (plan,) = s.plan_cache.candidates("shrink_ep")
        # A budget below the plan's recorded peak: the episode runs eagerly
        # and records a spill-aware plan.
        s.memory.pools[0].budget_bytes = plan.device_mem[0][1] - 1
        assert episode() == (1, 2)
        with pytest.raises(c.DeviceOutOfMemoryError):
            s.replay(plan)
        episode()                            # the new plan replays
        assert s.stats()["plan_replays"] == 2
        return seen, _mem(s), _spans(s)
    both(run)


def test_replay_pins_plan_default_arrays_under_pressure():
    """A replay under foreign memory pressure never evicts an array the
    plan binds later (persistent device-resident weights)."""
    def run(c):
        s = c.make_scheduler("parallel", simulate=True,
                             memory_budget=6 * CHUNK)
        w = s.array(np.ones(N, np.float32), name="pw_w")

        def episode(tag):
            with s.capture("pin_ep"):
                x = s.array(np.ones(N, np.float32), name=f"pw_x{tag}")
                y = _stage(c, s)(x)
                STAGES[c][1].with_options(scheduler=s, cost_s=1e-4,
                                          name="pw_k2")(y, w)
            s.sync()

        for tag in range(3):
            episode(tag)
        assert s.stats()["plan_replays"] == 1
        for i in range(2):
            _stage(c, s)(s.array(np.ones(N, np.float32), name=f"pw_f{i}"))
        s.sync()
        assert w.device_valid
        episode(3)                           # replays: w pinned
        st = s.stats()
        assert st["plan_replays"] == 2
        assert w.device_valid and w.device_id == 0
        assert st["mem_evict_blocks"] >= 1
        return _mem(s), _spans(s), _pools(c, s, w)
    both(run)


# ======================================================================
# Forced H2D for multi-device host-only reads
# ======================================================================

def _forced_h2d(c, simulate, **kw):
    s = c.make_scheduler("parallel", simulate=simulate, num_devices=2,
                         auto_prefetch=False, placement="round-robin", **kw)
    try:
        x0 = s.array(np.full(N, 2.0, np.float32), name="fp_x0")
        x1 = s.array(np.full(N, 3.0, np.float32), name="fp_x1")
        y0 = _stage(c, s)(x0)                # lands on device 0
        y1 = _stage(c, s)(x1)                # lands on device 1
        elements = list(s._elements)
        s.sync()
        h2d = [e for e in elements if e.kind is c.ElementKind.TRANSFER]
        assert {e.args[0].array.name for e in h2d} >= {"fp_x0", "fp_x1"}
        assert x0.device_valid and x1.device_valid
        if not simulate:
            assert np.allclose(np.asarray(y0), 5.0)
            assert np.allclose(np.asarray(y1), 7.0)
        assert_conservation(s, [x0, x1, y0, y1])
        return (sorted(e.args[0].array.name for e in h2d),
                _kernel_devices(elements), _mem(s))
    finally:
        s.close()


@pytest.mark.parametrize("simulate", [True, False])
def test_multidevice_forces_h2d_without_auto_prefetch(simulate):
    """Host-only read arguments are localized on a two-device scheduler
    even with auto_prefetch off; the real case runs on CPU lanes."""
    if simulate:
        both(lambda c: _forced_h2d(c, True))
    else:
        assert _forced_h2d(T, False, device="cpu") == _forced_h2d(J, True)


def test_single_device_auto_prefetch_off_unchanged():
    """The paper's fault-driven single-device mode stays prefetch-free."""
    def run(c):
        s = c.make_scheduler("parallel", simulate=True, auto_prefetch=False)
        _stage(c, s)(s.array(np.ones(N, np.float32), name="sd_x"))
        kinds = [e.kind.name for e in s._elements]
        s.sync()
        assert "TRANSFER" not in kinds
        return kinds, _spans(s)
    both(run)


# ======================================================================
# Capture demotion keeps location bits and residency in lockstep
# ======================================================================

def test_capture_demotion_keeps_bits_and_residency_in_lockstep():
    s = T.make_scheduler("parallel", memory_budget=64 * CHUNK, device="cpu")
    try:
        capture_demotion(tgr, s)
    finally:
        s.close()


def test_host_write_drops_residency_with_device_copy():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True,
                             memory_budget=8 * CHUNK)
        x = s.array(np.ones(N, np.float32), name="hw_x")
        y = _stage(c, s)(x)
        s.sync()
        assert s.memory.pools[0].resident_bytes == 2 * CHUNK
        y.write(np.zeros(N, np.float32))      # host overwrite of the output
        assert not y.device_valid and y.device_id is None
        assert s.memory.pools[0].resident_bytes == CHUNK
        assert_conservation(s, [x, y])
        return _mem(s), _pools(c, s, x)
    both(run)


# ======================================================================
# Concurrent sync against racing launches; conservation properties
# ======================================================================

def test_concurrent_sync_vs_launch_stress():
    s = T.make_scheduler("parallel", num_devices=2,
                         memory_budget=256 * CHUNK, device="cpu")
    try:
        concurrent_stress(tgr, s)
    finally:
        s.close()


def _random_steps(c, seed, s, stage, arrays, tag, cap, check):
    """Twenty random steps (a new array, a stage, a host read, a host
    write), each followed by ``check``; returns per-step ledgers."""
    rng = np.random.RandomState(seed)
    arrays += [s.array(rng.rand(N).astype(np.float32), name=f"{tag}_{i}")
               for i in range(3)]
    trace = []
    for step in range(20):
        op = rng.randint(4)
        if op == 0 and len(arrays) < cap:
            arrays.append(s.array(rng.rand(N).astype(np.float32),
                                  name=f"{tag}_n{step}"))
        elif op == 1:
            arrays.append(stage(arrays[rng.randint(len(arrays))]))
        elif op == 2:
            arrays[rng.randint(len(arrays))].read()
        else:
            arrays[rng.randint(len(arrays))].write(
                rng.rand(N).astype(np.float32))
        check(s, arrays)
        trace.append([p.resident_bytes for p in s.memory.pools])
    s.sync()
    check(s, arrays)
    return trace


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=0, max_value=2 ** 32 - 1))
def test_memory_conservation_property(seed):
    """At every step of a random workload, resident bytes equal the bytes
    of the device-valid arrays, and each step's ledgers, the stats and the
    timeline equal the reference's."""
    def run(c):
        s = c.make_scheduler("parallel", simulate=True, num_devices=2,
                             placement="min-pressure",
                             memory_budget=5 * CHUNK)
        arrays = []
        trace = _random_steps(c, seed, s, _stage(c, s), arrays, "pp", 12,
                              assert_conservation)
        return trace, _mem(s), _spans(s), _pools(c, s, arrays[0])
    both(run)


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=0, max_value=2 ** 32 - 1))
def test_whole_stack_conservation_property(seed):
    """The same under a tier stack (peer device, then compressed host):
    pools plus host-tier residency cover the device-valid and tier-backed
    bytes at every step, ``verify()`` stays clean, and the ledgers equal
    the reference's."""
    def run(c):
        s = c.make_scheduler("parallel", simulate=True, num_devices=2,
                             placement="min-pressure",
                             memory_budget={0: 4 * CHUNK, 1: 3 * CHUNK},
                             spill_tiers=[c.PeerDeviceTier(),
                                          c.CompressedHostTier(lossy=False)])
        arrays = []
        trace = _random_steps(c, seed, s, _stage(c, s), arrays, "ws", 10,
                              assert_stack_conservation)
        tiers = [t.resident_bytes for t in s.memory.tiers]
        s.close()
        return trace, tiers, _mem(s), _spans(s)
    both(run)


def test_replay_budget_gate_with_tier_stack():
    """A plan recorded with tier spills stops replaying when the budget
    shrinks below its recorded peak, a plan for the new budget is
    recorded, and the whole-stack accounting stays exact."""
    def run(c):
        s = c.make_scheduler("parallel", simulate=True,
                             memory_budget=16 * CHUNK,
                             spill_tiers=[c.CompressedHostTier(lossy=False)])
        alive = []

        def episode():
            with s.capture("tshrink_ep"):
                xs = [s.array(np.zeros(N, np.float32),
                              name=f"ts{len(alive)}_{i}") for i in range(2)]
                outs = [_stage(c, s)(x) for x in xs]
            s.sync()
            alive.extend(xs + outs)
            assert_stack_conservation(s, alive)
            st = s.stats()
            return st["plan_replays"], st["plan_records"]

        seen = [episode(), episode()]
        assert seen[-1][0] == 1
        (plan,) = s.plan_cache.candidates("tshrink_ep")
        s.memory.pools[0].budget_bytes = plan.device_mem[0][1] - 1
        seen.append(episode())
        assert seen[-1] == (1, 2)
        with pytest.raises(c.DeviceOutOfMemoryError):
            s.replay(plan)
        seen.append(episode())
        assert seen[-1][0] == 2
        assert_stack_conservation(s, alive)
        out = seen, _mem(s), _spans(s)
        s.close()
        return out
    both(run)
