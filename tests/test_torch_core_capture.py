"""Graph capture & replay in the port (``repro_torch.core.capture``), the
suite of ``tests/test_capture.py`` with torch kernels on CPU lanes: plan
recording, cache keying/invalidation, replay correctness (real executor)
and replay performance (simulator vs the CUDA-Graphs oracle of §V-D)."""
import statistics

import numpy as np
import pytest

from _torch_memory_check import _verify_torch_memory_accounting  # noqa: F401
from repro_torch.core import const, inout, make_scheduler, out


def _episode(s, n=1024, cost=1e-4, tag=""):
    """VEC-shaped episode: two squares + a reduce, fresh arrays."""
    x1 = s.array(np.ones(n, np.float32), name=f"x1{tag}")
    x2 = s.array(np.full(n, 2.0, np.float32), name=f"x2{tag}")
    y1 = s.array(shape=(n,), dtype=np.float32, name=f"y1{tag}")
    y2 = s.array(shape=(n,), dtype=np.float32, name=f"y2{tag}")
    z = s.array(shape=(n,), dtype=np.float32, name=f"z{tag}")
    s.launch(None, [const(x1), out(y1)], name="SQ1", cost_s=cost)
    s.launch(None, [const(x2), out(y2)], name="SQ2", cost_s=cost)
    s.launch(None, [const(y1), const(y2), out(z)], name="RED", cost_s=cost)
    return z


# ----------------------------------------------------------------------
# Recording, cache keying, invalidation
# ----------------------------------------------------------------------

def test_capture_records_then_replays():
    s = make_scheduler("parallel", simulate=True)
    for _ep in range(4):
        with s.capture("vec"):
            _episode(s)
        s.sync()
    st = s.stats()
    assert st["plan_records"] == 1
    assert st["plan_replays"] == 3
    assert st["plan_invalidations"] == 0
    # every episode's elements entered the DAG (transfers + kernels)
    assert st["elements"] == 4 * 5


def test_plan_cache_keyed_by_argument_shapes():
    s = make_scheduler("parallel", simulate=True)
    for _ep in range(2):
        for n in (256, 512):
            with s.capture("vec"):
                _episode(s, n=n)
            s.sync()
    st = s.stats()
    assert st["plans_cached"] == 2          # one plan per shape signature
    assert st["plan_records"] == 2
    assert st["plan_replays"] == 2


def test_divergent_episode_invalidates_plan_and_records_new_shape():
    s = make_scheduler("parallel", simulate=True)
    with s.capture("vec"):
        _episode(s)
    s.sync()
    # same first launch, then a different kernel -> mid-episode divergence:
    # the stale plan is invalidated and the replayed prefix is transplanted
    # into a recording of the new shape.
    with s.capture("vec"):
        x = s.array(np.ones(1024, np.float32), name="xx")
        y = s.array(shape=(1024,), dtype=np.float32, name="yy")
        s.launch(None, [const(x), out(y)], name="SQ1", cost_s=1e-4)
        s.launch(None, [const(y), inout(x)], name="OTHER", cost_s=1e-4)
    s.sync()
    st = s.stats()
    assert st["plan_invalidations"] == 1
    assert st["plans_cached"] == 1          # the divergent shape got cached
    # the new shape now replays
    with s.capture("vec"):
        x = s.array(np.ones(1024, np.float32), name="xx2")
        y = s.array(shape=(1024,), dtype=np.float32, name="yy2")
        s.launch(None, [const(x), out(y)], name="SQ1", cost_s=1e-4)
        s.launch(None, [const(y), inout(x)], name="OTHER", cost_s=1e-4)
    s.sync()
    assert s.stats()["plan_replays"] == 1


def test_shorter_episode_invalidates_plan():
    s = make_scheduler("parallel", simulate=True)
    with s.capture("vec"):
        _episode(s)
    s.sync()
    with s.capture("vec"):      # only the first two launches of the episode
        x1 = s.array(np.ones(1024, np.float32), name="a")
        y1 = s.array(shape=(1024,), dtype=np.float32, name="b")
        s.launch(None, [const(x1), out(y1)], name="SQ1", cost_s=1e-4)
    s.sync()
    assert s.stats()["plan_invalidations"] == 1


def test_capture_is_noop_for_serial_policy():
    s = make_scheduler("serial", simulate=True)
    for _ in range(2):
        with s.capture("vec"):
            _episode(s)
        s.sync()
    assert s.stats()["plan_records"] == 0


def test_capture_contexts_cannot_nest():
    s = make_scheduler("parallel", simulate=True)
    with s.capture("a"):
        with pytest.raises(RuntimeError):
            with s.capture("b"):
                pass


# ----------------------------------------------------------------------
# Replay correctness — real ThreadLaneExecutor, bit-identical outputs
# ----------------------------------------------------------------------

def test_replay_bit_identical_on_real_executor():
    sq = lambda a, _o: a * a
    red = lambda a, b, _o: a - b

    def run_eager():
        s = make_scheduler("parallel", device="cpu")
        try:
            rng = np.random.RandomState(7)
            x1 = s.array(rng.randn(512).astype(np.float32))
            x2 = s.array(rng.randn(512).astype(np.float32))
            y1 = s.array(shape=(512,), dtype=np.float32)
            y2 = s.array(shape=(512,), dtype=np.float32)
            z = s.array(shape=(512,), dtype=np.float32)
            s.launch(sq, [const(x1), out(y1)], name="SQ1")
            s.launch(sq, [const(x2), out(y2)], name="SQ2")
            s.launch(red, [const(y1), const(y2), out(z)], name="RED")
            return np.asarray(z).copy()
        finally:
            s.shutdown()

    ref = run_eager()
    s = make_scheduler("parallel", device="cpu")
    try:
        for _ep in range(3):
            rng = np.random.RandomState(7)
            x1 = s.array(rng.randn(512).astype(np.float32))
            x2 = s.array(rng.randn(512).astype(np.float32))
            y1 = s.array(shape=(512,), dtype=np.float32)
            y2 = s.array(shape=(512,), dtype=np.float32)
            z = s.array(shape=(512,), dtype=np.float32)
            with s.capture("ep"):
                s.launch(sq, [const(x1), out(y1)], name="SQ1")
                s.launch(sq, [const(x2), out(y2)], name="SQ2")
                s.launch(red, [const(y1), const(y2), out(z)], name="RED")
            np.testing.assert_array_equal(np.asarray(z), ref)
            s.sync()
        assert s.stats()["plan_replays"] == 2
    finally:
        s.shutdown()


@pytest.mark.parametrize("bname", ["VEC", "ML", "HITS"])
def test_replay_bit_identical_on_benchmarks(bname):
    """Replayed benchmark episodes on the real executor must produce exactly
    the eager results (acceptance criterion)."""
    from repro_torch.benchsuite import BENCHMARKS

    bench = BENCHMARKS[bname]
    data = bench.make_data(0.001)
    s_eager = make_scheduler("parallel", device="cpu")
    try:
        ref = bench.build(s_eager, data, gpu=None, iters=1)
    finally:
        s_eager.shutdown()
    s = make_scheduler("parallel", device="cpu")
    try:
        for _ep in range(3):
            with s.capture(bname):
                outs = bench.build(s, data, gpu=None, iters=1)
            for k in ref:
                np.testing.assert_array_equal(outs[k], ref[k])
        assert s.stats()["plan_replays"] >= 2
    finally:
        s.shutdown()


def test_replay_orders_against_prior_work_on_same_arrays():
    """Back-to-back replays binding the same arrays must chain through entry
    dependencies (RAW/WAR against the previous episode's frontier)."""
    addc = lambda a: a + 1.0
    s = make_scheduler("parallel", device="cpu")
    try:
        x = s.array(np.zeros(64, np.float32), name="x")
        for _ep in range(4):
            with s.capture("inc"):
                s.launch(addc, [inout(x)], name="INC")
        assert float(np.asarray(x)[0]) == 4.0
    finally:
        s.shutdown()


# ----------------------------------------------------------------------
# Explicit replay API
# ----------------------------------------------------------------------

def test_explicit_replay_with_fresh_bindings():
    dbl = lambda a, _o: 2.0 * a
    s = make_scheduler("parallel", device="cpu")
    try:
        x = s.array(np.arange(16, dtype=np.float32), name="xin")
        y = s.array(shape=(16,), dtype=np.float32, name="yout")
        with s.capture("dbl"):
            s.launch(dbl, [const(x), out(y)], name="DBL")
        s.sync()
        plans = s.plan_cache.candidates("dbl")
        assert len(plans) == 1
        plan = plans[0]
        x2 = s.array(np.full(16, 3.0, np.float32), name="x2")
        y2 = s.array(shape=(16,), dtype=np.float32, name="y2")
        s.replay(plan, {"xin": x2, "yout": y2})
        np.testing.assert_array_equal(np.asarray(y2), np.full(16, 6.0, np.float32))
        # unbound slots reuse the captured arrays
        s.replay(plan)
        np.testing.assert_array_equal(np.asarray(y),
                                      2.0 * np.arange(16, dtype=np.float32))
    finally:
        s.shutdown()


def test_host_write_mid_replay_demotes_to_eager():
    """A host write to a plan-bound array between launches must produce the
    same results as eager execution (the plan's recorded transfer structure
    cannot cover the fresh host data)."""
    cp = lambda a, _o: a + 0.0

    def run(write_mid, captured):
        s = make_scheduler("parallel", device="cpu")
        try:
            outs = []
            for _ep in range(3):
                x = s.array(np.full(64, 1.0, np.float32), name="x")
                z1 = s.array(shape=(64,), dtype=np.float32, name="z1")
                z2 = s.array(shape=(64,), dtype=np.float32, name="z2")
                import contextlib
                ctx = s.capture("hw") if captured else contextlib.nullcontext()
                with ctx:
                    s.launch(cp, [const(x), out(z1)], name="K1")
                    if write_mid:
                        x.write(np.full(64, 100.0, np.float32))
                    s.launch(cp, [const(x), out(z2)], name="K2")
                outs.append((np.asarray(z1).copy(), np.asarray(z2).copy()))
                s.sync()
            return outs
        finally:
            s.shutdown()

    ref = run(write_mid=True, captured=False)
    got = run(write_mid=True, captured=True)
    for (r1, r2), (g1, g2) in zip(ref, got):
        np.testing.assert_array_equal(g1, r1)
        np.testing.assert_array_equal(g2, r2)     # sees the written value

    # Asymmetric case: plan recorded WITHOUT the write (so it contains no
    # second prefetch), later episode writes mid-way — K2 must still see
    # the new host value, not the stale device copy.
    s = make_scheduler("parallel", device="cpu")
    try:
        for ep in range(3):
            x = s.array(np.full(64, 1.0, np.float32), name="x")
            z1 = s.array(shape=(64,), dtype=np.float32, name="z1")
            z2 = s.array(shape=(64,), dtype=np.float32, name="z2")
            with s.capture("hw2"):
                s.launch(cp, [const(x), out(z1)], name="K1")
                if ep == 2:
                    x.write(np.full(64, 100.0, np.float32))
                s.launch(cp, [const(x), out(z2)], name="K2")
            expect2 = 100.0 if ep == 2 else 1.0
            np.testing.assert_array_equal(
                np.asarray(z2), np.full(64, expect2, np.float32))
            s.sync()
    finally:
        s.shutdown()


def test_host_read_mid_record_blocks_plan_storage():
    """A host read between launches retires the in-trace writer, so a plan
    recorded across it would lose the RAW edge (a race when replayed without
    the read).  The recording must be abandoned; trailing reads/syncs after
    the last launch stay capturable."""
    s = make_scheduler("parallel", simulate=True)
    with s.capture("midread"):
        x = s.array(np.ones(256, np.float32), name="x")
        y = s.array(shape=(256,), dtype=np.float32, name="y")
        z = s.array(shape=(256,), dtype=np.float32, name="z")
        s.launch(None, [const(x), out(y)], name="K1", cost_s=1e-4)
        _ = y[0]                       # retires K1 mid-episode
        s.launch(None, [const(y), out(z)], name="K2", cost_s=1e-4)
    s.sync()
    assert s.stats()["plan_records"] == 0      # racy plan not cached
    # trailing read: harmless, plan stored and replayable
    for _ep in range(2):
        with s.capture("tailread"):
            x = s.array(np.ones(256, np.float32), name="x2")
            y = s.array(shape=(256,), dtype=np.float32, name="y2")
            s.launch(None, [const(x), out(y)], name="K1", cost_s=1e-4)
            _ = y[0]
        s.sync()
    st = s.stats()
    assert st["plan_records"] == 1 and st["plan_replays"] == 1


def test_explicit_replay_rejects_aliased_bindings():
    """Binding one array to two slots would drop the WAW/WAR ordering eager
    execution enforces; replay() must refuse."""
    s = make_scheduler("parallel", simulate=True)
    with s.capture("pair"):
        x = s.array(np.ones(128, np.float32), name="xin")
        y1 = s.array(shape=(128,), dtype=np.float32, name="o1")
        y2 = s.array(shape=(128,), dtype=np.float32, name="o2")
        s.launch(None, [const(x), out(y1)], name="A", cost_s=1e-4)
        s.launch(None, [const(x), out(y2)], name="B", cost_s=1e-4)
    s.sync()
    plan = s.plan_cache.candidates("pair")[0]
    shared = s.array(np.zeros(128, np.float32), name="shared")
    with pytest.raises(ValueError):
        s.replay(plan, {"o1": shared, "o2": shared})


def test_explicit_replay_rejects_stale_host_copy():
    """replay() must refuse to re-run a recorded H2D prefetch over an array
    whose newest value lives only on the device."""
    dbl = lambda a, _o: 2.0 * a
    bump = lambda a: a + 1.0
    s = make_scheduler("parallel", device="cpu")
    try:
        x = s.array(np.full(16, 2.0, np.float32), name="x")
        y = s.array(shape=(16,), dtype=np.float32, name="y")
        with s.capture("st"):
            s.launch(dbl, [const(x), out(y)], name="DBL")
        s.sync()
        plan = s.plan_cache.candidates("st")[0]
        s.launch(bump, [inout(x)], name="BUMP")   # x now newest on device
        s.sync()
        with pytest.raises(ValueError):
            s.replay(plan)                        # would clobber device x
    finally:
        s.shutdown()


def test_explicit_replay_rejects_bad_bindings():
    s = make_scheduler("parallel", simulate=True)
    with s.capture("vec"):
        _episode(s)
    s.sync()
    plan = s.plan_cache.candidates("vec")[0]
    bad = s.array(np.zeros(7, np.float32))
    with pytest.raises(ValueError):
        s.replay(plan, {"x1": bad})            # shape mismatch
    with pytest.raises(ValueError):
        s.replay(plan, {"nope": bad})          # unknown slot


# ----------------------------------------------------------------------
# Performance acceptance (simulator): replay ~ oracle, >> eager
# ----------------------------------------------------------------------

def _episode_times(mode, bench, gpu, overhead, episodes=4, warmup=2):
    from repro_torch.benchsuite.costmodel import sim_hardware

    kw = {} if mode == "oracle" else {"launch_overhead_s": overhead}
    s = make_scheduler("parallel", simulate=True,
                       hw=sim_hardware(gpu, "parallel", True),
                       oracle=(mode == "oracle"), **kw)
    data = bench.make_data(0.02)
    times = []
    for _ in range(warmup + episodes):
        t0 = s.executor.host_time
        if mode == "replay":
            with s.capture(bench.name):
                bench.build(s, data, gpu=gpu, iters=1)
        else:
            bench.build(s, data, gpu=gpu, iters=1)
        times.append(s.executor.host_time - t0)
    if mode == "replay":
        assert s.stats()["plan_replays"] >= episodes
    return statistics.median(times[warmup:])


def test_replay_matches_oracle_and_beats_eager():
    """Acceptance criterion: on repeated episodes of the paper's 6
    benchmarks, steady-state replay is within 5% of the CUDA-Graphs oracle
    emulation and >= 25% faster than eager at high launch overhead."""
    from repro_torch.benchsuite import BENCHMARKS, GTX1660S

    overhead = 5e-4
    for bname, bench in BENCHMARKS.items():
        te = _episode_times("eager", bench, GTX1660S, overhead)
        tr = _episode_times("replay", bench, GTX1660S, overhead)
        to = _episode_times("oracle", bench, GTX1660S, overhead)
        assert tr <= 1.05 * to + 1e-9, (
            f"{bname}: replay {tr*1e6:.1f}us not within 5% of oracle "
            f"{to*1e6:.1f}us")
        assert tr <= 0.75 * te, (
            f"{bname}: replay {tr*1e6:.1f}us not >=25% faster than eager "
            f"{te*1e6:.1f}us")


def test_invalidation_releases_reserved_lanes():
    """Repeated divergence in a long-running loop must not leak reserved
    lane sets: a dropped plan's lanes return to the eager pool."""
    s = make_scheduler("parallel", simulate=True)
    for cycle in range(10):
        with s.capture("flaky"):
            _episode(s)                 # record (cycle 0) / replay
        s.sync()
        with s.capture("flaky"):        # diverging episode -> invalidate
            x = s.array(np.ones(1024, np.float32))
            y = s.array(shape=(1024,), dtype=np.float32)
            s.launch(None, [const(x), out(y)], name="SQ1", cost_s=1e-4)
            s.launch(None, [const(y), inout(x)], name=f"DIV{cycle}",
                     cost_s=1e-4)
        s.sync()
    reserved = [l for l in s.streams.lanes.values() if l.reserved]
    assert len(reserved) <= 8           # only live plans keep reservations
    assert s.stats()["plan_invalidations"] >= 10


def test_unhashable_config_values_are_capturable():
    """Launch kwargs the eager path accepts (lists, dicts) must not break
    plan recording, matching, or replayed-element configs."""
    s = make_scheduler("parallel", simulate=True)
    for _ep in range(3):
        x = s.array(np.ones(256, np.float32))
        y = s.array(shape=(256,), dtype=np.float32)
        with s.capture("cfg"):
            e = s.launch(None, [const(x), out(y)], name="K", cost_s=1e-4,
                         block=[8, 8], opts={"k": 1})
        assert e.config["block"] == [8, 8]
        s.sync()
    st = s.stats()
    assert st["plan_records"] == 1 and st["plan_replays"] == 2


def test_plan_lanes_do_not_leak_into_eager_pool():
    s = make_scheduler("parallel", simulate=True)
    for _ in range(3):
        with s.capture("vec"):
            _episode(s)
        s.sync()
    reserved = {lid for lid, l in s.streams.lanes.items() if l.reserved}
    assert reserved
    # eager work after replays must not land on reserved plan lanes
    w = s.array(np.zeros(256, np.float32), name="w")
    e = s.launch(None, [inout(w)], name="EAGER", cost_s=1e-4)
    assert e.stream not in reserved
    s.sync()


def test_plan_cache_replacement_stat_and_displacement():
    """``records`` counts net-new signatures only; a same-signature store
    is a replacement (returned as displaced so reservations are freed)."""
    from repro_torch.core.capture import ExecutionPlan, PlanCache

    def mk(key, sig_tag):
        return ExecutionPlan(
            name="n", key=key, elements=(), slots=(), fns=(), configs=(),
            slot_arrays=(), lane_devices=(), kernel_positions=(),
            device_mem=((0, sig_tag),))

    pc = PlanCache(max_plans_per_name=2)
    p1 = mk("k1", 1)
    assert pc.store(p1) == []
    assert pc.records == 1 and pc.replacements == 0
    p1b = mk("k1b", 1)                  # same signature -> replacement
    assert pc.store(p1b) == [p1]
    assert pc.records == 1 and pc.replacements == 1
    pc.store(mk("k2", 2))
    assert pc.store(mk("k3", 3)) == [p1b]   # LRU overflow displaces p1b
    assert pc.records == 3 and pc.replacements == 1
    assert pc.stats()["plan_replacements"] == 1
    assert pc.stats()["plan_records"] == 3


def test_plan_cache_overflow_releases_displaced_reservations():
    """Overflowing max_plans_per_name must release every displaced plan's
    lane reservations — no reserved-lane leak, however many signatures
    cycle through one capture name."""
    s = make_scheduler("parallel", simulate=True)

    def ep(n):
        with s.capture("many"):
            _episode(s, n=n)
        s.sync()

    shapes = [256 + 32 * i for i in range(9)]
    for n in shapes[:8]:
        ep(n)                           # record
        ep(n)                           # replay -> reserves a lane set
    st = s.stats()
    assert st["plan_records"] == 8 and st["plan_replays"] == 8
    assert len(s.plan_cache) == 8
    ep(shapes[8])                       # 9th signature displaces the oldest
    assert len(s.plan_cache) == 8
    assert s.stats()["plan_records"] == 9
    live_keys = {p.key for p in s.plan_cache.candidates("many")}
    assert set(s.streams._plan_lanes) <= live_keys
    reserved_ids = {lid for insts in s.streams._plan_lanes.values()
                    for inst in insts for lid in inst.values()}
    leaked = [l.lane_id for l in s.streams.lanes.values()
              if l.reserved and l.lane_id not in reserved_ids]
    assert not leaked
