"""Multi-tenant QoS in the port, the suite of ``tests/test_multitenant.py``
with torch kernels on CPU lanes: priority-weighted space-sharing,
priority-aware lane selection, tenant quotas, the thread-safe submission
pipeline, per-tenant stats, and capture/replay of priority-tagged
episodes."""
import threading

import numpy as np
import pytest

from _torch_memory_check import _verify_torch_memory_accounting  # noqa: F401

from repro_torch.benchsuite.multitenant import (BULK_TENANT, LATENCY_TENANT,
                                                build_contention)
from repro_torch.core import (ComputationalElement, ElementKind, StreamManager,
                              const, inout, make_scheduler, out, priority_weight)


def ce(*args, cost_s=0.0, name="", priority=0, tenant="default"):
    return ComputationalElement(fn=None, args=tuple(args), name=name,
                                cost_s=cost_s, priority=priority,
                                tenant=tenant)


def link(child, *parents):
    child.parents = list(parents)
    for p in parents:
        p.children.append(child)
    return child


class DoneSet:
    def __init__(self):
        self.done = set()

    def finish(self, *elements):
        self.done.update(e.uid for e in elements)

    def __call__(self, element):
        return element.uid in self.done


# ----------------------------------------------------------------------
# Priority weights & the weighted water-fill
# ----------------------------------------------------------------------

def test_priority_weight_mapping():
    assert priority_weight(0) == 1.0
    assert priority_weight(3) == 8.0
    assert priority_weight(-1) == 0.5


def test_weighted_waterfill_favors_high_priority():
    """Two full-occupancy kernels: priority 3 gets 8/9 of the device while
    both run, so it finishes ~1.8x sooner; total work is conserved."""
    s = make_scheduler("parallel", simulate=True, auto_prefetch=False)
    xa = s.array(shape=(256,), dtype=np.float32, name="a")
    xb = s.array(shape=(256,), dtype=np.float32, name="b")
    lo = s.launch(None, [inout(xa)], name="lo", cost_s=1e-3,
                  parallel_fraction=1.0, priority=0)
    hi = s.launch(None, [inout(xb)], name="hi", cost_s=1e-3,
                  parallel_fraction=1.0, priority=3)
    s.sync()
    dur_hi = hi.t_end - hi.t_start
    dur_lo = lo.t_end - lo.t_start
    # hi: rate 8/9 while contended -> 1e-3 * 9/8 = 1.125e-3
    assert dur_hi == pytest.approx(1.125e-3, rel=1e-3)
    # lo: 1/9 rate until hi finishes, then full rate -> ends at ~2e-3 total
    assert dur_lo == pytest.approx(2e-3, rel=1e-2)
    assert hi.t_end < lo.t_end


def test_equal_priorities_reduce_to_unweighted_fill():
    """With equal weights the weighted fill must reproduce the original
    behaviour: three pf=0.75 kernels each run at (1/3)/0.75 of solo rate."""
    s = make_scheduler("parallel", simulate=True, auto_prefetch=False)
    ks = []
    for i in range(3):
        x = s.array(shape=(64,), dtype=np.float32, name=f"x{i}")
        ks.append(s.launch(None, [inout(x)], name=f"k{i}", cost_s=1e-3,
                           parallel_fraction=0.75))
    s.sync()
    for k in ks:
        assert k.t_end - k.t_start == pytest.approx(2.25e-3, rel=1e-2)


def test_pf_ceiling_preserved_under_weighting():
    """A high-priority kernel's allocation is still capped by its parallel
    fraction: a pf=0.25 priority-5 kernel cannot exceed solo rate, and the
    leftover capacity spills to the low-priority kernel."""
    s = make_scheduler("parallel", simulate=True, auto_prefetch=False)
    xa = s.array(shape=(64,), dtype=np.float32, name="a")
    xb = s.array(shape=(64,), dtype=np.float32, name="b")
    hi = s.launch(None, [inout(xa)], name="hi", cost_s=1e-3,
                  parallel_fraction=0.25, priority=5)
    lo = s.launch(None, [inout(xb)], name="lo", cost_s=1e-3,
                  parallel_fraction=0.75, priority=0)
    s.sync()
    # hi capped at pf -> solo rate; lo gets the remaining 0.75 -> solo too.
    assert hi.t_end - hi.t_start == pytest.approx(1e-3, rel=1e-2)
    assert lo.t_end - lo.t_start == pytest.approx(1e-3, rel=1e-2)


# ----------------------------------------------------------------------
# Inheritance by auto-inserted transfers
# ----------------------------------------------------------------------

def test_h2d_transfer_inherits_priority_and_tenant():
    s = make_scheduler("parallel", simulate=True)
    x = s.array(np.zeros(1024, np.float32), name="x")
    k = s.launch(None, [inout(x)], name="k", cost_s=1e-4,
                 priority=2, tenant="lat")
    h2d = [p for p in k.parents if p.kind is ElementKind.TRANSFER]
    assert len(h2d) == 1
    assert h2d[0].priority == 2 and h2d[0].tenant == "lat"
    s.sync()


def test_d2d_transfer_inherits_priority_and_tenant():
    s = make_scheduler("parallel", simulate=True, num_devices=2,
                       placement="round-robin")
    x = s.array(np.zeros(1024, np.float32), name="x")
    s.launch(None, [inout(x)], name="k0", cost_s=1e-4)           # device 0
    k1 = s.launch(None, [inout(x)], name="k1", cost_s=1e-4,     # device 1
                  priority=3, tenant="lat")
    d2d = [p for p in k1.parents if p.kind is ElementKind.D2D]
    assert len(d2d) == 1
    assert d2d[0].priority == 3 and d2d[0].tenant == "lat"
    s.sync()


# ----------------------------------------------------------------------
# Priority-aware lane acquisition & tenant quotas
# ----------------------------------------------------------------------

def test_saturated_fallback_avoids_lower_priority_tail():
    sm = StreamManager(max_lanes=2)
    done = DoneSet()
    low = ce(name="low", priority=0)
    hi_busy = ce(name="hi_busy", priority=3)
    sm.assign(low, done)        # lane 0, low-priority tail
    sm.assign(hi_busy, done)    # lane 1, high-priority tail
    # Saturated: the new high-priority element must NOT queue behind the
    # low-priority tail while the lane-1 alternative exists.
    hi = ce(name="hi", priority=3)
    lane, _ = sm.assign(hi, done)
    assert lane.lane_id == hi_busy.stream
    assert sm.priority_bypasses == 1
    # An equal-priority element sees no blocked lanes: least-loaded wins
    # (lane 0 has 1 pending, lane 1 now has 2).
    other = ce(name="other", priority=0)
    lane2, _ = sm.assign(other, done)
    assert lane2.lane_id == low.stream


def test_tenant_quota_caps_busy_lanes():
    sm = StreamManager(tenant_quotas={"bulk": 2})
    done = DoneSet()
    b = [ce(name=f"b{i}", tenant="bulk") for i in range(4)]
    for e in b:
        sm.assign(e, done)
    # Third/fourth bulk submissions fold onto the tenant's own 2 lanes.
    assert sm.lanes_created == 2
    assert {b[0].stream, b[1].stream} == {b[2].stream, b[3].stream}
    assert sm.quota_fallbacks == 2
    # An unrelated tenant is not constrained by bulk's quota.
    other = ce(name="lat0", tenant="lat")
    sm.assign(other, done)
    assert sm.lanes_created == 3
    # Once bulk's lanes drain, it may again use fresh/free lanes.
    done.finish(*b)
    b4 = ce(name="b4", tenant="bulk")
    sm.assign(b4, done)
    assert sm.quota_fallbacks == 2


def test_tenant_quota_counts_shared_lanes():
    """A lane hosting several tenants' work still counts toward each of
    their quotas — the flooding tenant cannot slip past its cap because
    someone else queued on one of its lanes."""
    sm = StreamManager(tenant_quotas={"bulk": 2})
    done = DoneSet()
    b0, b1 = ce(name="b0", tenant="bulk"), ce(name="b1", tenant="bulk")
    sm.assign(b0, done)
    sm.assign(b1, done)
    # A "lat" child of b0 inherits b0's lane: that lane now serves both.
    lat = link(ce(name="lat", tenant="lat"), b0)
    sm.assign(lat, done)
    assert lat.stream == b0.stream
    b2 = ce(name="b2", tenant="bulk")
    sm.assign(b2, done)
    assert sm.lanes_created == 2        # quota held: no third lane for bulk
    assert sm.quota_fallbacks == 1


# ----------------------------------------------------------------------
# Thread-safe submission pipeline (acceptance: >=4 concurrent submitters)
# ----------------------------------------------------------------------

def _build_tenant_chains(s, tid, chains=3, per=4):
    for c in range(chains):
        x = s.array(np.zeros(256, np.float32), name=f"t{tid}_x{c}")
        for k in range(per):
            s.launch(None, [inout(x)], name=f"t{tid}_k{c}_{k}", cost_s=1e-5,
                     priority=tid % 3, tenant=f"tenant{tid}")


def test_concurrent_submitters_match_single_thread_reference():
    """>=4 threads submitting to one GrScheduler: no lost elements, DAG
    node/edge counts equal the single-threaded reference (disjoint arrays
    make the counts interleaving-invariant), and the sim drains fully."""
    n_threads, chains, per = 4, 3, 4
    ref = make_scheduler("parallel", simulate=True)
    for tid in range(n_threads):
        _build_tenant_chains(ref, tid, chains, per)
    ref.sync()

    s = make_scheduler("parallel", simulate=True)
    errs = []
    barrier = threading.Barrier(n_threads)   # all submitters truly concurrent

    def worker(tid):
        try:
            barrier.wait()
            _build_tenant_chains(s, tid, chains, per)
        except BaseException as exc:  # surfaced below
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(tid,))
               for tid in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    s.sync()
    assert not errs
    assert s.dag.num_elements == ref.dag.num_elements
    assert s.dag.num_edges == ref.dag.num_edges
    # Every submitted element actually completed in the simulator.
    assert len(s.executor._end) == s.dag.num_elements
    assert s.stats()["pipeline_threads_seen"] >= n_threads
    # All four tenants show up in the QoS attribution.
    assert len(s.tenant_stats()) == n_threads


def test_concurrent_submitters_real_executor_values():
    """Concurrent submitters on the real ThreadLaneExecutor: every chain
    computes the right value (dependencies intact under contention)."""
    def inc(a):
        return a + 1.0
    n_threads, per = 4, 5
    s = make_scheduler("parallel", device="cpu")
    arrays, errs = {}, []

    def worker(tid):
        try:
            x = s.array(np.zeros(32, np.float32), name=f"x{tid}")
            arrays[tid] = x
            for _ in range(per):
                s.launch(inc, [inout(x)], name=f"inc{tid}",
                         tenant=f"tenant{tid}")
        except BaseException as exc:
            errs.append(exc)

    try:
        threads = [threading.Thread(target=worker, args=(tid,))
                   for tid in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        s.sync()
        assert not errs
        for _tid, x in arrays.items():
            np.testing.assert_allclose(np.asarray(x), float(per))
    finally:
        s.shutdown()


def test_host_read_does_not_block_other_tenants_launches():
    """No priority inversion through the pipeline lock: while one tenant's
    host read blocks on its slow in-flight kernel (real executor), another
    tenant's launch() must complete promptly."""
    import time
    s = make_scheduler("parallel", device="cpu")

    def slow_fn(a):
        time.sleep(0.5)
        return a + 1.0

    x = s.array(np.zeros(8, np.float32), name="x")
    launch_latency = [None]
    try:
        s.launch(slow_fn, [inout(x)], name="slow", tenant="bulk")

        def reader():
            np.asarray(x)          # blocks ~0.5s on the slow kernel

        def submitter():
            time.sleep(0.1)        # let the reader start blocking first
            t0 = time.perf_counter()
            y = s.array(np.zeros(8, np.float32), name="y")
            s.launch(lambda a: a + 1.0, [inout(y)], name="fast",
                     priority=3, tenant="lat")
            launch_latency[0] = time.perf_counter() - t0

        ra = threading.Thread(target=reader)
        rb = threading.Thread(target=submitter)
        ra.start(); rb.start(); ra.join(); rb.join()
        s.sync()
        assert launch_latency[0] < 0.25, \
            f"launch stalled {launch_latency[0]:.3f}s behind a host read"
    finally:
        s.shutdown()


# ----------------------------------------------------------------------
# Per-tenant QoS stats
# ----------------------------------------------------------------------

def test_tenant_stats_report_latency_and_queueing():
    s = make_scheduler("parallel", simulate=True)
    build_contention(s, bulk_kernels=3, latency_streams=1, per_stream=3,
                     n=1 << 10)
    s.sync()
    ts = s.tenant_stats()
    assert set(ts) == {BULK_TENANT, LATENCY_TENANT}
    for t in ts.values():
        assert t["elements"] > 0
        assert t["latency_p99_s"] >= t["latency_p50_s"] > 0
        assert t["queue_delay_p99_s"] >= 0
        assert t["makespan_s"] > 0
    # The bulk flood dominates the device for far longer.
    assert ts[BULK_TENANT]["makespan_s"] > ts[LATENCY_TENANT]["makespan_s"]


# ----------------------------------------------------------------------
# Acceptance: contention benchmark targets
# ----------------------------------------------------------------------

def test_priority_weighting_improves_latency_p99_2x():
    """Acceptance: weighted p99 >= 2x better than priority-blind,
    aggregate makespan regresses <= 10%."""
    def run(weighted):
        s = make_scheduler("parallel", simulate=True)
        build_contention(s, use_priority=weighted)
        s.sync()
        return s.timeline.makespan, s.tenant_stats()

    mk_blind, ts_blind = run(False)
    mk_wtd, ts_wtd = run(True)
    p99_blind = ts_blind[LATENCY_TENANT]["latency_p99_s"]
    p99_wtd = ts_wtd[LATENCY_TENANT]["latency_p99_s"]
    assert p99_blind / p99_wtd >= 2.0, \
        f"p99 improvement only {p99_blind / p99_wtd:.2f}x"
    assert mk_wtd <= 1.10 * mk_blind, \
        f"makespan regressed {mk_wtd / mk_blind:.3f}x"


# ----------------------------------------------------------------------
# Capture/replay of priority-tagged episodes
# ----------------------------------------------------------------------

def _qos_episode(s, tag=""):
    xa = s.array(np.ones(256, np.float32), name=f"qa{tag}")
    xb = s.array(np.ones(256, np.float32), name=f"qb{tag}")
    s.launch(None, [inout(xa)], name="hi", cost_s=1e-3,
             parallel_fraction=1.0, priority=3, tenant="lat")
    s.launch(None, [inout(xb)], name="lo", cost_s=1e-3,
             parallel_fraction=1.0, priority=0, tenant="bulk")


def test_replay_preserves_priority_weighting():
    s = make_scheduler("parallel", simulate=True)
    for ep in range(3):
        with s.capture("qos"):
            _qos_episode(s, tag=str(ep))
        s.sync()
    assert s.stats()["plan_replays"] == 2
    # Every episode — recorded and replayed — ran with the same weighting:
    # the priority-3 kernel's span is ~1.8x shorter each time.
    hi = sorted((sp for sp in s.timeline.spans if sp.name == "hi"),
                key=lambda sp: sp.t0)
    lo = sorted((sp for sp in s.timeline.spans if sp.name == "lo"),
                key=lambda sp: sp.t0)
    assert len(hi) == len(lo) == 3
    for h, l in zip(hi, lo):
        assert h.priority == 3 and h.tenant == "lat"
        assert l.priority == 0 and l.tenant == "bulk"
        assert h.dur == pytest.approx(1.125e-3, rel=1e-2)
        assert l.dur == pytest.approx(2e-3, rel=2e-2)


def test_priority_retag_records_separate_plan():
    """Re-issuing the same structure at a different priority must not hit
    the old plan (the weighting is part of the structural signature)."""
    s = make_scheduler("parallel", simulate=True)
    x1 = s.array(np.ones(256, np.float32), name="p1")
    with s.capture("retag"):
        s.launch(None, [inout(x1)], name="k", cost_s=1e-4, priority=0)
    s.sync()
    x2 = s.array(np.ones(256, np.float32), name="p2")
    with s.capture("retag"):
        s.launch(None, [inout(x2)], name="k", cost_s=1e-4, priority=2)
    s.sync()
    st = s.stats()
    assert st["plan_records"] == 2
    assert st["plan_replays"] == 0
    assert st["plans_cached"] == 2


def test_capture_roundtrip_priority_tagged_real_executor():
    """Acceptance: capture/replay round-trips priority-tagged episodes
    bit-identically on the real executor."""
    def sq(a, _o):
        return a * a

    def addc(a, _o):
        return a + 2.0

    def episode(s, tag):
        x = s.array(np.arange(64, dtype=np.float32), name=f"x{tag}")
        y = s.array(np.zeros(64, np.float32), name=f"y{tag}")
        z = s.array(np.zeros(64, np.float32), name=f"z{tag}")
        s.launch(sq, [const(x), out(y)], name="sq",
                 priority=3, tenant="lat")
        s.launch(addc, [const(x), out(z)], name="addc",
                 priority=0, tenant="bulk")
        return y, z

    ref = np.arange(64, dtype=np.float32)
    s = make_scheduler("parallel", device="cpu")
    try:
        for ep in range(3):
            y, z = episode(s, ep)
            np.testing.assert_array_equal(np.asarray(y), ref * ref)
            np.testing.assert_array_equal(np.asarray(z), ref + 2.0)
        # Same episodes under capture: record once, replay twice, outputs
        # bit-identical to the eager runs above.
        for ep in range(3):
            with s.capture("qos_real"):
                y, z = episode(s, f"c{ep}")
            np.testing.assert_array_equal(np.asarray(y), ref * ref)
            np.testing.assert_array_equal(np.asarray(z), ref + 2.0)
        st = s.stats()
        assert st["plan_replays"] >= 2
        # Replayed elements kept their tags all the way to the timeline.
        tags = {(sp.tenant, sp.priority) for sp in s.timeline.spans
                if sp.name in ("sq", "addc")}
        assert ("lat", 3) in tags and ("bulk", 0) in tags
    finally:
        s.shutdown()
