"""Deadline/SLO-aware scheduling in the port, the suite of
``tests/test_slo.py`` with torch kernels on CPU lanes: EDF ordering,
element-boundary preemption with pause/resume, deadline capture/replay,
no-deadline bit-identity, per-tenant SLO attainment, and serving-engine
EDF batching."""
import threading

import numpy as np
import pytest

from _torch_memory_check import _verify_torch_memory_accounting  # noqa: F401

from _hypothesis_fallback import given, settings, st
from repro_torch.benchsuite.slo import (BULK_TENANT, LATENCY_TENANT,
                                        build_slo_workload)
from repro_torch.core import const, inout, make_scheduler, out
from repro_torch.runtime.serving import ServingEngine


# ----------------------------------------------------------------------
# EDF ordering & preemption (simulated)
# ----------------------------------------------------------------------

def test_edf_gives_deadlined_kernel_capacity_first():
    """Two equal-priority full-occupancy kernels: the deadline'd one takes
    the device at full rate (EDF fill) and finishes in its solo time; the
    deadline-free one only gets leftover capacity."""
    s = make_scheduler("parallel", simulate=True, auto_prefetch=False)
    xa = s.array(shape=(256,), dtype=np.float32, name="a")
    xb = s.array(shape=(256,), dtype=np.float32, name="b")
    free = s.launch(None, [inout(xa)], name="free", cost_s=1e-3,
                    parallel_fraction=1.0)
    urgent = s.launch(None, [inout(xb)], name="urgent", cost_s=1e-3,
                      parallel_fraction=1.0, deadline_s=1.5e-3)
    s.sync()
    assert urgent.t_end - urgent.t_start == pytest.approx(1e-3, rel=1e-3)
    assert urgent.t_end < free.t_end
    assert s.stats()["deadline_elements"] >= 1
    assert s.stats()["edf_fill_rounds"] > 0


def test_slo_scenario_preemption_beats_baseline():
    """The benchsuite adversarial scenario: deadlines + preemption cut the
    latency tenant's p99 while conserving total work (makespan)."""
    def run(use_deadlines):
        s = make_scheduler(simulate=True, num_devices=1,
                           tenant_quotas={BULK_TENANT: 4})
        build_slo_workload(s, bulk_units=16, latency_chains=2, per_chain=4,
                           use_deadlines=use_deadlines)
        s.sync()
        res = (s.tenant_stats()[LATENCY_TENANT]["latency_p99_s"],
               s.timeline.makespan, dict(s.stats()))
        s.shutdown()
        return res

    base_p99, base_mk, base_st = run(False)
    dl_p99, dl_mk, dl_st = run(True)
    assert base_p99 / dl_p99 >= 2.0
    assert dl_mk / base_mk <= 1.10
    assert dl_st["edf_preemptions"] > 0
    assert dl_st["edf_resumes"] == dl_st["edf_preemptions"]  # all resumed
    # The deadline-blind run must not even report deadline machinery.
    assert "deadline_elements" not in base_st


@st.composite
def _chain_specs(draw):
    """1-3 kernel chains, each with a deadline choice and per-stage costs."""
    chains = []
    for _ in range(draw(st.integers(min_value=1, max_value=3))):
        length = draw(st.integers(min_value=1, max_value=4))
        dl = draw(st.sampled_from([None, 5e-4, 2e-3, 1e-2]))
        costs = [draw(st.floats(min_value=1e-5, max_value=1e-3))
                 for _ in range(length)]
        chains.append((dl, costs))
    return chains


@settings(max_examples=20, deadline=None)
@given(_chain_specs())
def test_edf_never_violates_dag_order(chains):
    """Property: whatever mix of deadlines EDF reorders by, a child never
    starts before every parent has finished (DAG edges dominate EDF rank)."""
    s = make_scheduler("parallel", simulate=True, auto_prefetch=False)
    kernels = []
    for c, (dl, costs) in enumerate(chains):
        x = s.array(np.zeros(64, np.float32), name=f"c{c}")
        for k, cost in enumerate(costs):
            y = s.array(shape=(64,), dtype=np.float32, name=f"c{c}_{k}")
            kernels.append(s.launch(None, [const(x), out(y)],
                                    name=f"k{c}_{k}", cost_s=cost,
                                    parallel_fraction=1.0, deadline_s=dl))
            x = y
    s.sync()
    for k in kernels:
        for p in k.parents:
            assert k.t_start >= p.t_end - 1e-12, (
                f"{k.name} started before parent {p.name} finished")


def test_pause_resume_bit_identical_on_real_executor():
    """Real ThreadLaneExecutor: force a preemption (queued bulk chain paused
    behind a blocked head while an urgent deadline'd launch arrives), then
    let everything drain — results must match the deadline-free run."""
    gate = threading.Event()

    def blocker(a, _o):
        gate.wait(5.0)
        return a + 1

    step = lambda a, _o: a + 1
    lat = lambda a, _o: a * 2

    def run(use_deadline):
        gate.clear()
        s = make_scheduler("parallel", device="cpu")
        try:
            x = s.array(np.arange(64, dtype=np.float32), name="x")
            y = x
            # Deep single-lane bulk chain: head blocks on the gate, the rest
            # sit QUEUED — exactly the state preemption may pause.
            for k in range(6):
                yn = s.array(shape=(64,), dtype=np.float32, name=f"b{k}")
                fn = blocker if k == 0 else step
                s.launch(fn, [const(y), out(yn)], name=f"bulk{k}",
                         cost_s=1e-2, tenant="bulk")
                y = yn
            u = s.array(np.ones(64, np.float32), name="u")
            v = s.array(shape=(64,), dtype=np.float32, name="v")
            # Declared cost >> deadline window: slack is negative at the
            # submit-time risk check regardless of wall-clock timing, so
            # the preemption decision is deterministic.
            s.launch(lat, [const(u), out(v)], name="urgent", cost_s=1e-2,
                     tenant="lat",
                     deadline_s=(1e-4 if use_deadline else None))
            gate.set()
            s.sync()
            st = dict(s.stats())
            return np.asarray(y).copy(), np.asarray(v).copy(), st
        finally:
            gate.set()
            s.shutdown()

    bulk_ref, lat_ref, _ = run(False)
    bulk_dl, lat_dl, st = run(True)
    np.testing.assert_array_equal(bulk_dl, bulk_ref)
    np.testing.assert_array_equal(lat_dl, lat_ref)
    assert st.get("deadline_elements", 0) >= 1
    # The queued bulk tail was paused (deterministic: the gate holds the
    # lane head until after the urgent submit's risk check) ...
    assert st.get("edf_preemptions", 0) > 0
    # ... and every pause was matched by a resume before shutdown.
    assert st["edf_preemptions"] == st["edf_resumes"]


# ----------------------------------------------------------------------
# No-deadline bit-identity
# ----------------------------------------------------------------------

def test_no_deadline_schedule_bit_identical_with_monitor_armed():
    """A scheduler whose monitor is armed (slo_targets for a tenant that
    never launches) must produce a bit-identical timeline to the default
    scheduler on a deadline-free workload."""
    def spans(**kw):
        s = make_scheduler(simulate=True, num_devices=1,
                           tenant_quotas={BULK_TENANT: 2}, **kw)
        build_slo_workload(s, bulk_units=6, latency_chains=1, per_chain=3,
                           use_deadlines=False)
        s.sync()
        out_ = sorted((sp.name, sp.lane, sp.t0, sp.t1)
                      for sp in s.timeline.spans)
        st = dict(s.stats())
        s.shutdown()
        return out_, st

    ref, ref_st = spans()
    armed, armed_st = spans(slo_targets={"ghost-tenant": 1.0})
    assert armed == ref
    assert "deadline_elements" not in ref_st
    assert armed_st.get("deadline_elements", 0) == 0
    assert armed_st.get("edf_preemptions", 0) == 0


# ----------------------------------------------------------------------
# Tenant SLO targets & attainment stats
# ----------------------------------------------------------------------

def test_tenant_slo_target_stamps_deadlines_and_reports_attainment():
    s = make_scheduler(simulate=True, num_devices=1,
                       tenant_quotas={BULK_TENANT: 4},
                       slo_targets={LATENCY_TENANT: 0.05})
    build_slo_workload(s, bulk_units=8, latency_chains=1, per_chain=3,
                       use_deadlines=False)   # deadline comes from the SLO
    s.sync()
    ts = s.tenant_stats()
    lat = ts[LATENCY_TENANT]
    assert lat["deadlined"] > 0
    assert lat["slo_attainment"] == pytest.approx(1.0)   # 50ms is generous
    assert "slo_attainment" not in ts[BULK_TENANT]
    assert s.stats()["deadline_elements"] > 0
    s.shutdown()


# ----------------------------------------------------------------------
# Capture/replay of deadline'd episodes
# ----------------------------------------------------------------------

def test_replay_restamps_deadlines_and_preserves_edf_rank():
    """Deadline'd episodes replay from one plan; each replay re-stamps a
    fresh absolute deadline (monitor registers the replayed elements) and
    the deadline'd kernel still EDF-outranks the deadline-free one."""
    s = make_scheduler("parallel", simulate=True, auto_prefetch=False)

    def episode():
        xa = s.array(shape=(256,), dtype=np.float32, name="a")
        xb = s.array(shape=(256,), dtype=np.float32, name="b")
        with s.capture("ep"):
            s.launch(None, [inout(xa)], name="free", cost_s=1e-3,
                     parallel_fraction=1.0)
            s.launch(None, [inout(xb)], name="urgent", cost_s=1e-3,
                     parallel_fraction=1.0, deadline_s=1.5e-3)
        s.sync()

    counts = []
    for _ in range(3):
        episode()
        counts.append(s.stats()["deadline_elements"])
    st = s.stats()
    assert st["plan_records"] == 1
    assert st["plan_replays"] == 2
    # Each replay registered the urgent kernel afresh (fresh deadline_t).
    assert counts == [1, 2, 3]
    urgent = [sp for sp in s.timeline.spans if sp.name == "urgent"]
    free = [sp for sp in s.timeline.spans if sp.name == "free"]
    assert len(urgent) == 3 and len(free) == 3
    for u, f in zip(sorted(urgent, key=lambda sp: sp.t0),
                    sorted(free, key=lambda sp: sp.t0)):
        assert u.t1 - u.t0 == pytest.approx(1e-3, rel=1e-3)  # full EDF rate
        assert u.t1 < f.t1
    s.shutdown()


def test_deadline_retag_invalidates_plan():
    """deadline_s is part of the plan signature: re-running the episode with
    a different deadline must record a fresh plan, not replay the stale
    one (EDF rank and preemption eligibility differ)."""
    s = make_scheduler("parallel", simulate=True, auto_prefetch=False)

    def episode(dl):
        xa = s.array(shape=(256,), dtype=np.float32, name="a")
        with s.capture("ep"):
            s.launch(None, [inout(xa)], name="k", cost_s=1e-3,
                     parallel_fraction=1.0, deadline_s=dl)
        s.sync()

    episode(1e-3)
    episode(1e-3)
    assert s.stats()["plan_replays"] == 1
    episode(5e-3)                       # retag: signature mismatch
    st = s.stats()
    assert st["plan_records"] == 2
    assert st["plan_replays"] == 1
    episode(5e-3)                       # the retagged plan now replays
    assert s.stats()["plan_replays"] == 2
    s.shutdown()


# ----------------------------------------------------------------------
# Serving engine: EDF batch assembly + age-based partial-batch flush
# ----------------------------------------------------------------------

def _engine_shell(batch=2):
    eng = ServingEngine.__new__(ServingEngine)
    eng.batch = batch
    eng.max_new = 4
    eng.sched = make_scheduler("parallel", simulate=True)
    eng.capture = False
    eng._queue = __import__("collections").deque()
    eng._rid = 0
    eng._pending = []
    return eng


def test_serving_deadlined_batch_issues_first():
    """A deadline'd tenant's batch EDF-outranks the stride order: it issues
    before the earlier-submitted deadline-free bulk batches, which then
    drain in the usual stride order."""
    eng = _engine_shell(batch=2)
    order = []
    eng._issue_batch = lambda plen, ntok, tenant, prio, group: \
        order.append(tenant)
    rng = np.random.RandomState(0)
    for _ in range(4):
        eng.submit(rng.randint(0, 100, 8), 4, tenant="bulk", priority=0)
    for _ in range(2):
        eng.submit(rng.randint(0, 100, 8), 4, tenant="lat", priority=0,
                   deadline_s=1e-3)
    eng.flush()
    assert order == ["lat", "bulk", "bulk"]


def test_serving_deadline_free_flush_order_unchanged():
    """Without deadlines the EDF sort keys are all +inf: batch assembly must
    keep the exact legacy weighted-fair order."""
    eng = _engine_shell(batch=2)
    order = []
    eng._issue_batch = lambda plen, ntok, tenant, prio, group: \
        order.append((tenant, len(group)))
    rng = np.random.RandomState(0)
    for _ in range(6):
        eng.submit(rng.randint(0, 100, 8), 4, tenant="bulk", priority=0)
    for _ in range(6):
        eng.submit(rng.randint(0, 100, 8), 4, tenant="lat", priority=3)
    eng.flush()
    assert order == [("bulk", 2), ("lat", 2), ("lat", 2), ("lat", 2),
                     ("bulk", 2), ("bulk", 2)]


def test_serving_max_batch_wait_holds_then_releases_partial_batches():
    """With max_batch_wait_s set, a young partial batch with a comfortable
    deadline is held back; force=True (or deadline pressure) releases it."""
    eng = _engine_shell(batch=4)
    eng.max_batch_wait_s = 10.0
    order = []
    eng._issue_batch = lambda plen, ntok, tenant, prio, group: \
        order.append((tenant, len(group)))
    rng = np.random.RandomState(1)
    eng.submit(rng.randint(0, 100, 8), 4, tenant="a", priority=0)
    eng.submit(rng.randint(0, 100, 8), 4, tenant="a", priority=0)
    eng.flush()
    assert order == []                  # young + partial + no pressure: held
    eng.flush(force=True)
    assert order == [("a", 2)]
    # A tight deadline defeats the hold even for a fresh partial batch.
    order.clear()
    eng.submit(rng.randint(0, 100, 8), 4, tenant="a", priority=0,
               deadline_s=1e-3)
    eng.flush()
    assert order == [("a", 1)]
