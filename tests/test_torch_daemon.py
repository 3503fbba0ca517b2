"""The port's runtime daemon (``repro_torch.daemon``), the suite of
``tests/test_daemon.py`` with torch chain kernels and simulated or
``device="cpu"`` schedulers: lifecycle state machine, persistent store,
monitor, admission policy, wire framing, and socket end-to-end flows; then
parity with ``repro.daemon`` on the same inputs (chain results, journal
lines and audits, admission decisions, monitor snapshots).

The crash/restart recovery suite lives in
``test_torch_daemon_recovery.py``; clean-shutdown satellites in
``test_torch_shutdown.py``.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from _hypothesis_fallback import given, settings, st
from repro_torch.daemon import (AdmissionPolicy, DaemonClient, DaemonError,
                                DaemonServer, Ewma, IllegalTransitionError,
                                JobRecord, JobState, JobStore,
                                LEGAL_TRANSITIONS, RuntimeMonitor,
                                SpikeDetector)
from repro_torch.daemon.jobs import JobCancelled, JobContext, run_job
from repro_torch.daemon.lifecycle import validate_history
from repro_torch.daemon.wire import ProtocolError, recv_msg, send_msg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _server(tmp, **kw):
    """In-process daemon on a sim scheduler (no device needed)."""
    kw.setdefault("sched_kw", {"simulate": True})
    kw.setdefault("workers", 2)
    kw.setdefault("monitor_interval_s", 0.02)
    srv = DaemonServer(os.path.join(tmp, "d.sock"),
                       store_path=os.path.join(tmp, "jobs.jsonl"), **kw)
    return srv.start()


# ======================================================================
# Lifecycle state machine
# ======================================================================

def test_lifecycle_happy_path_records_timestamps():
    j = JobRecord("j1", "noop", submit_t=100.0)
    for dst in (JobState.ADMITTED, JobState.RUNNING, JobState.FINISHED):
        j.transition(dst, t=101.0)
    assert j.state is JobState.FINISHED and j.terminal
    assert j.attempts == 1
    assert [(a, b) for a, b, _ in j.transitions] == [
        ("queued", "admitted"), ("admitted", "running"),
        ("running", "finished")]
    assert j.transition_time(JobState.RUNNING) == 101.0
    assert validate_history(j.transitions) == []


def test_illegal_transition_raises_and_mutates_nothing():
    j = JobRecord("j1", "noop")
    with pytest.raises(IllegalTransitionError):
        j.transition(JobState.FINISHED)     # queued -> finished is illegal
    assert j.state is JobState.QUEUED and j.transitions == []
    j.transition(JobState.CANCELLED)
    with pytest.raises(IllegalTransitionError):
        j.transition(JobState.ADMITTED)     # terminal states are absorbing
    assert len(j.transitions) == 1


def test_pause_resume_cycle_and_shed_edges_are_legal():
    j = JobRecord("j1", "sleep")
    for dst in (JobState.ADMITTED, JobState.RUNNING, JobState.PAUSED,
                JobState.RUNNING, JobState.PAUSED, JobState.CANCELLED):
        j.transition(dst)
    assert validate_history(j.transitions) == []
    shed = JobRecord("j2", "sleep")
    shed.transition(JobState.CANCELLED, reason="shed:queue_full")
    assert shed.reason.startswith("shed:")
    assert validate_history(shed.transitions) == []


def test_validate_history_flags_corruptions():
    assert validate_history([("queued", "finished", 0.0)])
    assert validate_history([("admitted", "running", 0.0)])  # bad start
    assert validate_history([("queued", "admitted", 0.0),
                             ("running", "finished", 1.0)])  # broken chain
    assert validate_history([("queued", "bogus", 0.0)])      # unknown state


def test_job_record_json_roundtrip():
    j = JobRecord("j1", "chain", params={"n": 3}, tenant="t", priority=2,
                  deadline_s=1.5, submit_t=9.0)
    j.transition(JobState.ADMITTED)
    j.transition(JobState.RUNNING)
    j.transition(JobState.FAILED, reason="boom")
    j.result = {"x": 1}
    back = JobRecord.from_json(json.loads(json.dumps(j.to_json())))
    assert back.to_json() == j.to_json()
    assert back.state is JobState.FAILED and back.reason == "boom"


_STATE_LIST = sorted(JobState, key=lambda s: s.value)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, len(_STATE_LIST) - 1), min_size=1,
                max_size=20))
def test_property_random_walks_never_record_illegal_history(steps):
    """Drive a JobRecord with arbitrary requested transitions: every edge
    either raises (and changes nothing) or lands in the recorded history —
    and the history always validates clean."""
    j = JobRecord("jp", "noop")
    for idx in steps:
        dst = _STATE_LIST[idx]
        before = (j.state, len(j.transitions))
        try:
            j.transition(dst)
        except IllegalTransitionError:
            assert (j.state, len(j.transitions)) == before
        else:
            assert dst in LEGAL_TRANSITIONS[before[0]]
            assert j.state is dst
    assert validate_history(j.transitions) == []
    if j.transitions:
        assert j.transitions[-1][1] == j.state.value


# ======================================================================
# Persistent store
# ======================================================================

def test_store_roundtrip_and_last_record_wins(tmp_path):
    path = str(tmp_path / "jobs.jsonl")
    st1 = JobStore(path)
    j = JobRecord("j1", "noop", submit_t=1.0)
    st1.put(j)
    j.transition(JobState.ADMITTED)
    st1.update(j)
    j.transition(JobState.RUNNING)
    st1.update(j)
    st1.close(compact=False)
    # three journal lines, one job, latest state wins
    assert len(open(path).read().splitlines()) == 3
    st2 = JobStore(path)
    assert len(st2) == 1
    assert st2.get("j1").state is JobState.RUNNING
    assert st2.replayed == 3


def test_store_tolerates_torn_tail(tmp_path):
    path = str(tmp_path / "jobs.jsonl")
    st1 = JobStore(path)
    st1.put(JobRecord("j1", "noop"))
    st1.put(JobRecord("j2", "noop"))
    st1.close(compact=False)
    with open(path, "a") as fh:            # simulated crash mid-append
        fh.write('{"t": 1.0, "job": {"job_id": "j3", "ki')
    st2 = JobStore(path)
    assert len(st2) == 2 and st2.truncated_tail == 1
    st2.put(JobRecord("j4", "noop"))       # journal still appendable
    st2.close(compact=False)
    assert len(JobStore(path)) == 3


def test_store_recover_contract(tmp_path):
    path = str(tmp_path / "jobs.jsonl")
    st1 = JobStore(path)
    specs = [("q1", JobState.QUEUED), ("q2", JobState.QUEUED),
             ("a1", JobState.ADMITTED), ("r1", JobState.RUNNING),
             ("p1", JobState.PAUSED), ("f1", JobState.FINISHED),
             ("c1", JobState.CANCELLED)]
    for i, (jid, state) in enumerate(specs):
        j = JobRecord(jid, "noop", submit_t=float(i))
        path_to = {JobState.QUEUED: [], JobState.ADMITTED: ["admitted"],
                   JobState.RUNNING: ["admitted", "running"],
                   JobState.PAUSED: ["admitted", "running", "paused"],
                   JobState.FINISHED: ["admitted", "running", "finished"],
                   JobState.CANCELLED: ["cancelled"]}[state]
        for name in path_to:
            j.transition(JobState(name))
        st1.put(j)
    st1.close()
    st2 = JobStore(path)
    requeued, failed = st2.recover()
    assert [j.job_id for j in requeued] == ["q1", "q2"]   # submit order
    assert {j.job_id for j in failed} == {"a1", "r1", "p1"}
    for j in failed:
        assert j.state is JobState.FAILED and j.reason == "daemon restart"
        assert validate_history(j.transitions) == []
    assert st2.get("f1").state is JobState.FINISHED       # terminals kept
    # recovery is itself journaled: a second replay sees FAILED directly
    st2.close(compact=False)
    st3 = JobStore(path)
    assert st3.get("r1").state is JobState.FAILED
    assert st3.recover() == ([st3.get("q1"), st3.get("q2")], [])


def test_store_compact_rewrites_one_line_per_job(tmp_path):
    path = str(tmp_path / "jobs.jsonl")
    st1 = JobStore(path)
    j = JobRecord("j1", "noop")
    st1.put(j)
    for dst in (JobState.ADMITTED, JobState.RUNNING, JobState.FINISHED):
        j.transition(dst)
        st1.update(j)
    st1.close(compact=True)                # 4 lines -> 1
    assert len(open(path).read().splitlines()) == 1
    st2 = JobStore(path)
    back = st2.get("j1")
    assert back.state is JobState.FINISHED
    assert len(back.transitions) == 3      # history survives compaction


# ======================================================================
# Monitor: EWMA, spikes, cooldown, drift
# ======================================================================

def test_ewma_converges():
    e = Ewma(alpha=0.5)
    assert e.get(7.0) == 7.0               # default until first update
    e.update(10.0)
    assert e.value == 10.0                 # first observation seeds
    e.update(0.0)
    assert e.value == 5.0


def test_spike_detector_fires_before_absorbing_and_cools_down():
    d = SpikeDetector(factor=3.0, floor=2.0, cooldown_s=1.0, alpha=0.5)
    assert not d.observe(1.0, now=0.0)     # below 3*floor
    assert d.observe(20.0, now=1.0)        # step change: spike pre-absorb
    assert d.active(now=1.5) and not d.active(now=2.5)
    # once the baseline has absorbed the new level, it is not a spike
    for t in range(2, 8):
        d.observe(20.0, now=float(t))
    assert not d.observe(20.0, now=9.0)
    assert d.spikes >= 1


def test_monitor_depth_spike_opens_cooldown_and_snapshot_reports_it():
    depth = {"v": 0}
    mon = RuntimeMonitor(None, interval_s=None, spike_factor=3.0,
                         spike_floor=2.0, cooldown_s=5.0,
                         queue_depth_fn=lambda: depth["v"])
    t = [0.0]

    def sample():
        t[0] += 0.1
        return mon.sample_once(now=t[0])

    for _ in range(5):
        snap = sample()
    assert not snap.spiking
    depth["v"] = 50                        # burst lands
    snap = sample()
    assert snap.spiking and snap.cooldown_remaining_s > 4.0
    assert snap.queue_depth == 50
    assert mon.stats()["monitor_spikes"] >= 1


def test_monitor_arrival_rate_uses_window_not_instant():
    arr = {"v": 0}
    mon = RuntimeMonitor(None, interval_s=None, spike_factor=3.0,
                         spike_floor=4.0, rate_floor=4.0, rate_window_s=1.0,
                         arrivals_fn=lambda: arr["v"])
    now = 0.0
    for _ in range(20):                    # steady 1 job per 0.02s = 50/s?
        now += 0.02
        arr["v"] += 0                      # no arrivals: baseline
        mon.sample_once(now=now)
    arr["v"] += 1                          # ONE submit between samples
    snap = mon.sample_once(now=now + 0.02)
    # one arrival over the 1s window is 1 job/s, far below 3*floor=12 —
    # must NOT read as a 50/s instantaneous spike.
    assert not snap.spiking
    arr["v"] += 40                         # genuine burst
    snap = mon.sample_once(now=now + 0.04)
    assert snap.spiking


def test_monitor_drift_alarm_needs_persistence():
    from repro_torch.core.scheduler import make_scheduler
    s = make_scheduler("parallel", simulate=True)
    mon = RuntimeMonitor(s, interval_s=None, drift_grace=2)
    assert mon.sample_once(now=1.0).drift_alarms == 0
    # corrupt the pool ledger: logical accounting now disagrees with itself
    s.memory.pools[0].add(0xDEAD, 1234)
    snap = mon.sample_once(now=2.0)
    assert snap.drift_alarms == 0          # one dirty sample: grace
    snap = mon.sample_once(now=3.0)
    assert snap.drift_alarms == 1          # persisted: alarm
    assert any("untracked" in p for p in snap.drift_problems)
    s.memory.pools[0].discard(0xDEAD)      # repaired: streak resets
    snap = mon.sample_once(now=4.0)
    assert snap.drift_alarms == 1 and mon._drift_streak == 0
    s.close()


def test_memory_logical_vs_physical_byte_accounting():
    import numpy as np
    from repro_torch.core.scheduler import make_scheduler
    s = make_scheduler("parallel", simulate=True)
    a = s.array(np.zeros(256, np.float32), name="a")
    b = s.array(np.zeros(64, np.float32), name="b")
    from repro_torch.core import const, out
    s._launch(None, [const(a), out(b)], name="k", cost_s=1e-4)
    s.sync()
    logical = s.memory.logical_resident_bytes()
    assert logical[0] == a.nbytes + b.nbytes
    # the simulator installs no physical device values
    assert s.memory.physical_resident_bytes()[0] == 0
    s.close()


# ======================================================================
# Admission policy
# ======================================================================

def _snap(**kw):
    from repro_torch.daemon.monitor import MonitorSnapshot
    return MonitorSnapshot(**kw)


def test_policy_sheds_on_full_queue_and_spike_but_not_high_priority():
    pol = AdmissionPolicy(max_queue_depth=10, spike_shed_depth=4,
                          shed_below_priority=1)
    lo, hi = JobRecord("lo", "noop", priority=0), \
        JobRecord("hi", "noop", priority=5)
    assert pol.admit(lo, _snap(queue_depth=3)).admitted
    d = pol.admit(lo, _snap(queue_depth=10))
    assert d.action == "shed" and "queue_full" in d.reason
    d = pol.admit(lo, _snap(queue_depth=6, spiking=True))
    assert d.action == "shed" and "spike" in d.reason
    # a spike must not lock out the latency tenant
    assert pol.admit(hi, _snap(queue_depth=6, spiking=True)).admitted
    # below the spike-shed depth, low priority is still admitted
    assert pol.admit(lo, _snap(queue_depth=2, spiking=True)).admitted
    assert pol.stats()["policy_shed"] == 2


def test_policy_dispatch_defers_on_slots_memory_and_cooldown():
    pol = AdmissionPolicy(max_running=2, mem_high_watermark=0.9)
    j = JobRecord("j", "noop", priority=0)
    assert pol.dispatch(j, _snap(running=1)).admitted
    d = pol.dispatch(j, _snap(running=2))
    assert not d.admitted and "running_slots" in d.reason
    d = pol.dispatch(j, _snap(mem_occupancy=0.95))
    assert not d.admitted and "mem_pressure" in d.reason
    d = pol.dispatch(j, _snap(spiking=True))
    assert not d.admitted and "cooldown" in d.reason
    hi = JobRecord("h", "noop", priority=9)
    assert pol.dispatch(hi, _snap(spiking=True)).admitted
    s = pol.stats()
    assert s["policy_defer_events"] == 3
    assert s["policy_deferred_jobs"] == 1  # same job deferred thrice


# ======================================================================
# Wire framing
# ======================================================================

def test_wire_roundtrip_and_eof():
    a, b = socket.socketpair()
    try:
        msgs = [{"op": "ping"}, {"x": [1, 2.5, None, "é"]}, {}]
        for m in msgs:
            send_msg(a, m)
        for m in msgs:
            assert recv_msg(b) == m
        a.close()
        assert recv_msg(b) is None         # clean EOF
    finally:
        b.close()


def test_wire_rejects_oversized_header():
    a, b = socket.socketpair()
    try:
        a.sendall(b"\xff\xff\xff\xff")
        with pytest.raises(ProtocolError):
            recv_msg(b)
    finally:
        a.close()
        b.close()


# ======================================================================
# JobContext + run_job
# ======================================================================

def test_job_context_checkpoint_cancel_and_pause_callbacks():
    ctx = JobContext(None, "j1")
    ctx.checkpoint()
    events = []
    ctx.on_pause = lambda: (events.append("pause"), ctx.pause_event.set())
    ctx.on_resume = lambda: events.append("resume")
    ctx.pause_event.clear()
    ctx.checkpoint()                       # pauses, callback resumes it
    assert events == ["pause", "resume"] and ctx.paused_times == 1
    ctx.cancel_requested = True
    with pytest.raises(JobCancelled):
        ctx.checkpoint()


def test_run_job_unknown_kind():
    with pytest.raises(ValueError, match="unknown job kind"):
        run_job(None, "nope")


def test_run_job_sleep_in_process():
    out = run_job(None, "sleep", {"total_s": 0.02, "steps": 2})
    assert out == {"slept_s": 0.02, "checkpoints": 2}


# ======================================================================
# Server end-to-end over the socket (sim scheduler, in-process server)
# ======================================================================

def test_server_submit_wait_status_stats_roundtrip(tmp_path):
    srv = _server(str(tmp_path))
    try:
        with DaemonClient(srv.socket_path) as c:
            assert c.ping()["ok"]
            r = c.submit("noop", {"k": [1, 2]}, tenant="acme", priority=3)
            job = c.wait(r["job_id"], timeout=10)
            assert job["state"] == "finished"
            assert job["result"] == {"echo": {"k": [1, 2]}}
            assert job["tenant"] == "acme" and job["priority"] == 3
            assert validate_history([tuple(t) for t in
                                     job["transitions"]]) == []
            assert c.status(r["job_id"])["state"] == "finished"
            st = c.stats()
            assert st["server"]["arrivals"] == 1
            assert st["policy"]["policy_admitted"] == 1
            assert st["store"]["by_state"] == {"finished": 1}
            assert "mem_occupancy" in st["scheduler"]
            assert st["job_tenant_stats"]["acme"]["finished"] == 1
            assert st["job_tenant_stats"]["acme"]["queue_delay_mean_s"] >= 0
            with pytest.raises(DaemonError, match="unknown job kind"):
                c.submit("not_a_kind")
            with pytest.raises(DaemonError, match="unknown job_id"):
                c.status("j-nope")
    finally:
        srv.stop()


def test_server_two_connections_interleave(tmp_path):
    srv = _server(str(tmp_path))
    try:
        c1, c2 = DaemonClient(srv.socket_path), DaemonClient(srv.socket_path)
        ids = [c.submit("sleep", {"total_s": 0.03, "steps": 3},
                        tenant=t)["job_id"]
               for c, t in [(c1, "a"), (c2, "b"), (c1, "a"), (c2, "b")]]
        for jid, c in zip(ids, [c2, c1, c2, c1]):   # cross-waiting is fine
            assert c.wait(jid, timeout=10)["state"] == "finished"
        c1.close()
        c2.close()
    finally:
        srv.stop()


def test_server_cancel_queued_and_running(tmp_path):
    srv = _server(str(tmp_path), workers=1)
    try:
        with DaemonClient(srv.socket_path) as c:
            blocker = c.submit("sleep", {"total_s": 5.0,
                                         "steps": 100})["job_id"]
            queued = c.submit("sleep", {"total_s": 5.0})["job_id"]
            # cancel while queued: immediate, never runs
            assert c.cancel(queued)["job"]["state"] == "cancelled"
            jq = c.status(queued)
            assert [tuple(t[:2]) for t in jq["transitions"]] == [
                ("queued", "cancelled")]
            # cancel while running: lands at the next checkpoint
            deadline = time.monotonic() + 5
            while c.status(blocker)["state"] != "running":
                assert time.monotonic() < deadline
                time.sleep(0.01)
            c.cancel(blocker)
            jb = c.wait(blocker, timeout=10)
            assert jb["state"] == "cancelled"
            assert jb["reason"] == "client cancel"
    finally:
        srv.stop()


def test_server_pause_resume_journals_transitions(tmp_path):
    srv = _server(str(tmp_path), workers=1)
    try:
        with DaemonClient(srv.socket_path) as c:
            jid = c.submit("sleep", {"total_s": 3.0,
                                     "steps": 60})["job_id"]
            deadline = time.monotonic() + 5
            while c.status(jid)["state"] != "running":
                assert time.monotonic() < deadline
                time.sleep(0.01)
            c.pause(jid)
            while c.status(jid)["state"] != "paused":
                assert time.monotonic() < deadline
                time.sleep(0.01)
            c.resume(jid)
            c.cancel(jid)
            job = c.wait(jid, timeout=10)
            edges = [tuple(t[:2]) for t in job["transitions"]]
            assert ("running", "paused") in edges
            assert ("paused", "running") in edges
            assert validate_history([tuple(t) for t in
                                     job["transitions"]]) == []
    finally:
        srv.stop()


def test_server_failed_job_reports_reason(tmp_path):
    srv = _server(str(tmp_path))
    try:
        with DaemonClient(srv.socket_path) as c:
            jid = c.submit("sleep", {"total_s": "not-a-number"})["job_id"]
            job = c.wait(jid, timeout=10)
            assert job["state"] == "failed"
            assert "float" in job["reason"] or "str" in job["reason"]
            with pytest.raises(DaemonError, match="ended failed"):
                c.result(jid)
    finally:
        srv.stop()


def test_server_drain_blocks_submissions_then_resumes(tmp_path):
    srv = _server(str(tmp_path))
    try:
        with DaemonClient(srv.socket_path) as c:
            jid = c.submit("sleep", {"total_s": 0.05})["job_id"]
            # drain finishes *running* jobs and claims no queued one: wait
            # until a dispatcher has claimed the job (it may finish too)
            deadline = time.monotonic() + 10
            while c.status(jid)["state"] == "queued":
                assert time.monotonic() < deadline
                time.sleep(0.01)
            d = c.drain(timeout=10)
            assert d["drained"] and d["running"] == 0
            assert c.status(jid)["state"] == "finished"
            with pytest.raises(DaemonError, match="draining"):
                c.submit("noop")
            c.resume_admission()
            assert c.submit("noop")["ok"]
    finally:
        srv.stop()


def test_server_sheds_under_sustained_overload_admits_when_calm(tmp_path):
    policy = AdmissionPolicy(max_queue_depth=12, spike_shed_depth=4,
                             shed_below_priority=1, max_running=1)
    srv = _server(str(tmp_path), workers=1, policy=policy,
                  monitor=RuntimeMonitor(interval_s=0.02, spike_factor=3.0,
                                         spike_floor=2.0, rate_floor=50.0,
                                         cooldown_s=2.0),
                  monitor_interval_s=0.02)
    try:
        with DaemonClient(srv.socket_path) as c:
            # calm wave: trickled submissions all admitted
            for _ in range(3):
                assert c.submit("sleep", {"total_s": 0.01})["ok"]
                time.sleep(0.05)
            assert srv.policy.shed == 0
            # overload: burst to build depth, pause a beat for the monitor
            # to see the step change, then keep pushing into the cooldown
            outcomes = []
            for _wave in range(3):
                for _ in range(10):
                    outcomes.append(c.submit(
                        "sleep", {"total_s": 0.3, "steps": 3}))
                time.sleep(0.08)
            shed = [o for o in outcomes if o.get("shed")]
            assert shed, "sustained overload must shed low-priority work"
            assert all("shed:" in o["reason"] for o in shed)
            # shed jobs are journaled QUEUED -> CANCELLED, legally
            job = c.status(shed[0]["job_id"])
            assert job["state"] == "cancelled"
            assert [tuple(t[:2]) for t in job["transitions"]] == [
                ("queued", "cancelled")]
            # high-priority work still gets in during the storm
            assert c.submit("sleep", {"total_s": 0.01},
                            priority=5)["ok"]
            st = c.stats(scheduler=False)
            assert st["policy"]["policy_shed"] == len(shed)
            assert st["monitor"]["monitor_spikes"] >= 1
    finally:
        srv.stop()


def test_server_restart_on_same_socket_path(tmp_path):
    srv = _server(str(tmp_path))
    srv.stop()
    srv2 = _server(str(tmp_path))          # stale paths are reclaimed
    try:
        with DaemonClient(srv2.socket_path) as c:
            assert c.ping()["ok"]
    finally:
        srv2.stop()


# ======================================================================
# Two concurrent client *processes* via the CLI, bit-identical results
# ======================================================================

def _cli(sock, *args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.daemon", "--socket", sock, *args],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": SRC}, cwd=REPO)


def test_two_cli_processes_bit_identical_to_in_process(tmp_path):
    from repro_torch.core.scheduler import make_scheduler
    specs = [{"n": 3, "size": 128, "seed": 11}, {"n": 4, "size": 96,
                                                 "seed": 23}]
    # real executor on CPU lanes: the daemon's path
    with make_scheduler("parallel", device="cpu") as s:
        expected = [run_job(s, "chain", p) for p in specs]

    srv = DaemonServer(str(tmp_path / "d.sock"),
                       store_path=str(tmp_path / "jobs.jsonl"),
                       sched_kw={"device": "cpu"}, workers=2).start()
    try:
        results = [None, None]
        errs = [None, None]

        def client(i):
            try:
                p = specs[i]
                proc = _cli(srv.socket_path, "submit", "chain",
                            "-p", f"n={p['n']}", "-p", f"size={p['size']}",
                            "-p", f"seed={p['seed']}", "--wait")
                assert proc.returncode == 0, proc.stderr
                results[i] = json.loads(proc.stdout)
            except BaseException as exc:   # surfaced below
                errs[i] = exc

        ts = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=240)
        assert errs == [None, None], errs
        for i, job in enumerate(results):
            assert job["state"] == "finished", job
            assert job["result"] == expected[i]   # bit-identical floats
    finally:
        srv.stop()


def test_cli_socket_roundtrip_smoke(tmp_path):
    """The CI smoke path: serve in a subprocess, ping + noop over the
    socket from a second process, clean shutdown."""
    sock = str(tmp_path / "d.sock")
    env = {**os.environ, "PYTHONPATH": SRC,
           "REPRO_DAEMON_SOCKET": sock,
           "REPRO_DAEMON_STORE": str(tmp_path / "jobs.jsonl")}
    serve = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.daemon", "serve", "--executor",
         "sim"],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 30
        while not os.path.exists(sock):
            assert time.monotonic() < deadline, "daemon never bound"
            time.sleep(0.05)
        out = _cli(sock, "submit", "noop", "-p", "hello=1", "--wait")
        assert out.returncode == 0, out.stderr
        job = json.loads(out.stdout)
        assert job["result"] == {"echo": {"hello": 1}}
        assert _cli(sock, "stats", "--no-scheduler").returncode == 0
        assert _cli(sock, "shutdown").returncode == 0
        assert serve.wait(timeout=30) == 0
    finally:
        if serve.poll() is None:
            serve.kill()
            serve.wait()


# ======================================================================
# The port's own: devices, serve_lm, the CLI on CPU lanes
# ======================================================================

def test_client_side_imports_no_torch():
    """A client process (``DaemonClient``, the CLI's client verbs) loads
    neither torch nor the scheduler; ``DaemonServer`` does, on first use."""
    code = ("import sys\n"
            "import repro_torch.daemon as d\n"
            "from repro_torch.daemon import cli, DaemonClient, JobStore\n"
            "assert 'torch' not in sys.modules, 'client loaded torch'\n"
            "assert d.DaemonServer.__name__ == 'DaemonServer'\n"
            "assert 'torch' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr


def test_serve_without_a_card_raises_and_never_binds(tmp_path):
    """``serve`` defaults to ``--device cuda``: with no visible card the
    threads executor raises at startup; it never serves on the host."""
    sock = str(tmp_path / "d.sock")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.daemon", "--socket", sock,
         "serve", "--store", str(tmp_path / "jobs.jsonl")],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": SRC, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "device='cuda'" in proc.stderr, proc.stderr
    assert not os.path.exists(sock)


def test_simulated_daemon_serve_lm_raises_instead_of_using_the_cpu(
        tmp_path):
    from repro_torch.core import make_scheduler
    with make_scheduler("parallel", simulate=True) as s:
        with pytest.raises(RuntimeError, match="simulated daemon"):
            run_job(s, "serve_lm")
    srv = _server(str(tmp_path))
    try:
        with DaemonClient(srv.socket_path) as c:
            job = c.wait(c.submit("serve_lm")["job_id"], timeout=30)
        assert job["state"] == "failed"
        assert "simulated daemon" in job["reason"]
    finally:
        srv.stop()


def test_serve_lm_job_on_cpu_daemon_equals_direct_engine(tmp_path):
    """The daemon's default LM job (reduced qwen2-moe) on CPU lanes gives
    the tokens of a direct ``ServingEngine`` call with the same seed."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.runtime.serving import ServingEngine
    params = {"requests": 3, "prompt_len": 8, "new_tokens": 3, "seed": 5}
    srv = _server(str(tmp_path), sched_kw={"device": "cpu"})
    try:
        with DaemonClient(srv.socket_path) as c:
            res = c.result(c.submit("serve_lm", params,
                                    tenant="lm")["job_id"], timeout=120)
    finally:
        srv.stop()
    cfg = get_config("qwen2_moe_a2_7b", reduced=True)
    model = init_lm(cfg, torch.Generator("cpu").manual_seed(5), "cpu")
    rng = np.random.RandomState(5)
    with ServingEngine(cfg, model, batch_size=2, max_new_tokens=3,
                       device="cpu", use_flash=False) as eng:
        reqs = [eng.submit(rng.randint(0, cfg.vocab, 8)) for _ in range(3)]
        eng.drain()
    assert res["generations"] == [[int(t) for t in r.result] for r in reqs]
    assert res["tenant_stats"]["elements"] >= 2


def test_cli_serve_on_cpu_lanes_chain_matches_in_process(tmp_path):
    """``serve --device cpu`` in a subprocess: a chain job submitted from
    a second process equals ``run_job`` on an in-process CPU scheduler bit
    for bit; the journal audits clean after shutdown."""
    from repro_torch.core.scheduler import make_scheduler
    sock, store = str(tmp_path / "d.sock"), str(tmp_path / "jobs.jsonl")
    spec = {"n": 4, "size": 8192, "seed": 3}
    with make_scheduler("parallel", device="cpu") as s:
        expected = run_job(s, "chain", spec)
    serve = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.daemon", "--socket", sock,
         "serve", "--device", "cpu", "--store", store],
        env={**os.environ, "PYTHONPATH": SRC}, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(sock):
            assert serve.poll() is None, "daemon died during startup"
            assert time.monotonic() < deadline, "daemon never bound"
            time.sleep(0.05)
        out = _cli(sock, "submit", "chain", *[f"-p{k}={v}"
                                              for k, v in spec.items()],
                   "--wait")
        assert out.returncode == 0, out.stderr
        job = json.loads(out.stdout)
        assert job["state"] == "finished", job
        assert job["result"] == expected
        assert _cli(sock, "shutdown").returncode == 0
        assert serve.wait(timeout=60) == 0
    finally:
        if serve.poll() is None:
            serve.kill()
            serve.wait()
    audit = _cli(sock, "jobs", "--audit", "--store", store)
    assert audit.returncode == 0, audit.stdout + audit.stderr
    assert json.loads(audit.stdout)["ok"] is True


# ======================================================================
# Parity with repro.daemon on the same inputs
# ======================================================================

@pytest.mark.parametrize("spec", [
    {"n": 3, "size": 128, "seed": 11},
    {"n": 4, "size": 96, "seed": 23},
    {"n": 2, "size": 4096, "seed": 5},
])
def test_chain_job_matches_reference_job(spec):
    """The torch chain kernels against the reference's jitted ones: sum,
    absmax and values within rtol 1e-6 (the same float32 operations; XLA
    may contract ``x*x*0.5 + 0.25*x`` into FMAs and sum in another order,
    so equality is not required, though these inputs agree bit for
    bit)."""
    import numpy as np
    from repro.core import make_scheduler as jmake
    from repro.daemon.jobs import run_job as jrun
    from repro_torch.core import make_scheduler
    with jmake("parallel") as s:
        want = jrun(s, "chain", spec)
    with make_scheduler("parallel", device="cpu") as s:
        got = run_job(s, "chain", spec)
    assert set(got) == set(want) == {"sum", "absmax", "values"}
    for key in ("sum", "absmax"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    np.testing.assert_allclose(got["values"], want["values"], rtol=1e-6)


def _journal_sequence(pkg, path):
    """One fixed job sequence through ``pkg``'s store: every lifecycle
    edge, a restart with recovery, the audit, and a compaction."""
    JR, JS = pkg.JobRecord, pkg.JobState
    st1 = pkg.JobStore(path)
    walks = {
        "j1": ["admitted", "running", "finished"],
        "j2": ["cancelled"],
        "j3": ["admitted", "running", "paused", "running", "failed"],
        "j4": [],
        "j5": ["admitted", "running"],
        "j6": ["admitted", "running", "paused"],
    }
    for i, (jid, walk) in enumerate(walks.items()):
        job = JR(jid, "sleep", params={"i": i}, tenant=f"t{i % 2}",
                 priority=i % 3, submit_t=100.0 + i)
        st1.put(job)
        for name in walk:
            job.transition(JS(name), reason="shed:spike" if jid == "j2"
                           else "")
            if name == "finished":
                job.result = {"echo": i}
            st1.update(job)
    st1.close(compact=False)
    first = open(path).read()
    st2 = pkg.JobStore(path)
    requeued, failed = st2.recover()
    audit = st2.audit().to_json()
    audit.pop("path")                   # the two journals' own paths
    st2.close(compact=True)
    return (first, [j.job_id for j in requeued], [j.job_id for j in failed],
            audit, open(path).read())


def test_journal_lines_and_audit_equal_reference(tmp_path, monkeypatch):
    import repro.daemon as J
    import repro_torch.daemon as T
    results = []
    for tag, pkg in (("ref", J), ("port", T)):
        clock = iter(range(1000, 2000))
        monkeypatch.setattr(time, "time", lambda c=clock: float(next(c)))
        results.append(_journal_sequence(pkg, str(tmp_path / f"{tag}.jsonl")))
    ref, port = results
    assert port[0].splitlines() == ref[0].splitlines()     # journal lines
    assert port[1:4] == ref[1:4]         # requeued, failed, audit record
    assert port[1] == ["j4"] and sorted(port[2]) == ["j5", "j6"]
    assert port[3]["ok"] is True
    assert port[4].splitlines() == ref[4].splitlines()     # compacted


def test_admission_decisions_equal_reference():
    """The same snapshots and jobs through both packages' policies: the
    same admit/defer/shed actions, reasons and counters."""
    import numpy as np
    import repro.daemon as J
    import repro_torch.daemon as T
    rng = np.random.RandomState(0)
    kw = dict(max_queue_depth=20, spike_shed_depth=5, shed_below_priority=1,
              max_running=3, mem_high_watermark=0.8)
    jpol, tpol = J.AdmissionPolicy(**kw), T.AdmissionPolicy(**kw)
    actions = set()
    for i in range(300):
        fields = dict(t=float(i), queue_depth=int(rng.randint(0, 30)),
                      running=int(rng.randint(0, 5)),
                      mem_occupancy=float(rng.uniform(0, 1)),
                      spiking=bool(rng.rand() < 0.4),
                      cooldown_remaining_s=float(rng.uniform(0, 1)))
        jid, prio = f"j{rng.randint(0, 40)}", int(rng.randint(0, 3))
        for op in ("admit", "dispatch"):
            jd = getattr(jpol, op)(J.JobRecord(jid, "noop", priority=prio),
                                   J.MonitorSnapshot(**fields))
            td = getattr(tpol, op)(T.JobRecord(jid, "noop", priority=prio),
                                   T.MonitorSnapshot(**fields))
            assert (td.action, td.reason) == (jd.action, jd.reason)
            actions.add(td.action)
    assert actions == {"admit", "defer", "shed"}
    assert tpol.stats() == jpol.stats()


def test_monitor_snapshots_equal_reference():
    """Both monitors fed the same gauges at the same instants: the same
    EWMAs, spikes, cooldowns and snapshots."""
    import dataclasses
    import numpy as np
    import repro.daemon as J
    import repro_torch.daemon as T
    rng = np.random.RandomState(1)
    gauges = {"depth": 0, "running": 0, "arrivals": 0}
    mons = [pkg.RuntimeMonitor(
        None, interval_s=None, spike_factor=3.0, spike_floor=2.0,
        rate_floor=20.0, cooldown_s=0.3,
        queue_depth_fn=lambda: gauges["depth"],
        running_fn=lambda: gauges["running"],
        arrivals_fn=lambda: gauges["arrivals"]) for pkg in (J, T)]
    spiked = False
    for i in range(200):
        burst = rng.rand() < 0.05
        gauges["depth"] = int(rng.randint(30, 60) if burst
                              else rng.randint(0, 4))
        gauges["running"] = int(rng.randint(0, 3))
        gauges["arrivals"] += int(rng.randint(20, 40) if burst
                                  else rng.randint(0, 2))
        now = 0.02 * (i + 1)
        jsnap, tsnap = (m.sample_once(now=now) for m in mons)
        assert dataclasses.asdict(tsnap) == dataclasses.asdict(jsnap)
        spiked |= tsnap.spiking
    assert spiked
    for key in ("monitor_samples", "monitor_spikes",
                "monitor_queue_depth_ewma", "monitor_arrival_rate_ewma"):
        assert mons[1].stats()[key] == mons[0].stats()[key]
