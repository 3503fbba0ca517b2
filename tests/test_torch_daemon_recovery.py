"""Crash recovery of the port's daemon (``repro_torch.daemon``), the suite
of ``tests/test_daemon_recovery.py``: SIGKILL the daemon mid-queue, restart
on the same store, and prove the restart contract — QUEUED jobs resume
exactly once, in-flight jobs are re-marked FAILED, and no journal ever
records an illegal history.
"""
import os
import signal
import subprocess
import sys
import time

from repro_torch.daemon import (DaemonClient, DaemonServer, JobState,
                                JobStore)
from repro_torch.daemon.lifecycle import validate_history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _spawn_daemon(sock, store, *extra):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.daemon", "--socket", sock,
         "serve",
         "--store", store, "--executor", "sim", "--workers", "1",
         "--monitor-interval", "0.02", *extra],
        env={**os.environ, "PYTHONPATH": SRC}, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 30
    while not os.path.exists(sock):
        assert proc.poll() is None, "daemon died during startup"
        assert time.monotonic() < deadline, "daemon never bound its socket"
        time.sleep(0.05)
    return proc


def test_sigkill_midqueue_then_restart_runs_queued_exactly_once(tmp_path):
    sock = str(tmp_path / "d.sock")
    store_path = str(tmp_path / "jobs.jsonl")
    proc = _spawn_daemon(sock, store_path)
    try:
        c = DaemonClient(sock)
        # one long job occupies the single worker; the rest stay QUEUED
        ids = [c.submit("sleep", {"total_s": 30.0, "steps": 300})["job_id"]]
        ids += [c.submit("sleep", {"total_s": 0.05, "steps": 2})["job_id"]
                for _ in range(4)]
        deadline = time.monotonic() + 10
        while c.status(ids[0])["state"] != "running":
            assert time.monotonic() < deadline
            time.sleep(0.02)
        c.close()
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)

    # Restart against the same store (in-process this time), drain it.
    srv = DaemonServer(sock, store_path=store_path,
                       sched_kw={"simulate": True}, workers=2,
                       monitor_interval_s=0.02).start()
    try:
        assert srv.wait_idle(timeout=30), "restarted daemon never drained"
        with DaemonClient(sock) as c2:
            killed = c2.status(ids[0])
            assert killed["state"] == "failed"
            assert killed["reason"] == "daemon restart"
            for jid in ids[1:]:
                job = c2.status(jid)
                assert job["state"] == "finished", job
                # exactly once: a single dispatcher ever admitted it
                assert job["attempts"] == 1
                admits = [t for t in job["transitions"]
                          if tuple(t[:2]) == ("queued", "admitted")]
                assert len(admits) == 1
    finally:
        srv.stop()

    # The full journal — both daemon generations — validates clean.
    final = JobStore(store_path)
    assert len(final) == 5
    for job in final.jobs():
        assert validate_history(job.transitions) == [], job.job_id
        assert job.terminal
    final.close(compact=False)


def test_sigkill_tears_at_most_one_record_and_restart_truncates(tmp_path):
    """Whatever instant the kill lands at, replay loses at most the record
    in flight, and the restarted journal stays appendable."""
    sock = str(tmp_path / "d.sock")
    store_path = str(tmp_path / "jobs.jsonl")
    proc = _spawn_daemon(sock, store_path)
    try:
        c = DaemonClient(sock)
        for _ in range(6):
            c.submit("sleep", {"total_s": 0.02, "steps": 1})
        c.close()
    finally:
        proc.send_signal(signal.SIGKILL)   # may land mid-append
        proc.wait(timeout=10)

    st = JobStore(store_path)              # replay + frontier truncation
    n = len(st)
    assert n >= 5                          # at most the in-flight record lost
    requeued, failed = st.recover()
    for j in st.jobs():
        assert validate_history(j.transitions) == []
    # journal is appendable and self-consistent after recovery
    st.close(compact=True)
    st2 = JobStore(store_path)
    assert len(st2) == n
    assert not any(j.state in (JobState.ADMITTED, JobState.RUNNING,
                               JobState.PAUSED) for j in st2.jobs())
    st2.close(compact=False)


def test_clean_shutdown_compacts_and_restart_requeues_nothing(tmp_path):
    sock = str(tmp_path / "d.sock")
    store_path = str(tmp_path / "jobs.jsonl")
    srv = DaemonServer(sock, store_path=store_path,
                       sched_kw={"simulate": True},
                       monitor_interval_s=0.02).start()
    with DaemonClient(sock) as c:
        for i in range(5):
            c.submit("noop", {"i": i})
        assert srv.wait_idle(timeout=10)
    srv.stop()                             # drain + compact
    assert len(open(store_path).read().splitlines()) == 5  # one line per job
    st = JobStore(store_path)
    requeued, failed = st.recover()
    assert requeued == [] and failed == []
    assert all(j.state is JobState.FINISHED for j in st.jobs())
    st.close(compact=False)


def test_restart_preserves_results_for_status_queries(tmp_path):
    sock = str(tmp_path / "d.sock")
    store_path = str(tmp_path / "jobs.jsonl")
    srv = DaemonServer(sock, store_path=store_path,
                       sched_kw={"simulate": True},
                       monitor_interval_s=0.02).start()
    with DaemonClient(sock) as c:
        jid = c.submit("noop", {"payload": "kept"})["job_id"]
        res = c.result(jid, timeout=10)
    srv.stop()
    srv2 = DaemonServer(sock, store_path=store_path,
                        sched_kw={"simulate": True},
                        monitor_interval_s=0.02).start()
    try:
        with DaemonClient(sock) as c2:
            job = c2.status(jid)
            assert job["state"] == "finished" and job["result"] == res
    finally:
        srv2.stop()
