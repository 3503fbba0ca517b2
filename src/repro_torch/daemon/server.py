"""DaemonServer — the resident runtime behind a Unix domain socket.

One process owns one :class:`~repro_torch.core.scheduler.GrScheduler`; any number
of client processes submit jobs over length-prefixed JSON (``wire.py``).
Jobs are journaled to a persistent :class:`~repro_torch.daemon.store.JobStore`,
walked through the strict lifecycle state machine, admission-controlled by
an EWMA monitor + policy pair, and executed by dispatcher threads on the
shared scheduler through the thread-safe SubmissionPipeline — the
multi-tenant QoS, deadline and memory machinery all apply across *process*
boundaries exactly as they do across threads.

Request ops: ``ping, submit, status, wait, cancel, pause, resume, jobs,
stats, drain, resume_admission, shutdown``.
"""
from __future__ import annotations

import heapq
import itertools
import os
import socket
import threading
import time
import traceback
import uuid
from typing import Dict, List, Optional

from ..core.scheduler import GrScheduler, make_scheduler
from . import jobs as jobs_mod
from .jobs import JobCancelled, JobContext
from .lifecycle import JobRecord, JobState, TERMINAL_STATES
from .monitor import RuntimeMonitor
from .policy import AdmissionPolicy
from .store import JobStore
from .wire import recv_msg, send_msg


def _json_safe(obj):
    """Best-effort conversion of a stats tree to JSON-serializable types."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


class DaemonServer:
    def __init__(self, socket_path: str, *,
                 store: Optional[JobStore] = None,
                 store_path: Optional[str] = None,
                 scheduler: Optional[GrScheduler] = None,
                 sched_kw: Optional[dict] = None,
                 policy: Optional[AdmissionPolicy] = None,
                 monitor: Optional[RuntimeMonitor] = None,
                 workers: int = 2,
                 monitor_interval_s: Optional[float] = 0.05) -> None:
        self.socket_path = socket_path
        self.store = store if store is not None else JobStore(store_path)
        self._owns_scheduler = scheduler is None
        self.scheduler = scheduler or make_scheduler(**(sched_kw or {}))
        self.policy = policy or AdmissionPolicy()
        self.workers = max(1, int(workers))
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._heap: List[tuple] = []        # (-priority, deadline_t, seq, id)
        self._seq = itertools.count()
        self._queued = 0
        self._running: Dict[str, JobContext] = {}
        self._draining = False
        self._stop = threading.Event()
        self._started = False
        self.arrivals = 0
        self.completed = 0
        self.t_start = time.time()
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self.monitor = monitor or RuntimeMonitor(
            self.scheduler, interval_s=monitor_interval_s)
        # Gauges the monitor samples; installed whether or not the monitor
        # was supplied by the caller.
        self.monitor.scheduler = self.scheduler
        self.monitor.queue_depth_fn = lambda: self._queued
        self.monitor.running_fn = lambda: len(self._running)
        self.monitor.arrivals_fn = lambda: self.arrivals

    # ------------------------------------------------------------------
    # Lifecycle of the server itself
    # ------------------------------------------------------------------
    def start(self) -> "DaemonServer":
        if self._started:
            return self
        self._started = True
        requeued, failed = self.store.recover()
        with self._cond:
            for job in requeued:
                self._push_locked(job)
            self._cond.notify_all()
        if failed:
            self.completed += len(failed)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)     # stale socket from a dead daemon
        os.makedirs(os.path.dirname(self.socket_path) or ".", exist_ok=True)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen(64)
        self._listener.settimeout(0.2)
        for i in range(self.workers):
            t = threading.Thread(target=self._dispatch_loop,
                                 name=f"repro-daemon-dispatch-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._accept_loop,
                             name="repro-daemon-accept", daemon=True)
        t.start()
        self._threads.append(t)
        self.monitor.start()
        return self

    def serve_forever(self) -> None:
        self.start()
        try:
            while not self._stop.wait(0.2):
                pass
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self, *, drain: bool = True) -> None:
        """Graceful shutdown: stop admitting, optionally finish running
        jobs, persist the store (compacted) and close the scheduler."""
        if self._stop.is_set():
            return
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        if drain:
            self.wait_idle(timeout=30.0, queue_too=False)
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        listener, self._listener = self._listener, None
        if listener is not None:
            listener.close()
        for c in list(self._conns):
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()
        self.monitor.stop()
        self.store.close(compact=True)
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
        if self._owns_scheduler:
            self.scheduler.close()

    def wait_idle(self, timeout: float = 30.0, *,
                  queue_too: bool = True) -> bool:
        """Block until no job is running (and, with ``queue_too``, none is
        queued).  Returns False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._running or (queue_too and self._queued):
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=min(left, 0.2))
        return True

    # ------------------------------------------------------------------
    # Queue internals (callers hold self._cond)
    # ------------------------------------------------------------------
    def _push_locked(self, job: JobRecord) -> None:
        deadline_t = (job.submit_t + job.deadline_s
                      if job.deadline_s is not None else float("inf"))
        heapq.heappush(self._heap,
                       (-job.priority, deadline_t, next(self._seq),
                        job.job_id))
        self._queued += 1

    def _pop_locked(self) -> Optional[JobRecord]:
        while self._heap:
            _, _, _, job_id = heapq.heappop(self._heap)
            self._queued -= 1
            job = self.store.get(job_id)
            if job is not None and job.state is JobState.QUEUED:
                return job
            # Cancelled while queued (or unknown): drop silently.
        return None

    def _snap(self):
        # Background monitor running: its latest sample is fresh enough.
        # No background thread (deterministic tests): sample synchronously.
        if self.monitor.interval_s is not None and not self._stop.is_set():
            snap = self.monitor.last
            if snap is not None and time.monotonic() - snap.t \
                    <= 4 * self.monitor.interval_s:
                return snap
        return self.monitor.sample_once()

    def _transition(self, job: JobRecord, dst: JobState, *,
                    reason: str = "") -> None:
        with self._cond:
            job.transition(dst, reason=reason)
            self.store.update(job)
            if job.terminal:
                self.completed += 1
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # Dispatchers
    # ------------------------------------------------------------------
    def _claim_next(self, timeout: float) -> Optional[JobRecord]:
        with self._cond:
            if self._stop.is_set() or self._draining or not self._queued:
                self._cond.wait(timeout=timeout)
                return None
            return self._pop_locked()

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            job = self._claim_next(timeout=0.05)
            if job is None:
                continue
            snap = self._snap()
            decision = self.policy.dispatch(job, snap)
            if not decision.admitted:
                with self._cond:
                    # Keep its queue position; retry after the backoff.
                    self._push_locked(job)
                self._stop.wait(self.policy.defer_backoff_s)
                continue
            self._run_job(job)

    def _run_job(self, job: JobRecord) -> None:
        ctx = JobContext(self.scheduler, job.job_id, tenant=job.tenant,
                         priority=job.priority, deadline_s=job.deadline_s)
        ctx.on_pause = lambda: self._transition(job, JobState.PAUSED,
                                                reason="paused")
        ctx.on_resume = lambda: self._transition(job, JobState.RUNNING,
                                                 reason="resumed")
        with self._cond:
            if job.state is not JobState.QUEUED:   # cancel raced the claim
                return
            job.transition(JobState.ADMITTED)
            self.store.update(job)
            self._running[job.job_id] = ctx
        try:
            self._transition(job, JobState.RUNNING)
            result = jobs_mod.run_job(self.scheduler, job.kind, job.params,
                                      ctx=ctx)
            with self._cond:
                job.result = result
            self._transition(job, JobState.FINISHED)
        except JobCancelled:
            self._transition(job, JobState.CANCELLED,
                             reason=job.reason or "cancelled")
        except Exception as exc:
            self._transition(job, JobState.FAILED,
                             reason=f"{type(exc).__name__}: {exc}\n"
                                    f"{traceback.format_exc(limit=4)}")
        finally:
            with self._cond:
                self._running.pop(job.job_id, None)
                self._cond.notify_all()

    # ------------------------------------------------------------------
    # Request handling
    # ------------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            listener = self._listener
            if listener is None:
                return
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="repro-daemon-conn", daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    req = recv_msg(conn)
                except (OSError, ValueError):
                    break
                if req is None:
                    break
                try:
                    resp = self.handle(req)
                except Exception as exc:
                    resp = {"ok": False,
                            "error": f"{type(exc).__name__}: {exc}"}
                # A shutdown op must not close this connection before its
                # reply is on the wire: run the trigger after send_msg.
                after = resp.pop("_after", None) \
                    if isinstance(resp, dict) else None
                try:
                    send_msg(conn, resp)
                except OSError:
                    break
                if after is not None:
                    after()
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if conn in self._conns:
                self._conns.remove(conn)

    # -- ops -------------------------------------------------------------
    def handle(self, req: dict) -> dict:
        op = req.get("op")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            return {"ok": False, "error": f"unknown op {op!r}"}
        return fn(req)

    def _op_ping(self, req: dict) -> dict:
        return {"ok": True, "pid": os.getpid(),
                "uptime_s": time.time() - self.t_start}

    def _op_submit(self, req: dict) -> dict:
        spec = req.get("job") or {}
        kind = spec.get("kind")
        if kind not in jobs_mod.REGISTRY:
            return {"ok": False, "error": f"unknown job kind {kind!r}; "
                    f"registered: {sorted(jobs_mod.REGISTRY)}"}
        if self._draining:
            return {"ok": False, "error": "daemon is draining",
                    "draining": True}
        with self._cond:
            self.arrivals += 1
        job = JobRecord(
            job_id=f"j-{uuid.uuid4().hex[:12]}", kind=kind,
            params=dict(spec.get("params") or {}),
            tenant=str(spec.get("tenant", "default")),
            priority=int(spec.get("priority", 0)),
            deadline_s=spec.get("deadline_s"),
            submit_t=time.time())
        snap = self._snap()
        decision = self.policy.admit(job, snap)
        with self._cond:
            self.store.put(job)             # journal: born QUEUED
            if decision.admitted:
                self._push_locked(job)
                self._cond.notify_all()
        if not decision.admitted:           # shed: QUEUED -> CANCELLED
            self._transition(job, JobState.CANCELLED, reason=decision.reason)
            return {"ok": False, "shed": True, "job_id": job.job_id,
                    "reason": decision.reason}
        return {"ok": True, "job_id": job.job_id, "state": job.state.value}

    def _require_job(self, req: dict) -> JobRecord:
        job = self.store.get(str(req.get("job_id")))
        if job is None:
            raise KeyError(f"unknown job_id {req.get('job_id')!r}")
        return job

    def _op_status(self, req: dict) -> dict:
        job = self._require_job(req)
        return {"ok": True, "job": job.to_json()}

    def _op_wait(self, req: dict) -> dict:
        job = self._require_job(req)
        deadline = time.monotonic() + float(req.get("timeout", 60.0))
        with self._cond:
            while job.state not in TERMINAL_STATES:
                left = deadline - time.monotonic()
                if left <= 0:
                    return {"ok": False, "timed_out": True,
                            "job": job.to_json()}
                self._cond.wait(timeout=min(left, 0.2))
        return {"ok": True, "job": job.to_json()}

    def _op_cancel(self, req: dict) -> dict:
        job = self._require_job(req)
        with self._cond:
            if job.state is JobState.QUEUED:
                job.transition(JobState.CANCELLED, reason="client cancel")
                self.store.update(job)
                self.completed += 1
                self._cond.notify_all()
                return {"ok": True, "job": job.to_json()}
            ctx = self._running.get(job.job_id)
            if ctx is not None:
                job.reason = "client cancel"
                ctx.cancel_requested = True
                ctx.pause_event.set()       # wake a paused job so it can die
                return {"ok": True, "cancelling": True,
                        "job": job.to_json()}
        return {"ok": job.terminal, "job": job.to_json(),
                "error": None if job.terminal else "not cancellable"}

    def _op_pause(self, req: dict) -> dict:
        job = self._require_job(req)
        with self._cond:
            ctx = self._running.get(job.job_id)
            if ctx is None:
                return {"ok": False, "error": "job is not running",
                        "job": job.to_json()}
            ctx.pause_event.clear()
        return {"ok": True, "job": job.to_json()}

    def _op_resume(self, req: dict) -> dict:
        job = self._require_job(req)
        with self._cond:
            ctx = self._running.get(job.job_id)
            if ctx is None:
                return {"ok": False, "error": "job is not running",
                        "job": job.to_json()}
            ctx.pause_event.set()
        return {"ok": True, "job": job.to_json()}

    def _op_jobs(self, req: dict) -> dict:
        rows = [{"job_id": j.job_id, "kind": j.kind, "tenant": j.tenant,
                 "priority": j.priority, "state": j.state.value,
                 "reason": j.reason}
                for j in self.store.jobs()]
        return {"ok": True, "jobs": rows}

    def _op_stats(self, req: dict) -> dict:
        with self._cond:
            server = {
                "uptime_s": time.time() - self.t_start,
                "arrivals": self.arrivals,
                "queued": self._queued,
                "running": len(self._running),
                "completed": self.completed,
                "draining": self._draining,
                "workers": self.workers,
            }
        out = {"ok": True, "server": server,
               "policy": self.policy.stats(),
               "monitor": self.monitor.stats(),
               "store": self.store.stats(),
               "job_tenant_stats": self.job_tenant_stats()}
        if req.get("scheduler", True):
            out["scheduler"] = _json_safe(self.scheduler.stats())
            out["tenant_stats"] = _json_safe(self.scheduler.tenant_stats())
        return out

    def _op_drain(self, req: dict) -> dict:
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        idle = self.wait_idle(timeout=float(req.get("timeout", 30.0)),
                              queue_too=False)
        with self._cond:
            return {"ok": idle, "drained": idle, "queued": self._queued,
                    "running": len(self._running)}

    def _op_resume_admission(self, req: dict) -> dict:
        with self._cond:
            self._draining = False
            self._cond.notify_all()
        return {"ok": True}

    def _op_shutdown(self, req: dict) -> dict:
        drain = bool(req.get("drain", True))

        def trigger() -> None:
            threading.Thread(target=self.stop, kwargs={"drain": drain},
                             name="repro-daemon-stop", daemon=True).start()

        return {"ok": True, "stopping": True, "_after": trigger}

    # ------------------------------------------------------------------
    def job_tenant_stats(self) -> dict:
        """Per-tenant job accounting from the lifecycle timestamps:
        queue delay (QUEUED -> first RUNNING), service time (first RUNNING
        -> terminal) and terminal-state counts, including sheds."""
        per: Dict[str, dict] = {}
        for job in self.store.jobs():
            d = per.setdefault(job.tenant, {
                "jobs": 0, "finished": 0, "failed": 0, "cancelled": 0,
                "shed": 0, "queue_delays": [], "service_times": []})
            d["jobs"] += 1
            if job.state in TERMINAL_STATES:
                d[job.state.value] += 1
                if job.reason.startswith("shed:"):
                    d["shed"] += 1
            run_t = job.transition_time(JobState.RUNNING)
            if run_t is not None:
                d["queue_delays"].append(run_t - job.submit_t)
                if job.terminal:
                    d["service_times"].append(
                        job.transitions[-1][2] - run_t)
        out = {}
        for tenant, d in per.items():
            qd, st = d.pop("queue_delays"), d.pop("service_times")
            d["queue_delay_mean_s"] = sum(qd) / len(qd) if qd else 0.0
            d["queue_delay_max_s"] = max(qd) if qd else 0.0
            d["service_mean_s"] = sum(st) / len(st) if st else 0.0
            out[tenant] = d
        return out
