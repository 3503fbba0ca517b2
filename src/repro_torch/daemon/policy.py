"""Admission control: admit / defer / shed, driven by monitor snapshots.

Two decision points, mirroring the job lifecycle:

* :meth:`AdmissionPolicy.admit` — at **submission** (QUEUED or not at all).
  A full queue or a spike-with-cooldown sheds low-priority work outright
  (the job is journaled QUEUED -> CANCELLED with a ``shed:`` reason, so
  the client gets an immediate, honest answer instead of an unbounded
  queue), subject to ``shed_below_priority``.
* :meth:`AdmissionPolicy.dispatch` — at **claim time** (QUEUED -> ADMITTED
  or stay QUEUED).  Running-slot limits, memory-occupancy watermarks and
  open cooldown windows *defer* the job: it keeps its queue position and
  is retried after ``defer_backoff_s``.

Deferring is deliberately separate from shedding: deferral trades latency
for completeness, shedding trades completeness for stability.  Counters for
every decision feed ``stats`` (and the daemon benchmark's gates).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

from .lifecycle import JobRecord
from .monitor import MonitorSnapshot

ADMIT = "admit"
DEFER = "defer"
SHED = "shed"


@dataclass(frozen=True)
class Decision:
    action: str                 # ADMIT | DEFER | SHED
    reason: str = ""

    @property
    def admitted(self) -> bool:
        return self.action == ADMIT


class AdmissionPolicy:
    """Threshold policy over :class:`MonitorSnapshot` gauges.

    Knobs (all per-instance, all surfaced on the CLI):

    * ``max_queue_depth`` — hard bound on QUEUED jobs; beyond it, shed.
    * ``spike_shed_depth`` — during a spike cooldown, shed jobs with
      ``priority <= shed_below_priority`` once the queue is this deep
      (high-priority work is still admitted: a spike must not lock out
      the latency tenant).
    * ``max_running`` — dispatch-side concurrency bound; defer above it.
    * ``mem_high_watermark`` — defer dispatch while the memory-occupancy
      EWMA is above this fraction of budget.
    * ``defer_in_cooldown`` — hold dispatch of sub-priority work while a
      cooldown window is open (the queue drains at the rate running work
      completes, which is the point of the window).
    """

    def __init__(self, *, max_queue_depth: int = 64,
                 spike_shed_depth: int = 8,
                 shed_below_priority: int = 1,
                 max_running: int = 8,
                 mem_high_watermark: float = 0.97,
                 defer_in_cooldown: bool = True,
                 defer_backoff_s: float = 0.01) -> None:
        self.max_queue_depth = int(max_queue_depth)
        self.spike_shed_depth = int(spike_shed_depth)
        self.shed_below_priority = int(shed_below_priority)
        self.max_running = int(max_running)
        self.mem_high_watermark = float(mem_high_watermark)
        self.defer_in_cooldown = bool(defer_in_cooldown)
        self.defer_backoff_s = float(defer_backoff_s)
        self._lock = threading.Lock()
        self.admitted = 0
        self.shed = 0
        self.deferred_jobs = 0              # distinct jobs ever deferred
        self.defer_events = 0               # total defer decisions
        self._deferred_seen = set()

    # ------------------------------------------------------------------
    def admit(self, job: JobRecord, snap: MonitorSnapshot) -> Decision:
        """Submission-time gate: queue the job, or shed it now."""
        with self._lock:
            if snap.queue_depth >= self.max_queue_depth:
                self.shed += 1
                return Decision(SHED, f"shed:queue_full "
                                      f"(depth {snap.queue_depth} >= "
                                      f"{self.max_queue_depth})")
            if (snap.spiking
                    and job.priority <= self.shed_below_priority
                    and snap.queue_depth >= self.spike_shed_depth):
                self.shed += 1
                return Decision(SHED, f"shed:spike "
                                      f"(depth {snap.queue_depth}, cooldown "
                                      f"{snap.cooldown_remaining_s:.3f}s)")
            self.admitted += 1
            return Decision(ADMIT)

    # ------------------------------------------------------------------
    def dispatch(self, job: JobRecord, snap: MonitorSnapshot) -> Decision:
        """Claim-time gate: run now, or keep queued and retry later."""
        with self._lock:
            decision = None
            if snap.running >= self.max_running:
                decision = Decision(DEFER, f"defer:running_slots "
                                           f"({snap.running} >= "
                                           f"{self.max_running})")
            elif snap.mem_occupancy > self.mem_high_watermark:
                decision = Decision(DEFER, f"defer:mem_pressure "
                                           f"({snap.mem_occupancy:.2f} > "
                                           f"{self.mem_high_watermark})")
            elif (self.defer_in_cooldown and snap.spiking
                    and job.priority <= self.shed_below_priority):
                decision = Decision(DEFER, "defer:cooldown")
            if decision is None:
                return Decision(ADMIT)
            self.defer_events += 1
            if job.job_id not in self._deferred_seen:
                self._deferred_seen.add(job.job_id)
                self.deferred_jobs += 1
            return decision

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"policy_admitted": self.admitted,
                    "policy_shed": self.shed,
                    "policy_deferred_jobs": self.deferred_jobs,
                    "policy_defer_events": self.defer_events,
                    "policy_max_queue_depth": self.max_queue_depth,
                    "policy_max_running": self.max_running}
