"""Deadline/SLO-aware scheduling: EDF risk tracking + element-boundary
preemption (ROADMAP "Deadline/SLO-aware scheduling with preemption").

The paper's scheduler optimizes makespan; the priority weights shape
*capacity*.  Neither bounds *latency*: under contention a latency-critical
element can queue behind an arbitrarily long bulk tail, so p99 is unbounded.
This module adds the missing piece — per-launch deadlines
(``gr.with_options(deadline_s=...)``) and per-tenant SLO targets
(``GrScheduler(slo_targets={tenant: seconds})``) — and makes the runtime act
on them in three stages:

1. **EDF ordering.**  Elements carry an *effective deadline* (absolute
   deadline, or +inf when deadline-free).  Lane fallback prefers lanes whose
   queues hold equal-or-earlier deadlines, and the SimExecutor's water-fill
   hands device capacity to deadline'd kernels in earliest-deadline order
   before any deadline-free kernel sees it.  Deadline-free work sorts last
   everywhere, so a run with no deadlines is bit-identical to the pre-EDF
   scheduler.

2. **Deadline-risk signal.**  ``slack = deadline − now − critical-path cost``
   where the critical path is the element's own declared ``cost_s`` plus the
   max over its unfinished parents' remaining paths, plus the unfinished
   work queued ahead of it on its lane (FIFO lanes make that wait
   unavoidable).  Computed at submission and re-checked at every element
   completion boundary; an element is *at risk* when slack drops under a
   safety margin (a fraction of its deadline window).

3. **Element-boundary preemption.**  When a deadline is at risk, queued
   (never started) deadline-free elements on the affected devices are
   PAUSED — their lanes yield.  Pausing blocks a lane *in place*: same-lane
   children depend on FIFO order instead of events, so the queue must never
   be reordered.  Running work is never interrupted (no mid-kernel
   preemption), and lanes holding deadline'd work — or work the urgent
   frontier transitively depends on — are never stalled.  Paused elements
   resume when no at-risk work remains, when the urgent frontier drains, or
   when a host wait would otherwise block on them (deadlock guard).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from .element import ComputationalElement, ElementState


class DeadlineMonitor:
    """Owns deadline stamping, the slack estimator and pause/resume.

    Thread-safety: the monitor has its own lock and never acquires the
    scheduler's submission-pipeline lock.  Full risk checks (which walk
    scheduler lane state) run only from contexts that already hold the
    pipeline lock — submission, and the SimExecutor's completion boundaries
    (the sim clock only advances inside locked scheduler calls).  Boundaries
    raised from real-executor worker threads take the *light* path: prune
    finished work, resume when the urgent frontier has drained — touching
    only monitor-owned state and per-element gates.
    """

    def __init__(self, scheduler, slo_targets: Optional[Dict[str, float]] = None,
                 slack_margin: float = 0.25) -> None:
        self.sched = scheduler
        self.slo_targets: Dict[str, float] = dict(slo_targets or {})
        # Risk fires when slack < slack_margin * deadline_s: the margin
        # absorbs costs the critical-path estimator cannot see (copy-engine
        # backlogs, host overhead) before the deadline is already lost.
        self.slack_margin = float(slack_margin)
        self._lock = threading.RLock()
        # Live (not yet completed) deadline'd elements, by uid.
        self._live: Dict[int, ComputationalElement] = {}
        # Currently paused elements, by uid.
        self._paused: Dict[int, ComputationalElement] = {}
        # Flips True at the first deadline'd launch; every hook early-outs
        # while False, keeping deadline-free runs at zero overhead.
        self.enabled = bool(self.slo_targets)
        # True when completion boundaries may run the full risk check (the
        # boundary fires under the pipeline lock — SimExecutor); False for
        # real worker threads (light path only).  Set by the scheduler.
        self.full_boundary_checks = True
        self.deadline_elements = 0   # elements stamped with a deadline
        self.preemptions = 0         # elements paused
        self.preempt_events = 0      # risk sweeps that paused something
        self.resumes = 0             # elements resumed

    # ------------------------------------------------------------------
    # Deadline stamping
    # ------------------------------------------------------------------
    def tag(self, element: ComputationalElement) -> None:
        """Stamp ``element``'s absolute deadline and register it.

        Applies the tenant SLO target when no explicit ``deadline_s`` was
        declared; stamps ``deadline_t = host_now + deadline_s`` exactly once
        (inherited children arrive with ``deadline_t`` pre-set and keep it).
        Idempotent — safe to call from both launch and schedule paths."""
        if element.deadline_s is None:
            if element.is_host:
                return
            slo = self.slo_targets.get(element.tenant)
            if slo is None:
                return
            element.deadline_s = float(slo)
        if element.deadline_t is None:
            element.deadline_t = (self.sched.executor.host_now()
                                  + float(element.deadline_s))
        self.enabled = True
        with self._lock:
            if element.uid not in self._live:
                self._live[element.uid] = element
                self.deadline_elements += 1

    # ------------------------------------------------------------------
    # Completion predicate
    # ------------------------------------------------------------------
    def _done(self, e: ComputationalElement) -> bool:
        """Device-side completion.  Executor ``is_done`` answers the *host's*
        question (has the host observed completion — false while the host
        clock lags the sim's device clock mid-drain); risk tracking must see
        an element as finished the moment it retires on the device, or every
        completed deadline would read as eternally at-risk and keep the
        bulk lanes paused."""
        return (e.state is ElementState.DONE
                or self.sched.executor.is_done(e))

    # ------------------------------------------------------------------
    # Slack estimation
    # ------------------------------------------------------------------
    def _remaining_path(self, e: ComputationalElement, is_done,
                        memo: Dict[int, float]) -> float:
        """Critical-path seconds still between ``e``'s completion and now:
        own declared cost plus the deepest unfinished ancestor chain.
        Iterative (serving lanes chain thousands of elements deep)."""
        stack = [(e, False)]
        while stack:
            x, expanded = stack.pop()
            if x.uid in memo:
                continue
            if is_done(x):
                memo[x.uid] = 0.0
                continue
            if expanded:
                best = 0.0
                for p in x.parents:
                    v = memo.get(p.uid, 0.0)
                    if v > best:
                        best = v
                memo[x.uid] = best + max(x.cost_s, 0.0)
            else:
                stack.append((x, True))
                for p in x.parents:
                    if p.uid not in memo:
                        stack.append((p, False))
        return memo.get(e.uid, 0.0)

    def _lane_wait(self, e: ComputationalElement, is_done) -> float:
        """Unfinished work queued ahead of ``e`` on its FIFO lane."""
        if e.stream is None:
            return 0.0
        lane = self.sched.streams.lanes.get(e.stream)
        if lane is None:
            return 0.0
        w = 0.0
        for q in lane.in_flight:
            if q is e:
                break
            if not is_done(q):
                w += max(q.cost_s, 0.0)
        return w

    def slack(self, e: ComputationalElement, now: float, is_done,
              memo: Optional[Dict[int, float]] = None) -> float:
        memo = {} if memo is None else memo
        return (e.deadline_t - now
                - self._remaining_path(e, is_done, memo)
                - self._lane_wait(e, is_done))

    # ------------------------------------------------------------------
    # Risk check + preemption
    # ------------------------------------------------------------------
    def check(self, now: Optional[float] = None) -> None:
        """Full risk sweep.  Caller must hold the pipeline lock (or be the
        sim event loop, which only runs under it)."""
        if not self.enabled:
            return
        ex = self.sched.executor
        is_done = self._done
        if now is None:
            now = ex.device_now()
        with self._lock:
            for uid in [u for u, e in self._live.items() if is_done(e)]:
                del self._live[uid]
            memo: Dict[int, float] = {}
            risky = [e for e in self._live.values()
                     if (self.slack(e, now, is_done, memo)
                         < self.slack_margin * (e.deadline_s or 0.0))]
            if risky:
                self._preempt_locked(risky, is_done)
            elif self._paused:
                # No at-risk deadline remains: the urgent frontier has
                # drained (or caught up) — give the device back.
                self._resume_locked()

    def _preempt_locked(self, risky, is_done) -> None:
        # Work the urgent frontier transitively depends on must keep
        # flowing: collect the unfinished ancestor closure of every live
        # deadline'd element (not just the risky ones — pausing a comfy
        # deadline's parent would manufacture the next at-risk element).
        needed = set()
        stack = [e for e in self._live.values()]
        while stack:
            x = stack.pop()
            if x.uid in needed:
                continue
            needed.add(x.uid)
            for p in x.parents:
                if p.uid not in needed and not is_done(p):
                    stack.append(p)
        devices = {e.device for e in risky}
        paused_any = False
        for lane in self.sched.streams.lanes.values():
            if lane.device_id not in devices and None not in devices:
                continue
            stall = True
            for q in lane.in_flight:
                if is_done(q):
                    continue
                if q.deadline_t is not None or q.uid in needed:
                    stall = False     # lane carries (or feeds) urgent work
                    break
            if not stall:
                continue
            for q in lane.in_flight:
                if q.state is ElementState.QUEUED and not is_done(q):
                    self._pause(q)
                    paused_any = True
        if paused_any:
            self.preempt_events += 1

    def _pause(self, q: ComputationalElement) -> None:
        if self.sched.executor.pause_via_gates:
            # Publish a cleared gate *before* flipping state: the lane
            # worker checks the gate right before running.  If the worker
            # already passed the check the element simply runs — that is
            # the no-mid-kernel-preemption contract, not an error.
            gate = threading.Event()
            q.pause_gate = gate
        q.state = ElementState.PAUSED
        self._paused[q.uid] = q
        self.preemptions += 1

    def _resume_locked(self) -> None:
        for q in self._paused.values():
            if q.state is ElementState.PAUSED:
                q.state = ElementState.QUEUED
                self.resumes += 1
            gate = q.pause_gate
            if gate is not None:
                q.pause_gate = None
                gate.set()
        self._paused.clear()

    def resume_all(self) -> None:
        if not self._paused:
            return
        with self._lock:
            self._resume_locked()

    # ------------------------------------------------------------------
    # Hooks wired into the executors / pipeline
    # ------------------------------------------------------------------
    def on_submit(self, element: ComputationalElement) -> None:
        """Submission-time risk check (pipeline lock held)."""
        if not self.enabled:
            return
        if element.deadline_t is not None:
            if self._paused:
                # A new urgent element must never end up gated behind
                # paused ancestors; the subsequent check() re-pauses
                # anything that is still safely stallable.
                with self._lock:
                    for p in element.parents:
                        if p.uid in self._paused:
                            self._resume_locked()
                            break
            self.check()

    def on_boundary(self, element: ComputationalElement) -> None:
        """Element-completion hook (both executors)."""
        if not self.enabled:
            return
        if self.full_boundary_checks:
            self.check()
            return
        # Worker-thread context: never walk scheduler lane state here.
        is_done = self._done
        with self._lock:
            self._live.pop(element.uid, None)
            for uid in [u for u, e in self._live.items() if is_done(e)]:
                del self._live[uid]
            if self._paused and not self._live:
                self._resume_locked()

    def ensure_progress(self, element: Optional[ComputationalElement] = None
                        ) -> bool:
        """Stalled-host hook: a wait that cannot complete resumes paused
        work.  Returns True when anything was resumed."""
        if not self._paused:
            return False
        with self._lock:
            if not self._paused:
                return False
            self._resume_locked()
        return True

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        if not (self.enabled or self.deadline_elements):
            return {}
        out = {
            "deadline_elements": self.deadline_elements,
            "edf_preemptions": self.preemptions,
            "edf_preempt_events": self.preempt_events,
            "edf_resumes": self.resumes,
        }
        rounds = getattr(self.sched.executor, "edf_fill_rounds", 0)
        if rounds:
            out["edf_fill_rounds"] = rounds
        return out
