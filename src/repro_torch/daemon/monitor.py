"""Monitoring loop: EWMAs, spike detection, cooldowns, residency drift.

The monitor is the daemon's sensory system.  It samples queue depth,
arrival rate, lane utilization and memory-pool occupancy as exponentially
weighted moving averages, detects spikes (an observation far above the
moving baseline) and opens a *cooldown window* during which the admission
policy defers or sheds instead of admitting blindly.

It is also the home of the physical-accounting reconciliation: the
MemoryManager's *logical* residency ledger is cross-checked against itself
(:meth:`MemoryManager.verify`) and — on the real executor — against the
bytes physically installed on devices.  Persistent drift raises an alarm
counter the policy and operators can see; transient in-flight skew (logical
bits flip at schedule time, physical values land at completion) is filtered
by requiring the drift to persist across consecutive quiescent samples.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


class Ewma:
    """Exponentially weighted moving average; ``None`` until first update."""

    def __init__(self, alpha: float = 0.3) -> None:
        self.alpha = float(alpha)
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        x = float(x)
        if self.value is None:
            self.value = x
        else:
            self.value = self.alpha * x + (1.0 - self.alpha) * self.value
        return self.value

    def get(self, default: float = 0.0) -> float:
        return default if self.value is None else self.value


class SpikeDetector:
    """Spike = observation > ``factor`` x max(EWMA baseline, ``floor``).

    A detected spike opens (or extends) a cooldown window of
    ``cooldown_s``; :meth:`active` reports whether the window is open.
    The observation is folded into the baseline *after* the comparison, so
    a step change is seen as a spike before the average absorbs it."""

    def __init__(self, *, factor: float = 3.0, floor: float = 2.0,
                 cooldown_s: float = 0.5, alpha: float = 0.3,
                 warmup: int = 0) -> None:
        self.factor = float(factor)
        self.floor = float(floor)
        self.cooldown_s = float(cooldown_s)
        self.ewma = Ewma(alpha)
        self.spikes = 0
        self.cooldown_until = 0.0
        # Observations absorbed before the detector may signal: the first
        # sample of a busy-but-healthy workload would otherwise compare a
        # real rate against the cold floor and read steady state as a spike.
        self.warmup = max(0, int(warmup))
        self._seen = 0

    def observe(self, x: float, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        baseline = max(self.ewma.get(self.floor), self.floor)
        self._seen += 1
        spiking = (self._seen > self.warmup
                   and float(x) > self.factor * baseline)
        if spiking:
            self.spikes += 1
            self.cooldown_until = max(self.cooldown_until,
                                      now + self.cooldown_s)
        self.ewma.update(x)
        return spiking

    def active(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return now < self.cooldown_until


@dataclass
class MonitorSnapshot:
    """One consistent sample the admission policy decides from."""

    t: float = 0.0
    queue_depth: int = 0
    running: int = 0
    queue_depth_ewma: float = 0.0
    arrival_rate_ewma: float = 0.0          # submits/second
    utilization: float = 0.0                # device-busy fraction, EWMA
    mem_occupancy: float = 0.0              # bounded-pool resident/budget
    spiking: bool = False                   # inside a cooldown window
    cooldown_remaining_s: float = 0.0
    drift_alarms: int = 0
    drift_problems: List[str] = field(default_factory=list)


class RuntimeMonitor:
    """Background sampler over one scheduler + the server's queue gauges.

    ``queue_depth_fn``/``running_fn``/``arrivals_fn`` are cheap gauges the
    server installs; the scheduler is read through its (now lock-consistent)
    ``stats()`` snapshot.  ``interval_s=None`` disables the background
    thread — callers then drive :meth:`sample_once` explicitly, which is
    what the deterministic tests do."""

    def __init__(self, scheduler=None, *, interval_s: Optional[float] = 0.05,
                 spike_factor: float = 3.0, spike_floor: float = 4.0,
                 rate_floor: Optional[float] = None,
                 cooldown_s: float = 0.5, alpha: float = 0.3,
                 spike_warmup: int = 2,
                 drift_grace: int = 2, rate_window_s: float = 0.25,
                 queue_depth_fn: Optional[Callable[[], int]] = None,
                 running_fn: Optional[Callable[[], int]] = None,
                 arrivals_fn: Optional[Callable[[], int]] = None) -> None:
        self.scheduler = scheduler
        self.interval_s = interval_s
        self.queue_depth_fn = queue_depth_fn or (lambda: 0)
        self.running_fn = running_fn or (lambda: 0)
        self.arrivals_fn = arrivals_fn or (lambda: 0)
        self.depth_spikes = SpikeDetector(factor=spike_factor,
                                          floor=spike_floor,
                                          cooldown_s=cooldown_s, alpha=alpha,
                                          warmup=spike_warmup)
        # Queue depth (jobs) and arrival rate (jobs/second) live on very
        # different scales; ``rate_floor`` keeps a healthy high-throughput
        # trickle from reading as a rate spike (default: 4x the depth floor
        # per second).
        self.rate_spikes = SpikeDetector(
            factor=spike_factor,
            floor=4.0 * spike_floor if rate_floor is None else rate_floor,
            cooldown_s=cooldown_s, alpha=alpha, warmup=spike_warmup)
        self.util_ewma = Ewma(alpha)
        self.occupancy_ewma = Ewma(alpha)
        self.drift_grace = max(1, int(drift_grace))
        self.samples = 0
        self.drift_alarms = 0
        self._drift_streak = 0
        self._drift_problems: List[str] = []
        self._drift_report = None       # latest DriftReport from _reconcile
        self._last_t: Optional[float] = None
        # Arrival rate is measured over a sliding window, not one sample
        # interval: at a 20 ms cadence a single submit would read as an
        # instantaneous 50 jobs/s "spike".  The window keeps the gauge in
        # genuine jobs-per-second regardless of the sampling period.
        self.rate_window_s = float(rate_window_s)
        self._arrival_hist: "collections.deque" = collections.deque()
        self._busy_idx = 0                  # timeline cursor for busy delta
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last: Optional[MonitorSnapshot] = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self.interval_s is None or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="repro-daemon-monitor",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:               # pragma: no cover - never die
                pass

    # ------------------------------------------------------------------
    def _lane_utilization(self, now: float) -> float:
        """Device-busy seconds accrued since the previous sample, divided
        by wall-interval x lanes — a coarse utilization gauge.  On the
        port's real executor those spans are host-clock element spans (a
        lane's element from its start to its stream's completion), so on
        the card the gauge reads lane occupancy, not device busy."""
        sched = self.scheduler
        if sched is None or self._last_t is None:
            return 0.0
        interval = max(1e-9, now - self._last_t)
        tl = sched.timeline
        self._busy_idx, busy = tl.device_busy_since(self._busy_idx)
        lanes = max(1, sched.streams.lanes_created)
        return min(1.0, busy / (interval * lanes))

    def _reconcile(self, quiescent: bool) -> List[str]:
        """Logical-ledger self-check + logical-vs-physical accounting.

        Physical accounting only means something on a real executor at a
        quiescent point: the simulator installs no physical values, and a
        mid-flight real run legitimately has logical bits ahead of the
        device (flipped at schedule time).  The sampler must never unwind
        on drift — it records the structured :class:`DriftReport` for the
        alarm path instead of raising."""
        sched = self.scheduler
        if sched is None:
            return []
        physical = (quiescent
                    and type(sched.executor).__name__ == "ThreadLaneExecutor")
        report = sched.memory.verify(raise_on_drift=False, physical=physical)
        self._drift_report = report
        return list(report.problems)

    def sample_once(self, now: Optional[float] = None) -> MonitorSnapshot:
        with self._lock:
            now = time.monotonic() if now is None else now
            depth = int(self.queue_depth_fn())
            running = int(self.running_fn())
            arrivals = int(self.arrivals_fn())
            self.depth_spikes.observe(depth, now)
            hist = self._arrival_hist
            hist.append((now, arrivals))
            while len(hist) > 1 and hist[0][0] < now - self.rate_window_s:
                hist.popleft()
            dt = now - hist[0][0]
            if dt > 0:
                rate = (arrivals - hist[0][1]) / dt
                self.rate_spikes.observe(rate, now)
            util = self._lane_utilization(now)
            self.util_ewma.update(util)
            occ = 0.0
            if self.scheduler is not None:
                occ = float(self.scheduler.stats().get("mem_occupancy", 0.0))
            self.occupancy_ewma.update(occ)
            problems = self._reconcile(quiescent=(running == 0 and depth == 0))
            if problems:
                self._drift_streak += 1
                if self._drift_streak == self.drift_grace:
                    self.drift_alarms += 1
                    self._drift_problems = problems
            else:
                self._drift_streak = 0
            self._last_t = now
            self.samples += 1
            spiking = (self.depth_spikes.active(now)
                       or self.rate_spikes.active(now))
            cooldown_until = max(self.depth_spikes.cooldown_until,
                                 self.rate_spikes.cooldown_until)
            snap = MonitorSnapshot(
                t=now, queue_depth=depth, running=running,
                queue_depth_ewma=self.depth_spikes.ewma.get(),
                arrival_rate_ewma=self.rate_spikes.ewma.get(),
                utilization=self.util_ewma.get(),
                mem_occupancy=self.occupancy_ewma.get(),
                spiking=spiking,
                cooldown_remaining_s=max(0.0, cooldown_until - now),
                drift_alarms=self.drift_alarms,
                drift_problems=list(self._drift_problems))
            self.last = snap
            return snap

    def snapshot(self) -> MonitorSnapshot:
        """Latest sample (fresh one if none has been taken yet)."""
        snap = self.last
        return snap if snap is not None else self.sample_once()

    def stats(self) -> dict:
        with self._lock:
            return {
                "monitor_samples": self.samples,
                "monitor_spikes": (self.depth_spikes.spikes
                                   + self.rate_spikes.spikes),
                "monitor_in_cooldown": (self.depth_spikes.active()
                                        or self.rate_spikes.active()),
                "monitor_queue_depth_ewma": self.depth_spikes.ewma.get(),
                "monitor_arrival_rate_ewma": self.rate_spikes.ewma.get(),
                "monitor_utilization_ewma": self.util_ewma.get(),
                "monitor_mem_occupancy_ewma": self.occupancy_ewma.get(),
                "monitor_drift_alarms": self.drift_alarms,
                "monitor_drift_problems": list(self._drift_problems),
                "monitor_drift_report": (self._drift_report.to_json()
                                         if self._drift_report is not None
                                         else None),
            }
