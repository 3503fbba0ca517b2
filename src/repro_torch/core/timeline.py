"""Execution timeline + overlap accounting (paper Fig. 10 / §V-F).

Every executor records (element, lane, kind, t_start, t_end) intervals.  From
the timeline we compute the paper's four overlap metrics:

* **CT** — fraction of kernel-computation time overlapped with any transfer;
* **TC** — fraction of transfer time overlapped with any computation;
* **CC** — fraction of computation time overlapped with other computation;
* **TOT** — fraction of device-busy time where ≥2 device tasks overlap,
  overlap intervals counted once (union semantics).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple


_NAN = float("nan")


@dataclass(frozen=True)
class Span:
    uid: int
    name: str
    kind: str          # "compute" | "h2d" | "d2h" | "d2d" | "host"
    lane: Optional[int]
    t0: float
    t1: float
    # Multi-tenant QoS attribution (None/defaults for untagged spans).
    tenant: Optional[str] = None
    priority: int = 0
    t_issue: float = _NAN              # submission time; t0 - t_issue is the
    #                                    span's queueing delay
    deadline: Optional[float] = None   # absolute deadline (None = no SLO);
    #                                    met iff t1 <= deadline

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    @property
    def queue_delay(self) -> float:
        return self.t0 - self.t_issue   # nan when t_issue was not recorded

    @property
    def latency(self) -> float:
        return self.t1 - self.t_issue   # submit-to-completion (nan likewise)

    @property
    def met_deadline(self) -> Optional[bool]:
        """True/False for deadline'd spans, None for deadline-free ones."""
        if self.deadline is None:
            return None
        return self.t1 <= self.deadline + 1e-12


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    ivs = sorted((a, b) for a, b in intervals if b > a)
    out: List[Tuple[float, float]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _measure(ivs: List[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in ivs)


def _intersect(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]
               ) -> List[Tuple[float, float]]:
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _sorted_percentile(ys: List[float], q: float) -> float:
    """Linear-interpolated percentile of an already-sorted ``ys``."""
    if not ys:
        return 0.0
    k = (len(ys) - 1) * q
    lo = int(k)
    hi = min(lo + 1, len(ys) - 1)
    return ys[lo] + (ys[hi] - ys[lo]) * (k - lo)


def _percentile(xs: List[float], q: float) -> float:
    """Linear-interpolated percentile of ``xs`` (q in [0, 1])."""
    return _sorted_percentile(sorted(xs), q)


def _k_overlap(spans: List[Tuple[float, float]], k: int = 2
               ) -> List[Tuple[float, float]]:
    """Intervals where at least ``k`` of the given spans are active."""
    pts = []
    for a, b in spans:
        pts.append((a, 1))
        pts.append((b, -1))
    pts.sort()
    out, depth, start = [], 0, None
    for t, d in pts:
        prev = depth
        depth += d
        if prev < k <= depth:
            start = t
        elif prev >= k > depth and start is not None:
            out.append((start, t))
            start = None
    return _union(out)


@dataclass
class Timeline:
    spans: List[Span] = field(default_factory=list)
    # Per-tenant append-only buffers of device spans, filled by record():
    # tenant_stats() reads these instead of rescanning (and re-sorting) the
    # full span list on every call.  ``_tenant_cache`` memoizes one stats
    # epoch per tenant — keyed by buffer length, so stats are recomputed
    # (and the percentile arrays re-sorted) at most once per query epoch,
    # however often serving polls per flush.
    _per_tenant: Dict[str, List[Span]] = field(default_factory=dict)
    _tenant_cache: Dict[str, tuple] = field(default_factory=dict)
    # Recorders (real-executor lane workers, host-span paths) and readers
    # (tenant_stats, the daemon monitor) run on different threads and are
    # NOT all under the scheduler's pipeline lock — a timeline-internal lock
    # keeps each record and each stats pass internally consistent.
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    _DEVICE_KINDS = ("compute", "h2d", "d2h", "d2d")

    def record(self, uid: int, name: str, kind: str, lane: Optional[int],
               t0: float, t1: float, *, tenant: Optional[str] = None,
               priority: int = 0, t_issue: float = _NAN,
               deadline: Optional[float] = None) -> None:
        s = Span(uid, name, kind, lane, t0, t1,
                 tenant=tenant, priority=priority,
                 t_issue=t_issue, deadline=deadline)
        with self._lock:
            self.spans.append(s)
            if tenant is not None and kind in self._DEVICE_KINDS:
                self._per_tenant.setdefault(tenant, []).append(s)

    def device_busy_since(self, idx: int) -> Tuple[int, float]:
        """Sum of device-span durations recorded at or after span index
        ``idx``; returns ``(new_idx, busy_seconds)`` so callers (the daemon
        monitor's utilization gauge) can walk the timeline incrementally."""
        with self._lock:
            n = len(self.spans)
            busy = sum(s.dur for s in self.spans[idx:n]
                       if s.kind in self._DEVICE_KINDS)
        return n, busy

    # ------------------------------------------------------------------
    def device_spans(self) -> List[Span]:
        return [s for s in self.spans
                if s.kind in ("compute", "h2d", "d2h", "d2d")]

    @property
    def makespan(self) -> float:
        dev = self.device_spans()
        if not dev:
            return 0.0
        return max(s.t1 for s in dev) - min(s.t0 for s in dev)

    def overlap_metrics(self) -> Dict[str, float]:
        comp = [(s.t0, s.t1) for s in self.spans if s.kind == "compute"]
        xfer = [(s.t0, s.t1) for s in self.spans
                if s.kind in ("h2d", "d2h", "d2d")]
        u_comp, u_xfer = _union(comp), _union(xfer)
        t_comp, t_xfer = _measure(u_comp), _measure(u_xfer)

        ct = _measure(_intersect(u_comp, u_xfer)) / t_comp if t_comp else 0.0
        tc = _measure(_intersect(u_comp, u_xfer)) / t_xfer if t_xfer else 0.0
        cc = _measure(_k_overlap(comp, 2)) / t_comp if t_comp else 0.0
        allspans = comp + xfer
        u_all = _union(allspans)
        tot = _measure(_k_overlap(allspans, 2)) / _measure(u_all) if allspans else 0.0
        return {"CT": ct, "TC": tc, "CC": cc, "TOT": tot}

    def tenant_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant QoS metrics over the device spans.

        For each tenant that appears on the timeline: element count,
        makespan (first start to last end of its spans), device-busy time,
        mean/p99 queueing delay (span start minus submission) and p50/p99
        submit-to-completion latency.  Tenants with deadline'd spans
        additionally report ``deadlined`` (count of deadline'd compute
        launches) and ``slo_attainment`` (fraction that finished by their
        deadline).  Spans recorded without a tenant tag (host spans,
        pre-QoS callers) are excluded.

        Incremental: spans accumulate in per-tenant append-only buffers and
        the percentile arrays are extended + re-sorted once per query epoch
        (timsort is near-linear on the mostly-sorted extension); repeated
        queries with no new spans return the cached epoch.

        Thread-safe: the whole pass runs under the timeline lock, so a
        monitor polling stats never sees a tenant buffer mid-append (torn
        counters) from a lane worker recording concurrently."""
        with self._lock:
            return self._tenant_stats_locked()

    def _tenant_stats_locked(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for tenant, spans in self._per_tenant.items():
            cached = self._tenant_cache.get(tenant)
            if cached is not None and cached[0] == len(spans):
                out[tenant] = dict(cached[1])
                continue
            n0, _, lats, qds = cached if cached is not None else (0, None, [], [])
            fresh = spans[n0:]
            lats = lats + [s.latency for s in fresh if s.latency == s.latency]
            qds = qds + [s.queue_delay for s in fresh
                         if s.queue_delay == s.queue_delay]
            lats.sort()
            qds.sort()
            stats = {
                "elements": float(len(spans)),
                "makespan_s": max(s.t1 for s in spans) - min(s.t0 for s in spans),
                "busy_s": _measure(_union([(s.t0, s.t1) for s in spans])),
                "queue_delay_mean_s": (sum(qds) / len(qds)) if qds else 0.0,
                "queue_delay_p99_s": _sorted_percentile(qds, 0.99),
                "latency_p50_s": _sorted_percentile(lats, 0.50),
                "latency_p99_s": _sorted_percentile(lats, 0.99),
            }
            # SLO attainment over deadline'd *compute* spans only: inherited
            # transfer children carry the same deadline and would otherwise
            # triple-count each launch.
            ded = [s for s in spans
                   if s.deadline is not None and s.kind == "compute"]
            if ded:
                met = sum(1 for s in ded if s.met_deadline)
                stats["deadlined"] = float(len(ded))
                stats["slo_attainment"] = met / len(ded)
            self._tenant_cache[tenant] = (len(spans), stats, lats, qds)
            out[tenant] = dict(stats)
        return out

    def busy_time(self, kind: str) -> float:
        return _measure(_union([(s.t0, s.t1) for s in self.spans if s.kind == kind]))

    def reload_spans(self) -> List[Span]:
        """H2D spans that re-upload a previously uploaded block.

        Two sources: explicitly named ``reload_*`` transfers (Belady plans,
        tier reloads) and *repeat* H2D uploads of a name already seen on
        the H2D engine — the eager LRU path names every upload ``h2d_*``,
        so a second upload of the same array is spill-return traffic."""
        out: List[Span] = []
        seen: set = set()
        for s in sorted((s for s in self.spans if s.kind == "h2d"),
                        key=lambda s: s.t0):
            if s.name.startswith("reload_") or s.name in seen:
                out.append(s)
            seen.add(s.name)
        return out

    def reload_stall_s(self) -> float:
        """Reload time *not* hidden behind compute — the stall a smarter
        eviction/prefetch schedule can actually remove (reload bytes alone
        conflate overlapped and blocking traffic)."""
        ru = _union([(s.t0, s.t1) for s in self.reload_spans()])
        if not ru:
            return 0.0
        comp = _union([(s.t0, s.t1) for s in self.spans
                       if s.kind == "compute"])
        return _measure(ru) - _measure(_intersect(ru, comp))

    def per_lane(self) -> Dict[int, List[Span]]:
        lanes: Dict[int, List[Span]] = {}
        for s in self.device_spans():
            lanes.setdefault(s.lane if s.lane is not None else -1, []).append(s)
        return lanes

    def critical_path(self) -> float:
        """Longest chain end-to-end (lower bound on any schedule)."""
        return self.makespan  # refined bound computed by benchmarks from DAG

    def to_rows(self) -> List[dict]:
        return [s.__dict__ | {"dur": s.dur} for s in self.spans]

    def to_chrome_trace(self, path: str) -> None:
        """Export as a Chrome trace (chrome://tracing / Perfetto): one row
        per lane plus H2D/D2H/host rows — the paper's Fig. 10 timeline,
        inspectable."""
        import json
        events = []
        for s in self.spans:
            tid = {"h2d": -1, "d2h": -2, "host": -3, "d2d": -5}.get(
                s.kind, s.lane if s.lane is not None else -4)
            events.append({
                "name": s.name, "cat": s.kind, "ph": "X",
                "ts": s.t0 * 1e6, "dur": max(0.01, s.dur * 1e6),
                "pid": 0, "tid": tid,
            })
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": t,
                 "args": {"name": n}} for t, n in
                [(-1, "H2D engine"), (-2, "D2H engine"), (-3, "host"),
                 (-5, "D2D link")]]
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + events}, f)
