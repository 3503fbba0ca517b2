"""Execution timeline + overlap accounting (paper Fig. 10 / §V-F).

Every executor records (element, lane, kind, t_start, t_end) intervals.  From
the timeline we compute the paper's four overlap metrics:

* **CT** — fraction of kernel-computation time overlapped with any transfer;
* **TC** — fraction of transfer time overlapped with any computation;
* **CC** — fraction of computation time overlapped with other computation;
* **TOT** — fraction of device-busy time where ≥2 device tasks overlap,
  overlap intervals counted once (union semantics).

On the real executor's CUDA lanes an element's interval is its device
interval, timed with CUDA events and placed on the program's clock; on the
CPU lanes and in the simulator it is the host (or simulated) interval.

Layer spans mark each boundary of the serving path on the program's clock:
``serve.flush``, ``serve.issue`` and ``serve.collect`` (the serving
engine), ``sched.launch`` (the scheduler), ``lane.wait``, ``lane.issue``
and ``lane.sync`` (each element on its lane worker).  Their count and
seconds by name are always kept (``stats()["spans"]``); their records join
``spans`` only when ``trace`` is on, each with its batch's ``trace_id``
and the ``parent`` span that caused it.  Two counters sit beside them:
``lane_gap``, the device time from an element's completion to the start
of the next element on the same CUDA stream, and ``issue_overlap_s``, the
lane-seconds spent inside ``lane.issue`` while another lane was inside it
too.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .element import _ELEMENT_IDS


_NAN = float("nan")
# Chrome-export rows: the process of a timeline merged into a profiler's
# file (above any Linux pid), and the offset of a lane thread's row from
# its stream's.
TIMELINE_PID = 1_000_000_000
LANE_THREAD_ROW = 10_000


@dataclass(frozen=True)
class Span:
    uid: int
    name: str
    kind: str          # "compute" | "h2d" | "d2h" | "d2d" | "host", or a
    #                    layer span's layer: "serve" | "sched" | "lane"
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
    trace_id: Optional[int] = None     # the batch's identifier (the rid of
    #                                    its first request), on every span
    #                                    of that batch
    parent: Optional[int] = None       # uid of the span that caused this one

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


class _LayerSpan:
    """One open layer span (``Timeline.span``): closed on exit, its parent
    the innermost span open on the same thread."""

    __slots__ = ("tl", "name", "trace_id", "uid", "parent", "t0")

    def __init__(self, tl: "Timeline", name: str,
                 trace_id: Optional[int]) -> None:
        self.tl, self.name, self.trace_id = tl, name, trace_id

    def __enter__(self) -> "_LayerSpan":
        tl = self.tl
        stack = tl._open_spans()
        up = stack[-1] if stack else None
        self.parent = up.uid if up is not None else None
        if self.trace_id is None and up is not None:
            self.trace_id = up.trace_id
        self.uid = next(_ELEMENT_IDS) if tl.trace else None
        stack.append(self)
        self.t0 = tl.clock()
        return self

    def __exit__(self, *exc) -> None:
        t1 = self.tl.clock()
        self.tl._open_spans().pop()
        self.tl.close_span(self.name, self.t0, t1, uid=self.uid,
                           trace_id=self.trace_id, parent=self.parent)


@dataclass
class Timeline:
    spans: List[Span] = field(default_factory=list)
    # The program's clock (the executor's ``host_now``), which layer spans
    # and lane boundaries read.
    clock: Callable[[], float] = time.perf_counter
    # Keep layer-span records in ``spans`` (their aggregates are kept
    # either way).  Set by ``GrScheduler(trace=True)``.
    trace: bool = False
    # Unix time in ns at ``clock``'s zero (0: the clock is not tied to
    # the wall, as the simulator's is not): the Chrome export's time base.
    epoch_unix_ns: int = 0
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
    # Layer spans by name: [count, seconds], cumulative.
    _agg: Dict[str, list] = field(default_factory=dict)
    # Lane gaps on the device: [count, seconds], cumulative.
    _gap: list = field(default_factory=lambda: [0, 0.0])
    # Lanes inside ``lane.issue`` now, the clock at the last boundary, and
    # the lane-seconds spent there while at least two were.
    _issuing: int = 0
    _issue_t: float = 0.0
    _overlap_s: float = 0.0
    _local: threading.local = field(default_factory=threading.local,
                                    repr=False)

    _DEVICE_KINDS = ("compute", "h2d", "d2h", "d2d")

    def record(self, uid: int, name: str, kind: str, lane: Optional[int],
               t0: float, t1: float, *, tenant: Optional[str] = None,
               priority: int = 0, t_issue: float = _NAN,
               deadline: Optional[float] = None,
               trace_id: Optional[int] = None,
               parent: Optional[int] = None) -> None:
        s = Span(uid, name, kind, lane, t0, t1,
                 tenant=tenant, priority=priority,
                 t_issue=t_issue, deadline=deadline,
                 trace_id=trace_id, parent=parent)
        with self._lock:
            self.spans.append(s)
            if tenant is not None and kind in self._DEVICE_KINDS:
                self._per_tenant.setdefault(tenant, []).append(s)

    # -- layer spans and counters ----------------------------------------
    def _open_spans(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, trace_id: Optional[int] = None) -> _LayerSpan:
        """``with timeline.span("serve.issue", trace_id=rid):`` — a layer
        span on the calling thread, nested under the one open there."""
        return _LayerSpan(self, name, trace_id)

    def context(self) -> Tuple[Optional[int], Optional[int]]:
        """``(trace_id, uid)`` of the innermost layer span open on the
        calling thread: what an element submitted now carries."""
        stack = self._open_spans()
        if not stack:
            return None, None
        return stack[-1].trace_id, stack[-1].uid

    def close_span(self, name: str, t0: float, t1: float, *,
                   lane: Optional[int] = None, uid: Optional[int] = None,
                   trace_id: Optional[int] = None,
                   parent: Optional[int] = None) -> None:
        """Count a layer span ``[t0, t1]`` under ``name``, and with
        ``trace`` on keep its record (``uid`` drawn here where not
        given)."""
        with self._lock:
            agg = self._agg.get(name)
            if agg is None:
                self._agg[name] = [1, t1 - t0]
            else:
                agg[0] += 1
                agg[1] += t1 - t0
            if self.trace:
                self.spans.append(Span(
                    next(_ELEMENT_IDS) if uid is None else uid, name,
                    name.split(".", 1)[0], lane, t0, t1,
                    trace_id=trace_id, parent=parent))

    def lane_gap(self, seconds: float) -> None:
        with self._lock:
            self._gap[0] += 1
            self._gap[1] += seconds

    def issue_edge(self, delta: int) -> float:
        """A lane enters (``+1``) or leaves (``-1``) ``lane.issue``; returns
        the clock at that boundary, read under the lock so that the
        boundaries of all lanes come in the clock's order."""
        with self._lock:
            now = self.clock()
            if self._issuing >= 2:
                self._overlap_s += self._issuing * (now - self._issue_t)
            self._issuing += delta
            self._issue_t = now
            return now

    def stats(self) -> dict:
        """Cumulative layer-span aggregates ``{"spans": {name: (count,
        seconds)}}``, ``lane_gap`` ``(count, seconds)`` and
        ``issue_overlap_s``; a reader takes the difference of two."""
        with self._lock:
            return {"spans": {n: (a[0], a[1]) for n, a in self._agg.items()},
                    "lane_gap": (self._gap[0], self._gap[1]),
                    "issue_overlap_s": self._overlap_s}

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

    def to_chrome_trace(self, path: str,
                        profiler_trace: Optional[str] = None) -> None:
        """Export as a Chrome trace (chrome://tracing / Perfetto): one row
        per lane plus H2D/D2H/host rows — the paper's Fig. 10 timeline,
        inspectable.

        With lane spans on the timeline (the real executor traced), each
        lane has a row for its thread (``lane.*``) and one for its stream
        (its elements, device-timed on the card), and the engine's and the
        scheduler's spans share a row.  A timeline tied to the wall clock
        (``epoch_unix_ns``) is stamped as ``torch.profiler``'s
        ``export_chrome_trace`` stamps: microseconds of Unix time less the
        file's ``baseTimeNanoseconds``.  ``profiler_trace``, such a file
        from the same process, lends its base and its events to this one,
        so that one viewer shows the lanes over the device's kernels."""
        header: dict = {}
        theirs: list = []
        base_ns = self.epoch_unix_ns // 10**9 * 10**9
        if profiler_trace is not None:
            with open(profiler_trace) as f:
                header = json.load(f)
            theirs = header.pop("traceEvents")
            base_ns = int(header.get("baseTimeNanoseconds", 0))
        elif self.epoch_unix_ns:
            header["baseTimeNanoseconds"] = base_ns
        shift = (self.epoch_unix_ns - base_ns) / 1e3 if self.epoch_unix_ns \
            else 0.0
        pid = TIMELINE_PID if profiler_trace is not None else 0
        lanes = any(s.kind == "lane" for s in self.spans)
        rows = {-1: "H2D engine", -2: "D2H engine", -3: "host",
                -5: "D2D link"}
        events = []
        for s in self.spans:
            if lanes and s.lane is not None:
                thread = s.kind == "lane"
                tid = s.lane + (LANE_THREAD_ROW if thread else 0)
                rows[tid] = f"lane {s.lane} {'thread' if thread else 'stream'}"
            elif s.kind in ("serve", "sched"):
                tid = -6
                rows[tid] = "serving engine and scheduler"
            else:
                tid = {"h2d": -1, "d2h": -2, "host": -3, "d2d": -5}.get(
                    s.kind, s.lane if s.lane is not None else -4)
            ev = {"name": s.name, "cat": s.kind, "ph": "X",
                  "ts": s.t0 * 1e6 + shift, "dur": max(0.01, s.dur * 1e6),
                  "pid": pid, "tid": tid}
            if s.trace_id is not None or s.parent is not None:
                ev["args"] = {"uid": s.uid, "trace_id": s.trace_id,
                              "parent": s.parent}
            events.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": t,
                 "args": {"name": n}} for t, n in rows.items()]
        if profiler_trace is not None:
            meta.insert(0, {"name": "process_name", "ph": "M", "pid": pid,
                            "args": {"name": "repro_torch timeline"}})
        with open(path, "w") as f:
            json.dump({**header, "traceEvents": theirs + meta + events}, f)
