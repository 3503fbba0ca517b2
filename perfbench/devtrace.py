"""The traced part of a ``--trace 1`` run: one cycle of the mix under
``torch.profiler``, started and ended with nothing in flight, so every
kernel of the trace belongs to one of its batches; and the reduction of
that trace to what the per-layer metrics read.

The harness marks each flush and each collect with ``record_function``,
so the host's spans and the device's kernels share the trace's clock.  The
steady part of the cycle runs from its first completion to the completion
after which fewer than ``in_flight`` batches remain; device busy time and
idle gaps are read there, kernel times over the whole cycle."""
from __future__ import annotations

import collections
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SPANS = ("flush", "collect")
Interval = Tuple[float, float]


def union(spans: Sequence[Interval]) -> List[Interval]:
    """Sorted, merged intervals."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(spans: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


@dataclass
class TraceSummary:
    """Times in seconds on the trace's clock."""
    lengths: List[int]                       # the traced batches' prompts
    kernels: List[Tuple[str, float, float]]  # every device operation
    host: List[Tuple[str, float, float]]     # the harness's spans
    steady: Interval = (0.0, 0.0)
    busy: List[Interval] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.steady[1] - self.steady[0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    @property
    def device_s(self) -> float:
        """Seconds in which any operation of the traced cycle ran."""
        return sum(b - a for a, b in union([(a, b) for _, a, b
                                            in self.kernels]))

    def kernel_time(self, pattern: str, exclude: Sequence[str] = ()
                    ) -> Tuple[int, float]:
        """(launches, device seconds) of the operations whose name holds
        ``pattern`` and none of ``exclude``, over the whole traced cycle."""
        hits = [(b - a) for n, a, b in self.kernels
                if pattern in n and not any(x in n for x in exclude)]
        return len(hits), sum(hits)

    def device_ops(self, top: Optional[int] = 10) -> List[list]:
        """The device operations with the most time over the traced cycle,
        by name: [name, seconds], ``top`` of them (all for ``None``)."""
        total: Dict[str, float] = collections.defaultdict(float)
        for n, a, b in self.kernels:
            total[n] += b - a
        return [[n, s] for n, s in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest idle gaps of the steady part, each named by the
        harness span the host was in at the gap's middle ("host" outside
        them)."""
        lo, hi = self.steady
        edges = [lo] + [t for ab in self.busy for t in ab] + [hi]
        gaps = []
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            name = next((n for n, s, e in self.host if s <= mid <= e),
                        "host")
            gaps.append([name, b - a])
        return sorted(gaps, key=lambda g: -g[1])[:top]


def summarize(events, lengths: Sequence[int], in_flight: int
              ) -> TraceSummary:
    """The summary of ``prof.events()`` for a cycle of ``lengths``."""
    kernels, host = [], []
    for e in events:
        t0, t1 = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type.name == "CUDA":
            if e.name not in SPANS:          # GPU user annotations
                kernels.append((e.name, t0, t1))
        elif e.name in SPANS:
            host.append((e.name, t0, t1))
    s = TraceSummary(list(lengths), kernels, sorted(host, key=lambda h: h[1]))
    done = [e for n, _, e in s.host if n == "collect"]
    if len(done) != len(lengths):
        raise RuntimeError(f"the trace holds {len(done)} collects for "
                           f"{len(lengths)} batches")
    last = len(done) - in_flight
    s.steady = (done[0], done[max(last, 0)]) if last > 0 else \
        (done[0], done[-1])
    s.busy = clip(union([(a, b) for _, a, b in kernels]), *s.steady)
    return s


@contextlib.contextmanager
def profiled():
    """``(prof, span)``: the profiler over the block, and the span factory
    the clients mark their flushes and collects with."""
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof, record_function
