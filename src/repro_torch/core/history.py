"""Per-kernel historical performance tracking (paper §IV-A).

"We track each kernel's historical performance and scheduling to allow the
creation of heuristics that guide future scheduling of the same kernel."

GrJAX uses the history for three things:
* cost estimates for the discrete-event simulator / oracle scheduler;
* straggler detection (an execution slower than ``factor`` × the running
  median is flagged; the distributed trainer uses this to re-dispatch);
* block-size / config heuristics (best-performing config per kernel).
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def _config_key(config: dict) -> Tuple:
    return tuple(sorted((k, str(v)) for k, v in config.items()))


@dataclass
class KernelHistory:
    straggler_factor: float = 3.0
    min_samples: int = 3
    _durations: Dict[Tuple[str, Tuple], List[float]] = field(
        default_factory=lambda: defaultdict(list))
    stragglers_seen: int = 0

    def record(self, name: str, config: dict, duration_s: float) -> bool:
        """Record an execution; returns True if it was a straggler."""
        key = (name, _config_key(config))
        hist = self._durations[key]
        straggler = False
        if len(hist) >= self.min_samples:
            med = statistics.median(hist)
            if med > 0 and duration_s > self.straggler_factor * med:
                straggler = True
                self.stragglers_seen += 1
        hist.append(duration_s)
        if len(hist) > 256:          # sliding window
            del hist[0]
        return straggler

    def estimate(self, name: str, config: dict) -> Optional[float]:
        hist = self._durations.get((name, _config_key(config)))
        if not hist:
            # fall back to any config of the same kernel
            pool = [d for (n, _), ds in self._durations.items() if n == name
                    for d in ds]
            return statistics.median(pool) if pool else None
        return statistics.median(hist)

    def is_straggler(self, name: str, config: dict, duration_s: float) -> bool:
        est = self.estimate(name, config)
        return est is not None and est > 0 and duration_s > self.straggler_factor * est

    def best_config(self, name: str) -> Optional[dict]:
        """Config with the lowest median duration for this kernel (§VI:
        'estimating the ideal block size based on previous executions')."""
        best, best_t = None, float("inf")
        for (n, ckey), ds in self._durations.items():
            if n == name and ds:
                m = statistics.median(ds)
                if m < best_t:
                    best, best_t = dict((k, v) for k, v in ckey), m
        return best

    def stats(self) -> dict:
        return {"kernels_tracked": len(self._durations),
                "stragglers_seen": self.stragglers_seen}
