"""Out-of-core scenario (benchsuite companion to suite.py).

The memory question the budgeted runtime must answer: when a workload's
working set exceeds the device's byte budget, does the transparent
spill/evict machinery keep it *running correctly* at a bounded slowdown —
instead of the unhandled-OOM it used to be?

:func:`build_outofcore` constructs a two-pass streaming pipeline over
``chunks`` independent data chunks:

* pass 1 maps every input chunk ``x[i]`` to an intermediate ``y[i]``
  (device-only output — spilling it later costs a real D2H write-back);
* pass 2 maps every ``y[i]`` to a final ``z[i]``, re-touching the
  intermediates in order, so chunks evicted under pressure must be
  reloaded (H2D after the spill's D2H — the thrash pattern an LRU policy
  must survive).

Total allocated bytes are ``3 * chunks * chunk_bytes``; running with
``budget = working_set_bytes(...) // 2`` (a working set of
about twice the budget) forces evictions while every single element's own working
set (2 chunks) stays far below the budget.  Kernel cost is set so compute
dominates the spill traffic: the acceptance criterion is makespan ≤ 2×
the unlimited-budget run with ≥ 1 recorded spill.

Like every benchsuite scenario, the host code is plain sequential calls
through one declared GrFunction — budgets, spills and reloads are
entirely the runtime's business.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core import GrScheduler
from ..core.frontend import function


def _stage_fn(x, o):
    return x * 2.0 + 1.0


# Declared once: an elementwise streaming stage, full occupancy; per-call
# cost (sim mode) attaches via with_options.
OOC_STAGE = function(_stage_fn, modes=("const", "out"), name="ooc_stage",
                     outputs=0, parallel_fraction=1.0)


def working_set_bytes(chunks: int = 8, n: int = 1 << 14) -> int:
    """Total bytes the scenario keeps live (x + y + z chunk sets)."""
    return 3 * chunks * 4 * n


def build_outofcore(sched: GrScheduler, *, chunks: int = 8, n: int = 1 << 14,
                    cost_s: float = 1e-3, seed: int = 0,
                    device: int = None) -> Dict[str, List]:
    """Issue the two-pass pipeline; returns the chunk arrays for
    verification (``z[i] == 4*x[i] + 3`` elementwise).

    ``device`` pins every stage to one device (bypassing placement) — the
    tiered-spill benchmark uses it to keep the *compute* on the budgeted
    device so a peer-device tier competes on spill placement alone, not on
    work stealing."""
    rng = np.random.RandomState(seed)
    stage = OOC_STAGE.with_options(scheduler=sched, cost_s=cost_s)
    if device is not None:
        stage = stage.with_options(device=device)
    xs = [sched.array(rng.rand(n).astype(np.float32), name=f"ooc_x{i}")
          for i in range(chunks)]
    ys = [stage.with_options(name=f"ooc_p1_{i}")(x)
          for i, x in enumerate(xs)]
    zs = [stage.with_options(name=f"ooc_p2_{i}")(y)
          for i, y in enumerate(ys)]
    return {"x": xs, "y": ys, "z": zs}


def verify_outofcore(arrays: Dict[str, List]) -> bool:
    """Host-side correctness check (real executor): reads every final
    chunk back — through any spilled host copies — and compares against
    the closed form."""
    for x, z in zip(arrays["x"], arrays["z"]):
        expect = np.asarray(x.host, np.float32) * 4.0 + 3.0
        if not np.allclose(np.asarray(z), expect, rtol=1e-5, atol=1e-5):
            return False
    return True
