"""Multi-device scheduling scenarios (benchsuite companions to suite.py).

Two synthetic DAG shapes that isolate the two questions the multi-device
runtime must answer:

* :func:`build_task_parallel` — independent kernel chains with no shared
  data.  An N-device scheduler should approach N× speedup over one device;
  any placement policy works because there is nothing to misplace *within*
  a chain once it starts (affinity keeps each chain pinned, the others pay
  D2D migrations on every hop they scatter).
* :func:`build_locality_heavy` — groups of kernels that repeatedly update
  their own group's arrays.  Placement that ignores data location
  (round-robin) bounces every array between devices — one D2D per scattered
  hop — while data-affinity placement keeps each group on the device that
  owns its arrays and inserts (almost) no D2D traffic.

Both builders issue plain sequential host code through declared GrFunctions,
the programming model of the paper's Fig. 4 — devices, lanes and D2D copies
are entirely the runtime's business.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core import GrScheduler
from ..core.frontend import function

# Declared once; cost and display names attach per call.
CHAIN_STAGE = function(None, modes=("const", "out"), name="td_k",
                       parallel_fraction=1.0)
INPLACE_STAGE = function(None, modes=("inout",), name="loc_k",
                         parallel_fraction=1.0)


def build_task_parallel(sched: GrScheduler, *, branches: int = 4,
                        chain: int = 4, n: int = 1 << 20,
                        cost_s: float = 1e-3) -> List:
    """``branches`` independent chains of ``chain`` kernels each.

    Each kernel fully occupies its device (``parallel_fraction=1.0``) so
    intra-device space-sharing cannot hide the serialization — speedup must
    come from using more devices.
    """
    stage = CHAIN_STAGE.with_options(scheduler=sched, cost_s=cost_s)
    outs = []
    for b in range(branches):
        x = sched.array(np.zeros(n, np.float32), name=f"td_x{b}")
        for k in range(chain):
            y = sched.array(shape=(n,), dtype=np.float32,
                            name=f"td_y{b}_{k}")
            stage.with_options(name=f"td_k{b}_{k}")(x, y)
            x = y
        outs.append(x)
    return outs


def build_locality_heavy(sched: GrScheduler, *, groups: int = 4,
                         iters: int = 6, n: int = 1 << 20,
                         cost_s: float = 5e-4) -> List:
    """``groups`` arrays, each updated in place ``iters`` times.

    Every kernel reads and writes only its group's array, so the DAG is
    ``groups`` independent sequential chains over *persistent* data — the
    worst case for location-blind placement (each scattered hop drags the
    array across the link) and the best case for data affinity.
    """
    stage = INPLACE_STAGE.with_options(scheduler=sched, cost_s=cost_s)
    outs = []
    for g in range(groups):
        x = sched.array(np.zeros(n, np.float32), name=f"loc_x{g}")
        for it in range(iters):
            stage.with_options(name=f"loc_k{g}_{it}")(x)
        outs.append(x)
    return outs
