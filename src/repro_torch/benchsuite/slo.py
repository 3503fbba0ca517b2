"""Deadline/SLO contention scenario (benchsuite companion to
multitenant.py).

The tail-latency question the deadline-aware runtime must answer: when a
**latency tenant** with a per-launch deadline shares one device — compute
capacity *and* the H2D copy engine — with a quota-folded **bulk tenant**
whose lanes hold deep queues of large uploads and long kernels, do EDF
ordering and element-boundary preemption bound the latency tenant's p99
without wrecking the bulk tenant's makespan?

:func:`build_slo_workload` constructs exactly that adversarial mix:

* the *bulk* tenant issues ``bulk_units`` upload+process stages (a fresh
  ``bulk_mb``-sized host array H2D'd then consumed by a long full-occupancy
  kernel).  Run it under a ``tenant_quotas={"bulk": 2}`` scheduler: the
  flood folds onto two lanes, so at any instant two bulk tasks are started
  (holding the copy engine / device) while the rest sit *queued* — exactly
  the state element-boundary preemption can act on;
* the *latency* tenant then issues ``latency_chains`` sequential chains of
  ``per_chain`` short kernels, each chain fed by a small host upload.  With
  ``use_deadlines`` every latency launch carries ``deadline_s``; without it
  the chains are plain priority-0 work (the priority-only baseline — both tenants
  equal priority, so priority weighting cannot help).

Without deadlines a chain's first upload queues behind the bulk uploads
already handed to the FIFO copy engine and its kernels water-fill against
the running bulk kernels — p99 is set by the bulk tenant's queue depth.
With deadlines the chain EDF-ranks first for device capacity, and when its
slack runs low the monitor pauses the bulk lanes' *queued* elements at the
next element boundary, so the engine and device drain to the urgent
frontier.  Total bulk work is conserved (the paused elements would have
received no capacity anyway), so the bulk makespan moves by at most the
pause windows where its lanes sit idle.

Both tenants are priority 0 throughout: every improvement measured on this
workload is attributable to the deadline machinery alone.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core import GrScheduler
from ..core.frontend import function

BULK_TENANT = "bulk"
LATENCY_TENANT = "latency"

# Declared once: a full-occupancy bulk consumer and a full-occupancy latency
# stage; cost, tenant and deadline attach per call via with_options.
SLO_BULK = function(None, modes=("inout",), name="slo_bulk",
                    parallel_fraction=1.0)
SLO_LAT = function(None, modes=("const", "out"), name="slo_lat",
                   parallel_fraction=1.0)


def build_slo_workload(sched: GrScheduler, *, bulk_units: int = 32,
                       latency_chains: int = 2, per_chain: int = 4,
                       bulk_mb: float = 2.0, bulk_cost: float = 1e-3,
                       lat_cost: float = 1.5e-4, lat_kb: int = 64,
                       deadline_s: Optional[float] = 2.5e-3,
                       use_deadlines: bool = True) -> List:
    """Issue the bulk flood, then the latency tenant's deadline'd chains.

    ``deadline_s`` applies to every latency launch when ``use_deadlines``
    is set; pass ``use_deadlines=False`` for the deadline-blind baseline
    (identical workload, no deadline tags).  Returns the output arrays so
    callers can extend the episode or force a drain."""
    bulk_n = max(1, int(bulk_mb * (1 << 20)) // 4)
    lat_n = max(1, (lat_kb << 10) // 4)
    bulk = SLO_BULK.with_options(scheduler=sched, cost_s=bulk_cost,
                                 priority=0, tenant=BULK_TENANT)
    lat = SLO_LAT.with_options(scheduler=sched, cost_s=lat_cost,
                               priority=0, tenant=LATENCY_TENANT)
    if use_deadlines and deadline_s is not None:
        lat = lat.with_options(deadline_s=float(deadline_s))
    outs = []
    for b in range(bulk_units):
        # Fresh host-resident input per unit: each stage costs one large
        # H2D on the FIFO copy engine before its kernel can run.
        x = sched.array(np.zeros(bulk_n, np.float32), name=f"slo_bulk{b}")
        bulk.with_options(name=f"slo_bulk_k{b}")(x)
        outs.append(x)
    for s in range(latency_chains):
        x = sched.array(np.zeros(lat_n, np.float32), name=f"slo_lat{s}")
        for k in range(per_chain):
            y = sched.array(shape=(lat_n,), dtype=np.float32,
                            name=f"slo_lat{s}_{k}")
            lat.with_options(name=f"slo_lat_k{s}_{k}")(x, y)
            x = y
        outs.append(x)
    return outs
