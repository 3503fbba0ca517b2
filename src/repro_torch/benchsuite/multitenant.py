"""Multi-tenant contention scenarios (benchsuite companions to suite.py).

The QoS question the priority-weighted runtime must answer: when a small
**latency-sensitive** tenant shares devices with a **bulk throughput**
tenant, does priority weighting protect the former's tail latency without
wrecking aggregate throughput?

:func:`build_contention` constructs exactly that workload:

* the *bulk* tenant issues ``bulk_kernels`` independent, long,
  full-occupancy kernels (priority 0) — enough outstanding work to keep
  every device saturated for the whole episode;
* the *latency* tenant issues ``latency_streams`` sequential chains of
  ``per_stream`` short kernels (one chain ~ one interactive request
  pipeline), tagged ``latency_priority`` when ``use_priority`` is set, else
  priority 0 (the priority-blind baseline).

With weighting on, each latency kernel receives ``w/(w+B)`` of a device
(w = 2**priority, B = concurrent bulk weight) instead of ``1/(1+B)`` —
the chain completes several times sooner while the bulk tenant, which only
cares about aggregate makespan, finishes at essentially the same time
(total work is conserved; the water-fill always hands out full capacity).

Both builders issue plain sequential host code through declared GrFunctions
(the paper's Fig. 4 programming model); tenants, priorities and devices are
call-scoped options — entirely the runtime's business.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core import GrScheduler
from ..core.frontend import function

BULK_TENANT = "bulk"
LATENCY_TENANT = "latency"

# Declared once: a full-occupancy in-place bulk kernel and a full-occupancy
# streaming stage; QoS tags/cost attach per call via with_options.
BULK_STAGE = function(None, modes=("inout",), name="mt_bulk",
                      parallel_fraction=1.0)
LATENCY_STAGE = function(None, modes=("const", "out"), name="mt_lat",
                         parallel_fraction=1.0)


def build_contention(sched: GrScheduler, *, bulk_kernels: int = 6,
                     latency_streams: int = 2, per_stream: int = 6,
                     bulk_cost: float = 4e-3, lat_cost: float = 2e-4,
                     n: int = 1 << 16, latency_priority: int = 3,
                     use_priority: bool = True) -> List:
    """Issue the bulk flood first, then the latency tenant's chains."""
    lp = latency_priority if use_priority else 0
    bulk = BULK_STAGE.with_options(scheduler=sched, cost_s=bulk_cost,
                                   priority=0, tenant=BULK_TENANT)
    lat = LATENCY_STAGE.with_options(scheduler=sched, cost_s=lat_cost,
                                     priority=lp, tenant=LATENCY_TENANT)
    outs = []
    for b in range(bulk_kernels):
        x = sched.array(np.zeros(n, np.float32), name=f"mt_bulk{b}")
        bulk.with_options(name=f"mt_bulk_k{b}")(x)
        outs.append(x)
    for s in range(latency_streams):
        x = sched.array(np.zeros(n, np.float32), name=f"mt_lat{s}")
        for k in range(per_stream):
            y = sched.array(shape=(n,), dtype=np.float32,
                            name=f"mt_lat{s}_{k}")
            lat.with_options(name=f"mt_lat_k{s}_{k}")(x, y)
            x = y
        outs.append(x)
    return outs
