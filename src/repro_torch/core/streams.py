"""Stream (execution-lane) management (paper §IV-C) + device placement.

CUDA streams map to GrJAX *lanes*: ordered dispatch queues that serialize the
elements assigned to them while different lanes proceed independently.  On a
real TPU deployment a lane is a per-device async dispatch queue or a submesh
(see DESIGN.md §2); the assignment algorithm below is the paper's, verbatim:

* lanes are reused in FIFO order; a new lane is created **only** when no
  currently-empty lane exists;
* the **first child** of a computation is scheduled on its parent's lane
  (sequential lane order makes the dependency free — no event needed);
  **following children** are scheduled on other lanes to guarantee
  concurrency, synchronizing with an event;
* the manager tracks which computations are in flight on each lane and which
  managed arrays each lane currently *owns*, so a host access synchronizes
  only the lanes operating on that data (§IV-B).

Multi-device extension: every lane is pinned to one ``device_id`` and a
pluggable :class:`PlacementPolicy` picks the device for each new element
*before* lane assignment.  Lane reuse, first-child inheritance and event
insertion then all happen within the chosen device; the scheduler inserts
``D2D`` transfer elements when an input's owning device disagrees with the
placement (see scheduler.py).
"""
from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

from .element import ComputationalElement


class NewStreamPolicy(enum.Enum):
    """How to obtain a lane when none can be inherited from a parent."""

    FIFO_REUSE = "fifo"          # reuse an empty lane in FIFO order (default)
    ALWAYS_NEW = "always-new"    # create a fresh lane every time


class ParentStreamPolicy(enum.Enum):
    """How children relate to their parents' lanes."""

    FIRST_CHILD_INHERITS = "disjoint"      # paper default (§IV-C)
    SAME_AS_PARENT = "same-as-parent"      # all children share parent's lane


@dataclass
class Lane:
    lane_id: int
    device_id: int = 0
    in_flight: List[ComputationalElement] = field(default_factory=list)
    last: Optional[ComputationalElement] = None   # tail of the lane's queue
    # Lanes pre-reserved for an execution plan (capture/replay) are excluded
    # from the eager scheduler's FIFO-reuse pool, so interleaved eager work
    # cannot serialize into a replayed episode's queues.
    reserved: bool = False
    # Incremental per-tenant occupancy (count of in-flight elements per
    # tenant) maintained on every add/prune/release, so quota checks do not
    # rescan ``in_flight``.  ``manager`` (set by StreamManager._new_lane)
    # receives busy-lane transitions (0 -> >0 and back) per tenant.
    manager: Optional["StreamManager"] = None
    _tenant_counts: Dict[str, int] = field(default_factory=dict)

    def _note_add(self, e: ComputationalElement) -> None:
        n = self._tenant_counts.get(e.tenant, 0)
        self._tenant_counts[e.tenant] = n + 1
        if n == 0 and self.manager is not None:
            self.manager._busy_transition(self, e.tenant, +1)

    def _note_remove(self, e: ComputationalElement) -> None:
        n = self._tenant_counts.get(e.tenant, 0)
        if n <= 1:
            self._tenant_counts.pop(e.tenant, None)
            if n == 1 and self.manager is not None:
                self.manager._busy_transition(self, e.tenant, -1)
        else:
            self._tenant_counts[e.tenant] = n - 1

    def add(self, e: ComputationalElement) -> None:
        self.in_flight.append(e)
        self._note_add(e)

    def pending(self, is_done: Callable[[ComputationalElement], bool]) -> int:
        alive: List[ComputationalElement] = []
        for e in self.in_flight:
            if is_done(e):
                self._note_remove(e)
            else:
                alive.append(e)
        self.in_flight = alive
        return len(alive)

    def serves(self, tenant: str) -> bool:
        """Whether any in-flight element belongs to ``tenant`` (per-tenant
        lane quotas count a shared lane for every tenant queued on it)."""
        return self._tenant_counts.get(tenant, 0) > 0

    def load(self, is_done) -> float:
        """Cost-weighted outstanding work (used by min-load placement)."""
        self.pending(is_done)
        return sum(max(e.cost_s, 1e-6) for e in self.in_flight)

    def min_priority(self) -> Optional[int]:
        """Lowest priority currently queued on this lane (None when idle)."""
        if not self.in_flight:
            return None
        return min(e.priority for e in self.in_flight)

    def min_deadline(self) -> float:
        """Earliest effective deadline queued on this lane (inf when idle or
        when every queued element is deadline-free)."""
        if not self.in_flight:
            return float("inf")
        return min(e.effective_deadline for e in self.in_flight)


# ======================================================================
# Device placement policies
# ======================================================================

class PlacementPolicy:
    """Picks the device for an element before lane assignment."""

    name = "base"

    def choose(self, element: ComputationalElement, manager: "StreamManager",
               is_done) -> int:
        raise NotImplementedError


class RoundRobinPlacement(PlacementPolicy):
    """Cycle devices per launch — maximal spreading, ignores data location."""

    name = "round-robin"

    def __init__(self) -> None:
        self._next = 0

    def choose(self, element, manager, is_done) -> int:
        d = self._next % manager.num_devices
        self._next += 1
        return d


class MinLoadPlacement(PlacementPolicy):
    """Least outstanding (cost-weighted) work across each device's lanes."""

    name = "min-load"

    def choose(self, element, manager, is_done) -> int:
        return min(range(manager.num_devices),
                   key=lambda d: (manager.device_load(d, is_done), d))


class DataAffinityPlacement(PlacementPolicy):
    """Device that already owns the most input bytes; falls back to min-load
    for elements with no device-resident inputs.  Minimizes D2D traffic on
    locality-heavy DAGs."""

    name = "affinity"

    def __init__(self) -> None:
        self._fallback = MinLoadPlacement()

    def choose(self, element, manager, is_done) -> int:
        bytes_on: Dict[int, int] = {}
        for a in element.args:
            ma = a.array
            dev = getattr(ma, "device_id", None)
            if (a.mode.reads and getattr(ma, "device_valid", False)
                    and dev is not None and dev < manager.num_devices):
                bytes_on[dev] = bytes_on.get(dev, 0) + getattr(ma, "nbytes", 0)
        if bytes_on:
            return max(sorted(bytes_on), key=lambda d: bytes_on[d])
        return self._fallback.choose(element, manager, is_done)


class MinPressurePlacement(PlacementPolicy):
    """Memory-aware placement: the device whose budget occupancy after
    hosting the element's arguments is lowest; ties break by outstanding
    load, then device id.  With unlimited budgets every device reports
    zero pressure and the policy degrades to min-load."""

    name = "min-pressure"

    def __init__(self) -> None:
        self._fallback = MinLoadPlacement()

    def choose(self, element, manager, is_done) -> int:
        mem = getattr(manager, "memory", None)
        if mem is None or not mem.bounded:
            return self._fallback.choose(element, manager, is_done)
        return min(range(manager.num_devices),
                   key=lambda d: (mem.placement_pressure(d, element.args),
                                  manager.device_load(d, is_done), d))


PLACEMENT_POLICIES = {p.name: p for p in
                      (RoundRobinPlacement, MinLoadPlacement,
                       DataAffinityPlacement, MinPressurePlacement)}


def make_placement(policy: Union[str, PlacementPolicy, None]
                   ) -> PlacementPolicy:
    if policy is None:
        return RoundRobinPlacement()
    if isinstance(policy, PlacementPolicy):
        return policy
    try:
        return PLACEMENT_POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown placement policy {policy!r}; "
                         f"choose from "
                         f"{sorted(PLACEMENT_POLICIES)}") from None


# ======================================================================
class StreamManager:
    """Assigns computational elements to (device, lane) and decides event
    insertion.  ``max_lanes`` caps lanes *per device*."""

    def __init__(self,
                 new_stream_policy: NewStreamPolicy = NewStreamPolicy.FIFO_REUSE,
                 parent_stream_policy: ParentStreamPolicy = ParentStreamPolicy.FIRST_CHILD_INHERITS,
                 max_lanes: Optional[int] = None,
                 num_devices: int = 1,
                 placement: Union[str, PlacementPolicy, None] = None,
                 tenant_quotas: Optional[Dict[str, int]] = None) -> None:
        self.new_stream_policy = new_stream_policy
        self.parent_stream_policy = parent_stream_policy
        self.max_lanes = max_lanes
        self.num_devices = max(1, num_devices)
        self.placement = make_placement(placement)
        # Optional per-tenant cap on concurrently *busy* lanes per device: a
        # bulk tenant with a quota of 2 can keep at most 2 queues of work
        # outstanding per device, however many elements it submits.
        self.tenant_quotas: Dict[str, int] = dict(tenant_quotas or {})
        # MemoryManager installed by the owning scheduler; placement uses it
        # to refuse devices whose byte budget the element cannot fit and to
        # drive the min-pressure policy.  None for standalone managers.
        self.memory = None
        self.lanes: Dict[int, Lane] = {}
        self._free: Dict[int, deque] = {}    # device -> FIFO of idle lane ids
        self.lanes_created = 0
        self.events_created = 0
        self.events_cross_device = 0
        self.priority_bypasses = 0   # saturated fallbacks that dodged a
        #                              lower-priority lane tail
        self.edf_bypasses = 0        # saturated fallbacks that dodged a
        #                              later-deadline lane tail (EDF)
        self.quota_fallbacks = 0     # submissions folded onto a tenant's own
        #                              lanes because its quota was reached
        # Incremental (device, tenant) -> busy-lane count, maintained by the
        # lanes' _note_add/_note_remove transitions.  An *upper bound*: a
        # lane leaves the count only when its finished elements are pruned
        # (pending()/release()), so ``count < quota`` proves the precise scan
        # would pass and the scan is skipped; ``count >= quota`` falls back
        # to the pruning scan for the exact answer.
        self._tenant_busy: Dict[Tuple[int, str], int] = {}
        # plan key -> list of reserved lane-set instances, each mapping the
        # plan-local lane id to a real lane id (capture/replay, §V-D oracle).
        self._plan_lanes: Dict[str, List[Dict[int, int]]] = {}
        self._plan_rr = 0
        self.max_plan_instances = 4

    # ------------------------------------------------------------------
    def device_lanes(self, device: int) -> List[Lane]:
        return [l for l in self.lanes.values() if l.device_id == device]

    def device_load(self, device: int, is_done) -> float:
        return sum(l.load(is_done) for l in self.device_lanes(device))

    def place(self, element: ComputationalElement, is_done) -> int:
        """Pick the device for ``element`` (0 when single-device).

        Whatever the policy chose, a device whose byte budget is smaller
        than the element's working set is refused — no amount of eviction
        could make the element fit there.  The least-pressured fitting
        device is substituted; when *no* device fits, the policy's choice
        stands and the pipeline's reserve stage raises the descriptive
        :class:`~repro.core.memory.DeviceOutOfMemoryError`."""
        if self.num_devices <= 1:
            return 0
        d = self.placement.choose(element, self, is_done)
        d = min(max(0, int(d)), self.num_devices - 1)
        mem = self.memory
        if mem is not None and mem.bounded:
            ws = mem.working_set_bytes(element.args)
            if not mem.device_fits(d, ws):
                fitting = [x for x in range(self.num_devices)
                           if mem.device_fits(x, ws)]
                if fitting:
                    d = min(fitting, key=lambda x: (mem.pressure(x), x))
        return d

    # ------------------------------------------------------------------
    def _busy_transition(self, lane: Lane, tenant: str, delta: int) -> None:
        key = (lane.device_id, tenant)
        n = self._tenant_busy.get(key, 0) + delta
        if n <= 0:
            self._tenant_busy.pop(key, None)
        else:
            self._tenant_busy[key] = n

    def busy_lanes(self, device: int, tenant: str) -> int:
        """Upper bound on ``tenant``'s busy lanes on ``device`` (see
        ``_tenant_busy``)."""
        return self._tenant_busy.get((device, tenant), 0)

    def _new_lane(self, device: int) -> Lane:
        lane = Lane(self.lanes_created, device_id=device, manager=self)
        self.lanes[lane.lane_id] = lane
        self.lanes_created += 1
        return lane

    def _acquire_free_lane(self, is_done, device: int,
                           element: Optional[ComputationalElement] = None
                           ) -> Lane:
        # Per-tenant quota: once the tenant occupies its full allowance of
        # busy lanes on this device, fold the element onto the least-loaded
        # of its *own* lanes instead of taking a free/new one — other
        # tenants' concurrency is protected from a flooding submitter.
        if element is not None and self.tenant_quotas:
            quota = self.tenant_quotas.get(element.tenant)
            if quota is not None:
                # A lane counts toward the quota while ANY of the tenant's
                # work is queued on it (not just the latest assignee — a
                # shared lane must not silently drop out of the count).
                # The incremental busy-lane count is an upper bound, so
                # ``count < quota`` skips the per-lane pruning scan entirely
                # (provably the same decision); only at/over quota do we pay
                # for the precise scan.
                if (self.busy_lanes(device, element.tenant)
                        >= max(1, quota)):
                    own = [l for l in self.device_lanes(device)
                           if not l.reserved and l.pending(is_done) > 0
                           and l.serves(element.tenant)]
                    if len(own) >= max(1, quota):
                        self.quota_fallbacks += 1
                        return self._fallback_lane(own, element, is_done)
        free = self._free.setdefault(device, deque())
        if self.new_stream_policy is NewStreamPolicy.FIFO_REUSE:
            # Reclaim lanes whose queues drained (FIFO order, §IV-C).
            for _ in range(len(free)):
                lane_id = free.popleft()
                lane = self.lanes[lane_id]
                if lane.pending(is_done) == 0:
                    return lane
                free.append(lane_id)
            # Lazily scan for drained lanes not yet returned to the pool.
            for lane in self.lanes.values():
                if (lane.device_id == device and not lane.reserved
                        and lane.pending(is_done) == 0
                        and lane.lane_id not in free):
                    return lane
        # Reserved plan lanes neither count toward nor satisfy the eager cap.
        dev_lanes = [l for l in self.device_lanes(device) if not l.reserved]
        if (self.max_lanes is not None and dev_lanes
                and len(dev_lanes) >= self.max_lanes):
            # Saturated: fall back to a lane on this device, priority-aware.
            return self._fallback_lane(dev_lanes, element, is_done)
        return self._new_lane(device)

    def _fallback_lane(self, lanes: List[Lane],
                       element: Optional[ComputationalElement],
                       is_done) -> Lane:
        """Pick an existing lane to queue on when no fresh lane is allowed.

        Priority-aware: a lane whose queue holds *lower-priority* work would
        make the element wait behind it (lane order is FIFO), so such lanes
        are only chosen when every alternative is equally blocked; ties break
        by shortest queue.  This is what keeps a latency-critical element
        from parking behind a bulk tenant's queue under ``max_lanes``
        saturation.

        EDF-aware: a lane whose queue holds only *later-deadline* (or
        deadline-free) work would likewise delay a deadline'd element past
        its EDF rank, so such lanes sort after lanes already serving an
        equal-or-earlier deadline.  For deadline-free elements the EDF term
        is vacuously False everywhere (``inf < x`` never holds), preserving
        today's ordering bit-for-bit."""
        prio = element.priority if element is not None else 0
        edl = (element.effective_deadline if element is not None
               else float("inf"))

        def key(lane: Lane):
            n = lane.pending(is_done)       # prunes finished elements first
            mp = lane.min_priority()
            blocked = mp is not None and mp < prio
            edf_blocked = n > 0 and edl < lane.min_deadline()
            return (blocked, edf_blocked, n, lane.lane_id)

        keyed = sorted(((key(lane), lane) for lane in lanes),
                       key=lambda kl: kl[0])
        best_key, best = keyed[0]
        bmp = best.min_priority()
        if any(l.min_priority() is not None and l.min_priority() < prio
               for l in lanes) and not (bmp is not None and bmp < prio):
            self.priority_bypasses += 1
        if (edl != float("inf") and not best_key[1]
                and any(k[1] for k, _ in keyed[1:])):
            self.edf_bypasses += 1
        return best

    # ------------------------------------------------------------------
    def assign(self, element: ComputationalElement,
               is_done: Callable[[ComputationalElement], bool]
               ) -> Tuple[Lane, List[ComputationalElement]]:
        """Pick a lane for ``element``; return (lane, parents needing events).

        A parent needs no event when it is the lane's current tail (lane
        order guarantees completion) — the "first child inherits" rule; every
        other *unfinished* parent contributes one synchronization event.
        ``element.device`` (set by :meth:`place`) constrains inheritance: a
        parent's lane is only inherited when it lives on the same device.
        """
        parents = element.parents
        device = element.device if element.device is not None else 0
        lane: Optional[Lane] = None

        if parents and self.parent_stream_policy is ParentStreamPolicy.SAME_AS_PARENT:
            plane = self.lanes.get(parents[0].stream)
            if (plane is not None and plane.device_id == device
                    and not plane.reserved):
                lane = plane
        elif parents:
            # First child inherits: find a parent that (a) sits at the tail of
            # its lane, (b) lives on the chosen device, and (c) has no
            # scheduled child yet on that lane.  Reserved plan lanes are
            # never inherited — eager children of replayed elements must not
            # serialize into a plan's queues.
            for p in sorted(parents, key=lambda q: -q.cost_s):
                if p.stream is None:
                    continue
                plane = self.lanes[p.stream]
                if plane.device_id != device or plane.reserved:
                    continue
                if plane.last is p and not is_done(p):
                    lane = plane
                    break

        if lane is None:
            lane = self._acquire_free_lane(is_done, device, element)

        element.stream = lane.lane_id
        element.device = lane.device_id
        lane.add(element)
        lane.last = element

        # Events: every unfinished parent on a *different* lane.  Same-lane
        # parents — tail or not — were enqueued earlier on this FIFO lane,
        # so queue order already covers them and no event is needed.
        events = []
        for p in parents:
            if is_done(p) or p.stream == lane.lane_id:
                continue
            events.append(p)
            if p.device is not None and p.device != lane.device_id:
                self.events_cross_device += 1
        self.events_created += len(events)
        return lane, events

    # ------------------------------------------------------------------
    # Capture/replay: pre-reserved lane sets for execution plans (§V-D).
    # ------------------------------------------------------------------
    def reserve(self, plan_key: str, lane_devices, is_done) -> Dict[int, Lane]:
        """Pre-reserve a dedicated lane set for one replay of an execution
        plan.  ``lane_devices`` is the plan's (plan-local lane id -> device)
        mapping.  The first idle instance is reused (mirroring
        ``cudaGraphLaunch`` re-submitting into the same streams); while all
        instances are busy, up to ``max_plan_instances`` fresh sets are
        created so concurrent replays of the same plan keep space-sharing,
        after which instances are handed out round-robin (lane FIFO order
        keeps overlapping replays correct — they merely serialize)."""
        instances = self._plan_lanes.setdefault(plan_key, [])
        for inst in instances:
            lanes = {c: self.lanes[lid] for c, lid in inst.items()}
            if all(l.pending(is_done) == 0 for l in lanes.values()):
                return lanes
        if len(instances) < self.max_plan_instances:
            inst = {}
            for cap_id, dev in sorted(lane_devices):
                # Recycle a drained eager lane when one exists — plan churn
                # (record/invalidate cycles) must not grow the lane table
                # (= worker threads on the real executor) without bound.
                lane = self._reclaim_idle_lane(dev, is_done) or self._new_lane(dev)
                lane.reserved = True
                inst[cap_id] = lane.lane_id
            instances.append(inst)
            return {c: self.lanes[lid] for c, lid in inst.items()}
        inst = instances[self._plan_rr % len(instances)]
        self._plan_rr += 1
        return {c: self.lanes[lid] for c, lid in inst.items()}

    def _reclaim_idle_lane(self, device: int, is_done) -> Optional[Lane]:
        free = self._free.get(device)
        if not free:
            return None
        for _ in range(len(free)):
            lid = free.popleft()
            lane = self.lanes[lid]
            if lane.pending(is_done) == 0:
                return lane
            free.append(lid)
        return None

    def unreserve(self, plan_key: str) -> None:
        """Return a dropped plan's lanes to the eager pool (called when a
        plan is invalidated or evicted from the cache — without this, every
        divergence in a long-running loop would leak a reserved lane set).
        The lanes may still hold in-flight replayed work, so they are only
        un-flagged here; the eager FIFO-reuse scan reclaims them once
        drained."""
        for inst in self._plan_lanes.pop(plan_key, []):
            for lid in inst.values():
                lane = self.lanes.get(lid)
                if lane is not None:
                    lane.reserved = False

    def bind_to_lane(self, lane: Lane, element: ComputationalElement) -> None:
        """Replay fast path: place ``element`` on a pre-reserved lane,
        skipping placement and the assignment algorithm entirely."""
        element.stream = lane.lane_id
        element.device = lane.device_id
        lane.add(element)
        lane.last = element

    # ------------------------------------------------------------------
    def release(self, element: ComputationalElement) -> None:
        """Called when the host has synchronized with ``element``."""
        lane = self.lanes.get(element.stream) if element.stream is not None else None
        if lane is None:
            return
        if element in lane.in_flight:
            lane.in_flight.remove(element)
            lane._note_remove(element)
        if not lane.in_flight and lane.last is not None and not lane.last.active:
            # A drained lane's retired tail can never be inherited again,
            # but through parents/children lists it would pin the whole
            # episode graph — and, transitively, its arrays — in memory for
            # as long as the lane idles.
            lane.last = None
        if lane.reserved:
            return    # plan lanes are recycled via reserve(), not the pool
        free = self._free.setdefault(lane.device_id, deque())
        if not lane.in_flight and lane.lane_id not in free:
            free.append(lane.lane_id)

    def stats(self) -> dict:
        out = {"lanes_created": self.lanes_created,
               "events_created": self.events_created}
        if self.priority_bypasses:
            out["priority_bypasses"] = self.priority_bypasses
        if self.edf_bypasses:
            out["edf_bypasses"] = self.edf_bypasses
        if self.tenant_quotas:
            out["quota_fallbacks"] = self.quota_fallbacks
        if self._plan_lanes:
            out["plan_lane_sets"] = sum(len(v) for v in
                                        self._plan_lanes.values())
        if self.num_devices > 1:
            out.update({
                "num_devices": self.num_devices,
                "placement": self.placement.name,
                "events_cross_device": self.events_cross_device,
                "lanes_per_device": {
                    d: len(self.device_lanes(d))
                    for d in range(self.num_devices)},
            })
        return out
