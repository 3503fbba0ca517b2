"""SubmissionPipeline — the explicit, lock-protected submission path.

Historically the stages of issuing one computational element (device
placement, argument prefetch, cross-device migration, DAG insertion, lane
assignment, executor submission) were inlined across ``GrScheduler.launch``
and ``GrScheduler._schedule``; correct only when a single host thread talked
to the scheduler.  Multi-tenant serving has *concurrent* submitters, so the
pipeline is now an explicit object with one re-entrant lock guarding every
stage:

    place -> reserve (EVICT) -> prefetch (H2D) -> migrate (D2D) -> DAG-add
          -> lane-assign -> submit

The lock is held across the whole pipeline for one element (plus the host
synchronization paths), which keeps the paper's dependency inference sound
under concurrency: the DAG frontier, the stream manager's lane table and the
executor's clocks are only ever mutated by the lock holder.  Submissions from
different threads serialize at the pipeline; the *executors* still overlap
device work freely (that is the whole point of lanes).

The pipeline is deliberately a thin, orderable object: each stage is a
method, so subclasses (or tests) can instrument/override individual stages
without re-implementing ``launch``.
"""
from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Iterable, Optional, Sequence, Set

from .element import (Arg, ComputationalElement, DEFAULT_TENANT, ElementKind,
                      inout)

if TYPE_CHECKING:  # pragma: no cover
    from .scheduler import GrScheduler


class SubmissionPipeline:
    """Serializes concurrent submitters onto one scheduler instance."""

    def __init__(self, sched: "GrScheduler") -> None:
        self.sched = sched
        # RLock: host-access synchronization can nest inside a launch (e.g.
        # a ManagedValue.get() issued from a tuning callback) and the public
        # entry points wrap each other freely.
        self._lock = threading.RLock()
        self.submissions = 0
        self._seen_threads: Set[int] = set()

    # -- critical section ------------------------------------------------
    def __enter__(self) -> "SubmissionPipeline":
        self._lock.acquire()
        self._seen_threads.add(threading.get_ident())
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._lock.release()
        return False

    # -- stages ----------------------------------------------------------
    def run(self, e: ComputationalElement) -> None:
        """Full pipeline for a kernel element under the parallel policy.

        Caller must hold the pipeline lock (``with sched.pipeline:``)."""
        sched = self.sched
        # Placement first: prefetches land on the consuming device and
        # cross-device inputs get D2D copies before the kernel is added.
        # A caller-pinned device (GrFunction ``with_options(device=...)``)
        # bypasses the placement policy but is clamped to the device count.
        if e.device is None:
            e.device = sched.streams.place(e, sched.executor.is_done)
        else:
            e.device = min(max(0, int(e.device)), sched.num_devices - 1)
        # Reserve the element's working set before anything lands on the
        # device: under budget pressure this synthesizes DAG-ordered EVICT
        # elements for LRU victims (spill D2H first, reload H2D after — the
        # copy engines see them in that order).
        self.reserve(e)
        # Tier-resident read args (spilled to compressed host / disk) must
        # come back regardless of ``auto_prefetch``: the fault-driven
        # single-device mode can read a *host-valid* array in place, but a
        # tier payload is not host-addressable until its RELOAD runs.
        self.reload(e.args, e.device, priority=e.priority, tenant=e.tenant,
                    deadline_s=e.deadline_s, deadline_t=e.deadline_t)
        # Host-resident read args must reach the device ahead of the kernel.
        # With auto_prefetch off on a single device the executor reads the
        # host copy in place (GrCUDA's fault-driven mode), but on multiple
        # devices skipping the H2D would leave cross-device host-only reads
        # never localized (migrate() only moves device-owned copies), so the
        # upload is forced regardless of the flag.
        if sched.auto_prefetch or sched.num_devices > 1:
            self.prefetch(e.args, e.device, priority=e.priority,
                          tenant=e.tenant, deadline_s=e.deadline_s,
                          deadline_t=e.deadline_t)
        if sched.num_devices > 1:
            self.migrate(e.args, e.device, priority=e.priority,
                         tenant=e.tenant, deadline_s=e.deadline_s,
                         deadline_t=e.deadline_t)
        self.schedule(e)

    def reserve(self, e: ComputationalElement,
                extra_pinned: Optional[Iterable[int]] = None) -> None:
        """Budget stage: make room for ``e``'s working set on its device.

        No-op under unlimited budgets.  Victims are chosen LRU-first among
        non-frontier arrays (no live DAG readers/writer); each victim gets
        one EVICT element — an async D2H write-back (clean copies just
        drop) ordered *after* the victim's last reader by the ordinary
        dependency rules, exactly like the paper's transparent H2D/D2D
        insertion.  Evictions inherit the triggering element's priority and
        tenant: making room is work done on that element's behalf.

        ``extra_pinned`` forwards to :meth:`MemoryManager.reserve` — the
        replay fast path pins its plan-bound arrays so only foreign
        leftovers are evicted under a replay."""
        sched = self.sched
        mem = sched.memory
        if not mem.bounded:
            return
        for ma in mem.reserve(e.device, e, sched.dag.has_device_frontier,
                              extra_pinned):
            self.evict(ma, priority=e.priority, tenant=e.tenant,
                       deadline_s=e.deadline_s, deadline_t=e.deadline_t)

    def reserve_plan(self, plan, extra_pinned: Optional[Iterable[int]] = None
                     ) -> None:
        """Budget stage for a Belady-scheduled plan replay: make room for
        the plan's recorded per-device peaks once, up front.

        A ``mem_scheduled`` plan carries its own EVICT elements — its
        element order *is* the memory schedule — so the only possible
        victims here are *foreign* leftovers from earlier episodes still
        holding bytes the plan's peak needs.  Plan gating
        (``plan_fits``) already guaranteed peak <= budget."""
        sched = self.sched
        mem = sched.memory
        if not mem.bounded:
            return
        for device, peak in plan.device_mem:
            for ma in mem.reserve_bytes(device, peak,
                                        sched.dag.has_device_frontier,
                                        extra_pinned):
                self.evict(ma)

    def evict(self, ma, *, priority: int = 0,
              tenant: str = DEFAULT_TENANT,
              deadline_s: Optional[float] = None,
              deadline_t: Optional[float] = None) -> ComputationalElement:
        """Synthesize and schedule one EVICT element for ``ma``.

        ``inout`` access makes the DAG order it after every in-flight
        reader and the last writer of the array; the device copy is dropped
        at schedule time (logical bits + residency via the MemoryManager),
        the executors perform the physical write-back/release.  A clean
        copy (host still valid) is dropped without moving bytes.

        Dirty victims consult the spill-tier stack (``memory.select_tier``):
        a peer-device spill becomes a device-to-device transfer (the EVICT
        runs on the D2D link, ``src_device`` set like any D2D element), a
        host-tier spill stays on the D2H engine but the tier stores/encodes
        the payload instead of the plain host write-back.  A stack-wide
        miss — or no stack at all — is the flat D2H spill."""
        sched = self.sched
        dirty = not getattr(ma, "host_valid", True)
        tier = plan = None
        if dirty:
            tier, plan = sched.memory.select_tier(ma)
        if tier is None:
            t = ComputationalElement(
                fn=None, args=(inout(ma),), kind=ElementKind.EVICT,
                name=f"evict_{ma.name}",
                transfer_bytes=ma.nbytes if dirty else 0,
                config={"writeback": dirty}, priority=priority, tenant=tenant,
                deadline_s=deadline_s, deadline_t=deadline_t)
            t.device = ma.device_id if ma.device_id is not None else 0
            if sched.policy == "parallel":
                self.schedule(t)
            else:
                self.serial(t)
            sched.memory.note_evict(ma)
            return t
        src = ma.device_id if ma.device_id is not None else 0
        target = plan.get("target")
        wire = int(plan.get("transfer_bytes", ma.nbytes))
        t = ComputationalElement(
            fn=None, args=(inout(ma),), kind=ElementKind.EVICT,
            name=f"evict_{ma.name}", transfer_bytes=wire,
            config=dict({"writeback": True}, **plan.get("config", {})),
            priority=priority, tenant=tenant,
            deadline_s=deadline_s, deadline_t=deadline_t)
        t.tier = tier
        if tier.location == "device":
            t.device = target       # runs on the (src -> target) D2D link
            t.src_device = src
            sched.d2d_transfers += 1
        else:
            t.device = src          # runs on the source's D2H engine
        if sched.policy == "parallel":
            self.schedule(t)
        else:
            self.serial(t)
        sched.memory.note_spill(ma, tier, target, wire)
        return t

    def reload(self, args: Sequence[Arg], device: int, *,
               priority: int = 0, tenant: str = DEFAULT_TENANT,
               deadline_s: Optional[float] = None,
               deadline_t: Optional[float] = None) -> None:
        """Insert RELOAD elements for read args parked in a host-side tier
        (``ma.backing_tier`` set).  The tier handler restores the host
        payload and the H2D engine uploads it; the DAG orders the RELOAD
        after the spill's write via the ordinary ``inout`` rules.  Peer-tier
        blocks never reach here — they are device-resident and come back
        through the migrate stage's plain D2D."""
        sched = self.sched
        for a in args:
            ma = a.array
            tname = getattr(ma, "backing_tier", None)
            if tname is None or not a.mode.reads:
                continue
            tier = sched.memory.tier_named(tname)
            if tier is None:        # stack reconfigured under a live block
                continue
            cfg = {"tier": tier.name}
            gbps = getattr(tier, "gbps", None)
            if gbps is not None:
                cfg["tier_gbps"] = gbps
            t = ComputationalElement(
                fn=None, args=(inout(ma),), kind=ElementKind.RELOAD,
                name=f"reload_{ma.name}",
                transfer_bytes=tier.reload_wire_bytes(ma),
                config=cfg, priority=priority, tenant=tenant,
                deadline_s=deadline_s, deadline_t=deadline_t)
            t.tier = tier
            t.device = device
            if sched.policy == "parallel":
                self.schedule(t)
            else:
                self.serial(t)
            sched.memory.note_reload(ma, device)

    def prefetch(self, args: Sequence[Arg], device: int = 0, *,
                 priority: int = 0, tenant: str = DEFAULT_TENANT,
                 deadline_s: Optional[float] = None,
                 deadline_t: Optional[float] = None) -> None:
        """Insert asynchronous H2D transfers for host-resident read args.

        The transfers inherit the consuming kernel's priority/tenant (and
        deadline): a latency-critical kernel's input upload must not be
        accounted (or de-prioritized) as someone else's work."""
        sched = self.sched
        for a in args:
            ma = a.array
            if a.mode.reads and ma.host_valid and not ma.device_valid:
                t = ComputationalElement(
                    fn=None, args=(inout(ma),), kind=ElementKind.TRANSFER,
                    name=f"h2d_{ma.name}", transfer_bytes=ma.nbytes,
                    priority=priority, tenant=tenant,
                    deadline_s=deadline_s, deadline_t=deadline_t)
                t.device = device
                if sched.policy == "parallel":
                    self.schedule(t)
                else:
                    self.serial(t)
                # Logical location update at schedule time (see managed.py),
                # via the MemoryManager so residency tracks the bits.
                sched.memory.note_h2d(ma, device)

    def migrate(self, args: Sequence[Arg], device: int, *,
                priority: int = 0, tenant: str = DEFAULT_TENANT,
                deadline_s: Optional[float] = None,
                deadline_t: Optional[float] = None) -> None:
        """Move device-resident read args owned by *other* devices onto
        ``device`` via D2D transfer elements (single-copy ownership model:
        the copy migrates, it is not replicated)."""
        sched = self.sched
        for a in args:
            ma = a.array
            if not a.mode.reads or not getattr(ma, "device_valid", False):
                continue
            src = getattr(ma, "device_id", None)
            if src is None:
                sched.memory.note_d2d(ma, device)  # claim unowned copies
                continue
            if src == device:
                continue
            t = ComputationalElement(
                fn=None, args=(inout(ma),), kind=ElementKind.D2D,
                name=f"d2d_{ma.name}", transfer_bytes=getattr(ma, "nbytes", 0),
                priority=priority, tenant=tenant,
                deadline_s=deadline_s, deadline_t=deadline_t)
            t.device = device
            t.src_device = src
            self.schedule(t)
            sched.memory.note_d2d(ma, device)
            sched.d2d_transfers += 1

    def schedule(self, e: ComputationalElement) -> None:
        """DAG insert + lane assignment + submission (parallel policy)."""
        sched = self.sched
        # Idempotent deadline stamp: kernels arrive tagged from _launch,
        # auto children carry inherited deadline_t; both still register
        # with the monitor here (direct schedule() callers get stamped).
        sched.deadlines.tag(e)
        sched.executor.host_overhead(sched.launch_overhead_s)
        if sched.sanitizer is not None:
            sched.sanitizer.on_schedule(e)
        sched.dag.add(e)
        lane, events = sched.streams.assign(e, sched.executor.is_done)
        sched.executor.submit(e, lane.lane_id, events)
        sched._elements.append(e)
        self.submissions += 1
        # Submission-time deadline-risk check (may preempt queued bulk work).
        sched.deadlines.on_submit(e)
        if sched._capture is not None:
            sched._capture.trace(e)

    def serial(self, e: ComputationalElement) -> None:
        """Original GrCUDA behaviour: blocking, in-order, single lane, no
        dependency computation (overheads even smaller, §V-C)."""
        sched = self.sched
        sched.executor.host_overhead(sched.launch_overhead_s)
        e.parents = []
        sched.executor.submit(e, 0, [])
        sched.executor.wait(e)
        sched._elements.append(e)
        self.submissions += 1

    # -- stats -----------------------------------------------------------
    def stats(self) -> dict:
        return {"pipeline_submissions": self.submissions,
                "pipeline_threads_seen": len(self._seen_threads)}
