"""Graph capture & replay — reusable execution plans (CUDA-Graphs analogue).

The paper's strongest baseline (§V-D) is a hand-written CUDA-Graphs
schedule: the full DAG is known in advance, so launching it costs a single
``cudaGraphLaunch`` instead of per-kernel dependency inference, stream
assignment and launch overhead.  This module closes that gap *without*
giving up the paper's core premise (no upfront program structure):

* ``with scheduler.capture(name):`` — a transparent recording context.  The
  first episode under a given ``name``/signature runs eagerly while its
  launches are traced into an immutable :class:`ExecutionPlan`; later
  episodes are matched launch-by-launch against the cached plan and replayed
  through a fast path that skips ``ComputationDAG.add``,
  ``StreamManager.place``/``assign`` and the per-element launch overhead
  (one reduced plan-launch overhead is charged instead).
* ``scheduler.replay(plan, bindings)`` — explicit re-submission of a whole
  plan with fresh arrays bound by slot.

Plans are keyed by (name + structural signature: argument shapes/dtypes,
access modes, kernel configs, logical data locations).  When a traced
episode diverges from its plan mid-way, the plan is invalidated and the
episode continues eagerly, so capture is always semantics-preserving.

Lane assignment is *re-planned* at capture finalization: the eager episode's
lane choices are an artifact of host pacing (a slow host drains every lane
between launches), so the plan re-runs the paper's §IV-C assignment rules
structurally — nothing assumed complete, first child inherits, fresh lane
otherwise — which is exactly the schedule the zero-overhead oracle produces.
Replays then run on a lane set pre-reserved via ``StreamManager.reserve``.
"""
from __future__ import annotations

import itertools
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

from .element import (AccessMode, Arg, ComputationalElement, DEFAULT_TENANT,
                      ElementKind, dep_key)

_PLAN_IDS = itertools.count()


def _freeze(v: Any) -> Any:
    """Hashable stand-in for a launch-config value (plan signatures are
    dict keys).  Containers freeze recursively; anything else unhashable
    degrades to its repr — two values with equal reprs then match, which is
    the right conservatism for cache keying."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (set, frozenset)):
        return tuple(sorted((_freeze(x) for x in v), key=repr))
    try:
        hash(v)
    except TypeError:
        # Array-likes compare by exact content (repr would truncate large
        # arrays and let different values collide); anything else degrades
        # to repr, which is conservative for cache keying.
        tobytes = getattr(v, "tobytes", None)
        if callable(tobytes):
            return ("array", getattr(v, "shape", None),
                    str(getattr(v, "dtype", "")), tobytes())
        return repr(v)
    return v


def freeze_config(config: dict) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted((k, _freeze(v)) for k, v in config.items()))


class _PlanSignature:
    """Structural cache key with a memoized hash.

    The signature tuple nests every element/slot of the plan; tuples do not
    cache their hash, so keying the cache on the raw tuple re-walked the
    whole plan on *every* probe (each transparent episode probes at least
    once).  Hashing once at plan finalization makes the probe O(1); equality
    short-circuits on the stored hash before falling back to the tuple
    compare dict collisions require."""

    __slots__ = ("data", "_hash")

    def __init__(self, data: Tuple) -> None:
        self.data = data
        self._hash = hash(data)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, _PlanSignature):
            return self._hash == other._hash and self.data == other.data
        return self.data == other

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<_PlanSignature {self._hash:#x}>"


# ======================================================================
# Immutable plan structures
# ======================================================================

@dataclass(frozen=True)
class SlotSpec:
    """One array-binding slot of an execution plan.

    Captures the array's geometry and its *logical location bits* at first
    use — a replay binding must present the same shape/dtype and the same
    location state, otherwise the recorded transfer structure would be wrong
    for the new array (e.g. a recorded H2D prefetch re-run against an array
    that only lives on the device)."""

    index: int
    name: str
    shape: Optional[Tuple[int, ...]]
    dtype: Optional[str]
    nbytes: int
    host_valid: bool
    device_valid: bool
    device_id: Optional[int]
    # Backing tier holding the array at capture time (None = not spilled).
    # Part of the slot state: a plan recorded against a disk-resident array
    # replays a disk RELOAD, which would read the wrong payload for an
    # array parked in (say) the compressed tier.
    tier: Optional[str] = None

    def geometry_matches(self, array: Any) -> bool:
        shape = getattr(array, "shape", None)
        dtype = getattr(array, "dtype", None)
        return ((tuple(shape) if shape is not None else None) == self.shape
                and (str(dtype) if dtype is not None else None) == self.dtype)

    def state_matches(self, array: Any) -> bool:
        return (bool(getattr(array, "host_valid", False)) == self.host_valid
                and bool(getattr(array, "device_valid", False)) == self.device_valid
                and getattr(array, "device_id", None) == self.device_id
                and getattr(array, "backing_tier", None) == self.tier)


def _slot_spec(index: int, array: Any) -> SlotSpec:
    shape = getattr(array, "shape", None)
    dtype = getattr(array, "dtype", None)
    return SlotSpec(
        index=index,
        name=getattr(array, "name", f"slot{index}"),
        shape=tuple(shape) if shape is not None else None,
        dtype=str(dtype) if dtype is not None else None,
        nbytes=int(getattr(array, "nbytes", 0)),
        host_valid=bool(getattr(array, "host_valid", False)),
        device_valid=bool(getattr(array, "device_valid", False)),
        device_id=getattr(array, "device_id", None),
        tier=getattr(array, "backing_tier", None))


@dataclass(frozen=True)
class PlanElement:
    """One topologically-ordered vertex of an execution plan."""

    index: int
    kind: ElementKind
    name: str
    config: Tuple[Tuple[str, Any], ...]       # frozen launch-config items
    cost_s: float
    transfer_bytes: int
    arg_slots: Tuple[Tuple[int, AccessMode], ...]
    lane: int                                  # plan-local lane id
    device: int
    src_device: Optional[int]
    parents: Tuple[int, ...]                   # plan indices (in-trace only)
    wait_events: Tuple[int, ...]               # cross-lane parents -> events
    # QoS tags are part of the structural signature: an episode re-issued at
    # a different priority (or by a different tenant) records its own plan,
    # so replay always reproduces the captured capacity weighting.
    priority: int = 0
    tenant: str = DEFAULT_TENANT
    # Relative deadline window (seconds).  Part of the signature — a plan
    # captured without deadlines must not replay a deadline'd episode (EDF
    # ordering and preemption eligibility differ).  The *absolute* deadline
    # is never captured: replay re-stamps ``deadline_t`` at submission time.
    deadline_s: Optional[float] = None
    # Declared-function identity (GrFunction frontend).  Part of the
    # signature: two declarations that happen to share a kernel name never
    # alias each other's plans, while one declaration whose Python closure
    # is re-created per episode keeps replaying the same plan.
    fn_key: Optional[int] = None
    # The caller pinned this element's device explicitly; the plan-time
    # optimizer (planopt.py) must keep it in place — replay matching
    # rejects a device retarget of a pinned launch.
    pinned: bool = False


@dataclass(frozen=True)
class ExecutionPlan:
    """Immutable, replayable trace of one episode.

    ``signature`` is the structural cache key (everything except the
    callables and the default array bindings); ``key`` is a process-unique
    id used to reserve lane sets."""

    name: str
    key: str
    elements: Tuple[PlanElement, ...]
    slots: Tuple[SlotSpec, ...]
    fns: Tuple[Optional[Callable], ...]        # captured callables
    configs: Tuple[dict, ...]                  # original (unfrozen) configs
    # Default bindings are held *weakly*: the transparent match path always
    # rebinds the episode's current arrays, so a cached plan must not pin a
    # retired episode's batch tensors in memory.  Explicit replay of an
    # unbound slot raises if the captured array has been collected.
    slot_arrays: Tuple["weakref.ref", ...]
    lane_devices: Tuple[Tuple[int, int], ...]  # (plan-local lane, device)
    kernel_positions: Tuple[int, ...]
    # Per-device peak resident bytes of one replay, computed structurally
    # from the trace (slot geometry + transfer/evict/write transitions).
    # Part of the signature: replay is gated on the peak still fitting the
    # current budgets — a shrunk budget re-records a spill-aware plan
    # instead of silently blowing the device's memory.
    device_mem: Tuple[Tuple[int, int], ...] = ()
    # Set by the plan-time optimizer (planopt.py): ``optimized`` marks a
    # rewritten plan; ``mem_scheduled`` means the plan carries its own
    # Belady evict/reload schedule, so replay honors it instead of the
    # reactive per-element LRU reserve.  Neither is part of the structural
    # signature — an optimized plan *replaces* its greedy original in the
    # cache rather than coexisting with it.
    optimized: bool = False
    mem_scheduled: bool = False

    @property
    def signature(self) -> "_PlanSignature":
        # Memoized: hashed once at first use (finalization stores the plan,
        # which probes the cache), O(1) on every later probe.  The plan is
        # immutable, so the cached value can never go stale; optimize/retag
        # build a *new* plan object with its own signature.
        sig = self.__dict__.get("_signature")
        if sig is None:
            sig = _PlanSignature((self.elements, self.slots, self.device_mem))
            object.__setattr__(self, "_signature", sig)
        return sig

    @property
    def num_kernels(self) -> int:
        return len(self.kernel_positions)

    def optimize(self, sched) -> "ExecutionPlan":
        """Run the plan-time global optimizer on this plan (see
        :func:`repro.core.planopt.optimize_plan`); returns the rewritten
        plan, or ``self`` when no strict improvement is possible.  Does not
        touch the scheduler's plan cache — use
        :meth:`GrScheduler.optimize_plan` for cached plans."""
        from .planopt import optimize_plan
        return optimize_plan(sched, self)

    def __len__(self) -> int:
        return len(self.elements)


# ======================================================================
# Plan cache
# ======================================================================

class PlanCache:
    """Plans keyed by name + structural signature, with LRU-bounded storage
    per name and explicit invalidation when a traced episode diverges."""

    def __init__(self, max_plans_per_name: int = 8) -> None:
        self.max_plans_per_name = max_plans_per_name
        self._plans: Dict[str, "OrderedDict[Tuple, ExecutionPlan]"] = {}
        self.records = 0
        self.replacements = 0
        self.hits = 0
        self.invalidations = 0

    def candidates(self, name: str) -> List[ExecutionPlan]:
        return list(self._plans.get(name, {}).values())

    def all_plans(self) -> List[ExecutionPlan]:
        """Every cached plan across all names (verifier/introspection)."""
        return [p for by_sig in self._plans.values()
                for p in by_sig.values()]

    def store(self, plan: ExecutionPlan) -> List[ExecutionPlan]:
        """Cache ``plan``; returns the plans displaced by it (same signature
        or LRU overflow) so the caller can release their lane reservations.

        ``records`` counts net-new signatures only; a same-signature
        replacement displaces the previous plan and counts under
        ``replacements`` instead (it used to inflate ``records``, hiding
        record/replace churn from the stats)."""
        displaced: List[ExecutionPlan] = []
        by_sig = self._plans.setdefault(plan.name, OrderedDict())
        prev = by_sig.pop(plan.signature, None)
        if prev is not None:
            displaced.append(prev)
            self.replacements += 1
        else:
            self.records += 1
        by_sig[plan.signature] = plan
        while len(by_sig) > self.max_plans_per_name:
            displaced.append(by_sig.popitem(last=False)[1])
        return displaced

    def invalidate(self, plan: ExecutionPlan) -> None:
        by_sig = self._plans.get(plan.name)
        if by_sig is not None and by_sig.pop(plan.signature, None) is not None:
            self.invalidations += 1

    def touch(self, plan: ExecutionPlan) -> None:
        """Refresh a plan's recency on a replay hit, so LRU eviction drops
        cold signatures rather than the hot, constantly-replayed one."""
        by_sig = self._plans.get(plan.name)
        if by_sig is not None and plan.signature in by_sig:
            by_sig.move_to_end(plan.signature)

    def __len__(self) -> int:
        return sum(len(v) for v in self._plans.values())

    def stats(self) -> dict:
        return {"plans_cached": len(self),
                "plan_records": self.records,
                "plan_replacements": self.replacements,
                "plan_replays": self.hits,
                "plan_invalidations": self.invalidations}


# ======================================================================
# Recording
# ======================================================================

@dataclass
class _Draft:
    """Mutable per-element record collected while the episode runs eagerly."""

    index: int
    kind: ElementKind
    name: str
    config: Tuple[Tuple[str, Any], ...]
    cost_s: float
    transfer_bytes: int
    arg_slots: Tuple[Tuple[int, AccessMode], ...]
    device: int
    src_device: Optional[int]
    parents: Tuple[int, ...]
    fn: Optional[Callable] = None
    raw_config: dict = field(default_factory=dict)
    priority: int = 0
    tenant: str = DEFAULT_TENANT
    deadline_s: Optional[float] = None
    fn_key: Optional[int] = None
    pinned: bool = False


def _assign_plan_lanes(drafts: Sequence[_Draft]):
    """Structural lane assignment for the finalized plan.

    Re-runs the paper's §IV-C rules with *nothing assumed complete* (the
    zero-overhead oracle regime): the most expensive parent sitting at its
    lane's tail on the same device is inherited, every other element opens a
    fresh plan-local lane, and each cross-lane parent costs one event.  The
    eager episode's actual lane choices are deliberately discarded — they
    encode host pacing (a slow host drains every lane between launches),
    which would serialize the replayed episode."""
    lane_of: Dict[int, int] = {}
    tails: Dict[int, int] = {}
    lane_dev: List[int] = []
    placed = []
    for d in drafts:
        lane = None
        for p in sorted(d.parents, key=lambda j: -drafts[j].cost_s):
            pl = lane_of[p]
            if tails[pl] == p and lane_dev[pl] == d.device:
                lane = pl
                break
        if lane is None:
            lane = len(lane_dev)
            lane_dev.append(d.device)
        events = tuple(p for p in d.parents if lane_of.get(p) != lane)
        lane_of[d.index] = lane
        tails[lane] = d.index
        placed.append((lane, events))
    return placed, tuple(enumerate(lane_dev))


def _plan_device_mem(drafts: Sequence[_Draft], slots: Sequence[SlotSpec]
                     ) -> Tuple[Tuple[int, int], ...]:
    """Per-device peak resident bytes of one replay of the trace.

    Replays the logical residency transitions structurally: slots captured
    device-resident start on their device; TRANSFER/D2D place a slot on the
    element's device, EVICT drops it, and a kernel's writable slots
    materialize on its device.  The running per-device byte sums' maxima
    are the plan's memory demand — what replay gating checks against the
    current budgets."""
    loc: Dict[int, int] = {}            # slot -> device currently holding it
    cur: Dict[int, int] = {}            # device -> resident bytes
    peak: Dict[int, int] = {}

    def move(slot: int, dev: Optional[int]) -> None:
        nb = slots[slot].nbytes
        if nb <= 0:
            return
        old = loc.pop(slot, None)
        if old is not None:
            cur[old] -= nb
        if dev is not None:
            loc[slot] = dev
            cur[dev] = cur.get(dev, 0) + nb
            peak[dev] = max(peak.get(dev, 0), cur[dev])

    for s in slots:
        if s.device_valid:
            move(s.index, s.device_id if s.device_id is not None else 0)
    for d in drafts:
        if d.kind in (ElementKind.TRANSFER, ElementKind.D2D,
                      ElementKind.RELOAD):
            move(d.arg_slots[0][0], d.device)
        elif d.kind is ElementKind.EVICT:
            # A peer-tier spill keeps the block device-resident on the spill
            # target (its budget is gated too); other evictions drop it.
            move(d.arg_slots[0][0], d.raw_config.get("spill_target"))
        else:
            for slot, mode in d.arg_slots:
                if mode.writes:
                    move(slot, d.device)
    return tuple(sorted((dv, pk) for dv, pk in peak.items() if pk > 0))


class _Recorder:
    def __init__(self) -> None:
        self.slots: List[SlotSpec] = []
        self.slot_arrays: List[Any] = []
        self._slot_of: Dict[int, int] = {}
        self.drafts: List[_Draft] = []
        self._idx_of_uid: Dict[int, int] = {}
        # Set when a host access retired part of the trace: any *further*
        # launch would record with the retired RAW/WAR edges missing (the
        # retire cleared them before inference), producing a racy plan.
        self.blocked = False

    def traced(self, e: ComputationalElement) -> bool:
        return e.uid in self._idx_of_uid

    def knows(self, array: Any) -> bool:
        """Whether ``array`` is already a slot of this recording."""
        return dep_key(array) in self._slot_of

    def _slot_for(self, array: Any) -> int:
        k = dep_key(array)
        s = self._slot_of.get(k)
        if s is None:
            s = len(self.slots)
            self._slot_of[k] = s
            self.slots.append(_slot_spec(s, array))
            self.slot_arrays.append(array)
        return s

    def seed_from_replay(self, r: "_ReplayState") -> None:
        """Adopt an already-submitted replay prefix as the head of a new
        trace (mid-episode divergence): the prefix matched its old plan, so
        its fresh elements become drafts verbatim and the bound arrays keep
        their capture-time slot specs (their *current* location bits have
        already advanced past episode start)."""
        plan = r.plan
        for slot_idx in sorted({s for pe in plan.elements[:r.flushed]
                                for s, _ in pe.arg_slots}):
            arr = r.bound[slot_idx]
            spec = plan.slots[slot_idx]
            new_idx = len(self.slots)
            self._slot_of[dep_key(arr)] = new_idx
            self.slots.append(SlotSpec(
                index=new_idx, name=spec.name, shape=spec.shape,
                dtype=spec.dtype, nbytes=spec.nbytes,
                host_valid=spec.host_valid, device_valid=spec.device_valid,
                device_id=spec.device_id, tier=spec.tier))
            self.slot_arrays.append(arr)
        for ce in r.new_elements:
            self.record(ce)

    def record(self, e: ComputationalElement) -> None:
        """Trace one scheduled element (called from ``GrScheduler._schedule``
        after DAG insertion, before the scheduler flips location bits)."""
        arg_slots = tuple((self._slot_for(a.array), a.mode) for a in e.args)
        parents = tuple(self._idx_of_uid[p.uid] for p in e.parents
                        if p.uid in self._idx_of_uid)
        idx = len(self.drafts)
        self._idx_of_uid[e.uid] = idx
        self.drafts.append(_Draft(
            index=idx, kind=e.kind, name=e.name,
            config=freeze_config(e.config),
            cost_s=e.cost_s, transfer_bytes=e.transfer_bytes,
            arg_slots=arg_slots,
            device=e.device if e.device is not None else 0,
            src_device=e.src_device, parents=parents, fn=e.fn,
            raw_config=dict(e.config),
            priority=e.priority, tenant=e.tenant,
            deadline_s=e.deadline_s, fn_key=e.fn_key,
            pinned=bool(getattr(e, "device_pinned", False))))

    def build(self, name: str) -> Optional[ExecutionPlan]:
        if not any(d.kind is ElementKind.KERNEL for d in self.drafts):
            return None
        placed, lane_devices = _assign_plan_lanes(self.drafts)
        elements = tuple(PlanElement(
            index=d.index, kind=d.kind, name=d.name, config=d.config,
            cost_s=d.cost_s, transfer_bytes=d.transfer_bytes,
            arg_slots=d.arg_slots, lane=lane, device=d.device,
            src_device=d.src_device, parents=d.parents, wait_events=events,
            priority=d.priority, tenant=d.tenant, deadline_s=d.deadline_s,
            fn_key=d.fn_key, pinned=d.pinned)
            for d, (lane, events) in zip(self.drafts, placed))
        return ExecutionPlan(
            name=name, key=f"{name}#{next(_PLAN_IDS)}",
            elements=elements, slots=tuple(self.slots),
            fns=tuple(d.fn for d in self.drafts),
            configs=tuple(d.raw_config for d in self.drafts),
            slot_arrays=tuple(weakref.ref(a) for a in self.slot_arrays),
            lane_devices=lane_devices,
            kernel_positions=tuple(i for i, d in enumerate(self.drafts)
                                   if d.kind is ElementKind.KERNEL),
            device_mem=_plan_device_mem(self.drafts, self.slots))


# ======================================================================
# Replay
# ======================================================================

class _ReplayState:
    """Bookkeeping for one in-flight replay of a plan."""

    def __init__(self, sched, plan: ExecutionPlan) -> None:
        self.plan = plan
        self.bound: List[Any] = [None] * len(plan.slots)
        self.bound_keys: Dict[int, int] = {}   # dep_key(array) -> slot
        self.new_elements: List[ComputationalElement] = []
        self.flushed = 0                       # next plan index to submit
        self.kpos = 0                          # next kernel to match
        self.written: set = set()              # slots written in-session
        self.started = False
        self.lanes = sched.streams.reserve(plan.key, plan.lane_devices,
                                           sched.executor.is_done)
        # The plan's captured default arrays (persistent weights etc.) are
        # pinned against replay-time eviction even before the episode binds
        # them: evicting one would flip its location bits and guarantee a
        # state mismatch — and hence divergence — at its first use, so a
        # replay under sustained pressure would never stick.
        self.pinned: set = {dep_key(a) for ref in plan.slot_arrays
                            if (a := ref()) is not None}

    @property
    def completed(self) -> bool:
        return self.flushed == len(self.plan.elements)


def _match_kernel(plan: ExecutionPlan, kpos: int, bound: List[Any],
                  bound_keys: Dict[int, int], args: Sequence[Arg],
                  name: str, cfg_items: Tuple, cost_s: float,
                  priority: int = 0, tenant: str = DEFAULT_TENANT,
                  device: Optional[int] = None,
                  fn_key: Optional[int] = None,
                  deadline_s: Optional[float] = None
                  ) -> Optional[Dict[int, Any]]:
    """Check one user launch against the plan's next kernel.  Returns the
    new slot bindings on a match, None on any mismatch."""
    pe = plan.elements[plan.kernel_positions[kpos]]
    if pe.name != name or pe.config != cfg_items or pe.cost_s != cost_s:
        return None
    if pe.priority != priority or pe.tenant != tenant:
        return None     # QoS retag: record a fresh plan with the new weights
    if pe.deadline_s != deadline_s:
        return None     # deadline retag: EDF rank/preemption eligibility
        #                 differ — record a fresh plan
    if pe.fn_key != fn_key:
        return None     # a different declared GrFunction (or legacy launch)
    if device is not None and pe.device != device:
        return None     # explicit device retarget: the recorded placement,
        #                 lanes and D2D structure would all be wrong
    if len(args) != len(pe.arg_slots):
        return None
    new_bind: Dict[int, Any] = {}
    new_keys: Dict[int, int] = {}
    for a, (slot, mode) in zip(args, pe.arg_slots):
        if a.mode is not mode:
            return None
        k = dep_key(a.array)
        cur = bound_keys.get(k, new_keys.get(k))
        if cur is not None:                 # array already bound to a slot
            if cur != slot:
                return None                 # aliasing the capture didn't have
            continue
        if bound[slot] is not None:
            if dep_key(bound[slot]) != k:
                return None                 # slot already holds another array
            continue
        if slot in new_bind:
            return None                     # two arrays for one slot
        spec = plan.slots[slot]
        if not spec.geometry_matches(a.array) or not spec.state_matches(a.array):
            return None
        new_bind[slot] = a.array
        new_keys[k] = slot
    return new_bind


def _apply_location_bits(sched, pe: PlanElement, bound: List[Any]) -> None:
    """Logical data-location updates at schedule time — the same
    MemoryManager transitions the eager pipeline performs, so a replayed
    (or capture-demoted) episode keeps location bits and resident-set
    accounting in lockstep with the eager path."""
    mem = sched.memory
    if pe.kind is ElementKind.TRANSFER:
        mem.note_h2d(bound[pe.arg_slots[0][0]], pe.device)
    elif pe.kind is ElementKind.D2D:
        mem.note_d2d(bound[pe.arg_slots[0][0]], pe.device)
    elif pe.kind is ElementKind.EVICT:
        # Plan-carried evictions are *scheduled* (part of the captured —
        # possibly Belady-rewritten — memory schedule), not reactive.
        cfg = dict(pe.config)
        tier = mem.tier_named(cfg["tier"]) if cfg.get("tier") else None
        if tier is not None:
            mem.note_spill(bound[pe.arg_slots[0][0]], tier,
                           cfg.get("spill_target"), pe.transfer_bytes,
                           scheduled=True)
        else:
            mem.note_evict(bound[pe.arg_slots[0][0]], scheduled=True)
    elif pe.kind is ElementKind.RELOAD:
        mem.note_reload(bound[pe.arg_slots[0][0]], pe.device)
    else:
        for slot, mode in pe.arg_slots:
            if mode.writes:
                mem.note_device_write(bound[slot], pe.device)


def _flush_range(sched, r: _ReplayState, hi_inclusive: int,
                 kernel_fn: Optional[Callable] = None,
                 use_plan_fns: bool = False) -> ComputationalElement:
    """Materialize and batch-submit plan elements ``r.flushed .. hi``.

    Fresh ``ComputationalElement``s are created with slot-bound arrays and
    pre-resolved parents; the DAG adopts them without inference, the
    pre-reserved lanes receive them without assignment, and the executor
    gets one batch with pre-materialized event lists.  Only the *first* use
    of each slot consults the live frontier (entry dependencies) so that
    replays chain correctly behind earlier eager/replayed work touching the
    same arrays."""
    plan = r.plan
    bounded = sched.memory.bounded
    if not r.started:
        # The whole episode costs one reduced plan-launch overhead
        # (cudaGraphLaunch analogue) instead of one overhead per element.
        sched.executor.host_overhead(sched.plan_launch_overhead_s)
        r.started = True
        if bounded and plan.mem_scheduled:
            # The plan carries its own Belady evict/reload schedule: make
            # room for its recorded per-device peak once, up front (stale
            # foreign leftovers are the only possible victims), then let
            # the plan's own EVICT elements manage its working set.
            sched.pipeline.reserve_plan(
                plan, extra_pinned=r.pinned.union(r.bound_keys))
    is_done = sched.executor.is_done
    items = []
    for idx in range(r.flushed, hi_inclusive + 1):
        pe = plan.elements[idx]
        if pe.kind is ElementKind.KERNEL:
            fn = plan.fns[idx] if use_plan_fns else kernel_fn
        else:
            fn = plan.fns[idx]
        args = tuple(Arg(r.bound[s], m) for s, m in pe.arg_slots)
        ce = ComputationalElement(
            fn=fn, args=args, kind=pe.kind, name=pe.name,
            config=dict(plan.configs[idx]), cost_s=pe.cost_s,
            transfer_bytes=pe.transfer_bytes,
            priority=pe.priority, tenant=pe.tenant,
            deadline_s=pe.deadline_s, fn_key=pe.fn_key)
        # Re-stamp the absolute deadline at *replay* submission time (the
        # capture-time deadline_t would be long expired) and register with
        # the monitor for EDF/risk tracking.
        sched.deadlines.tag(ce)
        ce.device = pe.device
        ce.src_device = pe.src_device
        ce.device_pinned = pe.pinned    # survives a seed_from_replay re-trace
        if pe.kind in (ElementKind.EVICT, ElementKind.RELOAD):
            # Re-resolve the tier by name against the *current* stack: the
            # plan records only the tier name (part of the frozen config),
            # never the runtime object.
            tname = plan.configs[idx].get("tier")
            if tname:
                ce.tier = sched.memory.tier_named(tname)
        if bounded and not plan.mem_scheduled \
                and pe.kind is not ElementKind.EVICT:
            # Replays reserve dynamically too: plan gating guarantees the
            # plan's *own* peak fits the budget, but stale foreign arrays
            # (earlier episodes' leftovers) may still hold bytes — evict
            # those eagerly, never an array the plan has bound (or will
            # bind by default).  The synthesized evicts bypass the replay
            # lanes entirely.  (Belady-scheduled plans did this once, up
            # front, in reserve_plan — their element order *is* the
            # schedule, so the reactive reserve must not interleave.)
            sched.pipeline.reserve(
                ce, extra_pinned=r.pinned.union(r.bound_keys))
        parents = [r.new_elements[p] for p in pe.parents]
        seen = {p.uid for p in parents}
        entry: List[ComputationalElement] = []
        for s, m in pe.arg_slots:
            if s in r.written:
                continue    # session already owns this slot's frontier
            for d in sched.dag.live_deps(dep_key(r.bound[s]), writes=m.writes):
                if d.uid not in seen and d is not ce and not d.is_host:
                    seen.add(d.uid)
                    entry.append(d)
        ce.parents = parents + entry
        sched.dag.adopt(ce)
        for s, m in pe.arg_slots:
            if m.writes:
                r.written.add(s)
        lane = r.lanes[pe.lane]
        sched.streams.bind_to_lane(lane, ce)
        events = [r.new_elements[w] for w in pe.wait_events
                  if not is_done(r.new_elements[w])]
        events += [d for d in entry if not is_done(d)]
        items.append((ce, lane.lane_id, events))
        r.new_elements.append(ce)
        sched._elements.append(ce)
        if pe.kind is ElementKind.D2D:
            sched.d2d_transfers += 1
        _apply_location_bits(sched, pe, r.bound)
    sched.executor.submit_batch(items)
    if items and items[-1][0].deadline_t is not None:
        # Deadline'd replay flush: run the submission-time risk check once
        # per batch (the caller holds the pipeline lock on this path).
        sched.deadlines.on_submit(items[-1][0])
    r.flushed = hi_inclusive + 1
    return r.new_elements[hi_inclusive]


def replay_plan(sched, plan: ExecutionPlan,
                bindings: Optional[Mapping] = None
                ) -> List[ComputationalElement]:
    """Explicit whole-plan replay (``scheduler.replay``).  ``bindings`` maps
    slot names or indices to fresh arrays; unbound slots reuse the arrays
    captured with the plan (CUDA-graph buffer-reuse semantics)."""
    r = _ReplayState(sched, plan)
    arrays = [ref() for ref in plan.slot_arrays]
    by_name = {s.name: s.index for s in plan.slots}
    for ref, arr in (bindings or {}).items():
        if isinstance(ref, int):
            if not 0 <= ref < len(arrays):
                raise ValueError(f"no slot {ref} in plan {plan.name!r}")
            idx = ref
        else:
            if ref not in by_name:
                raise ValueError(f"no slot named {ref!r} in plan {plan.name!r}; "
                                 f"slots: {sorted(by_name)}")
            idx = by_name[ref]
        spec = plan.slots[idx]
        if not spec.geometry_matches(arr):
            raise ValueError(
                f"binding for slot {spec.name!r} has shape/dtype "
                f"{getattr(arr, 'shape', None)}/{getattr(arr, 'dtype', None)}, "
                f"plan expects {spec.shape}/{spec.dtype}")
        arrays[idx] = arr
    # Location-state validation for every slot, bound or default: a recorded
    # H2D prefetch re-uploads the array's *host* copy, so replaying it over
    # an array whose newest value lives on the device would silently clobber
    # it; likewise a slot captured device-resident (no transfer recorded)
    # needs a valid device copy to read.
    transfer_slots = {pe.arg_slots[0][0] for pe in plan.elements
                      if pe.kind is ElementKind.TRANSFER}
    for spec, arr in zip(plan.slots, arrays):
        if arr is None:
            raise ValueError(
                f"slot {spec.name!r}: the captured default array has been "
                f"garbage-collected; bind a fresh array explicitly")
        if (spec.index in transfer_slots
                and not getattr(arr, "host_valid", True)
                and getattr(arr, "device_valid", False)):
            raise ValueError(
                f"slot {spec.name!r}: the plan replays a host->device "
                f"transfer but the array's host copy is stale "
                f"(host_valid=False); read it back or rebind before replay")
        if spec.tier != getattr(arr, "backing_tier", None):
            raise ValueError(
                f"slot {spec.name!r} was captured "
                f"{'in tier ' + repr(spec.tier) if spec.tier else 'untiered'}"
                f" but the bound array is "
                f"{'in tier ' + repr(arr.backing_tier) if getattr(arr, 'backing_tier', None) else 'not tier-resident'};"
                f" the recorded reload structure would read the wrong payload")
        if spec.device_valid:
            if not getattr(arr, "device_valid", False):
                raise ValueError(
                    f"slot {spec.name!r} was captured device-resident but "
                    f"the bound array has no valid device copy")
            if getattr(arr, "device_id", None) != spec.device_id:
                raise ValueError(
                    f"slot {spec.name!r} is resident on device "
                    f"{getattr(arr, 'device_id', None)}, plan expects "
                    f"device {spec.device_id} (rebind or migrate first)")
    r.bound = arrays
    for i, a in enumerate(arrays):
        k = dep_key(a)
        if k in r.bound_keys:
            # Eager execution would serialize the aliased writes (WAW/WAR);
            # a plan captured from distinct arrays has no such edges, so the
            # aliasing must be rejected (the transparent match path rejects
            # it the same way).
            raise ValueError(
                f"array {getattr(a, 'name', a)!r} is bound to both slot "
                f"{plan.slots[r.bound_keys[k]].name!r} and "
                f"{plan.slots[i].name!r}; replay bindings must be distinct")
        r.bound_keys[k] = i
    _flush_range(sched, r, len(plan.elements) - 1, use_plan_fns=True)
    sched.plan_cache.hits += 1
    sched.plan_cache.touch(plan)
    return list(r.new_elements)


# ======================================================================
# The transparent context manager
# ======================================================================

class CaptureContext:
    """``with scheduler.capture(name):`` — record on first sight, replay on
    structural match, fall back to eager on divergence.

    Modes:

    * ``match``  — a cached plan for ``name`` exists; user launches are
      matched positionally against its kernels and submitted through the
      replay fast path (intervening transfer/D2D plan elements ride along);
    * ``record`` — no (matching) plan; the episode runs eagerly while
      ``_schedule`` traces it, and a plan is stored on clean exit;
    * ``eager``  — divergence was detected (plan invalidated) or the
      scheduler policy is serial; pure passthrough.
    """

    def __init__(self, sched, name: str) -> None:
        self.sched = sched
        self.name = name
        self.mode = "idle"
        self.recorder: Optional[_Recorder] = None
        self.replay: Optional[_ReplayState] = None
        self.candidates: List[ExecutionPlan] = []

    # -- context protocol ----------------------------------------------
    def __enter__(self) -> "CaptureContext":
        if self.sched._capture is not None:
            raise RuntimeError("capture contexts cannot nest")
        self.sched._capture = self
        if self.sched.policy != "parallel":
            self.mode = "eager"
            return self
        self.candidates = self.sched.plan_cache.candidates(self.name)
        if self.sched.memory.bounded:
            # Budget gating: a plan whose recorded per-device peak no longer
            # fits the current budgets must not replay (its transfer/evict
            # structure was recorded for a roomier device).  The episode
            # falls back to eager execution — and re-records, so the next
            # episode replays a spill-aware plan under the new budget.
            self.candidates = [p for p in self.candidates
                               if self.sched.memory.plan_fits(p.device_mem)]
        if self.candidates:
            self.mode = "match"
        else:
            self.mode = "record"
            self.recorder = _Recorder()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.sched._capture = None
        if exc_type is not None:
            return False            # abandoned episode: keep cache untouched
        if self.mode == "match" and self.replay is not None:
            if self.replay.completed:
                self.sched.plan_cache.hits += 1
                self.sched.plan_cache.touch(self.replay.plan)
            else:
                # Episode ended before the plan did: structural divergence.
                # The replayed prefix *is* this shorter episode — transplant
                # it into a recording so the new shape is cached immediately.
                self._diverge(self.replay)
        if self.mode == "record" and self.recorder is not None:
            plan = self.recorder.build(self.name)
            if plan is not None:
                if getattr(self.sched, "plan_optimize", False):
                    # Plan-time global optimization (planopt.py): min-cut
                    # placement + Belady memory scheduling.  Returns the
                    # same object when no strict improvement exists, so
                    # disabled/unimprovable plans cache the greedy trace
                    # bit for bit.
                    from .planopt import optimize_plan
                    with self.sched.pipeline:
                        plan = optimize_plan(self.sched, plan)
                if getattr(self.sched, "sanitize", False):
                    # Sanitize mode: never cache a plan that fails the
                    # happens-before/liveness verifier.
                    from ..analysis.verifier import (PlanVerificationError,
                                                     verify_plan)
                    violations = verify_plan(plan)
                    if violations:
                        raise PlanVerificationError(plan.name, violations)
                for displaced in self.sched.plan_cache.store(plan):
                    self.sched.streams.unreserve(displaced.key)
        return False

    def _drop(self, plan: ExecutionPlan) -> None:
        """Invalidate a diverged plan and free its reserved lane sets."""
        self.sched.plan_cache.invalidate(plan)
        self.sched.streams.unreserve(plan.key)

    def _diverge(self, r: _ReplayState) -> None:
        """Mid-episode divergence: the already-replayed prefix matched (and
        therefore executed correctly).  Drop the stale plan and transplant
        the prefix into a fresh recording, so the *new* episode shape gets
        cached without waiting for another full eager episode.  (Distinct
        episode shapes are still best given distinct capture names —
        alternating shapes under one name re-record every switch.)"""
        self._drop(r.plan)
        self.recorder = _Recorder()
        self.recorder.seed_from_replay(r)
        self.replay = None
        self.mode = "record"

    def note_host_write(self, ma: Any) -> None:
        """A host write to a plan-bound array mid-replay changes its logical
        location behind the plan's back (the eager path would insert a fresh
        prefetch the plan does not contain).  Demote the rest of the episode
        to eager execution; the plan stays cached — episodes without the
        mid-episode write keep replaying."""
        if self.mode != "match" or self.replay is None:
            return
        if dep_key(ma) in self.replay.bound_keys:
            self.replay = None
            self.mode = "eager"

    # -- scheduler hooks -----------------------------------------------
    @property
    def recording(self) -> bool:
        return self.mode == "record"

    def trace(self, e: ComputationalElement) -> None:
        """Trace one eagerly-scheduled element (record mode only)."""
        if self.mode != "record" or self.recorder is None:
            return
        if self.recorder.blocked:
            # A host sync retired part of the trace before this launch; its
            # inferred parents are missing the retired edges, so a plan
            # containing it would replay without them (a data race when the
            # episode is later re-issued without the host access).  Abandon
            # the recording; the episode itself stays correct and eager.
            self.recorder = None
            self.mode = "eager"
            return
        if (e.kind is ElementKind.EVICT
                and not self.recorder.knows(e.args[0].array)):
            # Budget eviction of an array *foreign* to this episode (a
            # previous episode's leftover): purely environment-dependent —
            # baking it into the plan would tie the plan's slots (and its
            # replayability) to whatever happened to be resident this time.
            # Episode-local evictions (the victim is already a slot) stay
            # in the trace: they manage the plan's own working set.
            return
        self.recorder.record(e)

    def note_host_sync(self, deps: Optional[Sequence] = None) -> None:
        """Called when a host access synchronizes (and retires) in-flight
        work: ``deps`` are the waited elements, None means a full barrier.
        Recording stays valid only while no *traced* element is retired
        before further launches (trailing reads/syncs are harmless)."""
        if self.mode != "record" or self.recorder is None:
            return
        if not self.recorder.drafts:
            return
        if deps is None or any(self.recorder.traced(p) for p in deps):
            self.recorder.blocked = True

    def offer(self, fn: Optional[Callable], args: Sequence[Arg], name: str,
              config: dict, cost_s: float, priority: int = 0,
              tenant: str = DEFAULT_TENANT, device: Optional[int] = None,
              fn_key: Optional[int] = None,
              deadline_s: Optional[float] = None
              ) -> Optional[ComputationalElement]:
        """Called by ``GrScheduler._launch`` before the eager path.  Returns
        the replayed element on a plan hit, or None to fall through (the
        eager path then records when in record mode)."""
        if self.mode != "match":
            return None
        cfg_items = freeze_config(config)
        r = self.replay
        if r is None:
            # Candidate selection happens at the first kernel: the cache may
            # hold several signatures under one name (e.g. batch shapes).
            for plan in self.candidates:
                bind = _match_kernel(plan, 0, [None] * len(plan.slots), {},
                                     args, name, cfg_items, cost_s,
                                     priority, tenant, device, fn_key,
                                     deadline_s)
                if bind is not None:
                    self.replay = r = _ReplayState(self.sched, plan)
                    return self._commit(r, bind, fn)
            # No plan starts with this launch: trace a new episode instead.
            self.mode = "record"
            self.recorder = _Recorder()
            return None
        if r.kpos >= r.plan.num_kernels:
            bind = None             # plan exhausted but episode continues
        else:
            bind = _match_kernel(r.plan, r.kpos, r.bound, r.bound_keys,
                                 args, name, cfg_items, cost_s,
                                 priority, tenant, device, fn_key,
                                 deadline_s)
        if bind is None:
            # Divergence: drop the stale plan, transplant the replayed
            # prefix into a recording, and let the eager path trace the
            # rest of this (new-shape) episode.
            self._diverge(r)
            return None
        return self._commit(r, bind, fn)

    def _commit(self, r: _ReplayState, bind: Dict[int, Any],
                fn: Optional[Callable]) -> ComputationalElement:
        for slot, arr in bind.items():
            r.bound[slot] = arr
            r.bound_keys[dep_key(arr)] = slot
        j = r.plan.kernel_positions[r.kpos]
        r.kpos += 1
        # The matched launch's *current* callable is used (closures are
        # routinely re-created per episode); only the schedule is reused.
        return _flush_range(self.sched, r, j, kernel_fn=fn)
