"""Happens-before verification of live DAGs and captured execution plans.

Two conflicting accesses to the same array (same ``dep_key``/slot, at
least one write) must be *ordered*: RAW, WAR and WAW pairs all need a path
in the transitive closure of the ordering edges.  What counts as an
ordering edge differs by artifact:

* **Captured plans** replay through lane FIFOs plus recorded cross-lane
  ``wait_events`` — so the execution closure is lane-order ∪ wait_events,
  and the recorded ``parents`` are *claims* checked against that closure
  (a parent not enforced by lane order or an event is a lane/event
  inconsistency even before it loses a race).
* **Live DAGs** are ordered by the inferred parent edges themselves
  (that is precisely what the verifier audits: a dropped edge on a
  conflicting pair is a race even if today's lane assignment happens to
  serialize it), plus host-access barriers: a host read/write blocks the
  submitting thread until its frontier completes, so it orders before
  everything submitted after it returned.

Plans additionally get an evict/reload liveness check: after an EVICT of
a slot, no kernel may read that slot until a TRANSFER/RELOAD/D2D places
it back (a pure ``out`` write also re-materializes it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.element import (AccessMode, ComputationalElement, ElementKind)

_COMPUTE_KINDS = (ElementKind.KERNEL, ElementKind.LIBRARY)
_PLACING_KINDS = (ElementKind.TRANSFER, ElementKind.RELOAD, ElementKind.D2D)


@dataclass(frozen=True)
class Violation:
    """One verified ordering/consistency defect."""

    kind: str        # "race" | "parent-order" | "liveness" | "structure"
    message: str
    elements: Tuple[int, ...] = ()   # uids (live) or plan indices

    def __str__(self) -> str:
        return f"[{self.kind}] {self.message}"


class PlanVerificationError(RuntimeError):
    """Raised (under ``sanitize=True``) when a plan fails verification."""

    def __init__(self, name: str, violations: Sequence[Violation]) -> None:
        self.violations = list(violations)
        lines = "\n  ".join(str(v) for v in self.violations)
        super().__init__(
            f"plan {name!r} failed verification "
            f"({len(self.violations)} violation(s)):\n  {lines}")


def _race_kind(m1: AccessMode, m2: AccessMode) -> str:
    if m1.writes and m2.writes:
        return "WAW"
    return "RAW" if m1.writes else "WAR"


# ======================================================================
# Captured plans
# ======================================================================

def verify_plan(plan) -> List[Violation]:
    """Check one :class:`ExecutionPlan` (greedy-recorded or
    planopt-rewritten) for unordered conflicts, lane/event inconsistency
    and evict/reload liveness.  Returns violations; empty list = green."""
    out: List[Violation] = []
    elements = list(plan.elements)
    n = len(elements)
    lane_dev: Dict[int, Optional[int]] = dict(plan.lane_devices)

    # -- structure: indices must be 0..n-1 in topological (record) order.
    for pos, pe in enumerate(elements):
        if pe.index != pos:
            out.append(Violation(
                "structure",
                f"element #{pos} carries index {pe.index}", (pos,)))
            return out      # positional reasoning is unsound beyond this

    # -- execution happens-before closure: lane FIFO ∪ wait_events.
    hb = [0] * n
    last_on_lane: Dict[int, int] = {}
    for i, pe in enumerate(elements):
        preds = list(pe.wait_events)
        if pe.lane in last_on_lane:
            preds.append(last_on_lane[pe.lane])
        mask = 0
        for p in preds:
            if not 0 <= p < i:
                out.append(Violation(
                    "structure",
                    f"{pe.name}#{i} waits on non-preceding index {p}",
                    (i,)))
                continue
            mask |= hb[p] | (1 << p)
        hb[i] = mask
        last_on_lane[pe.lane] = i

        # -- recorded parents must be enforced by lane order or events.
        for p in pe.parents:
            if not 0 <= p < i or not (mask >> p) & 1:
                pname = elements[p].name if 0 <= p < n else "?"
                out.append(Violation(
                    "parent-order",
                    f"{pe.name}#{i} declares parent {pname}#{p} but no "
                    f"lane-FIFO/event path enforces it at replay",
                    (p, i)))

        # -- lane/device consistency.
        expect = lane_dev.get(pe.lane)
        if (pe.device is not None and expect is not None
                and pe.device != expect):
            out.append(Violation(
                "structure",
                f"{pe.name}#{i} targets device {pe.device} but lane "
                f"{pe.lane} is bound to device {expect}", (i,)))

    # -- merged per-slot access modes per element (write wins).
    def merged(pe) -> Dict[int, AccessMode]:
        acc: Dict[int, AccessMode] = {}
        for slot, mode in pe.arg_slots:
            prev = acc.get(slot)
            if prev is None or (mode.writes and not prev.writes):
                acc[slot] = mode
            elif prev.writes and mode.reads and not prev.reads:
                acc[slot] = AccessMode.INOUT
        return acc

    accesses: Dict[int, List[Tuple[int, AccessMode]]] = {}
    for i, pe in enumerate(elements):
        for slot, mode in merged(pe).items():
            accesses.setdefault(slot, []).append((i, mode))

    # -- every conflicting pair must be ordered in the execution closure.
    for slot, acc in accesses.items():
        sname = plan.slots[slot].name if slot < len(plan.slots) else slot
        for a in range(len(acc)):
            i, mi = acc[a]
            for b in range(a + 1, len(acc)):
                j, mj = acc[b]
                if not mi.conflicts_with(mj):
                    continue
                if not (hb[j] >> i) & 1:
                    out.append(Violation(
                        "race",
                        f"unordered {_race_kind(mi, mj)} on slot "
                        f"{sname!r}: {elements[i].name}#{i} "
                        f"({mi.value}) vs {elements[j].name}#{j} "
                        f"({mj.value})", (i, j)))

    # -- evict/reload liveness (plan order is record order).
    evicted: Dict[int, int] = {}            # slot -> evicting index
    for i, pe in enumerate(elements):
        slots_here = merged(pe)
        if pe.kind is ElementKind.EVICT:
            for slot in slots_here:
                evicted[slot] = i
        elif pe.kind in _PLACING_KINDS:
            for slot in slots_here:
                evicted.pop(slot, None)
        elif pe.kind in _COMPUTE_KINDS:
            for slot, mode in slots_here.items():
                if slot in evicted and mode.reads:
                    sname = (plan.slots[slot].name
                             if slot < len(plan.slots) else slot)
                    out.append(Violation(
                        "liveness",
                        f"{pe.name}#{i} reads slot {sname!r} between its "
                        f"EVICT (#{evicted[slot]}) and the next reload",
                        (evicted[slot], i)))
                elif slot in evicted and mode.writes:
                    evicted.pop(slot, None)   # pure write re-materializes
    return out


# ======================================================================
# Live DAGs
# ======================================================================

def verify_elements(elements: Sequence[ComputationalElement],
                    host_log: Sequence[Tuple[int, ComputationalElement]] = (),
                    total_order: bool = False) -> List[Violation]:
    """Check a submission-ordered element window (``sched._elements``
    since the last full sync) for conflicting pairs not covered by the
    transitive closure of the inferred parent edges.

    ``host_log`` holds ``(position, host_element)`` entries: the host
    element's frontier wait completed before ``elements[position:]`` were
    submitted, so it bridges ordering across retired elements.
    ``total_order=True`` (serial policy: every launch is host-blocking)
    declares the whole window ordered."""
    out: List[Violation] = []
    if total_order:
        return out
    n = len(elements)
    pos = {e.uid: i for i, e in enumerate(elements)}

    def closure_of(parents) -> int:
        mask = 0
        for p in parents:
            k = pos.get(p.uid)
            if k is not None:
                mask |= hb[k] | (1 << k)
        return mask

    hb = [0] * n
    hosts = sorted(((at, h) for at, h in host_log), key=lambda t: t[0])
    host_mask = 0
    hi = 0
    for i, e in enumerate(elements):
        while hi < len(hosts) and hosts[hi][0] <= i:
            host_mask |= closure_of(hosts[hi][1].parents)
            hi += 1
        hb[i] = closure_of(e.parents) | host_mask

    accesses: Dict[object, List[Tuple[int, AccessMode]]] = {}
    names: Dict[object, str] = {}
    for i, e in enumerate(elements):
        for key, mode in e.arg_modes():
            accesses.setdefault(key, []).append((i, mode))
    for e in elements:
        for a in e.args:
            names.setdefault(a.key, getattr(a.array, "name", str(a.key)))

    for key, acc in accesses.items():
        aname = names.get(key, str(key))
        for a in range(len(acc)):
            i, mi = acc[a]
            for b in range(a + 1, len(acc)):
                j, mj = acc[b]
                if not mi.conflicts_with(mj):
                    continue
                if not (hb[j] >> i) & 1:
                    out.append(Violation(
                        "race",
                        f"unordered {_race_kind(mi, mj)} on array "
                        f"{aname!r}: {elements[i].name}"
                        f"(uid {elements[i].uid}, {mi.value}) vs "
                        f"{elements[j].name}(uid {elements[j].uid}, "
                        f"{mj.value}) — no happens-before path",
                        (elements[i].uid, elements[j].uid)))
    return out


def verify_scheduler(sched, plans: bool = True) -> List[Violation]:
    """Verify a scheduler's live window, its DAG bookkeeping invariants,
    and (optionally) every cached execution plan."""
    with sched.pipeline:
        window = list(sched._elements)
        host_log = list(getattr(sched, "_host_log", ()))
        out = verify_elements(window, host_log,
                              total_order=(sched.policy == "serial"))
        out += [Violation("structure", msg)
                for msg in sched.dag.validate()]
        if plans:
            for plan in sched.plan_cache.all_plans():
                for v in verify_plan(plan):
                    out.append(Violation(
                        v.kind, f"plan {plan.name!r} ({plan.key}): "
                        f"{v.message}", v.elements))
    return out
