"""Plan-time global optimization of captured execution plans.

The paper's scheduler is deliberately greedy: each computational element is
placed and ordered as it arrives, with no knowledge of the future DAG.
Capture (capture.py) changes the information available — at plan
finalization the runtime holds the *entire* episode: every dependency,
every array's full access order, every per-device byte footprint.  This
module spends that information once per recorded plan, in two stages:

**Stage 1 — placement.**  Kernels are vertices of a graph whose edge
weights are the bytes that would cross the D2D link if the endpoints land
on different devices (consecutive accesses of one array under the
single-copy ownership model drag the array along).  A KL/FM-style min-cut
refinement (pure Python — gain-ordered moves with per-pass rollback to the
best prefix, so the search can climb out of local minima) improves the
greedy assignment subject to a load-balance cap on per-device compute and
to user pins (``with_options(device=...)`` launches never move; replay
matching would reject the retarget).  Grounded in "A Graph-Partition-Based
Scheduling Policy for Heterogeneous Architectures" (PAPERS.md).

**Stage 2 — memory.**  For budgeted replays the reactive LRU reserve is
replaced with Belady's algorithm computed from the plan's exact future
access order: victims are the blocks whose next *read* is farthest away
(dead blocks first, clean before dirty), evictions carry only the victim's
own frontier as dependencies — so the DAG lets them run as early as the
buffer goes dead — and the re-upload of a previously evicted block is
issued as a ``reload_*`` transfer whose only dependency is the eviction's
write-back, so it overlaps earlier compute instead of stalling the
consuming kernel.

The rewritten plan is re-synthesized from scratch (movement elements,
dependencies, lanes, ``device_mem``) by replaying the same state machine
the eager pipeline runs, which guarantees DAG-equivalence by construction:
every RAW/WAR/WAW ordering between original kernels is re-derived from the
same access modes.  The optimizer is strictly conservative: if the rewrite
does not *strictly* reduce total moved bytes (D2D + spill write-backs +
re-uploads), or the plan contains structures it does not model (tiered
spills, library/host elements), the original plan object is returned
untouched — ``plan_optimize=False`` and eager execution stay bit-identical
by the same token.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .capture import (ExecutionPlan, PlanElement, _PLAN_IDS, _Draft,
                      _assign_plan_lanes, _plan_device_mem, freeze_config)
from .element import AccessMode, DEFAULT_TENANT, ElementKind

# Kinds the re-synthesis state machine models.  RELOAD is deliberately
# absent: it only appears in tiered-spill plans, which the optimizer skips
# (tier choice depends on runtime stack state the plan cannot re-derive).
_MODELED_KINDS = frozenset((ElementKind.KERNEL, ElementKind.TRANSFER,
                            ElementKind.D2D, ElementKind.EVICT))

_FM_PASSES = 8
_BALANCE_TOL = 0.25     # per-device compute may exceed the mean by 25%
_INF = float("inf")


# ======================================================================
# Entry point
# ======================================================================

def optimize_plan(sched, plan: ExecutionPlan) -> ExecutionPlan:
    """Rewrite ``plan`` with globally-optimized placement and memory
    scheduling.  Returns the *same object* when the plan is out of scope
    (tiered spills, host/library elements, already optimized) or when the
    rewrite is not strictly better — callers can rely on ``is`` to detect
    a no-op."""
    if not _eligible(plan):
        return plan
    kpos = plan.kernel_positions
    kernels = [plan.elements[i] for i in kpos]
    assign = [pe.device for pe in kernels]
    moved = False
    if sched.num_devices > 1 and len(kernels) > 1:
        refined = _refine_placement(plan, kernels, sched)
        if refined is not None:
            assign = refined
            moved = True
    bounded = sched.memory.bounded
    has_evict = any(pe.kind is ElementKind.EVICT for pe in plan.elements)
    if not moved and not (bounded and has_evict):
        return plan     # nothing the rewrite could improve
    new = _resynthesize(sched, plan, kernels, assign)
    if new is None:
        return plan
    if bounded and not sched.memory.plan_fits(new.device_mem):
        return plan     # safety net: never adopt an over-budget rewrite
    if _moved_bytes(new) >= _moved_bytes(plan):
        return plan     # strictly-better or keep the greedy trace
    if getattr(sched, "sanitize", False):
        # Sanitize mode: a rewrite must pass the happens-before/liveness
        # verifier before it can replace the (already verified) greedy
        # trace — a planopt bug must never reach the replay fast path.
        from ..analysis.verifier import PlanVerificationError, verify_plan
        violations = verify_plan(new)
        if violations:
            raise PlanVerificationError(new.name, violations)
    return new


def _eligible(plan: ExecutionPlan) -> bool:
    if not plan.kernel_positions or plan.optimized:
        return False
    for pe in plan.elements:
        if pe.kind not in _MODELED_KINDS:
            return False
        if pe.kind is ElementKind.EVICT and dict(pe.config).get("tier"):
            return False        # tiered spill: stack-state dependent
    return all(spec.tier is None for spec in plan.slots)


def _moved_bytes(plan: ExecutionPlan) -> int:
    """Total bytes the plan moves over any link (H2D uploads, D2D
    migrations, spill write-backs, tier reloads) — the objective the
    optimizer must strictly reduce before its rewrite is adopted."""
    return sum(pe.transfer_bytes for pe in plan.elements
               if pe.kind in (ElementKind.TRANSFER, ElementKind.D2D,
                              ElementKind.EVICT, ElementKind.RELOAD))


# ======================================================================
# Stage 1 — min-cut placement refinement (KL/FM style)
# ======================================================================

def _refine_placement(plan: ExecutionPlan, kernels: Sequence[PlanElement],
                      sched) -> Optional[List[int]]:
    """Return an improved device assignment for ``kernels`` (kernel-order
    list), or None when the greedy assignment is already minimal."""
    ndev = sched.num_devices
    # Adjacency: for each slot, consecutive distinct accessors form an edge
    # weighted by the slot's bytes — under single-copy ownership *any*
    # consecutive pair on different devices costs one migration of the
    # array (even read->read: the copy moves, it is not replicated).  A
    # slot captured device-resident contributes a fixed "pin" edge from its
    # holding device to the first accessor; host-resident slots cost the
    # same H2D wherever the first accessor lands, so they contribute no
    # edge at all.
    adj: List[List[Tuple[object, int]]] = [[] for _ in kernels]
    chains: Dict[int, List[int]] = {}
    for pos, pe in enumerate(kernels):
        seen: Set[int] = set()
        for slot, _mode in pe.arg_slots:
            if slot in seen:
                continue
            seen.add(slot)
            chain = chains.setdefault(slot, [])
            if not chain or chain[-1] != pos:
                chain.append(pos)
    for slot, chain in chains.items():
        spec = plan.slots[slot]
        nb = spec.nbytes
        if nb <= 0:
            continue
        prev: object = None
        if spec.device_valid:
            prev = ("pin", spec.device_id if spec.device_id is not None else 0)
        for pos in chain:
            if isinstance(prev, tuple):
                adj[pos].append((prev, nb))
            elif prev is not None:
                adj[pos].append((prev, nb))
                adj[prev].append((pos, nb))
            prev = pos

    assign = [pe.device for pe in kernels]
    locked = [pe.pinned for pe in kernels]
    costs = [max(float(pe.cost_s), 0.0) for pe in kernels]
    return _fm_refine(assign, adj, costs, locked, ndev)


def _cut(assign: List[int], adj: List[List[Tuple[object, int]]]) -> int:
    total = 0
    for i, edges in enumerate(adj):
        for nbr, w in edges:
            if isinstance(nbr, tuple):
                if assign[i] != nbr[1]:
                    total += w
            elif nbr > i and assign[i] != assign[nbr]:
                total += w          # symmetric edges stored twice, count once
    return total


def _gain(i: int, target: int, assign: List[int],
          adj: List[List[Tuple[object, int]]]) -> int:
    """Cut reduction from moving kernel ``i`` to ``target``."""
    here = assign[i]
    g = 0
    for nbr, w in adj[i]:
        nd = nbr[1] if isinstance(nbr, tuple) else assign[nbr]
        if nd == here:
            g -= w              # edge becomes cut
        elif nd == target:
            g += w              # edge becomes internal
    return g


def _fm_refine(assign: List[int], adj: List[List[Tuple[object, int]]],
               costs: List[float], locked: List[bool], ndev: int
               ) -> Optional[List[int]]:
    """Fiduccia–Mattheyses-style refinement generalized to ``ndev`` parts.

    Each pass greedily applies the single best-gain feasible move (possibly
    negative — that is what lets the search traverse ridges), freezing each
    moved vertex, then rolls back to the best prefix of the move sequence.
    Passes repeat until one fails to improve.  Feasibility = the balance
    cap: a device's summed kernel cost may not exceed the mean by more than
    ``_BALANCE_TOL`` (unless the move still leaves it lighter than the
    source — rebalancing toward the mean is always allowed)."""
    n = len(assign)
    total_cost = sum(costs)
    # Standard FM balance criterion: a device may exceed the mean by the
    # tolerance *or* by one maximal cell, whichever is larger — without the
    # one-cell slack, a perfectly balanced swap (A->B then B->A) could
    # never pass through its intermediate state on equal-cost kernels.
    mean = total_cost / ndev
    cap = mean + max(max(costs) if costs else 0.0, mean * _BALANCE_TOL)
    cur = list(assign)
    cur_cut = _cut(cur, adj)
    start_cut = cur_cut
    for _ in range(_FM_PASSES):
        loads = [0.0] * ndev
        for i, d in enumerate(cur):
            loads[d] += costs[i]
        frozen = list(locked)
        history: List[Tuple[int, int, int]] = []
        pass_cut = cur_cut
        best_cut, best_len = cur_cut, 0
        while True:
            pick = None
            for i in range(n):
                if frozen[i]:
                    continue
                src = cur[i]
                for dst in range(ndev):
                    if dst == src:
                        continue
                    after = loads[dst] + costs[i]
                    if after > cap and after > loads[src]:
                        continue        # would unbalance the target
                    g = _gain(i, dst, cur, adj)
                    if pick is None or g > pick[0]:
                        pick = (g, i, dst)
            if pick is None:
                break
            g, i, dst = pick
            src = cur[i]
            cur[i] = dst
            loads[src] -= costs[i]
            loads[dst] += costs[i]
            frozen[i] = True
            pass_cut -= g
            history.append((i, src, dst))
            if pass_cut < best_cut:
                best_cut, best_len = pass_cut, len(history)
        for i, src, _dst in reversed(history[best_len:]):
            cur[i] = src            # roll back past the best prefix
        if best_cut >= cur_cut:
            break                   # the pass found nothing better
        cur_cut = best_cut
    if cur_cut < start_cut:
        return cur
    return None


# ======================================================================
# Stage 2 — re-synthesis with Belady memory scheduling
# ======================================================================

def _resynthesize(sched, plan: ExecutionPlan,
                  kernels: Sequence[PlanElement], assign: Sequence[int]
                  ) -> Optional[ExecutionPlan]:
    """Rebuild the plan for the (possibly new) device assignment.

    Walks the kernels in original order through the same state machine the
    eager pipeline runs (reserve -> upload -> migrate -> kernel), with two
    substitutions: victims are chosen by Belady's farthest-next-read rule
    instead of LRU, and re-uploads of previously evicted blocks are named
    ``reload_*`` (they carry only the eviction's write-back as a
    dependency, so batch submission starts them as early as the DAG
    allows — the prefetch-ahead overlap).  Residency accounting mirrors
    ``_plan_device_mem``'s list-order walk exactly, so the rebuilt plan's
    recorded peak is over-budget only if a single kernel's working set is
    (in which case — or on any other unmodeled structure — None is
    returned and the greedy plan stands)."""
    slots = plan.slots
    nslots = len(slots)
    ndev = sched.num_devices
    auto_upload = sched.auto_prefetch or ndev > 1
    budgets = [p.budget_bytes for p in sched.memory.pools]

    # -- dynamic slot state ------------------------------------------------
    host_valid = [s.host_valid for s in slots]
    device_valid = [s.device_valid for s in slots]
    device_id: List[Optional[int]] = [
        (s.device_id if s.device_id is not None else 0) if s.device_valid
        else None for s in slots]
    last_writer: List[Optional[int]] = [None] * nslots
    readers: List[List[int]] = [[] for _ in range(nslots)]
    evicted_once: Set[int] = set()

    resident: Dict[int, int] = {}       # slot -> device (sized slots only)
    res_bytes = [0] * ndev
    for s in slots:
        if s.device_valid and s.nbytes > 0:
            d = s.device_id if s.device_id is not None else 0
            resident[s.index] = d
            res_bytes[d] += s.nbytes

    # Belady oracle: kernel-order positions at which each slot is *read*
    # (a future write-only access needs no reload, so it must not keep a
    # victim resident).
    reads_at: List[List[int]] = [[] for _ in range(nslots)]
    for pos, pe in enumerate(kernels):
        seen: Set[int] = set()
        for slot, mode in pe.arg_slots:
            if mode.reads and slot not in seen:
                seen.add(slot)
                reads_at[slot].append(pos)

    drafts: List[_Draft] = []

    def add_draft(kind, name, arg_slots, dep_modes, device, *,
                  src_device=None, transfer_bytes=0, raw=None, config=None,
                  cost_s=0.0, fn=None, priority=0, tenant=DEFAULT_TENANT,
                  deadline_s=None, fn_key=None, pinned=False) -> None:
        raw = {} if raw is None else raw
        idx = len(drafts)
        parents: Dict[int, None] = {}   # insertion-ordered de-dup
        for slot, mode in dep_modes:
            lw = last_writer[slot]
            if lw is not None:
                parents.setdefault(lw)
            if mode.writes:
                for r in readers[slot]:
                    parents.setdefault(r)
        drafts.append(_Draft(
            index=idx, kind=kind, name=name,
            config=freeze_config(raw) if config is None else config,
            cost_s=cost_s, transfer_bytes=transfer_bytes,
            arg_slots=tuple(arg_slots), device=device, src_device=src_device,
            parents=tuple(parents), fn=fn, raw_config=raw,
            priority=priority, tenant=tenant, deadline_s=deadline_s,
            fn_key=fn_key, pinned=pinned))
        for slot, mode in dep_modes:
            if mode.writes:
                last_writer[slot] = idx
                readers[slot] = []
            else:
                readers[slot].append(idx)

    for pos, pe in enumerate(kernels):
        d = assign[pos]
        orig = plan.kernel_positions[pos]
        # Merged strongest mode per distinct slot (element.arg_modes rule).
        merged: Dict[int, AccessMode] = {}
        for slot, mode in pe.arg_slots:
            prev = merged.get(slot)
            if prev is None or (mode.writes and not prev.writes):
                merged[slot] = mode
        for slot, mode in merged.items():
            if mode.reads and not host_valid[slot] and not device_valid[slot]:
                return None     # location state the machine does not model

        # ---- Belady reserve (budgeted target device only) ----
        budget = budgets[d] if d < len(budgets) else None
        if budget is not None:
            ws = incoming = 0
            ws_slots: Set[int] = set()
            for slot in merged:
                nb = slots[slot].nbytes
                if nb <= 0:
                    continue
                ws_slots.add(slot)
                ws += nb
                if resident.get(slot) != d:
                    incoming += nb
            if ws > budget:
                return None     # single-element OOM: greedy raises too
            need = res_bytes[d] + incoming - budget
            if need > 0:
                def victim_key(s: int, pos: int = pos) -> Tuple:
                    i = bisect_right(reads_at[s], pos)
                    nxt = reads_at[s][i] if i < len(reads_at[s]) else _INF
                    dirty = device_valid[s] and not host_valid[s]
                    return (-nxt, dirty, s)     # farthest first, clean first
                cands = sorted((s for s, dev in resident.items()
                                if dev == d and s not in ws_slots),
                               key=victim_key)
                for s in cands:
                    if need <= 0:
                        break
                    nb = slots[s].nbytes
                    dirty = device_valid[s] and not host_valid[s]
                    add_draft(ElementKind.EVICT, f"evict_{slots[s].name}",
                              ((s, AccessMode.INOUT),),
                              ((s, AccessMode.INOUT),), d,
                              transfer_bytes=nb if dirty else 0,
                              raw={"writeback": dirty},
                              priority=pe.priority, tenant=pe.tenant,
                              deadline_s=pe.deadline_s)
                    host_valid[s] = True
                    device_valid[s] = False
                    device_id[s] = None
                    del resident[s]
                    res_bytes[d] -= nb
                    evicted_once.add(s)
                    need -= nb
                if need > 0:
                    return None     # nothing evictable enough

        # ---- uploads & migrations for read slots ----
        for slot, mode in merged.items():
            if not mode.reads:
                continue
            nb = slots[slot].nbytes
            if host_valid[slot] and not device_valid[slot]:
                if not auto_upload:
                    continue        # fault-driven mode reads host in place
                name = (f"reload_{slots[slot].name}"
                        if slot in evicted_once
                        else f"h2d_{slots[slot].name}")
                add_draft(ElementKind.TRANSFER, name,
                          ((slot, AccessMode.INOUT),),
                          ((slot, AccessMode.INOUT),), d,
                          transfer_bytes=nb,
                          priority=pe.priority, tenant=pe.tenant,
                          deadline_s=pe.deadline_s)
                device_valid[slot] = True
                device_id[slot] = d
                if nb > 0:
                    resident[slot] = d
                    res_bytes[d] += nb
            elif device_valid[slot] and device_id[slot] != d:
                src = device_id[slot]
                add_draft(ElementKind.D2D, f"d2d_{slots[slot].name}",
                          ((slot, AccessMode.INOUT),),
                          ((slot, AccessMode.INOUT),), d,
                          src_device=src, transfer_bytes=nb,
                          priority=pe.priority, tenant=pe.tenant,
                          deadline_s=pe.deadline_s)
                device_id[slot] = d
                if nb > 0:
                    if resident.get(slot) == src:
                        res_bytes[src] -= nb
                    resident[slot] = d
                    res_bytes[d] += nb

        # ---- the kernel itself ----
        add_draft(ElementKind.KERNEL, pe.name, pe.arg_slots, merged.items(),
                  d, transfer_bytes=pe.transfer_bytes, config=pe.config,
                  raw=plan.configs[orig], cost_s=pe.cost_s,
                  fn=plan.fns[orig], priority=pe.priority, tenant=pe.tenant,
                  deadline_s=pe.deadline_s, fn_key=pe.fn_key, pinned=pe.pinned)
        for slot, mode in merged.items():
            if not mode.writes:
                continue
            nb = slots[slot].nbytes
            was = resident.get(slot)
            host_valid[slot] = False
            device_valid[slot] = True
            device_id[slot] = d
            if nb > 0 and was != d:
                if was is not None:
                    res_bytes[was] -= nb
                resident[slot] = d
                res_bytes[d] += nb

    placed, lane_devices = _assign_plan_lanes(drafts)
    elements = tuple(PlanElement(
        index=dr.index, kind=dr.kind, name=dr.name, config=dr.config,
        cost_s=dr.cost_s, transfer_bytes=dr.transfer_bytes,
        arg_slots=dr.arg_slots, lane=lane, device=dr.device,
        src_device=dr.src_device, parents=dr.parents, wait_events=events,
        priority=dr.priority, tenant=dr.tenant, deadline_s=dr.deadline_s,
        fn_key=dr.fn_key, pinned=dr.pinned)
        for dr, (lane, events) in zip(drafts, placed))
    return ExecutionPlan(
        name=plan.name, key=f"{plan.name}#{next(_PLAN_IDS)}",
        elements=elements, slots=slots,
        fns=tuple(dr.fn for dr in drafts),
        configs=tuple(dr.raw_config for dr in drafts),
        slot_arrays=plan.slot_arrays, lane_devices=lane_devices,
        kernel_positions=tuple(i for i, dr in enumerate(drafts)
                               if dr.kind is ElementKind.KERNEL),
        device_mem=_plan_device_mem(drafts, slots),
        optimized=True, mem_scheduled=sched.memory.bounded)
