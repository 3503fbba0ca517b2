"""Per-device memory manager — budgeted placement + transparent spill/evict.

The paper's scheduler transparently inserts data transfers without advance
knowledge of the program (§IV); this module extends the same mechanism to
the *capacity* dimension: each device gets a :class:`MemoryPool` with a
configurable byte budget, the submission pipeline reserves an element's
working set before DAG insertion, and under pressure the runtime
synthesizes DAG-ordered ``EVICT`` transfer elements (async D2H + drop of
the device copy) for least-recently-used victims — out-of-core working
sets then run unmodified, they just spill.

Two design rules keep this sound:

* **Logical residency is flipped at schedule time**, exactly like the
  location bits on :class:`~repro.core.managed.ManagedArray` (see the NOTE
  in managed.py): the scheduling thread knows what each scheduled element
  will produce, and worker threads only install physical values.
* **This manager is the single source of truth for location-bit
  transitions.**  Every path that used to flip ``host_valid`` /
  ``device_valid`` / ``device_id`` by hand (eager prefetch, D2D migration,
  kernel-output updates, capture replay, host overwrites) now goes through
  one ``note_*`` method that updates the bits *and* the resident-set
  accounting atomically — the two can no longer diverge, whichever path
  (eager, replayed, or capture-demoted) scheduled the element.

Budgets are opt-in: ``memory_budget=None`` (the default) tracks residency
for stats but never evicts, refuses no placements, and inserts no
elements — the pre-budget behaviour, bit for bit.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, Union)

from .element import dep_key
from .tiers import BackingTier, make_tiers

Budget = Union[None, int, Mapping[int, Optional[int]]]


class DeviceOutOfMemoryError(RuntimeError):
    """An element's working set cannot fit any device's byte budget (even
    after evicting everything else) — the workload is not merely
    out-of-core, a *single* computational element is over-budget."""


class DriftReport:
    """Structured logical-vs-physical residency reconciliation.

    ``problems`` are the ledger inconsistencies; ``logical`` is the
    per-device byte count the pools account against their budgets;
    ``physical`` (when the check ran with ``physical=True``) is the
    per-device byte count of actually-installed device values."""

    def __init__(self, problems: List[str], logical: Dict[int, int],
                 physical: Optional[Dict[int, int]] = None) -> None:
        self.problems = list(problems)
        self.logical = dict(logical)
        self.physical = dict(physical) if physical is not None else None

    @property
    def ok(self) -> bool:
        return not self.problems

    def to_json(self) -> dict:
        return {"ok": self.ok, "problems": list(self.problems),
                "logical_bytes": dict(self.logical),
                "physical_bytes": (dict(self.physical)
                                   if self.physical is not None else None)}

    def __str__(self) -> str:
        if self.ok:
            return "memory ledger consistent"
        lines = [f"{len(self.problems)} memory-ledger problem(s):"]
        lines += [f"  - {p}" for p in self.problems]
        lines.append(f"  logical bytes/device: {self.logical}")
        if self.physical is not None:
            lines.append(f"  physical bytes/device: {self.physical}")
        return "\n".join(lines)


class MemoryDriftError(RuntimeError):
    """Raised by :meth:`MemoryManager.verify` when the logical ledger and
    the tracked array/tier state disagree.  Carries the full
    :class:`DriftReport` for the daemon's drift alarm path."""

    def __init__(self, report: DriftReport) -> None:
        self.report = report
        super().__init__(str(report))


class MemoryPool:
    """Resident-set tracker for one device: byte budget, LRU ordering and
    spill statistics.

    ``budget_bytes=None`` means unlimited (tracking only).  Stats:

    * ``resident_bytes`` — bytes currently (logically) resident;
    * ``peak_bytes``     — high-water mark of ``resident_bytes``;
    * ``spills``         — dirty evictions (device copy newer than host →
      an async D2H write-back was scheduled);
    * ``spill_bytes``    — bytes moved by those write-backs;
    * ``evict_blocks``   — arrays evicted in total (dirty + clean drops);
    * ``reloads``/``reload_bytes`` — re-uploads of previously evicted
      blocks (the *return* traffic spilling causes; reported separately
      from ``spill_bytes`` so eviction-policy quality is visible: a policy
      that spills dead blocks moves the same spill bytes but reloads none).
    """

    def __init__(self, device_id: int,
                 budget_bytes: Optional[int] = None) -> None:
        self.device_id = device_id
        self.budget_bytes = budget_bytes
        self.resident_bytes = 0
        self.peak_bytes = 0
        self.spills = 0
        self.spill_bytes = 0
        self.evict_blocks = 0
        self.reloads = 0
        self.reload_bytes = 0
        # key -> nbytes, insertion order == LRU order (oldest first); touch
        # moves a key to the MRU end.
        self._resident: "OrderedDict[int, int]" = OrderedDict()

    # -- residency -----------------------------------------------------
    def __contains__(self, key: int) -> bool:
        return key in self._resident

    def add(self, key: int, nbytes: int) -> None:
        prev = self._resident.pop(key, None)
        if prev is not None:
            self.resident_bytes -= prev
        self._resident[key] = nbytes
        self.resident_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.resident_bytes)

    def touch(self, key: int) -> None:
        if key in self._resident:
            self._resident.move_to_end(key)

    def discard(self, key: int) -> int:
        nbytes = self._resident.pop(key, None)
        if nbytes is None:
            return 0
        self.resident_bytes -= nbytes
        return nbytes

    def fits(self, working_set_bytes: int) -> bool:
        return (self.budget_bytes is None
                or working_set_bytes <= self.budget_bytes)

    def lru_keys(self) -> List[int]:
        return list(self._resident)

    @property
    def occupancy(self) -> float:
        """Resident/budget fraction (0.0 when unlimited)."""
        if not self.budget_bytes:
            return 0.0
        return self.resident_bytes / self.budget_bytes

    def stats(self) -> dict:
        return {"resident_bytes": self.resident_bytes,
                "peak_bytes": self.peak_bytes,
                "occupancy": self.occupancy,
                "spills": self.spills,
                "spill_bytes": self.spill_bytes,
                "evict_blocks": self.evict_blocks,
                "reloads": self.reloads,
                "reload_bytes": self.reload_bytes}


def _nbytes(array: Any) -> int:
    try:
        return int(getattr(array, "nbytes", 0))
    except TypeError:  # pragma: no cover - exotic duck types
        return 0


class MemoryManager:
    """Per-device :class:`MemoryPool` set + the location-bit transitions.

    ``budget`` is ``None`` (unlimited everywhere), one int (same budget on
    every device) or a ``{device_id: bytes | None}`` mapping (missing
    devices unlimited).  All methods are thread-safe: scheduling threads
    hold the submission-pipeline lock, but array finalizers (GC) may fire
    anywhere, so pool mutations take a private lock.
    """

    def __init__(self, num_devices: int = 1, budget: Budget = None,
                 tiers: Optional[Sequence[Any]] = None) -> None:
        self.num_devices = max(1, num_devices)
        if isinstance(budget, Mapping):
            per_dev = [budget.get(d) for d in range(self.num_devices)]
        else:
            per_dev = [budget] * self.num_devices
        self.pools: List[MemoryPool] = [
            MemoryPool(d, per_dev[d]) for d in range(self.num_devices)]
        self._lock = threading.RLock()
        # key -> (device, weakref) for every resident array; the weakref's
        # finalizer drops residency when an array is GC'd mid-episode, so
        # long-running serving loops cannot leak pool accounting.
        self._where: Dict[int, Tuple[int, "weakref.ref"]] = {}
        # Ordered spill stack (tiers.py).  Empty stack == flat D2H.
        self.tiers: List[BackingTier] = make_tiers(tiers)
        for t in self.tiers:
            t.bind(self)
        # key -> (tier, weakref|None) for blocks a tier currently tracks.
        # Host tiers hold the block's only valid copy (backing_tier set on
        # the array); the peer tier only tracks membership for stats — the
        # block stays an ordinary device-resident entry in the peer's pool.
        # The weakref finalizer drops physical tier payloads (compressed
        # bytes, spool files) when an array is GC'd while spilled.
        self._tier_of: Dict[int, Tuple[BackingTier, Any]] = {}
        # Keys evicted off-device at some point and not yet re-uploaded:
        # the next h2d/d2d/reload of such a key is *return traffic caused
        # by eviction*, counted under the pool's reload stats.  Cleared on
        # host overwrite (the re-upload then carries new data, not a
        # reload) and on GC.
        self._evicted_keys: set = set()
        # Scheduled (plan-carried Belady EVICT elements replayed from a
        # captured plan) vs reactive (LRU reserve under live pressure)
        # eviction split, for the planopt benchmarks.
        self.evicts_scheduled = 0
        self.evicts_reactive = 0

    # ------------------------------------------------------------------
    @property
    def bounded(self) -> bool:
        """True when at least one device has a finite budget."""
        return any(p.budget_bytes is not None for p in self.pools)

    def pool(self, device: int) -> MemoryPool:
        return self.pools[min(max(0, int(device)), self.num_devices - 1)]

    def _on_dead(self, key: int) -> None:
        with self._lock:
            entry = self._where.pop(key, None)
            if entry is not None:
                self.pools[entry[0]].discard(key)
            self._tier_release(key)
            self._evicted_keys.discard(key)

    # -- tier stack ----------------------------------------------------
    def tier_named(self, name: str) -> Optional[BackingTier]:
        for t in self.tiers:
            if t.name == name:
                return t
        return None

    def select_tier(self, ma: Any):
        """Ask the ordered stack where a *dirty* victim should land.

        Returns ``(tier, plan)`` from the first tier that accepts the block
        (``plan`` is the tier's schedule-time spill description, see
        ``BackingTier.plan_spill``) or ``(None, None)`` — the flat
        D2H spill.  Clean victims never reach here: their bytes already
        live in the host buffer, so dropping the device copy is free."""
        nb = _nbytes(ma)
        src = getattr(ma, "device_id", None)
        for tier in self.tiers:
            if not tier.can_accept(nb, src):
                continue
            plan = tier.plan_spill(ma)
            if tier.location == "device" and plan.get("target") is None:
                continue        # raced out of peer room; try the next tier
            return tier, plan
        return None, None

    def _tier_release(self, key: int, reload: bool = False) -> None:
        """A tier-tracked block left its tier (reload, overwrite, GC,
        re-eviction).  Must hold the manager lock."""
        entry = self._tier_of.pop(key, None)
        if entry is None:
            return
        tier = entry[0]
        if reload:
            tier.note_reload(key)
        else:
            tier.note_release(key)
            tier.drop(key)      # physical payload is garbage now

    def _make_resident(self, ma: Any, device: int) -> None:
        nb = _nbytes(ma)
        if nb <= 0:
            return      # ManagedValue / zero-size arrays are never tracked
        key = dep_key(ma)
        device = min(max(0, int(device)), self.num_devices - 1)
        with self._lock:
            prev = self._where.get(key)
            if prev is not None and prev[0] != device:
                self.pools[prev[0]].discard(key)
            if prev is None or prev[0] != device:
                try:
                    ref = weakref.ref(ma, lambda _r, k=key: self._on_dead(k))
                except TypeError:       # plain test doubles without __weakref__
                    ref = (lambda m: (lambda: m))(ma)
                self._where[key] = (device, ref)
                self.pools[device].add(key, nb)
            else:
                self.pools[device].touch(key)

    def _drop_residency(self, ma: Any) -> None:
        key = dep_key(ma)
        with self._lock:
            entry = self._where.pop(key, None)
            if entry is not None:
                self.pools[entry[0]].discard(key)

    # ------------------------------------------------------------------
    # Location-bit transitions (single source of truth).  Each mirrors one
    # schedule-time update the runtime used to perform inline; callers —
    # eager pipeline, capture replay, host-write path — may not flip the
    # bits themselves.
    # ------------------------------------------------------------------
    def _note_return(self, key: int, device: int, nbytes: int) -> None:
        """Count a re-upload of a previously evicted key as reload traffic.
        Must hold the manager lock."""
        if key in self._evicted_keys:
            self._evicted_keys.discard(key)
            pool = self.pool(device)
            pool.reloads += 1
            pool.reload_bytes += nbytes

    def note_h2d(self, ma: Any, device: int) -> None:
        """An H2D prefetch of ``ma`` onto ``device`` was scheduled."""
        ma.device_valid = True
        ma.device_id = device
        with self._lock:
            self._note_return(dep_key(ma), device, _nbytes(ma))
        self._make_resident(ma, device)

    def note_d2d(self, ma: Any, device: int) -> None:
        """A D2D migration of ``ma`` onto ``device`` was scheduled (or an
        unowned device copy was claimed): single-copy ownership moves.
        A peer-tier-parked block consumed this way counts as its reload."""
        ma.device_id = device
        with self._lock:
            self._tier_release(dep_key(ma), reload=True)
            self._note_return(dep_key(ma), device, _nbytes(ma))
        self._make_resident(ma, device)

    def note_device_write(self, ma: Any, device: int) -> None:
        """A kernel writing ``ma`` on ``device`` was scheduled: the device
        copy becomes the only valid one (any tier payload is stale)."""
        ma.device_valid = True
        ma.host_valid = False
        ma.device_id = device
        if getattr(ma, "backing_tier", None) is not None:
            ma.backing_tier = None
        with self._lock:
            self._tier_release(dep_key(ma))
            # A write-only kernel re-materializes an evicted block with new
            # data; no bytes came back over the link, so not a reload.
            self._evicted_keys.discard(dep_key(ma))
        self._make_resident(ma, device)

    def note_evict(self, ma: Any, scheduled: bool = False) -> bool:
        """An EVICT of ``ma`` was scheduled: the device copy is dropped
        (after an async D2H write-back when it was the only valid copy).
        Returns True when the eviction was dirty (write-back needed).
        ``scheduled=True`` marks a plan-carried (Belady) eviction rather
        than a reactive LRU one — the split is reported in stats()."""
        dirty = not getattr(ma, "host_valid", True)
        device = getattr(ma, "device_id", None)
        pool = self.pool(device if device is not None else 0)
        ma.host_valid = True
        ma.device_valid = False
        ma.device_id = None
        self._drop_residency(ma)
        with self._lock:
            self._tier_release(dep_key(ma))
            self._evicted_keys.add(dep_key(ma))
            pool.evict_blocks += 1
            if scheduled:
                self.evicts_scheduled += 1
            else:
                self.evicts_reactive += 1
            if dirty:
                pool.spills += 1
                pool.spill_bytes += _nbytes(ma)
        return dirty

    def note_spill(self, ma: Any, tier: BackingTier,
                   target: Optional[int] = None,
                   wire_bytes: Optional[int] = None,
                   scheduled: bool = False) -> None:
        """A tiered spill of dirty ``ma`` was scheduled.

        Peer tier (``location == "device"``): the block becomes an ordinary
        device-resident entry on ``target`` — its host copy stays stale and
        the migrate stage's plain D2D brings it back when next consumed.

        Host tiers (compressed / disk): the tier payload becomes the only
        valid copy — host *and* device bits clear and ``backing_tier``
        names the holder, so consumers synthesize a RELOAD and capture
        slot-state distinguishes tier residency."""
        nb = _nbytes(ma)
        key = dep_key(ma)
        src = getattr(ma, "device_id", None)
        pool = self.pool(src if src is not None else 0)
        with self._lock:
            self._tier_release(key)     # re-spill replaces any old entry
            self._evicted_keys.add(key)
            pool.evict_blocks += 1
            if scheduled:
                self.evicts_scheduled += 1
            else:
                self.evicts_reactive += 1
            pool.spills += 1
            pool.spill_bytes += nb
            tier.note_spill(key, nb, nb if wire_bytes is None else wire_bytes)
            if tier.location == "device":
                ma.device_valid = True
                ma.device_id = target
                self._tier_of[key] = (tier, None)
                self._make_resident(ma, target if target is not None else 0)
                return
            ma.host_valid = False
            ma.device_valid = False
            ma.device_id = None
            ma.backing_tier = tier.name
            self._drop_residency(ma)
            try:
                ref = weakref.ref(ma, lambda _r, k=key: self._on_dead(k))
            except TypeError:           # plain test doubles
                ref = None
            self._tier_of[key] = (tier, ref)

    def note_reload(self, ma: Any, device: int) -> None:
        """A RELOAD of ``ma`` from its host tier onto ``device`` was
        scheduled: the tier handler restores the host buffer and the copy
        engine uploads it, so both copies become valid."""
        with self._lock:
            self._tier_release(dep_key(ma), reload=True)
            self._note_return(dep_key(ma), device, _nbytes(ma))
        ma.backing_tier = None
        ma.host_valid = True
        ma.device_valid = True
        ma.device_id = device
        self._make_resident(ma, device)

    def note_tier_to_host(self, ma: Any) -> None:
        """The host read a tier-resident block (no device upload): the tier
        handler restored ``ma.host`` and the payload is released."""
        with self._lock:
            self._tier_release(dep_key(ma), reload=True)
        ma.backing_tier = None
        ma.host_valid = True
        ma.device_valid = False
        ma.device_id = None

    def note_host_overwrite(self, ma: Any) -> None:
        """The host mutated ``ma.host``: the device copy (if any) is stale
        and no device owns a valid copy anymore (see managed.py for why
        ``device_id`` must clear too).  Any tier payload is stale with it."""
        ma.host_valid = True
        if ma.device_valid or ma.device_id is not None:
            ma.device_valid = False
            ma.device_id = None
        if getattr(ma, "backing_tier", None) is not None:
            ma.backing_tier = None
        with self._lock:
            self._tier_release(dep_key(ma))
            # The next upload carries *new* host data — not reload traffic.
            self._evicted_keys.discard(dep_key(ma))
        self._drop_residency(ma)

    # ------------------------------------------------------------------
    # Budget planning (placement + the submission pipeline's reserve stage)
    # ------------------------------------------------------------------
    def _distinct_args(self, args: Sequence[Any], device: int):
        """Yield ``(key, nbytes, resident_on_device)`` per distinct sized
        argument — the one accounting rule behind working-set size,
        placement pressure and the reserve stage.  Callers needing the
        residency flag must hold the manager lock."""
        seen = set()
        for a in args:
            ma = a.array
            nb = _nbytes(ma)
            k = dep_key(ma)
            if nb <= 0 or k in seen:
                continue
            seen.add(k)
            entry = self._where.get(k)
            yield k, nb, (entry is not None and entry[0] == device)

    def working_set_bytes(self, args: Sequence[Any]) -> int:
        """Bytes that must be simultaneously resident to run one element:
        every distinct argument's nbytes (reads are uploaded/migrated,
        outputs materialize on-device)."""
        return sum(nb for _, nb, _ in self._distinct_args(args, -1))

    def device_fits(self, device: int, working_set_bytes: int) -> bool:
        return self.pool(device).fits(working_set_bytes)

    def pressure(self, device: int) -> float:
        """Occupancy fraction of the device's budget (0.0 when unlimited)."""
        pool = self.pool(device)
        if pool.budget_bytes is None or pool.budget_bytes <= 0:
            return 0.0
        return pool.resident_bytes / pool.budget_bytes

    def placement_pressure(self, device: int, args: Sequence[Any]) -> float:
        """Budget fraction the device would reach after hosting ``args``
        (incoming = argument bytes not already resident there)."""
        pool = self.pool(device)
        if pool.budget_bytes is None or pool.budget_bytes <= 0:
            return 0.0
        with self._lock:
            incoming = sum(nb for _, nb, here in
                           self._distinct_args(args, pool.device_id)
                           if not here)
        return (pool.resident_bytes + incoming) / pool.budget_bytes

    def plan_fits(self, device_mem: Iterable[Tuple[int, int]]) -> bool:
        """Whether a captured plan's recorded per-device peak bytes fit the
        current budgets (capture/replay gating)."""
        return all(self.pool(d).fits(peak) for d, peak in device_mem)

    def reserve(self, device: int, element: Any,
                is_frontier: Optional[Callable[[int], bool]] = None,
                extra_pinned: Optional[Iterable[int]] = None) -> List[Any]:
        """Reserve ``element``'s working set on ``device``; under pressure,
        pick LRU victims to evict (non-frontier arrays first — arrays still
        referenced by in-flight DAG work are spilled only as a last resort,
        the DAG ordering of the EVICT element keeps even that correct).

        ``extra_pinned`` keys are additionally exempt from eviction without
        counting toward the element's working set (the replay fast path
        pins every plan-bound array: a replayed episode may evict stale
        *foreign* leftovers, never its own schedule's data).

        Returns the victim arrays (the pipeline synthesizes one EVICT
        element per victim); raises :class:`DeviceOutOfMemoryError` when
        the element's own working set exceeds the budget outright."""
        pool = self.pool(device)
        if pool.budget_bytes is None:
            return []
        pinned: Dict[int, int] = {}
        incoming = 0
        with self._lock:
            for k, nb, here in self._distinct_args(element.args,
                                                   pool.device_id):
                pinned[k] = nb
                if here:
                    pool.touch(k)
                else:
                    incoming += nb
            ws = sum(pinned.values())
            if ws > pool.budget_bytes:
                raise DeviceOutOfMemoryError(
                    f"element {getattr(element, 'name', '?')!r} needs "
                    f"{ws} bytes resident at once on device "
                    f"{pool.device_id}, budget is {pool.budget_bytes}")
            need = pool.resident_bytes + incoming - pool.budget_bytes
            if need <= 0:
                return []
            no_evict = set(pinned)
            if extra_pinned is not None:
                no_evict.update(extra_pinned)
            victims: List[Any] = []
            # Two LRU passes: non-frontier arrays first, then (only if the
            # budget still cannot be met) arrays with live DAG readers.
            for frontier_pass in (False, True):
                if need <= 0:
                    break
                for k in pool.lru_keys():
                    if need <= 0:
                        break
                    if k in no_evict:
                        continue
                    if (not frontier_pass and is_frontier is not None
                            and is_frontier(k)):
                        continue
                    entry = self._where.get(k)
                    ma = entry[1]() if entry is not None else None
                    freed = pool.discard(k)
                    self._where.pop(k, None)
                    need -= freed
                    if ma is not None:
                        victims.append(ma)
            return victims

    def reserve_bytes(self, device: int, peak: int,
                      is_frontier: Optional[Callable[[int], bool]] = None,
                      extra_pinned: Optional[Iterable[int]] = None
                      ) -> List[Any]:
        """Make room for ``peak`` bytes on ``device`` up front (the whole-
        plan analogue of :meth:`reserve`): evict LRU victims — non-frontier
        first — until the *non-pinned* resident bytes fit beside ``peak``.

        Used by ``SubmissionPipeline.reserve_plan`` before replaying a
        Belady-scheduled plan: the plan's own slots are in ``extra_pinned``
        (their bytes are part of ``peak`` already), so only foreign
        leftovers from earlier episodes are evicted.  Returns the victim
        arrays; never raises — ``plan_fits`` gating already checked
        ``peak <= budget``."""
        pool = self.pool(device)
        if pool.budget_bytes is None:
            return []
        no_evict = set(extra_pinned) if extra_pinned is not None else set()
        with self._lock:
            pinned_res = sum(nb for k, nb in pool._resident.items()
                             if k in no_evict)
            need = (pool.resident_bytes - pinned_res) \
                - (pool.budget_bytes - peak)
            if need <= 0:
                return []
            victims: List[Any] = []
            for frontier_pass in (False, True):
                if need <= 0:
                    break
                for k in pool.lru_keys():
                    if need <= 0:
                        break
                    if k in no_evict:
                        continue
                    if (not frontier_pass and is_frontier is not None
                            and is_frontier(k)):
                        continue
                    entry = self._where.get(k)
                    ma = entry[1]() if entry is not None else None
                    freed = pool.discard(k)
                    self._where.pop(k, None)
                    need -= freed
                    if ma is not None:
                        victims.append(ma)
            return victims

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        agg = {"resident_bytes": 0, "peak_bytes": 0, "spills": 0,
               "spill_bytes": 0, "evict_blocks": 0, "reloads": 0,
               "reload_bytes": 0}
        per = {}
        bounded_res = bounded_budget = 0
        for p in self.pools:
            s = p.stats()
            per[p.device_id] = dict(s, budget_bytes=p.budget_bytes)
            for k in agg:
                agg[k] += s[k]
            if p.budget_bytes:
                bounded_res += p.resident_bytes
                bounded_budget += p.budget_bytes
        out = {f"mem_{k}": v for k, v in agg.items()}
        out["mem_evicts_scheduled"] = self.evicts_scheduled
        out["mem_evicts_reactive"] = self.evicts_reactive
        # Pressure alarm input: resident/budget over the *bounded* pools
        # (0.0 when every pool is unlimited, like MemoryPool.occupancy).
        out["mem_occupancy"] = (bounded_res / bounded_budget
                                if bounded_budget else 0.0)
        if self.num_devices > 1:
            out["mem_per_device"] = per
        if self.tiers:
            out["mem_tiers"] = {t.name: t.stats() for t in self.tiers}
        return out

    def logical_resident_bytes(self) -> Dict[int, int]:
        """Per-device bytes the *logical* ledger says are resident —
        exactly what the pools account against their budgets."""
        with self._lock:
            return {p.device_id: p.resident_bytes for p in self.pools}

    def physical_resident_bytes(self) -> Dict[int, int]:
        """Per-device bytes *physically installed*: resident-tracked arrays
        whose device value object actually exists.  On the real executor at
        a quiescent point this must equal :meth:`logical_resident_bytes`
        (the daemon monitor's drift check); the simulator installs no
        physical values, and a mid-flight real run legitimately lags."""
        out: Dict[int, int] = {p.device_id: 0 for p in self.pools}
        with self._lock:
            for _k, (dev, ref) in self._where.items():
                ma = ref() if callable(ref) else None
                if ma is None or getattr(ma, "device", None) is None:
                    continue
                out[dev] = out.get(dev, 0) + _nbytes(ma)
        return out

    def verify(self, *, raise_on_drift: bool = True,
               physical: bool = False) -> DriftReport:
        """Reconcile logical residency (array location bits, tier
        membership) against the pool ledger; with ``physical=True`` also
        diff the logical byte counts against physically-installed device
        values (only meaningful at a quiescent point on the real
        executor).  Returns a :class:`DriftReport`; raises
        :class:`MemoryDriftError` on any problem unless
        ``raise_on_drift=False`` (the daemon monitor's alarm path reads
        the report instead of unwinding the sampler)."""
        problems: List[str] = []
        with self._lock:
            for p in self.pools:
                ledger = sum(p._resident.values())
                if ledger != p.resident_bytes:
                    problems.append(
                        f"pool {p.device_id}: resident_bytes="
                        f"{p.resident_bytes} but ledger sums to {ledger}")
                for k in p._resident:
                    entry = self._where.get(k)
                    if entry is None:
                        problems.append(f"pool {p.device_id}: key {k} "
                                        f"resident but untracked in _where")
                    elif entry[0] != p.device_id:
                        problems.append(
                            f"key {k} in pool {p.device_id} but _where says "
                            f"device {entry[0]}")
            for k, (dev, ref) in self._where.items():
                if k not in self.pools[dev]._resident:
                    problems.append(f"_where key {k} on device {dev} "
                                    f"missing from that pool's ledger")
                ma = ref() if callable(ref) else None
                if ma is None:
                    continue
                if not getattr(ma, "device_valid", True):
                    problems.append(f"{getattr(ma, 'name', k)}: resident on "
                                    f"device {dev} but device_valid is False")
                elif getattr(ma, "device_id", dev) != dev:
                    problems.append(
                        f"{getattr(ma, 'name', k)}: pool says device {dev}, "
                        f"array says {ma.device_id}")
            for k, (tier, ref) in self._tier_of.items():
                if not tier.holds(k):
                    problems.append(f"key {k} tracked by tier {tier.name} "
                                    f"but the tier's ledger dropped it")
                if tier.location == "device":
                    if k not in self._where:
                        problems.append(f"peer-tier key {k} not device-"
                                        f"resident anywhere")
                    continue
                if k in self._where:
                    problems.append(f"{tier.name}-tier key {k} still "
                                    f"device-resident")
                ma = ref() if callable(ref) else None
                if ma is not None and \
                        getattr(ma, "backing_tier", None) != tier.name:
                    problems.append(
                        f"{getattr(ma, 'name', k)}: tier ledger says "
                        f"{tier.name}, array says {ma.backing_tier!r}")
            for t in self.tiers:
                mine = {k for k, (tt, _r) in self._tier_of.items() if tt is t}
                for k in list(t._resident):
                    if k not in mine:
                        problems.append(f"tier {t.name} holds key {k} the "
                                        f"manager does not track")
        logical = self.logical_resident_bytes()
        phys: Optional[Dict[int, int]] = None
        if physical:
            phys = self.physical_resident_bytes()
            for dev, lb in sorted(logical.items()):
                pb = phys.get(dev, 0)
                if pb != lb:
                    problems.append(
                        f"device {dev}: logical ledger says {lb} resident "
                        f"bytes but {pb} bytes are physically installed")
        report = DriftReport(problems, logical, phys)
        if problems and raise_on_drift:
            raise MemoryDriftError(report)
        return report

    def close(self) -> None:
        """Release every tier's backing resources (spool directories,
        compressed payloads).  Called from ``GrScheduler.shutdown()``."""
        with self._lock:
            self._tier_of.clear()
        for t in self.tiers:
            t.close()
