"""Computational elements — the vertices of the runtime DAG (paper §IV-A).

A *computational element* is anything the scheduler must order: a device
kernel invocation, a host access to a managed array, a host-to-device
transfer (prefetch), or a pre-registered library call.  Each element carries
an explicit argument list; every argument is a handle to a `ManagedArray`
(GrCUDA's UM-backed device array analogue) annotated with an access mode.

The managed-object encapsulation is what makes automatic dependency
inference sound: arguments are opaque handles, so there is no pointer
aliasing (paper §IV-A, "removing the risk of pointer aliasing typical of
native languages").
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

_ELEMENT_IDS = itertools.count()

# Priority -> space-sharing weight mapping (multi-tenant QoS).  Each priority
# level doubles the element's claim on contended device capacity: the
# SimExecutor water-fill hands a kernel ``weight/Σweights`` of the device
# (still capped by its parallel fraction), so priority 3 work progresses 8x
# faster than priority 0 work *only while they contend* — an idle device runs
# everything at full rate regardless.
PRIORITY_WEIGHT_BASE = 2.0

DEFAULT_TENANT = "default"


def priority_weight(priority: int) -> float:
    """Capacity weight of a priority level (``base ** priority``).

    Negative priorities yield sub-unit weights: true background work that
    cedes the device to any default-priority tenant under contention."""
    return float(PRIORITY_WEIGHT_BASE ** priority)


class AccessMode(enum.Enum):
    """Argument annotations (paper §IV-D: ``input``/``const``/``output``).

    ``CONST`` arguments are read-only and get the special dependency rules of
    Fig. 3.  Un-annotated arguments are conservatively ``INOUT`` ("the
    scheduler treats them as modifiable by the kernel; not specifying
    arguments as read-only does not affect correctness").
    """

    CONST = "const"      # read-only
    OUT = "out"          # write-only (still ordered after prior readers/writer)
    INOUT = "inout"      # read-modify-write (default for unannotated args)

    @property
    def reads(self) -> bool:
        return self in (AccessMode.CONST, AccessMode.INOUT)

    @property
    def writes(self) -> bool:
        return self in (AccessMode.OUT, AccessMode.INOUT)

    def conflicts_with(self, other: "AccessMode") -> bool:
        """Two accesses to the same array conflict (must be ordered) unless
        both are read-only — the RAW/WAR/WAW rule the verifier and the
        runtime sanitizer share."""
        return self.writes or other.writes


def dep_key(array: Any) -> int:
    """Dependency-tracking key for an argument handle.

    Managed arrays carry a process-monotonic ``aid``; plain (test) objects
    fall back to ``id()``.  ``id()`` alone is unsound in long-running loops:
    CPython reuses addresses after GC, so a fresh array could inherit the
    stale ``last_writer``/``readers`` frontier of a dead one.  ``aid`` keys
    are mapped to negative ints so the two namespaces can never collide
    (``id()`` is a non-negative address)."""
    aid = getattr(array, "aid", None)
    return id(array) if aid is None else -1 - aid


@dataclass(frozen=True)
class Arg:
    """One argument of a computational element: a managed handle + mode."""

    array: Any               # ManagedArray (duck-typed; keyed via dep_key)
    mode: AccessMode

    @property
    def key(self) -> int:
        return dep_key(self.array)


class ElementKind(enum.Enum):
    KERNEL = "kernel"            # device computation
    HOST_ACCESS = "host_access"  # CPU read/write of a managed array (§IV-A)
    TRANSFER = "transfer"        # H2D prefetch / D2H copy (scheduled by runtime)
    D2D = "d2d"                  # device-to-device copy (multi-device runtime)
    EVICT = "evict"              # budget spill: async D2H + drop device copy
    RELOAD = "reload"            # bring a tier-spilled block back on-device
    LIBRARY = "library"          # pre-registered library call (§IV-A)
    SYNC = "sync"                # explicit barrier requested by the host


class ElementState(enum.Enum):
    """Element lifecycle, as the executors see it.

    ``PAUSED`` is the element-boundary preemption state: a queued (never
    started) element whose lane yields to deadline-urgent work.  A paused
    element stays exactly where it is in its lane's FIFO — pausing blocks
    the lane in place, it never reorders it, because same-lane children
    rely on queue order instead of completion events.  Running work is
    never interrupted (no mid-kernel preemption)."""

    PENDING = "pending"    # constructed, not yet handed to an executor
    QUEUED = "queued"      # submitted, waiting for lane/parents
    PAUSED = "paused"      # queued but yielding to at-risk deadline work
    RUNNING = "running"    # on the device (or worker thread)
    DONE = "done"          # completed


@dataclass
class ComputationalElement:
    """A vertex of the computation DAG.

    Tracks its configuration, input arguments and whether the computation is
    *active* (paper: "computations are considered active until the CPU
    requires their result or one of their children" — plus the dependency-set
    emptiness rule).
    """

    fn: Optional[Callable]
    args: Tuple[Arg, ...]
    kind: ElementKind = ElementKind.KERNEL
    name: str = ""
    # launch configuration (block-size analogue; used by history heuristics)
    config: dict = field(default_factory=dict)
    # estimated costs for the simulator (seconds / bytes); populated by the
    # benchsuite or measured by the history tracker.
    cost_s: float = 0.0
    transfer_bytes: int = 0
    # Multi-tenant QoS: who issued this element and how urgent it is.
    # Auto-inserted TRANSFER/D2D elements inherit both from the kernel that
    # triggered them; ``priority`` feeds the weighted water-fill and the
    # priority-aware lane fallback, ``tenant`` feeds per-tenant accounting
    # and (optional) lane quotas.
    priority: int = 0
    tenant: str = DEFAULT_TENANT
    # Deadline/SLO-aware scheduling (EDF): ``deadline_s`` is the declared
    # per-launch latency budget (seconds from submission; None = no
    # deadline); ``deadline_t`` is the absolute deadline stamped at
    # submission time (host clock).  Auto-inserted TRANSFER/D2D/EVICT
    # children inherit both from the kernel that triggered them so the
    # whole urgent frontier carries one EDF rank.
    deadline_s: Optional[float] = None
    deadline_t: Optional[float] = None
    # Declared-function identity (GrFunction frontend): launches issued
    # through the same declared ``GrFunction`` share one ``fn_key`` even when
    # the underlying Python callable is re-created per episode, and two
    # different declarations never share one.  ``None`` for legacy
    # ``scheduler.launch`` call sites; capture/replay keys plans by it.
    fn_key: Optional[int] = None

    # Backing tier driving this EVICT/RELOAD (runtime object, not part of
    # the structural signature — capture encodes the tier *name* in
    # ``config`` and replay re-resolves it against the scheduler's stack).
    tier: Any = None

    # -- filled in by the scheduler --
    uid: int = field(default_factory=lambda: next(_ELEMENT_IDS))
    stream: Optional[int] = None       # lane id assigned by the StreamManager
    device: Optional[int] = None       # device chosen by the placement policy
    # True when ``device`` was pinned by the caller (GrFunction
    # ``with_options(device=...)``) rather than chosen by the placement
    # policy.  Capture records it so the plan optimizer never moves a
    # user-pinned kernel (replay matching rejects device retargets).
    device_pinned: bool = False
    src_device: Optional[int] = None   # D2D only: device the copy reads from
    parents: list = field(default_factory=list)    # list[ComputationalElement]
    children: list = field(default_factory=list)
    # dependency set: argument keys that can still introduce dependencies
    dep_set: set = field(default_factory=set)
    active: bool = False
    state: ElementState = ElementState.PENDING
    done_event: Any = None             # executor-specific completion handle
    pause_gate: Any = None             # threading.Event (real executor only):
    #                                    cleared = paused, worker blocks on it
    # timeline bookkeeping (filled by executors)
    t_issue: float = float("nan")      # submission time (queueing-delay base)
    t_start: float = float("nan")
    t_end: float = float("nan")

    @property
    def weight(self) -> float:
        """Space-sharing weight derived from ``priority``."""
        return priority_weight(self.priority)

    @property
    def effective_deadline(self) -> float:
        """EDF sort key: absolute deadline, or +inf for deadline-free work.

        Comparisons between two deadline-free elements are always vacuous
        (``inf > inf`` is False), which is what keeps every EDF tie-break a
        no-op — and the schedule bit-identical — when no deadlines are in
        play."""
        return float("inf") if self.deadline_t is None else self.deadline_t

    def __post_init__(self) -> None:
        if not self.name:
            self.name = f"{self.kind.value}_{self.uid}"
        # The dependency set initially contains all arguments (§IV-A).
        self.dep_set = {a.key for a in self.args}

    # ------------------------------------------------------------------
    def arg_modes(self):
        """Yield (key, mode) merged per distinct array.

        If the same array appears twice with different modes the strongest
        (writing) mode wins — matching the conservative GrCUDA behaviour.
        """
        merged: dict = {}
        for a in self.args:
            prev = merged.get(a.key)
            if prev is None or (a.mode.writes and not prev.writes):
                merged[a.key] = a.mode
        return merged.items()

    @property
    def is_host(self) -> bool:
        return self.kind in (ElementKind.HOST_ACCESS, ElementKind.SYNC)

    def __hash__(self) -> int:
        return self.uid

    def __eq__(self, other) -> bool:
        return isinstance(other, ComputationalElement) and other.uid == self.uid

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<CE {self.name} uid={self.uid} stream={self.stream} "
                f"parents={[p.name for p in self.parents]}>")


def kernel(fn: Callable, *args: Arg, name: str = "", cost_s: float = 0.0,
           transfer_bytes: int = 0, priority: int = 0,
           tenant: str = DEFAULT_TENANT, **config) -> ComputationalElement:
    """Convenience constructor for a device kernel element."""
    return ComputationalElement(fn=fn, args=tuple(args), kind=ElementKind.KERNEL,
                                name=name, config=config, cost_s=cost_s,
                                transfer_bytes=transfer_bytes,
                                priority=priority, tenant=tenant)


def const(array: Any) -> Arg:
    return Arg(array, AccessMode.CONST)


def out(array: Any) -> Arg:
    return Arg(array, AccessMode.OUT)


def inout(array: Any) -> Arg:
    return Arg(array, AccessMode.INOUT)
