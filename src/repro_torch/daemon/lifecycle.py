"""Job lifecycle state machine for the runtime daemon.

A job is the daemon's unit of admission and accounting — one client request
that expands into one or more scheduler launches.  Its lifecycle is a strict
state machine::

    QUEUED ---> ADMITTED ---> RUNNING ---> FINISHED
      |            |          |    ^
      |            |          v    |
      |            |        PAUSED-+
      |            |          |
      +------------+----------+---> CANCELLED
                   +----------+---> FAILED

Every transition is validated against :data:`LEGAL_TRANSITIONS` and recorded
with a timestamp; an illegal transition raises
:class:`IllegalTransitionError` *before* any state is mutated, so a bug in
the daemon can never journal an impossible history.  The per-transition
timestamps are what the daemon's ``tenant_stats`` are computed from
(queue delay = QUEUED->RUNNING, service time = RUNNING->terminal).
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class JobState(enum.Enum):
    QUEUED = "queued"        # accepted into the persistent queue
    ADMITTED = "admitted"    # claimed by a dispatcher, about to run
    RUNNING = "running"      # handler executing on the shared scheduler
    PAUSED = "paused"        # cooperatively paused at a checkpoint
    FINISHED = "finished"    # handler returned a result
    FAILED = "failed"        # handler raised / daemon restarted mid-run
    CANCELLED = "cancelled"  # client cancel or admission-control shed


#: The only edges the daemon may ever take.  Everything else raises.
LEGAL_TRANSITIONS: Dict[JobState, frozenset] = {
    JobState.QUEUED: frozenset({JobState.ADMITTED, JobState.CANCELLED}),
    JobState.ADMITTED: frozenset({JobState.RUNNING, JobState.CANCELLED,
                                  JobState.FAILED}),
    JobState.RUNNING: frozenset({JobState.PAUSED, JobState.FINISHED,
                                 JobState.FAILED, JobState.CANCELLED}),
    JobState.PAUSED: frozenset({JobState.RUNNING, JobState.CANCELLED,
                                JobState.FAILED}),
    JobState.FINISHED: frozenset(),
    JobState.FAILED: frozenset(),
    JobState.CANCELLED: frozenset(),
}

TERMINAL_STATES = frozenset({JobState.FINISHED, JobState.FAILED,
                             JobState.CANCELLED})


class IllegalTransitionError(RuntimeError):
    """An edge outside :data:`LEGAL_TRANSITIONS` was attempted."""

    def __init__(self, job_id: str, src: JobState, dst: JobState) -> None:
        super().__init__(
            f"job {job_id}: illegal transition {src.value} -> {dst.value}; "
            f"legal from {src.value}: "
            f"{sorted(s.value for s in LEGAL_TRANSITIONS[src]) or 'none'}")
        self.src, self.dst = src, dst


@dataclass
class JobRecord:
    """One job's durable state: spec + lifecycle history + result.

    ``transitions`` is the append-only list of
    ``(from_state, to_state, wall_timestamp)`` triples, in order; the last
    entry's destination always equals ``state``.
    """

    job_id: str
    kind: str
    params: Dict[str, Any] = field(default_factory=dict)
    tenant: str = "default"
    priority: int = 0
    deadline_s: Optional[float] = None
    submit_t: float = 0.0
    state: JobState = JobState.QUEUED
    reason: str = ""                       # why FAILED/CANCELLED/deferred
    result: Any = None                     # JSON-serializable handler result
    attempts: int = 0                      # times a dispatcher admitted it
    transitions: List[Tuple[str, str, float]] = field(default_factory=list)

    # ------------------------------------------------------------------
    def transition(self, dst: JobState, *, reason: str = "",
                   t: Optional[float] = None) -> None:
        """Take one validated edge, recording its timestamp.

        Raises :class:`IllegalTransitionError` (and changes nothing) when
        the edge is not in the legal table."""
        if dst not in LEGAL_TRANSITIONS[self.state]:
            raise IllegalTransitionError(self.job_id, self.state, dst)
        when = time.time() if t is None else t
        self.transitions.append((self.state.value, dst.value, when))
        self.state = dst
        if reason:
            self.reason = reason
        if dst is JobState.ADMITTED:
            self.attempts += 1

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def transition_time(self, dst: JobState) -> Optional[float]:
        """Timestamp of the *first* transition into ``dst`` (None if the
        job never entered it)."""
        for _src, to, when in self.transitions:
            if to == dst.value:
                return when
        return None

    # -- serialization (journal records / wire status replies) ----------
    def to_json(self) -> dict:
        return {
            "job_id": self.job_id, "kind": self.kind, "params": self.params,
            "tenant": self.tenant, "priority": self.priority,
            "deadline_s": self.deadline_s, "submit_t": self.submit_t,
            "state": self.state.value, "reason": self.reason,
            "result": self.result, "attempts": self.attempts,
            "transitions": [list(tr) for tr in self.transitions],
        }

    @classmethod
    def from_json(cls, d: dict) -> "JobRecord":
        return cls(
            job_id=d["job_id"], kind=d["kind"], params=dict(d["params"]),
            tenant=d.get("tenant", "default"),
            priority=int(d.get("priority", 0)),
            deadline_s=d.get("deadline_s"),
            submit_t=float(d.get("submit_t", 0.0)),
            state=JobState(d["state"]), reason=d.get("reason", ""),
            result=d.get("result"), attempts=int(d.get("attempts", 0)),
            transitions=[tuple(tr) for tr in d.get("transitions", [])])


def validate_history(transitions: List[Tuple[str, str, float]], *,
                     check_times: bool = False) -> List[str]:
    """Audit a recorded transition history against the legal table.

    Returns a list of violation strings (empty = clean): illegal edges,
    broken chaining (an edge starting from a state the previous edge did
    not land in), transitions out of a terminal state, or a non-QUEUED
    start.  ``check_times=True`` additionally requires non-decreasing
    timestamps (the journal auditor's wall-clock sanity check; the
    recovery tests keep it off since fake clocks need not be monotone).
    Used by the recovery tests to prove no journal ever records an
    impossible history."""
    problems: List[str] = []
    prev_dst: Optional[str] = None
    prev_t: Optional[float] = None
    for i, (src, dst, t) in enumerate(transitions):
        if check_times:
            try:
                tf = float(t)
            except (TypeError, ValueError):
                problems.append(f"edge {i}: non-numeric timestamp {t!r}")
            else:
                if prev_t is not None and tf < prev_t:
                    problems.append(
                        f"edge {i}: timestamp {tf} precedes previous "
                        f"edge's {prev_t} — history is not append-ordered")
                prev_t = tf
        try:
            s, d = JobState(src), JobState(dst)
        except ValueError:
            problems.append(f"edge {i}: unknown state in {src!r}->{dst!r}")
            continue
        if i == 0 and s is not JobState.QUEUED:
            problems.append(f"edge 0 starts from {src!r}, not 'queued'")
        if prev_dst is not None and src != prev_dst:
            problems.append(f"edge {i}: starts from {src!r} but previous "
                            f"edge landed in {prev_dst!r}")
        if d not in LEGAL_TRANSITIONS[s]:
            problems.append(f"edge {i}: illegal {src!r}->{dst!r}")
        prev_dst = dst
    return problems
