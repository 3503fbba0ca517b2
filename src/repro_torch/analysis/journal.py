"""Offline auditor for the daemon's JSONL job journal.

The daemon journals every job mutation as one JSON line (last record
wins) and replays the file on restart; :mod:`repro_torch.daemon.lifecycle`
defines the legal state machine.  The auditor replays a journal *without
mutating it* and flags:

* **torn records** anywhere but the tail (a torn tail is the legal crash
  frontier — the store truncates it on recovery — but a torn record with
  valid records after it means lost history / concurrent writers);
* **illegal transition histories** per job, via
  :func:`lifecycle.validate_history` (unknown states, illegal edges,
  broken chaining, transitions out of terminal states) plus timestamp
  monotonicity;
* **non-append-only rewrites**: each journal snapshot of a job must
  extend the previous snapshot's transition list — a snapshot whose
  history is *not* an extension means the record was mutated, not
  appended;
* **state/history divergence**: the record's ``state`` field must equal
  the destination of its last transition.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List

from ..daemon.lifecycle import JobState, validate_history


@dataclass
class JournalAudit:
    """Result of auditing one journal file."""

    path: str
    records: int = 0
    jobs: int = 0
    torn_tail: bool = False
    problems: List[str] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems

    def to_json(self) -> dict:
        return {"path": self.path, "records": self.records,
                "jobs": self.jobs, "torn_tail": self.torn_tail,
                "ok": self.ok, "problems": list(self.problems),
                "notes": list(self.notes)}


def _as_triples(transitions) -> List[tuple]:
    return [tuple(t) for t in (transitions or [])]


def audit_journal(path: str) -> JournalAudit:
    """Audit one JSONL journal; never modifies the file."""
    audit = JournalAudit(path=str(path))
    try:
        with open(path) as fh:
            raw_lines = fh.read().splitlines()
    except OSError as exc:
        audit.problems.append(f"unreadable journal: {exc}")
        return audit

    parsed: List[tuple] = []        # (line_no, record dict)
    torn: List[int] = []
    for no, line in enumerate(raw_lines, start=1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict) or "job" not in rec:
                raise ValueError("record is not a {'t', 'job'} object")
        except ValueError:
            torn.append(no)
            continue
        parsed.append((no, rec))
    audit.records = len(parsed)
    for no in torn:
        if parsed and no > parsed[-1][0]:
            # Beyond the last valid record: the legal crash frontier.
            audit.torn_tail = True
            audit.notes.append(
                f"torn tail record at line {no} (truncated on recovery)")
        else:
            audit.problems.append(
                f"torn record at line {no} with valid records after it — "
                f"lost history or concurrent writers")

    histories: Dict[str, List[tuple]] = {}
    last_record: Dict[str, dict] = {}
    for no, rec in parsed:
        job = rec.get("job") or {}
        jid = job.get("job_id")
        if not jid:
            audit.problems.append(f"line {no}: record without a job_id")
            continue
        trans = _as_triples(job.get("transitions"))
        prev = histories.get(jid)
        if prev is not None and trans[:len(prev)] != prev:
            audit.problems.append(
                f"job {jid}: snapshot at line {no} does not extend the "
                f"previous transition history — journal was rewritten, "
                f"not appended")
        if prev is None or len(trans) >= len(prev):
            histories[jid] = trans
        last_record[jid] = job

    audit.jobs = len(last_record)
    valid_states = {s.value for s in JobState}
    for jid, job in sorted(last_record.items()):
        trans = _as_triples(job.get("transitions"))
        for msg in validate_history(trans, check_times=True):
            audit.problems.append(f"job {jid}: {msg}")
        state = job.get("state")
        if state not in valid_states:
            audit.problems.append(f"job {jid}: unknown state {state!r}")
        elif trans and trans[-1][1] != state:
            audit.problems.append(
                f"job {jid}: recorded state {state!r} != last transition "
                f"destination {trans[-1][1]!r}")
        elif not trans and state != JobState.QUEUED.value:
            audit.problems.append(
                f"job {jid}: state {state!r} with an empty transition "
                f"history (jobs are born {JobState.QUEUED.value!r})")
    return audit
