"""Persistent job store — an append-only JSONL journal.

Durability model: every job mutation appends one full-snapshot record
(``{"t": wall, "job": {...}}``) to the journal and flushes it to the OS, so
a killed daemon (SIGKILL included) loses at most the mutation in flight.
Reopening the journal replays it last-record-wins into the job table; no
tombstones, no partial-update ambiguity.  A trailing partially-written line
(the crash frontier) is ignored.

:meth:`JobStore.recover` implements the restart contract:

* QUEUED jobs are returned for re-enqueue — they were accepted but never
  claimed, so running them after a restart is exactly-once;
* ADMITTED / RUNNING / PAUSED jobs may have had side effects and are marked
  FAILED (``reason="daemon restart"``) — the legal table has an edge to
  FAILED from each of these states precisely for this;
* terminal jobs are kept for status queries.

``path=None`` gives a memory-only store with the same interface (tests,
benchmarks that do not care about restarts).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .lifecycle import JobRecord, JobState


class JobStore:
    def __init__(self, path: Optional[str] = None, *,
                 fsync: bool = False) -> None:
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        self._jobs: Dict[str, JobRecord] = {}
        self._fh = None
        self.appends = 0
        self.replayed = 0
        self.truncated_tail = 0
        if path is not None:
            self._replay(path)
            self._fh = open(path, "a", encoding="utf-8")

    # ------------------------------------------------------------------
    def _replay(self, path: str) -> None:
        if not os.path.exists(path):
            return
        good_end = 0            # byte offset after the last intact record
        with open(path, "rb") as fh:
            for raw in fh:
                try:
                    rec = json.loads(raw.decode().strip() or "null")
                    job = JobRecord.from_json(rec["job"])
                except (ValueError, KeyError, TypeError, AttributeError):
                    # Crash frontier: a half-written trailing record.  Only
                    # the tail can be torn (appends are sequential), so we
                    # drop it and keep everything before it.
                    self.truncated_tail += 1
                    continue
                good_end += len(raw)
                self._jobs[job.job_id] = job
                self.replayed += 1
        if self.truncated_tail:
            # Physically cut the torn tail before reopening for append —
            # otherwise the next record would be glued onto the partial
            # line and *both* would be lost at the following replay.
            with open(path, "rb+") as fh:
                fh.truncate(good_end)

    # ------------------------------------------------------------------
    def _append_locked(self, job: JobRecord) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps({"t": time.time(),
                                       "job": job.to_json()}) + "\n")
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
        self.appends += 1

    def put(self, job: JobRecord) -> None:
        """Insert a new job (or persist an update — same journal shape)."""
        with self._lock:
            self._jobs[job.job_id] = job
            self._append_locked(job)

    # ``update`` is an alias that reads better at transition sites.
    update = put

    def get(self, job_id: str) -> Optional[JobRecord]:
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self) -> List[JobRecord]:
        with self._lock:
            return list(self._jobs.values())

    def by_state(self, state: JobState) -> List[JobRecord]:
        with self._lock:
            return [j for j in self._jobs.values() if j.state is state]

    def __len__(self) -> int:
        with self._lock:
            return len(self._jobs)

    # ------------------------------------------------------------------
    def recover(self) -> Tuple[List[JobRecord], List[JobRecord]]:
        """Apply the restart contract; returns ``(requeued, failed)``.

        ``requeued`` are the QUEUED jobs to re-enqueue (exactly once: the
        table holds one record per job however many journal lines it has);
        ``failed`` are the jobs that were in flight when the previous
        daemon died, now FAILED."""
        requeued: List[JobRecord] = []
        failed: List[JobRecord] = []
        with self._lock:
            for job in self._jobs.values():
                if job.state is JobState.QUEUED:
                    requeued.append(job)
                elif job.state in (JobState.ADMITTED, JobState.RUNNING,
                                   JobState.PAUSED):
                    job.transition(JobState.FAILED, reason="daemon restart")
                    self._append_locked(job)
                    failed.append(job)
        # Stable re-enqueue order: original submission order.
        requeued.sort(key=lambda j: j.submit_t)
        return requeued, failed

    # ------------------------------------------------------------------
    def compact(self) -> None:
        """Rewrite the journal with one snapshot per job (atomic rename).

        Called on clean shutdown so restart replay stays O(jobs), not
        O(transitions ever recorded)."""
        if self.path is None:
            return
        with self._lock:
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                for job in self._jobs.values():
                    fh.write(json.dumps({"t": time.time(),
                                         "job": job.to_json()}) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            if self._fh is not None:
                self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")

    def audit(self):
        """Replay the journal through the lifecycle auditor
        (:func:`repro_torch.analysis.journal.audit_journal`) without
        mutating it.
        Flushes pending appends first so the audit sees the live tail.
        Returns the :class:`JournalAudit`; raises when the store is
        in-memory only (nothing on disk to audit)."""
        if self.path is None:
            raise ValueError("in-memory JobStore has no journal to audit")
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
        from ..analysis.journal import audit_journal
        return audit_journal(self.path)

    def close(self, *, compact: bool = True) -> None:
        if compact:
            self.compact()
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def stats(self) -> dict:
        with self._lock:
            by_state: Dict[str, int] = {}
            for j in self._jobs.values():
                by_state[j.state.value] = by_state.get(j.state.value, 0) + 1
            return {"jobs": len(self._jobs), "appends": self.appends,
                    "replayed": self.replayed,
                    "truncated_tail": self.truncated_tail,
                    "by_state": by_state}
