"""Runtime daemon of the port — out-of-process job service over the
port's scheduler.

Every frontend links :class:`~repro_torch.core.scheduler.GrScheduler`
in-process; a resident runtime that many client *processes* submit to needs
a service boundary.  This package is that boundary, with the reference's
(``repro.daemon``) wire format, journal records and CLI verbs:

* :mod:`~repro_torch.daemon.server` — a Unix-domain-socket server speaking
  length-prefixed JSON, dispatching jobs onto one shared scheduler through
  the thread-safe SubmissionPipeline;
* :mod:`~repro_torch.daemon.client` / :mod:`~repro_torch.daemon.cli` — the
  client library and ``python -m repro_torch.daemon``
  (``serve | submit | status | wait | cancel | stats | drain | shutdown``);
* :mod:`~repro_torch.daemon.store` — an append-only JSONL journal: the job
  table survives daemon restarts and QUEUED work is replayed exactly once;
* :mod:`~repro_torch.daemon.lifecycle` — the strict job state machine
  (QUEUED -> ADMITTED -> RUNNING -> PAUSED -> FINISHED/FAILED/CANCELLED)
  with an explicit legal-transition table and per-transition timestamps;
* :mod:`~repro_torch.daemon.monitor` / :mod:`~repro_torch.daemon.policy` —
  an EWMA monitoring loop (queue depth, lane utilization, memory occupancy,
  spike detection with cooldown windows, logical-vs-physical residency
  drift) driving admission control: jobs are shed or deferred under
  pressure instead of admitted blindly;
* :mod:`~repro_torch.daemon.jobs` — the job kinds (``chain``, ``sleep``,
  ``noop``, ``serve_lm``); their tensors live on the scheduler's executor
  device, and a simulated daemon has none.

:class:`DaemonServer` is loaded on first use: it imports the scheduler and
torch, which a client process that only submits jobs (``DaemonClient``,
the CLI's client verbs) never needs.
"""
from .client import DaemonClient, DaemonError
from .lifecycle import (IllegalTransitionError, JobRecord, JobState,
                        LEGAL_TRANSITIONS, TERMINAL_STATES, validate_history)
from .monitor import Ewma, MonitorSnapshot, RuntimeMonitor, SpikeDetector
from .policy import AdmissionPolicy, Decision
from .store import JobStore

__all__ = [
    "AdmissionPolicy", "DaemonClient", "DaemonError", "DaemonServer",
    "Decision", "Ewma", "IllegalTransitionError", "JobRecord", "JobState",
    "JobStore", "LEGAL_TRANSITIONS", "MonitorSnapshot", "RuntimeMonitor",
    "SpikeDetector", "TERMINAL_STATES", "validate_history",
]


def __getattr__(name: str):
    if name == "DaemonServer":
        from .server import DaemonServer
        return DaemonServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
