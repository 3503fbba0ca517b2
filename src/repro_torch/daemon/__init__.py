"""Runtime daemon of the port.

Only the job lifecycle state machine (:mod:`.lifecycle`) is here so far:
the journal auditor (``repro_torch.analysis.journal``) replays journals
through it.  The rest of the daemon (server, client, store, monitor,
admission policy, jobs and CLI) is still to be ported (ROADMAP A.2).
"""
from .lifecycle import (IllegalTransitionError, JobRecord, JobState,
                        LEGAL_TRANSITIONS, TERMINAL_STATES, validate_history)

__all__ = [
    "IllegalTransitionError", "JobRecord", "JobState", "LEGAL_TRANSITIONS",
    "TERMINAL_STATES", "validate_history",
]
