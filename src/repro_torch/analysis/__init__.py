"""Static analysis and runtime sanitization for the PyTorch runtime.

The scheduler infers the whole dependency DAG from declared access modes
(paper §IV-D) — which makes a wrong annotation invisible at runtime: a
``const`` on a written operand silently drops an edge and races kernels, an
``inout`` on a read-only operand serializes work the space-sharing
scheduler should overlap.  This package is the correctness tooling:

* :mod:`~repro_torch.analysis.modes` — abstract execution of declared
  ``GrFunction`` kernels (``make_fx`` on meta tensors) to infer actual
  read/write behavior vs modes;
* :mod:`~repro_torch.analysis.verifier` — happens-before verification of live
  DAGs and captured/optimized :class:`ExecutionPlan` objects;
* :mod:`~repro_torch.analysis.sanitizer` — runtime shadow tracking
  (``GrScheduler(sanitize=True)``) raising on observed races and
  writes-through-const;
* :mod:`~repro_torch.analysis.journal` — offline audits of the daemon's JSONL
  job journal against the lifecycle state machine.

CLI: ``python -m repro_torch.analysis lint|verify-plan|audit-journal``.
"""
from .journal import JournalAudit, audit_journal
from .modes import ModeIssue, ModeReport, analyze_function, lint_functions
from .sanitizer import Sanitizer, SanitizerError
from .verifier import (PlanVerificationError, Violation, verify_elements,
                       verify_plan, verify_scheduler)

__all__ = [
    "ModeIssue", "ModeReport", "analyze_function", "lint_functions",
    "Violation", "PlanVerificationError", "verify_plan", "verify_elements",
    "verify_scheduler", "Sanitizer", "SanitizerError",
    "JournalAudit", "audit_journal",
]
