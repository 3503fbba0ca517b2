"""``python -m repro_torch.analysis`` — lint | verify-plan | audit-journal.

* ``lint`` imports the in-repo declaration sites (benchsuite kernels and
  scenarios, runtime serving, plus any ``--file`` — e.g. the examples)
  and runs the access-mode checker over every registered ``GrFunction``.
  Exit 1 on any under/over-declaration.
* ``verify-plan`` drives the benchsuite scenarios on the simulator —
  eager live windows, capture/replay plans, planopt-rewritten plans,
  budgeted out-of-core plans — and runs the happens-before verifier over
  every live DAG window and cached plan.  Exit 1 on any violation.
* ``audit-journal PATH...`` replays daemon JSONL journals through the
  lifecycle state machine.  Exit 1 on any illegal history.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from typing import List

# The trainer is not ported yet (ROADMAP A.5); its module joins this list
# when it is.
_LINT_MODULES = (
    "repro_torch.benchsuite.kernels",
    "repro_torch.benchsuite.multitenant",
    "repro_torch.benchsuite.multidevice",
    "repro_torch.benchsuite.outofcore",
    "repro_torch.benchsuite.slo",
    "repro_torch.daemon.jobs",
    "repro_torch.runtime.serving",
    "repro_torch.runtime.trainer",
)


def _import_file(path: str, idx: int) -> None:
    name = f"_repro_torch_lint_target_{idx}"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)


def cmd_lint(args) -> int:
    from .modes import lint_functions

    for mod in list(_LINT_MODULES) + list(args.module or []):
        importlib.import_module(mod)
    for i, path in enumerate(args.file or []):
        _import_file(path, i)
    reports = lint_functions()
    issues = [i for r in reports for i in r.issues]
    if args.json:
        json.dump({"functions": len(reports),
                   "issues": len(issues),
                   "reports": [r.to_json() for r in reports]},
                  sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        for r in sorted(reports, key=lambda r: r.function):
            if r.skipped:
                status = f"SKIP ({r.skipped})"
            elif r.ok:
                status = "OK"
            else:
                status = "ISSUES"
            print(f"lint: {r.function:<24} modes={','.join(r.modes):<40} "
                  f"{status}")
            for issue in r.issues:
                print(f"    {issue}")
        print(f"lint: {len(reports)} declaration(s), "
              f"{len(issues)} issue(s)")
    return 1 if issues else 0


# ----------------------------------------------------------------------
def _verify_and_report(sched, label: str, out: List[str]) -> None:
    from .verifier import verify_scheduler
    for v in verify_scheduler(sched):
        out.append(f"{label}: {v}")


def cmd_verify_plan(args) -> int:
    import numpy as np

    from repro_torch.benchsuite import (BENCHMARKS, build_locality_heavy,
                                        build_outofcore, build_slo_workload,
                                        build_task_parallel,
                                        working_set_bytes)
    from repro_torch.benchsuite.costmodel import P100, sim_hardware
    from repro_torch.benchsuite.multitenant import build_contention
    from repro_torch.core import make_scheduler

    violations: List[str] = []
    scale = args.scale

    # Paper benchmarks: eager + capture/replay episodes on the simulator.
    for bname, bench in sorted(BENCHMARKS.items()):
        s = make_scheduler("parallel", simulate=True,
                           hw=sim_hardware(P100, "parallel", True))
        try:
            data = bench.make_data(scale)
            for ep in range(2):
                with s.capture(f"verify_{bname}"):
                    bench.build(s, data, gpu=P100, iters=2)
                _verify_and_report(s, f"bench {bname} ep{ep}", violations)
                s.sync()
        finally:
            s.shutdown()
        print(f"verify-plan: {bname}: "
              f"{'OK' if not violations else 'VIOLATIONS'}")

    # Multi-device scenarios, with the plan-time optimizer on (verifies a
    # planopt-rewritten plan, not just the greedy recording).
    for name, builder, kw in (
            ("task_parallel", build_task_parallel,
             dict(branches=3, chain=3, n=1 << 10)),
            ("locality_heavy", build_locality_heavy,
             dict(groups=2, iters=3, n=1 << 10))):
        s = make_scheduler("parallel", simulate=True, num_devices=2,
                           placement="round-robin", plan_optimize=True)
        try:
            for ep in range(2):
                with s.capture(f"verify_{name}"):
                    builder(s, **kw)
                _verify_and_report(s, f"scenario {name} ep{ep}", violations)
                s.sync()
        finally:
            s.shutdown()
        print(f"verify-plan: {name}: "
              f"{'OK' if not violations else 'VIOLATIONS'}")

    # Budgeted out-of-core: EVICT/RELOAD liveness on a memory-scheduled
    # plan (planopt Belady path) and on the greedy recording.
    chunks, n = 6, 1 << 10
    for opt in (False, True):
        s = make_scheduler("parallel", simulate=True,
                           memory_budget=working_set_bytes(chunks, n) // 2,
                           plan_optimize=opt)
        try:
            for ep in range(2):
                with s.capture("verify_ooc"):
                    build_outofcore(s, chunks=chunks, n=n)
                _verify_and_report(
                    s, f"scenario ooc(opt={opt}) ep{ep}", violations)
                s.sync()
        finally:
            s.shutdown()
    print(f"verify-plan: outofcore: "
          f"{'OK' if not violations else 'VIOLATIONS'}")

    # Multi-tenant contention + SLO workloads (live windows, no capture).
    s = make_scheduler("parallel", simulate=True)
    try:
        build_contention(s, bulk_kernels=3, latency_streams=2, per_stream=3,
                         n=1 << 10)
        _verify_and_report(s, "scenario contention", violations)
        s.sync()
    finally:
        s.shutdown()
    s = make_scheduler("parallel", simulate=True)
    try:
        build_slo_workload(s, bulk_units=6, latency_chains=2, per_chain=2)
        _verify_and_report(s, "scenario slo", violations)
        s.sync()
    finally:
        s.shutdown()
    print(f"verify-plan: contention+slo: "
          f"{'OK' if not violations else 'VIOLATIONS'}")

    # A tiny real-executor episode keeps the non-sim path honest.
    s = make_scheduler("parallel", device=args.device)
    try:
        from repro_torch.benchsuite import kernels as K
        x = s.array(np.linspace(0.5, 1.5, 256, dtype=np.float32), name="vx")
        y = s.array(shape=(256,), dtype=np.float32, name="vy")
        z = s.array(shape=(1,), dtype=np.float32, name="vz")
        K.SQUARE.with_options(scheduler=s)(x, y)
        K.L2_NORM.with_options(scheduler=s)(y, z)
        float(z[0])
        _verify_and_report(s, "scenario real-executor", violations)
        s.sync()
    finally:
        s.shutdown()

    for v in violations:
        print(f"verify-plan: VIOLATION {v}", file=sys.stderr)
    print(f"verify-plan: {len(violations)} violation(s)")
    return 1 if violations else 0


# ----------------------------------------------------------------------
def cmd_audit_journal(args) -> int:
    from .journal import audit_journal

    bad = 0
    for path in args.paths:
        audit = audit_journal(path)
        if args.json:
            json.dump(audit.to_json(), sys.stdout, indent=2, sort_keys=True)
            sys.stdout.write("\n")
        else:
            print(f"audit: {path}: {audit.records} record(s), "
                  f"{audit.jobs} job(s), "
                  f"{'torn tail, ' if audit.torn_tail else ''}"
                  f"{'OK' if audit.ok else 'PROBLEMS'}")
            for note in audit.notes:
                print(f"    note: {note}")
            for p in audit.problems:
                print(f"    problem: {p}")
        bad += 0 if audit.ok else 1
    return 1 if bad else 0


# ----------------------------------------------------------------------
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro-torch-analysis",
        description="Static analysis for the PyTorch runtime: access-mode "
                    "lint, DAG/plan race verification, journal audits.")
    sub = p.add_subparsers(dest="cmd", required=True)

    lint = sub.add_parser("lint", help="check declared access modes "
                                       "against actual kernel behavior")
    lint.add_argument("--module", action="append",
                      help="extra module to import for declarations")
    lint.add_argument("--file", action="append",
                      help="extra python file to import (e.g. an example)")
    lint.add_argument("--json", action="store_true")

    vp = sub.add_parser("verify-plan",
                        help="verify live DAGs and captured plans over "
                             "the benchsuite scenarios")
    vp.add_argument("--scale", type=float, default=0.001,
                    help="benchsuite problem scale (default tiny)")
    vp.add_argument("--device", default="cuda",
                    help="device of the real-executor episode's lanes "
                         "(default cuda; cpu where there is no card)")

    aj = sub.add_parser("audit-journal",
                        help="audit daemon JSONL job journals")
    aj.add_argument("paths", nargs="+", help="journal file(s)")
    aj.add_argument("--json", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    if args.cmd == "lint":
        rc = cmd_lint(args)
    elif args.cmd == "verify-plan":
        rc = cmd_verify_plan(args)
    else:
        rc = cmd_audit_journal(args)
    print(f"repro-torch-analysis: {args.cmd} finished in "
          f"{time.perf_counter() - t0:.2f}s (exit {rc})")
    return rc


if __name__ == "__main__":       # pragma: no cover
    raise SystemExit(main())
