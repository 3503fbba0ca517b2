"""``python -m repro_torch.daemon``: serve | submit | status | wait |
cancel | pause | resume | jobs | stats | drain | shutdown.

The default socket and store live under the system temp dir so two shells
on one machine talk to the same daemon with zero flags.  ``serve`` runs the
scheduler's lanes on ``--device`` (``cuda`` unless asked otherwise; without
a card the threads executor raises, it never falls back to the host):

    python -m repro_torch.daemon serve &
    python -m repro_torch.daemon submit chain -p n=4 -p size=1024 --wait
    python -m repro_torch.daemon stats
    python -m repro_torch.daemon shutdown

On a machine without a card, ``serve --device cpu`` runs the lanes on the
host and ``serve --executor sim`` on the simulator.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Optional


def default_socket_path() -> str:
    return os.environ.get(
        "REPRO_DAEMON_SOCKET",
        os.path.join(tempfile.gettempdir(), f"repro-daemon-{os.getuid()}.sock"))


def default_store_path() -> str:
    return os.environ.get(
        "REPRO_DAEMON_STORE",
        os.path.join(tempfile.gettempdir(),
                     f"repro-daemon-{os.getuid()}.jobs.jsonl"))


def _parse_params(pairs) -> dict:
    """``-p key=value`` with JSON-decoded values (bare words stay strings)."""
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"bad -p {pair!r}: expected key=value")
        k, v = pair.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro-torch-daemon",
        description="Out-of-process job service for the GrScheduler runtime "
                    "of the PyTorch port.")
    p.add_argument("--socket", default=default_socket_path(),
                   help="Unix domain socket path (env REPRO_DAEMON_SOCKET)")
    sub = p.add_subparsers(dest="cmd", required=True)

    serve = sub.add_parser("serve", help="run the daemon in the foreground")
    serve.add_argument("--store", default=default_store_path(),
                       help="job journal path (env REPRO_DAEMON_STORE)")
    serve.add_argument("--workers", type=int, default=2,
                       help="dispatcher threads")
    serve.add_argument("--devices", type=int, default=2,
                       help="scheduler device lanes")
    serve.add_argument("--executor", default="threads",
                       choices=["threads", "sim"], help="scheduler executor")
    serve.add_argument("--device", default="cuda",
                       help="where the threads executor's lanes run "
                            "(cuda streams, or cpu when asked for)")
    serve.add_argument("--mem-budget", type=float, default=None,
                       help="per-device memory budget in bytes")
    serve.add_argument("--monitor-interval", type=float, default=0.05,
                       help="monitor sample period (s)")
    serve.add_argument("--max-queue-depth", type=int, default=64)
    serve.add_argument("--spike-shed-depth", type=int, default=8)
    serve.add_argument("--shed-below-priority", type=int, default=1)
    serve.add_argument("--max-running", type=int, default=8)
    serve.add_argument("--mem-high-watermark", type=float, default=0.97)
    serve.add_argument("--spike-factor", type=float, default=3.0)
    serve.add_argument("--spike-floor", type=float, default=4.0,
                       help="queue-depth spike floor (jobs)")
    serve.add_argument("--rate-floor", type=float, default=None,
                       help="arrival-rate spike floor (jobs/s; "
                            "default 4x the depth floor)")
    serve.add_argument("--cooldown", type=float, default=0.5,
                       help="cooldown window after a spike (s)")

    sb = sub.add_parser("submit", help="submit one job")
    sb.add_argument("kind", help="registered job kind (chain, sleep, ...)")
    sb.add_argument("-p", "--param", action="append", dest="params",
                    metavar="KEY=VALUE", help="job parameter (JSON value)")
    sb.add_argument("--tenant", default="default")
    sb.add_argument("--priority", type=int, default=0)
    sb.add_argument("--deadline", type=float, default=None,
                    help="deadline in seconds from submission")
    sb.add_argument("--wait", action="store_true",
                    help="block until the job is terminal, print the result")
    sb.add_argument("--timeout", type=float, default=120.0)

    for name, hlp in [("status", "print one job record"),
                      ("wait", "block until a job is terminal"),
                      ("cancel", "cancel a queued or running job"),
                      ("pause", "pause a running job at its next checkpoint"),
                      ("resume", "resume a paused job")]:
        q = sub.add_parser(name, help=hlp)
        q.add_argument("job_id")
        if name == "wait":
            q.add_argument("--timeout", type=float, default=120.0)

    jb = sub.add_parser("jobs", help="list all jobs in the store")
    jb.add_argument("--audit", action="store_true",
                    help="audit the job journal offline (no daemon needed): "
                         "replay it through the lifecycle state machine and "
                         "exit non-zero on any illegal history")
    jb.add_argument("--store", default=default_store_path(),
                    help="journal path for --audit (env REPRO_DAEMON_STORE)")
    st = sub.add_parser("stats", help="print daemon + scheduler stats")
    st.add_argument("--no-scheduler", action="store_true",
                    help="skip the scheduler stats block")
    dr = sub.add_parser("drain", help="stop dispatching, wait for running")
    dr.add_argument("--timeout", type=float, default=30.0)
    sd = sub.add_parser("shutdown", help="stop the daemon")
    sd.add_argument("--no-drain", action="store_true",
                    help="do not wait for running jobs")
    sub.add_parser("ping", help="liveness check")
    return p


def _serve(args) -> int:
    from .monitor import RuntimeMonitor
    from .policy import AdmissionPolicy
    from .server import DaemonServer

    sched_kw = {"num_devices": args.devices,
                "simulate": args.executor == "sim", "device": args.device}
    if args.mem_budget is not None:
        sched_kw["memory_budget"] = args.mem_budget
    policy = AdmissionPolicy(
        max_queue_depth=args.max_queue_depth,
        spike_shed_depth=args.spike_shed_depth,
        shed_below_priority=args.shed_below_priority,
        max_running=args.max_running,
        mem_high_watermark=args.mem_high_watermark)
    server = DaemonServer(
        args.socket, store_path=args.store, sched_kw=sched_kw, policy=policy,
        workers=args.workers,
        monitor=RuntimeMonitor(interval_s=args.monitor_interval,
                               spike_factor=args.spike_factor,
                               spike_floor=args.spike_floor,
                               rate_floor=args.rate_floor,
                               cooldown_s=args.cooldown),
        monitor_interval_s=args.monitor_interval)
    print(f"repro-torch-daemon: serving on {args.socket} "
          f"(store {args.store}, pid {os.getpid()})", flush=True)
    server.serve_forever()
    return 0


def _emit(obj) -> None:
    json.dump(obj, sys.stdout, indent=2, sort_keys=True)
    sys.stdout.write("\n")


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "serve":
        return _serve(args)
    if args.cmd == "jobs" and args.audit:
        # Offline journal audit: reads the JSONL directly, never connects.
        from ..analysis.journal import audit_journal
        audit = audit_journal(args.store)
        _emit(audit.to_json())
        return 0 if audit.ok else 1

    from .client import DaemonClient, DaemonError
    client = DaemonClient(args.socket)
    try:
        if args.cmd == "submit":
            resp = client.submit(args.kind, _parse_params(args.params),
                                 tenant=args.tenant, priority=args.priority,
                                 deadline_s=args.deadline)
            if resp.get("shed"):
                _emit(resp)
                return 3
            if args.wait:
                _emit(client.wait(resp["job_id"], timeout=args.timeout))
            else:
                _emit(resp)
        elif args.cmd == "status":
            _emit(client.status(args.job_id))
        elif args.cmd == "wait":
            _emit(client.wait(args.job_id, timeout=args.timeout))
        elif args.cmd == "cancel":
            _emit(client.cancel(args.job_id))
        elif args.cmd == "pause":
            _emit(client.pause(args.job_id))
        elif args.cmd == "resume":
            _emit(client.resume(args.job_id))
        elif args.cmd == "jobs":
            _emit(client.jobs())
        elif args.cmd == "stats":
            _emit(client.stats(scheduler=not args.no_scheduler))
        elif args.cmd == "drain":
            _emit(client.drain(timeout=args.timeout))
        elif args.cmd == "shutdown":
            _emit(client.shutdown(drain=not args.no_drain))
        elif args.cmd == "ping":
            _emit(client.ping())
        return 0
    except DaemonError as exc:
        print(f"repro-torch-daemon: error: {exc}", file=sys.stderr)
        return 2
    finally:
        client.close()


if __name__ == "__main__":
    raise SystemExit(main())
