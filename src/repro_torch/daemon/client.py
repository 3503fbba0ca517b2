"""DaemonClient — thin, thread-safe handle to a running daemon socket.

One persistent connection, lazily opened, with a lock serializing
request/response pairs (the wire protocol is strictly one-in one-out per
connection).  Raises :class:`DaemonError` on server-reported errors so
callers don't have to inspect ``ok`` flags.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Optional

from .wire import recv_msg, send_msg


class DaemonError(RuntimeError):
    """Server-side failure, connection loss, or shed/timeout the caller
    asked to treat as an error."""

    def __init__(self, message: str, response: Optional[dict] = None) -> None:
        super().__init__(message)
        self.response = response or {}


class DaemonClient:
    def __init__(self, socket_path: str, *,
                 connect_timeout: float = 5.0) -> None:
        self.socket_path = socket_path
        self.connect_timeout = float(connect_timeout)
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def _connect(self) -> socket.socket:
        deadline = time.monotonic() + self.connect_timeout
        last: Optional[OSError] = None
        while time.monotonic() < deadline:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.connect(self.socket_path)
                return s
            except OSError as exc:      # daemon still binding, or gone
                last = exc
                s.close()
                time.sleep(0.05)
        raise DaemonError(f"cannot connect to daemon at "
                          f"{self.socket_path!r}: {last}")

    def request(self, op: str, **kw) -> dict:
        """One request/response round trip; raises on ``ok: false``."""
        req = {"op": op, **kw}
        with self._lock:
            if self._sock is None:
                self._sock = self._connect()
            try:
                send_msg(self._sock, req)
                resp = recv_msg(self._sock)
            except OSError as exc:
                self.close()
                raise DaemonError(f"daemon connection lost: {exc}") from exc
            if resp is None:
                self.close()
                raise DaemonError("daemon closed the connection")
        if not resp.get("ok", False) and not resp.get("shed"):
            raise DaemonError(resp.get("error") or f"op {op!r} failed",
                              response=resp)
        return resp

    def close(self) -> None:
        s, self._sock = self._sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def __enter__(self) -> "DaemonClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # Convenience ops
    # ------------------------------------------------------------------
    def ping(self) -> dict:
        return self.request("ping")

    def submit(self, kind: str, params: Optional[dict] = None, *,
               tenant: str = "default", priority: int = 0,
               deadline_s: Optional[float] = None,
               error_on_shed: bool = False) -> dict:
        """Submit a job; returns the server response (check ``shed``)."""
        resp = self.request("submit", job={
            "kind": kind, "params": params or {}, "tenant": tenant,
            "priority": priority, "deadline_s": deadline_s})
        if resp.get("shed") and error_on_shed:
            raise DaemonError(resp.get("reason", "job shed"), response=resp)
        return resp

    def status(self, job_id: str) -> dict:
        return self.request("status", job_id=job_id)["job"]

    def wait(self, job_id: str, timeout: float = 60.0) -> dict:
        """Block until the job is terminal; returns the final job record.
        Raises :class:`DaemonError` on timeout."""
        resp = self.request("wait", job_id=job_id, timeout=timeout)
        if resp.get("timed_out"):
            raise DaemonError(f"timed out waiting for {job_id}",
                              response=resp)
        return resp["job"]

    def result(self, job_id: str, timeout: float = 60.0) -> dict:
        """Wait, then return the FINISHED job's result; raises if the job
        ended FAILED or CANCELLED."""
        job = self.wait(job_id, timeout=timeout)
        if job["state"] != "finished":
            raise DaemonError(f"job {job_id} ended {job['state']}: "
                              f"{job.get('reason', '')}", response=job)
        return job["result"]

    def cancel(self, job_id: str) -> dict:
        return self.request("cancel", job_id=job_id)

    def pause(self, job_id: str) -> dict:
        return self.request("pause", job_id=job_id)

    def resume(self, job_id: str) -> dict:
        return self.request("resume", job_id=job_id)

    def jobs(self) -> list:
        return self.request("jobs")["jobs"]

    def stats(self, *, scheduler: bool = True) -> dict:
        return self.request("stats", scheduler=scheduler)

    def drain(self, timeout: float = 30.0) -> dict:
        return self.request("drain", timeout=timeout)

    def resume_admission(self) -> dict:
        return self.request("resume_admission")

    def shutdown(self, *, drain: bool = True) -> dict:
        return self.request("shutdown", drain=drain)
