"""Job registry — the named programs an out-of-process client may run.

Clients cannot ship Python callables over a socket; they name a registered
*job kind* plus JSON parameters, and the daemon executes the handler against
the shared scheduler through the ordinary ambient-runtime frontend.  Every
handler must be deterministic given its params (the end-to-end tests compare
daemon results bit-identically against in-process execution) and must return
a JSON-serializable result.

Handlers receive a :class:`JobContext` and should call
:meth:`JobContext.checkpoint` at element boundaries: that is where
cooperative pause (RUNNING -> PAUSED -> RUNNING) and cancellation
(-> CANCELLED) take effect — the daemon never interrupts a handler
mid-kernel, mirroring the scheduler's element-boundary preemption.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.frontend import function, runtime

REGISTRY: Dict[str, Callable] = {}


class JobCancelled(Exception):
    """Raised inside a handler when its job was cancelled at a checkpoint."""


class JobContext:
    """What a handler sees: the shared scheduler + cooperative control.

    ``pause_event`` set = run freely; cleared = pause at next checkpoint.
    The daemon's pause/resume ops (and, optionally, the admission policy on
    a spike) drive it; ``on_pause``/``on_resume`` are server callbacks that
    journal the RUNNING<->PAUSED transitions."""

    def __init__(self, scheduler, job_id: str = "", *,
                 tenant: str = "default", priority: int = 0,
                 deadline_s: Optional[float] = None) -> None:
        self.scheduler = scheduler
        self.job_id = job_id
        self.tenant = tenant
        self.priority = priority
        self.deadline_s = deadline_s
        self.pause_event = threading.Event()
        self.pause_event.set()
        self.cancel_requested = False
        self.checkpoints = 0
        self.paused_times = 0
        self.on_pause: Optional[Callable[[], None]] = None
        self.on_resume: Optional[Callable[[], None]] = None

    def checkpoint(self) -> None:
        """Cooperative yield point between scheduler launches."""
        self.checkpoints += 1
        if self.cancel_requested:
            raise JobCancelled(self.job_id)
        if not self.pause_event.is_set():
            self.paused_times += 1
            if self.on_pause is not None:
                self.on_pause()
            self.pause_event.wait()
            if self.on_resume is not None:
                self.on_resume()
            if self.cancel_requested:
                raise JobCancelled(self.job_id)

    def options(self) -> dict:
        """QoS tags every launch issued on behalf of this job carries."""
        out: dict = {"tenant": self.tenant, "priority": self.priority}
        if self.deadline_s is not None:
            out["deadline_s"] = self.deadline_s
        return out


def job_handler(name: str):
    """Register ``fn(ctx, **params) -> json`` as job kind ``name``."""
    def deco(fn: Callable) -> Callable:
        REGISTRY[name] = fn
        return fn
    return deco


def run_job(scheduler, kind: str, params: Optional[dict] = None, *,
            ctx: Optional[JobContext] = None) -> Any:
    """Execute one job kind against ``scheduler`` (daemon and in-process
    paths share this entry point, which is what makes the bit-identical
    comparison meaningful)."""
    try:
        handler = REGISTRY[kind]
    except KeyError:
        raise ValueError(f"unknown job kind {kind!r}; registered: "
                         f"{sorted(REGISTRY)}") from None
    if ctx is None:
        ctx = JobContext(scheduler)
    return handler(ctx, **(params or {}))


# ======================================================================
# Built-in job kinds
# ======================================================================

# The chain job's kernels, declared once at import (torch is already loaded
# with the port's core, so nothing is gained by deferring them).
_CHAIN_STEP = function(
    lambda x, _o: x * x * 0.5 + 0.25 * x + 0.125,
    modes=("const", "out"), outputs=0, name="daemon_chain_step")
_CHAIN_RED = function(
    lambda x, _o: torch.stack([x.sum(), x.abs().max()]),
    modes=("const", "out"), outputs=((2,), np.float32),
    name="daemon_chain_red")


@job_handler("chain")
def chain_job(ctx: JobContext, *, n: int = 4, size: int = 8192,
              seed: int = 0, digest: bool = False) -> dict:
    """``n`` dependent kernels over a seeded random vector.

    Deterministic: input from ``default_rng(seed)``, torch ops on the
    scheduler's lanes.  Returns the reduction pair plus either the full
    value list (small sizes) or a sha256 digest — both compare
    bit-identically across daemon/in-process runs on one device."""
    step, red = _CHAIN_STEP, _CHAIN_RED
    opts = ctx.options()
    x = np.random.default_rng(int(seed)).standard_normal(
        int(size)).astype(np.float32)
    with runtime(scheduler=ctx.scheduler):
        a = ctx.scheduler.array(x, name=f"chain_{ctx.job_id or seed}")
        for _ in range(int(n)):
            a = step(a, **opts)
            ctx.checkpoint()
        r = red(a, **opts)
        values = np.asarray(a)          # host read syncs only this chain
        summary = np.asarray(r)
    out = {"sum": float(summary[0]), "absmax": float(summary[1])}
    if digest or int(size) > 4096:
        out["sha256"] = hashlib.sha256(values.tobytes()).hexdigest()
    else:
        out["values"] = [float(v) for v in values]
    return out


@job_handler("sleep")
def sleep_job(ctx: JobContext, *, total_s: float = 0.05,
              steps: int = 5) -> dict:
    """Pure host work in ``steps`` checkpointed slices — the test/bench
    workhorse for queueing, pause/resume, cancel and crash recovery."""
    steps = max(1, int(steps))
    for _ in range(steps):
        time.sleep(float(total_s) / steps)
        ctx.checkpoint()
    return {"slept_s": float(total_s), "checkpoints": ctx.checkpoints}


@job_handler("noop")
def noop_job(ctx: JobContext, **params) -> dict:
    """Echo job: the socket round-trip smoke test."""
    return {"echo": params}


@job_handler("serve_lm")
def serve_lm_job(ctx: JobContext, *, arch: str = "qwen2_moe_a2_7b",
                 requests: int = 4, prompt_len: int = 16,
                 new_tokens: int = 4, batch_size: int = 2,
                 seed: int = 0) -> dict:
    """Daemon-backed serving: run a reduced LM ServingEngine *inside* the
    resident runtime and pump ``requests`` greedy generations through it.

    This is the out-of-process submit path for ``runtime/serving.py`` — a
    client process gets batched, capture-replayed inference from the shared
    daemon scheduler without linking torch or the model itself.  The model
    and the engine live on the scheduler's executor device
    (``ThreadLaneExecutor.device``); the weights are drawn from
    ``torch.Generator(device).manual_seed(seed)``.  A simulated scheduler
    has no device, and the job raises there rather than pick the CPU."""
    from ..configs import get_config
    from ..models import init_lm
    from ..runtime.serving import ServingEngine

    device = getattr(ctx.scheduler.executor, "device", None)
    if device is None:
        raise RuntimeError(
            "serve_lm needs a real executor's device; a simulated daemon "
            "has none (serve with --executor threads and --device cuda or "
            "cpu)")
    cfg = get_config(arch, reduced=True)
    model = init_lm(cfg, torch.Generator(device).manual_seed(int(seed)),
                    device)
    rng = np.random.RandomState(int(seed))
    # Plain attention, as the reference's engine serves: the reduced
    # configs' head dim (16) is not one the flash kernel takes.
    with ServingEngine(cfg, model, batch_size=int(batch_size),
                       max_new_tokens=int(new_tokens),
                       scheduler=ctx.scheduler, device=device,
                       use_flash=False) as eng:
        reqs = [eng.submit(rng.randint(0, cfg.vocab, int(prompt_len)),
                           tenant=ctx.tenant, priority=ctx.priority,
                           deadline_s=ctx.deadline_s)
                for _ in range(int(requests))]
        eng.flush(force=True)
        done = eng.collect()
        ctx.checkpoint()
    if len(done) != len(reqs):
        raise RuntimeError(f"serve_lm: {len(done)} of {len(reqs)} requests "
                           f"came back")
    return {"generations": [[int(t) for t in r.result] for r in reqs],
            "tenant_stats": eng.tenant_stats().get(ctx.tenant, {})}
