"""GrScheduler — the user-facing runtime (paper §IV-B, Fig. 5).

The *GPU execution context* of the paper: tracks declarations/invocations of
computational elements, updates the DAG with inferred dependencies, asks the
stream manager for a lane, and submits to an executor.  Two policies:

* ``serial``  — the original GrCUDA scheduler: synchronous, in-order, no
  overlap, no dependency computation (baseline of Fig. 7);
* ``parallel`` — this paper: asynchronous, dependency-driven, lanes + events,
  automatic prefetch of host-resident arguments.

Host reads/writes of managed arrays synchronize only against the in-flight
computations that actually touch the data (§IV-B), then retire the observed
sub-DAG from the frontier.
"""
from __future__ import annotations

import itertools
import threading
import warnings
from typing import Callable, List, Mapping, Optional, Sequence

import numpy as np

from .capture import CaptureContext, ExecutionPlan, PlanCache, replay_plan
from .dag import ComputationDAG
from .deadlines import DeadlineMonitor
from .dtypes import to_numpy
from .element import (Arg, ComputationalElement, DEFAULT_TENANT, ElementKind,
                      ElementState, const, dep_key, inout, out)
from .executor import Executor, SimExecutor, SimHardware, ThreadLaneExecutor
from .managed import ManagedArray
from .memory import Budget, MemoryManager
from .streams import NewStreamPolicy, ParentStreamPolicy, StreamManager
from .submission import SubmissionPipeline
from .timeline import Timeline

# A replayed plan is submitted with a single reduced launch overhead — the
# cudaGraphLaunch analogue: roughly one hardware kernel-launch, however many
# elements the plan contains.
_PLAN_LAUNCH_OVERHEAD_S = 5e-6


class GrScheduler:
    def __init__(self,
                 policy: str = "parallel",
                 executor: Optional[Executor] = None,
                 new_stream_policy: NewStreamPolicy = NewStreamPolicy.FIFO_REUSE,
                 parent_stream_policy: ParentStreamPolicy = ParentStreamPolicy.FIRST_CHILD_INHERITS,
                 auto_prefetch: bool = True,
                 launch_overhead_s: Optional[float] = None,
                 plan_launch_overhead_s: Optional[float] = None,
                 max_lanes: Optional[int] = None,
                 num_devices: int = 1,
                 placement: str = "round-robin",
                 tenant_quotas: Optional[Mapping[str, int]] = None,
                 memory_budget: Budget = None,
                 spill_tiers: Optional[Sequence] = None,
                 plan_optimize: bool = True,
                 slo_targets: Optional[Mapping[str, float]] = None,
                 sanitize: bool = False,
                 device: str = "cuda",
                 trace: bool = False) -> None:
        assert policy in ("serial", "parallel")
        self.policy = policy
        self.num_devices = max(1, num_devices)
        self.executor = executor or ThreadLaneExecutor(
            num_devices=self.num_devices, device=device)
        # Layer-span records join the timeline's spans only when traced;
        # their counts and seconds (``stats()["spans"]``) are always kept.
        self.executor.timeline.trace = bool(trace)
        self.dag = ComputationDAG()
        # Per-device byte budgets (None = unlimited): the MemoryManager owns
        # resident-set accounting and every logical location-bit flip; the
        # pipeline's reserve stage spills LRU victims when a budget is hit.
        # ``spill_tiers`` is the ordered backing-tier stack (tiers.py) dirty
        # victims fall through; empty/None keeps the flat D2H spill bit for
        # bit.
        self.memory = MemoryManager(self.num_devices, memory_budget,
                                    tiers=spill_tiers)
        self.streams = StreamManager(new_stream_policy, parent_stream_policy,
                                     max_lanes=max_lanes,
                                     num_devices=self.num_devices,
                                     placement=placement,
                                     tenant_quotas=tenant_quotas)
        self.streams.memory = self.memory
        self.auto_prefetch = auto_prefetch
        if launch_overhead_s is None:
            launch_overhead_s = 5e-6 if policy == "parallel" else 1e-6
        self.launch_overhead_s = launch_overhead_s
        if plan_launch_overhead_s is None:
            plan_launch_overhead_s = min(launch_overhead_s,
                                         _PLAN_LAUNCH_OVERHEAD_S)
        self.plan_launch_overhead_s = plan_launch_overhead_s
        self.d2d_transfers = 0
        self._elements: List[ComputationalElement] = []
        self._tune_counts: dict = {}
        # Explicit, lock-protected submission path (place -> prefetch/D2D ->
        # DAG-add -> lane-assign -> submit): multiple client threads may
        # call launch()/host_read()/host_write()/sync() concurrently.
        self.pipeline = SubmissionPipeline(self)
        # Graph capture & replay (capture.py): cached execution plans plus
        # the at-most-one active capture context.  ``plan_optimize`` runs the
        # plan-time global optimizer (planopt.py: min-cut placement + Belady
        # memory scheduling) once at capture finalization; False keeps the
        # greedy trace bit for bit.
        self.plan_cache = PlanCache()
        self.plan_optimize = plan_optimize
        self._capture: Optional[CaptureContext] = None
        # Deadline/SLO-aware scheduling (deadlines.py): per-tenant SLO
        # targets auto-stamp deadlines on launches; the monitor owns the
        # slack estimator and element-boundary preemption.  All hooks
        # early-out while no deadline exists, so deadline-free schedules
        # stay bit-identical.
        self.deadlines = DeadlineMonitor(self, slo_targets)
        self.deadlines.full_boundary_checks = not self.executor.concurrent_waits
        self.executor.on_boundary = self.deadlines.on_boundary
        self.executor.on_stall = self.deadlines.ensure_progress
        # Host-access ordering log for the happens-before verifier: each
        # entry is ``(position, host_element)`` recorded once the host wait
        # completed — the host element orders after its parents and before
        # everything submitted from ``position`` on.  Cleared with
        # ``_elements`` at every full sync; cheap enough to keep always-on.
        self._host_log: List[tuple] = []
        # Sanitizer runtime mode (repro_torch.analysis): version-vector race
        # detection at element boundaries.  Off by default — with
        # ``sanitize=False`` no hook is installed and scheduling is
        # bit-identical.
        self.sanitize = bool(sanitize)
        self.sanitizer = None
        if self.sanitize:
            from ..analysis.sanitizer import Sanitizer
            self.sanitizer = Sanitizer(
                checksums=not isinstance(self.executor, SimExecutor))
            self.executor.pre_exec = self.sanitizer.pre_exec
            self.executor.post_exec = self.sanitizer.post_exec
        self._closed = False

    # ------------------------------------------------------------------
    def array(self, data=None, *, shape=None, dtype=np.float32,
              name: str = "") -> ManagedArray:
        return ManagedArray(self, data, shape=shape, dtype=dtype, name=name)

    # ------------------------------------------------------------------
    def _mark_host_done(self, e: ComputationalElement) -> None:
        if isinstance(self.executor, SimExecutor):
            self.executor._end[e.uid] = self.executor.host_time
        else:
            ev = threading.Event()
            ev.set()
            e.done_event = ev
        e.state = ElementState.DONE
        e.t_start = e.t_end = self.executor.host_now()

    def _schedule(self, e: ComputationalElement) -> None:
        """DAG insert + lane assignment + submission (parallel policy).

        Thin alias kept for backward compatibility; the staged path lives in
        :class:`~repro.core.submission.SubmissionPipeline`."""
        self.pipeline.schedule(e)

    # ------------------------------------------------------------------
    def launch(self, fn: Optional[Callable], args: Sequence[Arg], *,
               name: str = "", cost_s: float = 0.0,
               tune: Optional[dict] = None,
               priority: int = 0, tenant: str = DEFAULT_TENANT,
               deadline_s: Optional[float] = None,
               **config) -> ComputationalElement:
        """Deprecated shim over the submission engine (:meth:`_launch`).

        Per-call ``const/out/inout`` annotation is exactly the expert burden
        the paper's polyglot API removes — declare a :class:`GrFunction`
        once via ``repro.api.function`` (access modes, cost model and tuning
        space live with the declaration) and call it like a plain function.
        The shim stays for at least two more releases so downstream callers
        and the tier-1 tests keep working; see README "Migrating from
        ``s.launch``".
        """
        warnings.warn(
            "GrScheduler.launch is deprecated: declare the kernel once with "
            "repro.api.function(fn, modes=...) and call the GrFunction "
            "directly", DeprecationWarning, stacklevel=2)
        return self._launch(fn, args, name=name, cost_s=cost_s, tune=tune,
                            priority=priority, tenant=tenant,
                            deadline_s=deadline_s, **config)

    def _launch(self, fn: Optional[Callable], args: Sequence[Arg], *,
                name: str = "", cost_s: float = 0.0,
                tune: Optional[dict] = None,
                priority: int = 0, tenant: str = DEFAULT_TENANT,
                device: Optional[int] = None,
                fn_key: Optional[int] = None,
                deadline_s: Optional[float] = None,
                **config) -> ComputationalElement:
        """Submission engine: issue one kernel, dependencies & lane inferred.

        This is the single path behind ``GrFunction.__call__`` (and the
        deprecated ``launch`` shim).  ``tune={"param": [candidates...]}``
        enables the paper's §VI heuristic: explore each candidate launch
        config round-robin, then exploit the historically fastest
        (per-kernel history, §IV-A).

        ``priority``/``tenant`` tag the element (and its auto-inserted
        transfers) for multi-tenant QoS: priority weights contended device
        capacity and steers lane selection; tenant drives per-tenant stats
        and optional lane quotas.  ``device`` pins placement to one device
        (bypassing the placement policy); ``fn_key`` is the declared-function
        identity capture plans are keyed by.  Thread-safe — concurrent
        submitters serialize on the scheduler's submission pipeline.
        """
        with self.timeline.span("sched.launch"), self.pipeline:
            if tune:
                config = dict(config, **self._tune(name, tune))
            if device is not None:
                # Clamp before capture matching: plans record the *clamped*
                # placement, so an out-of-range pin must present the same
                # value or identical episodes would re-record forever.
                device = min(max(0, int(device)), self.num_devices - 1)
            cap = self._capture
            if cap is not None:
                replayed = cap.offer(fn, tuple(args), name, config, cost_s,
                                     priority=priority, tenant=tenant,
                                     device=device, fn_key=fn_key,
                                     deadline_s=deadline_s)
                if replayed is not None:
                    return replayed     # plan hit: submitted via the fast path
            e = ComputationalElement(fn=fn, args=tuple(args),
                                     kind=ElementKind.KERNEL, name=name,
                                     config=config, cost_s=cost_s,
                                     priority=priority, tenant=tenant,
                                     fn_key=fn_key, deadline_s=deadline_s)
            if device is not None:
                e.device = device       # clamped by the pipeline's run stage
                e.device_pinned = True  # plan optimizer must not move it
            # Stamp the absolute deadline (explicit or tenant-SLO) before
            # the pipeline runs, so auto-inserted transfer children inherit
            # the same EDF rank.
            self.deadlines.tag(e)
            if self.policy == "parallel":
                self.pipeline.run(e)
            else:
                e.device = 0 if e.device is None else e.device
                self.pipeline.reserve(e)
                if self.auto_prefetch:
                    self.pipeline.prefetch(e.args, priority=priority,
                                           tenant=tenant)
                self.pipeline.serial(e)
            # Logical location update at schedule time: the kernel's writable
            # outputs will live on device; host copies become stale.  Routed
            # through the MemoryManager so residency tracks the bits.
            dev = e.device if e.device is not None else 0
            for a in e.args:
                if a.mode.writes:
                    self.memory.note_device_write(a.array, dev)
            return e

    def _tune(self, name: str, tune: dict) -> dict:
        counts = self._tune_counts.setdefault(name, 0)
        keys = sorted(tune)
        grid = [dict(zip(keys, vals)) for vals in
                itertools.product(*(tune[k] for k in keys))]
        if counts < 2 * len(grid):      # exploration phase
            choice = grid[counts % len(grid)]
        else:                           # exploitation: fastest median config
            choice = self._coerce_best_config(name, keys, grid)
        self._tune_counts[name] = counts + 1
        return choice

    def _coerce_best_config(self, name: str, keys, grid) -> dict:
        """History stores config values stringified; coerce them back to the
        candidate types, falling back to the first grid point when history
        is empty or a value no longer parses as the candidate type."""
        best = self.executor.history.best_config(name)
        if not best:
            return grid[0]
        choice = {}
        for k, v in best.items():
            if k not in keys:
                continue
            try:
                choice[k] = type(grid[0][k])(v)
            except (TypeError, ValueError):
                return grid[0]
        return choice or grid[0]

    # ------------------------------------------------------------------
    # Host accesses (ManagedArray callbacks) — paper §IV-A/B
    # ------------------------------------------------------------------
    def _sync_against(self, ma: ManagedArray, writes: bool) -> None:
        with self.pipeline:
            deps = [d for d in self.dag.live_deps(dep_key(ma), writes)
                    if not d.is_host]
            if deps and self._capture is not None:
                self._capture.note_host_sync(deps)
            if not deps:
                return  # fast path: host access introduces no dependency (§IV-A)
            e = ComputationalElement(
                fn=None, args=(inout(ma) if writes else const(ma),),
                kind=ElementKind.HOST_ACCESS, name=f"host_{ma.name}")
            self.dag.add(e)
            t0 = self.executor.host_now()
            waits = [p for p in e.parents if not p.is_host]
            if not self.executor.concurrent_waits:
                for p in waits:     # sync only the lanes owning this data
                    self.executor.wait(p)
                waits = []
        # Real executor: block OUTSIDE the pipeline lock — a tenant waiting
        # on its own slow kernel must not stall other tenants' launches
        # (priority inversion).  wait() is a pure completion-event wait and
        # the post-wait retire/release below are idempotent under the
        # re-acquired lock, so a concurrent sync() racing us is harmless.
        for p in waits:
            self.executor.wait(p)
        with self.pipeline:
            self.dag.retire(e)
            for p in e.parents:
                self.streams.release(p)
            self._mark_host_done(e)
            # Verifier ordering log: this host access completed before any
            # element at position >= len(_elements) was submitted.
            self._host_log.append((len(self._elements), e))
            self.executor.record_host_span(e, t0, self.executor.host_now())

    def _sync_and_localize(self, ma: ManagedArray, writes: bool) -> None:
        """Synchronize against the array's frontier, then (under the lock)
        refresh its host copy.  Because _sync_against may wait with the lock
        released, another tenant can slip a new writer in before the D2H —
        copying then would tear the host buffer and mask the newer device
        data behind host_valid=True, an outcome no serialization of the two
        accesses could produce.  Re-validate the frontier under the lock and
        re-sync until the gap stays clean."""
        while True:
            self._sync_against(ma, writes=writes)
            with self.pipeline:
                if self.dag.has_device_frontier(dep_key(ma), writes):
                    continue    # a racing launch re-dirtied the array
                if ma.device_valid and not ma.host_valid:
                    self._d2h(ma)
                elif getattr(ma, "backing_tier", None) is not None:
                    self._tier_restore(ma)
                return

    def host_read(self, ma: ManagedArray) -> None:
        self._sync_and_localize(ma, writes=False)

    def host_write(self, ma: ManagedArray) -> None:
        with self.pipeline:
            if self._capture is not None:
                # A host write flips the array's logical location in a way a
                # replaying plan cannot see (eager would re-prefetch the new
                # host data); the capture context demotes the rest of the
                # episode to eager execution when the array is plan-bound.
                self._capture.note_host_write(ma)
        # D2H before the write: read-modify-write safety for partial updates.
        self._sync_and_localize(ma, writes=True)

    def _d2h(self, ma: ManagedArray) -> None:
        ex = self.executor
        if isinstance(ex, SimExecutor):
            t0 = ex.host_time
            ex.host_time += ma.nbytes / (ex.hw.d2h_gbps * 1e9)
            ex._advance_to(ex.host_time)
            ex.timeline.record(-1, f"d2h_{ma.name}", "d2h", None, t0, ex.host_time)
        else:
            t0 = ex.host_now()
            ma.host = to_numpy(ma.device)
            ex.timeline.record(-1, f"d2h_{ma.name}", "d2h", None, t0, ex.host_now())
        ma.host_valid = True

    def _tier_restore(self, ma: ManagedArray) -> None:
        """Host access to a block parked in a host-side tier: restore the
        host buffer synchronously (decompress / read the spool file) —
        no device hop.  The simulator charges the tier's restore cost."""
        tier = self.memory.tier_named(ma.backing_tier)
        if tier is None:        # stack reconfigured under a live block
            self.memory.note_tier_to_host(ma)
            return
        ex = self.executor
        if isinstance(ex, SimExecutor):
            t0 = ex.host_time
            ex.host_time += tier.host_restore_seconds(ma.nbytes)
            ex._advance_to(ex.host_time)
            ex.timeline.record(-1, f"tier_{tier.name}_{ma.name}", "d2h",
                               None, t0, ex.host_time)
        else:
            t0 = ex.host_now()
            tier.reload(ma)     # refreshes ma.host, drops the payload
            ex.timeline.record(-1, f"tier_{tier.name}_{ma.name}", "d2h",
                               None, t0, ex.host_now())
        self.memory.note_tier_to_host(ma)

    # ------------------------------------------------------------------
    # Graph capture & replay (capture.py, §V-D CUDA-Graphs analogue)
    # ------------------------------------------------------------------
    def capture(self, name: str) -> CaptureContext:
        """Enter a transparent capture/replay context.

        The first episode under ``name`` (per structural signature) runs
        eagerly and is traced into an :class:`ExecutionPlan`; later episodes
        that issue the identical launch sequence are replayed through the
        fast path, skipping DAG inference, lane assignment and per-element
        launch overhead.  Divergence invalidates the plan and the episode
        continues eagerly — capture never changes program semantics.  Under
        the serial policy the context is a no-op passthrough."""
        return CaptureContext(self, name)

    def replay(self, plan: ExecutionPlan,
               bindings: Optional[Mapping] = None
               ) -> List[ComputationalElement]:
        """Explicitly re-submit a captured plan with fresh arrays bound by
        slot name or index; unbound slots reuse the captured arrays."""
        if self.policy != "parallel":
            raise RuntimeError("replay requires the parallel policy")
        with self.pipeline:
            if self._capture is not None:
                raise RuntimeError("cannot replay inside a capture context")
            if not self.memory.plan_fits(plan.device_mem):
                from .memory import DeviceOutOfMemoryError
                raise DeviceOutOfMemoryError(
                    f"plan {plan.name!r} needs per-device peak bytes "
                    f"{dict(plan.device_mem)} but the current budgets are "
                    f"smaller; re-capture under the new budget instead")
            return replay_plan(self, plan, bindings)

    def optimize_plan(self, plan: ExecutionPlan) -> ExecutionPlan:
        """Explicitly re-run the plan-time global optimizer on a captured
        plan (``planopt.py``): min-cut placement refinement plus Belady
        memory scheduling.  Returns the rewritten plan (re-cached in place
        of the original) or ``plan`` itself when no strict improvement is
        possible.  Capture finalization already does this automatically
        when ``plan_optimize`` is on."""
        from .planopt import optimize_plan as _optimize
        with self.pipeline:
            new = _optimize(self, plan)
            if new is not plan:
                self.plan_cache.invalidate(plan)
                self.streams.unreserve(plan.key)
                for displaced in self.plan_cache.store(new):
                    self.streams.unreserve(displaced.key)
            return new

    # ------------------------------------------------------------------
    def sync(self) -> None:
        """Full barrier: host waits for every in-flight computation."""
        if self.executor.concurrent_waits:
            # Drain outside the pipeline lock (same priority-inversion guard
            # as _sync_against): one tenant's barrier must not freeze other
            # tenants' launches while device work finishes.  The locked
            # wait_all afterwards is near-instant unless new work raced in
            # during the drain — which the barrier then also covers.
            with self.pipeline:
                if self._capture is not None:
                    self._capture.note_host_sync(None)
                pending = list(self._elements)
            for e in pending:
                self.executor.wait(e)
        with self.pipeline:
            if self._capture is not None and not self.executor.concurrent_waits:
                self._capture.note_host_sync(None)
            self.executor.wait_all()
            self.dag.retire_all()
            for e in self._elements:
                self.streams.release(e)
            # Retired elements can never need another release; keeping them
            # made every later sync re-walk (and re-release) the whole
            # history — unbounded memory and O(n^2) cost in long-running
            # serving loops.
            self._elements.clear()
            self._host_log.clear()

    def verify(self, plans: bool = True) -> None:
        """Run the happens-before verifier (``repro_torch.analysis``) over
        the live element window, the DAG bookkeeping invariants and every
        cached plan; raises :class:`PlanVerificationError` on any
        violation."""
        from ..analysis.verifier import PlanVerificationError, verify_scheduler
        violations = verify_scheduler(self, plans=plans)
        if violations:
            raise PlanVerificationError("scheduler", violations)

    @property
    def timeline(self) -> Timeline:
        return self.executor.timeline

    def stats(self) -> dict:
        """One consistent counter snapshot, taken under the submission lock
        so a concurrent submitter (or the daemon's monitor loop) never reads
        torn values — e.g. an element counted in ``elements`` whose bytes
        have not yet landed in ``mem_resident``."""
        with self.pipeline:
            return {"policy": self.policy,
                    "elements": self.dag.num_elements,
                    "edges": self.dag.num_edges,
                    "d2d_transfers": self.d2d_transfers,
                    **self.pipeline.stats(),
                    **self.streams.stats(),
                    **self.executor.history.stats(),
                    **self.plan_cache.stats(),
                    **self.memory.stats(),
                    **self.deadlines.stats(),
                    **(self.sanitizer.stats() if self.sanitizer is not None
                       else {}),
                    **self.timeline.stats()}

    def tenant_stats(self) -> dict:
        """Per-tenant QoS metrics (makespan, queueing delay, completion
        latency p50/p99, and — for deadline'd tenants — SLO attainment)
        computed from the execution timeline.  Consistent under concurrent
        launches: the pipeline lock serializes against submitters, the
        timeline's own lock against lane workers recording completions."""
        with self.pipeline:
            return self.timeline.tenant_stats()

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Idempotent full shutdown: resume paused work, drain every
        in-flight computation, join the executor's worker threads, release
        spill-tier backing resources (spool directories, compressed
        payloads).  After close the scheduler must not be used."""
        if self._closed:
            return
        self._closed = True
        # Paused (preempted) work must drain before workers are stopped.
        self.deadlines.resume_all()
        try:
            self.sync()
        except Exception:
            pass            # best effort: close from an except path anyway
        self.executor.shutdown()
        self.memory.close()

    def shutdown(self) -> None:
        """Backward-compatible alias for :meth:`close`."""
        self.close()

    def __enter__(self) -> "GrScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ----------------------------------------------------------------------
def make_scheduler(policy: str = "parallel", *, simulate: bool = False,
                   hw: Optional[SimHardware] = None,
                   oracle: bool = False, num_devices: int = 1,
                   placement: str = "round-robin", device: str = "cuda",
                   **kw) -> GrScheduler:
    """Factory: real vs simulated executor; ``oracle=True`` emulates the
    hand-optimized CUDA-Graphs baseline of §V-D (full DAG known in advance →
    zero runtime scheduling overhead, unlimited dedicated streams).

    ``num_devices=N`` enables the multi-device runtime: the ``placement``
    policy ("round-robin" / "min-load" / "affinity") spreads kernels across
    devices and the scheduler inserts D2D copies for cross-device inputs.

    ``device`` is where the real executor's lanes run: ``"cuda"`` (one CUDA
    stream per lane) unless the caller asks for ``"cpu"``.  Without a card
    a ``"cuda"`` scheduler raises; it never falls back to the host.
    ``simulate=True`` needs no device.  ``trace=True`` keeps a record of
    every layer span on the timeline (see ``timeline.py``).
    """
    num_devices = max(1, num_devices)
    if simulate:
        if hw is None:
            hw = SimHardware(num_devices=num_devices)
        elif hw.num_devices < num_devices:
            from dataclasses import replace
            hw = replace(hw, num_devices=num_devices)
        ex: Executor = SimExecutor(hw)
    else:
        ex = ThreadLaneExecutor(num_devices=num_devices, device=device)
    if oracle:
        kw.setdefault("new_stream_policy", NewStreamPolicy.ALWAYS_NEW)
        kw.setdefault("launch_overhead_s", 0.0)
    return GrScheduler(policy=policy, executor=ex, num_devices=num_devices,
                       placement=placement, **kw)
