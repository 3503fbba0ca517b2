"""Executors: how lanes actually run computational elements.

Two implementations behind one interface:

* ``ThreadLaneExecutor`` — real execution.  Each lane is a worker thread with
  an ordered queue (CUDA-stream semantics: in-order per lane, lanes
  independent).  Cross-lane dependencies wait on per-element events — the
  CUDA-event analogue; the host is never blocked by device work (§IV-B).
  Kernels are PyTorch callables.  On ``cuda`` each lane worker owns one
  ``torch.cuda.Stream`` and issues its elements there; host-to-device
  transfers are staged through pinned memory and issued with
  ``non_blocking=True`` on that stream, so they overlap other lanes' work.

* ``SimExecutor`` — a discrete-event simulator that replays the *same* DAG +
  lane assignment under a calibrated hardware model: processor-sharing
  compute with a per-kernel *parallel fraction* (space-sharing contention,
  Fig. 9), one copy engine per transfer direction with fair bandwidth
  sharing, and host scheduling overhead.  This is how speedup numbers are
  produced on a machine that is not an Nvidia GPU: the scheduling algorithm
  is identical, only the clock is simulated.
"""
from __future__ import annotations

import queue
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from .dtypes import to_numpy, to_tensor, torch_dtype
from .element import AccessMode, ComputationalElement, ElementKind, ElementState
from .history import KernelHistory
from .timeline import Timeline

# Tries of an anchor reading (the one read in the shortest time is kept),
# and the age at which a lane re-anchors its device: host and device
# clocks drift apart (3 to 6 us a second on the H100s measured, so 12 us
# at most between anchors), and ``elapsed_time`` is a float32 of ms.
ANCHOR_TRIES = 3
ANCHOR_PERIOD_S = 2.0


class Executor:
    """Interface shared by real and simulated executors."""

    timeline: Timeline
    history: KernelHistory
    # True when per-element wait() only blocks on a completion handle and
    # touches no shared executor state — the scheduler may then drop its
    # submission-pipeline lock while waiting, so one tenant's host read
    # cannot stall other tenants' launches (priority-inversion guard).
    # The simulator advances a shared clock in wait(), so it stays False.
    concurrent_waits = False
    # True when pausing a queued element requires a pause_gate event the
    # lane worker blocks on (real threads); the simulator pauses purely
    # via ElementState.PAUSED.
    pause_via_gates = False
    # Deadline-monitor hooks (installed by GrScheduler; None = no-op).
    # ``on_boundary(element)`` fires at every element completion — the
    # deadline-risk re-check point.  ``on_stall(element_or_None) -> bool``
    # fires when a host wait cannot make progress; it resumes paused work
    # and returns True when it changed anything.
    on_boundary = None
    on_stall = None
    # Sanitizer hooks (installed by ``GrScheduler(sanitize=True)``; None =
    # no-op).  ``pre_exec(element)`` fires when the element actually starts
    # executing (after its waits/gates resolved), ``post_exec(element)``
    # when its body finished but *before* the completion event is
    # published — so correctly-ordered children can never appear to
    # overlap their parent.
    pre_exec = None
    post_exec = None

    def _notify_boundary(self, element: ComputationalElement) -> None:
        cb = self.on_boundary
        if cb is not None:
            cb(element)

    def device_now(self) -> float:
        """Clock deadline-risk checks compare deadlines against: the sim
        clock mid-advance, the host clock on real executors."""
        return self.host_now()

    def submit(self, element: ComputationalElement, lane_id: int,
               wait_parents: List[ComputationalElement]) -> None:
        raise NotImplementedError

    def submit_batch(self, items) -> None:
        """Submit a pre-scheduled batch (capture/replay fast path).

        ``items`` is a sequence of ``(element, lane_id, wait_parents)``
        triples in topological order.  Subclasses override to pre-materialize
        completion events / start the whole batch at once."""
        for element, lane_id, waits in items:
            self.submit(element, lane_id, waits)

    def is_done(self, element: ComputationalElement) -> bool:
        raise NotImplementedError

    def wait(self, element: ComputationalElement) -> None:
        raise NotImplementedError

    def wait_all(self) -> None:
        raise NotImplementedError

    def host_overhead(self, seconds: float) -> None:
        """Host-side scheduling cost (only the simulator advances a clock)."""

    def host_now(self) -> float:
        raise NotImplementedError

    def record_host_span(self, element: ComputationalElement, t0: float,
                         t1: float) -> None:
        self.timeline.record(element.uid, element.name, "host", None, t0, t1)

    def shutdown(self) -> None:
        pass


# ======================================================================
# Real execution: threads as lanes, one CUDA stream per lane underneath
# ======================================================================

def _no_begin() -> None:
    pass


def _to_device(x, dev: torch.device, begin: Callable[[], None] = _no_begin):
    """Commit one value to the lane's device: host arrays are uploaded,
    tensors elsewhere are copied, anything else (a model, a dict of caches)
    passes through unchanged.  A bf16 host array (``ml_dtypes.bfloat16``)
    arrives as ``torch.bfloat16`` with its bits unchanged.  ``begin`` is
    called just before a copy is issued.

    On CUDA a host array is first copied into pinned memory from PyTorch's
    caching host allocator, then uploaded with ``non_blocking=True``: from
    pageable memory the copy would hold the lane's thread for the whole
    transfer.  The allocator records the lane's stream on the pinned block
    and reuses it only once the upload has finished, so the pinned pool
    stays about as large as the uploads in flight; host mirrors themselves
    stay pageable."""
    if isinstance(x, np.ndarray):
        t = to_tensor(x)
        if dev.type == "cuda":
            t = t.pin_memory()
        begin()
        return t.to(dev, non_blocking=True)
    if isinstance(x, torch.Tensor) and x.device != dev:
        begin()
        return x.to(dev, non_blocking=True)
    return x


def _arg_value(arg, dev: torch.device,
               begin: Callable[[], None] = _no_begin):
    """The value a kernel receives for one argument.  An ``out`` argument
    that has never been on a device gets a fresh uninitialized tensor of
    its shape and dtype: the kernel only writes it, so uploading its host
    buffer would move dead bytes.  Every other argument is committed to
    the lane's device (a no-op for values already resident)."""
    ma = arg.array
    if (arg.mode is AccessMode.OUT and ma.device is None
            and isinstance(ma.host, np.ndarray)):
        return torch.empty(ma.host.shape, dtype=torch_dtype(ma.host.dtype),
                           device=dev)
    return _to_device(ma.device_value(), dev, begin)


def _run_device_element(e: ComputationalElement, dev: torch.device,
                        begin: Callable[[], None] = _no_begin):
    """Execute a kernel/transfer element against its ManagedArray args.

    ``dev`` is the torch device the element's lane is pinned to.  On CUDA
    the caller has made the lane's stream current, so every copy and kernel
    issued here is ordered on that stream; completion is the caller's
    event.  ``begin`` is called just before the element's first device
    operation is issued (the caller's start event), after the host's own
    part of the work before it: staging an upload, decoding a tier's
    payload, making an ``out`` argument's tensor."""
    if e.kind is ElementKind.TRANSFER:
        ma = e.args[0].array
        ma.set_physical_device(_to_device(np.asarray(ma.host), dev, begin))
        return

    if e.kind is ElementKind.D2D:
        ma = e.args[0].array
        ma.set_physical_device(_to_device(ma.device_value(), dev, begin))
        return

    if e.kind is ElementKind.EVICT:
        ma = e.args[0].array
        tier = e.tier
        if tier is not None and tier.location == "device":
            # Peer-device spill: a D2D copy onto the tier's target device
            # (the lane — and dev — belong to the target, like any D2D).
            ma.set_physical_device(_to_device(ma.device_value(), dev, begin))
            return
        begin()
        if tier is not None:
            # Host-side tier: store/encode the payload (compressed bytes,
            # spool file), then release the device buffer.
            tier.spill(ma)
            ma.set_physical_device(None)
            return
        # Flat budget spill: write the device copy back to the host buffer
        # when it was the only valid one, then actually release the device
        # buffer (dropping the reference frees the backing device memory).
        if e.config.get("writeback", True) and ma.device is not None:
            np.copyto(ma.host, to_numpy(ma.device))
        ma.set_physical_device(None)
        return

    if e.kind is ElementKind.RELOAD:
        # Bring a tier-spilled block back: the tier decodes/reads the
        # payload (refreshing ma.host) and the copy engine uploads it.
        ma = e.args[0].array
        ma.set_physical_device(
            _to_device(np.asarray(e.tier.reload(ma)), dev, begin))
        return

    inputs = [_arg_value(a, dev, begin) for a in e.args]
    begin()
    result = e.fn(*inputs)
    writable = [a.array for a in e.args if a.mode.writes]
    if writable:
        outs = result if isinstance(result, (tuple, list)) else (result,)
        if len(outs) != len(writable):
            raise ValueError(
                f"kernel {e.name}: returned {len(outs)} outputs for "
                f"{len(writable)} writable args")
        for ma, val in zip(writable, outs):
            ma.set_physical_device(val)


class _LaneWorker(threading.Thread):
    def __init__(self, lane_id: int, executor: "ThreadLaneExecutor") -> None:
        super().__init__(name=f"lane-{lane_id}", daemon=True)
        self.lane_id = lane_id
        self.executor = executor
        self.q: "queue.Queue" = queue.Queue()
        # The lane's CUDA stream, one per device this lane ran on (created
        # lazily; a lane stays on one device in practice), and the
        # completion event of the last element each stream ran.
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        self._last_done: Dict[torch.device, "torch.cuda.Event"] = {}
        self.start()

    def _execute(self, element: ComputationalElement) -> tuple:
        """Run one element to completion on this lane, between the
        executor's ``pre_exec`` and ``post_exec`` hooks.  Returns
        ``(t_begin, t0, t1, t_issued, t_end)`` on the executor's clock: the
        start of its ``lane.issue``, the element's interval, the end of its
        ``lane.issue`` (every copy and launch issued, the completion event
        recorded) and of its ``lane.sync`` (complete, hooks run).

        On CUDA the element's copies and kernels are issued on the lane's
        stream (the current stream is thread-local in PyTorch), between a
        start event, recorded just before the first of them, and a
        completion event, both timing-enabled; the
        element is complete once the completion event has synchronized —
        the ``block_until_ready`` of the JAX executor.  Its interval is
        then the device's, from the start event to the completion event,
        placed on the executor's clock through the device's anchor.  The
        hooks run with that stream current: whatever ``pre_exec`` issues
        on the device is ordered before the element's kernels, and
        ``post_exec`` runs once they have completed.  On the CPU the
        interval is the host's, inside the hooks.

        Caching allocator across streams: a tensor made on lane A and read
        on lane B stays safe only because B starts after A's event has
        synchronized and B's writers are ordered after B by the DAG, so no
        block is freed back to A's pool while B's kernels still read it.
        Moving cross-lane waits onto the device (``wait_event``) will need
        ``record_stream`` on every tensor a lane consumes from another."""
        ex = self.executor
        tl = ex.timeline
        pre, post = ex.pre_exec, ex.post_exec
        dev = ex.torch_device_for(element)
        if dev.type != "cuda":
            t_begin = tl.issue_edge(+1)
            try:
                if pre is not None:
                    pre(element)
                t0 = ex.host_now()
                _run_device_element(element, dev)
                t1 = ex.host_now()
            finally:
                t_issued = tl.issue_edge(-1)
            if post is not None:
                post(element)
            return t_begin, t0, t1, t_issued, ex.host_now()
        stream = self._streams.get(dev)
        if stream is None:
            ex._anchor_device(dev)
            stream = self._streams[dev] = torch.cuda.Stream(device=dev)
        anchor, t_anchor = ex._anchors[dev]
        start = torch.cuda.Event(enable_timing=True)
        started = []

        def begin() -> None:
            if not started:
                start.record(stream)
                started.append(True)

        with torch.cuda.stream(stream):
            t_begin = tl.issue_edge(+1)
            try:
                if pre is not None:
                    pre(element)
                _run_device_element(element, dev, begin)
                begin()             # an element that issued nothing
                done = torch.cuda.Event(enable_timing=True)
                done.record(stream)
            finally:
                t_issued = tl.issue_edge(-1)
            done.synchronize()
            if post is not None:
                post(element)
        t_end = ex.host_now()
        t0 = t_anchor + anchor.elapsed_time(start) / 1e3
        t1 = t_anchor + anchor.elapsed_time(done) / 1e3
        last = self._last_done.get(dev)
        if last is not None:
            tl.lane_gap(last.elapsed_time(start) / 1e3)
        self._last_done[dev] = done
        if t_end - t_anchor > ANCHOR_PERIOD_S:
            ex._anchor_device(dev, older_than=t_anchor)
        return t_begin, t0, t1, t_issued, t_end

    def run(self) -> None:
        tl = self.executor.timeline
        while True:
            item = self.q.get()
            if item is None:
                return
            element, waits = item
            try:
                while waits:        # pop: no loop variable may outlive the
                    waits.pop().done_event.wait()   # wait (see finally below)
                # Element-boundary preemption: a paused element blocks its
                # lane *in place* (FIFO order is a dependency carrier — the
                # queue must never be reordered) until the deadline monitor
                # resumes it.  A gate published after this check simply
                # means the element already started: running work is never
                # interrupted.
                gate = element.pause_gate
                if gate is not None:
                    gate.wait()
                element.state = ElementState.RUNNING
                t_begin, t0, t1, t_issued, t_end = self._execute(element)
                element.t_start, element.t_end = t0, t1
                kind = ("h2d" if element.kind in (ElementKind.TRANSFER,
                                                 ElementKind.RELOAD)
                        else "d2d" if (element.kind is ElementKind.D2D
                                       or (element.kind is ElementKind.EVICT
                                           and element.src_device is not None))
                        else "d2h" if element.kind is ElementKind.EVICT
                        else "compute")
                trace = dict(lane=self.lane_id, trace_id=element.trace_id,
                             parent=element.trace_parent)
                tl.close_span("lane.wait", element.t_issue, t_begin, **trace)
                tl.close_span("lane.issue", t_begin, t_issued, **trace)
                tl.close_span("lane.sync", t_issued, t_end, **trace)
                tl.record(
                    element.uid, element.name, kind, self.lane_id, t0, t1,
                    tenant=element.tenant, priority=element.priority,
                    t_issue=element.t_issue, deadline=element.deadline_t,
                    trace_id=element.trace_id, parent=element.trace_parent)
                if element.kind is ElementKind.KERNEL:
                    self.executor.history.record(
                        element.name, element.config, t1 - t0)
            except BaseException as exc:  # surfaced on wait()
                element.error = exc
            finally:
                element.state = ElementState.DONE
                element.done_event.set()
                self.executor._notify_boundary(element)
                self.q.task_done()
                # An idle worker blocked on q.get must not keep its last
                # element's graph (and, through the args, the arrays)
                # reachable: tier-spilled blocks rely on GC finalizers to
                # release their spool payloads.
                del item, element, waits


def anchor_reading(stream: "torch.cuda.Stream", clock) -> tuple:
    """``(event, t, width)``: a timing-enabled event recorded on ``stream``
    and synchronized, and ``clock``'s reading midway between just before
    the record and just after the synchronize, ``width`` apart; of
    ``ANCHOR_TRIES`` tries the narrowest.  ``stream`` holds no other work,
    so the event completes as soon as the device reaches it."""
    best = None
    for _ in range(ANCHOR_TRIES):
        ev = torch.cuda.Event(enable_timing=True)
        a = clock()
        ev.record(stream)
        ev.synchronize()
        b = clock()
        if best is None or b - a < best[2]:
            best = (ev, (a + b) / 2, b - a)
    return best


def _release_cublas_workspaces() -> None:
    """Frees the cuBLAS workspaces PyTorch keeps for every (cuBLAS handle,
    stream) pair that ran a matmul: 32 MiB each on a Hopper card, held in a
    process-wide map that nothing else ever empties.  Every lane runs on a
    stream of its own and every lane thread holds a handle of its own, so
    each scheduler that ran matmuls on the card added its lanes' workspaces
    to that map for the life of the process.  The next cuBLAS call on a
    stream allocates its workspace again."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


class ThreadLaneExecutor(Executor):
    concurrent_waits = True     # wait() is a pure event wait
    pause_via_gates = True      # paused elements block their lane worker
    # Executors with lane workers on a CUDA device.  ``_lane_lock`` covers
    # every lane's creation and the workspaces' release, which happens only
    # once no such executor has a lane left: no lane thread can be inside
    # cuBLAS while its workspace map is emptied.
    _cuda_live: "weakref.WeakSet" = weakref.WeakSet()
    _lane_lock = threading.Lock()

    def __init__(self, num_devices: int = 1, device: str = "cuda") -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ThreadLaneExecutor: device='cuda' but no CUDA device is "
                "available; pass device='cpu' to run the lanes on the host")
        self.history = KernelHistory()
        self.num_devices = max(1, num_devices)
        self._lanes: Dict[int, _LaneWorker] = {}
        self._submitted: List[ComputationalElement] = []
        # Submitted EVICT elements not known to have finished, by the
        # device whose memory each releases (see _evictions_before).
        self._evicting: Dict[int, List[ComputationalElement]] = {}
        self._evicting_lock = threading.Lock()
        # The clock's zero, on ``perf_counter`` and in Unix time (the
        # profiler's Chrome traces are stamped in Unix time).
        before = time.perf_counter()
        unix_ns = time.time_ns()
        self._epoch = (before + time.perf_counter()) / 2
        self.timeline = Timeline(clock=self.host_now, epoch_unix_ns=unix_ns)
        # Per CUDA device: a stream of its own for anchors, and the anchor,
        # an event recorded and synchronized there with the clock's reading
        # at that moment, which places every lane's event times on the clock.
        self._anchor_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        self._anchors: Dict[torch.device, tuple] = {}
        self._anchor_lock = threading.Lock()

    def torch_device_for(self, element: ComputationalElement) -> torch.device:
        """Torch device backing the element's lane.  On the CPU, and with a
        single visible card, every lane shares one device (scheduling still
        works, D2D copies degrade to no-ops)."""
        if self.device.type != "cuda":
            return self.device
        count = torch.cuda.device_count()
        if self.num_devices <= 1 or count <= 1:
            return torch.device("cuda", self.device.index or 0)
        dev = element.device if element.device is not None else 0
        return torch.device("cuda", dev % count)

    def host_now(self) -> float:
        return time.perf_counter() - self._epoch

    def _anchor_device(self, dev: torch.device,
                       older_than: Optional[float] = None) -> None:
        """(Re-)anchor ``dev`` (``anchor_reading`` on its anchor stream).
        Made with the device's first lane stream, and again once the anchor
        is ``ANCHOR_PERIOD_S`` old (``older_than``: the anchor's reading the
        caller found, so that lanes finding it old together anchor once).
        ``elapsed_time`` from the anchor then gives any completed event's
        time on the clock, within half that reading's width."""
        with self._anchor_lock:
            held = self._anchors.get(dev)
            if held is not None and (older_than is None
                                     or held[1] > older_than):
                return
            stream = self._anchor_streams.get(dev)
            if stream is None:
                # high priority: a pool of its own, apart from the lanes'
                stream = self._anchor_streams[dev] = torch.cuda.Stream(
                    device=dev, priority=-1)
            self._anchors[dev] = anchor_reading(stream, self.host_now)[:2]

    def _worker(self, lane_id: int) -> _LaneWorker:
        worker = self._lanes.get(lane_id)
        if worker is None:
            with ThreadLaneExecutor._lane_lock:
                if self.device.type == "cuda":
                    ThreadLaneExecutor._cuda_live.add(self)
                worker = self._lanes[lane_id] = _LaneWorker(lane_id, self)
        return worker

    def _evictions_before(self, element: ComputationalElement) -> list:
        """The evictions ``element`` must wait for besides its parents.

        A budget makes room for an element by evicting victims, but the
        DAG orders an EVICT only after the victim's readers and writer,
        not before the uploads and outputs it makes room for: left alone,
        a lane could install them before another lane had released the
        victims, and the device would hold up to the whole working set at
        once.  So every element waits for the unfinished evictions
        submitted before it on its device; an EVICT is recorded under the
        device it releases and waits for none (its parents precede it, so
        no wait can close a cycle)."""
        with self._evicting_lock:
            self._prune_evictions()
            if element.kind is ElementKind.EVICT:
                dev = (element.src_device if element.src_device is not None
                       else element.device or 0)
                self._evicting.setdefault(dev, []).append(element)
                return []
            return list(self._evicting.get(element.device or 0, ()))

    def _prune_evictions(self) -> None:
        """Forgets finished evictions: a finished element must not keep its
        victim (and a tier's spool payload) reachable.  Caller holds
        ``_evicting_lock``."""
        for dev, pending in list(self._evicting.items()):
            pending[:] = [e for e in pending if not e.done_event.is_set()]
            if not pending:
                del self._evicting[dev]

    def submit(self, element, lane_id, wait_parents) -> None:
        element.done_event = threading.Event()
        element.error = None
        element.state = ElementState.QUEUED
        element.trace_id, element.trace_parent = self.timeline.context()
        element.t_issue = self.host_now()
        self._submitted.append(element)
        waits = list(wait_parents) + self._evictions_before(element)
        self._worker(lane_id).q.put((element, waits))

    def submit_batch(self, items) -> None:
        # Pre-materialize every completion event before anything is
        # enqueued: a worker may dequeue a child and wait on a sibling-lane
        # parent that has not been individually submitted yet.
        trace = self.timeline.context()
        for element, _, _ in items:
            element.done_event = threading.Event()
            element.error = None
            element.state = ElementState.QUEUED
            element.trace_id, element.trace_parent = trace
            element.t_issue = self.host_now()
        for element, lane_id, waits in items:
            self._submitted.append(element)
            self._worker(lane_id).q.put(
                (element, list(waits) + self._evictions_before(element)))

    def is_done(self, element) -> bool:
        ev = element.done_event
        return ev is not None and ev.is_set()

    def wait(self, element) -> None:
        ev = element.done_event
        if ev is None:
            return
        stall = self.on_stall
        if stall is None:
            ev.wait()
        else:
            # A host wait must never deadlock on paused (preempted) work:
            # poll, giving the deadline monitor a chance to resume anything
            # the host is now blocked on.  Event.wait returns as soon as the
            # event is set, so completed elements pay no extra latency.
            while not ev.wait(0.02):
                stall(element)
        if getattr(element, "error", None) is not None:
            raise element.error

    def wait_all(self) -> None:
        for e in self._submitted:
            self.wait(e)
        self._submitted.clear()
        with self._evicting_lock:
            self._prune_evictions()

    def shutdown(self) -> None:
        """Idempotent: stop every lane worker and *join* it.  Relying on
        daemon-thread teardown leaked running workers into interpreter exit
        (and kept spool-file finalizers from running deterministically);
        after shutdown returns, no lane thread is alive.  On CUDA the last
        executor to shut down also releases the lanes' cuBLAS workspaces,
        which would otherwise stay allocated for the life of the process."""
        if self.on_stall is not None:
            self.on_stall(None)   # resume paused work so workers can drain
        workers = list(self._lanes.values())
        self._lanes.clear()
        for w in workers:
            w.q.put(None)         # sentinel after any queued work: drain
        for w in workers:
            w.join(timeout=5.0)
        if self.device.type == "cuda":
            with ThreadLaneExecutor._lane_lock:
                live = ThreadLaneExecutor._cuda_live
                live.discard(self)
                if (workers and not any(w.is_alive() for w in workers)
                        and not any(ex._lanes for ex in live)):
                    _release_cublas_workspaces()


# ======================================================================
# Discrete-event simulation
# ======================================================================

@dataclass
class SimHardware:
    """Cost model of the target device + host link.

    * ``cost_s`` of a kernel is its *solo* execution time; a kernel's
      ``parallel_fraction`` (pf) is the fraction of device resources it
      occupies while running solo (SM occupancy / bandwidth analogue).
    * Space-sharing: concurrent kernels water-fill the device's unit
      capacity — a kernel receives allocation ``a ≤ pf`` and progresses at
      rate ``a / pf`` (≤ 1).  Two pf=0.75 kernels therefore run at 0.67×
      each — the ~70 %-of-contention-free-bound regime of Fig. 9 — while
      low-occupancy kernels overlap for free (the ML benchmark's low-IPC
      kernel, Fig. 12).
    * Transfers: one copy engine per direction, FIFO order, full bandwidth —
      CUDA DMA semantics (no fair-sharing of a single engine).

    Defaults approximate the paper's PCIe-3.0 testbeds; the benchsuite
    calibrates per-kernel costs, so only *relative* magnitudes matter for the
    scheduling comparison.
    """

    h2d_gbps: float = 12.0          # effective PCIe 3.0 x16 H2D bandwidth
    d2h_gbps: float = 12.0
    default_parallel_fraction: float = 0.75
    launch_overhead_s: float = 5e-6
    # Multi-device: N identical devices, each with unit compute capacity and
    # its own H2D/D2H copy engines; device pairs are connected by a
    # point-to-point link (NVLink / PCIe P2P analogue) used by D2D elements.
    num_devices: int = 1
    d2d_gbps: float = 50.0


@dataclass
class _SimTask:
    element: ComputationalElement
    kind: str                   # compute | h2d | d2h | d2d
    work: float                 # seconds (compute) or bytes (transfer)
    remaining: float
    pf: float
    lane: int
    issue_t: float
    device: int = 0             # executing device (D2D: destination)
    src_device: int = 0         # D2D only: device the copy reads from
    rate: float = 0.0
    t_start: float = float("nan")
    weight: float = 1.0         # priority weight for the capacity water-fill
    # Per-tier bandwidth override (GB/s): a disk-tier spill occupies its
    # copy engine at disk rate, not at link rate.  None = engine default.
    gbps: Optional[float] = None


class SimExecutor(Executor):
    """Event-driven replay of the scheduled DAG under `SimHardware`."""

    def __init__(self, hw: Optional[SimHardware] = None) -> None:
        self.hw = hw or SimHardware()
        self.timeline = Timeline(clock=self.host_now)
        self.history = KernelHistory()
        self.now = 0.0                    # device/simulation clock
        self.host_time = 0.0              # host program clock
        self.edf_fill_rounds = 0          # rate recomputes where the EDF
        #                                   layer handed capacity out first
        self._pending: List[_SimTask] = []
        self._running: List[_SimTask] = []
        self._end: Dict[int, float] = {}   # uid -> completion time
        # Lane queues complete strictly in head order (_try_start admits only
        # the head), so a deque with popleft keeps completion O(1) instead of
        # list.remove's O(n) — O(n^2) per episode on long serving lanes.
        self._lane_q: Dict[int, Deque[int]] = {}  # lane -> uid queue (order)

    # -- host clock ----------------------------------------------------
    def host_now(self) -> float:
        return self.host_time

    def device_now(self) -> float:
        return max(self.now, self.host_time)

    def host_overhead(self, seconds: float) -> None:
        self.host_time += seconds
        self._advance_to(self.host_time)

    # -- submission ------------------------------------------------------
    def submit(self, element, lane_id, wait_parents) -> None:
        self._enqueue(element, lane_id)
        self._try_start()

    def submit_batch(self, items) -> None:
        # Replay fast path: enqueue the whole pre-scheduled episode, then
        # run a single readiness scan instead of one per element.
        for element, lane_id, _ in items:
            self._enqueue(element, lane_id)
        self._try_start()

    def _enqueue(self, element, lane_id) -> None:
        if element.kind is ElementKind.TRANSFER:
            kind = "h2d"
            work = float(element.transfer_bytes)
        elif element.kind is ElementKind.D2D:
            kind = "d2d"
            work = float(element.transfer_bytes)
        elif element.kind is ElementKind.EVICT:
            # Spill write-back occupies the D2H engine for its byte count;
            # clean drops (transfer_bytes == 0) complete instantly.  A
            # peer-tier spill (src_device set) runs on the D2D link instead.
            kind = "d2d" if element.src_device is not None else "d2h"
            work = float(element.transfer_bytes)
        elif element.kind is ElementKind.RELOAD:
            # Tier reload: the H2D engine is occupied for the upload (at
            # the tier's bandwidth when it is the slower stage of the pipe).
            kind = "h2d"
            work = float(element.transfer_bytes)
        else:
            kind = "compute"
            est = element.cost_s
            if not est:
                h = self.history.estimate(element.name, element.config)
                est = h if h is not None else 1e-4
            work = float(est)
        pf = float(element.config.get(
            "parallel_fraction", self.hw.default_parallel_fraction))
        # The hardware model is authoritative: a schedule that names more
        # devices than the hw has folds onto the last physical device.
        top = max(0, self.hw.num_devices - 1)
        task = _SimTask(element=element, kind=kind, work=work, remaining=work,
                        pf=pf, lane=lane_id, issue_t=self.host_time,
                        device=min(element.device or 0, top),
                        src_device=min(element.src_device or 0, top),
                        weight=element.weight,
                        gbps=element.config.get("tier_gbps"))
        element.t_issue = self.host_time
        element.state = ElementState.QUEUED
        self._pending.append(task)
        self._lane_q.setdefault(lane_id, deque()).append(element.uid)

    # -- readiness & rates ---------------------------------------------
    def _parents_done(self, e: ComputationalElement) -> bool:
        return all(p.uid in self._end and self._end[p.uid] <= self.now
                   for p in e.parents)

    def _lane_head(self, t: _SimTask) -> bool:
        q = self._lane_q[t.lane]
        return q and q[0] == t.element.uid

    def _try_start(self) -> None:
        started = True
        while started:
            started = False
            for t in list(self._pending):
                # A PAUSED lane head yields without reordering: it simply
                # blocks its lane until the deadline monitor resumes it.
                if (t.issue_t <= self.now + 1e-18 and self._lane_head(t)
                        and t.element.state is not ElementState.PAUSED
                        and self._parents_done(t.element)):
                    self._pending.remove(t)
                    t.t_start = self.now
                    t.element.state = ElementState.RUNNING
                    if self.pre_exec is not None:
                        self.pre_exec(t.element)
                    self._running.append(t)
                    started = True
        self._recompute_rates()

    def _recompute_rates(self) -> None:
        # Priority-weighted water-fill of each device's unit capacity: a
        # kernel's fair share is ``remaining * w/W`` (weight over total
        # outstanding weight), still capped by its parallel fraction ``pf``;
        # it progresses at a/pf (solo rate 1.0).  Kernels are visited in
        # ascending pf/weight order so capacity a capped kernel cannot use
        # spills to the rest — with equal weights this reduces exactly to the
        # original unweighted progressive fill (ascending pf, share 1/n).
        by_dev: Dict[int, List[_SimTask]] = {}
        for t in self._running:
            if t.kind == "compute":
                by_dev.setdefault(t.device, []).append(t)
        for comp in by_dev.values():
            remaining = 1.0
            # EDF layer: deadline'd kernels take their full parallel
            # fraction in earliest-deadline order *before* any deadline-free
            # kernel sees capacity; deadline-free work then water-fills the
            # leftovers exactly as before.  With no deadlines in flight
            # ``urgent`` is empty and the fill below is bit-identical to the
            # pre-EDF scheduler.
            urgent = [t for t in comp if t.element.deadline_t is not None]
            if urgent:
                self.edf_fill_rounds += 1
                urgent.sort(key=lambda t: (t.element.deadline_t,
                                           t.element.uid))
                for t in urgent:
                    a = min(t.pf, remaining)
                    t.rate = (a / t.pf) if t.pf > 0 else 1.0
                    remaining -= a
                comp = [t for t in comp if t.element.deadline_t is None]
            todo = sorted(comp, key=lambda t: t.pf / max(t.weight, 1e-12))
            total_w = sum(t.weight for t in todo)
            for t in todo:
                share = remaining * t.weight / total_w if total_w > 0 else 0.0
                a = min(t.pf, share)
                t.rate = (a / t.pf) if t.pf > 0 else 1.0
                remaining -= a
                total_w -= t.weight
        # One DMA engine per direction *per device*, FIFO at full bandwidth.
        for direction, bw in (("h2d", self.hw.h2d_gbps),
                              ("d2h", self.hw.d2h_gbps)):
            engines: Dict[int, List[_SimTask]] = {}
            for t in self._running:
                if t.kind == direction:
                    engines.setdefault(t.device, []).append(t)
            for xs in engines.values():
                xs.sort(key=lambda t: (t.t_start, t.element.uid))
                for i, t in enumerate(xs):
                    t.rate = (t.gbps or bw) * 1e9 if i == 0 else 0.0
        # One point-to-point link per ordered (src, dst) device pair.
        links: Dict[tuple, List[_SimTask]] = {}
        for t in self._running:
            if t.kind == "d2d":
                links.setdefault((t.src_device, t.device), []).append(t)
        for xs in links.values():
            xs.sort(key=lambda t: (t.t_start, t.element.uid))
            for i, t in enumerate(xs):
                t.rate = (t.gbps or self.hw.d2d_gbps) * 1e9 if i == 0 else 0.0

    # -- event loop ------------------------------------------------------
    def _advance_to(self, target: float) -> None:
        inf = float("inf")
        guard = 0
        while True:
            guard += 1
            if guard > 5_000_000:  # pragma: no cover
                raise RuntimeError("simulation runaway")
            self._try_start()
            if not self._running:
                # Nothing executing: jump to the next issue time (if any)
                # or to the host target.
                future = [t.issue_t for t in self._pending
                          if t.issue_t > self.now + 1e-18]
                if future and (target == inf or min(future) <= target):
                    self.now = min(future)
                    continue
                if target != inf and self.now < target:
                    self.now = target
                    self._try_start()
                    if self._running:
                        continue
                return
            nxt = min(self.now + (t.remaining / t.rate if t.rate > 0 else inf)
                      for t in self._running)
            if nxt == inf:  # pragma: no cover
                raise RuntimeError("simulation deadlock: zero-rate tasks")
            step_to = nxt if target == inf else min(nxt, target)
            dt = step_to - self.now
            if dt > 0:
                for t in self._running:
                    t.remaining -= t.rate * dt
                self.now = step_to
            finished = [t for t in self._running
                        if t.remaining <= max(1e-12, 1e-9 * t.work)]
            for t in finished:
                self._running.remove(t)
                self._finish(t)
            if not finished and target != inf and self.now >= target:
                return
            if not finished and dt <= 0:
                return

    def _finish(self, t: _SimTask) -> None:
        e = t.element
        if self.post_exec is not None:
            self.post_exec(e)
        self._end[e.uid] = self.now
        e.t_start, e.t_end = t.t_start, self.now
        e.state = ElementState.DONE
        # Only the lane head may run, so the finishing task IS the head.
        self._lane_q[t.lane].popleft()
        self.timeline.record(e.uid, e.name, t.kind, t.lane, t.t_start, self.now,
                             tenant=e.tenant, priority=e.priority,
                             t_issue=t.issue_t, deadline=e.deadline_t)
        if t.kind == "compute":
            self.history.record(e.name, e.config, self.now - t.t_start)
        # Logical array-location bits are owned by the scheduler and were
        # already flipped at schedule time; nothing to do here.
        # Element boundary: the deadline monitor re-checks slack here and
        # may pause/resume queued work before the next _try_start scan.
        self._notify_boundary(e)

    # -- waiting -----------------------------------------------------------
    def is_done(self, element) -> bool:
        return element.uid in self._end and self._end[element.uid] <= self.host_time

    def wait(self, element) -> None:
        if element.uid not in self._end:
            self._advance_to(float("inf"))
        if element.uid not in self._end and self.on_stall is not None:
            # Everything runnable ran; if the target is (transitively)
            # behind paused/preempted work, resume it and advance again.
            while self.on_stall(element):
                self._advance_to(float("inf"))
                if element.uid in self._end:
                    break
        if element.uid not in self._end:
            raise RuntimeError(
                f"simulation deadlock waiting for {element.name}; "
                f"pending={[(t.element.name, t.lane) for t in self._pending]}")
        self.host_time = max(self.host_time, self._end[element.uid])

    def wait_all(self) -> None:
        self._advance_to(float("inf"))
        if (self._pending or self._running) and self.on_stall is not None:
            while self.on_stall(None):
                self._advance_to(float("inf"))
                if not (self._pending or self._running):
                    break
        if self._pending or self._running:
            raise RuntimeError("simulation finished with unrunnable tasks "
                               f"{[t.element.name for t in self._pending]}")
        self.host_time = max(self.host_time, self.now)
