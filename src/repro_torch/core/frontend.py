"""GrFunction frontend — declare-once kernels + the ambient runtime.

The paper's core promise (§III–IV) is that the polyglot API makes GPU task
parallelism *transparent*: host code calls kernels like plain functions and
the runtime infers the DAG — no per-call dependency annotations, no runtime
handle threaded through every call site.  This module is that surface for
GrJAX:

* :func:`function` wraps a JAX/Pallas callable **once** with everything the
  runtime needs to schedule it — its signature's access modes, an optional
  cost model and tuning space, and (for out-allocating kernels) an output
  spec::

      sq = gr.function(square_kernel, modes=("const", "out"),
                       outputs=0, name="square")

  after which every invocation is just ``sq(x, y)`` — or ``y = sq(x)``,
  with the runtime allocating the output :class:`ManagedArray` from the
  declared spec.  Call-scoped options never re-annotate the signature::

      sq.with_options(tenant="a", priority=1)(x, y)

* the **ambient runtime**: ``with gr.runtime(policy=..., num_devices=...):``
  (or a module-level default via :func:`set_runtime`) makes ManagedArrays
  and GrFunctions resolve their scheduler implicitly through a thread-local
  stack.  Explicit ``scheduler=`` always wins; each thread sees only its own
  stack, so concurrent tenants never leak runtimes into each other.

Every call funnels into ``GrScheduler._launch`` — the same engine behind
the deprecated ``scheduler.launch`` shim — so DAG inference, lane
assignment, QoS weighting and capture/replay behave identically whichever
surface issued the kernel.  Capture plans are keyed by the *declared*
function's identity (``GrFunction.fid``), not the Python callable, so
closures re-created per episode keep replaying one plan.
"""
from __future__ import annotations

import itertools
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .element import AccessMode, Arg, DEFAULT_TENANT
from .managed import ManagedArray
from .scheduler import GrScheduler, make_scheduler

_FN_IDS = itertools.count()

# Accepted spellings for declared access modes (paper §IV-D annotations).
_MODE_NAMES: Dict[str, AccessMode] = {
    "const": AccessMode.CONST, "in": AccessMode.CONST,
    "input": AccessMode.CONST,
    "out": AccessMode.OUT, "output": AccessMode.OUT,
    "inout": AccessMode.INOUT,
}

# Option keys consumed by the frontend itself; everything else a caller
# passes to with_options()/``__call__`` merges into the launch config
# (e.g. ``parallel_fraction`` for the simulator's occupancy model).
_OPTION_KEYS = ("scheduler", "name", "priority", "tenant", "cost_s",
                "device", "tune", "outputs", "deadline_s")


class NoActiveRuntimeError(RuntimeError):
    """No ambient runtime on this thread and no explicit ``scheduler=``."""


# ======================================================================
# Ambient runtime: thread-local stack over a module-level default
# ======================================================================

_tls = threading.local()
_default_runtime: Optional[GrScheduler] = None


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current_runtime() -> Optional[GrScheduler]:
    """Innermost ambient scheduler of this thread, the module-level default
    when the thread's stack is empty, or None."""
    stack = _stack()
    return stack[-1] if stack else _default_runtime


def get_runtime() -> GrScheduler:
    """Like :func:`current_runtime` but raising a directive error when no
    runtime is active — the failure mode every implicit resolution shares."""
    rt = current_runtime()
    if rt is None:
        raise NoActiveRuntimeError(
            "no GrJAX runtime is active on this thread: enter one with "
            "`with gr.runtime(...):`, install a process-wide default via "
            "`gr.set_runtime(make_scheduler(...))`, or pass `scheduler=` "
            "explicitly")
    return rt


def set_runtime(sched: Optional[GrScheduler]) -> Optional[GrScheduler]:
    """Install ``sched`` as the module-level default runtime (shared by all
    threads whose own stack is empty); returns the previous default.  Pass
    None to clear."""
    global _default_runtime
    prev = _default_runtime
    _default_runtime = sched
    return prev


class runtime:
    """``with gr.runtime(policy=..., num_devices=...) as sched:`` — push an
    ambient scheduler onto this thread's runtime stack.

    Keyword arguments are forwarded to :func:`make_scheduler` unless an
    existing scheduler is adopted via ``scheduler=``.  The scheduler is
    created eagerly at construction, so one ``runtime`` instance can be
    entered from several threads (or re-entered) without racing on lazy
    creation — every entry pushes the same scheduler.  Contexts nest: the
    innermost runtime wins, and exiting restores the enclosing one.  The
    stack is thread-local — a runtime entered on one thread is invisible to
    every other thread (each tenant thread enters its own).
    """

    def __init__(self, policy: str = "parallel", *,
                 scheduler: Optional[GrScheduler] = None, **make_kw) -> None:
        if scheduler is not None and (make_kw or policy != "parallel"):
            extra = sorted(make_kw) + (["policy"] if policy != "parallel"
                                       else [])
            raise TypeError("runtime(scheduler=...) adopts an existing "
                            "scheduler as-is; it cannot be combined with "
                            f"factory arguments {extra}")
        if scheduler is None:
            scheduler = make_scheduler(**dict(make_kw, policy=policy))
        self.scheduler = scheduler

    def __enter__(self) -> GrScheduler:
        _stack().append(self.scheduler)
        return self.scheduler

    def __exit__(self, exc_type, exc, tb) -> bool:
        stack = _stack()
        if not stack or stack[-1] is not self.scheduler:
            raise RuntimeError("runtime contexts must unwind LIFO on the "
                               "thread that entered them")
        stack.pop()
        return False


def array(data=None, *, shape: Optional[Tuple[int, ...]] = None,
          dtype=np.float32, name: str = "",
          scheduler: Optional[GrScheduler] = None) -> ManagedArray:
    """Create a :class:`ManagedArray` on the ambient runtime (or on an
    explicit ``scheduler=``, which wins)."""
    sched = scheduler if scheduler is not None else get_runtime()
    return sched.array(data, shape=shape, dtype=dtype, name=name)


# ======================================================================
# GrFunction
# ======================================================================

def _resolve_mode(mode: Union[str, AccessMode]) -> AccessMode:
    if isinstance(mode, AccessMode):
        return mode
    try:
        return _MODE_NAMES[str(mode).lower()]
    except KeyError:
        raise ValueError(f"unknown access mode {mode!r}; use one of "
                         f"{sorted(set(_MODE_NAMES))}") from None


class GrFunction:
    """A kernel declared once: callable + access modes + cost/tuning model.

    Instances are immutable from the caller's perspective;
    :meth:`with_options` returns a shallow variant sharing the same declared
    identity (``fid``), so call-scoped options (tenant, priority, cost,
    device pinning, simulator occupancy, even a per-call display name) never
    fork the capture-plan keying or the kernel history.
    """

    def __init__(self, fn: Optional[Callable],
                 modes: Sequence[Union[str, AccessMode]], *,
                 name: Optional[str] = None,
                 outputs: Any = None,
                 cost_s: float = 0.0,
                 tune: Optional[dict] = None,
                 config: Optional[dict] = None,
                 scheduler: Optional[GrScheduler] = None,
                 priority: int = 0,
                 tenant: str = DEFAULT_TENANT,
                 device: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 lint_shapes: Optional[Sequence] = None,
                 _fid: Optional[int] = None) -> None:
        self.fn = fn
        self.modes: Tuple[AccessMode, ...] = tuple(
            _resolve_mode(m) for m in modes)
        self.name = name or getattr(fn, "__name__", None) or "kernel"
        # Declared identity: shared by every with_options() variant, distinct
        # across declarations.  Capture plans key on it (element.fn_key).
        self.fid = next(_FN_IDS) if _fid is None else _fid
        self.outputs = self._normalize_outputs(outputs)
        self.cost_s = cost_s
        self.tune = tune
        self.config = dict(config or {})
        self.scheduler = scheduler
        self.priority = priority
        self.tenant = tenant
        self.device = device
        self.deadline_s = deadline_s
        # Shadow-operand hints for the access-mode checker (repro.analysis):
        # one (shape, dtype) pair per declared argument, for kernels whose
        # generic float shadows would not trace (e.g. integer index args).
        self.lint_shapes = (tuple((tuple(s), np.dtype(d))
                                  for s, d in lint_shapes)
                            if lint_shapes is not None else None)

    # -- declaration helpers -------------------------------------------
    def _out_positions(self) -> Tuple[int, ...]:
        return tuple(i for i, m in enumerate(self.modes)
                     if m is AccessMode.OUT)

    @staticmethod
    def _is_shape_dtype_pair(spec: Any) -> bool:
        """A single ``(shape, dtype)`` pair: a 2-sequence whose head is a
        shape (ints) and whose tail parses as a dtype.  The dtype probe is
        what separates one pair from a 2-element *sequence of specs* (e.g.
        two pairs, or two like-input indices)."""
        if not (isinstance(spec, (tuple, list)) and len(spec) == 2
                and isinstance(spec[0], (tuple, list))
                and all(isinstance(d, (int, np.integer)) for d in spec[0])):
            return False
        try:
            np.dtype(spec[1])
        except TypeError:
            return False
        return True

    def _normalize_outputs(self, outputs: Any):
        """``outputs`` describes how to allocate OUT-mode arguments the
        caller omits: an int (allocate like that input index), a
        ``(shape, dtype)`` pair, a callable ``(*given) -> (shape, dtype)``,
        or a sequence of those — one per OUT position, in order.  A
        2-tuple is a single pair only when its head is a shape sequence;
        any other list/tuple is a sequence of specs."""
        if outputs is None:
            return None
        out_n = len(self._out_positions())
        if (isinstance(outputs, (list, tuple))
                and not self._is_shape_dtype_pair(outputs)):
            specs = list(outputs)
        else:
            specs = [outputs]
        if len(specs) == 1 and out_n > 1:
            specs = specs * out_n
        if len(specs) != out_n:
            raise ValueError(
                f"{self.name}: {len(specs)} output spec(s) for {out_n} "
                f"'out'-mode argument(s)")
        return tuple(specs)

    def _allocate(self, pos: int, out_idx: int, given: Tuple[Any, ...],
                  sched: GrScheduler, call_name: str) -> ManagedArray:
        if self.outputs is None:
            raise TypeError(
                f"{call_name}: argument {pos} ('out') was not supplied and "
                f"the declaration has no outputs= spec to allocate it from")
        spec = self.outputs[out_idx]
        if isinstance(spec, bool) or spec is Ellipsis:
            raise TypeError(f"{call_name}: invalid output spec {spec!r}")
        if isinstance(spec, int):
            try:
                like = given[spec]
            except IndexError:
                raise TypeError(
                    f"{call_name}: output spec refers to input {spec} but "
                    f"only {len(given)} argument(s) were "
                    f"supplied") from None
            shape, dtype = tuple(like.shape), like.dtype
        elif callable(spec):
            shape, dtype = spec(*given)
        elif self._is_shape_dtype_pair(spec):
            shape, dtype = spec
        else:
            raise TypeError(
                f"{call_name}: output spec {spec!r} is not an input index, "
                f"a (shape, dtype) pair, or a callable")
        return sched.array(shape=tuple(shape), dtype=dtype,
                           name=f"{call_name}_o{out_idx}")

    # -- options --------------------------------------------------------
    def with_options(self, **opts) -> "GrFunction":
        """Return a variant with call-scoped options bound (same declared
        identity).  Known keys: ``scheduler, name, priority, tenant, cost_s,
        device, tune, deadline_s``; anything else merges into the launch
        config."""
        known = {k: opts.pop(k) for k in _OPTION_KEYS if k in opts}
        if "outputs" in known:
            outputs = known["outputs"]      # re-normalized by the ctor
        else:
            outputs = list(self.outputs) if self.outputs is not None else None
        return GrFunction(
            self.fn, self.modes,
            name=known.get("name", self.name),
            outputs=outputs,
            cost_s=known.get("cost_s", self.cost_s),
            tune=known.get("tune", self.tune),
            config=dict(self.config, **opts),
            scheduler=known.get("scheduler", self.scheduler),
            priority=known.get("priority", self.priority),
            tenant=known.get("tenant", self.tenant),
            device=known.get("device", self.device),
            deadline_s=known.get("deadline_s", self.deadline_s),
            lint_shapes=self.lint_shapes,
            _fid=self.fid)

    # -- the call -------------------------------------------------------
    def _resolve_scheduler(self, explicit: Optional[GrScheduler],
                           arrays: Tuple[Any, ...]) -> GrScheduler:
        if explicit is not None:
            return explicit
        if self.scheduler is not None:
            return self.scheduler
        rt = current_runtime()
        if rt is not None:
            return rt
        for a in arrays:               # last resort: the arrays know theirs
            sched = getattr(a, "_scheduler", None)
            if sched is not None:
                return sched
        raise NoActiveRuntimeError(
            f"cannot resolve a runtime for GrFunction {self.name!r}: enter "
            "`with gr.runtime(...):`, install a default via "
            "`gr.set_runtime(...)`, bind one with "
            "`.with_options(scheduler=...)`, or pass `scheduler=` to the "
            "call")

    def __call__(self, *arrays, scheduler: Optional[GrScheduler] = None,
                 **overrides):
        """Invoke the declared kernel on managed handles.

        Positional arguments fill the declared modes in order; trailing
        ``out`` arguments may be omitted when the declaration carries an
        ``outputs=`` spec — the runtime then allocates them and returns the
        allocated array(s) (single array, or a tuple).  When every argument
        is supplied, the scheduled :class:`ComputationalElement` is returned
        instead.  ``**overrides`` accepts the same keys as
        :meth:`with_options`, scoped to this call only.
        """
        gf = self.with_options(**overrides) if overrides else self
        sched = gf._resolve_scheduler(scheduler, arrays)
        n = len(gf.modes)
        if len(arrays) > n:
            raise TypeError(f"{gf.name}: takes at most {n} argument(s), "
                            f"got {len(arrays)}")
        allocated = []
        if len(arrays) < n:
            out_positions = gf._out_positions()
            full = list(arrays)
            for pos in range(len(arrays), n):
                if gf.modes[pos] is not AccessMode.OUT:
                    raise TypeError(
                        f"{gf.name}: argument {pos} "
                        f"('{gf.modes[pos].value}') must be supplied — only "
                        f"trailing 'out' arguments can be runtime-allocated")
                ma = gf._allocate(pos, out_positions.index(pos), arrays,
                                  sched, gf.name)
                allocated.append(ma)
                full.append(ma)
            arrays = tuple(full)
        args = tuple(Arg(a, m) for a, m in zip(arrays, gf.modes))
        element = sched._launch(
            gf.fn, args, name=gf.name, cost_s=gf.cost_s, tune=gf.tune,
            priority=gf.priority, tenant=gf.tenant, device=gf.device,
            deadline_s=gf.deadline_s, fn_key=gf.fid, **gf.config)
        if allocated:
            return allocated[0] if len(allocated) == 1 else tuple(allocated)
        return element

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        modes = ",".join(m.value for m in self.modes)
        return f"<GrFunction {self.name} fid={self.fid} modes=({modes})>"


# Every ``function()`` declaration registers here (weakly — a declaration
# dropped by user code disappears from lint sweeps with it).  The access-
# mode checker (``python -m repro.analysis lint``) audits this registry.
_DECLARATIONS: "weakref.WeakSet[GrFunction]" = weakref.WeakSet()


def declared_functions() -> List[GrFunction]:
    """Live ``function()`` declarations of this process, in fid order."""
    return sorted(_DECLARATIONS, key=lambda gf: gf.fid)


def function(fn: Optional[Callable],
             modes: Sequence[Union[str, AccessMode]], *,
             name: Optional[str] = None, outputs: Any = None,
             cost_s: float = 0.0, tune: Optional[dict] = None,
             scheduler: Optional[GrScheduler] = None,
             lint_shapes: Optional[Sequence] = None,
             **config) -> GrFunction:
    """Declare a kernel once; every later call is plain ``f(x, y)``.

    ``modes`` annotates the signature (``"const"``/``"out"``/``"inout"``,
    paper §IV-D) — the one place access intent is ever written.  ``outputs``
    optionally describes how to allocate omitted trailing ``out`` arguments
    (see :class:`GrFunction`); ``lint_shapes`` optionally gives the
    access-mode checker one ``(shape, dtype)`` shadow operand per argument.
    Remaining keyword arguments become the default launch config (e.g.
    ``parallel_fraction`` for the simulator).
    """
    gf = GrFunction(fn, modes, name=name, outputs=outputs, cost_s=cost_s,
                    tune=tune, scheduler=scheduler,
                    lint_shapes=lint_shapes, config=config)
    _DECLARATIONS.add(gf)
    return gf
