"""Access-mode checker: infer what a kernel *actually* reads and writes.

Every ``GrFunction`` declares per-argument access modes (``const`` /
``out`` / ``inout``) and the scheduler builds the dependency DAG from
nothing else.  The contract (paper §IV-D + the executor's install
convention) is:

* a kernel is a pure function of the device values of its arguments, in
  declared order, *including* output placeholders;
* it returns the new values of its writable (``out``/``inout``) arguments,
  in declared order — the executor installs them;
* ``const`` operands are never written, ``out`` operands' *prior values*
  are never read (their shape/dtype may be used — that is static).  The
  port hands a never-uploaded ``out`` argument to its kernel as an
  uninitialized tensor, so a kernel that reads one reads garbage.

The checker abstractly executes the kernel and compares behavior against
the declaration:

* **under-declaration** (correctness): the kernel returns more outputs
  than there are writable args (a computed value has no declared
  destination → the write drops DAG edges), a declared-``out`` operand's
  input *value* flows to an output, or the kernel mutates a ``const``
  operand in place;
* **over-declaration** (performance): the kernel returns fewer outputs
  than there are writable args (a declared write that never happens
  serializes every later reader), or a declared-``inout`` operand is never
  read (forces a spurious H2D prefetch/reload of dead data).

Inference is graph-based: ``torch.func.functionalize`` of the kernel is
traced with ``make_fx`` on shadow operands on the ``meta`` device (shapes
and dtypes, no data), and the read-set is the backward reachability of the
graph's outputs over its ``call_function`` nodes.  Shape-only uses are not
value reads: ``aten.*_like``, ``new_*``, ``sym_*`` and the destination of a
functional ``aten.copy`` take only an operand's shape and dtype.  An
in-place write to an input survives functionalization as a trailing
``aten.copy_`` into its placeholder, so a write through ``const`` shows in
the trace itself; a concrete pass on small CPU tensors (``_version`` and
bytes of every ``const`` operand) confirms writes the trace cannot see.

Tracing on ``meta`` keeps module caches clean: a cache keyed by device
(``benchsuite.kernels._filter``) files what the trace makes under
``meta``, never under a real device, and what the concrete pass caches
under ``cpu`` is real.  Kernels that cannot be traced
(``fn=None`` sim-only declarations, shape-sensitive kernels without
``lint_shapes`` hints) are reported as *skipped*, never as errors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core.dtypes import torch_dtype
from ..core.element import AccessMode

_aten = torch.ops.aten

#: Ops that use a tensor operand for its shape, dtype or device only.
_SHAPE_ONLY = frozenset((
    _aten.empty_like, _aten.zeros_like, _aten.ones_like, _aten.full_like,
    _aten.rand_like, _aten.randn_like, _aten.randint_like,
    _aten.new_empty, _aten.new_empty_strided, _aten.new_zeros,
    _aten.new_ones, _aten.new_full,
    _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
    _aten.sym_storage_offset,
))


@dataclass(frozen=True)
class ModeIssue:
    """One mismatch between a declaration and observed kernel behavior."""

    function: str
    kind: str                   # "under" (correctness) | "over" (performance)
    message: str
    arg: Optional[int] = None   # argument position, when attributable
    declared: Optional[str] = None

    def __str__(self) -> str:
        where = f" arg {self.arg}" if self.arg is not None else ""
        return f"[{self.kind}] {self.function}{where}: {self.message}"


@dataclass
class ModeReport:
    """Result of analyzing one declared ``GrFunction``."""

    function: str
    modes: Tuple[str, ...]
    issues: List[ModeIssue] = field(default_factory=list)
    reads: Optional[Tuple[bool, ...]] = None   # inferred value-read per arg
    n_outputs: Optional[int] = None            # values the kernel returns
    skipped: Optional[str] = None              # reason when unanalyzable

    @property
    def ok(self) -> bool:
        return not self.issues

    def to_json(self) -> dict:
        return {
            "function": self.function,
            "modes": list(self.modes),
            "reads": list(self.reads) if self.reads is not None else None,
            "n_outputs": self.n_outputs,
            "skipped": self.skipped,
            "issues": [{"kind": i.kind, "arg": i.arg,
                        "declared": i.declared, "message": i.message}
                       for i in self.issues],
        }


# ----------------------------------------------------------------------
# graph read-set inference
# ----------------------------------------------------------------------

def _value_inputs(node) -> List[Any]:
    """The nodes whose *values* ``node`` computes from."""
    target = node.target
    if getattr(target, "overloadpacket", None) in _SHAPE_ONLY:
        return []
    if target is _aten.copy.default:        # copy(dst, src): dst's shape only
        src = node.args[1]
        return [src] if hasattr(src, "op") else []
    return list(node.all_input_nodes)


def _value_read_positions(gm) -> Set[int]:
    """Positions of the graph's placeholders whose *value* can reach an
    output: backward reachability from the output node."""
    nodes = list(gm.graph.nodes)
    placeholders = [n for n in nodes if n.op == "placeholder"]
    live = set()
    for node in reversed(nodes):
        if node.op == "output":
            live.update(node.all_input_nodes)
        elif node in live and node.op == "call_function":
            live.update(_value_inputs(node))
    return {i for i, p in enumerate(placeholders) if p in live}


def _mutated_positions(gm) -> Set[int]:
    """Placeholders an in-place write lands in: after functionalization,
    a trailing ``aten.copy_`` into the placeholder."""
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    hit = set()
    for node in gm.graph.nodes:
        if (node.op == "call_function"
                and node.target is _aten.copy_.default
                and node.args[0] in placeholders):
            hit.add(placeholders.index(node.args[0]))
    return hit


# ----------------------------------------------------------------------
# shadow operands
# ----------------------------------------------------------------------

_DEFAULT_SHAPE_CANDIDATES: Tuple[Tuple[Tuple[int, ...], Any], ...] = (
    ((8, 8), np.float32),
    ((8,), np.float32),
)


def _candidate_spec_sets(gf, n_args: int,
                         shapes: Optional[Sequence] = None):
    """Yield lists of (shape, dtype) pairs to trace with.

    Order of preference: explicit ``shapes`` argument, the declaration's
    ``lint_shapes`` hint, then generic fallbacks (all-2D f32, all-1D f32).
    """
    hint = shapes if shapes is not None else getattr(gf, "lint_shapes", None)
    if hint is not None:
        yield [(tuple(s), np.dtype(d)) for s, d in hint]
        return
    for shape, dtype in _DEFAULT_SHAPE_CANDIDATES:
        yield [(shape, np.dtype(dtype))] * n_args


def _trace(fn, specs):
    """``make_fx`` graph of ``functionalize(fn)`` on meta shadows, and the
    number of values the kernel returned."""
    from torch.fx.experimental.proxy_tensor import make_fx

    shadows = [torch.empty(s, dtype=torch_dtype(d), device="meta")
               for s, d in specs]
    returned = []

    def kernel(*args):
        res = fn(*args)
        returned.append(res)
        return res

    gm = make_fx(torch.func.functionalize(kernel),
                 tracing_mode="real")(*shadows)
    res = returned[-1]
    return gm, (len(res) if isinstance(res, (tuple, list)) else 1)


def _concrete_fill(shape, dtype, salt: int) -> torch.Tensor:
    n = int(np.prod(shape)) if shape else 1
    if np.issubdtype(dtype, np.integer):
        vals = (np.arange(n) + salt) % 7
    elif np.issubdtype(dtype, np.bool_):
        vals = (np.arange(n) + salt) % 2
    else:
        vals = (np.arange(n) + salt) * 0.125 + 0.5
    return torch.from_numpy(
        np.asarray(vals, dtype=np.float64).reshape(shape)).to(
            torch_dtype(dtype))


def _check_inplace_const(fn, specs, modes) -> Optional[int]:
    """Run the kernel once on small CPU tensors; the first ``const``
    operand whose ``_version`` or bytes changed, or None.  Best-effort: a
    kernel that does not run at these shapes confirms nothing."""
    args = [_concrete_fill(s, d, salt=3 * i + 1)
            for i, (s, d) in enumerate(specs)]
    before = [(a._version, a.clone()) for a in args]
    try:
        fn(*args)
    except Exception:
        return None         # concrete pass is best-effort; tracing is the oracle
    for i, (a, (version, copy)) in enumerate(zip(args, before)):
        if modes[i].writes:
            continue
        if a._version != version or not torch.equal(
                a.view(-1).view(torch.uint8), copy.view(-1).view(torch.uint8)):
            return i
    return None


# ----------------------------------------------------------------------
# the checker
# ----------------------------------------------------------------------

def analyze_function(gf, shapes: Optional[Sequence] = None) -> ModeReport:
    """Infer read/write behavior of one declared ``GrFunction`` and diff it
    against the declared access modes.  Never raises for unanalyzable
    kernels — those come back with ``report.skipped`` set."""
    modes: Tuple[AccessMode, ...] = tuple(gf.modes)
    mode_names = tuple(m.value for m in modes)
    name = getattr(gf, "name", None) or getattr(gf.fn, "__name__", "<fn>")
    report = ModeReport(function=name, modes=mode_names)
    fn = gf.fn
    if fn is None:
        report.skipped = "no kernel callable (sim-only declaration)"
        return report

    gm = None
    n_out = None
    last_error: Optional[str] = None
    chosen_specs = None
    for specs in _candidate_spec_sets(gf, len(modes), shapes):
        if len(specs) != len(modes):
            last_error = (f"lint_shapes has {len(specs)} entries for "
                          f"{len(modes)} declared args")
            continue
        try:
            gm, n_out = _trace(fn, specs)
        except Exception as exc:
            last_error = f"{type(exc).__name__}: {exc}"
            continue
        chosen_specs = specs
        break
    if gm is None:
        report.skipped = f"trace failed: {last_error}"
        return report

    read_positions = _value_read_positions(gm)
    report.reads = tuple(i in read_positions for i in range(len(modes)))
    report.n_outputs = n_out

    writable = [i for i, m in enumerate(modes) if m.writes]
    if n_out > len(writable):
        report.issues.append(ModeIssue(
            function=name, kind="under",
            message=(f"kernel returns {n_out} outputs but only "
                     f"{len(writable)} args are declared writable — a "
                     f"computed value has no declared destination, so its "
                     f"write carries no DAG edges (and the executor would "
                     f"reject the launch)")))
    elif n_out < len(writable):
        report.issues.append(ModeIssue(
            function=name, kind="over",
            message=(f"declares {len(writable)} writable (out/inout) args "
                     f"but the kernel returns {n_out} outputs — the phantom "
                     f"write serializes every later reader of that operand "
                     f"behind a store that never happens")))

    for i, m in enumerate(modes):
        is_read = i in read_positions
        if m is AccessMode.OUT and is_read:
            report.issues.append(ModeIssue(
                function=name, kind="under", arg=i, declared=m.value,
                message=("declared 'out' but the operand's input value "
                         "flows to an output — the runtime skips the H2D "
                         "refresh for pure outputs, so the kernel reads "
                         "stale device contents; declare 'inout'")))
        elif m is AccessMode.INOUT and not is_read:
            report.issues.append(ModeIssue(
                function=name, kind="over", arg=i, declared=m.value,
                message=("declared 'inout' but the operand's prior value "
                         "is never read — forces a spurious host→device "
                         "prefetch/reload of dead data; declare 'out'")))

    mutated = [i for i in sorted(_mutated_positions(gm))
               if not modes[i].writes]
    if not mutated:
        bad = _check_inplace_const(fn, chosen_specs, modes)
        mutated = [bad] if bad is not None else []
    for i in mutated:
        report.issues.append(ModeIssue(
            function=name, kind="under", arg=i, declared="const",
            message=("kernel mutates a 'const' operand in place — the "
                     "write is invisible to the DAG (no WAR/WAW edges) "
                     "and races every concurrent reader; declare "
                     "'inout'")))
    return report


def lint_functions(fns: Optional[Iterable] = None) -> List[ModeReport]:
    """Analyze every declared ``GrFunction`` (default: the process-wide
    declaration registry) and return one report per declaration."""
    if fns is None:
        from ..core.frontend import declared_functions
        fns = declared_functions()
    reports = []
    seen = set()
    for gf in fns:
        fid = getattr(gf, "fid", None)
        if fid is not None:
            if fid in seen:
                continue
            seen.add(fid)
        reports.append(analyze_function(gf))
    return reports
