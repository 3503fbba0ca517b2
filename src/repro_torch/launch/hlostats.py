"""Per-device cost counter for the dry run's roofline: the port of
``repro.launch.hlostats``.

The reference parses the compiled HLO text of a step.  CUDA has no HLO: the
port runs its steps eagerly, so the operations a step dispatches are the
program.  ``count_step(fn, *args, **kw)`` runs ``fn`` under a
``TorchDispatchMode`` and counts each rank's local work:

* **flops**: ``torch.utils.flop_counter``'s formulas (matmuls, batched
  matmuls, convolutions, attention) on the local shapes, and each
  hand-written kernel's own formula (``cost`` beside each kernel in
  ``kernels/*/ops.py``; the kernel counts as one launch, never as its plain
  version's operations).  Elementwise arithmetic is not counted;
* **memory bytes**: the local inputs and outputs of every operation that
  is not a view and returns a tensor (an output that is one of the inputs
  counted once).  This
  is an unfused count: eager PyTorch writes every intermediate to device
  memory, so the figure is the traffic of the eager step, an upper bound
  on what a fused program moves, and larger than the reference's count at
  XLA's fusion boundaries;
* **collectives**: bytes and counts by kind from the ``_c10d_functional``
  operations (each one's result, as the reference reads the HLO op's result
  shape), with the size and ranks of the process group each one runs on;
  ``wire_bytes`` applies the reference's ring factors (``_wire_bytes``),
  and ``wire_bytes_internode`` is the part of it on groups that span more
  than one NVLink domain of ``launch.mesh.NODE_RANKS`` ranks.

A ``DTensor`` operation is left to ``DTensor`` (the mode returns
``NotImplemented``) and counted as the local operations it runs on the
rank's shard.  The global-shape operations that ``DTensor``'s sharding
propagation runs on fake tensors to learn output shapes (cached per
operator schema), and the index arithmetic of strided shards, are not
counted (``dtensor_bookkeeping``), so a step counts the same whether it
runs first or second.

The reference's HLO parser (``_Module``, trip counts, ``_dot_flops``,
``_conv_flops``) has no counterpart: there is no compiled module to parse,
no loop body to multiply (the port's loops run in Python, so every
iteration is dispatched and counted) and the products' flops come from
the dispatched shapes.  ``trip_counts`` stays empty here; the dry run's
own depth and accumulation multipliers are in ``launch.dryrun``.
"""
from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .mesh import NODE_RANKS


@dataclass
class HLOStats:
    flops: float = 0.0
    memory_bytes: float = 0.0
    wire_bytes: float = 0.0        # estimated per-device link traffic
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    collective_counts: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    trip_counts: Dict[str, int] = field(default_factory=dict)
    # the port's: wire bytes on groups beyond one NVLink domain, and each
    # hand-written kernel's calls
    wire_bytes_internode: float = 0.0
    kernel_launches: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> dict:
        return {"flops": self.flops, "memory_bytes": self.memory_bytes,
                "wire_bytes": self.wire_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "total_collective_bytes": self.total_collective_bytes,
                "wire_bytes_internode": self.wire_bytes_internode,
                "kernel_launches": dict(self.kernel_launches)}


# ``_c10d_functional`` operators by the reference's collective kind
# (all-gather, all-reduce, reduce-scatter, all-to-all, collective-permute;
# DTensor issues no permute); another operator counts under its own name
_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}

# operators that allocate without touching memory
_NO_BYTES = {"empty", "empty_strided", "new_empty", "new_empty_strided",
             "empty_like", "wait_tensor"}


def _wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """Per-device link traffic for one collective op (ring algorithms)."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":          # result = full gather
        return nbytes * (g - 1) / g
    if kind == "all-reduce":          # reduce-scatter + all-gather
        return 2.0 * nbytes * (g - 1) / g
    if kind == "reduce-scatter":      # result = one shard
        return nbytes * (g - 1)
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    return nbytes                     # collective-permute


# ----------------------------------------------------------------------
# DTensor's own bookkeeping, kept out of every count
# ----------------------------------------------------------------------
_STATE = threading.local()


def in_bookkeeping() -> bool:
    """Whether the calling thread is inside ``DTensor``'s sharding
    propagation or a strided shard's index arithmetic."""
    return getattr(_STATE, "depth", 0) > 0


def _marked(fn, real: bool = False):
    def wrapped(*args, **kw):
        _STATE.depth = getattr(_STATE, "depth", 0) + 1
        try:
            if real:
                from torch._subclasses.fake_tensor import \
                    unset_fake_temporarily
                with unset_fake_temporarily():
                    return fn(*args, **kw)
            return fn(*args, **kw)
        finally:
            _STATE.depth -= 1
    return wrapped


@contextlib.contextmanager
def dtensor_bookkeeping():
    """Marks ``DTensor``'s sharding propagation (global-shape operations on
    fake tensors) and its index arithmetic on shards (a strided shard's
    indices, a shard's global offsets), which then runs on small real
    tensors even under a ``FakeTensorMode`` (its ``.tolist()`` and
    ``int()`` cannot run on a fake one), for the duration."""
    from torch.distributed.tensor import _utils, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    strided = getattr(placement_types, "_StridedShard", None)
    patches = [(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                False)] + [
        (owner, name, True)
        for owner, name in ((strided, "local_shard_size_and_offset"),
                            (_utils, "_compute_local_shape_and_global_offset"))
        if owner is not None and name in vars(owner)]
    saved = [(cls, name, vars(cls)[name]) for cls, name, _ in patches]
    for cls, name, real in patches:
        setattr(cls, name, _marked(getattr(cls, name), real))
    try:
        yield
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


# ----------------------------------------------------------------------
def _tensors(tree):
    out = []
    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _kernel_costs() -> dict:
    from ..kernels.flash_attention import ops as flash
    from ..kernels.norm_shift_mix import ops as nsm
    from ..kernels.rmsnorm import ops as rms
    from ..kernels.rwkv6 import ops as wkv
    return {torch.ops.repro_torch.flash_attention_fwd.default:
            ("flash_attention", flash.cost),
            torch.ops.repro_torch.rmsnorm_fwd.default: ("rmsnorm", rms.cost),
            torch.ops.repro_torch.norm_shift_mix.default: ("norm_shift_mix",
                                                           nsm.cost),
            torch.ops.repro_torch.wkv6_fwd.default: ("wkv6", wkv.cost),
            torch.ops.repro_torch.wkv6_fwd_save.default: ("wkv6", wkv.cost),
            torch.ops.repro_torch.wkv6_bwd.default: ("wkv6_bwd",
                                                     wkv.cost_bwd)}


def _group(name: str) -> tuple:
    """(size, whether its ranks span more than one NVLink domain) of the
    process group called ``name``."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    ranks = dist.get_process_group_ranks(_resolve_process_group(name))
    return len(ranks), len({r // NODE_RANKS for r in ranks}) > 1


class _Counter(TorchDispatchMode):
    def __init__(self, stats: HLOStats) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.stats = stats
        self.flop_registry = flop_registry
        self.kernels = _kernel_costs()
        # group names repeat across worlds: resolved once a count
        self.groups: Dict[str, tuple] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not in_bookkeeping():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        st = self.stats
        if func in self.kernels:
            name, cost = self.kernels[func]
            flops, nbytes = cost(*args, *kwargs.values(), out)
            st.flops += flops
            st.memory_bytes += nbytes
            st.kernel_launches[name] += 1
            return
        packet = func._overloadpacket
        if packet in self.flop_registry:
            st.flops += self.flop_registry[packet](*args, **kwargs,
                                                   out_val=out)
        op = packet.__name__
        if func.namespace in ("_c10d_functional",
                              "_c10d_functional_autograd") \
                and op != "wait_tensor":
            kind = _KIND.get(op, op)
            name = [a for a in args if isinstance(a, str)][-1]
            if name not in self.groups:
                self.groups[name] = _group(name)
            g, internode = self.groups[name]
            b = sum(_nbytes(t) for t in _tensors(out))
            wire = _wire_bytes(kind, b, g)
            st.collective_bytes[kind] += b
            st.collective_counts[kind] += 1
            st.wire_bytes += wire
            if internode:
                st.wire_bytes_internode += wire
        outs = _tensors(out)
        if func.is_view or op in _NO_BYTES or not outs:
            return
        ins = _tensors(args) + _tensors(kwargs)
        st.memory_bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs if not any(t is i for i in ins))


def count_step(fn, *args, **kw) -> HLOStats:
    """Runs ``fn(*args, **kw)`` once and returns what the calling rank
    dispatched (see the module's docstring).  Works on real tensors and on
    fake ones (``FakeTensorMode``), plain or ``DTensor``."""
    stats = HLOStats()
    with dtensor_bookkeeping(), _Counter(stats):
        fn(*args, **kw)
    return stats
