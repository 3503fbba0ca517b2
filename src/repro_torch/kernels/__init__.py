"""Kernels written by hand for Hopper, one package per kernel of ``repro``.

Each package has ``ops.py`` (the wrapper: the CUDA kernel for a CUDA tensor,
the plain PyTorch version for a CPU tensor, and a launch count), ``ref.py``
(the plain PyTorch version) and ``csrc/`` (the CUDA source, built by
``build.py`` on first use).

A wrapper takes ``DTensor`` inputs too (``sharding``): through
``torch.distributed.tensor.experimental.local_map`` its kernel runs on each
rank's local shard, where the placement leaves whole every dimension the
kernel reduces over; any other placement is first redistributed to one the
kernel takes (``kernel_placements``).  The local shard then takes the path
of its device, as a plain tensor does.
"""
import sys

import torch


def on_card(x: torch.Tensor) -> bool:
    """Whether a wrapper takes its kernel's path for ``x`` (any tensor not
    on the CPU; the kernel then raises unless ``x`` is on a CUDA device)."""
    return x.device.type != "cpu"


def direct_launch(*tensors) -> bool:
    """Whether a launch may skip its operator (``torch.library``'s
    dispatch costs 20 to 45 us of host time a call on the card, PERF.md
    §6): plain tensors, and no dispatch mode active, so that nothing
    fakes, traces or counts the call.  Otherwise the call goes through the
    operator, whose fake gives a fake tensor its outputs and whose
    dispatch a counter sees; both run the same launch."""
    return torch._C._len_torch_dispatch_stack() == 0 and all(
        type(t) in _PLAIN for t in tensors)


_PLAIN = (torch.Tensor, torch.nn.Parameter)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (without importing the distributed
    package where nothing has made one)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def as_dtensor(t, mesh):
    """``t`` as a ``DTensor`` on ``mesh``: a plain tensor (every rank holds
    all of it, as a state made inside the model does) is replicated."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def kernel_placements(x, dims) -> tuple:
    """``x``'s placements with a shard kept only on a tensor dim in
    ``dims`` (the dims the kernel treats independently); every other mesh
    dimension replicated."""
    from torch.distributed.tensor import Replicate
    return tuple(p if p.is_shard() and p.dim % x.ndim in dims
                 else Replicate() for p in x.placements)


def mesh_factor(placements, mesh, dim: int) -> int:
    """How many shards ``placements`` cut tensor dim ``dim`` into."""
    n = 1
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            n *= mesh.size(i)
    return n


def attention_placements(q, k) -> tuple:
    """Placements for attention on each rank's shard of (B, S, H, hd) q and
    (B, S, Hkv, hd) k and v: the batch or the heads sharded, S and hd
    whole; heads only where the KV heads split by the same factor (each
    rank's query heads then read its own KV heads)."""
    from torch.distributed.tensor import Replicate
    pl = kernel_placements(q, (0, 2))
    if k.shape[2] % mesh_factor(pl, q.device_mesh, 2):
        pl = tuple(Replicate() if p.is_shard(2) else p for p in pl)
    return pl


def on_shards(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` on each rank's shard of ``DTensor`` q, k and
    v, laid out by ``attention_placements``; the output (B, S, H, hd) or
    (B, S, H * hd) comes back as a ``DTensor`` of the same layout."""
    from torch.distributed.tensor.experimental import local_map
    k, v = as_dtensor(k, q.device_mesh), as_dtensor(v, q.device_mesh)
    pl = attention_placements(q, k)
    return local_map(fn, out_placements=list(pl), in_placements=(pl, pl, pl),
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v, **kw)


def refuse_grad(kernel: str, why: str, *tensors: torch.Tensor) -> None:
    """Raises where autograd would need the gradient of a kernel that has
    no backward: on the card the call must not differentiate silently
    through nothing, nor fall back to the plain version."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward; {why} (a backward "
            f"kernel is open work in ROADMAP.md §B)")
