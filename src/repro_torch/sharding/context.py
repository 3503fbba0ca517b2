"""Use-site logical sharding constraints (ZeRO-3 materialization policy):
the port of ``repro.sharding.context``.

Parameters are *stored* FSDP-sharded (fp32 masters spread over the data
axes — see rules.py).  Every layer wraps its weights in
``use_weight(w, *candidate_specs)``: the bf16 copy is redistributed to a
TP-only layout, so the weight is all-gathered in bf16 right before use and
its gradient reduce-scattered back to the storage layout in the backward
(``DTensor.redistribute``'s own backward) — ZeRO-3 with mixed-precision
gathers.  The reference's ``jax.lax.with_sharding_constraint`` becomes
``DTensor.redistribute``.

Each function acts only on a ``DTensor`` inside ``sharding_rules(mesh)``;
outside a mesh context, or on a plain tensor, it returns its input
untouched.  ``sharding_rules`` also lets plain tensors made inside the
model (masks, positions, zeros) meet ``DTensor`` operands as replicated
ones (``implicit_replication``).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from typing import Optional, Sequence, Tuple

from ..kernels import is_dtensor, mesh_factor
from ..launch.mesh import mesh_axes

_STATE = threading.local()


def _mesh_axes():
    return getattr(_STATE, "axes", None)


def _mesh():
    return getattr(_STATE, "mesh", None)


def _dp_axes():
    axes = _mesh_axes()
    if not axes:
        return None
    dp = tuple(a for a in ("pod", "data") if a in axes)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


@contextmanager
def sharding_rules(mesh):
    """Activate use-site constraints under ``mesh`` (a ``DeviceMesh``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = (_mesh_axes(), _mesh())
    _STATE.axes = mesh_axes(mesh)
    _STATE.mesh = mesh
    try:
        with implicit_replication():
            yield
    finally:
        _STATE.axes, _STATE.mesh = prev


def recompute_context():
    """``context_fn`` of a non-reentrant ``torch.utils.checkpoint``: the
    recompute re-enters the sharding rules active when the block ran.
    Autograd runs a CUDA tensor's backward, and so remat's recompute, on
    its device thread, where this module's thread-local rules are not
    set; without them no use-site constraint would apply there."""
    mesh = _mesh()
    return nullcontext(), (sharding_rules(mesh) if mesh is not None
                           else nullcontext())


def _active(x) -> bool:
    # is_dtensor: a plain path never imports the distributed tensor
    # package (its first import costs seconds)
    return _mesh_axes() is not None and is_dtensor(x)


def _fit(spec: Sequence, shape: Tuple[int, ...]) -> Optional[tuple]:
    axes = _mesh_axes()
    out = []
    ok = False
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        size = axes.get(ax, 0) if not isinstance(ax, tuple) else 0
        if isinstance(ax, tuple):
            size = 1
            for a in ax:
                size *= axes.get(a, 0)
        if size and size > 0 and dim % size == 0:
            out.append(ax)
            ok = True
        else:
            out.append(None)
    return tuple(out) if ok else (None,) * len(shape)


def _constrain(x, spec):
    from .rules import placements
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def use_weight(w, *candidate_specs):
    """Constrain a weight (already cast to compute dtype) to the first
    candidate TP layout that divides evenly; no-op outside a mesh context."""
    if not _active(w) or not candidate_specs:
        return w
    for spec in candidate_specs:
        p = _fit(spec, w.shape)
        if any(a is not None for a in p):
            return _constrain(w, p)
    return _constrain(w, (None,) * w.ndim)


def to_stream(y, x):
    """``y`` in the layout of the residual stream ``x`` before the two
    are added: a block's row-parallel output (a partial sum) is reduced
    into the stream's layout (a reduce-scatter where the stream is
    sequence-sharded), and its backward hands the product a gradient in
    the product's own layout, which its view of (B, S) as one axis
    needs."""
    if not (_active(y) and is_dtensor(x)) or any(
            p.is_partial() for p in x.placements):
        return y         # a partial-sum stream (decode) takes y as it is
    return y.redistribute(x.device_mesh, x.placements)


def shard_activations(x, *, seq_axis=None):
    """Constrain token activations (B, S, d) to batch-over-DP."""
    if not _active(x):
        return x
    dp = _dp_axes()
    if dp is None:
        return x
    spec = [dp] + [None] * (x.ndim - 1)
    if seq_axis is not None and x.ndim >= 2:
        spec[1] = seq_axis
    return _constrain(x, _fit(spec, x.shape))


def _fit_dp(dim: int):
    """The DP axes where they divide ``dim``, else None (a ``DTensor``
    sharded unevenly cannot be reshaped; GSPMD pads instead)."""
    dp = _dp_axes()
    return _fit((dp,), (dim,))[0] if dp is not None else None


def shard_heads(x):
    """Constrain (B, S, H, hd) attention tensors: batch over DP, heads over
    "model" when divisible, and head_dim explicitly REPLICATED, so that no
    score product contracts a sharded dim."""
    if not _active(x) or x.ndim != 4:
        return x
    tp = _mesh_axes().get("model", 1)
    head_ax = "model" if (tp > 1 and x.shape[2] % tp == 0) else None
    return _constrain(x, (_fit_dp(x.shape[0]), None, head_ax, None))


def align_heads(q, k, v):
    """GQA under head sharding: query heads stay sharded only where the KV
    heads split by the same factor (each rank's query heads then attend
    its own KV heads, and no gradient of k or v is a partial sum across
    ranks); otherwise the query heads are gathered too.  The flash
    kernel's wrapper keeps the same rule."""
    if not _active(q):
        return q, k, v
    from torch.distributed.tensor import Replicate
    mesh = q.device_mesh
    if mesh_factor(q.placements, mesh, 2) != mesh_factor(k.placements, mesh,
                                                         2):
        rep = [Replicate() if p.is_shard(2) else p for p in q.placements]
        q = q.redistribute(mesh, rep)
        k = k.redistribute(mesh, rep)
        v = v.redistribute(mesh, rep)
    return q, k, v


def split_heads(x, n_heads: int, hd: int):
    """(..., n_heads * hd) -> (..., n_heads, hd).  A ``DTensor`` whose last
    dim is sharded across a head boundary is gathered on that dim first:
    a shard must hold whole heads to be viewed as heads."""
    if _active(x):
        from torch.distributed.tensor import Replicate
        mesh, last = x.device_mesh, x.ndim - 1
        if n_heads % mesh_factor(x.placements, mesh, last):
            x = x.redistribute(mesh, [Replicate() if p.is_shard(last) else p
                                      for p in x.placements])
    return x.reshape(*x.shape[:-1], n_heads, hd)


def merge_heads(x):
    """(..., n_heads, hd) -> (..., n_heads * hd), ``split_heads``'s
    inverse.  A ``DTensor`` result is pinned to its own layout (a no-op
    forward), so that its gradient, in whatever layout the next product
    hands it back, returns to that layout before the backward's view
    splits the heads again: a shard must hold whole heads."""
    y = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if _active(y):
        y = y.redistribute(y.device_mesh, y.placements)
    return y


def pin_attention_blocks(q, k, v):
    """Pin the blocked attention's inputs: batch over DP, kv-heads over
    "model" when divisible, and the sequence and head dims REPLICATED so
    the score product never contracts a sharded dim.  The reference pins
    its stacked blocks, (nq|nk, B, chunk, Hkv[, g], hd); the port's blocked
    attention runs on each rank's shard of whole tensors, so it pins those:
    (B, Sq, H, hd) for ``q`` (its heads split with the KV heads) and (B,
    Skv, Hkv, hd) for ``k`` and ``v``."""
    if not _active(q):
        return q, k, v
    dp = _fit_dp(q.shape[0])
    tp = _mesh_axes().get("model", 1)
    h_ax = "model" if (tp > 1 and k.shape[2] % tp == 0) else None
    return tuple(_constrain(t, (dp, None, h_ax, None)) for t in (q, k, v))


def constrain_like_params(tree):
    """Constrain a parameter-shaped tree (gradients, accumulators: a
    mapping of the model's leaf names to tensors) to the FSDP *storage*
    sharding — the data-parallel gradient sync is then a reduce-scatter,
    and the fp32 accumulator stays sharded."""
    mesh = _mesh()
    if mesh is None:
        return tree
    from .rules import param_sharding, place
    shardings = param_sharding(tree, mesh)
    return {n: (place(g, shardings[n]) if _active(g) else g)
            for n, g in tree.items()}
