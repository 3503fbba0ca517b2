"""Parameter/activation sharding rules: the port of ``repro.sharding.rules``.

Parallelism mapping over the production mesh ``("pod","data","model")``:

* **DP**   — batch over ``pod`` × ``data``;
* **FSDP** — every weight matrix additionally sharded over ``data``
  (ZeRO-3: the use sites gather it, ``sharding.context.use_weight``);
* **TP**   — head / FFN / expert / vocab dimensions over ``model``;
* **EP**   — MoE expert axis over ``model`` when divisible, else the expert
  FFN dim;
* **SP**   — long sequences over ``model`` (``batch_spec(seq_shard=True)``).

Every rule is divisibility-guarded: an axis is applied to a dimension only
when it divides evenly (hymba's 25 heads fall back to unsharded heads while
its FFN still gets TP).

A spec is a tuple with one entry per tensor dimension, as a JAX
``PartitionSpec``: an axis name, a tuple of axis names (sharded over each,
in mesh order) or None.  ``NamedSharding(mesh, spec).placements`` is the
``DTensor`` layout: a dimension under an axis is ``Shard(dim)`` on that
mesh dimension, and every other mesh dimension is ``Replicate()``.  The
spec functions need only the axis sizes, so ``mesh`` may be a
``DeviceMesh`` or a mapping ``{axis name: size}``.

The port stores each layer's parameters in its own module (``blocks.5.
attn.wq``), where the reference stacks them with a leading ``n_groups``
axis; a port leaf gets the reference's inner spec, without that leading
None.  Leaf names are matched through ``models.convert.reference_path``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Sequence, Tuple

import torch

from ..launch.mesh import mesh_axes

Spec = Tuple[Any, ...]


def _axis_size(axes: Mapping[str, int], name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= _axis_size(axes, n)
        return out
    return axes.get(name, 0)


def fit_spec(spec: Sequence, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop axes that don't exist in the mesh or don't divide the dim."""
    axes = mesh_axes(mesh)
    fitted = []
    for dim, ax in zip(shape, spec):
        size = _axis_size(axes, ax)
        if ax is None or size == 0 or size == 1 or dim % size != 0:
            fitted.append(None)
        else:
            fitted.append(ax)
    return tuple(fitted)


def dp_axes(mesh):
    """The data-parallel axes present in this mesh."""
    present = mesh_axes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in present)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def placements(spec: Sequence, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``'s dimensions."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        group = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax} does not follow the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


# ----------------------------------------------------------------------
# parameter rules, keyed by the trailing path element
# ----------------------------------------------------------------------
def _param_rule(path: str, shape, mesh, fsdp: str = "data") -> Spec:
    """Spec for an *unstacked* parameter; `path` is the dot- or
    slash-joined tree path (only its last element matters)."""
    tp = "model"
    leaf = path.replace("/", ".").split(".")[-1]
    r = len(shape)
    axes = mesh_axes(mesh)

    def S(*ax):
        return fit_spec(ax, shape, mesh)

    if leaf == "embed":
        return S(tp, fsdp)                      # (V, d): vocab-TP + FSDP
    if leaf == "lm_head":
        return S(fsdp, tp)                      # (d, V)
    if leaf in ("wq", "wk", "wv", "wg", "wr", "w_in", "w_gate", "w_decay_a",
                "frontend_proj"):
        if r == 3:                               # MoE expert weights (E, d, f)
            return S(tp, fsdp, None) if shape[0] % _axis_size(axes, tp) == 0 \
                else S(None, fsdp, tp)
        return S(fsdp, tp)                      # (d, out)
    if leaf in ("wo", "w_out", "wv_out", "w_decay_b"):
        if r == 3:                               # (E, f, d)
            return S(tp, None, fsdp) if shape[0] % _axis_size(axes, tp) == 0 \
                else S(None, tp, fsdp)
        return S(tp, fsdp)                      # (out, d)
    if leaf == "router":
        return S(fsdp, None)
    if leaf in ("conv_w",):
        return S(None, tp)
    if leaf in ("A_log", "D", "dt_bias", "w_dt", "w_B", "w_C"):
        return S(tp) if r == 1 else S(tp, None)
    if leaf == "bonus_u":
        return S(tp, None)                      # (H, hd)
    # norms / scales / mixers / biases: replicate
    return (None,) * r


def _named_leaves(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_sharding(params, mesh, fsdp=None) -> Dict[str, NamedSharding]:
    """``{leaf name: NamedSharding}`` for an ``LM`` (or a mapping of its
    leaf names to tensors: gradients, moments).  FSDP spans every
    data-parallel axis present (pod x data on the multi-pod mesh — ZeRO
    degree 512, not 256)."""
    if fsdp is None:
        fsdp = dp_axes(mesh)
    return {n: NamedSharding(mesh, _param_rule(n, tuple(t.shape), mesh,
                                               fsdp))
            for n, t in _named_leaves(params).items()}


# ----------------------------------------------------------------------
# activations / batches / caches
# ----------------------------------------------------------------------
def batch_spec(mesh, seq_shard: bool = False) -> Dict[str, Spec]:
    dp = dp_axes(mesh)
    seq_ax = "model" if seq_shard else None
    return {
        "tokens": (dp, seq_ax),
        "labels": (dp, seq_ax),
        "frames": (dp, seq_ax, None),
        "patches": (dp, None, None),
    }


_CACHE_SPECS = {
    # kv-head TP when divisible, else the head_dim: (B, S, H, hd)
    "k": None, "v": None, "cross_k": None, "cross_v": None,
    "wkv": ("dp", "model", None, None),        # (B, H, hd, hd)
    "h": ("dp", "model", None),                # (B, inner, N)
    "shift": ("dp", "model"),                  # (B, d)
    "cmix_shift": ("dp", "model"),
    "conv": ("dp", None, "model"),             # (B, k-1, inner)
}


def _cache_spec(name: str, shape, mesh) -> Spec:
    dp = dp_axes(mesh)
    if name not in _CACHE_SPECS:
        return (None,) * len(shape)
    spec = _CACHE_SPECS[name]
    if spec is None:
        if shape[2] % max(1, _axis_size(mesh_axes(mesh), "model")) == 0:
            spec = ("dp", None, "model", None)
        else:
            spec = ("dp", None, None, "model")
    spec = tuple(dp if a == "dp" else a for a in spec)
    return fit_spec(spec, shape, mesh)


def cache_sharding(cache, mesh):
    """KV caches: batch over DP, kv-heads over TP when divisible (else the
    head dim); recurrent states: channel dims over TP.  ``cache`` is the
    port's list of per-layer dicts (hymba's nested ``"mamba"`` dict too);
    the result has its structure, a ``NamedSharding`` per tensor, named by
    the tensor's last key as in the reference."""
    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, name) for v in tree)
        return NamedSharding(mesh, _cache_spec(name, tuple(tree.shape),
                                               mesh))
    return walk(cache)


def q8_specs(base: Sequence, codes_shape, scales_shape, mesh) -> tuple:
    """(codes spec, scales spec) of a q8 moment whose parameter has spec
    ``base`` (``launch/specs.py``'s ``opt_leaf_sharding``): the blocks keep
    the parameter's leading-axis sharding, and the block axis ``nb`` takes
    the parameter's last-axis sharding where it divides ``nb``; else, down
    a ladder (the full data-parallel tuple, then each sub-axis, largest
    first, then unsharded), the largest ZeRO degree that does (e.g. 144
    blocks against pod x data = 32 take data = 16).  The trailing axis of
    128 is never sharded, so every block lies inside one shard."""
    axes = mesh_axes(mesh)

    def length(ax) -> int:       # an axis the mesh lacks counts as 1
        group = ax if isinstance(ax, tuple) else (ax,)
        return math.prod(axes.get(a, 1) for a in group)
    base = tuple(base)
    lead = base[:-1] if base else ()
    last = base[-1] if base else None
    nb = codes_shape[-2]
    if isinstance(last, tuple):
        candidates = [last] + sorted(last, key=length, reverse=True)
    else:
        candidates = [last]
    pick = None
    for c in candidates:
        if c is not None and nb % length(c) == 0:
            pick = c
            break
    return (fit_spec(lead + (pick, None), codes_shape, mesh),
            fit_spec(lead + (pick,), scales_shape, mesh))


def spec_of(placements, mesh, ndim: int) -> Spec:
    """The spec whose ``placements`` on ``mesh`` are these (the inverse of
    ``placements``; a dimension sharded over several axes names them in
    mesh order)."""
    names = mesh.mesh_dim_names
    spec = []
    for d in range(ndim):
        on = tuple(names[i] for i, p in enumerate(placements)
                   if p.is_shard(d))
        spec.append(None if not on else on[0] if len(on) == 1 else on)
    return tuple(spec)


def state_sharding(state_tree, params_sharding):
    """Optimizer state mirrors parameter sharding: ``{"m": ..., "v": ...}``
    each the parameters' ``{leaf name: NamedSharding}``, a q8 moment's a
    ``Q8State`` of its codes' and scales' (``q8_specs``)."""
    from ..optim.adamw import Q8State

    def one(n, m):
        sh = params_sharding[n]
        if not isinstance(m, Q8State):
            return sh
        cs, ss = q8_specs(sh.spec, tuple(m.codes.shape),
                          tuple(m.scales.shape), sh.mesh)
        return Q8State(NamedSharding(sh.mesh, cs), NamedSharding(sh.mesh, ss))
    return {"m": {n: one(n, m) for n, m in state_tree.m.items()},
            "v": {n: one(n, m) for n, m in state_tree.v.items()}}


# ----------------------------------------------------------------------
# placing tensors
# ----------------------------------------------------------------------
def place(t: torch.Tensor, sharding: NamedSharding):
    """``t`` as a ``DTensor`` laid out by ``sharding``.  Every rank holds the
    same full ``t`` and keeps its own shard of it: no communication.  A
    ``DTensor`` is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh, pl = sharding.mesh, sharding.placements
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    return distribute_tensor(t.to(mesh.device_type), mesh, pl,
                             src_data_rank=None)


def _place_module(model: torch.nn.Module, shardings) -> torch.nn.Module:
    for name, sh in shardings.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        p = getattr(mod, leaf)
        placed = place(p.detach(), sh)
        setattr(mod, leaf, torch.nn.Parameter(placed,
                                              requires_grad=p.requires_grad))
    return model


def logical_to_physical(mesh, tree, sharding_tree):
    """Places every tensor of ``tree`` with the ``NamedSharding`` at the
    same place of ``sharding_tree``.  An ``LM`` (with ``sharding_tree`` from
    ``param_sharding``) has its parameters replaced by ``DTensor``
    parameters in place and is returned; dicts, lists and tuples come back
    as new trees."""
    if isinstance(tree, torch.nn.Module):
        return _place_module(tree, sharding_tree)
    if isinstance(tree, dict):
        return {k: logical_to_physical(mesh, v, sharding_tree[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(logical_to_physical(mesh, v, s)
                          for v, s in zip(tree, sharding_tree))
    return place(tree, sharding_tree)
